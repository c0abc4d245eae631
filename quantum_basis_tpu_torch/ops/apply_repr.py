"""Matrix-free apply in translational-symmetry (momentum) sectors.

Port of ``quantum_basis_tpu.ops.apply_repr`` (``ReprBasis``, ``MatvecRepr``)
with native complex128 vectors in place of split (re, im) pairs. Basis
vectors are |r,k> = P_k|r>/sqrt(nu_r) over representatives r (orbit minima)
with nu_r > 0 (cf. generate_Ham_sparse_repr / repr MultMv2,
src/model.cc:687-836, 941-1121).

Row kernel (Hermitian row-gather, no scatters): apply H to the product state
|r_i>; for every image |m> with amplitude A (JW sign included) compute all G
translated labels of m, take the orbit minimum r_j = min_g T_g(m) and the
minimizing element g*; then

    y_i += sqrt(nu_j / nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}} * x_j

Images whose representative has nu = 0, or lies outside the quantum-number
sector, are dropped. :func:`mopr_x_vec_repr` is the forward-scatter direction
y = A x between two momentum sectors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
    sector_norms,
)
from quantum_basis_tpu_torch.ops.apply import (
    DeviceBasis,
    _block_images,
    _group_device,
)
from quantum_basis_tpu_torch.ops.compile import CompiledOperator, compile_diagonal

_NU_TOL = 1e-10


class ReprBasis(DeviceBasis):
    """Momentum-sector basis: representatives + norms, blocked on the device.

    Built from the quantum-number-sector labels (cf. enumerate_basis_repr,
    src/model.cc:274-487): reps = orbit minima, nu = <r|P_k|r>, keep nu > 0.
    """

    def __init__(self, space, tset: TranslationSet, sector_labels: np.ndarray,
                 momentum, work_per_row: int = 16,
                 reps_all: np.ndarray | None = None):
        self.tset = tset
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))
        if reps_all is None:
            reps_all = enumerate_reps(tset, sector_labels)
        nus = sector_norms(tset, reps_all, momentum)
        keep = nus > _NU_TOL
        labels = reps_all[keep]
        self.nus = nus[keep]
        if labels.size == 0:
            raise ValueError(
                f"momentum sector k={self.momentum} is empty (all norms zero)")
        per_row = max(work_per_row, 1) * max(tset.G, 1)
        block_rows = 1 << int(math.floor(math.log2(
            max(256, config.memory("repr_block_budget", tset.device)
                // per_row))))
        index = BasisIndex(labels, space.label_space, device=tset.device)
        super().__init__(space, labels, index, block_rows, device=tset.device)
        nu_pad = np.concatenate([self.nus, np.ones(self.pad)])
        dev = self.device
        self.inv_sqrt_nu_b = torch.as_tensor(
            (1.0 / np.sqrt(nu_pad)).reshape(self.n_blocks, self.block_rows),
            device=dev)
        # entry n is the padding slot for images that leave the sector
        self.sqrt_nu = torch.as_tensor(
            np.sqrt(np.concatenate([self.nus, [1.0]])), device=dev)
        row_id = np.arange(self.n_blocks * self.block_rows)
        self.mask_b = torch.as_tensor(
            (row_id < self.n).reshape(self.n_blocks, self.block_rows),
            device=dev)

    def from_full(self, x_full: torch.Tensor) -> torch.Tensor:
        """Repr coefficients of a full-label-space sector-k vector.

        A normalized |psi> with P_k|psi> = |psi> expands over the repr basis
        |r,k> = P_k|r>/sqrt(nu_r) as c_r = <r,k|psi> = psi[r]/sqrt(nu_r): one
        gather at the representative labels (see ops/translate_fullspace.py).
        ``x_full`` runs over ALL labels of the space. Returns a normalized
        complex128 vector over the representatives.
        """
        idx = self.labels_b.reshape(-1)[: self.n]
        c = x_full[idx].to(torch.complex128) / self.sqrt_nu[: self.n]
        return c / torch.clamp(torch.linalg.vector_norm(c), min=1e-300)


class MatvecRepr:
    """y = H x in a momentum sector; complex128, matrix-free."""

    def __init__(self, compiled: CompiledOperator, rbasis: ReprBasis):
        self.compiled = compiled
        self.basis = rbasis
        self.n = rbasis.n
        self.device = rbasis.device
        self.dtype = torch.float64
        self.is_complex = True
        self.groups = [_group_device(g, self.device) for g in compiled.groups]
        if compiled.diag_terms.q_zero():
            self.diag_b = torch.zeros(rbasis.labels_b.shape,
                                      dtype=torch.float64, device=self.device)
        else:
            self.diag_b = compile_diagonal(compiled.diag_terms,
                                           compiled.space)(rbasis.V_b)
        cos, sin = rbasis.tset.phases(rbasis.momentum)
        self.phase = torch.as_tensor(cos + 1j * sin, device=self.device)

    def images(self, b: int):
        """Off-diagonal entries of row block ``b``, one triple per term group:
        (j, valid, coef), each (B, T, K), with H[i, j] = coef where valid."""
        rb = self.basis
        tset = rb.tset
        labels, V, F = rb.labels_b[b], rb.V_b[b], rb.F_b[b]
        isn = (rb.inv_sqrt_nu_b[b] * rb.mask_b[b])[:, None, None]
        out = []
        for g in self.groups:
            sign, amp, tgt = _block_images(g, labels, V, F)
            Vm = rb.space.decode(tgt)                            # (B,T,K,S)
            Fm = tset.fermion_counts(Vm) if tset.fermionic else None
            tl, tsign = tset.transform_all(Vm, Fm)               # (B,T,K,G)
            rmin, gstar = tl.min(dim=-1)
            sig = tsign.gather(-1, gstar[..., None])[..., 0]
            j, valid = rb.index.lookup_checked(rmin)
            w = (sign[..., None] * sig * rb.sqrt_nu[torch.where(valid, j, self.n)]
                 * isn * valid)
            out.append((j, valid, w * amp.conj() * self.phase[gstar]))
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.complex128)
        rb = self.basis
        y = rb.pad_vec(x) * self.diag_b
        for b in range(rb.n_blocks):
            for j, valid, coef in self.images(b):
                y[b] += (coef * x[torch.where(valid, j, 0)]).sum(dim=(1, 2))
        return (y * rb.mask_b).reshape(-1)[: self.n]


def mopr_x_vec_repr(compiled: CompiledOperator, src: ReprBasis,
                    dst: ReprBasis, x: torch.Tensor) -> torch.Tensor:
    """y = A x across momentum sectors (forward scatter direction).

    Port of the JAX package's moprXvec_repr (reference:
    src/model.cc:1715-1856). ``A`` must carry a definite momentum transfer q
    with dst.momentum = k_src - q for A = sum_x e^{-i q.x} O_x (the double
    projection P_k' A P_k then collapses to P_k' A):

        y_j = sum_i x_i sqrt(nu'_j / nu_i) sum_{m in A|r_i>}
                  B_m sigma*_m e^{+i k'.R*_m}

    Images whose representative is not in the destination basis are dropped
    (zero norm or out of sector), matching the reference's lookup-miss
    behavior: their contribution is zeroed before the ``index_add_`` (whose
    order is not fixed on a CUDA device: two runs may differ in the last
    bits).
    """
    space = compiled.space
    tset = src.tset
    dev = src.device
    groups = [_group_device(g, dev) for g in compiled.groups]
    cos, sin = tset.phases(dst.momentum)
    phase = torch.as_tensor(cos - 1j * sin, device=dev)       # e^{+i k'.R}
    diag_b = (None if compiled.diag_terms.q_zero() else
              compile_diagonal(compiled.diag_terms, space)(src.V_b))
    xb = src.pad_vec(x.to(device=dev, dtype=torch.complex128))
    y = torch.zeros(dst.n, dtype=torch.complex128, device=dev)

    def scatter(amp, tgt, wsrc):
        """Add the images ``tgt`` (B, T, K), amplitude ``amp`` (JW sign
        included), of source weights ``wsrc`` (B, 1, 1)."""
        Vm = space.decode(tgt)
        Fm = tset.fermion_counts(Vm) if tset.fermionic else None
        tl, tsign = tset.transform_all(Vm, Fm)                # (B,T,K,G)
        rmin, gstar = tl.min(dim=-1)
        sig = tsign.gather(-1, gstar[..., None])[..., 0]
        j, valid = dst.index.lookup_checked(rmin)
        j = torch.where(valid, j, 0)
        contrib = torch.where(
            valid, sig * dst.sqrt_nu[j] * amp * phase[gstar] * wsrc, 0.0)
        y.index_add_(0, j.reshape(-1), contrib.reshape(-1))

    for b in range(src.n_blocks):
        labels, V, F = src.labels_b[b], src.V_b[b], src.F_b[b]
        wsrc = (xb[b] * src.inv_sqrt_nu_b[b] * src.mask_b[b])[:, None, None]
        if diag_b is not None:
            # diagonal terms: the image is the source state itself
            scatter(diag_b[b][:, None, None].to(torch.complex128),
                    labels[:, None, None], wsrc)
        for g in groups:
            sign, amp, tgt = _block_images(g, labels, V, F)
            scatter(amp * sign[..., None], tgt, wsrc)
    return y
