"""Matrix-free operator application on the device.

Port of ``quantum_basis_tpu.ops.apply`` — the equivalent of
``model::MultMv2`` (reference: src/model.cc:941-1121) — with native
float64/complex128 vectors in place of split (re, im) pairs. Per row block:

1. slot values V and fermion counts F are precomputed per state (int8
   storage, widened per block);
2. joint columns c = V[slots] . jstrides;
3. the Jordan-Wigner parities of all terms at once, (F @ W^T) mod 2, in
   float64 (exact for these small integer sums);
4. the amplitude and label-displacement table lookups, hence the target
   labels of every image, and their row indices through the basis index;
5. y[i] = diag[i] x[i] + sum conj(amp) * sign * x[j] — the Hermitian
   row-gather direction: applying H to basis state i enumerates <j|H|i>, so
   row i of H is the conjugate, and every row is computed independently with
   no scatters (:class:`MatvecFull`).

:func:`mopr_x_vec` is the scatter direction, y[j] += amp * sign * x[i], for
operators that are not Hermitian or map one sector into another.

Row blocks run in a Python loop; the device's ``apply_block_budget``
(``config.MEMORY``) bounds the (rows, terms, images) intermediates of one
block.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.ops.compile import CompiledOperator, compile_diagonal


def _choose_block(n: int, work_per_row: int, device) -> int:
    b = max(1024, config.memory("apply_block_budget", device)
            // max(work_per_row, 1))
    b = 1 << int(math.floor(math.log2(b)))
    return int(min(b, n))


class DeviceBasis:
    """Device-resident per-state data, padded into uniform row blocks.

    Holds labels (nb, B) int64, decoded slot values V (nb, B, S) int8 and
    fermion counts F (nb, B, S) int8 — shared by the Hamiltonian apply and
    all measurement operators on the same sector. Padding rows repeat the
    first label.
    """

    def __init__(self, space, labels: np.ndarray, index: BasisIndex | None = None,
                 block_rows: int | None = None, work_per_row: int = 16,
                 device="cuda"):
        labels = np.asarray(labels, dtype=np.int64)
        if space.dim_max > 127:
            raise ValueError("local dimensions above 127 do not fit int8")
        self.space = space
        self.device = torch.device(device)
        self.n = int(labels.size)
        if index is None:
            index = BasisIndex(labels, space.label_space,
                               lin_split=digit_split(space), device=device)
        self.index = index
        B = int(min(block_rows, max(self.n, 1))) if block_rows else max(
            _choose_block(self.n, work_per_row * space.n_slots, device), 1)
        nb = max(1, -(-self.n // B))
        pad = nb * B - self.n
        lab_pad = np.concatenate(
            [labels, np.full(pad, labels[0] if self.n else 0, np.int64)])
        self.block_rows = B
        self.n_blocks = nb
        self.pad = pad
        self.labels_np = labels
        self.labels_b = torch.as_tensor(lab_pad.reshape(nb, B),
                                        device=self.device)
        V = space.decode(self.labels_b)                          # (nb, B, S)
        self.V_b = V.to(torch.int8)
        if space.fermionic:
            Ftab = torch.as_tensor(space.fermion_count_table,
                                   device=self.device)
            self.F_b = Ftab[torch.arange(space.n_slots, device=self.device),
                            V].to(torch.int8)
        else:
            self.F_b = torch.zeros_like(self.V_b)

    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) -> (n_blocks, block_rows), zero padded."""
        return torch.nn.functional.pad(x, (0, self.pad)).view(
            self.n_blocks, self.block_rows)


def _group_device(group, device):
    """Move one TermGroup's tables to the device, flattening (T, D)."""
    T, D, K = group.dlt.shape
    amp = group.amp_re.reshape(T * D, K)
    if group.amp_im is not None:
        amp = amp + 1j * group.amp_im.reshape(T * D, K)
    return dict(
        slots=torch.as_tensor(group.slots.astype(np.int64), device=device),
        jstrides=torch.as_tensor(group.jstrides, device=device),
        dlt=torch.as_tensor(group.dlt.reshape(T * D, K), device=device),
        amp=torch.as_tensor(amp, device=device),
        # JW weight vectors (S, T); None when no term carries a string
        W=torch.as_tensor(group.W.T.astype(np.float64), device=device)
        if group.W.any() else None,
        D=D,
        T=T,
    )


def _block_lookup(g, labels, V, F):
    """Per block: (sign float64, (B, T) or broadcastable to it; the row of
    each term's tables, (B, T); target labels (B, T, K))."""
    c = (V[:, g["slots"]].long() * g["jstrides"]).sum(dim=-1)    # (B, T)
    if g["W"] is None:
        sign = torch.ones((1, 1), dtype=torch.float64, device=V.device)
    else:
        sign = 1.0 - 2.0 * torch.remainder(F.to(torch.float64) @ g["W"], 2.0)
    flat = torch.arange(g["T"], device=V.device) * g["D"] + c
    tgt = labels[:, None, None] + g["dlt"][flat]                  # (B, T, K)
    return sign, flat, tgt


def _block_images(g, labels, V, F):
    """Per block: (sign float64, (B, T) or broadcastable to it; amplitudes
    (B, T, K); target labels (B, T, K))."""
    sign, flat, tgt = _block_lookup(g, labels, V, F)
    return sign, g["amp"][flat], tgt


def _device_diag(compiled: CompiledOperator, dbasis: DeviceBasis):
    """The real diagonal part over the padded blocks, (nb, B), or None."""
    if compiled.diag_terms.q_zero():
        return None
    return compile_diagonal(compiled.diag_terms, compiled.space)(dbasis.V_b)


def apply_block_rows(groups, index, labels, V, F, diag, xb, x):
    """One block of rows of y = H x (Hermitian row-gather direction).

    ``xb`` is this block's slice of x, ``x`` the full vector the gathers
    read from.
    """
    y = diag * xb
    for g in groups:
        sign, amp, tgt = _block_images(g, labels, V, F)
        j = index.lookup(tgt)
        # y[i] += conj(amp) * sign * x[j]
        y = y + (amp.conj() * sign[..., None] * x[j]).sum(dim=(1, 2))
    return y


class MatvecFull:
    """Matrix-free y = H x over a fixed basis (full or quantum-number sector).

    ``H`` must be Hermitian and conserve the sector (every image stays in the
    basis). Use :func:`mopr_x_vec` for general operators. A real H applied to
    a complex vector acts on both parts; a complex H needs a complex vector.
    """

    def __init__(self, compiled: CompiledOperator, dbasis: DeviceBasis):
        self.compiled = compiled
        self.basis = dbasis
        self.n = dbasis.n
        self.device = dbasis.device
        self.dtype = torch.float64
        self.groups = [_group_device(g, self.device) for g in compiled.groups]
        self.is_complex = any(g["amp"].is_complex() for g in self.groups)
        # precompute the diagonal once (reference: Ham_diag fast path)
        diag = _device_diag(compiled, dbasis)
        self.diag_b = diag if diag is not None else torch.zeros(
            dbasis.labels_b.shape, dtype=torch.float64, device=self.device)
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_complex and not x.is_complex():
            raise ValueError("complex Hamiltonian applied to real vector")
        x = x.to(torch.complex128 if x.is_complex() else torch.float64)
        b = self.basis
        xb = b.pad_vec(x)
        y = torch.empty_like(xb)
        for k in range(b.n_blocks):
            y[k] = apply_block_rows(self.groups, b.index, b.labels_b[k],
                                    b.V_b[k], b.F_b[k], self.diag_b[k],
                                    xb[k], x)
        self.n_applies += 1
        return y.reshape(-1)[: self.n]


def mopr_x_vec(compiled: CompiledOperator, src: DeviceBasis, dst: DeviceBasis,
               x: torch.Tensor) -> torch.Tensor:
    """General (non-Hermitian-trick) application: y = O x, scatter direction.

    ``src``/``dst`` may be different sectors (e.g. A_q maps Sz -> Sz-1 for
    dynamical structure factors; reference: model::moprXvec_full,
    src/model.cc:1468-1548). Images that leave ``dst`` are dropped, matching
    the reference's binary-search miss behavior. The sums go through
    ``index_add_``, whose order is not fixed on a CUDA device: two runs may
    differ in the last bits.
    """
    dev = src.device
    groups = [_group_device(g, dev) for g in compiled.groups]
    cplx = x.is_complex() or any(g["amp"].is_complex() for g in groups)
    dtype = torch.complex128 if cplx else torch.float64
    xb = src.pad_vec(x.to(dtype))
    diag_b = _device_diag(compiled, src)
    y = torch.zeros(dst.n, dtype=dtype, device=dev)
    row_iota = torch.arange(src.block_rows, device=dev)
    for b in range(src.n_blocks):
        labels, V, F = src.labels_b[b], src.V_b[b], src.F_b[b]
        row_ok = (b * src.block_rows + row_iota) < src.n
        if diag_b is not None:
            j, valid = dst.index.lookup_checked(labels)
            y.index_add_(0, j, torch.where(valid & row_ok,
                                           diag_b[b] * xb[b], 0.0))
        for g in groups:
            sign, amp, tgt = _block_images(g, labels, V, F)
            j, valid = dst.index.lookup_checked(tgt)
            ok = valid & row_ok[:, None, None]
            # y[j] += amp * sign * x[i]   (no conjugate: forward direction)
            contrib = torch.where(ok, amp * sign[..., None], 0.0) \
                * xb[b][:, None, None]
            y.index_add_(0, j.reshape(-1), contrib.to(dtype).reshape(-1))
    return y
