"""Operator application in the variational (vrnl) sector.

Port of ``quantum_basis_tpu.ops.apply_vrnl``: the counterparts of
``model::MultMv`` over the explicit vrnl matrix, ``moprXgs_vrnl``
(reference: src/model.cc:1915-1984), ``moprXvec_vrnl``
(src/model.cc:1987-2074), and ``measure_vrnl_static_trans_invariant``
(src/model.cc:2077-2129). All use the batched canonicalization of
:class:`quantum_basis_tpu_torch.basis.vrnl.CenterTranslator`; phases follow
the 2*pi-ful convention documented there. Vectors are complex128 tensors on
the translator's device; the lookups (``torch.searchsorted``) and the sums
(``index_add_``, whose order is not fixed on a CUDA device) stay there.

Deliberate divergence from the reference, kept from the JAX package:
``translate2center_OBC`` computes the fermion parity of the canonicalizing
translation and then discards it (src/basis.cc:678-680 — ``int sgn`` never
applied), so the reference's whole vrnl sector silently drops translation
signs for fermionic states. We keep them (the ``csign`` factor from
``canonicalize_vf``) — identical for spin/boson polarons, physically correct
for fermionic ones.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply import _block_images, _group_device
from quantum_basis_tpu_torch.ops.compile import (
    CompiledOperator,
    compile_diagonal_complex,
    compile_operator,
)
from quantum_basis_tpu_torch.ops.sparse import EllMatrix


def _coo_to_ell(n, rows, cols, vals):
    """COO entries -> ELL (cols (n, width) int32, vals (n, width)), each
    row's entries in their COO order; padding is column 0 with value 0."""
    order = np.argsort(rows, kind="stable")
    rows, cols, vals = rows[order], cols[order], vals[order]
    counts = np.bincount(rows, minlength=n)
    width = int(counts.max()) if rows.size else 0
    slot = np.arange(rows.size) - np.repeat(np.cumsum(counts) - counts, counts)
    ell_cols = np.zeros((n, width), dtype=np.int32)
    ell_vals = np.zeros((n, width), dtype=vals.dtype)
    ell_cols[rows, slot] = cols
    ell_vals[rows, slot] = vals
    return ell_cols, ell_vals


class MatvecVrnl(EllMatrix):
    """y = H_vrnl(k) x from the momentum-rephased COO skeleton, on device.

    The skeleton is re-phased on the host and folded into an ELL matrix
    (the port's :class:`EllMatrix`): with ``upper_triangle`` the i <= j
    entries and, mirrored, the conjugates of the strict-upper ones — the
    same Hermitization by construction as the reference's upper-triangle
    build + Hermitian SpMV descriptor (src/model.cc:910-918,
    src/sparse.cc:276-301). Each row sums its own entries, so the apply has
    no scatter. The vrnl sector is always complex (phases). The matrix lives
    on the skeleton's device.
    """

    def __init__(self, vmat, momentum, upper_triangle: bool = True):
        device = vmat.ct.device
        momentum = np.asarray(momentum, dtype=np.float64)
        ang = 2.0 * np.pi * (vmat.disp @ momentum)
        val = np.conj((vmat.amp_re + 1j * vmat.amp_im) * np.exp(1j * ang))
        rows, cols = vmat.rows, vmat.cols
        if upper_triangle:
            keep = rows <= cols
            rows, cols, val = rows[keep], cols[keep], val[keep]
            strict = rows < cols
            # mirrored strict-lower part: H[j, i] = conj(H[i, j])
            rows, cols, val = (np.concatenate([rows, cols[strict]]),
                               np.concatenate([cols, rows[strict]]),
                               np.concatenate([val, np.conj(val[strict])]))
        ell_cols, ell_vals = _coo_to_ell(vmat.n, rows, cols,
                                         val.astype(np.complex128))
        super().__init__(torch.as_tensor(ell_cols, device=device),
                         torch.as_tensor(ell_vals, device=device),
                         torch.as_tensor(vmat.diag, device=device))


def _images_canon(compiled: CompiledOperator, ct, labels: torch.Tensor,
                  chunk: int = 1 << 14):
    """All images of device labels, with canonical form and displacement.

    Yields, per row chunk and term group, (first row of the chunk,
    amp (B, M) complex128 incl. the canonicalization sign,
    canon (B, M) int64, disp (B, M, dim) int64), all on the device.
    """
    groups = [_group_device(g, ct.device) for g in compiled.groups]
    for start in range(0, labels.numel(), chunk):
        lab = labels[start:start + chunk]
        V, F = ct._decode(lab)
        B = lab.shape[0]
        for g in groups:
            sign, amp, tgt = _block_images(g, lab, V, F)
            tgt_f = tgt.reshape(B, -1)
            M = tgt_f.shape[1]
            a = (amp * sign[..., None]).reshape(B, M)
            canon, disp, csign = ct.canonicalize_vf(
                *ct._decode(tgt_f.reshape(-1)))
            yield (start, (a * csign.view(B, M)).to(torch.complex128),
                   canon.view(B, M), disp.view(B, M, -1))


def _phases(disp: torch.Tensor, momentum) -> torch.Tensor:
    """e^{2 pi i k.disp} for device displacements (..., dim)."""
    k = torch.as_tensor(np.asarray(momentum, dtype=np.float64),
                        device=disp.device)
    return torch.exp(1j * (2.0 * np.pi * (disp.to(torch.float64) @ k)))


def _locate(lab_sorted: torch.Tensor, sorter: torch.Tensor, labels):
    """(index into the unsorted labels, found mask) of device ``labels``."""
    n = lab_sorted.numel()
    pos = torch.searchsorted(lab_sorted, labels).clamp(0, max(n - 1, 0))
    if n == 0:
        return pos, torch.zeros(labels.shape, dtype=torch.bool,
                                device=labels.device)
    return sorter[pos], lab_sorted[pos] == labels


def mopr_x_gs_vrnl(Bq, sector, ct) -> torch.Tensor:
    """vec[j] = sqrt(omega_g) sum <gs| T-canon | Bq_dagger basis[j]> phases.

    Reference: model::moprXgs_vrnl (src/model.cc:1915-1984) — builds
    B_q |gs,k> expressed over the vrnl basis at the sector momentum.
    Returns a complex128 tensor on the device.
    """
    Bq_dg = compile_operator(Bq.dagger(), ct.space)
    labels = torch.as_tensor(sector.labels, device=ct.device)
    sqrt_wg = float(np.sqrt(float(sector.gs_omega)))
    vec = torch.zeros(labels.numel(), dtype=torch.complex128,
                      device=ct.device)
    for start, amp, canon, disp in _images_canon(Bq_dg, ct, labels):
        hit = canon == int(sector.gs_label)
        contrib = torch.where(hit, (amp * _phases(disp, sector.momentum))
                              .conj(), 0.0)
        vec[start:start + amp.shape[0]] += sqrt_wg * contrib.sum(dim=1)
    return vec


def mopr_x_vec_vrnl(Bq, sec_old, sec_new, ct, x) -> tuple[torch.Tensor,
                                                           complex]:
    """(y, pG): y = Bq x mapped into the target vrnl sector, pG the amplitude
    shed onto the ground state (reference: src/model.cc:1987-2074).

    ``x`` is a vector over sec_old's basis (numpy or tensor); phases use the
    TARGET sector momentum, matching the reference. ``y`` is a complex128
    tensor on the device.
    """
    space = ct.space
    dev = ct.device
    compiled = compile_operator(Bq, space)
    labels_old = torch.as_tensor(sec_old.labels, device=dev)
    labels_new = np.asarray(sec_new.labels, dtype=np.int64)
    sqrt_wg = float(np.sqrt(float(sec_new.gs_omega)))
    x = torch.as_tensor(x, device=dev).to(torch.complex128)
    y = torch.zeros(labels_new.size, dtype=torch.complex128, device=dev)
    pG = torch.zeros((), dtype=torch.complex128, device=dev)
    capture = float(sec_new.gs_norm) > 1e-12

    order = np.argsort(labels_new)
    sorter = torch.as_tensor(order, device=dev)
    lab_sorted = torch.as_tensor(labels_new[order], device=dev)

    # diagonal part: same state, new sector index, no phase (disp = 0)
    if not compiled.diag_terms.q_zero() and labels_new.size > 0:
        ev = compile_diagonal_complex(compiled.diag_terms, space)
        dvals = torch.as_tensor(ev(space.decode(np.asarray(sec_old.labels))),
                                device=dev)
        j, ok = _locate(lab_sorted, sorter, labels_old)
        y.index_add_(0, j[ok], (dvals * x)[ok])

    for start, amp, canon, disp in _images_canon(compiled, ct, labels_old):
        B = amp.shape[0]
        coef = x[start:start + B, None] * amp * _phases(disp, sec_new.momentum)
        is_gs = canon == int(sec_new.gs_label)
        if capture:
            pG = pG + torch.where(is_gs, coef, 0.0).sum() / sqrt_wg
        if labels_new.size == 0:
            continue  # target basis is only the (removed) gs; pG still counts
        j, ok = _locate(lab_sorted, sorter, canon.reshape(-1))
        if capture:
            ok &= ~is_gs.reshape(-1)
        y.index_add_(0, j[ok], coef.reshape(-1)[ok])
    return y, complex(pG)


def measure_vrnl_static(lhs, sector, ct, eigenvec) -> complex:
    """<phi| lhs |phi> over a vrnl sector eigenvector (translation-invariant
    lhs assumed; reference: src/model.cc:2077-2129, with the phase fixed to
    the 2*pi-ful convention). ``eigenvec``: numpy or tensor."""
    space = ct.space
    dev = ct.device
    compiled = compile_operator(lhs, space)
    labels_np = np.asarray(sector.labels, dtype=np.int64)
    labels = torch.as_tensor(labels_np, device=dev)
    phi = torch.as_tensor(eigenvec, device=dev).to(torch.complex128)
    result = torch.zeros((), dtype=torch.complex128, device=dev)

    if not compiled.diag_terms.q_zero():
        ev = compile_diagonal_complex(compiled.diag_terms, space)
        dvals = torch.as_tensor(ev(space.decode(labels_np)), device=dev)
        result = result + (phi.abs() ** 2 * dvals).sum()

    order = np.argsort(labels_np)
    sorter = torch.as_tensor(order, device=dev)
    lab_sorted = torch.as_tensor(labels_np[order], device=dev)
    for start, amp, canon, disp in _images_canon(compiled, ct, labels):
        B = amp.shape[0]
        coef = phi[start:start + B, None] * amp * _phases(disp,
                                                          sector.momentum)
        m, ok = _locate(lab_sorted, sorter, canon.reshape(-1))
        result = result + (phi[m[ok]].conj() * coef.reshape(-1)[ok]).sum()
    return complex(result)
