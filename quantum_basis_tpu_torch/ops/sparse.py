"""Explicit sparse Hamiltonian: ELL extraction + device SpMV.

Port of the momentum-sector half of ``quantum_basis_tpu.ops.sparse``
(reference LIL -> CSR pipeline, src/model.cc:687-836, src/sparse.cc). Rows
are stored fixed-width (ELL): ``cols (n, W) int64`` + ``vals (n, W)``
(complex128, or float64 for a real matrix) + real ``diag (n,)``. The SpMV
is one gather ``x[cols]`` and a row reduction.

The build reuses the matrix-free image machinery (``MatvecRepr.images``) in
one device pass over row blocks; duplicate columns are merged per block on
the device by :func:`compact_rows`, which folds runs in the same order as
the JAX package's numpy ``_compact_rows_np``.
"""

from __future__ import annotations

import torch

_VAL_TOL = 1e-14  # drop |v| below this (reference sparse_precision)
_INVALID = 1 << 62


def compact_rows(cols: torch.Tensor, vals: torch.Tensor,
                 tol: float = _VAL_TOL):
    """Merge duplicate columns per row; drop entries with |re|+|im| <= tol.

    cols (n, W) int64, vals (n, W) real or complex. Returns (cols, vals)
    sorted by column within each row, invalid slots zeroed, trimmed to the
    widest surviving row.
    """
    def mag(v):
        return v.real.abs() + v.imag.abs() if v.is_complex() else v.abs()

    n, W = cols.shape
    cols = torch.where(mag(vals) > tol, cols, _INVALID)
    cols, order = torch.sort(cols, dim=1, stable=True)
    vals = vals.gather(1, order)
    # fold each run of equal columns into the run's last slot
    for k in range(W - 1):
        dup = cols[:, k] == cols[:, k + 1]
        vals[:, k + 1] = torch.where(dup, vals[:, k + 1] + vals[:, k],
                                     vals[:, k + 1])
        vals[:, k] = torch.where(dup, 0.0, vals[:, k])
        cols[:, k] = torch.where(dup, _INVALID, cols[:, k])
    valid = (mag(vals) > tol) & (cols < _INVALID)
    # stable re-sort pushing invalid entries right
    _, order = torch.sort((~valid).to(torch.int8), dim=1, stable=True)
    cols = cols.gather(1, order)
    vals = vals.gather(1, order)
    valid = valid.gather(1, order)
    width = int(valid.sum(dim=1).max()) if n else 0
    cols = torch.where(valid, cols, 0)
    vals = torch.where(valid, vals, 0.0)
    return cols[:, :width], vals[:, :width]


class EllMatrix:
    """Explicit H over a sector basis in ELL layout (device-resident)."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor,
                 diag: torch.Tensor):
        self.n = int(diag.shape[0])
        self.width = int(cols.shape[1])
        self.cols = cols
        self.vals = vals
        self.diag = diag
        self.device = diag.device
        self.dtype = torch.float64
        self.is_complex = vals.is_complex()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_complex:
            x = x.to(torch.complex128)
        return self.diag * x + (self.vals * x[self.cols]).sum(dim=1)


def build_sparse_repr(matvec) -> EllMatrix:
    """Extract the explicit momentum-sector matrix from a MatvecRepr.

    Same coefficients as the matrix-free row kernel:
    H[i, j] = sqrt(nu_j/nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}}
    (cf. generate_Ham_sparse_repr, src/model.cc:729-829).
    """
    rb = matvec.basis
    cols_l, vals_l = [], []
    for b in range(rb.n_blocks):
        parts = matvec.images(b)
        B = rb.block_rows
        cols = torch.cat([torch.where(valid & (coef != 0), j, -1).reshape(B, -1)
                          for j, valid, coef in parts], dim=1)
        vals = torch.cat([coef.reshape(B, -1) for _, _, coef in parts], dim=1)
        c, v = compact_rows(cols, vals)
        cols_l.append(c)
        vals_l.append(v)
    width = max(c.shape[1] for c in cols_l)

    def padw(a):
        return torch.nn.functional.pad(a, (0, width - a.shape[1]))

    cols = torch.cat([padw(c) for c in cols_l])[: rb.n]
    vals = torch.cat([padw(v) for v in vals_l])[: rb.n]
    return EllMatrix(cols, vals, matvec.diag_b.reshape(-1)[: rb.n])
