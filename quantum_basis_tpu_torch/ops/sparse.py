"""Explicit sparse Hamiltonian: ELL extraction + device SpMV.

Port of ``quantum_basis_tpu.ops.sparse`` (reference LIL -> CSR pipeline,
``generate_Ham_sparse_full/repr``, src/model.cc:619-836, src/sparse.cc). Rows
are stored fixed-width (ELL): ``cols (n, W) int64`` + ``vals (n, W)``
(complex128, or float64 for a real matrix) + real ``diag (n,)``. The SpMV
is one gather ``x[cols]`` and a row reduction.

The builds reuse the matrix-free image machinery (``_row_images`` over a
full sector's packed tables, ``apply_repr.repr_images`` for a momentum
sector) in one device pass over row blocks; duplicate columns are merged
per block on the device by :func:`compact_rows`, which folds runs in the
same order as the JAX package's numpy ``_compact_rows_np``.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply import _row_images

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
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_complex:
            x = x.to(torch.complex128)
        self.n_applies += 1
        return self.diag * x + (self.vals * x[self.cols]).sum(dim=1)


def _assemble(cols_l, vals_l, n, diag_b) -> EllMatrix:
    """Pad the per-block compacted rows to one width and stack them."""
    width = max(c.shape[1] for c in cols_l)

    def padw(a):
        return torch.nn.functional.pad(a, (0, width - a.shape[1]))

    cols = torch.cat([padw(c) for c in cols_l])[:n]
    vals = torch.cat([padw(v) for v in vals_l])[:n]
    return EllMatrix(cols, vals, diag_b.reshape(-1)[:n])


def build_sparse_full(matvec) -> EllMatrix:
    """Extract the explicit matrix from a MatvecFull (one device pass).

    Row i's entries are H[i, j] = conj(A) * sign over the images of
    applying the operator's packed tables (``matvec.tables``) to |i> (the
    same Hermitian row-gather direction as the matrix-free apply). Values
    are float64 when every term group is real, else complex128.
    """
    db = matvec.basis
    B = db.block_rows
    tabs = matvec.tables
    vdt = torch.complex128 if matvec.is_complex else torch.float64
    row_iota = torch.arange(B, device=db.device)
    cols_l, vals_l = [], []
    for b in range(db.n_blocks):
        row_ok = ((b * B + row_iota) < db.n)[:, None]
        if tabs.n_cols:
            fodd = None if db.fodd is None else db.fodd[b * B:(b + 1) * B]
            amp, tgt = _row_images(tabs, db.labels_b[b], db.V_b[b], fodd)
            # images always land in the sector
            j = db.index.lookup(tgt)
            cols = torch.where(row_ok, j, -1)
            vals = torch.where(row_ok, amp.conj().to(vdt), 0.0)
        else:
            cols = torch.zeros((B, 0), dtype=torch.int64, device=db.device)
            vals = torch.zeros((B, 0), dtype=vdt, device=db.device)
        c, v = compact_rows(cols, vals)
        cols_l.append(c)
        vals_l.append(v)
    return _assemble(cols_l, vals_l, db.n, matvec.diag_b)


def build_sparse_repr(matvec) -> EllMatrix:
    """Extract the explicit momentum-sector matrix from a MatvecRepr.

    Same coefficients as the matrix-free row kernel:
    H[i, j] = sqrt(nu_j/nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}}
    (cf. generate_Ham_sparse_repr, src/model.cc:729-829): one
    ``repr_images`` launch a row block through the matvec's launch
    record (``ops/apply_repr.py``; the kernel on the card), its columns
    merged by :func:`compact_rows`.
    """
    rb = matvec.basis
    images = matvec.record("repr_images")
    B = rb.block_rows
    cols_l, vals_l = [], []
    for b in range(rb.n_blocks):
        rows = min(B, rb.n - b * B)
        cols, vals = images.images(b * B, rows)
        c, v = compact_rows(cols, vals)
        cols_l.append(c)
        vals_l.append(v)
    return _assemble(cols_l, vals_l, rb.n, matvec.diag_b)


def hermiticity_exact(ell: EllMatrix, tol: float = 1e-9) -> None:
    """Exact O(nnz) Hermiticity verification of an ELL matrix.

    Parity with the reference's full-matrix check (src/sparse.cc:235-256,
    which walks every CSR entry and exit(99)s on mismatch): every stored
    entry (i, j, v) must be matched by (j, i, conj(v)) to ``tol``. The
    randomized :func:`hermiticity_probe` can miss a single-entry asymmetry
    below its global tolerance; this one cannot. Cost: two sorts of the nnz
    stream on the matrix's device. Raises AssertionError with the worst
    offender.
    """
    n, W = ell.n, ell.width
    if W == 0 or n == 0:
        return
    rows = torch.arange(n, device=ell.device).repeat_interleave(W)
    cols = ell.cols.reshape(-1)
    vals = ell.vals.reshape(-1).to(torch.complex128)
    live = vals != 0
    rows, cols, vals = rows[live], cols[live], vals[live]

    def canon(keys, v):
        """Sort by key and merge duplicate keys (defensive; compaction
        normally leaves none)."""
        k, inv = torch.unique(keys, return_inverse=True)
        return k, torch.zeros(k.numel(), dtype=v.dtype,
                              device=v.device).index_add_(0, inv, v)

    k_f, v_f = canon(rows * n + cols, vals)
    k_t, v_t = canon(cols * n + rows, vals.conj())
    if k_f.shape != k_t.shape or bool((k_f != k_t).any()):
        # an entry (i, j) has no transpose partner at all
        kf, kt = k_f.cpu().numpy(), k_t.cpu().numpy()
        only_f, only_t = np.setdiff1d(kf, kt), np.setdiff1d(kt, kf)
        bad = int((only_f if only_f.size else only_t)[0])
        raise AssertionError(
            f"H not Hermitian: entry ({bad // n}, {bad % n}) unpaired "
            "(cf. csr_mat check, src/sparse.cc:235-256)")
    err = (v_f - v_t).abs()
    scale = v_f.abs().clamp(min=1.0)
    worst = int(torch.argmax(err / scale)) if err.numel() else 0
    if err.numel() and float(err[worst]) > tol * float(scale[worst]):
        i, j = int(k_f[worst]) // n, int(k_f[worst]) % n
        raise AssertionError(
            f"H not Hermitian: H[{i},{j}]={complex(v_f[worst]):.12g} vs "
            f"conj(H[{j},{i}])={complex(v_t[worst]):.12g} "
            "(cf. csr_mat check, src/sparse.cc:235-256)")


def hermiticity_probe(matvec_or_ell, n: int, complex_vec: bool,
                      n_probes: int = 3, seed: int = 11, tol: float = 1e-9):
    """Randomized Hermiticity check: <z|Hx> == conj(<x|Hz>).

    The cheap counterpart of the reference's full-matrix verification
    (src/sparse.cc:235-256, exit(99) on failure): O(probes * SpMV) instead
    of O(nnz) walks; raises AssertionError on failure.
    """
    rng = np.random.default_rng(seed)
    mv = matvec_or_ell

    def draw():
        v = rng.normal(size=n)
        if complex_vec:
            v = v + 1j * rng.normal(size=n)
        return torch.as_tensor(v, device=mv.device)

    for _ in range(n_probes):
        x, z = draw(), draw()
        lhs = complex(torch.vdot(z, mv(x).to(z.dtype)))
        rhs = complex(torch.vdot(mv(z).to(x.dtype), x))
        err = abs(lhs.real - rhs.real) + abs(lhs.imag - rhs.imag)
        if err > tol * max(1.0, abs(lhs.real)):
            raise AssertionError(
                f"H failed the Hermiticity probe: err={err:.3e} "
                "(cf. csr_mat check, src/sparse.cc:235-256)")
