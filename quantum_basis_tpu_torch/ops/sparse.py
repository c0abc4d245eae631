"""Explicit sparse Hamiltonian: ELL extraction + device SpMV.

Port of ``quantum_basis_tpu.ops.sparse`` (reference LIL -> CSR pipeline,
``generate_Ham_sparse_full/repr``, src/model.cc:619-836, src/sparse.cc). Rows
are stored fixed-width (ELL): ``cols (n, W) int64`` + ``vals (n, W)``
(complex128, or float64 for a real matrix) + real ``diag (n,)``. The SpMV,
:func:`ell_spmv`, launches ``csrc/ell_spmv.cu`` on CUDA tensors (built with
nvcc for sm_90a at first use, ops/cuda_build.py) and runs the plain
version, a gather ``x[cols]`` and a row reduction, on CPU tensors.

The builds reuse the matrix-free image machinery (the packed tables of a
full sector, ``apply_repr.ReprLaunch.images`` for a momentum sector) and
take each row's images to its finished entries in the row stage of
``ops/ell_build.py`` (a warp a row inside the kernel on the card; the
torch ``ell_build.compact_rows`` on the CPU), which folds runs in the same
order as the JAX package's numpy ``_compact_rows_np``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quantum_basis_tpu_torch.ops import cuda_build
from quantum_basis_tpu_torch.ops.ell_build import ell_rows

_SRC = cuda_build.CSRC / "ell_spmv.cu"

# Launches of ell_spmv since the last reset (the CPU plain version is not
# counted): lets a run show that its solves went through the kernel.
launch_count = 0

_lib = None


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/ell_spmv.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        lib.qbt_ell_spmv.argtypes = ([ctypes.c_void_p] * 6
                                     + [ctypes.c_longlong, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p])
        lib.qbt_ell_spmv.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ell_spmv_plain(cols, vals, diag, xd, xs):
    """Plain PyTorch :func:`ell_spmv`: the gather, the products and the
    row sum as torch ops (two (n, W) intermediates)."""
    return diag * xd + (vals * xs[cols]).sum(dim=1)


def _check_cuda_args(cols, vals, diag, xd, xs):
    dev = diag.device
    if vals.dim() != 2 or vals.dtype not in (torch.float64,
                                             torch.complex128):
        raise ValueError(f"ell_spmv takes (n, W) float64 or complex128 "
                         f"values, got {vals.dtype} {tuple(vals.shape)}")
    n, W = vals.shape
    for name, t, dt, shape in (("cols", cols, torch.int64, (n, W)),
                               ("vals", vals, vals.dtype, (n, W)),
                               ("diag", diag, torch.float64, (n,)),
                               ("xd", xd, xd.dtype, (n,)),
                               ("xs", xs, xd.dtype, (xs.shape[0],))):
        if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"ell_spmv: {name} must be a contiguous {dt} "
                             f"tensor of shape {shape} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.numel() and t.data_ptr() % t.element_size():
            raise ValueError(f"ell_spmv: {name} is not aligned to its "
                             f"elements")
    if W and n and not xs.numel():
        raise ValueError("ell_spmv: the columns index an empty xs")


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
             xd: torch.Tensor, xs: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = diag[i] xd[i] + sum_k vals[i, k] xs[cols[i, k]].

    ``cols`` (n, W) int64 and ``vals`` (n, W) float64 or complex128 (padded
    slots column 0, value 0), ``diag`` (n,) float64; ``xd`` (n,) and ``xs``
    the vector the columns index (``xd`` where None; the halo engine's
    ``[x_local | halo]``). x and y are complex128 where x or the values
    are complex, else float64. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise).
    """
    global launch_count
    cdt = (torch.complex128 if vals.is_complex() or xd.is_complex()
           or (xs is not None and xs.is_complex()) else torch.float64)
    xd = xd.to(cdt).contiguous()
    xs = xd if xs is None else xs.to(cdt).contiguous()
    if xd.device.type == "cpu":
        return _ell_spmv_plain(cols, vals, diag, xd, xs)
    if xd.device.type != "cuda":
        raise ValueError(f"ell_spmv: unsupported device {xd.device}")
    _check_cuda_args(cols, vals, diag, xd, xs)
    n, W = vals.shape
    y = torch.empty(n, dtype=cdt, device=xd.device)
    if not n:
        return y
    lib = build_library()
    with torch.cuda.device(xd.device):
        err = lib.qbt_ell_spmv(
            cols.data_ptr(), vals.data_ptr(), diag.data_ptr(),
            xd.data_ptr(), xs.data_ptr(), y.data_ptr(), n, W,
            int(vals.is_complex()), int(cdt == torch.complex128),
            torch.cuda.current_stream(xd.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: cudaError {err}")
    launch_count += 1
    return y


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
        self.n_applies += 1
        return ell_spmv(self.cols, self.vals, self.diag, x)


def build_sparse_full(matvec) -> EllMatrix:
    """Extract the explicit matrix from a MatvecFull (one device pass).

    Row i's entries are H[i, j] = conj(A) * sign over the images of
    applying the operator's packed tables (``matvec.tables``) to |i> (the
    same Hermitian row-gather direction as the matrix-free apply). Values
    are float64 when every term group is real, else complex128. On the card
    ``ell_rows`` (``ops/ell_build.py``) builds the rows: two launches and
    one host sync a build.
    """
    db = matvec.basis
    cols, vals = ell_rows(matvec.tables, db.index.tables, db.labels_b.view(-1),
                          db.V_b.view(-1, db.space.n_slots), db.fodd, db.n,
                          db.block_rows)
    return EllMatrix(cols, vals, matvec.diag_b.reshape(-1)[:db.n])


def build_sparse_repr(matvec) -> EllMatrix:
    """Extract the explicit momentum-sector matrix from a MatvecRepr.

    Same coefficients as the matrix-free row kernel:
    H[i, j] = sqrt(nu_j/nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}}
    (cf. generate_Ham_sparse_repr, src/model.cc:729-829): the finished rows
    of the whole sector from the matvec's ``repr_images`` launch record
    (``ops/apply_repr.py``; on the card two launches and one host sync).
    """
    rb = matvec.basis
    cols, vals = matvec.record("repr_images").images(0, rb.n, rb.block_rows)
    return EllMatrix(cols, vals, matvec.diag_b.reshape(-1)[:rb.n])


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
