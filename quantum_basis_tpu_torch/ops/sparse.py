"""Explicit sparse Hamiltonian: ELL extraction + device SpMV.

Port of ``quantum_basis_tpu.ops.sparse`` (reference LIL -> CSR pipeline,
``generate_Ham_sparse_full/repr``, src/model.cc:619-836, src/sparse.cc). Rows
are stored fixed-width (ELL): ``cols (n, W) int32`` (as the JAX package
stores them) + ``vals (n, W)`` (complex128, or float64 for a real matrix) +
real ``diag (n,)``, padded slots (column 0, value 0); each row's length,
:func:`row_lengths`, is 1 + its last slot of nonzero value. The SpMV runs
``csrc/ell_spmv.cu`` on the card (built with nvcc for sm_90a at first use,
ops/cuda_build.py) through a launch record, :class:`EllLaunch`, built once
per matrix; CPU tensors take the plain version, a gather ``x[cols]`` and a
row reduction. :func:`ell_spmv` is the same apply on bare arrays.

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
from quantum_basis_tpu_torch.ops.apply import _device_of
from quantum_basis_tpu_torch.ops.ell_build import ell_rows

_SRC = cuda_build.CSRC / "ell_spmv.cu"

# The kernel's group sizes (lanes a row), one instance each
GROUPS = (1, 2, 4, 8, 16, 32)

# Slots a pass of row_lengths takes at most (its (rows, W) intermediate)
_ROWLEN_SLOTS = 1 << 24

# Launches of ell_spmv since the last reset (the CPU plain version is not
# counted): lets a run show that its solves went through the kernel.
launch_count = 0

_lib = None


class _Args(ctypes.Structure):
    """csrc/ell_spmv.cu::Args, field by field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "cols", "vals", "rowlen", "diag", "xd", "xs", "y")]
        + [("n", ctypes.c_longlong)]
        + [(f, ctypes.c_int) for f in (
            "W", "G", "cols64", "vals_complex", "x_complex")])


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/ell_spmv.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        lib.qbt_ell_args_size.restype = ctypes.c_longlong
        if lib.qbt_ell_args_size() != ctypes.sizeof(_Args):
            raise RuntimeError("csrc/ell_spmv.cu's Args and _Args differ in "
                               "size")
        lib.qbt_ell_spmv.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        lib.qbt_ell_spmv.restype = ctypes.c_int
        _lib = lib
    return _lib


def row_lengths(vals: torch.Tensor) -> torch.Tensor:
    """Each row's length in an (n, W) ELL, (n,) int32 on ``vals``' device:
    1 + the row's last slot whose value is nonzero, 0 for a row of padding.
    The one rule for every producer's ELL; the kernel reads a row's slots
    below it and no other."""
    n, W = vals.shape
    out = torch.zeros(n, dtype=torch.int32, device=vals.device)
    if n and W:
        slot = torch.arange(1, W + 1, dtype=torch.int32, device=vals.device)
        step = max(1, _ROWLEN_SLOTS // W)
        for i in range(0, n, step):
            out[i:i + step] = ((vals[i:i + step] != 0) * slot).amax(dim=1)
    return out


def group_size(rowlen: torch.Tensor) -> int:
    """The kernel's lanes a row for these row lengths: the power of two at
    or above half their mean, at most 32, so that a lane takes about two
    of a row's slots (longer rows loop; ``benchmarks/ell_variants.py``
    times half and twice it, and the power of two at or above the mean).
    One host sync."""
    n = rowlen.numel()
    half = float(rowlen.sum(dtype=torch.int64)) / (2 * n) if n else 0.0
    return next((g for g in GROUPS if g >= half), GROUPS[-1])


def _ell_spmv_plain(cols, vals, diag, xd, xs):
    """Plain PyTorch :func:`ell_spmv`: the gather, the products and the
    row sum as torch ops (two (n, W) intermediates)."""
    return diag * xd + (vals * xs[cols]).sum(dim=1)


def _need(name, t, dtypes, shape, dev):
    if (t.dtype not in dtypes or t.shape != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(f"ell_spmv: {name} must be a contiguous "
                         f"{' or '.join(map(str, dtypes))} tensor of shape "
                         f"{shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if t.numel() and t.data_ptr() % t.element_size():
        raise ValueError(f"ell_spmv: {name} is not aligned to its elements")


def _check_matrix(cols, vals, diag, rowlen=None):
    """What the kernel takes of a matrix (once per launch record); rowlen
    where given."""
    if vals.dim() != 2 or vals.dtype not in (torch.float64,
                                             torch.complex128):
        raise ValueError(f"ell_spmv takes (n, W) float64 or complex128 "
                         f"values, got {vals.dtype} {tuple(vals.shape)}")
    n, W = vals.shape
    if n >= 2 ** 31 - 1:
        raise ValueError("ell_spmv takes fewer than 2 ** 31 - 1 rows")
    dev = diag.device
    _need("cols", cols, (torch.int32, torch.int64), (n, W), dev)
    _need("vals", vals, (vals.dtype,), (n, W), dev)
    _need("diag", diag, (torch.float64,), (n,), dev)
    if rowlen is not None:
        _need("rowlen", rowlen, (torch.int32,), (n,), dev)


def _check_x(xd, xs, n, W, dev):
    """What the kernel takes of x (every call): ``xd`` (n,) and ``xs`` of
    one type (float64 or complex128), contiguous, on the matrix's device."""
    _need("xd", xd, (torch.float64, torch.complex128), (n,), dev)
    if xs is not xd:
        _need("xs", xs, (xd.dtype,), (xs.numel(),), dev)
    if W and n and not xs.numel():
        raise ValueError("ell_spmv: the columns index an empty xs")


class EllLaunch:
    """``ell_spmv``'s launch for one matrix on a CUDA device, built once (at
    an :class:`EllMatrix`'s first CUDA apply, once per ``EllShardedHalo``):
    the matrix's checks, its row lengths (``rowlen``, :func:`row_lengths`
    where not given), the group size (:func:`group_size`), the instance
    (int32 or int64 columns, the values' type) and the pointers. A call
    then checks and converts only x, allocates y and launches on the
    current stream. The record holds the matrix's tensors, which nothing
    may change after it is built."""

    def __init__(self, cols, vals, diag, rowlen=None):
        if _device_of(diag) != "cuda":
            raise ValueError("an EllLaunch runs on a CUDA device; CPU "
                             "tensors take the plain version")
        _check_matrix(cols, vals, diag, rowlen)
        if rowlen is None:
            rowlen = row_lengths(vals)
        self.device = diag.device
        self.n, self.width = vals.shape
        self.rowlen = rowlen
        self.group = group_size(rowlen)
        self.vals_complex = vals.is_complex()
        self._keep = (cols, vals, diag, rowlen)
        self.p = _Args(cols=cols.data_ptr(), vals=vals.data_ptr(),
                       rowlen=rowlen.data_ptr(), diag=diag.data_ptr(),
                       n=self.n, W=self.width, G=self.group,
                       cols64=int(cols.dtype == torch.int64),
                       vals_complex=int(self.vals_complex))
        self._pp = ctypes.byref(self.p)
        self._dev = self.device.index
        self._fn = None

    def __call__(self, xd: torch.Tensor,
                 xs: torch.Tensor | None = None) -> torch.Tensor:
        """y = diag xd + A xs (xs = xd where None), in complex128 where the
        values or x are complex, else float64."""
        global launch_count
        cplx = (self.vals_complex or xd.is_complex()
                or (xs is not None and xs.is_complex()))
        cdt = torch.complex128 if cplx else torch.float64
        if xd.dtype != cdt or not xd.is_contiguous():
            xd = xd.to(cdt).contiguous()
        if xs is None:
            xs = xd
        elif xs.dtype != cdt or not xs.is_contiguous():
            xs = xs.to(cdt).contiguous()
        _check_x(xd, xs, self.n, self.width, self.device)
        y = torch.empty(self.n, dtype=cdt, device=self.device)
        if not self.n:
            return y
        if self._fn is None:
            self._fn = build_library().qbt_ell_spmv
        p = self.p
        p.xd, p.xs, p.y = xd.data_ptr(), xs.data_ptr(), y.data_ptr()
        p.x_complex = cplx
        if torch._C._cuda_getDevice() == self._dev:
            err = self._enqueue()
        else:
            with torch.cuda.device(self.device):
                err = self._enqueue()
        if err != 0:
            raise RuntimeError(f"ell_spmv kernel launch failed: cudaError "
                               f"{err}")
        launch_count += 1
        return y

    def _enqueue(self) -> int:
        # the current stream's handle as an int, without a Stream object
        return self._fn(self._pp,
                        torch._C._cuda_getCurrentRawStream(self._dev))


def ell_spmv(cols: torch.Tensor, vals: torch.Tensor, diag: torch.Tensor,
             xd: torch.Tensor, xs: torch.Tensor | None = None) -> torch.Tensor:
    """y[i] = diag[i] xd[i] + sum_k vals[i, k] xs[cols[i, k]].

    ``cols`` (n, W) int32 or int64 and ``vals`` (n, W) float64 or complex128
    (padded slots column 0, value 0), ``diag`` (n,) float64; ``xd`` (n,) and
    ``xs`` the vector the columns index (``xd`` where None; the halo
    engine's ``[x_local | halo]``). x and y are complex128 where x or the
    values are complex, else float64. CPU tensors take the plain version;
    CUDA tensors launch the kernel through a launch record made for this
    call (or raise): an engine that applies one matrix many times keeps
    its :class:`EllLaunch`.
    """
    if _device_of(xd) == "cuda":
        return EllLaunch(cols, vals, diag)(xd, xs)
    cdt = (torch.complex128 if vals.is_complex() or xd.is_complex()
           or (xs is not None and xs.is_complex()) else torch.float64)
    xd = xd.to(cdt)
    return _ell_spmv_plain(cols, vals, diag, xd,
                           xd if xs is None else xs.to(cdt))


class EllMatrix:
    """Explicit H over a sector basis in ELL layout (device-resident):
    int32 columns (given int64, converted), the values, the diagonal, and
    the rows' lengths (``rowlen``): those its build gives (the full-sector
    build's ``ell_rows`` writes them), else derived once by
    :func:`row_lengths` at their first use, the first CUDA apply, with the
    :class:`EllLaunch` that applies it."""

    def __init__(self, cols: torch.Tensor, vals: torch.Tensor,
                 diag: torch.Tensor, rowlen: torch.Tensor | None = None):
        self.n = int(diag.shape[0])
        if self.n >= 2 ** 31 - 1:
            raise ValueError("an EllMatrix takes fewer than 2 ** 31 - 1 rows")
        self.width = int(cols.shape[1])
        self.cols = cols.to(torch.int32)
        self.vals = vals
        self.diag = diag
        self.device = diag.device
        self.dtype = torch.float64
        self.is_complex = vals.is_complex()
        self.n_applies = 0
        self._launch = None
        self._rowlen = rowlen

    @property
    def rowlen(self) -> torch.Tensor:
        if self._rowlen is None:
            self._rowlen = row_lengths(self.vals)
        return self._rowlen

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.n_applies += 1
        if _device_of(x) == "cpu":
            return ell_spmv(self.cols, self.vals, self.diag, x)
        if self._launch is None:
            self._launch = EllLaunch(self.cols, self.vals, self.diag,
                                     self.rowlen)
        return self._launch(x)


def build_sparse_full(matvec) -> EllMatrix:
    """Extract the explicit matrix from a MatvecFull (one device pass).

    Row i's entries are H[i, j] = conj(A) * sign over the images of
    applying the operator's packed tables (``matvec.tables``) to |i> (the
    same Hermitian row-gather direction as the matrix-free apply). Values
    are float64 when every term group is real, else complex128. On the card
    ``ell_rows`` (``ops/ell_build.py``) builds the rows and their lengths:
    two launches and one host sync a build.
    """
    db = matvec.basis
    cols, vals, rowlen = ell_rows(
        matvec.tables, db.index.tables, db.labels_b.view(-1),
        db.V_b.view(-1, db.space.n_slots), db.fodd, db.n, db.block_rows)
    return EllMatrix(cols, vals, matvec.diag_b.reshape(-1)[:db.n], rowlen)


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
    # int64: the keys rows * n + cols pass 2 ** 31 where n * n does
    cols = ell.cols.reshape(-1).long()
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
