"""Block-sparse-row (BSR) matrices and the hand-written CUDA SpMV kernel.

Port of ``quantum_basis_tpu.ops.pallas_bsr``. H is tiled into (128, 128)
dense blocks; only nonzero blocks are stored, sorted by (row tile, column
tile), and the SpMV streams them: ``y[bi*128:+128] += A[b] @ x[bj*128:+128]``.
The diagonal is a separate elementwise pass.

On a CUDA tensor :func:`bsr_spmv` launches ``csrc/bsr_spmv.cu`` (built with
nvcc for sm_90a at first use and loaded with ctypes); on a CPU tensor it runs
the plain PyTorch version :func:`_bsr_matvec_plain`. There is no fallback
between the two: a CUDA tensor the kernel does not take raises.

Block values are accumulated in float64 and cast afterwards, as the JAX
package does, so both packages store bit-equal blocks for the same ELL.
"""

from __future__ import annotations

import ctypes

import torch

from quantum_basis_tpu_torch.ops import cuda_build

_B = 128  # block edge
_SRC = cuda_build.CSRC / "bsr_spmv.cu"

# Kernel launches since the last reset (the CPU plain version is not
# counted): lets a run show that its solves went through the kernel.
launch_count = 0

_lib = None


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


# --------------------------------------------------------------------------
# Building and loading the kernel
# --------------------------------------------------------------------------


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/bsr_spmv.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load(_SRC, verbose)
    for name in ("qbt_bsr_spmv_f32", "qbt_bsr_spmv_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


# --------------------------------------------------------------------------
# The kernel wrapper and its plain version
# --------------------------------------------------------------------------


def _bsr_matvec_plain(blocks_re, blocks_im, bi, bj, x2d):
    """Plain PyTorch y2d = A x2d: bmm of the blocks against the gathered x
    tiles, then ``index_add_`` by row tile. x2d is (n_pad, C), C = 1 for a
    real vector, 2 for a complex one (interleaved re/im)."""
    nbi, C = x2d.shape[0] // _B, x2d.shape[1]
    xt = x2d.view(nbi, _B, C)[bj.long()]                      # (nb, 128, C)
    if blocks_im is None:
        prod = torch.bmm(blocks_re, xt)
    else:
        xr, xi = xt[..., :1], xt[..., 1:]
        prod = torch.cat([torch.bmm(blocks_re, xr) - torch.bmm(blocks_im, xi),
                          torch.bmm(blocks_re, xi) + torch.bmm(blocks_im, xr)],
                         dim=-1)
    y = torch.zeros((nbi, _B, C), dtype=x2d.dtype, device=x2d.device)
    return y.index_add_(0, bi.long(), prod).view(nbi * _B, C)


def _check_cuda_args(blocks_re, blocks_im, bj, row_ptr, x2d):
    dev, dt = x2d.device, x2d.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"bsr_spmv takes float32 or float64, not {dt}")
    if x2d.dim() != 2 or x2d.shape[1] not in (1, 2) or x2d.shape[0] % _B:
        raise ValueError(f"x2d must be (n_pad, 1 or 2), got {tuple(x2d.shape)}")
    nbi = x2d.shape[0] // _B
    nb = blocks_re.shape[0]
    for name, t in (("blocks_re", blocks_re), ("blocks_im", blocks_im)):
        if t is None:
            continue
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (nb, _B, _B):
            raise ValueError(f"{name} must be ({nb}, 128, 128) {dt} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if blocks_im is not None and x2d.shape[1] != 2:
        raise ValueError("a complex matrix needs a complex (C = 2) vector")
    for name, t, size in (("bj", bj, nb), ("row_ptr", row_ptr, nbi + 1)):
        if (t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (size,) or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous int32 ({size},) on {dev}")
    if not x2d.is_contiguous() or x2d.data_ptr() % 16:
        raise ValueError("x2d must be contiguous and 16-byte aligned")


def bsr_spmv(blocks_re, blocks_im, bi, bj, row_ptr, x2d):
    """y2d = A x2d over the padded index space, diagonal excluded.

    ``blocks_*`` (nb, 128, 128) sorted by (bi, bj); ``bi``/``bj`` (nb,) int32
    tile coordinates; ``row_ptr`` (n_pad/128 + 1,) int32 block range of each
    row tile; ``x2d`` (n_pad, C). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise).
    """
    global launch_count
    if x2d.device.type == "cpu":
        return _bsr_matvec_plain(blocks_re, blocks_im, bi, bj, x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"bsr_spmv: unsupported device {x2d.device}")
    _check_cuda_args(blocks_re, blocks_im, bj, row_ptr, x2d)
    lib = build_library()
    fn = (lib.qbt_bsr_spmv_f32 if x2d.dtype == torch.float32
          else lib.qbt_bsr_spmv_f64)
    y = torch.empty_like(x2d)
    with torch.cuda.device(x2d.device):
        err = fn(blocks_re.data_ptr(),
                 None if blocks_im is None else blocks_im.data_ptr(),
                 row_ptr.data_ptr(), bj.data_ptr(), x2d.data_ptr(),
                 y.data_ptr(), x2d.shape[0] // _B, x2d.shape[1],
                 torch.cuda.current_stream(x2d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bsr_spmv kernel launch failed: cudaError {err}")
    launch_count += 1
    return y


# --------------------------------------------------------------------------
# Host-side layout: ELL -> BSR
# --------------------------------------------------------------------------


def _ell_entries(ell):
    """Live (rows, cols, vals) streams of an EllMatrix."""
    rows = torch.arange(ell.n, device=ell.device).repeat_interleave(ell.width)
    cols = ell.cols.reshape(-1)
    vals = ell.vals.reshape(-1)
    live = vals != 0
    return rows[live], cols[live], vals[live]


def bsr_fill_stats(ell, b: int = _B) -> dict:
    """Fill diagnostics without building blocks: nnz, block count (including
    one zero block per otherwise empty row tile), fill nnz/(nb*b*b) and the
    stored/nnz blowup."""
    rows, cols, _ = _ell_entries(ell)
    nbj = _ceil_to(ell.n, b) // b
    uniq = torch.unique((rows // b) * nbj + cols // b)
    covered = torch.unique(uniq // nbj).numel()
    nb = uniq.numel() + (nbj - covered)
    nnz = rows.numel()
    stored = nb * b * b
    return {"nnz": int(nnz), "n_blocks": int(nb), "stored": int(stored),
            "fill": nnz / stored if stored else 0.0,
            "blowup": stored / max(nnz, 1)}


class BsrMatrix:
    """Device-resident block-sparse matrix with the BSR SpMV.

    Built from ``blocks_re``/``blocks_im`` (nb, 128, 128) and ``bi``/``bj``
    (nb,) sorted by (bi, bj), and the unpadded ``diag`` (n,); it derives the
    int32 ``row_ptr`` (n_pad/128 + 1,) and the padded diagonal. Called like
    :class:`~quantum_basis_tpu_torch.ops.sparse.EllMatrix`.
    """

    def __init__(self, n, blocks_re, blocks_im, bi, bj, diag):
        self.n = int(n)
        self.n_pad = _ceil_to(max(self.n, 1), _B)
        nbi = self.n_pad // _B
        self.device = blocks_re.device
        self.dtype = blocks_re.dtype
        self.is_complex = blocks_im is not None
        self.blocks_re = blocks_re.contiguous()
        self.blocks_im = None if blocks_im is None else blocks_im.contiguous()
        self.nb = int(bi.shape[0])
        self.bi = bi.to(device=self.device, dtype=torch.int32).contiguous()
        self.bj = bj.to(device=self.device, dtype=torch.int32).contiguous()
        counts = torch.bincount(self.bi.long(), minlength=nbi)
        self.row_ptr = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).to(
            torch.int32)
        self.diag = torch.nn.functional.pad(
            diag.to(device=self.device, dtype=self.dtype),
            (0, self.n_pad - self.n))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cdt = torch.complex64 if self.dtype == torch.float32 else torch.complex128
        x = x.to(cdt if (x.is_complex() or self.is_complex) else self.dtype)
        xp = torch.nn.functional.pad(x, (0, self.n_pad - self.n))
        x2d = torch.view_as_real(xp) if xp.is_complex() else xp[:, None]
        y2d = bsr_spmv(self.blocks_re, self.blocks_im, self.bi, self.bj,
                       self.row_ptr, x2d)
        y = torch.view_as_complex(y2d) if xp.is_complex() else y2d[:, 0]
        return (y + self.diag * xp)[: self.n]


def ell_to_bsr(ell, dtype=None) -> BsrMatrix:
    """Convert an EllMatrix to BSR on its device.

    Every row tile gets at least one stored block (a zero block where no
    entry maps to it), as the JAX package's layout has it.
    """
    rows, cols, vals = _ell_entries(ell)
    dev = ell.device
    n = ell.n
    nbj = _ceil_to(max(n, 1), _B) // _B
    uniq, inv = torch.unique((rows // _B) * nbj + cols // _B,
                             return_inverse=True)
    covered = torch.zeros(nbj, dtype=torch.bool, device=dev)
    covered[uniq // nbj] = True
    missing = torch.nonzero(~covered).reshape(-1)
    all_bi = torch.cat([uniq // nbj, missing])
    all_bj = torch.cat([uniq % nbj, torch.zeros_like(missing)])
    order = torch.argsort(all_bi * nbj + all_bj)
    nb = all_bi.numel()
    rank = torch.empty_like(order)
    rank[order] = torch.arange(nb, device=dev)
    pos = (rank[inv], rows % _B, cols % _B)
    dt = dtype if dtype is not None else torch.float64
    blocks_re = torch.zeros((nb, _B, _B), dtype=torch.float64, device=dev)
    blocks_re.index_put_(pos, vals.real if vals.is_complex() else vals,
                         accumulate=True)
    blocks_im = None
    if vals.is_complex() and bool((vals.imag != 0).any()):
        blocks_im = torch.zeros((nb, _B, _B), dtype=torch.float64, device=dev)
        blocks_im.index_put_(pos, vals.imag, accumulate=True)
        blocks_im = blocks_im.to(dt)
    return BsrMatrix(n, blocks_re.to(dt), blocks_im, all_bi[order],
                     all_bj[order], ell.diag)

