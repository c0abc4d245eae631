"""The explicit (ELL) builds' rows: images to finished rows.

Both builds of ``ops/sparse.py`` end in the same row stage: a row's images
(column j, value) with |re| + |im| at or below 1e-14 dropped, sorted by
column stably in image-slot order, each run of equal columns summed in slot
order, dropped again at or below 1e-14, the survivors left in column order
and (0, 0) past them, at the width W of the widest row of the whole
sector. :func:`compact_rows` is that stage in torch ops over a (rows, E)
block, the JAX package's ``_compact_rows_np`` with the same folds.

On the card the stage runs inside the builds' kernels, so no (rows, E)
block reaches device memory: the momentum build's ``repr_images``
(``ops/apply_repr.py``, ``csrc/apply_repr.cu``: a warp a row through the
shared row stage ``csrc/ell_rows.cuh``) and the full-sector build's
``ell_rows`` (:func:`ell_rows`, ``csrc/ell_build.cu``: rows of up to 64
image columns sorted and merged in registers, wider ones through the
shared stage: ``PATHS``), which also writes each row's length. Either
build is :func:`two_pass`: a count pass gives the sector's W (the build's
one host sync), then a pass writes the (n, W) rows. CPU tensors run the
plain versions: the images of a row block (``_row_images`` and the index
lookup, or ``_repr_images_plain``), :func:`compact_rows`, and
:func:`assemble` of the blocks.
"""

from __future__ import annotations

import ctypes
import time

import torch

from quantum_basis_tpu_torch.basis.index import IndexTables, lookup_tables
from quantum_basis_tpu_torch.ops import cuda_build
from quantum_basis_tpu_torch.ops.apply import (
    _MODES,
    TABLES_SHARED_MAX,
    RowTables,
    _check_tables,
    _device_of,
    _need,
    _row_images,
)

_VAL_TOL = 1e-14  # drop |v| below this (reference sparse_precision)
_INVALID = 1 << 62
_SRC = cuda_build.CSRC / "ell_build.cu"

# A block's shared memory that the builds' kernels may take (the card's
# 227 KB): a block runs as many warps as their rows' scratch fits there, and
# where not one warp's fits, the scratch goes to a device buffer of at most
# ROW_SCRATCH_MAX bytes (at least one block's), allocated for the build
# (csrc/ell_rows.cuh::plan).
ROW_SHARED_MAX = 232448
ROW_SCRATCH_MAX = 1 << 26

# Launches of ell_rows since the last reset (two a build: the count pass and
# the write; the CPU plain version is not counted).
launch_count = 0

# The row stages of csrc/ell_build.cu, by qbt_ell_rows_path's code: in
# registers (rows of up to 64 image columns in sectors below 2^26 - 1 rows;
# two rows a warp up to 16 columns, two images a lane past 32), else the
# shared row stage of csrc/ell_rows.cuh, its scratch in shared memory or in
# a device buffer
PATHS = ("shared", "register, two rows a warp", "register, a row a warp",
         "register, two images a lane", "device")

# A list to trace the card's builds into, or None: each ell_rows build on a
# CUDA device appends {"path": its row stage, "events": CUDA events recorded
# at its start, before and after the count pass and the write pass, and at
# its end, "sync_s", "alloc_s": the host seconds of the host sync and of the
# output allocations between the passes} (chip_smoke.py's phase 21 splits a
# build's time with it).
trace = None

_lib = None


def compact_rows(cols: torch.Tensor, vals: torch.Tensor,
                 tol: float = _VAL_TOL):
    """Merge duplicate columns per row; drop entries with |re|+|im| <= tol.

    cols (n, W) int64, vals (n, W) real or complex. Returns (cols, vals)
    sorted by column within each row, invalid slots zeroed, trimmed to the
    widest surviving row; the columns int32, the ELL's layout (every
    column is a row below 2 ** 31 - 1).
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
    return cols[:, :width].to(torch.int32), vals[:, :width]


def assemble(parts, vdt, device):
    """The compacted blocks ``parts`` [(cols, vals), ...] padded to the
    widest and stacked: (cols (rows, W) int32, vals (rows, W) ``vdt``)."""
    if not parts:
        return (torch.zeros((0, 0), dtype=torch.int32, device=device),
                torch.zeros((0, 0), dtype=vdt, device=device))
    width = max(c.shape[1] for c, _ in parts)

    def padw(a):
        return torch.nn.functional.pad(a, (0, width - a.shape[1]))
    return (torch.cat([padw(c) for c, _ in parts]),
            torch.cat([padw(v) for _, v in parts]))


def row_scratch(p, query, device):
    """Gives the kernel's struct ``p`` its shared-memory cap
    (ROW_SHARED_MAX) and the device buffer its rows' scratch then needs
    (``query(p)``: the bytes a block, 0 where it fits in shared memory):
    as many blocks as ROW_SCRATCH_MAX holds, up to eight a multiprocessor,
    at least one. Returns the buffer (None where not needed), which the
    caller keeps until its launches are done."""
    p.row_shared = ROW_SHARED_MAX
    per_block = query(ctypes.byref(p))
    if not per_block:
        p.row_scratch, p.row_blocks = None, 0
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = max(1, min(8 * sms, ROW_SCRATCH_MAX // per_block))
    buf = torch.empty(blocks * per_block, dtype=torch.uint8, device=device)
    p.row_scratch, p.row_blocks = buf.data_ptr(), blocks
    return buf


def _event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def two_pass(rows: int, vdt, device, launch, rec=None):
    """A kernel build of ``rows`` finished rows: ``launch(cols, vals,
    width, W)`` once with no output and a device int32 ``width`` that the
    count pass raises to the widest row, then, after the build's one host
    sync reads W, once more into (rows, W) cols (int32) and vals (``vdt``)
    (no second launch where W is 0). ``rec``, a dict, takes the trace's
    events and host times (:data:`trace`)."""
    width = torch.zeros(1, dtype=torch.int32, device=device)
    if rec is not None:
        rec["events"].append(_event())
    launch(None, None, width, 0)
    if rec is not None:
        rec["events"].append(_event())
        t0 = time.perf_counter()
    W = int(width)
    if rec is not None:
        t1 = time.perf_counter()
    cols = torch.empty((rows, W), dtype=torch.int32, device=device)
    vals = torch.empty((rows, W), dtype=vdt, device=device)
    if rec is not None:
        rec["sync_s"], rec["alloc_s"] = t1 - t0, time.perf_counter() - t1
        rec["events"].append(_event())
    if W:
        launch(cols, vals, None, W)
    if rec is not None:
        rec["events"].append(_event())
    return cols, vals


# --------------------------------------------------------------------------
# The full-sector build: ell_rows
# --------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/ell_build.cu::Params, field by field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "rec", "ad", "gsel", "gstr", "t0", "t1", "labels", "V", "fodd",
        "cols", "vals", "rowlen", "width", "row_scratch")]
        + [(f, ctypes.c_longlong) for f in (
            "M", "sa", "label_space", "n", "rows", "row_blocks",
            "row_shared")]
        + [(f, ctypes.c_int) for f in (
            "E", "A", "S", "amp_c", "bits", "tabs_shared", "mode", "absent",
            "W", "write", "sa_shift")])


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/ell_build.cu`` (once per content of the source and
    its header, into ``quantum_basis_tpu_torch/_build/``,
    ops/cuda_build.py) and load it. ``verbose`` prints nvcc's ptxas report
    when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        lib.qbt_ell_params_size.restype = ctypes.c_longlong
        if lib.qbt_ell_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("csrc/ell_build.cu's Params and _Params "
                               "differ in size")
        lib.qbt_ell_rows.argtypes = [ctypes.POINTER(_Params),
                                     ctypes.c_void_p]
        lib.qbt_ell_rows.restype = ctypes.c_int
        lib.qbt_ell_rows_scratch.argtypes = [ctypes.POINTER(_Params)]
        lib.qbt_ell_rows_scratch.restype = ctypes.c_longlong
        lib.qbt_ell_rows_path.argtypes = [ctypes.POINTER(_Params)]
        lib.qbt_ell_rows_path.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ell_rows_plain(tabs, ix, labels, V, fodd, n, block):
    """Plain PyTorch :func:`ell_rows`: blocks of ``block`` rows, each's
    images (``_row_images``, the lookup; H[i, j] = conj(A) sign) compacted
    by :func:`compact_rows`, then :func:`assemble`; each row's length its
    count of entries (nonzero and left, so ``row_lengths``' rule)."""
    vdt = torch.complex128 if tabs.is_complex else torch.float64
    parts = []
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        amp, tgt = _row_images(tabs, labels[i0:i1], V[i0:i1],
                               None if fodd is None else fodd[i0:i1])
        # images always land in the sector
        parts.append(compact_rows(lookup_tables(ix, tgt),
                                  amp.conj().to(vdt)))
    cols, vals = assemble(parts, vdt, labels.device)
    return cols, vals, (vals != 0).sum(dim=1, dtype=torch.int32)


def _check(tabs, ix, labels, V, fodd, n, dev):
    _check_tables(tabs, dev)
    if ix.mode not in _MODES:
        raise ValueError(f"unknown index mode {ix.mode!r}")
    _need("index t0", ix.t0, torch.int32 if ix.mode == "direct"
          else torch.int64, tuple(ix.t0.shape), dev)
    _need("index t1", ix.t1, torch.int64, tuple(ix.t1.shape)
          if ix.t1 is not None else (), dev)
    if ix.mode == "lin" and (ix.t1 is None or ix.sa < 1):
        raise ValueError("a lin index needs Jb and its split")
    if n >= 2 ** 31 - 1:
        raise ValueError("the ELL build takes fewer than 2 ** 31 - 1 rows")
    R = labels.numel()
    if R < n:
        raise ValueError(f"{n} rows read, the basis holds {R}")
    _need("labels", labels, torch.int64, (R,), dev)
    _need("V", V, torch.int8, (R, V.shape[-1]), dev)
    _need("fodd", fodd, torch.int64, (R,), dev)
    if tabs.wmask is not None and fodd is None:
        raise ValueError("Jordan-Wigner strings need the basis' fodd")


def ell_rows(tabs: RowTables, ix: IndexTables, labels, V, fodd, n: int,
             block: int):
    """The finished ELL rows of H over the basis rows 0 .. n - 1: (cols (n,
    W) int32, vals (n, W), rowlen (n,) int32), H[i, j] = conj(A) sign over
    the images of ``tabs`` applied to |i> (the matrix-free apply's
    Hermitian row-gather direction), float64 where every amplitude is
    real, else complex128; rowlen each row's count of entries, which is
    its length under ``ops/sparse.py::row_lengths``' rule.

    ``labels`` (R,) int64, ``V`` (R, S) int8 and ``fodd`` (R,) int64 or
    None are the basis' flat per-row arrays, ``ix`` its index. CPU tensors
    take the plain version over blocks of ``block`` rows; CUDA tensors
    launch ``ell_rows`` twice (:func:`two_pass`; or raise), for any number
    of image columns (``PATHS``, :func:`row_scratch`).
    """
    vdt = torch.complex128 if tabs.is_complex else torch.float64
    dev = labels.device
    if not n or not tabs.n_cols:
        return (torch.zeros((n, 0), dtype=torch.int32, device=dev),
                torch.zeros((n, 0), dtype=vdt, device=dev),
                torch.zeros(n, dtype=torch.int32, device=dev))
    if _device_of(labels) == "cpu":
        return _ell_rows_plain(tabs, ix, labels, V, fodd, n, block)
    rec = None
    if trace is not None:
        rec = {"events": [_event()]}
    _check(tabs, ix, labels, V, fodd, n, dev)
    E, A = tabs.slots.shape

    def ptr(t):
        return None if t is None else t.data_ptr()
    p = _Params(
        rec=ptr(tabs.rec), ad=ptr(tabs.ad), gsel=ptr(tabs.gsel),
        gstr=ptr(tabs.strides) if tabs.gsel is not None else None,
        t0=ptr(ix.t0), t1=ptr(ix.t1), labels=ptr(labels), V=ptr(V),
        fodd=ptr(fodd), M=tabs.ad.shape[0], sa=ix.sa,
        label_space=ix.label_space, n=ix.n, rows=n, E=E, A=A,
        S=V.shape[-1], amp_c=int(tabs.is_complex), bits=int(tabs.bits),
        tabs_shared=int(tabs.nbytes <= TABLES_SHARED_MAX),
        mode=_MODES[ix.mode], absent=int(ix.absent), sa_shift=-1)
    lib = build_library()
    # the rows' scratch where it is not in shared memory, held to the end
    # of the build
    scratch = row_scratch(p, lib.qbt_ell_rows_scratch, dev)
    # the rows' lengths, written by the write pass (none where W is 0)
    rowlen = torch.empty(n, dtype=torch.int32, device=dev)
    p.rowlen = rowlen.data_ptr()

    def launch(cols, vals, width, W):
        global launch_count
        p.cols, p.vals, p.width = ptr(cols), ptr(vals), ptr(width)
        p.W, p.write = W, int(cols is not None)
        with torch.cuda.device(dev):
            err = lib.qbt_ell_rows(
                ctypes.byref(p), torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"ell_rows kernel launch failed: cudaError "
                               f"{err}")
        launch_count += 1
    cols, vals = two_pass(n, vdt, dev, launch, rec)
    del scratch
    if not vals.shape[1]:
        rowlen.zero_()
    if rec is not None:
        rec["path"] = PATHS[lib.qbt_ell_rows_path(ctypes.byref(p))]
        rec["events"].append(_event())
        trace.append(rec)
    return cols, vals, rowlen
