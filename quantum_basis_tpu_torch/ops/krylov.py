"""The thick-restart Krylov basis work: the CGS2 step and the compaction.

Port of the XLA programs of ``quantum_basis_tpu.solvers.restarted._DeviceOps``
(K6): ``step`` (:118, with ``proj`` :81 and ``subtract`` :97), run by
``expand`` (:184) and, without the apply, by ``insert_random`` (:169), and
``compact`` (:153). ``solvers/restarted.py::_Krylov`` calls :func:`cgs2` and
:func:`krylov_compact`.

A step orthogonalizes w against the rows 0..r-1 of the basis V (rows, n)
twice and writes it, normalized, into a row of V: four passes over the
columns, each a kernel of ``csrc/krylov.cu`` on a CUDA tensor (built with
nvcc for sm_90a at first use) and its plain PyTorch version on a CPU tensor
(the torch CGS2 this module replaced); there is no fallback between the two.

- :func:`krylov_project`: h1 = V^H w;
- :func:`krylov_subtract_project`: w' = w - V^T h1 and h2 = V^H w';
- :func:`krylov_subtract_norm`: w'' = w' - V^T h2 into the target row, and
  ||w''||^2;
- :func:`krylov_scale`: the row scaled by 1 / ||w''|| (0 at a breakdown),
  h = h1 + h2 and beta written on the device.

Each pass leaves its inner products as partial sums, one column a block of
the kernel (``parts`` (rows, P); P = 1 on the CPU, the sum in column 0), and
the next pass sums them in a fixed order. On a basis mesh :func:`cgs2`
all-reduces the partial sums between passes, where ``solvers/reduce.py``'s
``dot`` and ``norm`` reduced before; every rank then uses P = PARTS blocks.
So one step makes no host sync and calls no GEMV.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from quantum_basis_tpu_torch.ops import cuda_build

_SRC = cuda_build.CSRC / "krylov.cu"

KERNELS = ("krylov_project", "krylov_subtract_project",
           "krylov_subtract_norm", "krylov_scale", "krylov_compact")
# Kernel launches since the last reset, in all and by kernel; the CPU plain
# versions are not counted: lets a run show that its Krylov steps went
# through the kernels (one of each of the first four a step at r <= GROUP).
launch_count = 0
launches = dict.fromkeys(KERNELS, 0)

BREAKDOWN = 1e-13
GROUP = 16                 # rows pass B keeps in registers (kGroup)
THREADS = 256              # a block's computing threads (kThreads)
COMPACT_STAGES = 4         # slots the compaction's ring holds
COMPACT_REGS = 4           # sums a compaction thread holds in registers
COMPACT_CHUNK = 64         # the most sums one pass over a tile holds
COMPACT_WIDE = 4           # packs a thread takes of a row tile (kWide)
COMPACT_SLOT = COMPACT_WIDE * THREADS   # packs a slot holds (16 KB)
COMPACT_SLOT_ROWS = COMPACT_CHUNK // COMPACT_REGS   # rows a slot at most
PARTS = 4 * 132            # the most partial sums a pass leaves
SMEM_MAX = 232_448         # a block's dynamic shared memory on the H100
SMEM_STATIC = 1024         # at most the kernels' static shared memory
_CODES = {torch.float32: 0, torch.float64: 1, torch.complex64: 2,
          torch.complex128: 3}

_lib = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    global launch_count
    launch_count = 0
    for k in launches:
        launches[k] = 0


def _count(name: str) -> None:
    global launch_count
    launches[name] += 1
    launch_count += 1


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/krylov.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        i, p, q = ctypes.c_int, ctypes.c_void_p, ctypes.c_int64
        # (dtype code, 16-byte packs) first, the stream last
        lib.qbt_krylov_project.argtypes = [i, i, p, q, i, i, p, q, p, i, p]
        lib.qbt_krylov_subtract_project.argtypes = [i, i, p, q, i, p, i, p,
                                                    p, q, p, i, p]
        lib.qbt_krylov_subtract_norm.argtypes = [i, i, p, q, i, p, i, p, p,
                                                 q, p, i, p]
        lib.qbt_krylov_scale.argtypes = [i, i, p, q, p, i, p, p, i, i, p, q,
                                         p, i, p]
        lib.qbt_krylov_compact.argtypes = [i, i, p, q, q, i, i, p, i, i, p,
                                           p]
        lib.qbt_krylov_compact_blocks.argtypes = [i, i, q, i]
        for name in (*KERNELS, "krylov_compact_blocks"):
            getattr(lib, f"qbt_{name}").restype = i
        _lib = lib
    return _lib


class Workspace:
    """The scratch of one basis of ``rows`` vectors of length ``n``: the
    partial sums of h1 and h2 (rows, P) and of ||w''||^2 (P,), the work
    vector w' (n,) and a beta (1,). P is 1 on the CPU; on a CUDA device one
    block per 256 entries, up to PARTS, or PARTS on a basis mesh, where every
    rank must leave as many for the all-reduce. (The plain versions take
    any P: they leave their sum in column 0 and zeros in the others.)"""

    def __init__(self, rows: int, n: int, dtype, device, mesh=None):
        device = torch.device(device)
        if device.type != "cuda":
            P = 1
        elif mesh is not None:
            P = PARTS
        else:
            P = min(PARTS, max(1, -(-n // THREADS)))
        real = torch.empty(0, dtype=dtype).real.dtype
        self.mesh = mesh
        self.h1 = torch.zeros((rows, P), dtype=dtype, device=device)
        self.h2 = torch.zeros((rows, P), dtype=dtype, device=device)
        self.nrm = torch.zeros(P, dtype=real, device=device)
        self.work = torch.zeros(n, dtype=dtype, device=device)
        self.beta = torch.zeros(1, dtype=real, device=device)


def _all_reduce(t: torch.Tensor, mesh) -> None:
    if mesh is not None:
        mesh.all_reduce(t)


def cgs2(V, r: int, w, dst: int, ws: Workspace, h_out=None, beta_out=None,
         zero_breakdown: bool = True) -> None:
    """Orthogonalize ``w`` against the rows 0..r-1 of ``V`` twice (CGS2)
    and write it into row ``dst``, normalized by beta = ||w''||: with
    ``zero_breakdown`` the row is zeroed at beta <= 1e-13 (a step), else
    divided by max(beta, 1e-13) (a restart vector). ``h_out`` (r,), which
    may be strided, receives h = h1 + h2; ``beta_out`` (1,) beta (default
    ``ws.beta``). ``w`` is not written. No host sync."""
    if not r <= dst < V.shape[0]:
        raise ValueError(f"cgs2: row {dst} is among the {r} rows it reads")
    mesh = ws.mesh
    krylov_project(V, 0, r, w, ws.h1)
    _all_reduce(ws.h1[:r], mesh)
    krylov_subtract_project(V, r, ws.h1, w, ws.work, ws.h2)
    _all_reduce(ws.h2[:r], mesh)
    krylov_subtract_norm(V, r, ws.h2, ws.work, V[dst], ws.nrm)
    _all_reduce(ws.nrm, mesh)
    krylov_scale(V[dst], ws.nrm, ws.beta if beta_out is None else beta_out,
                 zero_breakdown, (ws.h1, ws.h2) if h_out is not None
                 else None, h_out, r)


# --------------------------------------------------------------------------
# Plain versions (the torch CGS2 and compaction, in the passes' form)
# --------------------------------------------------------------------------


def _project_plain(V, r0, r1, w, parts):
    parts[r0:r1] = 0
    parts[r0:r1, 0] = V[r0:r1].conj() @ w


def _subtract_project_plain(V, r, parts_in, w, w_out, parts_out):
    w_out.copy_(w - parts_in[:r].sum(1) @ V[:r])
    _project_plain(V, 0, r, w_out, parts_out)


def _subtract_norm_plain(V, r, parts_in, w, out, norm_parts):
    out.copy_(w - parts_in[:r].sum(1) @ V[:r])
    norm_parts.zero_()
    norm_parts[0] = torch.linalg.vector_norm(out).square()


def _scale_plain(row, norm_parts, beta_out, zero_breakdown, h_parts, h_out,
                 r):
    b = norm_parts.sum().sqrt()
    inv = 1.0 / torch.clamp(b, min=BREAKDOWN)
    if zero_breakdown:
        inv = torch.where(b > BREAKDOWN, inv, 0.0)
    row.mul_(inv)
    beta_out.copy_(b)
    if h_out is not None:
        h_out.copy_(h_parts[0][:r].sum(1) + h_parts[1][:r].sum(1))


def _compact_plain(V, S, m):
    keep = S.shape[1]
    Y = S.T @ V[:m]
    vm = V[m].clone()
    V.zero_()
    V[:keep] = Y
    V[keep] = vm


# --------------------------------------------------------------------------
# The wrappers
# --------------------------------------------------------------------------


def _on_cpu(t) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"krylov: unsupported device {t.device}")
    return False


def _check(V, r, vecs=(), parts=()):
    """The kernels' contract: V (rows, n) with unit column stride, r rows of
    it used, vectors (n,) and partial sums (rows, P) contiguous, all of V's
    type on V's device."""
    if V.dtype not in _CODES or V.dim() != 2 or V.stride(1) != 1:
        raise ValueError("krylov: V must be a float32, float64, complex64 "
                         "or complex128 (rows, n) tensor with unit column "
                         f"stride, got {V.dtype} {tuple(V.shape)}")
    rows, n = V.shape
    if not 0 < r <= rows:
        raise ValueError(f"krylov: r = {r} rows of a basis of {rows}")
    for t in vecs:
        if (t.dtype != V.dtype or t.device != V.device
                or tuple(t.shape) != (n,) or not t.is_contiguous()):
            raise ValueError(f"krylov: vectors must be contiguous {V.dtype} "
                             f"({n},) on {V.device}")
    for t in parts:
        if (t.dtype != V.dtype or t.device != V.device or t.dim() != 2
                or t.shape[0] != rows or not t.is_contiguous()
                or not 0 < t.shape[1] <= PARTS):
            raise ValueError(f"krylov: partial sums must be contiguous "
                             f"{V.dtype} ({rows}, P <= {PARTS})")


def _packs(n: int, ld: int, *tensors) -> int:
    """1 where the kernels may move 16 bytes at a time (n and the row stride
    ld multiples of 16 bytes' entries, every pointer 16-byte aligned), else
    0: they then move one entry at a time."""
    u = 16 // tensors[0].element_size()
    return int(n % u == 0 and ld % u == 0
               and all(t.data_ptr() % 16 == 0 for t in tensors))


def _launch(name, fn, V, vec, *args):
    if V.device.index != torch.cuda.current_device():
        with torch.cuda.device(V.device):
            return _launch(name, fn, V, vec, *args)
    err = fn(_CODES[V.dtype], vec, *args,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    _count(name)


def krylov_project(V, r0: int, r1: int, w, parts) -> None:
    """parts[i] for r0 <= i < r1: the partial sums (one a block) of <V_i, w>
    (V_i conjugated)."""
    if _on_cpu(V):
        return _project_plain(V, r0, r1, w, parts)
    _check(V, r1, (w,), (parts,))
    if not 0 <= r0 < r1:
        raise ValueError(f"krylov_project: rows [{r0}, {r1})")
    _launch("krylov_project", build_library().qbt_krylov_project, V,
            _packs(V.shape[1], V.stride(0), V, w), V.data_ptr(),
            V.stride(0), r0, r1, w.data_ptr(), V.shape[1], parts.data_ptr(),
            parts.shape[1])


def krylov_subtract_project(V, r: int, parts_in, w, w_out, parts_out) -> None:
    """w_out = w - sum_i h1_i V_i over i < r (h1 the sum of ``parts_in``'s
    rows), and parts_out[:r] the partial sums of <V_i, w_out>. Past GROUP
    rows a krylov_project launch adds rows GROUP..r-1."""
    if _on_cpu(V):
        return _subtract_project_plain(V, r, parts_in, w, w_out, parts_out)
    _check(V, r, (w, w_out), (parts_in, parts_out))
    _launch("krylov_subtract_project",
            build_library().qbt_krylov_subtract_project, V,
            _packs(V.shape[1], V.stride(0), V, w, w_out), V.data_ptr(),
            V.stride(0), r, parts_in.data_ptr(), parts_in.shape[1],
            w.data_ptr(), w_out.data_ptr(), V.shape[1], parts_out.data_ptr(),
            parts_out.shape[1])
    if r > GROUP:
        krylov_project(V, GROUP, r, w_out, parts_out)


def krylov_subtract_norm(V, r: int, parts_in, w, out, norm_parts) -> None:
    """out = w - sum_i h2_i V_i over i < r (h2 the sum of ``parts_in``'s
    rows; ``out`` a row of V past r, or any vector), and norm_parts the
    partial sums of ||out||^2."""
    if _on_cpu(V):
        return _subtract_norm_plain(V, r, parts_in, w, out, norm_parts)
    _check(V, r, (w, out), (parts_in,))
    if (norm_parts.dtype != V.real.dtype or norm_parts.device != V.device
            or tuple(norm_parts.shape) != (parts_in.shape[1],)):
        raise ValueError("krylov_subtract_norm: norm_parts must be "
                         f"({parts_in.shape[1]},) of V's real type")
    _launch("krylov_subtract_norm", build_library().qbt_krylov_subtract_norm,
            V, _packs(V.shape[1], V.stride(0), V, w, out), V.data_ptr(),
            V.stride(0), r, parts_in.data_ptr(), parts_in.shape[1],
            w.data_ptr(), out.data_ptr(), V.shape[1], norm_parts.data_ptr(),
            norm_parts.shape[0])


def krylov_scale(row, norm_parts, beta_out, zero_breakdown: bool,
                 h_parts=None, h_out=None, r: int = 0) -> None:
    """beta = sqrt(sum of norm_parts) into beta_out (1,); row *= 1 / beta,
    or 0 where ``zero_breakdown`` and beta <= 1e-13, else 1 / max(beta,
    1e-13). With ``h_out`` (r,), possibly strided: h_out = the sums of
    h_parts' two (rows, P) buffers' first r rows."""
    if _on_cpu(row):
        return _scale_plain(row, norm_parts, beta_out, zero_breakdown,
                            h_parts, h_out, r)
    real = row.real.dtype
    if (row.dtype not in _CODES or row.dim() != 1 or not row.is_contiguous()
            or norm_parts.dtype != real or norm_parts.dim() != 1
            or beta_out.dtype != real or beta_out.numel() < 1
            or not norm_parts.is_contiguous()):
        raise ValueError("krylov_scale: a contiguous row, and norm_parts "
                         "and beta_out of its real type")
    h1 = h2 = None
    if h_out is not None:
        h1, h2 = h_parts
        if (h_out.dtype != row.dtype or h_out.dim() != 1
                or h_out.shape[0] != r or h1.shape != h2.shape
                or h1.dtype != row.dtype or not h1.is_contiguous()
                or not h2.is_contiguous() or not 0 < r <= h1.shape[0]):
            raise ValueError(f"krylov_scale: h_out ({r},) and two equal "
                             "contiguous partial-sum buffers of the row's "
                             "type")
    for t in (norm_parts, beta_out, h_out, h1, h2):
        if t is not None and t.device != row.device:
            raise ValueError(f"krylov_scale: every tensor on {row.device}")
    _launch("krylov_scale", build_library().qbt_krylov_scale, row,
            _packs(row.shape[0], 0, row), row.data_ptr(), row.shape[0],
            norm_parts.data_ptr(), norm_parts.shape[0],
            None if h1 is None else h1.data_ptr(),
            None if h2 is None else h2.data_ptr(),
            0 if h1 is None else h1.shape[1], r,
            None if h_out is None else h_out.data_ptr(),
            0 if h_out is None else h_out.stride(0), beta_out.data_ptr(),
            int(bool(zero_breakdown)))


@dataclass(frozen=True)
class CompactPlan:
    """How ``krylov_compact``'s kernel cuts V (rows, nv packs): block b of
    a grid takes the packs [nv b / grid, nv (b + 1) / grid) in column tiles
    of ``tw`` packs (its last one short), G = COMPACT_SLOT / tw threads a
    column; each tile's rows 0..m are streamed ``chunks`` times (once for
    each COMPACT_REGS x G sums) through a ring of COMPACT_STAGES slots of G
    rows (``bulk``), the chunks before the last kept in a stash of
    ``stash`` packs a block; ``smem`` the dynamic shared-memory bytes a
    block stages: the ring and two buffers of a slot's S entries
    (COMPACT_SLOT_ROWS x COMPACT_CHUNK entries each). The grid is as many
    blocks as the card holds at once, at most one a tile."""

    nv: int
    m: int
    tw: int
    chunks: int
    bulk: bool
    smem: int
    stash: int

    @property
    def G(self) -> int:
        return COMPACT_SLOT // self.tw

    def loads(self, block: int, grid: int):
        """The (row, first pack, packs) of each row tile block ``block`` of
        ``grid`` reads, in the kernel's order."""
        b0 = self.nv * block // grid
        b1 = self.nv * (block + 1) // grid
        for c0 in range(b0, b1, self.tw):
            for _ in range(self.chunks):
                for i in range(self.m + 1):
                    yield i, c0, min(self.tw, b1 - c0)


@functools.lru_cache(maxsize=64)
def compact_plan(nv: int, m: int, keep: int, pack_bytes: int,
                 item_bytes: int, bulk: bool = True) -> CompactPlan:
    """The compaction's plan for rows 0..m of nv packs of ``pack_bytes``
    (16 where the rows are 16-byte aligned and ``bulk``) of entries of
    ``item_bytes``, and ``keep`` sums:
    G = the least power of two with min(keep, COMPACT_CHUNK) <= G
    COMPACT_REGS threads share a column, each holding at most COMPACT_REGS
    sums a chunk, and a tile is COMPACT_SLOT / G packs (16 KB a row at G =
    1); past COMPACT_CHUNK sums, one chunk of them a pass over the tile. The
    ring is the same 64 KB at every keep."""
    G = 1
    while G * COMPACT_REGS < min(keep, COMPACT_CHUNK):
        G *= 2
    tw = COMPACT_SLOT // G
    chunks = max(1, -(-keep // (G * COMPACT_REGS)))
    smem = ((COMPACT_STAGES * COMPACT_SLOT * pack_bytes if bulk else 0)
            + 2 * COMPACT_SLOT_ROWS * COMPACT_CHUNK * item_bytes)
    return CompactPlan(nv, m, tw, chunks, bulk, smem,
                       (chunks - 1) * G * COMPACT_REGS * tw)


def krylov_compact(V, S, m: int):
    """Thick restart, in place: V[:keep] = S^T V[:m], V[keep] = the old
    V[m], the rows after zero, for S (m, keep) of V's type; returns
    V[:keep]. Any m and keep (compact_plan)."""
    keep = S.shape[1] if S.dim() == 2 else -1
    if _on_cpu(V):
        _compact_plain(V, S, m)
        return V[:keep]
    _check(V, 1)
    rows = V.shape[0]
    if (S.dtype != V.dtype or S.device != V.device
            or tuple(S.shape) != (m, keep) or not S.is_contiguous()
            or not 0 <= keep <= m < rows):
        raise ValueError(f"krylov_compact: S must be a contiguous {V.dtype} "
                         f"(m, keep) with keep <= m < {rows}, got "
                         f"{tuple(S.shape)} at m = {m}")
    vec = _packs(V.shape[1], V.stride(0), V)
    pack = 16 if vec else V.element_size()
    plan = compact_plan(V.shape[1] * V.element_size() // pack, m, keep, pack,
                        V.element_size(), bool(vec))
    lib = build_library()
    stash = None
    if plan.stash:
        with torch.cuda.device(V.device):
            grid = lib.qbt_krylov_compact_blocks(_CODES[V.dtype], vec,
                                                 V.shape[1], plan.tw)
        if grid <= 0:
            raise RuntimeError("krylov_compact: the grid query failed: "
                               f"cudaError {-grid}")
        stash = torch.empty(grid * plan.stash * pack // V.element_size(),
                            dtype=V.dtype, device=V.device)
    _launch("krylov_compact", lib.qbt_krylov_compact, V, vec, V.data_ptr(),
            V.stride(0), V.shape[1], rows, m, S.data_ptr(), keep, plan.tw,
            None if stash is None else stash.data_ptr())
    return V[:keep]
