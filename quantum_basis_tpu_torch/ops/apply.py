"""Matrix-free operator application on the device.

Port of ``quantum_basis_tpu.ops.apply`` — the equivalent of
``model::MultMv2`` (reference: src/model.cc:941-1121) — with native
float64/complex128 vectors in place of split (re, im) pairs. Per row:

1. slot values V (int8) and, where fermionic, the mask of slots with an odd
   fermion count are precomputed per state;
2. joint columns c = V[slots] . jstrides;
3. the Jordan-Wigner parity of each term, (F @ W^T) mod 2, as
   popcount(Fodd & Wmask) mod 2;
4. the amplitude and label-displacement table lookups, hence the target
   labels of every image, and their row indices through the basis index;
5. y[i] = diag[i] x[i] + sum conj(amp) * sign * x[j] — the Hermitian
   row-gather direction: applying H to basis state i enumerates <j|H|i>, so
   row i of H is the conjugate, and every row is computed independently with
   no scatters (:class:`MatvecFull`).

:func:`mopr_x_vec` is the scatter direction, y[j] += amp * sign * x[i], for
operators that are not Hermitian or map one sector into another.

Both directions run on one fused kernel per call over tables packed once
per operator (:func:`pack_rows`): :func:`apply_rows` and
:func:`scatter_rows` launch ``csrc/apply_rows.cu`` (built with nvcc for
sm_90a at first use, loaded with ctypes) on CUDA tensors, and run their
plain PyTorch versions on CPU tensors; no (rows, terms, images)
intermediate reaches device memory on the card. The kernels read the
packed form of the tables (one 16-byte record a column, interleaved
entries, slot values from the label's bit fields where every local dim is
a power of two, diagonal columns flagged); the plain versions read the flat
tables beside it. The plain versions loop
over row blocks whose intermediates the device's ``apply_block_budget``
(``config.MEMORY``) bounds. :func:`_row_images` (the plain versions' images of a
block of rows) also serves the full sector's ELL build; :func:`_block_images`
(the same images per term group) serves the other sectors' engines.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import (BasisIndex, IndexTables,
                                                 lookup_tables)
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.ops import cuda_build
from quantum_basis_tpu_torch.ops.compile import CompiledOperator, compile_diagonal

_SRC = cuda_build.CSRC / "apply_rows.cu"

# Kernel launches since the last reset, one count per wrapper (the CPU plain
# versions are not counted): lets a run show that its applies went through
# the kernel. ``launch_count`` is apply_rows', ``scatter_launch_count``
# scatter_rows'.
launch_count = 0
scatter_launch_count = 0

_lib = None


def _choose_block(n: int, work_per_row: int, device) -> int:
    b = max(1024, config.memory("apply_block_budget", device)
            // max(work_per_row, 1))
    b = 1 << int(math.floor(math.log2(b)))
    return int(min(b, n))


class DeviceBasis:
    """Device-resident per-state data, padded into uniform row blocks.

    Holds labels (nb, B) int64, decoded slot values V (nb, B, S) int8 and
    fermion counts F (nb, B, S) int8 — shared by the Hamiltonian apply and
    all measurement operators on the same sector — and, for a fermionic
    space, ``fodd`` (nb * B,) int64: bit s set where slot s holds an odd
    fermion count (None otherwise). Padding rows repeat the first label.
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
        self.fodd = None
        if space.fermionic:
            Ftab = torch.as_tensor(space.fermion_count_table,
                                   device=self.device)
            self.F_b = Ftab[torch.arange(space.n_slots, device=self.device),
                            V].to(torch.int8)
            if space.n_slots <= 63:
                bits = torch.arange(space.n_slots, device=self.device)
                self.fodd = ((self.F_b.long() & 1) << bits).sum(-1).view(-1)
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


# --------------------------------------------------------------------------
# Term tables packed for the row kernels
# --------------------------------------------------------------------------


@dataclass
class RowTables:
    """One compiled operator's off-diagonal tables, packed for
    :func:`apply_rows` and :func:`scatter_rows`: one entry per image column
    e = (group, term, image k) over all groups, E = ``nnz_per_row`` of them.

    The flat tables, read by the plain versions: image e of a row with slot
    values V reads them at ``idx = off[e] + c * kstr[e]``, c = sum_a
    V[slots[e, a]] * strides[e, a] (the term's joint column; arities below A
    pad with stride 0): amplitude ``amp[idx]``, target label ``label +
    dlt[idx]``, and the Jordan-Wigner sign (-1) ** popcount(Fodd &
    wmask[e]).

    The same columns packed for the kernels (``csrc/apply_rows.cu``): ``rec``
    holds one 16-byte record a column, four int32 words; ``ad`` the
    amplitudes and displacements interleaved, one entry (amp bits, dlt) or
    (re bits, im bits, dlt, 0) as int64, each column's D entries
    contiguous. Word 0 is the offset of the column's entries (bits 0-27: the
    entry of joint column c is ``ad[off + c]``), bit 30 flags a diagonal
    column (every dlt of the column 0), bit 31 a column of arity > 2. Word 1
    holds, for arity <= 2, slot 0 (bits 0-7), slot 1 (8-15) and the joint
    stride of slot 1 (16-23, 0 at arity 1); with ``bits`` (every local dim a
    power of two) it holds instead the label shifts of the two slots' bit
    fields (0-7, 8-15) and their masks (16-23, 24-31; slot 1's 0 at arity
    1), so V[s] = (label >> shift) & mask and c = v0 + v1 * (mask0 + 1).
    A column of arity > 2 reads its slots from ``gsel`` (E, A) (shift | mask
    << 8 with ``bits``, else the slot) and ``strides``. Words 2 and 3 are
    the low and high halves of wmask.
    """

    slots: torch.Tensor      # (E, A) int32
    strides: torch.Tensor    # (E, A) int32
    off: torch.Tensor        # (E,) int32
    kstr: torch.Tensor       # (E,) int32
    wmask: torch.Tensor | None   # (E,) int64, None when no term has a string
    dlt: torch.Tensor        # (M,) int64, the groups' (T, D, K) tables
    amp: torch.Tensor        # (M,) float64, or complex128 where any is
    rec: torch.Tensor        # (E, 4) int32, the kernels' column records
    ad: torch.Tensor         # (M, 2) or (M, 4) int64, interleaved entries
    gsel: torch.Tensor | None    # (E, A) int32 where A > 2, else None
    bits: bool               # slot values from the label's bit fields
    diag_only: bool          # every column diagonal (or none at all)
    n_simple: int            # leading columns of arity <= 2

    @property
    def n_cols(self) -> int:
        return int(self.off.numel())

    @property
    def is_complex(self) -> bool:
        return self.amp.is_complex()

    @property
    def diagonal(self) -> torch.Tensor:
        """(E,) bool: the columns whose every image keeps the label."""
        return (self.rec[:, 0] & _DIAG) != 0

    @property
    def nbytes(self) -> int:
        """Bytes of ``rec`` and ``ad``, which a block stages."""
        return 16 * self.n_cols + 8 * self.ad.numel()


# word 0 of a column record (csrc/apply_rows.cu): the offset's bits, flags
_OFFSET = (1 << 28) - 1
_DIAG = 1 << 30
_GENERIC = 1 << 31


def slot_bit_fields(space):
    """(shift, width) of every slot's bit field in a label, int64 (S,)
    each, where every local dim is a power of two (labels are then bit
    strings: V[s] = (label >> shift[s]) & (2 ** width[s] - 1)); else
    None."""
    dims = np.asarray(space.dims, dtype=np.int64)
    if np.any(dims & (dims - 1)):
        return None
    width = np.array([int(d).bit_length() - 1 for d in dims], np.int64)
    return np.concatenate([[0], np.cumsum(width)[:-1]]).astype(np.int64), \
        width


def pack_rows(compiled: CompiledOperator, device) -> RowTables:
    """Pack the term groups of ``compiled`` into :class:`RowTables` on
    ``device`` (host numpy, once per operator)."""
    S = compiled.space.n_slots
    A = max([g.arity for g in compiled.groups], default=1)
    fields = slot_bit_fields(compiled.space)
    slots, strides, off, kstr, wmask, dlt, amp = [], [], [], [], [], [], []
    rec, gsel, adlt, aamp = [], [], [], []
    base = 0
    for g in compiled.groups:
        T, D, K = g.dlt.shape
        for t in range(T):
            w = g.W[t].astype(np.int64)
            if w.any() and S > 63:
                raise ValueError("Jordan-Wigner masks need at most 63 slots")
            mask = int(np.sum(w << np.arange(S, dtype=np.int64))) \
                if w.any() else 0
            sl = [int(s) for s in g.slots[t]]
            if fields is not None:      # (shift, mask) of each slot
                sm = [(int(fields[0][s]), (1 << int(fields[1][s])) - 1)
                      for s in sl]
                sel = [sh | mk << 8 for sh, mk in sm]
            else:
                sel = sl
            flags, word = 0, 0
            if g.arity <= 2:
                if int(g.jstrides[t][0]) != 1:
                    raise ValueError("joint strides must start at 1")
                if fields is not None:
                    word = sm[0][0] | sm[-1][0] << 8 | sm[0][1] << 16
                    if g.arity == 2:
                        word |= sm[1][1] << 24
                else:
                    word = sl[0] | sl[-1] << 8
                    if g.arity == 2:
                        word |= int(g.jstrides[t][1]) << 16
            else:
                flags = _GENERIC
            for k in range(K):
                slots.append(np.pad(g.slots[t], (0, A - g.arity)))
                strides.append(np.pad(g.jstrides[t], (0, A - g.arity)))
                gsel.append(np.pad(sel, (0, A - g.arity)))
                off.append(base + t * D * K + k)
                kstr.append(K)
                wmask.append(mask)
                diag = 0 if g.dlt[t, :, k].any() else _DIAG
                rec.append((base + (t * K + k) * D | flags | diag, word,
                            mask & 0xFFFFFFFF, mask >> 32))
        dlt.append(g.dlt.reshape(-1))
        a = g.amp_re if g.amp_im is None else g.amp_re + 1j * g.amp_im
        amp.append(a.reshape(-1))
        # each column's D entries contiguous: (T, K, D)
        adlt.append(g.dlt.transpose(0, 2, 1).reshape(-1))
        aamp.append(a.transpose(0, 2, 1).reshape(-1))
        base += T * D * K
    if base > _OFFSET:
        raise ValueError(f"term tables of {base} images exceed 2 ** 28")
    E = len(off)
    cplx = any(np.iscomplexobj(a) for a in amp)
    a = np.concatenate(aamp) if aamp else np.zeros(0)
    if cplx:
        a = a.astype(np.complex128)
        parts = [a.real, a.imag]
    else:
        parts = [a.astype(np.float64)]
    ad = np.zeros((base, len(parts) + (2 if cplx else 1)), np.int64)
    for col, part in enumerate(parts):
        ad[:, col] = np.ascontiguousarray(part, np.float64).view(np.int64)
    ad[:, len(parts)] = np.concatenate(adlt) if adlt else []
    rec = np.asarray(rec, np.int64).reshape(E, 4)

    def t(a, dt, shape):
        return torch.as_tensor(np.asarray(a, dtype=dt).reshape(shape),
                               device=device)
    return RowTables(
        slots=t(slots, np.int32, (E, A)),
        strides=t(strides, np.int32, (E, A)),
        off=t(off, np.int32, (E,)),
        kstr=t(kstr, np.int32, (E,)),
        wmask=t(wmask, np.int64, (E,)) if any(wmask) else None,
        dlt=t(np.concatenate(dlt) if dlt else [], np.int64, (-1,)),
        amp=t(np.concatenate(amp) if amp else [],
              np.complex128 if cplx else np.float64, (-1,)),
        rec=t(rec.astype(np.uint32).view(np.int32), np.int32, (E, 4)),
        ad=torch.as_tensor(ad, device=device),
        gsel=t(gsel, np.int32, (E, A)) if A > 2 else None,
        bits=fields is not None,
        diag_only=bool(np.all(rec[:, 0] & _DIAG)),
        n_simple=int(np.argmax(rec[:, 0] & _GENERIC != 0))
        if np.any(rec[:, 0] & _GENERIC) else E)


def _parity(v: torch.Tensor) -> torch.Tensor:
    """popcount(v) & 1 of non-negative int64 values, by xor folding."""
    for sh in (32, 16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def _row_images(tabs: RowTables, labels, V, fodd):
    """A block's images: (amp * sign, (rows, E)); target labels (rows, E)."""
    c = (V.long()[:, tabs.slots] * tabs.strides).sum(-1)
    idx = tabs.off + c * tabs.kstr
    amp = tabs.amp[idx]
    if tabs.wmask is not None:
        amp = amp * (1 - 2 * _parity(fodd[:, None] & tabs.wmask)).double()
    return amp, labels[:, None] + tabs.dlt[idx]


# --------------------------------------------------------------------------
# The kernels' plain versions
# --------------------------------------------------------------------------


def _apply_rows_plain(tabs, ix, labels, V, fodd, diag, x, row0, n_out,
                      n_valid):
    """Plain PyTorch :func:`apply_rows`: row blocks of at most
    ``apply_block_budget`` (rows x image columns x arity) elements."""
    y = torch.zeros(n_out, dtype=x.dtype, device=x.device)
    rows = max(0, min(n_valid - row0, n_out))
    B = _choose_block(max(rows, 1), tabs.n_cols * tabs.slots.shape[1],
                      x.device)
    for i0 in range(0, rows, B):
        i1 = min(i0 + B, rows)
        g0, g1 = row0 + i0, row0 + i1
        acc = x[g0:g1] * (diag[i0:i1] if diag is not None else 0.0)
        if tabs.n_cols:
            amp, tgt = _row_images(tabs, labels[g0:g1], V[g0:g1],
                                   None if fodd is None else fodd[g0:g1])
            # y[i] += conj(amp) * sign * x[j]
            acc = acc + (amp.conj() * x[lookup_tables(ix, tgt)]).sum(-1)
        y[i0:i1] = acc
    return y


def _scatter_rows_plain(tabs, ix, labels, V, fodd, diag, x, n_src):
    """Plain PyTorch :func:`scatter_rows`, with ``index_add_`` over row
    blocks of at most ``apply_block_budget`` elements."""
    y = torch.zeros(ix.n, dtype=x.dtype, device=x.device)
    if not ix.n:
        return y
    B = _choose_block(max(n_src, 1), tabs.n_cols * tabs.slots.shape[1],
                      x.device)
    for i0 in range(0, n_src, B):
        i1 = min(i0 + B, n_src)
        lab, xb = labels[i0:i1], x[i0:i1]
        if diag is not None:
            j = lookup_tables(ix, lab)
            y.index_add_(0, j, torch.where(ix.labels[j] == lab,
                                           diag[i0:i1] * xb, 0.0))
        if tabs.n_cols:
            amp, tgt = _row_images(tabs, lab, V[i0:i1],
                                   None if fodd is None else fodd[i0:i1])
            j = lookup_tables(ix, tgt)
            # y[j] += amp * sign * x[i]   (no conjugate: forward direction)
            contrib = torch.where(ix.labels[j] == tgt, amp, 0.0) * xb[:, None]
            y.index_add_(0, j.reshape(-1), contrib.to(x.dtype).reshape(-1))
    return y


# --------------------------------------------------------------------------
# The kernels: building, argument checks, wrappers
# --------------------------------------------------------------------------


_MODES = {"direct": 0, "lin": 1, "bsearch": 2}
# A block stages a column's record and entries in shared memory up to this
# many bytes of them (RowTables.nbytes); above it the kernels' other
# instance reads them through the read-only cache.
TABLES_SHARED_MAX = 32 * 1024


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/apply_rows.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        tables = [p] * 4 + [i, i, i, q, i, i, i, i]
        index = [i, p, p, q, q, q, p]
        rows = [p, p, i, p, p, p, i, p]
        lib.qbt_apply_rows.argtypes = tables + index + rows + [q, q, q, p]
        lib.qbt_scatter_rows.argtypes = tables + index + rows + [q, p]
        lib.qbt_apply_rows.restype = lib.qbt_scatter_rows.restype = i
        _lib = lib
    return _lib


def _need(name, t, dt, shape, dev):
    if t is None:
        return
    if (t.device != dev or t.dtype != dt or tuple(t.shape) != shape
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dt} tensor of "
                         f"shape {shape} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_tables(tabs, dev):
    """The packed tables' checks, once per RowTables and device (the
    tables do not change after pack_rows)."""
    if getattr(tabs, "_checked_on", None) == dev:
        return
    E, A = tabs.slots.shape
    _need("rec", tabs.rec, torch.int32, (E, 4), dev)
    _need("strides", tabs.strides, torch.int32, (E, A), dev)
    if A > 2 and tabs.gsel is None:
        raise ValueError("columns of arity > 2 need gsel")
    _need("gsel", tabs.gsel, torch.int32, (E, A), dev)
    M = tabs.dlt.numel()
    _need("ad", tabs.ad, torch.int64, (M, 4 if tabs.is_complex else 2), dev)
    tabs._checked_on = dev


def _check_cuda_args(tabs, ix, labels, V, fodd, diag, x, n_diag, n_rows):
    dev = x.device

    def need(name, t, dt, shape):
        _need(name, t, dt, shape, dev)
    if x.dtype not in (torch.float64, torch.complex128) or x.dim() != 1 \
            or not x.is_contiguous():
        raise ValueError("x must be a contiguous float64 or complex128 vector")
    if tabs.is_complex and not x.is_complex():
        raise ValueError("complex amplitudes need a complex128 vector")
    _check_tables(tabs, dev)
    if ix.mode not in _MODES:
        raise ValueError(f"unknown index mode {ix.mode!r}")
    # a direct index's position table holds int32 rows (basis/index.py)
    need("index t0", ix.t0, torch.int32 if ix.mode == "direct"
         else torch.int64, tuple(ix.t0.shape))
    need("index t1", ix.t1, torch.int64, tuple(ix.t1.shape)
         if ix.t1 is not None else ())
    need("index labels", ix.labels, torch.int64, (ix.n,))
    if ix.mode == "lin" and (ix.t1 is None or ix.sa < 1):
        raise ValueError("a lin index needs Jb and its split")
    if ix.absent:
        raise ValueError("the row kernels take a position table whose "
                         "every entry is a row (not one marking absent "
                         "labels with n)")
    R = labels.numel()
    if R < n_rows:
        raise ValueError(f"{n_rows} rows read, the basis holds {R}")
    need("labels", labels, torch.int64, (R,))
    need("V", V, torch.int8, (R, V.shape[-1]))
    if not 1 <= V.shape[-1] <= 255:
        raise ValueError("the kernels take 1 to 255 slots")
    need("fodd", fodd, torch.int64, (R,))
    need("diag", diag, torch.float64, (n_diag,))
    if tabs.wmask is not None and fodd is None:
        raise ValueError("Jordan-Wigner strings need the basis' fodd")


def _launch_args(tabs, ix, labels, V, fodd, diag, x, y):
    def ptr(t):
        return None if t is None else t.data_ptr()
    E, A = tabs.slots.shape
    return ([ptr(tabs.rec), ptr(tabs.ad), ptr(tabs.gsel),
             ptr(tabs.strides) if tabs.gsel is not None else None,
             E, tabs.n_simple, A, tabs.dlt.numel(), int(tabs.is_complex),
             int(tabs.bits),
             int(tabs.nbytes <= TABLES_SHARED_MAX), int(tabs.diag_only),
             _MODES[ix.mode], ptr(ix.t0), ptr(ix.t1), ix.sa, ix.label_space,
             ix.n, ptr(ix.labels), ptr(labels), ptr(V), V.shape[-1],
             ptr(fodd), ptr(diag), ptr(x), int(x.is_complex()), ptr(y)])


def _device_of(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    return x.device.type


def apply_rows(tabs: RowTables, ix: IndexTables, labels, V, fodd, diag, x,
               row0: int, n_out: int, n_valid: int) -> torch.Tensor:
    """Rows ``row0 .. row0 + n_out - 1`` of y = H x (Hermitian row-gather
    direction), one launch for all of them.

    ``labels`` (R,) int64, ``V`` (R, S) int8 and ``fodd`` (R,) int64 (or
    None: no fermions) are the basis' flat per-row arrays, ``ix`` its index;
    ``diag`` (n_out,) float64 or None is the diagonal of the rows computed;
    ``x`` is the whole vector, indexed by basis row (float64 or
    complex128). Rows at or past ``n_valid`` come out zero. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise).
    """
    global launch_count
    if _device_of(x) == "cpu":
        return _apply_rows_plain(tabs, ix, labels, V, fodd, diag, x, row0,
                                 n_out, n_valid)
    n_rows = max(0, min(n_valid, row0 + n_out))
    _check_cuda_args(tabs, ix, labels, V, fodd, diag, x, n_out, n_rows)
    if x.numel() < max(n_rows, ix.n):
        raise ValueError(f"x holds {x.numel()} rows, the apply reads "
                         f"{max(n_rows, ix.n)}")
    y = torch.empty(n_out, dtype=x.dtype, device=x.device)
    if n_out == 0:
        return y
    lib = build_library()
    with torch.cuda.device(x.device):
        err = lib.qbt_apply_rows(
            *_launch_args(tabs, ix, labels, V, fodd, diag, x, y),
            row0, n_out, n_valid,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"apply_rows kernel launch failed: cudaError {err}")
    launch_count += 1
    return y


def scatter_rows(tabs: RowTables, ix: IndexTables, labels, V, fodd, diag, x,
                 n_src: int) -> torch.Tensor:
    """y = O x in the scatter direction, y[j] += amp * sign * x[i] (no
    conjugate), over the source rows ``0 .. n_src - 1``; ``ix`` is the
    destination's index (y has ``ix.n`` rows), images outside it are
    dropped (``labels[j] == target`` checked), the diagonal ``diag`` (n_src,)
    or None goes through the same check. The other arguments are the source
    basis' as in :func:`apply_rows`. CPU tensors take the plain version;
    CUDA tensors launch the kernel (or raise), whose float64 atomic adds
    sum in an order that changes from run to run.
    """
    global scatter_launch_count
    if _device_of(x) == "cpu":
        return _scatter_rows_plain(tabs, ix, labels, V, fodd, diag, x, n_src)
    _check_cuda_args(tabs, ix, labels, V, fodd, diag, x, n_src, n_src)
    if x.numel() < n_src:
        raise ValueError(f"x holds {x.numel()} rows, {n_src} are read")
    y = torch.zeros(ix.n, dtype=x.dtype, device=x.device)
    if n_src == 0 or ix.n == 0:
        return y
    lib = build_library()
    with torch.cuda.device(x.device):
        err = lib.qbt_scatter_rows(
            *_launch_args(tabs, ix, labels, V, fodd, diag, x, y), n_src,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows kernel launch failed: cudaError "
                           f"{err}")
    scatter_launch_count += 1
    return y


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------


class MatvecFull:
    """Matrix-free y = H x over a fixed basis (full or quantum-number sector).

    ``H`` must be Hermitian and conserve the sector (every image stays in the
    basis). Use :func:`mopr_x_vec` for general operators. A real H applied to
    a complex vector acts on both parts; a complex H needs a complex vector.
    One :func:`apply_rows` call per apply.
    """

    def __init__(self, compiled: CompiledOperator, dbasis: DeviceBasis):
        self.compiled = compiled
        self.basis = dbasis
        self.n = dbasis.n
        self.device = dbasis.device
        self.dtype = torch.float64
        self.tables = pack_rows(compiled, self.device)
        self.is_complex = self.tables.is_complex
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
        y = apply_rows(self.tables, b.index.tables, b.labels_b.view(-1),
                       b.V_b.view(-1, b.space.n_slots), b.fodd,
                       self.diag_b.view(-1)[: self.n], x.contiguous(), 0,
                       self.n, self.n)
        self.n_applies += 1
        return y


def mopr_x_vec(compiled: CompiledOperator, src: DeviceBasis, dst: DeviceBasis,
               x: torch.Tensor) -> torch.Tensor:
    """General (non-Hermitian-trick) application: y = O x, scatter direction.

    ``src``/``dst`` may be different sectors (e.g. A_q maps Sz -> Sz-1 for
    dynamical structure factors; reference: model::moprXvec_full,
    src/model.cc:1468-1548). Images that leave ``dst`` are dropped, matching
    the reference's binary-search miss behavior. One :func:`scatter_rows`
    call; on a CUDA device its atomic sums are not in a fixed order: two
    runs may differ in the last bits.
    """
    tabs = pack_rows(compiled, src.device)
    cplx = x.is_complex() or tabs.is_complex
    x = x.to(torch.complex128 if cplx else torch.float64).contiguous()
    diag = _device_diag(compiled, src)
    return scatter_rows(tabs, dst.index.tables, src.labels_b.view(-1),
                        src.V_b.view(-1, src.space.n_slots), src.fodd,
                        None if diag is None else diag.view(-1)[: src.n],
                        x, src.n)
