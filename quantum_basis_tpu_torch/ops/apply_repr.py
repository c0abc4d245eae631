"""Matrix-free apply in translational-symmetry (momentum) sectors.

Port of ``quantum_basis_tpu.ops.apply_repr`` (``ReprBasis``, ``MatvecRepr``)
with native complex128 vectors in place of split (re, im) pairs. Basis
vectors are |r,k> = P_k|r>/sqrt(nu_r) over representatives r (orbit minima)
with nu_r > 0 (cf. generate_Ham_sparse_repr / repr MultMv2,
src/model.cc:687-836, 941-1121).

Row kernel (Hermitian row-gather, no scatters): apply H to the product state
|r_i>; for every image |m> with amplitude A (JW sign included) compute all G
translated labels of m, take the orbit minimum r_j = min_g T_g(m) and the
first minimizing element g*; then

    y_i += sqrt(nu_j / nu_i) * conj(A) * sigma_{g*} * e^{-i k.R_{g*}} * x_j

Images whose representative has nu = 0, or lies outside the quantum-number
sector, are dropped. :func:`mopr_x_vec_repr` is the forward-scatter direction
y = A x between two momentum sectors.

Three kernels carry it, over the operator's packed columns
(``ops/apply.py::pack_rows``) and the translations packed by
:func:`translation_tables`: ``repr_rows`` (``MatvecRepr``), ``repr_scatter``
(``mopr_x_vec_repr``) and ``repr_images`` (the finished rows of the explicit
ELL, for ``ops/sparse.py::build_sparse_repr``: a warp a row, merged and
compacted in the kernel by the row stage of ``ops/ell_build.py``). A
:class:`ReprLaunch` is one kernel's launch record, built once per engine
(``MatvecRepr.record``, :func:`scatter_launch`): every argument check, the
translation tables and the ctypes struct; a call then checks x, allocates
y and launches. On CUDA tensors it launches ``csrc/apply_repr.cu`` (built
with nvcc for sm_90a at first use, loaded with ctypes); on CPU tensors it
runs the plain versions, which repeat the kernels' formulation with torch
ops over row blocks. Two formulations, as :func:`entry_plan` picks them
for the kernels: the entry path (G <= 32, label spaces to 2^27-2^29),
where an image's translated labels are the row's keys T_g(r) << SH | g
plus its entry's constant change (:func:`entry_tables`) and one min over
g gives r_j and g*; and the general path, T_g(m) = T_g(r) + sum over the
term's slots of (V_s(m) - V_s(r)) SP[s, g] in int64. The fermionic sign is
popcounts against one mask a (g, slot); a diagonal column (every
displacement 0) is the row itself with coefficient A. On the entry path
``repr_rows`` reaches a row by its label: sqrt(nu_j) x_j sits in the
device's label buffer (:class:`LabelBuffer`, one a device, up to
``config.MEMORY``'s ``repr_label_buffer_max`` bytes), which a pre-pass
fills each launch; a basis whose label space passes that bound takes the
general path.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from dataclasses import dataclass

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import (BasisIndex, IndexTables,
                                                 lookup_tables)
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
    sector_norms,
)
from quantum_basis_tpu_torch.ops import cuda_build, ell_build
from quantum_basis_tpu_torch.ops.apply import (
    _MODES,
    _OFFSET,
    DeviceBasis,
    RowTables,
    _check_tables,
    _device_of,
    _need,
    _parity,
    _row_images,
    pack_rows,
)
from quantum_basis_tpu_torch.ops.compile import CompiledOperator, compile_diagonal
from quantum_basis_tpu_torch.ops.ell_build import assemble, compact_rows, two_pass

_NU_TOL = 1e-10
_SRC = cuda_build.CSRC / "apply_repr.cu"

KERNELS = ("repr_rows", "repr_scatter", "repr_images")
# Kernel launches since the last reset, by kernel (the CPU plain versions
# are not counted): lets a run show that its applies went through them.
launches = dict.fromkeys(KERNELS, 0)

# The general path: a block stages its tables (the columns' records,
# entries, slots and strides, and the translations) in shared memory up to
# this many bytes, else reads them from device memory; it holds its rows' G
# translated labels (8 G bytes a row, THREADS rows) in shared memory up to
# TR_SHARED_MAX bytes, else in a device scratch of two blocks an SM.
TABLES_SHARED_MAX = 48 * 1024
TR_SHARED_MAX = 64 * 1024
# The entry path stages its whole blob (records, entry rows, Fodd masks, SP
# rows, slots, phases, Q masks) in shared memory; an operator whose blob
# passes this many bytes takes the general path. A launch record reads the
# three bounds when it is built.
ENTRY_TABLES_MAX = 48 * 1024
THREADS = 128           # rows a block (csrc/apply_repr.cu::kThreads)
BUCKETS = (8, 16, 32)   # the entry path's G buckets (keys in registers)

_lib = None


def reset_launches() -> None:
    """Set every launch count to 0."""
    for k in launches:
        launches[k] = 0


class ReprBasis(DeviceBasis):
    """Momentum-sector basis: representatives + norms, blocked on the device.

    Built from the quantum-number-sector labels (cf. enumerate_basis_repr,
    src/model.cc:274-487): reps = orbit minima, nu = <r|P_k|r>, keep nu > 0.
    """

    def __init__(self, space, tset: TranslationSet, sector_labels: np.ndarray,
                 momentum, work_per_row: int = 16,
                 reps_all: np.ndarray | None = None):
        self.tset = tset
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))
        if reps_all is None:
            reps_all = enumerate_reps(tset, sector_labels)
        nus = sector_norms(tset, reps_all, momentum)
        keep = nus > _NU_TOL
        labels = reps_all[keep]
        self.nus = nus[keep]
        if labels.size == 0:
            raise ValueError(
                f"momentum sector k={self.momentum} is empty (all norms zero)")
        per_row = max(work_per_row, 1) * max(tset.G, 1)
        block_rows = 1 << int(math.floor(math.log2(
            max(256, config.memory("repr_block_budget", tset.device)
                // per_row))))
        # a direct table marks the labels it does not hold with row n
        index = BasisIndex(labels, space.label_space, device=tset.device,
                           absent_row=True)
        super().__init__(space, labels, index, block_rows, device=tset.device)
        nu_pad = np.concatenate([self.nus, np.ones(self.pad)])
        dev = self.device
        self.inv_sqrt_nu_b = torch.as_tensor(
            (1.0 / np.sqrt(nu_pad)).reshape(self.n_blocks, self.block_rows),
            device=dev)
        # entry n is the padding slot for images that leave the sector
        self.sqrt_nu = torch.as_tensor(
            np.sqrt(np.concatenate([self.nus, [1.0]])), device=dev)
        self._rrec = None

    def from_full(self, x_full: torch.Tensor) -> torch.Tensor:
        """Repr coefficients of a full-label-space sector-k vector.

        A normalized |psi> with P_k|psi> = |psi> expands over the repr basis
        |r,k> = P_k|r>/sqrt(nu_r) as c_r = <r,k|psi> = psi[r]/sqrt(nu_r): one
        gather at the representative labels (see ops/translate_fullspace.py).
        ``x_full`` runs over ALL labels of the space. Returns a normalized
        complex128 vector over the representatives.
        """
        idx = self.labels_b.reshape(-1)[: self.n]
        c = x_full[idx].to(torch.complex128) / self.sqrt_nu[: self.n]
        return c / torch.clamp(torch.linalg.vector_norm(c), min=1e-300)

    def rows(self):
        """The flat per-row arrays the repr kernels read: labels (R,) int64,
        fodd (R,) int64 or None, 1/sqrt(nu) (R,) float64 (R = n_blocks *
        block_rows; padding rows past n)."""
        return (self.labels_b.view(-1), self.fodd,
                self.inv_sqrt_nu_b.view(-1))

    def row_records(self) -> torch.Tensor:
        """(n, 2) int64: each row's (label, bits of sqrt(nu)), the record
        the scatter and the images gather for an image they land on (the
        check and the weight in one 16-byte load); built once per basis."""
        if self._rrec is None:
            self._rrec = row_records(self.index.tables, self.sqrt_nu)
        return self._rrec


def row_records(ix: IndexTables, sqrt_nu: torch.Tensor) -> torch.Tensor:
    """(ix.n, 2) int64 (label, bits of sqrt(nu)) of a destination's rows."""
    return torch.stack([ix.labels, sqrt_nu[: ix.n].view(torch.int64)],
                       1).contiguous()


# --------------------------------------------------------------------------
# Translations packed for the kernels
# --------------------------------------------------------------------------


@dataclass
class TransTables:
    """One TranslationSet packed for the repr kernels (and their plain
    versions): ``sp`` (S, G) int64, T_g(m) = sum_s V_s(m) sp[s, g];
    ``sstride``, ``sdim`` (S,) int64, V_s(m) = (m // sstride[s]) % sdim[s]
    (a bit field where ``bits``); for a fermionic space ``oddmask`` (S,)
    int64, bit v set where a slot value v holds an odd fermion count, and
    ``qmask`` (G, S) int64, bit t of [g, s] set where Q_g[s, t] = 1, so the
    sign of translation g on a state with odd-count slots F is (-1) **
    (xor over s in F of popcount(F & qmask[g, s])); else both None."""

    sp: torch.Tensor
    sstride: torch.Tensor
    sdim: torch.Tensor
    oddmask: torch.Tensor | None
    qmask: torch.Tensor | None
    bits: bool

    @property
    def S(self) -> int:
        return int(self.sp.shape[0])

    @property
    def G(self) -> int:
        return int(self.sp.shape[1])

    @property
    def nbytes(self) -> int:
        n = self.sp.numel() + 2 * self.S
        if self.qmask is not None:
            n += self.qmask.numel() + self.S
        return 8 * n + 16 * self.G


def translation_tables(tset: TranslationSet) -> TransTables:
    """The :class:`TransTables` of ``tset`` on its device (packed once per
    TranslationSet, host numpy)."""
    rt = getattr(tset, "_packed", None)
    if rt is not None:
        return rt
    space = tset.space
    S, G = tset.SP.shape
    dims = np.asarray(space.dims, np.int64)
    oddmask = qmask = None
    if tset.fermionic:
        if S > 63 or space.dim_max > 63:
            raise ValueError("fermionic translations take at most 63 slots "
                             "of at most 63 local states")
        odd = space.fermion_count_table % 2                  # (S, dim_max)
        oddmask = (odd.astype(np.int64)
                   << np.arange(space.dim_max, dtype=np.int64)).sum(1)
        qmask = (tset.Q.astype(np.int64)
                 << np.arange(S, dtype=np.int64)).sum(2)     # (G, S)

    def t(a):
        return None if a is None else torch.as_tensor(
            np.ascontiguousarray(a, np.int64), device=tset.device)
    rt = TransTables(sp=t(tset.SP), sstride=t(space.strides), sdim=t(dims),
                     oddmask=t(oddmask), qmask=t(qmask),
                     bits=not np.any(dims & (dims - 1)))
    tset._packed = rt
    return rt


def column_slots(tabs: RowTables) -> torch.Tensor:
    """(E, A) int32: the slots each image column's term acts on, -1 past
    its arity (where the packing pads with joint stride 0)."""
    cs = getattr(tabs, "_cslot", None)
    if cs is None:
        cs = torch.where(tabs.strides != 0, tabs.slots, -1).to(
            torch.int32).contiguous()
        tabs._cslot = cs
    return cs


def phase_table(tset: TranslationSet, momentum, sign: int = -1):
    """(G, 2) float64 (re, im) of e^{sign i k.R} per group element: -1 for
    the gather (``MatvecRepr``), +1 for the scatter into sector k'."""
    cos, sin = tset.phases(momentum)          # e^{-i k.R}
    return torch.as_tensor(np.stack([cos, -sign * sin], axis=1),
                           device=tset.device).contiguous()


# --------------------------------------------------------------------------
# The entry path's tables
# --------------------------------------------------------------------------


@dataclass
class EntryTables:
    """One operator's columns under one translation set, packed for the
    entry path (``csrc/apply_repr.cu``), entry by entry (the packed ``ad``
    layout: column e's joint column c is entry ``rec[e, 0] & _OFFSET`` +
    c). ``erow`` (M, gb + 4) int32: the amplitude's (re, im) float64 bits
    as four words, then (Delta_g << shift) mod 2^32 for g < G, 0 past it,
    where Delta_g = T_g(m) - T_g(r) is the change of translated label g
    that the entry's image makes (a constant of the entry: it fixes the
    term's slot values before and after); ``fx`` (M,) int64 the entry's
    change of the odd-count slots (Fodd_m = Fodd_r ^ fx), or None without
    fermionic translations; ``sp32`` (S, gb + 4) int32 SP[s, g] (0 past G);
    ``slot32`` (S, 2) int32 each slot's (shift, mask) where ``bits``, else
    (stride, dim). Entries of amplitude 0 hold no change."""

    erow: torch.Tensor
    fx: torch.Tensor | None
    sp32: torch.Tensor
    slot32: torch.Tensor
    G: int
    gb: int

    @property
    def shift(self) -> int:
        return self.gb.bit_length() - 1


def _bucket(G: int) -> int:
    return next(b for b in BUCKETS if G <= b)


def _blob_layout(E, M, S, G, gb, fermionic):
    """Byte offsets of the entry path's staged blob (``csrc/apply_repr.cu``
    ``Params.o_*``; -1 where absent: ``fx`` and ``q`` without
    ``fermionic`` translations) and its size, each region aligned to 16
    bytes."""
    def a16(b):
        return (b + 15) & ~15
    sizes = [("rec", 16 * E), ("erow", 4 * M * (gb + 4)),
             ("fx", 8 * M if fermionic else -1), ("sp", 4 * S * (gb + 4)),
             ("slot", 8 * S), ("phase", 16 * G),
             ("q", 8 * G * S if fermionic else -1)]
    off, o = {}, 0
    for name, size in sizes:
        if size < 0:
            off[name] = -1
            continue
        off[name] = o
        o += a16(size)
    return off, o


def entry_tables(rt: TransTables, tabs: RowTables) -> EntryTables:
    """The :class:`EntryTables` of ``tabs`` under ``rt`` on tabs' device
    (host numpy, once per RowTables and translation set; G <= 32)."""
    cached = getattr(tabs, "_entry", None)
    if cached is not None and cached[0] is rt:
        return cached[1]
    G, S = rt.G, rt.S
    gb = _bucket(G)
    sh = gb.bit_length() - 1
    rec = tabs.rec.cpu().numpy().view(np.uint32)
    ad = tabs.ad.cpu().numpy()
    M = ad.shape[0]
    re = np.ascontiguousarray(ad[:, 0]).view(np.float64)
    im = (np.ascontiguousarray(ad[:, 1]).view(np.float64) if tabs.is_complex
          else np.zeros(M))
    dlt = ad[:, 2 if tabs.is_complex else 1]
    slots = tabs.slots.cpu().numpy().astype(np.int64)
    strides = tabs.strides.cpu().numpy().astype(np.int64)
    sstride = rt.sstride.cpu().numpy()
    sdim = rt.sdim.cpu().numpy()
    SP = rt.sp.cpu().numpy()
    odd = None if rt.qmask is None else rt.oddmask.cpu().numpy()
    delta = np.zeros((M, G), np.int64)
    fx = np.zeros(M, np.int64)
    for e in range(tabs.n_cols):
        on = strides[e] != 0
        sl, js = slots[e][on], strides[e][on]
        dims = sdim[sl]
        c = np.arange(int(np.prod(dims)))
        idx = int(rec[e, 0] & _OFFSET) + c
        v = (c[:, None] // js) % dims                     # before the image
        after = (v * sstride[sl]).sum(1) + dlt[idx]
        nv = (after[:, None] // sstride[sl]) % dims       # after it
        live = (re[idx] != 0) | (im[idx] != 0)
        delta[idx] = np.where(live[:, None], nv - v, 0) @ SP[sl]
        if odd is not None:
            flip = ((odd[sl] >> v) ^ (odd[sl] >> nv)) & 1
            fx[idx] = np.where(live, (flip << sl).sum(1), 0)
    erow = np.zeros((M, gb + 4), np.int32)
    erow[:, 0:2] = re.view(np.int32).reshape(M, 2)
    erow[:, 2:4] = np.ascontiguousarray(im).view(np.int32).reshape(M, 2)
    erow[:, 4:4 + G] = ((delta << sh) & 0xFFFFFFFF).astype(
        np.uint32).view(np.int32)
    sp32 = np.zeros((S, gb + 4), np.int32)
    sp32[:, :G] = SP
    if rt.bits:
        slot32 = np.stack([np.log2(sstride).round().astype(np.int64),
                           sdim - 1], 1)
    else:
        slot32 = np.stack([sstride, sdim], 1)
    dev = tabs.rec.device

    def t(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=dev)
    et = EntryTables(erow=t(erow, np.int32),
                     fx=None if odd is None else t(fx, np.int64),
                     sp32=t(sp32, np.int32), slot32=t(slot32, np.int32),
                     G=G, gb=gb)
    tabs._entry = (rt, et)
    return et


def entry_plan(rt: TransTables, tabs: RowTables,
               ix: IndexTables) -> EntryTables | None:
    """The entry path's tables where the kernels take it for this operator,
    translation set and destination index (G <= 32; label space << shift
    below 2^32, so every key T_g << shift | g lies below the padding's
    0xFFFFFFFF; fewer than 2^31 rows; a direct table that marks absent
    labels with row n; the staged blob within ENTRY_TABLES_MAX bytes),
    else None: the general path."""
    if rt.G > BUCKETS[-1] or ix.n >= 2 ** 31 or (ix.mode == "direct"
                                                  and not ix.absent):
        return None
    gb = _bucket(rt.G)
    if ix.label_space << (gb.bit_length() - 1) > 0xFFFFFFFF:
        return None
    _, size = _blob_layout(tabs.n_cols, tabs.ad.shape[0], rt.S, rt.G, gb,
                           rt.qmask is not None)
    if size > ENTRY_TABLES_MAX:
        return None
    return entry_tables(rt, tabs)


def _blob(et: EntryTables, rt: TransTables, tabs: RowTables, phase):
    """The entry path's staged tables as one int32 tensor on tabs' device,
    and their byte offsets (:func:`_blob_layout`)."""
    off, size = _blob_layout(tabs.n_cols, et.erow.shape[0], rt.S, rt.G,
                             et.gb, et.fx is not None)
    blob = torch.zeros(size // 4, dtype=torch.int32, device=et.erow.device)

    def put(name, t):
        if off[name] >= 0 and t.numel():
            flat = t.contiguous().view(-1).view(torch.int32)
            blob[off[name] // 4: off[name] // 4 + flat.numel()] = flat
    put("rec", tabs.rec)
    put("erow", et.erow)
    if et.fx is not None:
        put("fx", et.fx)
        put("q", rt.qmask)
    put("sp", et.sp32)
    put("slot", et.slot32)
    put("phase", phase)
    return blob, off


# --------------------------------------------------------------------------
# The kernels' plain versions
# --------------------------------------------------------------------------


def _block(rows: int, tabs: RowTables, rt: TransTables, device) -> int:
    per_row = max(tabs.n_cols, 1) * (rt.G + rt.S + tabs.slots.shape[1])
    b = max(256, config.memory("repr_block_budget", device) // per_row)
    return int(min(1 << int(math.floor(math.log2(b))), max(rows, 1)))


def _sign_plain(rt: TransTables, fm, gs):
    """sigma of translation gs on states with odd-count slots fm, float64."""
    slots = torch.arange(rt.S, device=fm.device)
    par = (_parity(fm[..., None] & rt.qmask[gs])
           & ((fm[..., None] >> slots) & 1)).sum(-1) & 1
    return 1.0 - 2.0 * par.double()


def _orbit_min_plain(rt: TransTables, cs, V, fo, tgt):
    """The general path's translation of images ``tgt`` (rows, E) of rows
    with slot values ``V`` (rows, S) and odd-count slots ``fo`` (rows,) or
    None, ``cs`` (E, A) int64 the slots each column changes (-1 past its
    arity): (the minimum over g of T_g(m), the first g that reaches it,
    the sign sigma of that g as float64), each (rows, E)."""
    on = cs >= 0
    s = cs.clamp(min=0)
    vm = (tgt[:, :, None] // rt.sstride[s]) % rt.sdim[s]          # (B, E, A)
    dv = torch.where(on, vm - V[:, s], 0)
    tr = (V[:, :, None] * rt.sp).sum(1)                           # (B, G)
    T = tr[:, None, :] + (dv[..., None] * rt.sp[s]).sum(2)        # (B, E, G)
    rmin = T.min(-1).values
    G = rt.G
    gs = torch.where(T == rmin[..., None],
                     torch.arange(G, device=T.device), G).min(-1).values
    sig = torch.ones(tgt.shape, dtype=torch.float64, device=tgt.device)
    if rt.qmask is not None:
        fm = fo[:, None].expand(tgt.shape).clone()
        for a in range(cs.shape[1]):
            sa = s[:, a]
            bit = torch.ones_like(sa) << sa
            odd = (rt.oddmask[sa] >> vm[:, :, a]) & 1
            fm = torch.where(on[:, a], (fm & ~bit) | (odd << sa), fm)
        sig = _sign_plain(rt, fm, gs)
    return rmin, gs, sig


def _entry_images_plain(et: EntryTables, rt: TransTables, tabs: RowTables,
                        V, fo, translate: bool = True):
    """The entry path's routine on rows with slot values ``V`` (rows, S)
    and odd-count slots ``fo``, every image column, read from ``et`` as the
    kernels read it: amp (rows, E) complex128 with its Jordan-Wigner sign;
    with ``translate``, each image's minimum r_j, first g* and sigma, from
    the keys (T_g(r) << shift | g) + erow's changes mod 2^32 and their
    minimum."""
    c = (V[:, tabs.slots.long()] * tabs.strides).sum(-1)          # (B, E)
    idx = (tabs.rec[:, 0].long() & _OFFSET) + c
    er = et.erow[idx]                                   # (B, E, gb + 4)
    a = er[..., :4].contiguous().view(torch.float64)
    amp = torch.complex(a[..., 0], a[..., 1])
    if tabs.wmask is not None:
        amp = amp * (1 - 2 * _parity(fo[:, None] & tabs.wmask)).double()
    if not translate:
        return amp
    G, sh = et.G, et.shift
    tr = (V[:, :, None] * et.sp32[:, :G].long()).sum(1)           # (B, G)
    keys = (tr << sh) | torch.arange(G, device=V.device)
    keys = (keys[:, None, :] + (er[..., 4:4 + G].long() & 0xFFFFFFFF)) \
        & 0xFFFFFFFF                                              # (B, E, G)
    kmin = keys.min(-1).values
    rmin, gs = kmin >> sh, kmin & (et.gb - 1)
    sig = torch.ones(kmin.shape, dtype=torch.float64, device=V.device)
    if et.fx is not None:
        sig = _sign_plain(rt, fo[:, None] ^ et.fx[idx], gs)
    return amp, rmin, gs, sig


def _translate_plain(rt: TransTables, tabs: RowTables, ix: IndexTables,
                     labels, fodd, i0: int, i1: int, translate: bool = True):
    """The kernels' routine on the rows i0 .. i1 - 1, every image column,
    in the formulation :func:`entry_plan` picks for them: amp (rows, E)
    with its Jordan-Wigner sign; ``own`` (rows, E), the diagonal columns
    with a nonzero amplitude; with ``translate``, ``valid`` (the other
    nonzero columns whose representative the index holds), its row j,
    sigma (float64) and g*, each (rows, E)."""
    lab = labels[i0:i1]
    fo = None if fodd is None else fodd[i0:i1]
    V = (lab[:, None] // rt.sstride) % rt.sdim                   # (B, S)
    et = entry_plan(rt, tabs, ix)
    if et is not None:
        out = _entry_images_plain(et, rt, tabs, V, fo, translate)
        amp = out[0] if translate else out
    else:
        amp, tgt = _row_images(tabs, lab, V, fo)                  # (B, E)
    diag = tabs.diagonal[None, :]
    live = amp != 0
    own = live & diag
    if not translate:
        return amp, own
    if et is not None:
        _, rmin, gs, sig = out
    else:
        rmin, gs, sig = _orbit_min_plain(rt, column_slots(tabs).long(), V,
                                         fo, tgt)
    j = lookup_tables(ix, rmin)
    valid = live & ~diag & (ix.labels[j] == rmin)
    return amp, own, valid, j, sig, gs


def _complex_phase(phase):
    return torch.complex(phase[:, 0], phase[:, 1])


def _repr_rows_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                     x):
    """Plain PyTorch ``repr_rows``."""
    n = ix.n
    y = torch.empty(n, dtype=torch.complex128, device=x.device)
    ph = _complex_phase(phase)
    B = _block(n, tabs, rt, x.device)
    for i0 in range(0, n, B):
        i1 = min(i0 + B, n)
        xi = x[i0:i1]
        acc = xi * (diag[i0:i1] if diag is not None else 0.0)
        if tabs.n_cols:
            amp, own, valid, j, sig, gs = _translate_plain(
                rt, tabs, ix, labels, fodd, i0, i1)
            acc = acc + torch.where(own, amp, 0).sum(1).conj() * xi
            w = torch.where(valid, sqrt_nu[j] * isn[i0:i1, None] * sig, 0.0)
            acc = acc + (w * amp.conj() * ph[gs] * x[j]).sum(1)
        y[i0:i1] = acc
    return y


def _repr_scatter_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag,
                        phase, x, n_src):
    """Plain PyTorch ``repr_scatter``, ``index_add_`` over row blocks."""
    y = torch.zeros(ix.n, dtype=torch.complex128, device=x.device)
    ph = _complex_phase(phase)
    B = _block(n_src, tabs, rt, x.device)
    for i0 in range(0, n_src, B):
        i1 = min(i0 + B, n_src)
        w = x[i0:i1] * isn[i0:i1]
        own = torch.zeros(i1 - i0, dtype=torch.complex128, device=x.device)
        if diag is not None:
            own = own + diag[i0:i1]
        if tabs.n_cols:
            out = _translate_plain(rt, tabs, ix, labels, fodd, i0, i1,
                                   translate=not tabs.diag_only)
            amp, ownc = out[0], out[1]
            own = own + torch.where(ownc, amp, 0).sum(1)
            if not tabs.diag_only:
                _, _, valid, j, sig, gs = out
                c = torch.where(valid, sqrt_nu[j] * sig, 0.0) * amp * ph[gs]
                y.index_add_(0, j.reshape(-1), (c * w[:, None]).reshape(-1))
        lab = labels[i0:i1]
        j = lookup_tables(ix, lab)
        ok = ix.labels[j] == lab
        y.index_add_(0, j, torch.where(ok, sqrt_nu[j] * own * w, 0.0))
    return y


def _repr_images_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase,
                       row0, rows):
    """The image stage of the plain ``repr_images``: rows row0 .. row0 +
    rows - 1, one entry an image column, (cols (rows, E) int64, vals (rows,
    E) complex128): the column j and H[i, j] of every image the sector
    holds (a diagonal column: i and conj(A)), (-1, 0) for the others.
    ``compact_rows`` makes the rows of it."""
    if not tabs.n_cols:
        return (torch.zeros((rows, 0), dtype=torch.int64, device=isn.device),
                torch.zeros((rows, 0), dtype=torch.complex128,
                            device=isn.device))
    amp, own, valid, j, sig, gs = _translate_plain(
        rt, tabs, ix, labels, fodd, row0, row0 + rows)
    w = torch.where(valid, sqrt_nu[j] * isn[row0:row0 + rows, None] * sig,
                    0.0)
    i = torch.arange(row0, row0 + rows, device=j.device)[:, None]
    cols = torch.where(valid, j, torch.where(own, i, -1))
    vals = torch.where(own, amp.conj(),
                       w * amp.conj() * _complex_phase(phase)[gs])
    return cols, vals


def _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase, row0,
                    rows, block=None):
    """Plain PyTorch ``repr_images``: the finished rows row0 .. row0 +
    rows - 1, :func:`_repr_images_plain` and ``compact_rows`` over blocks
    of ``block`` rows (default: the plain versions' block), padded to the
    widest."""
    B = block or _block(rows, tabs, rt, isn.device)
    return assemble([compact_rows(*_repr_images_plain(
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase, i0,
        min(B, row0 + rows - i0))) for i0 in range(row0, row0 + rows, B)],
        torch.complex128, isn.device)


# --------------------------------------------------------------------------
# The kernels: building, argument checks, launch records
# --------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/apply_repr.cu::Params, field by field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "rec", "ad", "cslot", "cstr", "sstride", "sdim", "oddmask", "sp",
        "qmask", "phase", "labels", "fodd", "isn", "diag", "t0", "t1",
        "index_labels", "sqrt_nu", "x", "y", "cols", "vals", "tr_scratch",
        "blob", "gsel", "gstr", "rrec", "xlab", "width", "row_scratch")]
        + [(f, ctypes.c_longlong) for f in (
            "M", "row0", "rows", "sa", "sb", "label_space", "n",
            "scratch_blocks", "blob_bytes", "row_blocks", "row_shared")]
        + [(f, ctypes.c_int) for f in (
            "E", "A", "amp_c", "S", "G", "bits", "diag_only", "mode",
            "sa_shift", "tabs_shared", "threads", "gb", "absent", "o_erow",
            "o_fx", "o_sp", "o_slot", "o_phase", "o_q", "W", "write")])


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/apply_repr.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        lib.qbt_repr_params_size.restype = ctypes.c_longlong
        if lib.qbt_repr_params_size() != ctypes.sizeof(_Params):
            raise RuntimeError("csrc/apply_repr.cu's Params and _Params "
                               "differ in size")
        for name in KERNELS:
            fn = getattr(lib, f"qbt_{name}")
            fn.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.qbt_repr_label_clear.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p]
        lib.qbt_repr_label_clear.restype = ctypes.c_int
        lib.qbt_repr_images_scratch.argtypes = [ctypes.POINTER(_Params)]
        lib.qbt_repr_images_scratch.restype = ctypes.c_longlong
        _lib = lib
    return _lib


def _check_record(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                  dev, rows):
    """What the kernels take but x, checked when a launch record is built:
    every tensor on ``dev``, contiguous, of its type and shape; ``rows``
    source rows read."""
    def need(name, t, dt, shape):
        _need(name, t, dt, shape, dev)
    _check_tables(tabs, dev)
    E, A = tabs.slots.shape
    need("column slots", column_slots(tabs), torch.int32, (E, A))
    S, G = rt.S, rt.G
    need("sp", rt.sp, torch.int64, (S, G))
    need("sstride", rt.sstride, torch.int64, (S,))
    need("sdim", rt.sdim, torch.int64, (S,))
    if not 1 <= S <= 63:
        raise ValueError("the repr kernels take 1 to 63 slots")
    if (rt.qmask is None) != (rt.oddmask is None):
        raise ValueError("a fermionic space needs both qmask and oddmask")
    need("qmask", rt.qmask, torch.int64, (G, S))
    need("oddmask", rt.oddmask, torch.int64, (S,))
    need("phase", phase, torch.float64, (G, 2))
    if ix.mode not in _MODES:
        raise ValueError(f"unknown index mode {ix.mode!r}")
    need("index t0", ix.t0, torch.int32 if ix.mode == "direct"
         else torch.int64, tuple(ix.t0.shape))
    need("index t1", ix.t1, torch.int64, tuple(ix.t1.shape)
         if ix.t1 is not None else ())
    need("index labels", ix.labels, torch.int64, (ix.n,))
    if ix.mode == "lin" and (ix.t1 is None or ix.sa < 1):
        raise ValueError("a lin index needs Jb and its split")
    if sqrt_nu.numel() < ix.n:
        raise ValueError(f"sqrt_nu holds {sqrt_nu.numel()} of the index's "
                         f"{ix.n} rows")
    need("sqrt_nu", sqrt_nu, torch.float64, (sqrt_nu.numel(),))
    R = labels.numel()
    if R < rows:
        raise ValueError(f"{rows} rows read, the basis holds {R}")
    need("labels", labels, torch.int64, (R,))
    need("isn", isn, torch.float64, (R,))
    if diag is not None:
        need("diag", diag, torch.float64, (diag.numel(),))
        if diag.numel() < rows:
            raise ValueError(f"diag holds {diag.numel()} of {rows} rows")
    need("fodd", fodd, torch.int64, (R,))
    if (rt.qmask is not None or tabs.wmask is not None) and fodd is None:
        raise ValueError("fermions need the basis' fodd")


def _check_x(x, dev, rows):
    """What the kernels take of x: a contiguous complex128 vector on
    ``dev`` of at least ``rows`` entries."""
    if x.dtype != torch.complex128 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous complex128 vector")
    if x.device != dev:
        raise ValueError(f"x is on {x.device}, the tables on {dev}")
    if x.numel() < rows:
        raise ValueError(f"x holds {x.numel()} rows, {rows} are read")


class LabelBuffer:
    """The entry path's label buffer of one CUDA device: (L, 2) float64,
    zero but at the labels of the basis whose ``repr_rows`` launched last,
    where it holds that launch's sqrt(nu_j) x_j (its pre-pass writes them).
    One a device, shared by every basis and engine there, so a run holds
    one however many sectors it keeps: it grows to the largest label space
    a launch asks for (a record takes the entry path only where 16 bytes a
    label fit ``repr_label_buffer_max``) and is freed when the basis that
    used it last is (its labels, held weakly, are collected). Before a
    launch on another basis, the previous basis' labels are zeroed; a
    launch on another stream than the last waits for the last."""

    _of: dict = {}

    def __init__(self, device):
        self.device = torch.device(device)
        self.buf = None
        self._owner = None      # a weak reference to the sorted labels of
        #                         the basis whose values it holds
        self.stream = None      # the raw handle of its last launch's stream
        self._last = None       # that stream (a CUDA device's)

    @property
    def owner(self) -> torch.Tensor | None:
        """The sorted labels of the basis whose values the buffer holds."""
        return None if self._owner is None else self._owner()

    def _release(self, ref) -> None:
        if ref is self._owner:          # its basis is gone: free it
            self.buf = self._owner = None

    @classmethod
    def of(cls, device) -> "LabelBuffer":
        """The label buffer of ``device`` (made empty at the first ask;
        ``cuda`` is the current CUDA device)."""
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        got = cls._of.get(dev)
        if got is None:
            got = cls._of[dev] = cls(dev)
        return got

    @classmethod
    def held_bytes(cls) -> int:
        """The bytes every device's label buffer holds now."""
        return sum(0 if b.buf is None else b.buf.numel() * 8
                   for b in cls._of.values())

    def claim(self, labels: torch.Tensor, label_space: int, stream,
              clear) -> torch.Tensor:
        """The buffer for a launch over the basis whose sorted labels are
        ``labels`` on the current stream, whose raw handle is ``stream``:
        ordered after the last launch's stream; grown to ``label_space``
        rows where smaller (the old one freed first: zeros throughout),
        else the previous basis' labels zeroed by ``clear(buf, labels)``
        where another basis held it."""
        cuda = self.device.type == "cuda"
        if self.buf is not None and stream != self.stream:
            if cuda:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_stream(self._last)
                self.buf.record_stream(cur)
                self._last = cur
            self.stream = stream
        if self.buf is None or self.buf.shape[0] < label_space:
            self.buf = self._owner = None
            self.buf = torch.zeros((label_space, 2), dtype=torch.float64,
                                   device=self.device)
            self.stream = stream
            self._last = torch.cuda.current_stream(self.device) if cuda \
                else None
        owner = self.owner
        if owner is not labels:
            if owner is not None:
                clear(self.buf, owner)
            self._owner = weakref.ref(labels, self._release)
        return self.buf


def _clear_labels(buf: torch.Tensor, labels: torch.Tensor, stream) -> None:
    err = build_library().qbt_repr_label_clear(
        buf.data_ptr(), labels.data_ptr(), labels.numel(), stream)
    if err != 0:
        raise RuntimeError(f"label buffer clear failed: cudaError {err}")


class ReprLaunch:
    """One repr kernel's launch, built once per engine (``MatvecRepr``, a
    ``mopr_x_vec_repr`` call, an ELL build): ``kind`` one of ``KERNELS``,
    the arguments of ``repr_rows`` but x, ``rows`` the source rows a call
    reads (``ix.n`` gathering, n_src scattering, the rows an images call
    may ask for), ``rrec`` the destination's :func:`row_records` (the
    scatter's and the images'; built here where None).
    Building it makes every check of the arguments,
    picks the path (:func:`entry_plan`, the placement bounds as they are
    now; ``repr_rows`` takes the entry path only where its label buffer,
    16 bytes a label of ``ix``, fits ``repr_label_buffer_max``) and packs
    the ctypes struct with all but x and y. A call then checks x (type,
    device, contiguity, length), allocates y, writes the two pointers (and
    the device's :class:`LabelBuffer`, ``repr_rows`` on the entry path) and
    launches on the current stream. On CPU tensors a call runs the plain
    version. The record holds the basis' tensors: keep it with the engine
    that owns them."""

    def __init__(self, kind, rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                 diag, phase, rows, rrec=None):
        if kind not in KERNELS:
            raise ValueError(f"unknown repr kernel {kind!r}")
        dev = labels.device
        _device_of(labels)
        _check_record(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                      dev, rows)
        self.kind, self.device, self.rows, self.n_out = kind, dev, rows, ix.n
        self.args = (rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase)
        self.entry = entry_plan(rt, tabs, ix)
        if kind == "repr_rows" and 16 * ix.label_space > config.memory(
                "repr_label_buffer_max", dev):
            self.entry = None
        self.by_label = kind == "repr_rows" and self.entry is not None
        if kind != "repr_rows":
            if rrec is None:
                rrec = row_records(ix, sqrt_nu)
            _need("row records", rrec, torch.int64, (ix.n, 2), dev)
        else:
            rrec = None
        E, A = tabs.slots.shape

        def ptr(t):
            return None if t is None else t.data_ptr()
        # tensors the struct points into, kept alive with it
        self._keep = [] if rrec is None else [rrec]
        scratch, blocks = None, 0
        blob, off = None, dict.fromkeys(
            ("erow", "fx", "sp", "slot", "phase", "q"), -1)
        if self.entry is not None:
            blob, off = _blob(self.entry, rt, tabs, phase)
            self._keep.append(blob)
        elif (8 * rt.G * THREADS > TR_SHARED_MAX and dev.type == "cuda"
              and kind != "repr_images"):    # images: T_g(r) a warp
            blocks = 2 * torch.cuda.get_device_properties(
                dev).multi_processor_count
            scratch = torch.empty(blocks * rt.G * THREADS,
                                  dtype=torch.int64, device=dev)
            self._keep.append(scratch)
        shared = (tabs.nbytes + 8 * E * A + rt.nbytes) <= TABLES_SHARED_MAX
        self.p = _Params(
            rec=ptr(tabs.rec), ad=ptr(tabs.ad), cslot=ptr(column_slots(tabs)),
            cstr=ptr(tabs.strides), sstride=ptr(rt.sstride),
            sdim=ptr(rt.sdim), oddmask=ptr(rt.oddmask), sp=ptr(rt.sp),
            qmask=ptr(rt.qmask), phase=ptr(phase), labels=ptr(labels),
            fodd=ptr(fodd), isn=ptr(isn), diag=ptr(diag), t0=ptr(ix.t0),
            t1=ptr(ix.t1), index_labels=ptr(ix.labels),
            sqrt_nu=ptr(sqrt_nu), tr_scratch=ptr(scratch), blob=ptr(blob),
            gsel=ptr(tabs.gsel),
            gstr=ptr(tabs.strides) if tabs.gsel is not None else None,
            rrec=ptr(rrec), M=tabs.ad.shape[0], row0=0, rows=rows,
            sa=ix.sa, label_space=ix.label_space, n=ix.n,
            scratch_blocks=blocks,
            blob_bytes=0 if blob is None else 4 * blob.numel(), E=E, A=A,
            amp_c=int(tabs.is_complex), S=rt.S, G=rt.G, bits=int(rt.bits),
            diag_only=int(tabs.diag_only), mode=_MODES[ix.mode], sa_shift=-1,
            tabs_shared=int(shared), threads=THREADS,
            gb=0 if self.entry is None else self.entry.gb,
            absent=int(ix.absent),
            o_erow=off["erow"], o_fx=off["fx"], o_sp=off["sp"],
            o_slot=off["slot"], o_phase=off["phase"], o_q=off["q"])
        self._pp = ctypes.byref(self.p)
        self._fn = None

    def _launch(self):
        if self._fn is None:
            self._fn = getattr(build_library(), f"qbt_{self.kind}")
            self._dev = self.device.index
        # the current stream's handle as an int (what
        # torch.cuda.current_stream(dev).cuda_stream gives, without making
        # a Stream object a call)
        if torch._C._cuda_getDevice() == self._dev:
            err = self._enqueue()
        else:
            with torch.cuda.device(self.device):
                err = self._enqueue()
        if err != 0:
            raise RuntimeError(f"{self.kind} kernel launch failed: "
                               f"cudaError {err}")
        launches[self.kind] += 1

    def _enqueue(self) -> int:
        stream = torch._C._cuda_getCurrentRawStream(self._dev)
        if self.by_label:
            ix = self.args[2]
            self.p.xlab = LabelBuffer.of(self.device).claim(
                ix.labels, ix.label_space, stream,
                lambda buf, old: _clear_labels(buf, old, stream)).data_ptr()
        return self._fn(self._pp, stream)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """y = H x (``repr_rows``, ``ix.n`` rows) or y = A x
        (``repr_scatter``, from the first ``rows`` source rows into the
        destination's ``ix.n``); on a CUDA device the scatter's float64
        atomic adds sum in an order that changes from run to run (every
        column diagonal: plain stores)."""
        if self.kind == "repr_images":
            raise TypeError("a repr_images record is called by images()")
        if self.device.type == "cpu" and _device_of(x) == "cpu":
            if self.kind == "repr_rows":
                return _repr_rows_plain(*self.args, x)
            return _repr_scatter_plain(*self.args, x, self.rows)
        _check_x(x, self.device, self.rows)
        y = torch.empty(self.n_out, dtype=torch.complex128, device=x.device)
        if self.rows == 0 or self.n_out == 0:
            return y.zero_()
        p = self.p
        p.x = x.data_ptr()
        p.y = y.data_ptr()
        self._launch()
        return y

    def images(self, row0: int, rows: int, block: int | None = None):
        """Rows ``row0 .. row0 + rows - 1`` of H in the sector as finished
        ELL rows: (cols (rows, W) int32, vals (rows, W) complex128), each
        row's entries (j, H[i, j]) merged over its images (a diagonal
        column's at j = i), sorted by column, (0, 0) past them, W the
        widest of these rows. On a CUDA device two launches (the count
        pass, then the rows) and one host sync, for any number of image
        columns (``ell_build.row_scratch``); on the CPU the plain
        version, ``_repr_images_plain`` and ``compact_rows`` over blocks of
        ``block`` rows (default: the plain versions' block)."""
        if self.kind != "repr_images":
            raise TypeError(f"a {self.kind} record is called with x")
        if not 0 <= row0 <= row0 + rows <= self.rows:
            raise ValueError(f"rows {row0} .. {row0 + rows} outside the "
                             f"sector's {self.rows}")
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, _, phase = self.args
        if not rows or not tabs.n_cols:
            return (torch.zeros((rows, 0), dtype=torch.int32,
                                device=self.device),
                    torch.zeros((rows, 0), dtype=torch.complex128,
                                device=self.device))
        if self.device.type == "cpu":
            return _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                   phase, row0, rows, block)
        if ix.n >= 2 ** 31 - 1:
            raise ValueError("the ELL build takes fewer than 2 ** 31 - 1 "
                             "rows")
        p = self.p
        p.row0, p.rows = row0, rows
        # the rows' scratch where it is not in shared memory, held to the
        # end of the build
        scratch = ell_build.row_scratch(
            p, build_library().qbt_repr_images_scratch, self.device)

        def launch(cols, vals, width, W):
            p.cols, p.vals, p.width = (None if t is None else t.data_ptr()
                                       for t in (cols, vals, width))
            p.W, p.write = W, int(cols is not None)
            self._launch()
        out = two_pass(rows, torch.complex128, self.device, launch)
        del scratch
        return out


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------


class MatvecRepr:
    """y = H x in a momentum sector; complex128, matrix-free, one
    ``repr_rows`` launch an apply through a :class:`ReprLaunch` built at
    the first apply (again if the basis' index was replaced)."""

    def __init__(self, compiled: CompiledOperator, rbasis: ReprBasis):
        self.compiled = compiled
        self.basis = rbasis
        self.n = rbasis.n
        self.device = rbasis.device
        self.dtype = torch.float64
        self.is_complex = True
        self.tables = pack_rows(compiled, self.device)
        self.trans = translation_tables(rbasis.tset)
        if compiled.diag_terms.q_zero():
            self.diag_b = torch.zeros(rbasis.labels_b.shape,
                                      dtype=torch.float64, device=self.device)
        else:
            self.diag_b = compile_diagonal(compiled.diag_terms,
                                           compiled.space)(rbasis.V_b)
        self.phase = phase_table(rbasis.tset, rbasis.momentum)
        self._records = {}

    def args(self):
        """repr_rows' arguments but x (also those of repr_images)."""
        rb = self.basis
        labels, fodd, isn = rb.rows()
        return (self.trans, self.tables, rb.index.tables, labels, fodd, isn,
                rb.sqrt_nu, self.diag_b.view(-1), self.phase)

    def record(self, kind: str = "repr_rows") -> ReprLaunch:
        """The launch record of ``repr_rows`` (or ``repr_images``: the ELL
        build's) over this sector, built once per basis index."""
        index = self.basis.index
        got = self._records.get(kind)
        if got is None or got[0] is not index:
            args = list(self.args())
            if kind == "repr_images":
                args[7] = None
            got = (index, ReprLaunch(
                kind, *args, self.n, rrec=None if kind == "repr_rows"
                else self.basis.row_records()))
            self._records[kind] = got
        return got[1]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.complex128 or not x.is_contiguous():
            x = x.to(torch.complex128).contiguous()
        return self.record()(x)


def mopr_x_vec_repr(compiled: CompiledOperator, src: ReprBasis,
                    dst: ReprBasis, x: torch.Tensor) -> torch.Tensor:
    """y = A x across momentum sectors (forward scatter direction).

    Port of the JAX package's moprXvec_repr (reference:
    src/model.cc:1715-1856). ``A`` must carry a definite momentum transfer q
    with dst.momentum = k_src - q for A = sum_x e^{-i q.x} O_x (the double
    projection P_k' A P_k then collapses to P_k' A):

        y_j = sum_i x_i sqrt(nu'_j / nu_i) sum_{m in A|r_i>}
                  B_m sigma*_m e^{+i k'.R*_m}

    Images whose representative is not in the destination basis are dropped
    (zero norm or out of sector), matching the reference's lookup-miss
    behavior. One ``repr_scatter`` launch (:func:`scatter_launch`); on a
    CUDA device its atomic sums are not in a fixed order: two runs may
    differ in the last bits.
    """
    x = x.to(device=src.device, dtype=torch.complex128).contiguous()
    return scatter_launch(compiled, src, dst)(x)


def scatter_args(compiled: CompiledOperator, src: ReprBasis,
                 dst: ReprBasis):
    """repr_scatter's arguments but x and n_src for y = A x from ``src``
    into ``dst`` (the operator packed, its real diagonal evaluated)."""
    diag = (None if compiled.diag_terms.q_zero() else
            compile_diagonal(compiled.diag_terms, compiled.space)(
                src.V_b).view(-1))
    labels, fodd, isn = src.rows()
    return (translation_tables(src.tset), pack_rows(compiled, src.device),
            dst.index.tables, labels, fodd, isn, dst.sqrt_nu, diag,
            phase_table(src.tset, dst.momentum, +1))


def scatter_launch(compiled: CompiledOperator, src: ReprBasis,
                   dst: ReprBasis) -> ReprLaunch:
    """The launch record of y = A x from ``src`` into ``dst``
    (:func:`scatter_args`, the source's n rows, the destination's row
    records): call it with x as many times as the two bases live."""
    return ReprLaunch("repr_scatter", *scatter_args(compiled, src, dst),
                      src.n, rrec=dst.row_records())
