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

Three calls carry it, over the operator's packed columns
(``ops/apply.py::pack_rows``) and the translations packed by
:func:`translation_tables`: :func:`repr_rows` (``MatvecRepr``),
:func:`repr_scatter` (``mopr_x_vec_repr``) and :func:`repr_images` (each
row's columns and coefficients, for ``ops/sparse.py::build_sparse_repr``).
On CUDA tensors they launch ``csrc/apply_repr.cu`` (built with nvcc for
sm_90a at first use, loaded with ctypes), where no (rows, terms, images, G)
intermediate reaches device memory; on CPU tensors they run their plain
versions, which repeat the kernels' formulation with torch ops over row
blocks: T_g(m) = T_g(r) + sum over the term's slots of (V_s(m) - V_s(r))
SP[s, g] in int64, the first g that reaches the minimum, the fermionic
sign as popcounts against one mask a (g, slot), and a diagonal column (every
displacement 0) taken as the row itself with coefficient A.
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
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
    sector_norms,
)
from quantum_basis_tpu_torch.ops import cuda_build
from quantum_basis_tpu_torch.ops.apply import (
    _MODES,
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

_NU_TOL = 1e-10
_SRC = cuda_build.CSRC / "apply_repr.cu"

KERNELS = ("repr_rows", "repr_scatter", "repr_images")
# Kernel launches since the last reset, by kernel (the CPU plain versions
# are not counted): lets a run show that its applies went through them.
launches = dict.fromkeys(KERNELS, 0)

# A block of the kernels stages its tables (the columns' records, entries,
# slots and strides, and the translations) in shared memory up to this many
# bytes, else reads them from device memory; it holds its rows' G
# translated labels (8 G bytes a row, THREADS rows) in shared memory up to
# TR_SHARED_MAX bytes, else in a device scratch of two blocks an SM.
TABLES_SHARED_MAX = 48 * 1024
TR_SHARED_MAX = 64 * 1024
THREADS = 128           # rows a block (csrc/apply_repr.cu::kThreads)

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
        index = BasisIndex(labels, space.label_space, device=tset.device)
        super().__init__(space, labels, index, block_rows, device=tset.device)
        nu_pad = np.concatenate([self.nus, np.ones(self.pad)])
        dev = self.device
        self.inv_sqrt_nu_b = torch.as_tensor(
            (1.0 / np.sqrt(nu_pad)).reshape(self.n_blocks, self.block_rows),
            device=dev)
        # entry n is the padding slot for images that leave the sector
        self.sqrt_nu = torch.as_tensor(
            np.sqrt(np.concatenate([self.nus, [1.0]])), device=dev)

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
# The kernels' plain versions
# --------------------------------------------------------------------------


def _block(rows: int, tabs: RowTables, rt: TransTables, device) -> int:
    per_row = max(tabs.n_cols, 1) * (rt.G + rt.S + tabs.slots.shape[1])
    b = max(256, config.memory("repr_block_budget", device) // per_row)
    return int(min(1 << int(math.floor(math.log2(b))), max(rows, 1)))


def _orbit_min_plain(rt: TransTables, cs, V, fo, tgt):
    """The kernels' translation of images ``tgt`` (rows, E) of rows with
    slot values ``V`` (rows, S) and odd-count slots ``fo`` (rows,) or None,
    ``cs`` (E, A) int64 the slots each column changes (-1 past its arity):
    (the minimum over g of T_g(m), the first g that reaches it, the sign
    sigma of that g as float64), each (rows, E)."""
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
        slots = torch.arange(rt.S, device=fm.device)
        par = (_parity(fm[..., None] & rt.qmask[gs])
               & ((fm[..., None] >> slots) & 1)).sum(-1) & 1
        sig = 1.0 - 2.0 * par.double()
    return rmin, gs, sig


def _translate_plain(rt: TransTables, tabs: RowTables, ix: IndexTables,
                     labels, fodd, i0: int, i1: int, translate: bool = True):
    """The kernels' routine on the rows i0 .. i1 - 1, every image column:
    amp (rows, E) with its Jordan-Wigner sign; ``own`` (rows, E), the
    diagonal columns with a nonzero amplitude; with ``translate``,
    ``valid`` (the other nonzero columns whose representative the index
    holds), its row j, sigma (float64) and g*, each (rows, E)."""
    lab = labels[i0:i1]
    fo = None if fodd is None else fodd[i0:i1]
    V = (lab[:, None] // rt.sstride) % rt.sdim                   # (B, S)
    amp, tgt = _row_images(tabs, lab, V, fo)                      # (B, E)
    diag = tabs.diagonal[None, :]
    live = amp != 0
    own = live & diag
    if not translate:
        return amp, own
    rmin, gs, sig = _orbit_min_plain(rt, column_slots(tabs).long(), V, fo,
                                     tgt)
    j = lookup_tables(ix, rmin)
    valid = live & ~diag & (ix.labels[j] == rmin)
    return amp, own, valid, j, sig, gs


def _complex_phase(phase):
    return torch.complex(phase[:, 0], phase[:, 1])


def _repr_rows_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                     x):
    """Plain PyTorch :func:`repr_rows`."""
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
    """Plain PyTorch :func:`repr_scatter`, ``index_add_`` over row blocks."""
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
    """Plain PyTorch :func:`repr_images`."""
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


# --------------------------------------------------------------------------
# The kernels: building, argument checks, wrappers
# --------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """csrc/apply_repr.cu::Params, field by field."""

    _fields_ = ([(f, ctypes.c_void_p) for f in (
        "rec", "ad", "cslot", "cstr", "sstride", "sdim", "oddmask", "sp",
        "qmask", "phase", "labels", "fodd", "isn", "diag", "t0", "t1",
        "index_labels", "sqrt_nu", "x", "y", "cols", "vals", "tr_scratch")]
        + [(f, ctypes.c_longlong) for f in (
            "M", "row0", "rows", "sa", "sb", "label_space", "n",
            "scratch_blocks")]
        + [(f, ctypes.c_int) for f in (
            "E", "A", "amp_c", "S", "G", "bits", "diag_only", "mode",
            "sa_shift", "tabs_shared", "threads", "pad")])


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
        _lib = lib
    return _lib


def _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x,
                rows):
    """What the kernels take, checked before a launch: every tensor on
    x's device, contiguous, of its type and shape."""
    dev = x.device

    def need(name, t, dt, shape):
        _need(name, t, dt, shape, dev)
    if x.dtype != torch.complex128 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous complex128 vector")
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


def _launch(kind, rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x,
            y, cols, vals, row0, rows):
    def ptr(t):
        return None if t is None else t.data_ptr()
    E, A = tabs.slots.shape
    shared = (tabs.nbytes + 8 * E * A + rt.nbytes) <= TABLES_SHARED_MAX
    scratch, blocks = None, 0
    if 8 * rt.G * THREADS > TR_SHARED_MAX:
        blocks = 2 * torch.cuda.get_device_properties(
            x.device).multi_processor_count
        scratch = torch.empty(blocks * rt.G * THREADS, dtype=torch.int64,
                              device=x.device)
    p = _Params(
        rec=ptr(tabs.rec), ad=ptr(tabs.ad), cslot=ptr(column_slots(tabs)),
        cstr=ptr(tabs.strides), sstride=ptr(rt.sstride), sdim=ptr(rt.sdim),
        oddmask=ptr(rt.oddmask), sp=ptr(rt.sp), qmask=ptr(rt.qmask),
        phase=ptr(phase), labels=ptr(labels), fodd=ptr(fodd), isn=ptr(isn),
        diag=ptr(diag), t0=ptr(ix.t0), t1=ptr(ix.t1),
        index_labels=ptr(ix.labels), sqrt_nu=ptr(sqrt_nu), x=ptr(x),
        y=ptr(y), cols=ptr(cols), vals=ptr(vals), tr_scratch=ptr(scratch),
        M=tabs.dlt.numel(), row0=row0, rows=rows, sa=ix.sa,
        label_space=ix.label_space, n=ix.n, scratch_blocks=blocks, E=E, A=A,
        amp_c=int(tabs.is_complex), S=rt.S, G=rt.G, bits=int(rt.bits),
        diag_only=int(tabs.diag_only), mode=_MODES[ix.mode], sa_shift=-1,
        tabs_shared=int(shared), threads=THREADS)
    lib = build_library()
    with torch.cuda.device(x.device):
        err = getattr(lib, f"qbt_{kind}")(
            ctypes.byref(p), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kind} kernel launch failed: cudaError {err}")
    launches[kind] += 1


def repr_rows(rt: TransTables, tabs: RowTables, ix: IndexTables, labels,
              fodd, isn, sqrt_nu, diag, phase, x) -> torch.Tensor:
    """y = H x in a momentum sector (Hermitian row-gather direction), one
    launch for the sector's ``ix.n`` rows.

    ``labels`` (R,) int64, ``fodd`` (R,) int64 or None and ``isn`` (R,)
    float64 (1/sqrt(nu_i)) are the basis' flat per-row arrays
    (``ReprBasis.rows``), ``ix`` its index, ``sqrt_nu`` its sqrt(nu_j);
    ``diag`` (R,) float64 or None the real diagonal; ``phase`` (G, 2) the
    (re, im) of e^{-i k.R} (:func:`phase_table`); ``x`` complex128. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise).
    """
    if _device_of(x) == "cpu":
        return _repr_rows_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                diag, phase, x)
    n = ix.n
    _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x, n)
    if x.numel() < n:
        raise ValueError(f"x holds {x.numel()} rows, the apply reads {n}")
    y = torch.empty(n, dtype=torch.complex128, device=x.device)
    if n:
        _launch("repr_rows", rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag,
                phase, x, y, None, None, 0, n)
    return y


def repr_scatter(rt: TransTables, tabs: RowTables, ix: IndexTables, labels,
                 fodd, isn, sqrt_nu, diag, phase, x,
                 n_src: int) -> torch.Tensor:
    """y = A x from a momentum sector into another (forward scatter), over
    the source rows ``0 .. n_src - 1``: ``labels``, ``fodd``, ``isn``,
    ``diag`` and ``x`` are the source's, ``ix`` and ``sqrt_nu`` the
    destination's (y has ``ix.n`` rows), ``phase`` the (re, im) of
    e^{+i k'.R} of the destination's momentum k'. Images whose
    representative the destination does not hold are dropped. CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise),
    whose float64 atomic adds sum in an order that changes from run to run
    (every column diagonal: plain stores).
    """
    if _device_of(x) == "cpu":
        return _repr_scatter_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                   diag, phase, x, n_src)
    _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x,
                n_src)
    if x.numel() < n_src:
        raise ValueError(f"x holds {x.numel()} rows, {n_src} are read")
    y = torch.zeros(ix.n, dtype=torch.complex128, device=x.device)
    if n_src and ix.n:
        _launch("repr_scatter", rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                diag, phase, x, y, None, None, 0, n_src)
    return y


def repr_images(rt: TransTables, tabs: RowTables, ix: IndexTables, labels,
                fodd, isn, sqrt_nu, phase, row0: int, rows: int):
    """Rows ``row0 .. row0 + rows - 1`` of H in a momentum sector, one
    entry an image column: (cols (rows, E) int64, vals (rows, E)
    complex128), the column j and H[i, j] of every image the sector holds
    (a diagonal column: i and conj(A)), (-1, 0) for the others. Arguments
    as in :func:`repr_rows`. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise).
    """
    if _device_of(isn) == "cpu":
        return _repr_images_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                  phase, row0, rows)
    if not 0 <= row0 <= row0 + rows <= ix.n:
        raise ValueError(f"rows {row0} .. {row0 + rows} outside the "
                         f"sector's {ix.n}")
    dummy = torch.zeros(1, dtype=torch.complex128, device=isn.device)
    _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, None, phase, dummy,
                row0 + rows)
    E = tabs.n_cols
    cols = torch.empty((rows, E), dtype=torch.int64, device=isn.device)
    vals = torch.empty((rows, E), dtype=torch.complex128, device=isn.device)
    if rows and E:
        _launch("repr_images", rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                None, phase, dummy, None, cols, vals, row0, rows)
    return cols, vals


# --------------------------------------------------------------------------
# The engines
# --------------------------------------------------------------------------


class MatvecRepr:
    """y = H x in a momentum sector; complex128, matrix-free, one
    :func:`repr_rows` call an apply."""

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

    def args(self):
        """repr_rows' arguments but x (also those of repr_images)."""
        rb = self.basis
        labels, fodd, isn = rb.rows()
        return (self.trans, self.tables, rb.index.tables, labels, fodd, isn,
                rb.sqrt_nu, self.diag_b.view(-1), self.phase)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.complex128).contiguous()
        return repr_rows(*self.args(), x)


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
    behavior. One :func:`repr_scatter` call; on a CUDA device its atomic
    sums are not in a fixed order: two runs may differ in the last bits.
    """
    x = x.to(device=src.device, dtype=torch.complex128).contiguous()
    return repr_scatter(*scatter_args(compiled, src, dst), x, src.n)


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
