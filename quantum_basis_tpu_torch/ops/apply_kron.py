"""Tensor-factorized sector apply: dense matmuls or a fused ELL kernel.

Port of ``quantum_basis_tpu.ops.apply_kron``. Many sector Hamiltonians
factorize over a tensor product of two smaller conserved subsectors:

    H = H_a (x) I_b  +  I_a (x) H_b  +  sum_m D_a,m (x) D_b,m

with ``D_*`` diagonal. The canonical case is the Fermi-Hubbard model in the
species-major Jordan-Wigner ordering (all spin-up modes before all
spin-down modes): the up-hopping acts only on the up-occupation factor, the
down-hopping only on the down factor, and the U term is a diagonal product
``U sum_i n_i^up (x) n_i^dn``. The 4x4 half-filled sector (dim
C(16,8)^2 = 165,636,900, far beyond anything the reference attempts: its
anchor is 4x2, examples/trans_absent/latt_square/square_Fermi_Hubbard
.cc:113) then never materializes 1.66e8 basis labels at all: the state
vector IS a (12870, 12870) matrix ``psi`` and one H application is

    y = A psi + psi B^T + (a_diag (+) b_diag + scale * P) o psi

Two layouts, with the JAX package's names and meaning (``layout=``):

- ``"dense"``: ``A`` and ``B^T`` stored dense and applied with
  ``torch.matmul`` (true float32: TF32 is off, config.py), the epilogue as
  three in-place ``addcmul_`` on broadcast views, so the (na, nb) diagonal
  is never formed;
- ``"ell"``: only the factors' ELL rows are stored, slot-major with the
  count of live slots per row, in one of two forms (:func:`pack_slots`):
  compact, one int32 word a slot (the column in the low 16 bits, an index
  into the factor's table of distinct values in the high 16), for a float64
  engine whose factor's dim is at most 65,535 with at most 65,536 distinct
  values; else wide, int32 columns beside the values in the engine's dtype.
  The
  whole apply is :func:`kron_ell`: on a CUDA tensor the hand-written kernel
  ``csrc/kron_ell.cu`` (built with nvcc for sm_90a at first use), on a CPU
  tensor its plain version, which decodes the slots and follows the JAX
  package's loop slot by slot. There is no fallback between the two.

``layout=None`` takes the device's routing entry ``kron_dense_max_dim``
(config.ROUTING): dense when both factor dims are at or below it, ELL above.
On the CPU that is dense at every size, the JAX package's rule where float64
matrix products are trusted; on the H100 the factors of the 4x4 sector are
0.13% full, and the dense products cost 200-400 times the ELL apply's bound.
The JAX package kept the ELL layout for exact float64 on a TPU; the port
keeps it for speed.

Eigenvalues are basis-ordering independent, so results cross-check against
the site-major 'electron' encoding of the generic engines at 1e-8
(tests/test_torch_kron.py) and against the reference's 4x2 golden values.

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for
factorizable sectors. No analog exists in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.ops import cuda_build
from quantum_basis_tpu_torch.ops.compile import compile_diagonal
from quantum_basis_tpu_torch.ops.sparse import row_lengths

_SRC = cuda_build.CSRC / "kron_ell.cu"

# Kernel launches since the last reset, two per apply (the entry point
# launches kron_ell_a, then kron_ell_b); the CPU plain version is not
# counted: lets a run show that its applies went through the kernel.
launch_count = 0

_lib = None


def _ell_to_dense(ell, dtype) -> torch.Tensor:
    """Densify an EllMatrix's off-diagonal part on its device (once);
    accumulated in float64, then cast."""
    na = ell.n
    dense = torch.zeros((na, na), dtype=torch.float64, device=ell.device)
    if ell.width:
        rows = torch.arange(na, device=ell.device)[:, None].expand_as(ell.cols)
        # padding entries carry val 0.0 at col 0: harmless under add
        dense.index_put_((rows, ell.cols.long()),
                         ell.vals.to(torch.float64), accumulate=True)
    return dense.to(dtype)


# The compact slot form's limits: a 16-bit column and a 16-bit index into
# the table of values
COMPACT_MAX_DIM = 65535
COMPACT_MAX_VALUES = 65536


def pack_slots(cols, vals, n_cols: int, dtype, device):
    """An (n, W) ELL's columns and values in the kernel's slot-major form:
    (slots (W, n) int32, values, counts (n,) int32), on ``device``; a row's
    count is one past its last nonzero slot.

    Each row's live slots are reordered (:func:`_bank_order`) for the
    kernel's shared-memory banks. The form is chosen by type and shape:
    compact (``values`` 1-D) for float64 where ``n_cols`` is at most
    COMPACT_MAX_DIM and there are at most COMPACT_MAX_VALUES distinct
    values: each slot one word, column | index << 16, ``values`` the sorted
    table of the distinct values (padding's 0 included), each once; else
    wide (``values`` (W, n)), ``slots`` the int32 columns. The compact form
    takes 4 bytes a slot against 12 in float64, which took the kernel's
    apply at Hubbard 4x4 from 7.9 to 6.6 ms on an H100; in float32 (8 bytes
    a slot) it was no faster, so float32 is always wide."""
    cnt = row_lengths(vals).to(device)
    cols = cols.to(device=device, dtype=torch.int64)
    vals = vals.to(device=device, dtype=dtype)
    cols, vals = _bank_order(cols, vals, cnt)
    table, idx = torch.unique(vals, return_inverse=True)
    if (dtype != torch.float64 or n_cols > COMPACT_MAX_DIM
            or table.numel() > COMPACT_MAX_VALUES):
        return (cols.T.to(torch.int32).contiguous(), vals.T.contiguous(),
                cnt)
    words = cols | (idx << 16)
    # the unsigned word as the int32 of the same bits
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.T.to(torch.int32).contiguous(), table.contiguous(), cnt


# The kernel stages 16 bytes a source row, so that row j's values lie in
# bank group j % 8 of shared memory's 32 four-byte banks, and a warp's
# 16-byte loads run as four quarter-warps of 8 threads, one wavefront for each
# distinct row a bank group holds among them
_BANK_GROUPS = 8
_QUARTER_WARP = 8


def _bank_order(cols, vals, cnt):
    """(cols, vals) of an (n, W) ELL with each row's live slots [0, cnt)
    reordered, greedily, so that at each slot position the rows of each
    quarter-warp (8 consecutive rows, which the kernel's threads gather for
    together) fall in distinct bank groups where they can: fewer
    shared-memory wavefronts a gather. The sum of a row is unchanged up to
    rounding; padding stays in place."""
    n, W = cols.shape
    if n == 0 or W == 0:
        return cols, vals
    G, Q = -(-n // _QUARTER_WARP), _QUARTER_WARP
    pad = G * Q - n
    c = torch.nn.functional.pad(cols, (0, 0, 0, pad)).view(G, Q, W)
    k_cnt = torch.nn.functional.pad(cnt.long(), (0, pad)).view(G, Q)
    bank = c % _BANK_GROUPS
    slot = torch.arange(W, device=cols.device)
    free = slot < k_cnt[..., None]          # live slots not yet placed
    order = slot.expand(G, Q, W).clone()    # position k takes slot order[k]
    used = torch.zeros((G, _BANK_GROUPS), dtype=torch.long,
                       device=cols.device)
    g = torch.arange(G, device=cols.device)
    for k in range(int(k_cnt.max())):
        used.zero_()
        for r in range(Q):
            on = k < k_cnt[:, r]
            cost = used.gather(1, bank[:, r]) + (~free[:, r]) * (W + Q)
            j = torch.where(on, cost.argmin(1), k)
            order[g, r, k] = j
            free[g, r, j] &= ~on
            used[g, bank[g, r, j]] += on.long()
    order = order.view(G * Q, W)[:n]
    return cols.gather(1, order), vals.gather(1, order)


def is_compact(side) -> bool:
    """Whether a side's slots are in the compact form (a 1-D table)."""
    return side[1].dim() == 1


def decode_slots(side):
    """(columns (W, n) int64, values (W, n)) of a side in either form."""
    slots, values, _ = side
    if not is_compact(side):
        return slots.long(), values
    return (slots & 0xFFFF).long(), values[((slots >> 16) & 0xFFFF).long()]


def ell_arrays(ell, dtype, device, lo: int = 0, hi: int | None = None):
    """Rows [lo, hi) of an EllMatrix's off-diagonal part in the kernel's
    slot-major form (:func:`pack_slots`; its columns index the matrix's
    ``ell.n`` rows), on ``device``. Rows past the matrix are zero-count
    rows. A zero slot inside a row (there is none after the build's
    compaction) stays a harmless zero product."""
    hi = ell.n if hi is None else hi
    W, top = ell.width, min(hi, ell.n)
    cols = torch.zeros((hi - lo, W), dtype=torch.int64, device=device)
    vals = torch.zeros((hi - lo, W), dtype=ell.vals.dtype, device=device)
    if W and top > lo:
        cols[: top - lo] = ell.cols[lo:top].to(device)
        vals[: top - lo] = ell.vals[lo:top].to(device)
    return pack_slots(cols, vals, ell.n, dtype, device)


def kron_layout(na: int, nb: int, device) -> str:
    """The layout the device's routing table takes for factor dims na, nb:
    dense at or below ``kron_dense_max_dim``, else ELL."""
    bound = config.route("kron_dense_max_dim", device)
    return "dense" if max(na, nb) <= bound else "ell"


def _compact_coupling(P) -> np.ndarray:
    """Store the (na, nb) diagonal-coupling matrix small: int8 when its
    entries are small integers (occupation products), else float32. An int8
    or float32 matrix is taken as already stored."""
    P = np.asarray(P)
    if P.dtype in (np.int8, np.float32):
        return P
    rP = np.rint(P)
    if np.max(np.abs(P - rP)) < 1e-9 and np.max(np.abs(rP)) <= 127:
        return rP.astype(np.int8)
    return P.astype(np.float32)


# --------------------------------------------------------------------------
# The ELL apply: kernel wrapper and plain version
# --------------------------------------------------------------------------


def build_library(verbose: bool = False) -> ctypes.CDLL:
    """Compile ``csrc/kron_ell.cu`` (once per source content, into
    ``quantum_basis_tpu_torch/_build/``, ops/cuda_build.py) and load it.
    ``verbose`` prints nvcc's ptxas report when this call builds."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(_SRC, verbose)
        i, p = ctypes.c_int, ctypes.c_void_p
        side = [p, p, p, i]   # slots, values, counts, compact
        for name in ("qbt_kron_ell_f32", "qbt_kron_ell_f64"):
            fn = getattr(lib, name)
            fn.argtypes = side + side + [p, p, p, i, ctypes.c_double, p, p,
                                         p, p, i, i, i, p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _kron_ell_plain(A, B, adiag, bdiag, P, pscale, psi, psi_full):
    """Plain PyTorch version of :func:`kron_ell`: the slots decoded, then
    applied slot by slot as the JAX package's ELL layout applies them, each
    row's slots in their stored order (padded slots are zero products)."""
    (Ac, Av), (Bc, Bv) = decode_slots(A), decode_slots(B)
    y = torch.zeros_like(psi)
    for k in range(Ac.shape[0]):
        # row r of (A psi): sum_k Av[r,k] * psi_full[Ac[r,k], :]
        y += Av[k, :, None] * psi_full[Ac[k]]
    for k in range(Bc.shape[0]):
        # col c of (psi B^T): sum_k Bv[c,k] * psi[:, Bc[c,k]]
        y += Bv[k][None, :] * psi[:, Bc[k]]
    d = adiag[:, None] + bdiag[None, :]
    if P is not None:
        d = d + pscale * P.to(psi.dtype)
    return y + d * psi


def _check_cuda_args(A, B, adiag, bdiag, P, psi, psi_full):
    dev, dt = psi.device, psi.dtype
    if dt not in (torch.float32, torch.float64):
        raise TypeError(f"kron_ell takes float32 or float64, not {dt}")
    if psi.dim() != 2 or psi_full.dim() != 2 \
            or psi_full.shape[1] != psi.shape[1]:
        raise ValueError("psi must be (rows, nb) and psi_full (any, nb)")
    nr, nb = psi.shape
    for side, (slots, vals, cnt), n in (("A", A, nr), ("B", B, nb)):
        compact = vals.dim() == 1
        if (slots.dtype != torch.int32 or cnt.dtype != torch.int32
                or vals.dtype != dt or slots.dim() != 2
                or slots.shape[1] != n or tuple(cnt.shape) != (n,)
                or slots.numel() >= 1 << 31
                or (compact and (dt != torch.float64
                                 or vals.numel() > COMPACT_MAX_VALUES))
                or (not compact and tuple(vals.shape) != tuple(slots.shape))):
            raise ValueError(f"{side}: int32 slots (W, {n}) with {dt} "
                             "values of the same shape or (float64 only) a "
                             f"table of at most {COMPACT_MAX_VALUES}, and "
                             f"an int32 count ({n},)")
    named = [("A", t) for t in A] + [("B", t) for t in B] + [
        ("adiag", adiag), ("bdiag", bdiag), ("psi", psi),
        ("psi_full", psi_full)]
    if P is not None:
        named.append(("P", P))
        if P.dtype not in (torch.int8, torch.float32) \
                or tuple(P.shape) != (nr, nb):
            raise ValueError(f"P must be int8 or float32 ({nr}, {nb})")
    for name, t in named:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if tuple(adiag.shape) != (nr,) or tuple(bdiag.shape) != (nb,) \
            or adiag.dtype != dt or bdiag.dtype != dt:
        raise ValueError(f"adiag ({nr},) and bdiag ({nb},) must be {dt}")


def kron_ell(A, B, adiag, bdiag, P, pscale, psi, psi_full=None):
    """y = A psi_full + psi B^T + (adiag (+) bdiag + pscale P) o psi, for
    the caller's rows of psi.

    ``A``: (slots, values, counts) of A's ELL rows for psi's rows, slot
    major (W_A, rows) in either form of :func:`pack_slots`, whose columns
    index ``psi_full``'s rows (default ``psi``); ``B``: the same of B's
    (W_B, nb), indexing psi's columns; ``adiag`` (rows,), ``bdiag`` (nb,);
    ``P``: None or an int8 / float32 (rows, nb) coupling. CPU tensors take
    the plain version; CUDA tensors launch ``csrc/kron_ell.cu`` (or raise):
    two kernels, ``kron_ell_a`` (A psi_full, into scratch of psi's size)
    then ``kron_ell_b`` (the rest, and y), each counted in
    ``launch_count``.
    """
    global launch_count
    psi_full = psi if psi_full is None else psi_full
    if psi.device.type == "cpu":
        return _kron_ell_plain(A, B, adiag, bdiag, P, pscale, psi, psi_full)
    if psi.device.type != "cuda":
        raise ValueError(f"kron_ell: unsupported device {psi.device}")
    _check_cuda_args(A, B, adiag, bdiag, P, psi, psi_full)
    lib = build_library()
    fn = (lib.qbt_kron_ell_f32 if psi.dtype == torch.float32
          else lib.qbt_kron_ell_f64)
    y = torch.empty_like(psi)
    # scratch for pass 1's sums: nb x (rows rounded up to a 32-byte sector)
    sector = 32 // psi.element_size()
    z = torch.empty(psi.shape[1] * (-(-psi.shape[0] // sector) * sector),
                    dtype=psi.dtype, device=psi.device)
    sides = [a for side in (A, B)
             for a in (*(t.data_ptr() for t in side), int(is_compact(side)))]
    p_kind = 0 if P is None else (1 if P.dtype == torch.int8 else 2)
    with torch.cuda.device(psi.device):
        err = fn(*sides, adiag.data_ptr(), bdiag.data_ptr(),
                 None if P is None else P.data_ptr(), p_kind, float(pscale),
                 psi.data_ptr(), psi_full.data_ptr(), y.data_ptr(),
                 z.data_ptr(), psi.shape[0], psi_full.shape[0], psi.shape[1],
                 torch.cuda.current_stream(psi.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kron_ell kernel launch failed: cudaError {err}")
    if psi.numel():  # an empty psi launches nothing
        launch_count += 2
    return y


# --------------------------------------------------------------------------
# The engine
# --------------------------------------------------------------------------


def _bytes(*tensors) -> int:
    """Bytes of the distinct tensors among ``tensors`` (None skipped)."""
    seen = {}
    for t in tensors:
        if t is not None:
            seen[(t.data_ptr(), t.numel())] = t.numel() * t.element_size()
    return sum(seen.values())


class KronOp:
    """y = H x for H = A (x) I + I (x) B + diagonal couplings.

    ``A``/``B``: real :class:`~quantum_basis_tpu_torch.ops.sparse.EllMatrix`
    over the two factor bases, on one device (``B=None`` reuses ``A``;
    requires A symmetric, which holds for any real Hermitian factor).
    ``coupling``: optional (na, nb) array (the precomputed sum of diagonal
    outer products), multiplied by ``coupling_scale``. ``layout``:
    ``"dense"``, ``"ell"`` or None (the device's routing entry
    ``kron_dense_max_dim``); see the module docstring.

    Vectors are real tensors of length na*nb, row-major ``psi[r_a, c_b]``, in
    the engine's ``dtype``; the solver protocol (call, dtype, device,
    is_complex, mask) is every other engine's.
    """

    is_complex = False
    mask = None

    def __init__(self, A, B=None, coupling=None, coupling_scale: float = 1.0,
                 dtype=None, layout: str | None = None):
        if A.is_complex or (B is not None and B.is_complex):
            raise NotImplementedError("KronOp factors must be real")
        dtype = dtype or torch.float64
        nb = B.n if B is not None else A.n
        if layout is None:
            layout = kron_layout(A.n, nb, A.device)
        if layout == "dense":
            Aside = _ell_to_dense(A, dtype)
            if B is None:
                # cheap exact check at small sizes only
                if A.n * A.n <= (1 << 22) and not torch.equal(Aside,
                                                              Aside.T):
                    raise ValueError("B=None requires symmetric A")
                Bside = Aside  # psi @ A^T == psi @ A for symmetric A
            else:
                Bside = _ell_to_dense(B, dtype).T.contiguous()
        elif layout == "ell":
            Aside = ell_arrays(A, dtype, A.device)
            Bside = Aside if B is None else ell_arrays(B, dtype, A.device)
        else:
            raise ValueError(f"layout must be 'dense', 'ell' or None, not "
                             f"{layout!r}")
        P = None
        if coupling is not None:
            P = torch.as_tensor(_compact_coupling(coupling), device=A.device)
        # stored nonzeros of the assembled H (for nnz/s benchmarks)
        wB = B.width if B is not None else A.width
        self._install(layout, Aside, Bside, A.diag.to(dtype),
                      (B.diag if B is not None else A.diag).to(dtype), P,
                      float(coupling_scale) if coupling is not None else 0.0,
                      A.n * nb * (A.width + wB + 1))

    @classmethod
    def from_arrays(cls, A, B, adiag, bdiag, P, pscale, nnz_estimate=0,
                    layout: str = "dense"):
        """An engine from its parameter tensors. ``layout="dense"``: ``A``
        the dense A and ``B`` the dense B^T (may be ``A``); ``"ell"``: each
        a (columns, values) pair of the factor's (n, W) ELL (``B`` may be
        ``A``), stored slot-major (:func:`pack_slots`, the form chosen by
        type and shape) with the counts derived here."""
        if layout == "ell":
            def side(cv, n):
                cols, vals = cv
                # the kernel reads psi at these columns unchecked
                if cols.numel() and not (0 <= int(cols.min())
                                         and int(cols.max()) < n):
                    raise ValueError(f"ELL columns must lie in [0, {n})")
                return pack_slots(cols, vals, n, vals.dtype, vals.device)

            Aside = side(A, adiag.shape[0])
            B = Aside if B is A else side(B, bdiag.shape[0])
            A = Aside
        elif layout != "dense":
            raise ValueError(f"layout must be 'dense' or 'ell', not "
                             f"{layout!r}")
        op = cls.__new__(cls)
        op._install(layout, A, B, adiag, bdiag, P, float(pscale),
                    nnz_estimate)
        return op

    def _install(self, layout, Aside, Bside, adiag, bdiag, P, pscale,
                 nnz_estimate):
        self.layout = layout
        ell = layout == "ell"
        self._Ad, self._Bt = (None, None) if ell else (Aside, Bside)
        self._Aell, self._Bell = (Aside, Bside) if ell else (None, None)
        self._adiag, self._bdiag = adiag, bdiag
        self._P, self._pscale = P, pscale
        self.dtype = adiag.dtype
        self.device = adiag.device
        self.na, self.nb = int(adiag.shape[0]), int(bdiag.shape[0])
        self.N = self.n = self.na * self.nb
        self.nnz_estimate = int(nnz_estimate)
        self.n_applies = 0

    @property
    def resident_bytes(self) -> int:
        """Device bytes the engine holds (shared tensors counted once)."""
        sides = (self._Aell or ()) + (self._Bell or ())
        return _bytes(self._Ad, self._Bt, *sides, self._adiag, self._bdiag,
                      self._P)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            raise NotImplementedError("KronOp is a real engine")
        psi = x.to(self.dtype).view(self.na, self.nb)
        if self.layout == "ell":
            y = kron_ell(self._Aell, self._Bell, self._adiag, self._bdiag,
                         self._P, self._pscale, psi)
        else:
            y = self._Ad @ psi
            y.addmm_(psi, self._Bt)
            # (a (+) b + s P) o psi, accumulated without forming the diagonal
            y.addcmul_(self._adiag[:, None], psi)
            y.addcmul_(self._bdiag[None, :], psi)
            if self._P is not None:
                y.addcmul_(self._P, psi, value=self._pscale)
        self.n_applies += 1
        return y.view(-1)


def diagonal_product_coupling(space_a, labels_a, space_b, labels_b, pairs):
    """P = sum_m u_m (x) w_m for diagonal operator pairs (op_a, op_b).

    Each op is an all-diagonal Mopr on its factor space; u_m/w_m are its
    per-basis-state values. Returns the dense (na, nb) coupling matrix
    (host numpy, computed as one (na, M) @ (M, nb) product). For the Hubbard
    U term the pairs are (n_i^up, n_i^dn) per site and P[r, c] is the number
    of doubly occupied sites: integer-valued, stored int8 downstream.
    """
    Va = space_a.decode(np.asarray(labels_a, dtype=np.int64))
    Vb = space_b.decode(np.asarray(labels_b, dtype=np.int64))
    U = np.empty((len(labels_a), len(pairs)), dtype=np.float64)
    W = np.empty((len(pairs), len(labels_b)), dtype=np.float64)
    for m, (op_a, op_b) in enumerate(pairs):
        U[:, m] = compile_diagonal(op_a, space_a)(Va)
        W[m, :] = compile_diagonal(op_b, space_b)(Vb)
    return U @ W
