"""Compile a symbolic Mopr into static device term tables.

Port of ``quantum_basis_tpu.ops.compile`` (numpy host code; only the
diagonal evaluator also takes torch tensors). It replaces the reference's
on-the-fly operator
application ``oprXphi`` (reference: src/basis.cc:2585-2840) and the loops of
``model::MultMv2`` (src/model.cc:941-1121). Instead of walking a byte-packed
state and branching per operator, every Hamiltonian term is compiled ONCE
(host side, numpy) into dense lookup tables over the term's *joint local
space*; application on device is then pure gathers + elementwise math +
one small matmul for all fermionic signs at once.

For a term ``coeff * f_1 f_2 ... f_k`` with support slots s_1 < ... < s_k
(joint dimension D = prod d_i):

- ``amp[c, k]``, ``dlt[c, k]``: for input joint column c, the k-th nonzero
  output — its amplitude (including *intra-support* Jordan-Wigner signs,
  simulated exactly at compile time) and its label displacement
  ``sum_i (r_i - c_i) * stride(s_i)``;
- ``w[s]``: the term's Jordan-Wigner weight vector over non-support slots —
  applying the term to a state |v> carries the extra sign
  ``(-1) ** sum_s w[s] * F_s(v_s)``, where F is the per-slot fermion-count
  table. For a whole batch this is ONE int matmul ``(F_batch @ W.T) % 2``,
  replacing the reference's per-state fermion scan (src/basis.cc:2650-2664).

Terms with identical (support, w) are merged by summing joint matrices; the
result is grouped by arity so the device apply is a short static loop.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

from quantum_basis_tpu_torch.config import opr_precision, sparse_precision
from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.ops.operators import Mopr, OprProd


# --------------------------------------------------------------------------
# Host-side evaluation of diagonal operators (quantum-number filters, Hdiag)
# --------------------------------------------------------------------------


def compile_diagonal(mopr: Mopr, space: StateSpace):
    """Compile an all-diagonal Mopr into per-term gather tables.

    Returns a function ``f(V) -> values`` mapping decoded slot values
    (..., S) to the (real) diagonal expectation per state; works with numpy
    or torch inputs. Used for conserved-quantity sector filters (reference:
    src/basis.cc:1063-1076) and for the diagonal part of H.
    """
    if not mopr.q_diagonal():
        raise ValueError("compile_diagonal requires an all-diagonal operator")
    terms = []
    const = 0.0 + 0.0j
    for t in mopr.terms:
        if t.q_identity():
            const += complex(t.coeff)
            continue
        slots = np.asarray(t.slots(space), dtype=np.int64)
        diags = [f.mat for f in t.factors]  # each 1-d complex
        terms.append((complex(t.coeff), slots, diags))

    def evaluate(V):
        if isinstance(V, np.ndarray):
            def table(d):
                return d.real
            out = np.full(V.shape[:-1], const.real, dtype=np.float64)
        else:
            import torch

            def table(d):
                return torch.as_tensor(d.real, dtype=torch.float64,
                                       device=V.device)
            V = V.long()
            out = torch.full(V.shape[:-1], const.real, dtype=torch.float64,
                             device=V.device)
        for coeff, slots, diags in terms:
            prod = coeff.real
            for s, d in zip(slots, diags):
                if np.max(np.abs(d.imag)) > opr_precision:
                    raise ValueError("complex diagonal in real evaluation path")
                prod = prod * table(d)[V[..., s]]
            out = out + prod
        return out

    return evaluate


def compile_diagonal_complex(mopr: Mopr, space: StateSpace):
    """Complex host-side variant of :func:`compile_diagonal`.

    Needed for diagonal operators with complex coefficients (e.g. the
    phase-weighted B_q = sum_r e^{i q.r} Sz_r used in vrnl/Wannier
    measurements, reference src/model.cc:2024-2027 diagonal branch).
    Returns ``f(V) -> complex128 ndarray`` (numpy, host path).
    """
    if not mopr.q_diagonal():
        raise ValueError("compile_diagonal_complex requires a diagonal operator")
    terms = []
    const = 0.0 + 0.0j
    for t in mopr.terms:
        if t.q_identity():
            const += complex(t.coeff)
            continue
        slots = np.asarray(t.slots(space), dtype=np.int64)
        diags = [np.asarray(f.mat, dtype=np.complex128) for f in t.factors]
        terms.append((complex(t.coeff), slots, diags))

    def evaluate(V):
        V = np.asarray(V)
        out = np.full(V.shape[:-1], const, dtype=np.complex128)
        for coeff, slots, diags in terms:
            prod = np.full(V.shape[:-1], coeff, dtype=np.complex128)
            for s, d in zip(slots, diags):
                prod = prod * d[V[..., s]]
            out = out + prod
        return out

    return evaluate


# --------------------------------------------------------------------------
# Off-diagonal term compilation
# --------------------------------------------------------------------------


def _joint_matrix(term: OprProd, space: StateSpace):
    """Exact joint-space matrix of a product term, with intra-support JW signs.

    Returns (slots ascending, M) where M[r, c] acts on the mixed-radix joint
    index over the support slots (slot s_1 least significant).
    """
    slots = list(term.slots(space))
    dims = [int(space.dims[s]) for s in slots]
    D = int(np.prod(dims, dtype=np.int64))
    F = space.fermion_count_table  # (S, dmax)

    jstr = np.ones(len(slots), dtype=np.int64)
    for i in range(1, len(slots)):
        jstr[i] = jstr[i - 1] * dims[i - 1]

    # joint digit decomposition of all D columns: digits[c, i]
    cols = np.arange(D, dtype=np.int64)
    digits = (cols[:, None] // jstr[None, :]) % np.asarray(dims)[None, :]

    # operator = f_1 f_2 ... f_k with f_k applied first:
    # M = E(f_1) @ E(f_2) @ ... @ E(f_k), each E the single-slot embedding
    # E[r, c] = mat[r_i, c_i] * delta(other digits) * JW(column state)
    M = np.eye(D, dtype=np.complex128) * complex(term.coeff)
    for f in reversed(term.factors):  # rightmost factor applies first
        i = slots.index(space.slot(f.site, f.orbital))
        mat = f.dense()
        E = np.zeros((D, D), dtype=np.complex128)
        if f.fermion:
            below = np.zeros(D, dtype=np.int64)
            for ip in range(i):
                below += F[slots[ip]][digits[:, ip]]
            jw = np.where(below % 2 == 0, 1.0, -1.0)
        else:
            jw = np.ones(D)
        for c in range(D):
            ci = digits[c, i]
            for r_i in range(dims[i]):
                if abs(mat[r_i, ci]) < opr_precision:
                    continue
                r = c + (r_i - ci) * jstr[i]
                E[r, c] = mat[r_i, ci] * jw[c]
        M = E @ M
    return slots, dims, jstr, digits, M


def _jw_weights(term: OprProd, space: StateSpace) -> np.ndarray:
    """w[s] = (# fermionic factors at slots > s) mod 2, zeroed on support."""
    S = space.n_slots
    w = np.zeros(S, dtype=np.int8)
    support = set(term.slots(space))
    for f in term.factors:
        if not f.fermion:
            continue
        sf = space.slot(f.site, f.orbital)
        for s in range(sf):
            if s not in support:
                w[s] ^= 1
    return w


@dataclass
class TermGroup:
    """A batch of same-arity compiled terms, padded to common table shapes.

    Device apply consumes these arrays directly:
      slots    (T, k)    int32 — support slot indices
      jstrides (T, k)    int64 — joint-column strides
      dlt      (T, D, K) int64 — label displacement per (term, column, image)
      amp_re   (T, D, K) f64   — Re amplitude (0 padding = inert image)
      amp_im   (T, D, K) f64 or None (all-real group)
      W        (T, S)    int8  — JW weight vectors
    """

    arity: int
    slots: np.ndarray
    jstrides: np.ndarray
    dlt: np.ndarray
    amp_re: np.ndarray
    amp_im: np.ndarray | None
    W: np.ndarray
    max_images: int = field(init=False)

    def __post_init__(self):
        self.max_images = self.dlt.shape[-1]

    @property
    def n_terms(self):
        return self.slots.shape[0]


@dataclass
class CompiledOperator:
    """A Mopr compiled against a StateSpace: diagonal + grouped off-diagonal.

    ``nnz_per_row`` bounds the number of off-diagonal images per basis state
    (used for ELL sparse sizing and benchmarks).
    """

    space: StateSpace
    diag_terms: Mopr
    groups: list
    hermitian_pairing: bool
    nnz_per_row: int
    # exact merged off-diagonal term matrices [(slots, dims, jstr, M, w)],
    # kept for engines that need the full joint matrix (window contraction)
    term_matrices: list = field(default_factory=list)

    def has_offdiag(self) -> bool:
        return bool(self.groups)


def compile_operator(mopr: Mopr, space: StateSpace) -> CompiledOperator:
    """Split a Mopr into diagonal part + padded off-diagonal term groups.

    Mirrors the diagonal/off-diagonal split of ``model::add_Ham``
    (reference: src/model.cc:113-143), then compiles and merges terms.
    """
    def _real_diag(t):
        """Diagonal, non-fermionic, and fully real — eligible for the real
        diagonal fast path. Complex-coefficient diagonals (e.g. the Sz_q
        terms of a structure-factor operator) go through the general term
        tables instead, which carry split-complex amplitudes."""
        if not t.q_diagonal() or any(f.fermion for f in t.factors):
            return False
        if abs(np.imag(t.coeff)) > opr_precision:
            return False
        return all(np.max(np.abs(np.imag(f.mat))) <= opr_precision
                   for f in t.factors)

    diag = Mopr()
    offdiag_terms = []
    for t in mopr.terms:
        if _real_diag(t):
            diag += t
        else:
            offdiag_terms.append(t)

    # compile each term, merging identical (support, w)
    merged = {}  # (slots tuple, w bytes) -> [slots, dims, jstr, digits, M, w]
    for t in offdiag_terms:
        slots, dims, jstr, digits, M = _joint_matrix(t, space)
        w = _jw_weights(t, space)
        key = (tuple(slots), w.tobytes())
        if key in merged:
            merged[key][4] = merged[key][4] + M
        else:
            merged[key] = [slots, dims, jstr, digits, M, w]

    # pull diagonal parts out of merged joint matrices: the diagonal of a
    # joint matrix contributes only when w == 0 (no external JW string);
    # with w != 0 keep it in the off-diagonal tables (delta = 0 entries).
    by_arity = {}
    term_matrices = []
    for slots, dims, jstr, digits, M, w in merged.values():
        D = M.shape[0]
        if not np.any(w):
            dvals = np.diagonal(M).copy()
            if (np.max(np.abs(dvals)) > sparse_precision
                    and np.max(np.abs(dvals.imag)) <= 1e-12):
                # real joint diagonal: fold into the diag fast path;
                # complex diagonals stay in the term tables (dlt = 0)
                diag += _joint_diag_term(slots, dims, dvals.real, space)
                np.fill_diagonal(M, 0.0)
        mask = np.abs(M) > sparse_precision
        if not mask.any():
            continue
        term_matrices.append((list(slots), list(dims), jstr.copy(), M, w))
        K = int(mask.sum(axis=0).max())  # nonzero rows per column
        amp = np.zeros((D, K), dtype=np.complex128)
        dlt = np.zeros((D, K), dtype=np.int64)
        gstr = np.asarray([space.strides[s] for s in slots], dtype=np.int64)
        for c in range(D):
            rows = np.nonzero(mask[:, c])[0]
            for k, r in enumerate(rows):
                amp[c, k] = M[r, c]
                rdig = (r // jstr) % np.asarray(dims)
                dlt[c, k] = int(np.sum((rdig - digits[c]) * gstr))
        by_arity.setdefault(len(slots), []).append(
            (np.asarray(slots, np.int32), jstr, amp, dlt, w, D, K)
        )

    groups = []
    nnz = 0
    for arity, items in sorted(by_arity.items()):
        T = len(items)
        Dmax = max(item[5] for item in items)
        Kmax = max(item[6] for item in items)
        slots_a = np.zeros((T, arity), np.int32)
        jstr_a = np.ones((T, arity), np.int64)
        amp_a = np.zeros((T, Dmax, Kmax), np.complex128)
        dlt_a = np.zeros((T, Dmax, Kmax), np.int64)
        W_a = np.zeros((T, space.n_slots), np.int8)
        for ti, (slots, jstr, amp, dlt, w, D, K) in enumerate(items):
            slots_a[ti] = slots
            jstr_a[ti] = jstr
            amp_a[ti, :D, :K] = amp
            dlt_a[ti, :D, :K] = dlt
            W_a[ti] = w
        nnz += T * Kmax
        has_im = np.max(np.abs(amp_a.imag)) > opr_precision
        groups.append(
            TermGroup(
                arity=arity,
                slots=slots_a,
                jstrides=jstr_a,
                dlt=dlt_a,
                amp_re=np.ascontiguousarray(amp_a.real),
                amp_im=np.ascontiguousarray(amp_a.imag) if has_im else None,
                W=W_a,
            )
        )

    return CompiledOperator(
        space=space,
        diag_terms=diag,
        groups=groups,
        hermitian_pairing=True,
        nnz_per_row=nnz,
        term_matrices=term_matrices,
    )


def _joint_diag_term(slots, dims, dvals, space: StateSpace):
    """Wrap a joint diagonal (over several slots) back into a Mopr term chain.

    Decomposes dvals (length prod(dims)) into a sum of products of
    single-slot diagonals is unnecessary — we instead return a Mopr with a
    single OprProd whose factors are per-slot *indicator* diagonals only when
    the joint diagonal factorizes; otherwise we expand into indicator sums.
    """
    from quantum_basis_tpu_torch.ops.operators import Opr, OprProd, Mopr

    D = int(np.prod(dims, dtype=np.int64))
    assert dvals.shape == (D,)
    jstr = np.ones(len(slots), dtype=np.int64)
    for i in range(1, len(slots)):
        jstr[i] = jstr[i - 1] * dims[i - 1]
    out = Mopr()
    # Expand over joint columns grouped by value — worst case D indicator
    # products; D is tiny (<= d^k for k<=3), so this is cheap and exact.
    for c in range(D):
        if abs(dvals[c]) < sparse_precision:
            continue
        digs = (c // jstr) % np.asarray(dims)
        factors = []
        for i, s in enumerate(slots):
            orb = int(space.slot_orbital[s])
            site = int(space.slot_site[s])
            d_loc = int(space.dims[s])
            ind = np.zeros(d_loc, dtype=np.complex128)
            ind[digs[i]] = 1.0
            factors.append(Opr(site, orb, False, ind))
        out += OprProd(dvals[c], factors)
    return out


def operator_fingerprint(compiled: CompiledOperator) -> int:
    """Content CRC32 of a compiled operator's term tables.

    Folded into solver stage-checkpoint keys so a stale ``out_Qckpt/`` from
    a run with DIFFERENT couplings (but the same sector dim) is ignored
    instead of silently returned — the same re-validation discipline the
    reference applies to cached eigenvector files
    (src/model.cc:2163-2187), extended to every solve-stage record. The
    value equals the JAX package's on the same model, so that checkpoint keys
    and records are interchangeable between the packages.
    """
    fp = zlib.crc32(repr([g.arity for g in compiled.groups]).encode())
    for g in compiled.groups:
        for arr in (g.slots, g.jstrides, g.dlt, g.amp_re, g.amp_im, g.W):
            if arr is not None:
                fp = zlib.crc32(np.ascontiguousarray(arr).tobytes(), fp)
    for t in compiled.diag_terms.terms:
        fp = zlib.crc32(np.ascontiguousarray(
            np.atleast_1d(np.complex128(t.coeff))).tobytes(), fp)
        fp = zlib.crc32(np.ascontiguousarray(
            t.slots(compiled.space)).tobytes(), fp)
        for f in t.factors:
            fp = zlib.crc32(np.ascontiguousarray(f.mat).tobytes(), fp)
    return fp & 0xFFFFFFFF
