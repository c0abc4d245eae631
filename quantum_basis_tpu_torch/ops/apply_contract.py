"""Full-label-space apply as dense window contractions (batched matmuls).

Port of ``quantum_basis_tpu.ops.apply_contract``, the successor of the
masked-roll engine in :mod:`quantum_basis_tpu_torch.ops.apply_fullspace`.
The state vector over the full mixed-radix label space IS the state tensor
``(d_{S-1}, ..., d_1, d_0)``; every off-diagonal Hamiltonian term is a small
dense matrix acting on a few tensor axes. Terms are grouped into contiguous
slot WINDOWS of joint dimension <= ``max_window``; each window's terms sum
into one dense G (Dw x Dw) matrix and the whole group applies as ONE batched
matmul, accumulated into y in place:

    y.view(hi, Dw, lo) += G @ x.view(hi, Dw, lo)[a]      for every a

Terms whose slot span exceeds a window (lattice wrap/PBC bonds) are caught by
a second FRAME: the same vector with its slot order rotated (one (Q, P)
transpose), where wrap terms become mid-range and window-assignable. Two-slot
terms that fit no frame become pair windows (one 5-axis einsum); anything
still left (rare) falls back to the roll engine's masked-roll pass. The
diagonal stays one elementwise pass with an array built once from the labels.

Supports any mixed-radix site dimension (the joint matrices are exact: no
popcount constraint for window terms, unlike the roll engine) and both
working precisions: float32 for the mixed-precision Krylov bulk, float64 for
the exact stage. TF32 is off (config.py), so a float32 window product is a
true float32 matmul.

The planning half (``_Window``, ``ContractPlan``, ``supports_contract``,
``_pair_G``, ``_term_roll_passes``) is host numpy, carried over unchanged so
that the plan equals the JAX package's. What the device half leaves behind:
split (re, im) arithmetic (a real G on a complex x acts on
``view_as_real(x)``, which folds the pair into the ``lo`` axis; a complex G
is one complex tensor), and XLA's optimization barriers (eager PyTorch
neither batches the windows nor hoists index math).

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for full
sectors. No analog exists in the reference: this is the quantum-circuit-
simulator formulation of SpMV.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply_fullspace import (
    RollPasses,
    _diag_elementwise,
    _digit,
    _nnz_estimate,
    _popcount_ok,
    _to_full,
    build_over_labels,
    jw_wmask,
    sector_mask,
)
from quantum_basis_tpu_torch.ops.compile import CompiledOperator

_AMP_TOL = 1e-14


# --------------------------------------------------------------------------
# Planning: assign terms to (frame, window) or roll fallback
# --------------------------------------------------------------------------


class _Window:
    """Contiguous slot-position range [a, b) in one frame."""

    def __init__(self, frame: int, a: int, b: int, dims_f):
        self.frame = frame
        self.a = a
        self.b = b
        self.wdims = [int(dims_f[p]) for p in range(a, b)]
        self.D = int(np.prod(self.wdims, dtype=np.int64))
        self.terms = []  # indices into compiled.term_matrices

    def __repr__(self):  # pragma: no cover - debug aid
        return f"Window(f{self.frame}, [{self.a},{self.b}), D={self.D})"


class ContractPlan:
    """Host-side plan: windows per frame + leftover roll terms."""

    def __init__(self, compiled: CompiledOperator, max_window: int = 1024,
                 min_lo: int = 128, max_frames: int = 4):
        space = compiled.space
        S = space.n_slots
        self.space = space
        self.compiled = compiled
        self.windows: list[_Window] = []
        self.roll_terms: list[int] = []
        self.rotations: list[int] = []

        terms = compiled.term_matrices
        # window assignment uses the SUPPORT span only: a Jordan-Wigner
        # string outside the window factorizes into an elementwise sign on
        # the source label (constant along the window axis), applied as
        # y += G (sign * x) — so even an all-slot JW string (t-J wrap hop)
        # does not force a giant window
        involved_sets = [sorted(set(slots))
                         for (slots, dims, jstr, M, w) in terms]

        def span(i, r):
            pos = sorted(((s - r) % S) for s in involved_sets[i])
            return pos[0], pos[-1]

        assigned = [False] * len(terms)

        def run_frame(f, r):
            dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]

            def fits(a, b):
                return int(np.prod(dims_f[a:b], dtype=np.int64)) <= max_window

            made = False
            while True:
                todo = [i for i in range(len(terms)) if not assigned[i]
                        and fits(span(i, r)[0], span(i, r)[1] + 1)]
                if not todo:
                    break
                anchor = min(todo, key=lambda i: span(i, r)[0])
                a = span(anchor, r)[0]
                a_end = span(anchor, r)[1] + 1
                # pull the start down so the batch 'lo' axis is either 1 or
                # wide enough to make a well-shaped matmul column count —
                # but never so far that the anchor term no longer fits
                while a > 0:
                    lo = int(np.prod(dims_f[:a], dtype=np.int64))
                    if lo >= min_lo or not fits(a - 1, a_end):
                        break
                    a -= 1
                b = a + 1
                while b < S and fits(a, b + 1):
                    b += 1
                win = _Window(f, a, b, dims_f)
                for i in todo:
                    pmin, pmax = span(i, r)
                    if a <= pmin and pmax < b:
                        win.terms.append(i)
                        assigned[i] = True
                if not win.terms:
                    # the first todo term cannot fit a window from `a`
                    # (capacity eaten by the lo pull-down); give up on it
                    i0 = min(todo, key=lambda i: span(i, r)[0])
                    assigned[i0] = True
                    self.roll_terms.append(i0)
                    continue
                self.windows.append(win)
                made = True
            return made

        # frame 0 = identity, then adaptive rotations chosen so leftover
        # terms (lattice wrap bonds) become window-assignable. Candidate
        # rotations are scored by how many leftovers they absorb, with a
        # BALANCE tiebreak towards square-ish frame transposes
        # x.reshape(Q, P).T; it is kept so that the plan equals the JAX
        # package's plan for the same operator.
        self.rotations.append(0)
        run_frame(0, 0)
        while (len(self.rotations) < max_frames
               and not all(assigned)):
            leftover = [i for i in range(len(terms)) if not assigned[i]]
            best = None  # (coverage, -imbalance, r)
            for r in range(1, S):
                if r in self.rotations:
                    continue
                dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]

                def rfits(a, b):
                    return int(np.prod(dims_f[a:b],
                                       dtype=np.int64)) <= max_window

                cov = sum(1 for i in leftover
                          if rfits(span(i, r)[0], span(i, r)[1] + 1))
                if cov == 0:
                    continue
                P = float(np.prod([float(space.dims[s]) for s in range(r)]))
                Q = float(int(space.label_space) / P)
                imbalance = abs(np.log2(max(P, 1.0)) - np.log2(max(Q, 1.0)))
                cand = (cov, -imbalance, r)
                if best is None or cand > best:
                    best = cand
            if best is None:
                break
            r = best[2]
            f = len(self.rotations)
            self.rotations.append(r)
            if not run_frame(f, r):
                self.rotations.pop()
                break
        self.roll_terms.extend(i for i in range(len(terms)) if not assigned[i])
        # frames that ended up with windows (frame transposes are paid
        # only for these)
        used = sorted({w.frame for w in self.windows})
        self.frames = [(f, self.rotations[f]) for f in used]

    # ---------------------------------------------------------------- G build

    def w_out(self, win: _Window, ti: int) -> np.ndarray:
        """The term's JW weights restricted to slots OUTSIDE the window —
        the elementwise sign prefactor's support."""
        space = self.space
        S = space.n_slots
        r = self.rotations[win.frame]
        _, _, _, _, w = self.compiled.term_matrices[ti]
        out = w.copy()
        for s in np.nonzero(w)[0]:
            p = (int(s) - r) % S
            if win.a <= p < win.b:
                out[s] = 0
        return out

    def window_G(self, win: _Window, term_indices) -> np.ndarray:
        """Dense window matrix G[w', w] summing the given terms, with
        intra-window Jordan-Wigner signs applied exactly from the fermion
        count tables (cf. the reference's per-state fermion scan,
        src/basis.cc:2650-2664 — here evaluated once at plan time).
        Out-of-window JW weights are NOT included — the engine multiplies
        the source vector by their elementwise sign instead."""
        space = self.space
        S = space.n_slots
        r = self.rotations[win.frame]
        Dw = win.D
        nw = win.b - win.a
        wdims = np.asarray(win.wdims, dtype=np.int64)
        wstr = np.ones(nw, dtype=np.int64)
        for i in range(1, nw):
            wstr[i] = wstr[i - 1] * wdims[i - 1]
        wcols = np.arange(Dw, dtype=np.int64)
        wdigits = (wcols[:, None] // wstr[None, :]) % wdims[None, :]
        F = space.fermion_count_table

        G = np.zeros((Dw, Dw), dtype=np.complex128)
        for ti in term_indices:
            slots, dims, jstr, M, w = self.compiled.term_matrices[ti]
            pos = [((s - r) % S) - win.a for s in slots]
            # JW sign from weight-slots inside the window
            jw_exp = np.zeros(Dw, dtype=np.int64)
            for s in np.nonzero(w)[0]:
                p = ((int(s) - r) % S) - win.a
                if not (0 <= p < nw):
                    continue  # outside: handled by the elementwise prefactor
                jw_exp += F[int(s)][wdigits[:, p]]
            sgn = np.where(jw_exp % 2 == 0, 1.0, -1.0)
            # joint column index of each window column for this term
            c_of_w = np.zeros(Dw, dtype=np.int64)
            for i, p in enumerate(pos):
                c_of_w += wdigits[:, p] * int(jstr[i])
            rr, cc = np.nonzero(np.abs(M) > _AMP_TOL)
            dims_a = np.asarray(dims, dtype=np.int64)
            for rj, cj in zip(rr, cc):
                rdig = (int(rj) // jstr) % dims_a
                cdig = (int(cj) // jstr) % dims_a
                off = int(np.sum((rdig - cdig) * wstr[pos]))
                sel = c_of_w == int(cj)
                src = wcols[sel]
                G[src + off, src] += M[rj, cj] * sgn[sel]
        return G

    def describe(self) -> str:
        lines = [f"frames: {[r for _, r in self.frames]}"]
        for w in self.windows:
            lines.append(f"  f{w.frame} slots[{w.a}:{w.b}) D={w.D} "
                         f"terms={len(w.terms)}")
        lines.append(f"  roll fallback terms: {len(self.roll_terms)}")
        return "\n".join(lines)


def supports_contract(compiled: CompiledOperator,
                      max_label_space: int = 1 << 27,
                      max_window: int = 1024) -> bool:
    """True when the window engine fully covers this operator: label space
    small enough and every leftover (roll-fallback) term popcount-safe."""
    space = compiled.space
    if int(space.label_space) > max_label_space:
        return False
    if not compiled.term_matrices and compiled.groups:
        return False  # compiled before term_matrices existed
    plan = ContractPlan(compiled, max_window=max_window)
    for ti in plan.roll_terms:
        slots, _, _, _, w = compiled.term_matrices[ti]
        if len(set(int(s) for s in slots)) == 2:
            continue  # pair-window path: no popcount constraint
        if np.any(w) and not _popcount_ok(space, w):
            return False
    return True

# --------------------------------------------------------------------------
# Device engine
# --------------------------------------------------------------------------


def _complex_of(dtype):
    return torch.complex64 if dtype == torch.float32 else torch.complex128


def _g_tensor(G: np.ndarray, dtype, device) -> torch.Tensor:
    """A window matrix on the device: real unless it has an imaginary part."""
    if np.max(np.abs(G.imag)) > _AMP_TOL:
        return torch.as_tensor(G, device=device).to(_complex_of(dtype))
    return torch.as_tensor(G.real, device=device).to(dtype)


class ContractOp:
    """y = H x over the full label space via window contractions.

    Same protocol as :class:`FullSpaceOp` (call, mask, to_full, to_sector,
    nnz_estimate, dtype, device, is_complex); ``dtype`` is float32 by default
    (the mixed-precision Krylov bulk) or float64 (the exact stage).
    """

    def __init__(self, compiled: CompiledOperator, sector_labels=None,
                 dtype=None, max_window: int = 1024, device="cuda"):
        space = compiled.space
        self.space = space
        self.compiled = compiled
        dtype = dtype or torch.float32
        device = torch.device(device)
        N = int(space.label_space)
        if N > (1 << 31) - 1:
            raise ValueError("label space exceeds int32 range")

        plan = ContractPlan(compiled, max_window=max_window)
        self.plan = plan

        # ---- window tensors: (frame, hi, D, lo, G, sidx). Terms sharing a
        # window but differing in their OUT-of-window JW weights get
        # separate G's; sidx points at the elementwise sign prefactor array
        # for y += G (sign * x) (None = no prefactor)
        S = space.n_slots
        wins, signs, sign_idx = [], [], {}

        def sign_index(frame, w_arr):
            if not w_arr.any():
                return None
            skey = (frame, w_arr.astype(np.int8).tobytes())
            if skey not in sign_idx:
                sign_idx[skey] = len(signs)
                signs.append(self._build_sign(frame, w_arr, N, dtype, device))
            return sign_idx[skey]

        for win in plan.windows:
            r = plan.rotations[win.frame]
            dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]
            lo = int(np.prod(dims_f[:win.a], dtype=np.int64))
            hi = int(np.prod(dims_f[win.b:], dtype=np.int64))
            by_wout = {}
            for ti in win.terms:
                by_wout.setdefault(plan.w_out(win, ti).tobytes(), []).append(ti)
            for wkey, tis in by_wout.items():
                G = _g_tensor(plan.window_G(win, tis), dtype, device)
                sidx = sign_index(win.frame, np.frombuffer(wkey, dtype=np.int8))
                wins.append((win.frame, hi, win.D, lo, G, sidx))

        # ---- frame transpose shapes: rotated label = m*Q + q
        frame_shape = {}
        for f, r in plan.frames:
            if r == 0:
                continue
            P = int(np.prod([int(space.dims[s]) for s in range(r)],
                            dtype=np.int64))
            frame_shape[f] = (N // P, P)  # (Q, P)

        # ---- pair windows: 2-slot terms too far apart for any contiguous
        # window in any frame (e.g. the x-wrap bonds of a 2xL lattice, whose
        # two slots sit more than a window apart around the label circle in
        # every rotation). Applied as ONE 5-axis einsum over
        # x.reshape(A, d_hi, M, d_lo, L): no label-derived index arrays.
        pairs, leftover = [], []
        for ti in plan.roll_terms:
            slots, dims, jstr, M, w = compiled.term_matrices[ti]
            sup = sorted(set(int(s) for s in slots))
            if len(sup) != 2:
                leftover.append(ti)
                continue
            s_lo, s_hi = sup
            d_lo, d_hi = int(space.dims[s_lo]), int(space.dims[s_hi])
            L = int(space.strides[s_lo])
            Mmid = int(space.strides[s_hi]) // (L * d_lo)
            A = N // (int(space.strides[s_hi]) * d_hi)
            # joint G over (hi, lo) with intra-support JW; out-of-support
            # JW becomes an elementwise sign prefactor exactly as windows do
            w_in = w.copy()
            w_out = w.copy()
            for s in np.nonzero(w)[0]:
                (w_out if int(s) in sup else w_in)[s] = 0
            G = _g_tensor(_pair_G(space, slots, dims, jstr, M, w_in, s_lo,
                                  s_hi), dtype, device)
            pairs.append((A, d_hi, Mmid, d_lo, L, G, sign_index(0, w_out)))

        # ---- roll-fallback passes (same math as the roll engine)
        passes = []
        for ti in leftover:
            slots, dims, jstr, M, w = compiled.term_matrices[ti]
            passes.extend(_term_roll_passes(space, slots, dims, jstr, M, w))

        # ---- diagonal (elementwise from the labels)
        if compiled.diag_terms.q_zero():
            diag = torch.zeros(N, dtype=dtype, device=device)
        else:
            diag = build_over_labels(
                N, torch.float64, device,
                _diag_elementwise(compiled.diag_terms, space)).to(dtype)

        labels = None
        if sector_labels is not None:
            labels = torch.as_tensor(np.asarray(sector_labels, dtype=np.int64),
                                     device=device)
        self._install(N, dtype, device, wins, frame_shape, pairs, signs, diag,
                      RollPasses(passes, space.strides, N, dtype, device),
                      labels, None)

    @classmethod
    def from_arrays(cls, N, dtype, device, wins, frame_shape, pairs, signs,
                    diag, mask=None, sector_labels=None, passes=(),
                    strides=None):
        """An engine from its parameters alone (no compiled operator):
        ``wins`` [(frame, hi, D, lo, G, sidx)], ``frame_shape`` {frame:
        (Q, P)}, ``pairs`` [(A, d_hi, Mmid, d_lo, L, G, sidx)], the sign
        prefactors, the diagonal, the sector mask and, where there are
        roll-fallback passes, their tuples and the label strides."""
        op = cls.__new__(cls)
        op.space = op.compiled = op.plan = None
        device = torch.device(device)
        op._install(int(N), dtype, device, list(wins), dict(frame_shape),
                    list(pairs), list(signs), diag,
                    RollPasses(passes, strides, int(N), dtype, device),
                    sector_labels, mask)
        return op

    def _install(self, N, dtype, device, wins, frame_shape, pairs, signs,
                 diag, rolls, sector_labels, mask):
        self.N = self.n = N
        self.dtype = dtype
        self.device = device
        self._wins = wins
        self._frame_shape = frame_shape
        self._pairs = pairs
        self._signs = signs
        self.diag_full = diag
        self._rolls = rolls
        self.is_complex = bool(
            rolls.is_complex or any(w[4].is_complex() for w in wins)
            or any(p[5].is_complex() for p in pairs))
        self.sector_labels = sector_labels
        if mask is None and sector_labels is not None:
            mask = sector_mask(N, sector_labels, dtype)
        self.mask = mask
        self.n_applies = 0

    def _build_sign(self, frame, w_arr, N, dtype, device):
        """Elementwise JW prefactor over FRAME-ordered labels: the product
        of (-1)^{F_s(digit_s)} over the weight slots, built once on the
        device. Works for any local dimension (no popcount constraint: this
        is how t-J/Kondo wrap hops become window terms)."""
        space = self.space
        S = space.n_slots
        r = self.plan.rotations[frame]
        dims_f = [int(space.dims[(p + r) % S]) for p in range(S)]
        fstr = np.ones(S, dtype=np.int64)
        for p in range(1, S):
            fstr[p] = fstr[p - 1] * dims_f[p - 1]
        F = space.fermion_count_table
        slots = np.nonzero(w_arr)[0]

        def build(lab):
            expo = torch.zeros_like(lab)
            for s in slots:
                d = int(space.dims[s])
                odd = torch.as_tensor(F[s][:d] % 2, dtype=torch.int32,
                                      device=device)
                expo ^= odd[_digit(lab, int(fstr[(int(s) - r) % S]),
                                   d).long()]
            return (1 - 2 * expo).to(dtype)

        return build_over_labels(N, dtype, device, build)

    # ---------------------------------------------------------------- apply

    @staticmethod
    def _as_real(G, v):
        """A real G acts on a complex vector through its (re, im) pairs:
        the trailing axis of ``view_as_real`` joins the innermost one."""
        return torch.view_as_real(v) if v.is_complex() and not G.is_complex() \
            else v

    def _window(self, acc, x, hi, D, lo, G):
        """acc.view(hi, D, lo) += G @ x.view(hi, D, lo)[a] for every a, in
        place (one addmm when lo == 1, else one batched matmul with the
        batch stride of G zero)."""
        a, v = self._as_real(G, acc), self._as_real(G, x)
        lo = lo * (v.numel() // x.numel())
        if lo == 1:
            a.view(hi, D).addmm_(v.view(hi, D), G.T)
        else:
            a.view(hi, D, lo).baddbmm_(G.expand(hi, D, D), v.view(hi, D, lo))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cplx = self.is_complex or x.is_complex()
        x = x.to(_complex_of(self.dtype) if cplx else self.dtype)
        signs = self._signs
        y = self.diag_full * x

        for f in sorted({w[0] for w in self._wins}):
            if f == 0:
                xf, acc = x, y
            else:
                Q, P = self._frame_shape[f]
                xf = x.view(Q, P).T.contiguous().view(-1)
                acc = torch.zeros_like(xf)
            for (wf, hi, D, lo, G, sidx) in self._wins:
                if wf == f:
                    self._window(acc, xf if sidx is None else signs[sidx] * xf,
                                 hi, D, lo, G)
            if f != 0:
                y.view(Q, P).add_(acc.view(P, Q).T)

        for (A, d_hi, Mmid, d_lo, L, G, sidx) in self._pairs:
            sx = x if sidx is None else signs[sidx] * x
            G = G.to(x.dtype) if cplx else G
            y += torch.einsum("abmcl,BCbc->aBmCl",
                              sx.view(A, d_hi, Mmid, d_lo, L), G).reshape(-1)

        self._rolls.add_to(y, x)
        self.n_applies += 1
        return y

    # ------------------------------------------------------ sector interop

    def to_full(self, x_sector: torch.Tensor) -> torch.Tensor:
        """Sector-coordinate vector -> full-space vector (device scatter)."""
        return _to_full(self, x_sector)

    def to_sector(self, x_full: torch.Tensor) -> torch.Tensor:
        """Full-space vector -> sector coordinates (device gather)."""
        return x_full[self.sector_labels]

    @property
    def nnz_estimate(self) -> int:
        return _nnz_estimate(self)


# --------------------------------------------------------------------------
# Pair windows and the roll-pass fallback (shared math with
# ops/apply_fullspace.py)
# --------------------------------------------------------------------------


def _pair_G(space, slots, dims, jstr, M, w_in, s_lo, s_hi):
    """Dense (d_hi, d_lo, d_hi, d_lo) tensor G[B, C, b, c] for a term whose
    support is exactly the two slots {s_lo, s_hi}, including intra-support
    Jordan-Wigner signs from the fermion count tables (same sign convention
    as :meth:`ContractPlan.window_G`)."""
    d_lo, d_hi = int(space.dims[s_lo]), int(space.dims[s_hi])
    dims_a = np.asarray(dims, dtype=np.int64)
    F = space.fermion_count_table
    G = np.zeros((d_hi, d_lo, d_hi, d_lo), dtype=np.complex128)
    rr, cc = np.nonzero(np.abs(M) > _AMP_TOL)
    for rj, cj in zip(rr, cc):
        rdig = (int(rj) // jstr) % dims_a
        cdig = (int(cj) // jstr) % dims_a
        r_lo = r_hi = c_lo = c_hi = 0
        for i, s in enumerate(slots):
            if int(s) == s_lo:
                r_lo, c_lo = int(rdig[i]), int(cdig[i])
            else:
                r_hi, c_hi = int(rdig[i]), int(cdig[i])
        sgn = 1.0
        for s in np.nonzero(w_in)[0]:
            v = c_lo if int(s) == s_lo else c_hi
            if int(F[int(s)][v]) % 2:
                sgn = -sgn
        G[r_hi, r_lo, c_hi, c_lo] += M[rj, cj] * sgn
    return G


def _term_roll_passes(space, slots, dims, jstr, M, w):
    """Delta-class passes for one term: [(dlt, slots, jstr, col, wmask, dims)]
    — the roll engine's representation, built from the exact joint matrix."""
    wmask = jw_wmask(space, w)

    D = M.shape[0]
    dims_a = np.asarray(dims, dtype=np.int64)
    gstr = np.asarray([space.strides[s] for s in slots], dtype=np.int64)
    deltas = {}
    for rj, cj in zip(*np.nonzero(np.abs(M) > _AMP_TOL)):
        rdig = (int(rj) // jstr) % dims_a
        cdig = (int(cj) // jstr) % dims_a
        dl = int(np.sum((rdig - cdig) * gstr))
        col = deltas.setdefault(dl, np.zeros(D, dtype=np.complex128))
        col[int(cj)] += M[rj, cj]
    return [(dl, np.asarray(slots, np.int64), np.asarray(jstr, np.int64),
             col, wmask, dims_a.copy()) for dl, col in deltas.items()]
