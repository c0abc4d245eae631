"""Full-label-space matrix-free apply: Hamiltonian terms as masked rolls.

Port of ``quantum_basis_tpu.ops.apply_fullspace``. Vectors live over the
ENTIRE mixed-radix label space and every off-diagonal image class is

    y += roll(amp(label) * jw_sign(label) * x, delta)

where ``delta`` is the CONSTANT label displacement of that image class
(ladder-structured operators displace every source state by the same
per-class stride offset), ``amp`` is a per-joint-column value read from the
label's digits, and the Jordan-Wigner sign is the parity of a bit mask of the
label. No gathers over matrix entries and no basis lookup.

What differs from the JAX engine, which recomputes the label arithmetic of
every pass inside each apply and leaves the fusion to XLA: eager PyTorch
would spend some ten launches and as many label-space temporaries per pass.
Here each pass keeps ONE coefficient array ``amp * jw_sign`` over the label
space, built once at construction (:class:`RollPasses`): int8 in {0, +1, -1}
with a scalar magnitude when all amplitudes of the pass are real and of one
magnitude (every ladder term: spin flips, hops), else float64/complex128.
An apply is then two in-place ``addcmul_`` on shifted slices per pass and
makes no label-space temporary. The price is memory: one byte per label and
pass (48 passes over 2^24 labels for the L=24 chain: 0.8 GB; 96 for the
24-site kagome cluster: 1.6 GB), eight or sixteen for a general pass.

Trade-off of the engine itself: vectors are label_space long instead of
sector-dim long (6.2x for the L=24 Sz=0 chain). Sector states stay exactly
in-sector (H conserves the quantum numbers and out-of-sector amplitudes
start and remain zero); random solver restarts are projected by the sector
mask.

Supported when (a) label_space fits int32 and memory, (b) every slot crossed
by a Jordan-Wigner string has a power-of-2 local dimension whose fermion
count is popcount-compatible mod 2 (spin-1/2, spinless fermion, electron).
``supports_fullspace`` reports this; callers fall back to the ELL /
row-gather engines otherwise (e.g. t-J, d=3). Float64 only; the float32 tier
is the window-contraction engine (ops/apply_contract.py), which also takes
over as the f64 engine wherever it applies.

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for full
sectors; there is no analog in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.compile import CompiledOperator

_AMP_TOL = 1e-14
_BUILD_CHUNK = 1 << 22  # labels per chunk when building label-space arrays


def _popcount_ok(space, w: np.ndarray) -> bool:
    """Can the JW parity for weight vector w be a label popcount?"""
    F = space.fermion_count_table
    for s in np.nonzero(w)[0]:
        d = int(space.dims[s])
        if d & (d - 1):
            return False  # non-power-of-2 digit occupies a bit range unevenly
        for v in range(d):
            if (int(F[s][v]) - int(bin(v).count("1"))) % 2 != 0:
                return False
    return True


def supports_fullspace(compiled: CompiledOperator,
                       max_label_space: int = 1 << 27) -> bool:
    space = compiled.space
    if int(space.label_space) > max_label_space:
        return False
    for g in compiled.groups:
        for t in range(g.n_terms):
            if np.any(g.W[t]) and not _popcount_ok(space, g.W[t]):
                return False
    return True


def _bit_shift_of_stride(stride: int) -> int | None:
    return int(stride).bit_length() - 1 if stride & (stride - 1) == 0 else None


def _digit(lab: torch.Tensor, stride: int, d: int) -> torch.Tensor:
    """Digit of the slot at ``stride`` with local dimension ``d`` (int32)."""
    sh = _bit_shift_of_stride(stride)
    if sh is not None and d & (d - 1) == 0:
        return (lab >> sh) & (d - 1)
    return (lab // stride) % d


def _parity(v: torch.Tensor) -> torch.Tensor:
    """Popcount of a non-negative int32 tensor, mod 2. PyTorch has no
    population-count operator: xor-fold the word onto its lowest bit."""
    for sh in (16, 8, 4, 2, 1):
        v = v ^ (v >> sh)
    return v & 1


def build_over_labels(N: int, dtype, device, fn) -> torch.Tensor:
    """out[lab] = fn(lab) over the whole label space, built on the device in
    chunks of int32 labels, so the temporaries of ``fn`` stay chunk-sized."""
    out = torch.empty(N, dtype=dtype, device=device)
    for start in range(0, N, _BUILD_CHUNK):
        stop = min(start + _BUILD_CHUNK, N)
        lab = torch.arange(start, stop, dtype=torch.int32, device=device)
        out[start:stop] = fn(lab)
    return out


def jw_wmask(space, w: np.ndarray) -> int:
    """Bit mask of the label bits a popcount-compatible JW string reads."""
    if np.any(w) and not _popcount_ok(space, w):
        raise ValueError("JW string not popcount-compatible; "
                         "use the ELL / row-gather engines")
    wmask = 0
    for s in np.nonzero(w)[0]:
        d = int(space.dims[s])
        bits = d.bit_length() - 1
        sh = _bit_shift_of_stride(int(space.strides[s]))
        # power-of-2 dims on a mixed-radix space may still sit at
        # non-power-of-2 strides; then popcount masking fails
        if sh is None:
            raise ValueError("JW slot at non-power-of-2 stride")
        wmask |= ((1 << bits) - 1) << sh
    return wmask


class RollPasses:
    """The masked-roll passes of an engine, one coefficient array per pass.

    ``passes``: [(delta, slots, jstr, col (D,) complex, wmask, dims)], the
    JAX engine's representation. ``strides``: the label strides of all
    slots. :meth:`add_to` accumulates sum_p roll(coef_p * x, delta_p) into y
    in place.
    """

    def __init__(self, passes, strides, N: int, dtype, device):
        self.N = int(N)
        self.is_complex = any(np.max(np.abs(p[3].imag)) > _AMP_TOL
                              for p in passes)
        cdtype = (torch.complex64 if dtype == torch.float32
                  else torch.complex128)
        self._coefs = []  # (delta mod N, coefficient array, scalar factor)
        for dl, slots, jstr, col, wmask, dims in passes:
            nz = np.nonzero(np.abs(col) > _AMP_TOL)[0]
            vals = col[nz]
            real = np.max(np.abs(vals.imag), initial=0.0) <= _AMP_TOL
            mag = float(np.abs(vals[0].real)) if nz.size else 0.0
            compact = bool(real and nz.size and np.all(
                np.abs(np.abs(vals.real) - mag) <= _AMP_TOL * max(mag, 1.0)))
            if compact:
                lut_np = np.zeros(col.shape[0], dtype=np.int8)
                lut_np[nz] = np.sign(vals.real).astype(np.int8)
                out_dt, scale = torch.int8, mag
            else:
                lut_np = np.where(np.abs(col) > _AMP_TOL, col, 0.0)
                lut_np = lut_np.real if real else lut_np
                out_dt, scale = (dtype if real else cdtype), 1.0
            lut = torch.as_tensor(lut_np, device=device).to(out_dt)

            def coef(lab, slots=slots, jstr=jstr, dims=dims, wmask=wmask,
                     lut=lut):
                c = torch.zeros_like(lab)
                for i, s in enumerate(slots):
                    c += _digit(lab, int(strides[int(s)]),
                                int(dims[i])) * int(jstr[i])
                a = lut[c.long()]
                if wmask:
                    a = a * (1 - 2 * _parity(lab & int(wmask))).to(a.dtype)
                return a

            self._coefs.append((int(dl) % self.N,
                                build_over_labels(self.N, out_dt, device,
                                                  coef), scale))

    def __len__(self):
        return len(self._coefs)

    def add_to(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """y += sum_p roll(coef_p * x, delta_p), in place; y must be complex
        when a coefficient or x is."""
        N = self.N
        for d, c, a in self._coefs:
            if d == 0:
                y.addcmul_(c, x, value=a)
            else:
                y[d:].addcmul_(c[:N - d], x[:N - d], value=a)
                y[:d].addcmul_(c[N - d:], x[N - d:], value=a)
        return y


def sector_mask(N: int, labels: torch.Tensor, dtype) -> torch.Tensor:
    """0/1 indicator of the sector labels over the label space."""
    return torch.zeros(N, dtype=dtype, device=labels.device).index_fill_(
        0, labels, 1.0)


class FullSpaceOp:
    """y = H x over the full label space, float64 (complex128 vectors when H
    or x is complex).

    ``sector_labels`` (optional) builds the 0/1 sector mask used to project
    solver-injected random vectors and to convert to/from sector coordinates.
    """

    def __init__(self, compiled: CompiledOperator, sector_labels=None,
                 device="cuda"):
        space = compiled.space
        self.space = space
        self.compiled = compiled
        self.device = torch.device(device)
        self.dtype = torch.float64
        N = int(space.label_space)
        if N > (1 << 31) - 1:
            raise ValueError("label space exceeds int32 range")
        self.N = N
        self.n = N  # solver-facing dimension

        # ---- compile passes: (delta, slots, jstr, amp_col (D,), wmask, dims)
        passes = []
        for g in compiled.groups:
            T, D, K = g.dlt.shape
            for t in range(T):
                slots = g.slots[t]
                dims = [int(space.dims[s]) for s in slots]
                wmask = jw_wmask(space, g.W[t])
                amp = g.amp_re[t] + (1j * g.amp_im[t]
                                     if g.amp_im is not None else 0.0)
                deltas = {}
                for c in range(D):
                    for k in range(K):
                        a = amp[c, k]
                        if abs(a) <= _AMP_TOL:
                            continue
                        col = deltas.setdefault(
                            int(g.dlt[t, c, k]),
                            np.zeros(D, dtype=np.complex128))
                        col[c] += a
                for dl, col in deltas.items():
                    passes.append((dl, np.asarray(slots, np.int64),
                                   np.asarray(g.jstrides[t], np.int64), col,
                                   wmask, np.asarray(dims, np.int64)))
        self._rolls = RollPasses(passes, space.strides, N, self.dtype,
                                 self.device)
        self.is_complex = self._rolls.is_complex

        # ---- full-space diagonal, built once on the device
        if compiled.diag_terms.q_zero():
            self.diag_full = torch.zeros(N, dtype=self.dtype,
                                         device=self.device)
        else:
            self.diag_full = build_over_labels(
                N, self.dtype, self.device,
                _diag_elementwise(compiled.diag_terms, space))

        # ---- sector mask + coordinates
        self.sector_labels = None
        self.mask = None
        if sector_labels is not None:
            self.sector_labels = torch.as_tensor(
                np.asarray(sector_labels, dtype=np.int64), device=self.device)
            self.mask = sector_mask(N, self.sector_labels, self.dtype)
        self.n_applies = 0

    @property
    def n_passes(self) -> int:
        return len(self._rolls)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_complex or x.is_complex():
            x = x.to(torch.complex128)
        else:
            x = x.to(torch.float64)
        self.n_applies += 1
        return self._rolls.add_to(self.diag_full * x, x)

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


def _to_full(op, x_sector: torch.Tensor) -> torch.Tensor:
    if op.sector_labels is None:
        raise ValueError("the engine was built without sector labels")
    dt = op.dtype
    if x_sector.is_complex():
        dt = torch.complex64 if dt == torch.float32 else torch.complex128
    return torch.zeros(op.N, dtype=dt, device=op.device).index_copy_(
        0, op.sector_labels, x_sector.to(device=op.device, dtype=dt))


def _nnz_estimate(op) -> int:
    rows = op.N if op.sector_labels is None else int(op.sector_labels.numel())
    return rows * (1 + op.compiled.nnz_per_row)


def _diag_elementwise(diag_terms, space):
    """Elementwise diagonal evaluator label -> sum of per-term products
    (float64).

    Unlike compile_diagonal (which consumes decoded V), this reads digits
    straight out of the label iota so the (label_space,) diagonal can be
    built on the device without materializing V for the whole space.
    """
    terms = []
    const = 0.0
    for t in diag_terms.terms:
        if t.q_identity():
            const += float(np.real(t.coeff))
            continue
        slots = [space.slot(f.site, f.orbital) for f in t.factors]
        # diag fast-path terms are real by construction (compile_operator)
        tabs = [np.asarray(f.mat).real.astype(np.float64) for f in t.factors]
        terms.append((float(np.real(t.coeff)), slots, tabs))

    def evaluate(lab):
        out = torch.full(lab.shape, const, dtype=torch.float64,
                         device=lab.device)
        for coeff, slots, tabs in terms:
            prod = None
            for s, tab in zip(slots, tabs):
                tab = np.where(np.abs(tab) > _AMP_TOL, tab, 0.0)
                dig = _digit(lab, int(space.strides[s]), int(space.dims[s]))
                val = torch.as_tensor(tab, device=lab.device)[dig.long()]
                prod = val if prod is None else prod * val
            out.add_(prod, alpha=coeff)
        return out

    return evaluate
