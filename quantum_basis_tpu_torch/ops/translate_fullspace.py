"""Lattice translations of full-label-space vectors as block transposes.

Port of ``quantum_basis_tpu.ops.translate_fullspace``: the momentum-sector
machinery of the full-label-space engines (``ContractOp``, ``FullSpaceOp``).
Instead of building the representative basis and paying gather-bound lookups
per Hamiltonian image (the ELL repr path, cf. generate_Ham_sparse_repr / repr
MultMv2, reference src/model.cc:687-836, 1040-1104), each momentum sector is
solved IN THE FULL LABEL SPACE with the fast engine, and Lanczos is kept
inside the sector with the projector

    P_k = (1/G) sum_R e^{+i k.R} T(R).

The label-space vector is the state tensor ``(d_{S-1}, ..., d_0)``, and with
the lattice's mixed-radix site numbering a rigid translation by r units along
lattice dimension ``dim`` is a cyclic shift of a contiguous digit group: on
the flat vector, a block transpose ``(A, P, Q, B) -> (A, Q, P, B)`` with P =
d**(r * w) the wrapped top part (w = sites per unit step), once per
combination of higher site digits and per orbital block. All these
transposes act on disjoint digit groups, so one translation is ONE
permutation of digit-group axes: a single ``reshape``, ``permute`` and copy
(the JAX package chains one transpose per group and lets XLA fuse them; eager
PyTorch would copy the vector once per link). No gathers, no index tables.
The projector factorizes over dimensions (e^{ik.R} is separable), so P_k
costs sum_d (L_d - 1) translations instead of prod_d L_d, each accumulated
in place into one buffer.

Fermionic boundary signs: the cyclic shift moves the wrapped block of sites
past the rest, so the permutation parity on a product state is ``n_P * n_Q``
per independent site block (n_P = fermions wrapped, n_Q = fermions passed
over): an elementwise sign per (dim, shift), built once on the device from
the labels and kept as int8 (replacing the reference's bubble-sort swap
counting, src/basis.cc:598-609).

Eigenvector interop: a normalized full-space eigenvector |psi> in sector k
expands over the repr basis |r,k> = P_k|r>/sqrt(nu_r) with coefficients
c_r = <r,k|psi> = psi[r]/sqrt(nu_r): one small gather at the representative
labels (``ReprBasis.from_full``).

Vectors are native complex tensors for every momentum (k = 0 too), as the JAX
package forces the complex structure for every k: start vectors, matvec
counts and ``is_complex`` then agree between the packages. Tilted clusters
have no mixed-radix numbering and fall back to the ELL path.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.apply_fullspace import (
    _bit_shift_of_stride,
    _digit,
    _parity,
    build_over_labels,
)
from quantum_basis_tpu_torch.utils.codec import radix_decode, radix_encode

_MAX_PERMUTE_DIMS = 24  # a CUDA copy indexes at most 25 axes
_SELF_CHECK_MAX_N = 1 << 22


def _digit_layout(lattice):
    """Site-index digits fastest -> slowest: list of (kind, base) where kind
    is a lattice dimension index or 'sub'. None when the lattice does not
    use the plain mixed-radix numbering (e.g. tilted clusters)."""
    if not hasattr(lattice, "_base") or not hasattr(lattice, "_dim_arr"):
        return None
    if type(lattice).__name__ == "TiltedLattice":
        return None
    base = [int(b) for b in lattice._base]
    if lattice._sub_pos == 0:
        kinds = ["sub"] + list(lattice._dim_arr)
    else:
        kinds = list(lattice._dim_arr) + ["sub"]
    return list(zip(kinds, base))


class RollTranslations:
    """Translations of full-space vectors as one axis permutation each.

    Raises ValueError when unsupported; use :meth:`supported` to probe.
    """

    def __init__(self, space, lattice, device="cuda"):
        layout = _digit_layout(lattice)
        if layout is None:
            raise ValueError("lattice site numbering is not plain mixed-radix")
        self.space = space
        self.lattice = lattice
        self.layout = layout
        self.device = torch.device(device)
        n_latt = int(lattice.Nsites)

        # orbital blocks: contiguous slot ranges, uniform local dim, one slot
        # per lattice site (the StateSpace layout guarantees the first two)
        self.blocks = []  # (s0, n_sites, d_local)
        s0 = 0
        for sb, n_sites in space.orbitals:
            if n_sites != n_latt:
                raise ValueError("orbital does not cover every lattice site")
            self.blocks.append((s0, n_sites, int(sb.dim_local)))
            s0 += n_sites
        self.N = int(space.label_space)
        if self.N > (1 << 31) - 1:
            raise ValueError("label space exceeds int32 range")

        # per lattice dim: digit position + sites per unit step
        self._dim_info = {}
        below = 1
        for pos, (kind, b) in enumerate(layout):
            if kind != "sub":
                self._dim_info[int(kind)] = (pos, below, b)
            below *= b

        self._spec_table = None  # {(d, r): specs} of an engine from arrays
        self._sign_cache = {}    # (d, r) -> int8 sign over source labels
        self._sign_dst_cache = {}
        self._perm_cache = {}
        self._self_check()

    @classmethod
    def from_specs(cls, N: int, specs: dict, signs: dict, device):
        """Translations from their block-transpose specs alone: ``specs``
        {(dim, shift): [(A, P, Q, B), ...]}, ``signs`` {(dim, shift): +-1
        array over all labels} for the fermionic shifts."""
        self = cls.__new__(cls)
        self.space = self.lattice = self.layout = None
        self.device = torch.device(device)
        self.N = int(N)
        self.blocks, self._dim_info = [], {}
        self._spec_table = {(int(d), int(r)): [tuple(int(v) for v in s)
                                               for s in sp]
                            for (d, r), sp in specs.items()}
        self._sign_cache = {
            (int(d), int(r)): torch.as_tensor(
                np.asarray(s), device=self.device).to(torch.int8)
            for (d, r), s in signs.items()}
        self._sign_dst_cache = {}
        self._perm_cache = {}
        return self

    # ----------------------------------------------------------- validation

    @staticmethod
    def supported(space, lattice) -> bool:
        try:
            RollTranslations(space, lattice, device="cpu")
            return True
        except (ValueError, KeyError):
            return False

    def _self_check(self, n_probe: int = 256):
        """Verify the transpose map against the lattice permutation oracle
        (space.transform over translation_plan) on random labels, for a unit
        shift along every pbc dimension. Cheap and load-bearing: it pins the
        digit-layout assumptions to the actual site numbering. Skipped above
        2^22 labels (the layout is size-independent, so small-system
        coverage transfers)."""
        if self.N > _SELF_CHECK_MAX_N:
            return
        rng = np.random.default_rng(7)
        probes = np.unique(rng.integers(0, self.N, size=min(n_probe, self.N),
                                        dtype=np.int64))
        vals = np.arange(1.0, probes.size + 1)
        for d in self.lattice.trans_dims:
            if int(self.lattice.L[d]) < 2:
                continue
            disp = np.zeros(self.lattice.dim, dtype=np.int64)
            disp[d] = 1
            plan = self.lattice.translation_plan(disp)
            new_labels, parity = self.space.transform(probes, plan)
            x = torch.zeros(self.N, dtype=torch.float64, device=self.device)
            x[torch.as_tensor(probes, device=self.device)] = torch.as_tensor(
                vals, device=self.device)
            sgn = self.sign(d, 1)
            y = self.translate(x * sgn if sgn is not None else x, d, 1)
            want = vals * np.where(parity % 2 == 0, 1.0, -1.0)
            got = y[torch.as_tensor(new_labels, device=self.device)]
            if not np.allclose(got.cpu().numpy(), want):
                raise ValueError(
                    f"translation self-check failed along dim {d}")

    # ----------------------------------------------------------- transposes

    def _specs(self, d: int, r: int):
        """Block-transpose specs (A, P, Q, B) for shift r along dim d: one
        per (orbital block, higher-digit combination). Each stands for
        ``swapaxes(x.reshape(A, P, Q, B), 1, 2)``."""
        if self._spec_table is not None:
            return self._spec_table[(int(d), int(r))]
        _, w, L = self._dim_info[int(d)]
        r = int(r) % L
        specs = []
        for (s0, n_sites, dl) in self.blocks:
            below_blk = 1
            for s in range(s0):
                below_blk *= int(self.space.dims[s])
            above_blk = 1
            for s in range(s0 + n_sites, self.space.n_slots):
                above_blk *= int(self.space.dims[s])
            grp_sites = L * w
            n_hi = n_sites // grp_sites
            grp = dl ** grp_sites
            P = dl ** (r * w)
            Q = grp // P
            for h in range(n_hi):
                B = below_blk * (grp ** h)
                A = above_blk * (grp ** (n_hi - 1 - h))
                specs.append((A, P, Q, B))
        return specs

    def _perms(self, d: int, r: int):
        """Shift r along dim d as a list of (shape, axis permutation): the
        block transposes of :meth:`_specs` act on disjoint digit groups, so
        as many as fit ``_MAX_PERMUTE_DIMS`` axes merge into ONE permute and
        copy (all of them, for every lattice met so far)."""
        key = (int(d), int(r))
        if key not in self._perm_cache:
            specs = sorted((s for s in self._specs(d, r)
                            if s[1] > 1 and s[2] > 1), key=lambda s: -s[3])
            out, chunk = [], []
            for spec in specs:
                if self._chunk_perm(chunk + [spec]) is None:
                    out.append(self._chunk_perm(chunk))
                    chunk = []
                chunk.append(spec)
            if chunk:
                out.append(self._chunk_perm(chunk))
            if any(p is None for p in out):
                raise ValueError(f"digit groups of shift {key} do not nest")
            self._perm_cache[key] = out
        return self._perm_cache[key]

    def _chunk_perm(self, specs):
        """(shape, perm) swapping (P, Q) of each spec (sorted slowest group
        first) in one permute; None when the groups do not nest or need more
        than ``_MAX_PERMUTE_DIMS`` axes."""
        shape, perm = [], []
        above = 1  # product of the axes emitted so far
        for A, P, Q, B in specs:
            if A % above or A * P * Q * B != self.N:
                return None
            if A // above > 1:  # untouched digits above this group
                perm.append(len(shape))
                shape.append(A // above)
            perm += [len(shape) + 1, len(shape)]
            shape += [P, Q]
            above = A * P * Q
        if self.N // above > 1:
            perm.append(len(shape))
            shape.append(self.N // above)
        if len(shape) > max(_MAX_PERMUTE_DIMS, 4):
            return None
        return shape, perm

    def translate(self, x: torch.Tensor, d: int, r: int) -> torch.Tensor:
        """T_r along dim d applied to a flat vector: a new tensor (x itself
        for a trivial shift). Signs are NOT folded in: multiply by
        :meth:`sign` first, or the result by :meth:`sign_dst`."""
        if self._spec_table is None:
            r = int(r) % self._dim_info[int(d)][2]
        if r == 0:
            return x
        for shape, perm in self._perms(d, r):
            x = x.reshape(shape).permute(perm).contiguous()
        return x.view(-1)

    def translate_disp(self, x: torch.Tensor, disp) -> torch.Tensor:
        """Composite translation by an integer displacement vector."""
        for d in range(self.lattice.dim):
            r = int(disp[d]) % int(self.lattice.L[d])
            if r:
                x = self.translate(x, d, r)
        return x

    # ------------------------------------------------------------ signs

    def _slots_parity(self, lab, slots):
        """Fermion parity (0/1, int32) of the given slots of int32 labels.
        Two-state slots at power-of-two strides whose upper state is the
        fermion fold into one masked word parity; the others go through
        their per-slot table."""
        space = self.space
        F = space.fermion_count_table
        wmask, par = 0, torch.zeros_like(lab)
        for s in slots:
            dl, stride = int(space.dims[s]), int(space.strides[s])
            odd = (F[s, :dl] % 2).astype(np.int32)
            sh = _bit_shift_of_stride(stride)
            if dl == 2 and sh is not None and odd.tolist() == [0, 1]:
                wmask |= 1 << sh
            else:
                lut = torch.as_tensor(odd, device=lab.device)
                par = par ^ lut[_digit(lab, stride, dl).long()]
        if wmask:
            par = par ^ _parity(lab & wmask)
        return par

    def sign(self, d: int, r: int):
        """Elementwise fermionic boundary sign for shift r along dim d, int8
        (+1/-1) over all SOURCE labels: T_r x = translate(sign * x). None
        when non-fermionic or the shift is trivial. Built on the device in
        label chunks; cached."""
        if self._spec_table is not None:
            return self._sign_cache.get((int(d), int(r)))
        if not self.space.fermionic:
            return None
        pos, w, L = self._dim_info[int(d)]
        r = int(r) % L
        if r == 0:
            return None
        key = (int(d), r)
        if key in self._sign_cache:
            return self._sign_cache[key]

        space = self.space
        base = np.asarray([b for _, b in self.layout], dtype=np.int64)
        sites = np.arange(self.lattice.Nsites, dtype=np.int64)
        digits = radix_decode(sites, base)
        hi = digits[:, pos + 1:]
        hi_key = (radix_encode(hi, base[pos + 1:])
                  if hi.shape[1] else np.zeros(sites.size, dtype=np.int64))
        wrapped = digits[:, pos] >= (L - r)
        F = space.fermion_count_table

        # per independent site block: (slots wrapped, slots passed over)
        groups = []
        for (s0, n_sites, dl) in self.blocks:
            for a in np.unique(hi_key):
                slots_p, slots_q = [], []
                for site in sites[hi_key == a]:
                    s = s0 + int(site)
                    if not np.any(F[s, : int(space.dims[s])] % 2):
                        continue
                    (slots_p if wrapped[site] else slots_q).append(s)
                if slots_p and slots_q:
                    groups.append((slots_p, slots_q))

        def fn(lab):
            bit = torch.zeros_like(lab)
            for slots_p, slots_q in groups:
                bit ^= (self._slots_parity(lab, slots_p)
                        & self._slots_parity(lab, slots_q))
            return (1 - 2 * bit).to(torch.int8)

        out = build_over_labels(self.N, torch.int8, self.device, fn)
        self._sign_cache[key] = out
        return out

    def sign_dst(self, d: int, r: int):
        """The same sign over DESTINATION labels: T_r x = sign_dst *
        translate(x), which lets a caller fold the sign into its
        accumulation instead of making a signed copy of x first."""
        key = (int(d), int(r))
        if key not in self._sign_dst_cache:
            s = self.sign(d, r)
            self._sign_dst_cache[key] = (None if s is None
                                         else self.translate(s, d, r))
        return self._sign_dst_cache[key]


class MomentumProjector:
    """P_k over the full label space, factorized per lattice dimension.

    Phase convention P_k = (1/G) sum_R e^{+i k.R} T(R), matching
    basis.translation (validated against the repr-path golden values). The
    projector holds no precision of its own: :meth:`apply` works in the
    complex type of the vector it is given (complex128 for solver start
    vectors, complex64 inside the f32 bulk stage).
    """

    def __init__(self, rolls: RollTranslations, momentum, terms=None):
        self.rolls = rolls
        self.momentum = tuple(int(x) for x in np.atleast_1d(momentum))
        if terms is None:
            lattice = rolls.lattice
            terms = []
            for d in lattice.trans_dims:
                L = int(lattice.L[d])
                if L < 2:
                    continue
                shifts = []
                for r in range(1, L):
                    disp = np.zeros(lattice.dim)
                    disp[d] = r
                    ang = 2.0 * np.pi * float(lattice.k_dot_R(
                        self.momentum, disp[None, :])[0])
                    shifts.append((r, complex(np.cos(ang), np.sin(ang))))
                terms.append((d, L, shifts))
        # per pbc dim: (dim, L, [(shift, phase e^{+i k.R})])
        self.dims = [(int(d), int(L), [(int(r), complex(ph))
                                       for r, ph in shifts])
                     for d, L, shifts in terms]
        self.complex_phases = True  # complex vectors for every momentum
        self.is_identity = not self.dims

    @classmethod
    def from_arrays(cls, rolls, momentum, dims, phases):
        """From the JAX projector's ``dims`` [(dim, L, [(shift, sign index),
        ...])] and ``_phases_np`` ((n_terms, 2) cos/sin in iteration
        order); the signs come from ``rolls``."""
        phases = np.asarray(phases, dtype=np.float64).reshape(-1, 2)
        terms, t = [], 0
        for d, L, shifts in dims:
            out = []
            for r, _ in shifts:
                out.append((r, complex(phases[t, 0], phases[t, 1])))
                t += 1
            terms.append((d, L, out))
        return cls(rolls, momentum, terms=terms)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """P_k x, complex, in x's precision. Per dimension the phased,
        signed shifts accumulate in place into one buffer; besides it one
        translated copy is alive at a time."""
        if not x.is_complex():
            x = x.to(torch.complex64 if x.dtype == torch.float32
                     else torch.complex128)
        rolls = self.rolls
        for d, L, shifts in self.dims:
            acc = x.clone()
            for r, phase in shifts:
                t = rolls.translate(x, d, r)
                sg = rolls.sign_dst(d, r)
                if sg is None:
                    acc.add_(t, alpha=phase)
                else:
                    acc.addcmul_(t, sg, value=phase)
                del t
            x = acc.mul_(1.0 / L)
        return x


class ProjectedFullOp:
    """y = P_k H x over the full label space: the fast momentum-sector
    matvec (H commutes with T(R), so on sector-k vectors this is exactly the
    sector Hamiltonian; the projection kills numerical drift out of the
    sector each application).

    ``base`` is a full-label-space engine (``ContractOp`` / ``FullSpaceOp``),
    shared by all momentum sectors of a model; ``mask`` the 0/1
    quantum-number mask of THIS sector's enumeration, kept outside the
    shared engine. Same protocol as the base engines (call, mask, N, dtype,
    device, is_complex, n_applies, to_full, to_sector, nnz_estimate);
    :meth:`project` projects solver start and injection vectors.
    """

    def __init__(self, base, projector: MomentumProjector, mask=None):
        self.base = base
        self.projector = projector
        self.space = base.space
        self.N = self.n = base.N
        self.dtype = base.dtype
        self.device = base.device
        self.is_complex = True
        self.mask = base.mask if mask is None else mask
        self.sector_labels = base.sector_labels
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.n_applies += 1
        return self.projector.apply(self.base(x))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """Quantum-number mask, then P_k, then renormalise: what keeps a
        start or injected vector inside the sector. Works in x's precision."""
        if self.mask is not None:
            x = x * self.mask.to(x.real.dtype)
        x = self.projector.apply(x)
        return x / torch.clamp(torch.linalg.vector_norm(x), min=1e-300)

    def to_full(self, x_sector):
        return self.base.to_full(x_sector)

    def to_sector(self, x_full):
        return self.base.to_sector(x_full)

    @property
    def nnz_estimate(self) -> int:
        return self.base.nnz_estimate
