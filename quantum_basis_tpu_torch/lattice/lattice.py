"""Lattice geometry and symmetry plans (host-side, numpy).

Port of ``quantum_basis_tpu.lattice.lattice`` (numpy, unchanged).
Re-design of the reference ``lattice`` class (reference: src/lattice.cc).
Site numbering follows the reference exactly so that site-indexed golden
correlators line up (src/lattice.cc:591-616 site2coor_old):

- a "dim_spec" dimension is counted first when ``auto_dim_spec`` and
  ``num_sub`` is odd and some L is even (src/lattice.cc:209-216);
- with dim_spec == dim: site = sub + num_sub * (x0 + L0*(x1 + L1*(...)));
- with dim_spec == d:   site = x_d + L_d * (x_others... + (...)*sub).

Symmetry plans are permutation arrays ``plan[site] = new_site`` (value moves
from ``site`` TO ``plan[site]``) — applied on device as gathers.
"""

from __future__ import annotations

import itertools
import math

import numpy as np

from quantum_basis_tpu_torch.utils.codec import radix_decode, radix_encode

_NAMED_LATTICES = {
    # name: (dim, num_sub, a-vectors builder, sublattice positions)
    "chain": (1, 1, lambda: np.array([[1.0]]), [[0.0]]),
    "square": (2, 1, lambda: np.array([[1.0, 0.0], [0.0, 1.0]]), [[0.0, 0.0]]),
    "triangular": (
        2, 1,
        lambda: np.array([[1.0, 0.0], [-0.5, 0.5 * math.sqrt(3.0)]]),
        [[0.0, 0.0]],
    ),
    "kagome": (
        2, 3,
        lambda: np.array([[1.0, 0.0], [-0.5, 0.5 * math.sqrt(3.0)]]),
        [[0.0, 0.0], [0.0, 0.5], [-0.5, 0.0]],
    ),
    "honeycomb": (
        2, 2,
        lambda: np.array([[1.0, 0.0], [-0.5, 0.5 * math.sqrt(3.0)]]),
        [[0.0, 0.0], [2.0 / 3.0, 1.0 / 3.0]],
    ),
    "cubic": (3, 1, lambda: np.eye(3), [[0.0, 0.0, 0.0]]),
    "fcc": (
        3, 1,
        lambda: np.array([[0.0, 0.5, 0.5], [0.5, 0.0, 0.5], [0.5, 0.5, 0.0]]),
        [[0.0, 0.0, 0.0]],
    ),
    "triangular-stacked": (
        3, 1,
        lambda: np.array(
            [[1.0, 0.0, 0.0], [-0.5, 0.5 * math.sqrt(3.0), 0.0], [0.0, 0.0, 1.0]]
        ),
        [[0.0, 0.0, 0.0]],
    ),
}


class Lattice:
    def __init__(self, name: str, L, bc, auto_dim_spec: bool = True):
        key = name.lower()
        if key not in _NAMED_LATTICES:
            raise ValueError(f"lattice {name!r} not recognized")
        dim, num_sub, a_fn, pos_sub = _NAMED_LATTICES[key]
        L = [int(x) for x in L]
        if len(L) != dim:
            raise ValueError(f"{name} lattice needs {dim} extents")
        bc = [s.lower() for s in bc]
        if len(bc) != dim or any(s not in ("pbc", "obc") for s in bc):
            raise ValueError("bc must be 'pbc'/'obc' per dimension")
        self.name = key
        self.dim = dim
        self.num_sub = num_sub
        self.L = np.asarray(L, dtype=np.int64)
        self.bc = list(bc)
        self.a = a_fn()  # rows = primitive vectors
        self.b = 2.0 * np.pi * np.linalg.inv(self.a).T  # reciprocal rows
        self.pos_sub = np.asarray(pos_sub, dtype=np.float64)
        self.Nsites = int(np.prod(self.L) * num_sub)
        self.n_sites = self.Nsites  # pythonic alias

        # dim_spec: the dimension counted first (reference: lattice.cc:209-216)
        self.dim_spec = dim
        if auto_dim_spec and num_sub % 2 != 0:
            for d in range(dim):
                if L[d] % 2 == 0:
                    self.dim_spec = d
                    break

        # mixed-radix digit order for site <-> (coor, sub)
        if self.dim_spec != dim:
            self._dim_arr = [self.dim_spec] + [d for d in range(dim) if d != self.dim_spec]
            self._base = np.asarray([L[d] for d in self._dim_arr] + [num_sub], np.int64)
            self._sub_pos = dim  # sub digit index
        else:
            self._dim_arr = list(range(dim))
            self._base = np.asarray([num_sub] + [L[d] for d in self._dim_arr], np.int64)
            self._sub_pos = 0

        coors, subs = self._all_coords()
        self._site2coor = coors  # (Nsites, dim) int
        self._site2sub = subs    # (Nsites,) int

    # ------------------------------------------------------------ numbering

    def _all_coords(self):
        sites = np.arange(self.Nsites, dtype=np.int64)
        digits = radix_decode(sites, self._base)  # (N, dim+1)
        coor = np.zeros((self.Nsites, self.dim), dtype=np.int64)
        if self._sub_pos == 0:
            sub = digits[:, 0]
            for j, d in enumerate(self._dim_arr):
                coor[:, d] = digits[:, j + 1]
        else:
            sub = digits[:, -1]
            for j, d in enumerate(self._dim_arr):
                coor[:, d] = digits[:, j]
        return coor, sub.astype(np.int64)

    def site2coor(self, site: int):
        """-> (coor list, sublattice index)."""
        return self._site2coor[site].tolist(), int(self._site2sub[site])

    def coor2site(self, coor, sub: int = 0) -> int:
        """Fold coordinates into the supercell (periodic) and return site."""
        coor = np.asarray(coor, dtype=np.int64) % self.L
        sub = int(sub) % self.num_sub
        digits = np.empty(self.dim + 1, dtype=np.int64)
        if self._sub_pos == 0:
            digits[0] = sub
            for j, d in enumerate(self._dim_arr):
                digits[j + 1] = coor[d]
        else:
            digits[-1] = sub
            for j, d in enumerate(self._dim_arr):
                digits[j] = coor[d]
        return int(radix_encode(digits, self._base))

    # ------------------------------------------------------------ geometry

    def position(self, site: int) -> np.ndarray:
        """Cartesian position (coor + pos_sub) @ a."""
        coor, sub = self._site2coor[site], self._site2sub[site]
        return (coor + self.pos_sub[sub]) @ self.a

    def k_vector(self, momentum) -> np.ndarray:
        """Cartesian k of integer momentum (k_d in [0, L_d))."""
        m = np.asarray(momentum, dtype=np.float64)
        return (m / self.L) @ self.b

    # ------------------------------------------------------------- symmetry

    @property
    def trans_dims(self):
        """Dimensions along which translation symmetry holds (pbc only);
        cf. model::check_translation (src/model.cc:179-202)."""
        return [d for d in range(self.dim) if self.bc[d] == "pbc"]

    def translation_plan(self, disp) -> np.ndarray:
        """Permutation: value at ``site`` moves to ``plan[site]`` under a
        rigid displacement (reference: src/lattice.cc:968-981)."""
        disp = np.asarray(disp, dtype=np.int64)
        coor_new = (self._site2coor + disp) % self.L
        plan = np.empty(self.Nsites, dtype=np.int64)
        for site in range(self.Nsites):
            plan[site] = self.coor2site(coor_new[site], int(self._site2sub[site]))
        return plan

    def translation_group(self):
        """All distinct translations: (displacements (G, dim), plans (G, N)).

        Displacements run over pbc dimensions only, ordered with the LAST
        listed dimension fastest — matching the loop nesting of the reference
        examples (kx outer, ky inner)."""
        ranges = [range(self.L[d]) if self.bc[d] == "pbc" else range(1)
                  for d in range(self.dim)]
        disps, plans = [], []
        for combo in itertools.product(*ranges):
            disps.append(list(combo))
            plans.append(self.translation_plan(list(combo)))
        return np.asarray(disps, dtype=np.int64), np.asarray(plans, dtype=np.int64)

    def k_dot_R(self, momentum, disps) -> np.ndarray:
        """Fractional k.R products sum_d k_d R_d / L_d per displacement row
        (generalized by TiltedLattice to m @ A^{-T} R)."""
        m = np.asarray(momentum, dtype=np.float64)
        disps = np.atleast_2d(np.asarray(disps, dtype=np.float64))
        return disps @ (m / self.L)

    def rotation_plan(self, origin: int, angle: float) -> np.ndarray:
        """2-d rotation permutation about a site (single-sublattice lattices
        only, like the reference: src/lattice.cc:983-1028)."""
        if self.dim != 2 or self.num_sub != 1:
            raise NotImplementedError("rotation_plan: 2-d single-sublattice only")
        x0 = self.position(origin)
        R = np.array([[math.cos(angle), -math.sin(angle)],
                      [math.sin(angle), math.cos(angle)]])
        plan = np.empty(self.Nsites, dtype=np.int64)
        for site in range(self.Nsites):
            x1 = x0 + R @ (self.position(site) - x0)
            frac = self.b @ x1 / (2.0 * np.pi)
            coor = np.rint(frac).astype(np.int64)
            if np.max(np.abs(coor - frac)) > 1e-10:
                raise ValueError("rotation does not map the lattice onto itself")
            plan[site] = self.coor2site(coor, 0)
        if len(set(plan.tolist())) != self.Nsites:
            raise ValueError("rotation plan is not a permutation")
        return plan

    def reflection_plan(self, axis: int = 0) -> np.ndarray:
        """Reflection permutation (API parity: the reference declares this
        and throws unimplemented, src/lattice.cc:1030-1036 — here it works
        for single-sublattice lattices by coordinate negation)."""
        if self.num_sub != 1:
            raise NotImplementedError(
                "reflection_plan: single-sublattice lattices only "
                "(the reference does not implement it at all)")
        coor_new = self._site2coor.copy()
        coor_new[:, axis] = (-coor_new[:, axis]) % self.L[axis]
        plan = np.empty(self.Nsites, dtype=np.int64)
        for site in range(self.Nsites):
            plan[site] = self.coor2site(coor_new[site], 0)
        return plan

    def trans_subgroups(self, trans_sym=None):
        """All distinct subgroups of the translation group.

        The reference enumerates commensurate "magnetic Bravais" bases and
        dedups them by their covering pattern (lattice::trans_subgroups,
        src/lattice.cc:714-950); for the torus group Z_{L1} x ... x Z_{Ld}
        the same set is obtained directly by closing every generator tuple
        and deduplicating — feasible exactly because |T| <= a few hundred.

        Returns a list of (members, omega_g) sorted by decreasing subgroup
        size: ``members`` is an (m, dim) int array of displacement vectors
        (sorted rows), ``omega_g = |T| / m`` the reference's unit-cell size.
        Dimensions without translation symmetry contribute only 0.
        """
        if trans_sym is None:
            trans_sym = [self.bc[d] == "pbc" for d in range(self.dim)]
        Ls = np.asarray([int(self.L[d]) if trans_sym[d] else 1
                         for d in range(self.dim)], dtype=np.int64)
        elements = [np.asarray(c, dtype=np.int64)
                    for c in itertools.product(*[range(int(l)) for l in Ls])]
        G = len(elements)

        def closure(gens):
            seen = {tuple(np.zeros(self.dim, dtype=np.int64))}
            frontier = [np.zeros(self.dim, dtype=np.int64)]
            while frontier:
                cur = frontier.pop()
                for g in gens:
                    nxt = (cur + g) % Ls
                    t = tuple(int(v) for v in nxt)
                    if t not in seen:
                        seen.add(t)
                        frontier.append(nxt)
            return frozenset(seen)

        rank = int(np.sum(Ls > 1))
        subgroups = {closure([])}
        # abelian group of rank r: every subgroup has <= r generators
        gen_tuples = itertools.product(elements, repeat=max(rank, 1))
        for gens in gen_tuples:
            subgroups.add(closure(list(gens)))
        out = []
        for sg in subgroups:
            members = np.asarray(sorted(sg), dtype=np.int64)
            out.append((members, G // len(sg)))
        out.sort(key=lambda x: (x[1], x[0].tobytes()))
        return out

    def divide_lattice(self):
        """Split sites into sublattices A/B by coordinate parity along
        ``dim_spec`` (the divide-and-conquer split; reference:
        lattice::divide_lattice, src/lattice.cc:1076-1116).

        Returns (sites_A, sites_B) index arrays; A = even coordinate.
        """
        d = self.dim_spec if self.dim_spec < self.dim else 0
        if self.L[d] % 2 != 0:
            raise ValueError("divide_lattice needs an even extent along "
                             f"dimension {d} (reference asserts the same)")
        par = self._site2coor[:, d] % 2
        return (np.nonzero(par == 0)[0].astype(np.int64),
                np.nonzero(par == 1)[0].astype(np.int64))

    def k2superBZ(self, k_frac, A: np.ndarray):
        """Fold a fractional wave vector into the first superlattice BZ.

        ``A`` is the integer superlattice basis (rows = super vectors in
        lattice units); returns (k_folded_frac, integer_shift) such that
        k = k_folded + shift @ B_super with k_folded in [0, 1)^dim of the
        super reciprocal cell (reference: lattice::k2superBZ,
        src/lattice.cc:503-532, which solves the same system with dgesv).
        """
        A = np.asarray(A, dtype=np.float64)
        k = np.asarray(k_frac, dtype=np.float64)
        # coefficients of k in the super reciprocal basis: c = A @ k
        c = A @ k
        shift = np.floor(c + 1e-12).astype(np.int64)
        c_fold = c - shift
        k_fold = np.linalg.solve(A, c_fold)
        return k_fold, shift

    @staticmethod
    def plan_product(p2: np.ndarray, p1: np.ndarray) -> np.ndarray:
        """Composition 'apply p1 then p2' (cf. src/lattice.cc:1039-1074)."""
        p1 = np.asarray(p1)
        p2 = np.asarray(p2)
        out = np.empty_like(p1)
        out[np.arange(p1.size)] = p2[p1]
        return out

    @staticmethod
    def plan_inverse(p: np.ndarray) -> np.ndarray:
        p = np.asarray(p)
        inv = np.empty_like(p)
        inv[p] = np.arange(p.size)
        return inv
