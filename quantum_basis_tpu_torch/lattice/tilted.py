"""Arbitrary (tilted) supercell clusters from TOML files.

Port of ``quantum_basis_tpu.lattice.tilted`` (numpy and ``tomllib`` host
code, unchanged). A tilted cluster has no mixed-radix site numbering, so its
momentum sectors take the explicit route (ELL, BSR kernel) of ``Model``.

Re-design of the reference's TOML lattice constructor
(reference: src/lattice.cc:262-462) using the stdlib ``tomllib`` instead of
vendored cpptoml. File keys: ``dim``, ``num_sub``, ``a<i>`` (real-space
basis rows), ``A<i>`` (integer superlattice basis rows, possibly tilted),
``pos_sub<i>``, and ``[[sub<i>]] site=[...]`` tables listing every site's
integer coordinates (e.g. latt_special/triangular_31site.toml).

Folding into the canonical supercell solves coor = alpha @ A and subtracts
the integer part (reference: lattice::coor2supercell0, src/lattice.cc:479-501
— LAPACK dgesv there, a precomputed inverse here). Momentum sectors use
k.R fractions m @ A^{-T} R via :meth:`k_dot_R`, which reduces to m.R/L on
rectangular supercells.
"""

from __future__ import annotations

import tomllib

import numpy as np


class TiltedLattice:
    """A cluster defined by an integer superlattice basis A (rows) and an
    explicit site list; the translation group is Z^dim / A Z^dim."""

    def __init__(self, dim, num_sub, a, A, pos_sub, site_coords, name="tilted"):
        self.name = name
        self.dim = int(dim)
        self.num_sub = int(num_sub)
        self.a = np.asarray(a, dtype=np.float64)          # rows = primitive
        self.b = 2.0 * np.pi * np.linalg.inv(self.a).T
        self.A = np.asarray(A, dtype=np.int64)            # rows = supercell
        det = int(round(abs(np.linalg.det(self.A))))
        if det == 0:
            raise ValueError("superlattice basis A is singular")
        self.n_cells = det
        self.Ainv = np.linalg.inv(self.A.astype(np.float64))
        self.pos_sub = np.asarray(pos_sub, dtype=np.float64)
        self.bc = ["pbc"] * self.dim
        self.L = None  # no rectangular extents on a tilted cluster

        coords, subs = [], []
        for coor, sub in site_coords:
            coords.append([int(c) for c in coor])
            subs.append(int(sub))
        self._site2coor = np.asarray(coords, dtype=np.int64)
        self._site2sub = np.asarray(subs, dtype=np.int64)
        self.Nsites = len(coords)
        self.n_sites = self.Nsites
        if self.Nsites != self.n_cells * self.num_sub:
            raise ValueError(
                f"site list has {self.Nsites} entries, expected "
                f"|det A| * num_sub = {self.n_cells * self.num_sub}")
        self._coor2site = {}
        for s in range(self.Nsites):
            key = (int(self._site2sub[s]), tuple(self.fold(self._site2coor[s])))
            if key in self._coor2site:
                raise ValueError(f"duplicate site (after folding): {key}")
            self._coor2site[key] = s

    # ------------------------------------------------------------- geometry

    @staticmethod
    def from_toml(path: str) -> "TiltedLattice":
        with open(path, "rb") as f:
            cfg = tomllib.load(f)
        dim = int(cfg["dim"])
        num_sub = int(cfg["num_sub"])
        a = [cfg[f"a{d}"] for d in range(dim)]
        A = [cfg[f"A{d}"] for d in range(dim)]
        pos_sub = [cfg[f"pos_sub{i}"] for i in range(num_sub)]
        site_coords = []
        for i in range(num_sub):
            for entry in cfg[f"sub{i}"]:
                site_coords.append((entry["site"], i))
        return TiltedLattice(dim, num_sub, a, A, pos_sub, site_coords,
                             name=str(path))

    def fold(self, coor) -> np.ndarray:
        """Fold integer coordinates into the canonical supercell:
        coor = alpha @ A; coor0 = coor - floor(alpha) @ A."""
        coor = np.asarray(coor, dtype=np.int64)
        alpha = coor @ self.Ainv
        M = np.floor(alpha + 1e-12).astype(np.int64)
        return coor - M @ self.A

    def site2coor(self, site: int):
        return self._site2coor[site].tolist(), int(self._site2sub[site])

    def coor2site(self, coor, sub: int = 0) -> int:
        key = (int(sub) % self.num_sub, tuple(self.fold(coor)))
        return self._coor2site[key]

    def position(self, site: int) -> np.ndarray:
        coor, sub = self._site2coor[site], self._site2sub[site]
        return (coor + self.pos_sub[sub]) @ self.a

    # ------------------------------------------------------------- symmetry

    @property
    def trans_dims(self):
        return list(range(self.dim))

    def cell_displacements(self) -> np.ndarray:
        """Coset representatives of Z^dim / A Z^dim: the folded coordinates
        of one sublattice's cells (sorted), including the origin."""
        folded = {tuple(self.fold(self._site2coor[s]))
                  for s in range(self.Nsites)
                  if self._site2sub[s] == self._site2sub[0]}
        out = sorted(folded)
        if len(out) != self.n_cells:
            raise AssertionError("cell enumeration inconsistent with |det A|")
        return np.asarray(out, dtype=np.int64)

    def translation_plan(self, disp) -> np.ndarray:
        disp = np.asarray(disp, dtype=np.int64)
        plan = np.empty(self.Nsites, dtype=np.int64)
        for s in range(self.Nsites):
            plan[s] = self.coor2site(self._site2coor[s] + disp,
                                     int(self._site2sub[s]))
        return plan

    def translation_group(self):
        disps = self.cell_displacements()
        plans = np.stack([self.translation_plan(d) for d in disps])
        return disps, plans

    def k_dot_R(self, momentum, disps) -> np.ndarray:
        """Fractional k.R products m . alpha(R), with alpha = R @ A^{-1}
        (the supercell fractional coordinate, coor = alpha @ A) — shifting R
        by a superlattice vector changes alpha by integers, so the phase is
        a well-defined character of Z^dim / A Z^dim."""
        m = np.asarray(momentum, dtype=np.float64)
        disps = np.atleast_2d(np.asarray(disps, dtype=np.float64))
        return (disps @ self.Ainv) @ m

    def k_vector(self, momentum) -> np.ndarray:
        """Cartesian k of an integer momentum (units of superlattice B)."""
        m = np.asarray(momentum, dtype=np.float64)
        return (m @ self.Ainv) @ self.b

    @staticmethod
    def plan_product(p2, p1):
        p1 = np.asarray(p1)
        return np.asarray(p2)[p1]

    @staticmethod
    def plan_inverse(p):
        p = np.asarray(p)
        inv = np.empty_like(p)
        inv[p] = np.arange(p.size)
        return inv
