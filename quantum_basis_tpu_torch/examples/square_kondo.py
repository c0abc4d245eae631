"""Kondo lattice model on a square lattice: itinerant electrons + local
spins, solved per momentum sector.

The port of ``examples/square_kondo.py``, after the reference example
examples/trans_symmetric/latt_square/square_Kondo.cc: a parameter-scan
driver (the reference reads J_Kondo and the magnetization sector from stdin,
square_Kondo.cc:28-42; here they are arguments) over a 2x2 square Kondo
lattice at quarter filling, writing E0(kx, ky) per momentum sector. The
reference has no golden values for it; the self-checks are the resolution of
identity over sectors and min_k E0(k) equal to the full-sector E0.

Run:  python -m quantum_basis_tpu_torch.examples.square_kondo [J_Kondo] [Nelec]
"""

from __future__ import annotations

import sys

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

C_UP = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0.0]])
C_DN = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0.0]])
SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()


def build(Lx, Ly, J_K, t=1.0, device="cuda"):
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "electron")
    m.add_orbital(lat.n_sites, "spin-1/2")
    N_tot, Sz_tot = Mopr(), Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            cu, cd = Opr(i, 0, True, C_UP), Opr(i, 0, True, C_DN)
            splus, sminus = cu.dagger() * cd, cd.dagger() * cu
            sz = 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd)
            Splus, Sminus = Opr(i, 1, False, SP), Opr(i, 1, False, SM)
            Sz_loc = Opr(i, 1, False, SZ)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
                m.add_Ham((-t) * (cu.dagger() * cu_j))
                m.add_Ham((-t) * (cu_j.dagger() * cu))
                m.add_Ham((-t) * (cd.dagger() * cd_j))
                m.add_Ham((-t) * (cd_j.dagger() * cd))
            # on-site Kondo exchange (square_Kondo.cc:128-129)
            m.add_Ham((0.5 * J_K) * (Splus * sminus + Sminus * splus))
            m.add_Ham(J_K * (Sz_loc * sz))
            N_tot += cu.dagger() * cu + cd.dagger() * cd
            Sz_tot += Sz_loc + sz
    return m, N_tot, Sz_tot


def main(J_K=1.1, Nelec=2.0, device="cuda"):
    rows = []
    Lx = Ly = 2
    m, Ntot, Sz = build(Lx, Ly, J_K, device=device)
    dim_full = m.enumerate_basis_full([Ntot, Sz], [Nelec, 0.0])
    print(f"square Kondo {Lx}x{Ly}, J_K={J_K:g}, N={Nelec:g}, Sz=0: "
          f"dim = {dim_full}")
    E0_full = solve(rows, m, "full", nev=1, ncv=1)
    print(f"E0(full) = {E0_full:.9f}")

    mk, Nk, Szk = build(Lx, Ly, J_K, device=device)
    found = []
    for kx in range(Lx):
        for ky in range(Ly):
            dim_k = mk.enumerate_basis_repr([kx, ky], [Nk, Szk],
                                            [Nelec, 0.0])
            e0 = solve(rows, mk, f"k=({kx},{ky})", "repr")
            found.append((kx, ky, dim_k, e0))
            print(f"E0(k=({kx},{ky})) = {e0:.9f}   dim {dim_k}")
    assert sum(r[2] for r in found) == dim_full
    assert abs(min(r[3] for r in found) - E0_full) < 1e-8
    print("square Kondo example passed.")
    return rows


if __name__ == "__main__":
    main(float(sys.argv[1]) if len(sys.argv) > 1 else 1.1,
         float(sys.argv[2]) if len(sys.argv) > 2 else 2.0)
