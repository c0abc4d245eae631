"""Kagome lattice: spin-1/2 Heisenberg (12 sites) and t-J (N=8) models.

The port of ``examples/kagome_heisenberg_tj.py``, after the reference
examples examples/trans_absent/latt_kagome/kagome_Heisenberg_spin_half.cc
(2x2 cells, Sz=0, E0 = -5.444875217), examples/trans_absent/latt_kagome/
kagome_tJ.cc (N=8, Sz=0 full, E0 = -15.41931496) and the trans_symmetric
t-J variant (4 momentum sectors).

Run:  python -m quantum_basis_tpu_torch.examples.kagome_heisenberg_tj
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()
TJ_C_UP = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 0.0]])
TJ_C_DN = np.array([[0, 0, 1], [0, 0, 0], [0, 0, 0.0]])

# NN bond set of the reference kagome examples: (sub_i, sub_j, cell disp)
BONDS = [
    (0, 2, (1, 0)), (0, 2, (0, 0)),
    (1, 0, (0, 1)), (1, 0, (0, 0)),
    (2, 1, (-1, -1)), (2, 1, (0, 0)),
]
GOLDEN_TJ_K = {(0, 0): -15.41931496, (1, 0): -14.40277723,
               (0, 1): -14.40277723, (1, 1): -14.40277723}


def build_heisenberg(Lx, Ly, J=1.0, device="cuda"):
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in BONDS:
                i = lat.coor2site([x, y], si)
                j = lat.coor2site([x + dx, y + dy], sj)
                m.add_Ham((0.5 * J) * (Opr(i, 0, False, SP) * Opr(j, 0, False, SM)
                                       + Opr(i, 0, False, SM) * Opr(j, 0, False, SP)))
                m.add_Ham(J * (Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ)))
    Sz_tot = Mopr()
    for s in range(lat.n_sites):
        Sz_tot += Opr(s, 0, False, SZ)
    return m, Sz_tot


def build_tj(Lx, Ly, t=1.0, J=1.0, device="cuda"):
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "tJ")

    def ops(s):
        cu, cd = Opr(s, 0, True, TJ_C_UP), Opr(s, 0, True, TJ_C_DN)
        return {"cu": cu, "cd": cd,
                "Sp": cu.dagger() * cd, "Sm": cd.dagger() * cu,
                "Sz": 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd),
                "N": cu.dagger() * cu + cd.dagger() * cd}

    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in BONDS:
                i = lat.coor2site([x, y], si)
                j = lat.coor2site([x + dx, y + dy], sj)
                oi, oj = ops(i), ops(j)
                m.add_Ham((-t) * (oi["cu"].dagger() * oj["cu"]))
                m.add_Ham((-t) * (oj["cu"].dagger() * oi["cu"]))
                m.add_Ham((-t) * (oi["cd"].dagger() * oj["cd"]))
                m.add_Ham((-t) * (oj["cd"].dagger() * oi["cd"]))
                m.add_Ham((0.5 * J) * (oi["Sp"] * oj["Sm"] + oi["Sm"] * oj["Sp"]))
                m.add_Ham(J * (oi["Sz"] * oj["Sz"]))
                m.add_Ham((-0.25 * J) * (oi["N"] * oj["N"]))
    N_tot, Sz_tot = Mopr(), Mopr()
    for s in range(lat.n_sites):
        o = ops(s)
        N_tot += o["N"]
        Sz_tot += o["Sz"]
    return m, N_tot, Sz_tot


def main(device="cuda"):
    rows = []
    # kagome Heisenberg, 12 sites, Sz=0 (kagome_Heisenberg_spin_half.cc:175)
    m, Sz = build_heisenberg(2, 2, device=device)
    dim = m.enumerate_basis_full([Sz], [0.0])
    print(f"kagome 2x2 Heisenberg Sz=0 dim = {dim}")
    E0 = solve(rows, m, "Heisenberg full Sz=0", nev=1, ncv=1)
    print(f"E0 = {E0:.9f}")
    assert abs(E0 - (-5.444875217)) < 1e-8

    # kagome t-J, N=8 Sz=0: full (kagome_tJ.cc:232) + momentum sectors
    mt, N, Szt = build_tj(2, 2, device=device)
    dim = mt.enumerate_basis_full([N, Szt], [8.0, 0.0])
    print(f"kagome 2x2 t-J N=8 Sz=0 dim = {dim}")
    E0t = solve(rows, mt, "t-J full", nev=1, ncv=1)
    print(f"E0(full) = {E0t:.9f}")
    assert abs(E0t - (-15.41931496)) < 1e-8

    mk, Nk, Szk = build_tj(2, 2, device=device)
    for (kx, ky), e_ref in GOLDEN_TJ_K.items():
        mk.enumerate_basis_repr([kx, ky], [Nk, Szk], [8.0, 0.0])
        e0k = solve(rows, mk, f"t-J k=({kx},{ky})", "repr")
        print(f"E0(k=({kx},{ky})) = {e0k:.9f}")
        assert abs(e0k - e_ref) < 1e-8, ((kx, ky), e0k)
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
