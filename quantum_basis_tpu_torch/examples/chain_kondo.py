"""Kondo lattice chain: itinerant electrons + local spins.

The port of ``examples/chain_kondo.py``, after the reference examples
examples/trans_absent/latt_chain/chain_Kondo.cc (L=4, J_K=4, N=4: E0/E1) and
examples/trans_symmetric/latt_chain/chain_Kondo.cc (L=8, J_K=1.1, N=8, Sz=0
momentum sectors). Two orbitals per site: electron (orbital 0, fermionic)
and spin-1/2 (orbital 1); on-site Kondo exchange.

Run:  python -m quantum_basis_tpu_torch.examples.chain_kondo
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

# electron local basis |0>, |up>, |dn>, |updn> (reference convention)
C_UP = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0.0]])
C_DN = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0.0]])
SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()
GOLDEN_K = [-11.28542034, -11.15505719, -11.05573907, -11.02630258]


def build(L, J_K, t=1.0, device="cuda"):
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat, device=device)
    m.add_orbital(L, "electron")
    m.add_orbital(L, "spin-1/2")
    N_tot, Sz_tot = Mopr(), Mopr()
    for x in range(L):
        j = (x + 1) % L
        cu, cd = Opr(x, 0, True, C_UP), Opr(x, 0, True, C_DN)
        cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
        splus, sminus = cu.dagger() * cd, cd.dagger() * cu
        sz = 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd)
        Splus, Sminus = Opr(x, 1, False, SP), Opr(x, 1, False, SM)
        Sz_loc = Opr(x, 1, False, SZ)
        m.add_Ham((-t) * (cu.dagger() * cu_j))
        m.add_Ham((-t) * (cu_j.dagger() * cu))
        m.add_Ham((-t) * (cd.dagger() * cd_j))
        m.add_Ham((-t) * (cd_j.dagger() * cd))
        m.add_Ham((0.5 * J_K) * (Splus * sminus + Sminus * splus))
        m.add_Ham(J_K * (Sz_loc * sz))
        N_tot += cu.dagger() * cu + cd.dagger() * cd
        Sz_tot += Sz_loc + sz
    return m, N_tot, Sz_tot


def main(device="cuda"):
    rows = []
    # full sector, strong coupling (chain_Kondo.cc:126-127 trans_absent)
    m, N, _ = build(4, J_K=4.0, device=device)
    dim = m.enumerate_basis_full([N], [4.0])
    print(f"L=4 J_K=4 N=4 sector dim = {dim}")
    solve(rows, m, "full N=4", nev=2, ncv=1)
    E0, E1 = m.eigenvals_full[0], m.eigenvals_full[1]
    print(f"E0 = {E0:.9f}   E1 = {E1:.9f}")
    assert abs(E0 - (-12.67762138)) < 1e-8
    assert abs(E1 - (-9.834798964)) < 1e-8

    # momentum sectors (chain_Kondo.cc:129-132 trans_symmetric)
    mk, Nk, Szk = build(8, J_K=1.1, device=device)
    for k in range(4):
        mk.enumerate_basis_repr([k], [Nk, Szk], [8.0, 0.0])
        e0k = solve(rows, mk, f"k={k}", "repr")
        print(f"E0(k={k}) = {e0k:.9f}")
        assert abs(e0k - GOLDEN_K[k]) < 1e-8, (k, e0k)
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
