"""t-J model on a chain: hole-doped exchange + constrained hopping.

The port of ``examples/chain_tj.py``, after the reference examples
examples/trans_absent/latt_chain/chain_tJ.cc (L=12, N=8, Sz=0: degenerate
E0 = E1 = -9.762087307) and examples/trans_symmetric/latt_chain/chain_tJ.cc
(the same model per momentum sector; min_k E0(k) must equal the full-sector
E0). Local basis |0>, |up>, |dn> (no double occupancy).

Run:  python -m quantum_basis_tpu_torch.examples.chain_tj [L N]
"""

from __future__ import annotations

import sys

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

# tJ local basis |0>, |up>, |dn>  (reference convention, chain_tJ.cc:30-33)
C_UP = np.zeros((3, 3)); C_UP[0, 1] = 1.0
C_DN = np.zeros((3, 3)); C_DN[0, 2] = 1.0


def build(L, t=1.0, J=1.0, device="cuda"):
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "tJ")
    Sz_total, N_total = Mopr(), Mopr()
    for x in range(L):
        i = lat.coor2site([x], 0)
        j = lat.coor2site([x + 1], 0)
        cu_i, cd_i = Opr(i, 0, True, C_UP), Opr(i, 0, True, C_DN)
        cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
        Sp_i, Sm_i = cu_i.dagger() * cd_i, cd_i.dagger() * cu_i
        Sz_i = 0.5 * (cu_i.dagger() * cu_i) - 0.5 * (cd_i.dagger() * cd_i)
        N_i = cu_i.dagger() * cu_i + cd_i.dagger() * cd_i
        Sp_j, Sm_j = cu_j.dagger() * cd_j, cd_j.dagger() * cu_j
        N_j = cu_j.dagger() * cu_j + cd_j.dagger() * cd_j
        Sz_j = 0.5 * (cu_j.dagger() * cu_j) - 0.5 * (cd_j.dagger() * cd_j)
        # constrained hopping + spin exchange - N N / 4 (chain_tJ.cc:66-73)
        m.add_Ham((-t) * (cu_i.dagger() * cu_j))
        m.add_Ham((-t) * (cu_j.dagger() * cu_i))
        m.add_Ham((-t) * (cd_i.dagger() * cd_j))
        m.add_Ham((-t) * (cd_j.dagger() * cd_i))
        m.add_Ham(0.5 * J * (Sp_i * Sm_j + Sm_i * Sp_j))
        m.add_Ham(J * (Sz_i * Sz_j))
        m.add_Ham((-0.25 * J) * (N_i * N_j))
        Sz_total += Sz_i
        N_total += N_i
    return m, Sz_total, N_total


def main(L=12, N=8.0, device="cuda"):
    rows = []
    # ---- full sector: degenerate ground state pair (trans_absent variant)
    m, Sz, Ntot = build(L, device=device)
    dim = m.enumerate_basis_full([Sz, Ntot], [0.0, N])
    print(f"t-J chain L={L}, N={N:g}, Sz=0: dim = {dim}")
    solve(rows, m, "full", nev=2, ncv=2)
    E0, E1 = m.eigenvals_full[0], m.eigenvals_full[1]
    print(f"E0 = {E0:.9f}\nE1 = {E1:.9f}")
    if L == 12 and N == 8.0:
        assert abs(E0 + 9.762087307) < 1e-8   # chain_tJ.cc:100
        assert abs(E1 + 9.762087307) < 1e-8   # chain_tJ.cc:101

    # ---- momentum sectors (trans_symmetric variant)
    mk, Szk, Nk = build(L, device=device)
    e0k = []
    for k in range(L):
        mk.enumerate_basis_repr([k], [Szk, Nk], [0.0, N])
        e0k.append(solve(rows, mk, f"k={k}", "repr"))
        print(f"E0(k={k}) = {e0k[-1]:.9f}")
    assert abs(min(e0k) - E0) < 1e-8
    print("t-J chain example passed.")
    return rows


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 12,
         float(sys.argv[2]) if len(sys.argv) > 2 else 8.0)
