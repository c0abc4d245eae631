"""Spin-1 Heisenberg chain: full sector E0/E1 and momentum sectors.

The port of ``examples/chain_heisenberg_spin_one.py``, after the reference
examples examples/trans_absent/latt_chain/chain_Heisenberg_spin_one.cc (full,
L=10) and examples/trans_symmetric/latt_chain/chain_Heisenberg_spin_one.cc
(momentum sectors, L=12).

Run:  python -m quantum_basis_tpu_torch.examples.chain_heisenberg_spin_one [L_full] [L_k]
"""

from __future__ import annotations

import sys

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

SZ = np.array([1.0, 0.0, -1.0])
SP = np.sqrt(2.0) * np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0.0]])
SM = SP.T.copy()
GOLDEN_K = [-16.86955614, -15.2458356, -14.40827083, -14.13433756,
            -14.54973865]  # L = 12, k = 0..4


def build(L, device="cuda"):
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat, device=device)
    m.add_orbital(L, "spin-1")
    Sz_tot = Mopr()
    for x in range(L):
        j = (x + 1) % L
        m.add_Ham(0.5 * (Opr(x, 0, False, SP) * Opr(j, 0, False, SM)
                         + Opr(x, 0, False, SM) * Opr(j, 0, False, SP)))
        m.add_Ham(Opr(x, 0, False, SZ) * Opr(j, 0, False, SZ))
        Sz_tot += Opr(x, 0, False, SZ)
    return m, Sz_tot


def main(L_full=10, L_k=12, device="cuda"):
    rows = []
    # full sector (reference asserts: chain_Heisenberg_spin_one.cc:96-97)
    m, Sz = build(L_full, device)
    dim = m.enumerate_basis_full([Sz], [0.0])
    print(f"L={L_full}  Sz=0 sector dim = {dim}")
    solve(rows, m, "full Sz=0", nev=2, ncv=1)
    E0, E1 = m.eigenvals_full[0], m.eigenvals_full[1]
    print(f"E0 = {E0:.9f}   E1 = {E1:.9f}")
    if L_full == 10:
        assert abs(E0 - (-14.09412995)) < 1e-8
        assert abs(E1 - (-13.569322)) < 1e-6

    # momentum sectors (trans_symmetric …spin_one.cc:98-102)
    mk, Szk = build(L_k, device)
    for k in range(L_k // 2 + 1):
        mk.enumerate_basis_repr([k], [Szk], [0.0])
        e0k = solve(rows, mk, f"k={k}", "repr")
        print(f"E0(k={k}) = {e0k:.9f}")
        if L_k == 12 and k < len(GOLDEN_K):
            assert abs(e0k - GOLDEN_K[k]) < 1e-8, (k, e0k)
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:3]))
