"""Spin-1/2 Heisenberg chain: full sector, momentum sectors, correlators.

The port of ``examples/chain_heisenberg_spin_half.py``, after the reference
example examples/trans_symmetric/latt_chain/chain_Heisenberg_spin_half.cc:
the same physics checks through the PyTorch API.

Run:  python -m quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half [L]
"""

from __future__ import annotations

import sys

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = np.array([[0.0, 0.0], [1.0, 0.0]])


def build(L, device="cuda"):
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat, device=device)
    m.add_orbital(L, "spin-1/2")
    Sz_tot = Mopr()
    for x in range(L):
        j = (x + 1) % L
        m.add_Ham(0.5 * (Opr(x, 0, False, SP) * Opr(j, 0, False, SM)
                         + Opr(x, 0, False, SM) * Opr(j, 0, False, SP)))
        m.add_Ham(Opr(x, 0, False, SZ) * Opr(j, 0, False, SZ))
        Sz_tot += Opr(x, 0, False, SZ)
    return m, Sz_tot


def main(L=16, device="cuda"):
    rows = []
    m, Sz_tot = build(L, device)
    dim = m.enumerate_basis_full([Sz_tot], [0.0])
    print(f"L={L}  Sz=0 sector dim = {dim}")
    solve(rows, m, "full Sz=0", nev=2, ncv=2)
    E0 = m.eigenvals_full[0]
    print(f"E0 = {E0:.9f}   E1 = {m.eigenvals_full[1]:.9f}")
    if L == 16:
        assert abs(E0 - (-7.142296361)) < 1e-8  # src/main_test.cc:88

    # static correlators (src/main_test.cc:106-108)
    def szsz(i, j):
        return m.measure_full_static(
            Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ), 0, 0).real

    print(f"<Sz0 Sz1> = {szsz(0, 1):+.10f}")
    print(f"<Sz0 Sz2> = {szsz(0, 2):+.10f}")
    if L == 16:
        assert abs(szsz(0, 1) - (-0.1487978408)) < 1e-8
        assert abs(szsz(0, 2) - (+0.0617414604)) < 1e-8

    # momentum sectors: E0(k)
    mk, Sz_tot_k = build(L, device)
    for k in range(L):
        mk.enumerate_basis_repr([k], [Sz_tot_k], [0.0])
        e0k = solve(rows, mk, f"k={k}", "repr")
        print(f"E0(k={k:2d}) = {e0k:.9f} (dim {mk.dim_repr(0)})")
        if L == 16 and k == 0:
            assert abs(e0k - E0) < 1e-8
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 16)
