"""Spinless fermions with nearest-neighbor repulsion on the honeycomb
lattice (3x2 cells, 6+6 sites).

The port of ``examples/honeycomb_spinless_fermion.py``, after the reference
examples examples/trans_absent/latt_honeycomb/honeycomb_Spinless_Fermion.cc
(full sector E0 at N=4) and the trans_symmetric variant (all 6 momentum
sectors). Interaction V1 (n_i - 1/2)(n_j - 1/2) expanded; the constant V1/4
per bond is excluded from the eigenvalues, as in the reference.

Run:  python -m quantum_basis_tpu_torch.examples.honeycomb_spinless_fermion
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

C = np.array([[0.0, 1.0], [0.0, 0.0]])
N_DIAG = np.array([0.0, 1.0])
E0_FULL = -28.60363167
E0_KY1 = -28.27163215


def build(Lx, Ly, t=1.0, V1=4.0, device="cuda"):
    lat = Lattice("honeycomb", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spinless-fermion")
    N_tot = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            c_i, n_i = Opr(i, 0, True, C), Opr(i, 0, False, N_DIAG)
            for cx, cy in ((x, y), (x - 1, y), (x, y - 1)):
                j = lat.coor2site([cx, cy], 1)
                c_j, n_j = Opr(j, 0, True, C), Opr(j, 0, False, N_DIAG)
                m.add_Ham((-t) * (c_i.dagger() * c_j))
                m.add_Ham((-t) * (c_j.dagger() * c_i))
                m.add_Ham(V1 * (n_i * n_j))
                m.add_Ham((-0.5 * V1) * n_i)
                m.add_Ham((-0.5 * V1) * n_j)
            N_tot += n_i + Opr(lat.coor2site([x, y], 1), 0, False, N_DIAG)
    return m, N_tot


def main(device="cuda"):
    rows = []
    # full sector (trans_absent honeycomb_Spinless_Fermion.cc:129)
    m, N = build(3, 2, device=device)
    dim = m.enumerate_basis_full([N], [4.0])
    print(f"3x2 honeycomb N=4 sector dim = {dim}")
    E0 = solve(rows, m, "full N=4", nev=1, ncv=1)
    print(f"E0(full) = {E0:.9f}")
    assert abs(E0 - E0_FULL) < 1e-8

    # momentum sectors (trans_symmetric …cc:136-141)
    mk, Nk = build(3, 2, device=device)
    for kx in range(3):
        for ky in range(2):
            mk.enumerate_basis_repr([kx, ky], [Nk], [4.0])
            e0k = solve(rows, mk, f"k=({kx},{ky})", "repr")
            e_ref = E0_FULL if ky == 0 else E0_KY1
            print(f"E0(k=({kx},{ky})) = {e0k:.9f}")
            assert abs(e0k - e_ref) < 1e-8, ((kx, ky), e0k)
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
