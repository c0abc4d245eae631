"""Square-lattice Bose-Hubbard model, 3x3, Nmax=2 bosons per site.

The port of ``examples/square_bose_hubbard.py``, after the reference example
examples/trans_absent/latt_square/square_Bose_Hubbard.cc (N=9 sector,
E0 = -25.81136094).

Run:  python -m quantum_basis_tpu_torch.examples.square_bose_hubbard
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve


def build(Lx, Ly, Nmax, t=1.0, U=1.1, device="cuda"):
    b = np.zeros((Nmax + 1, Nmax + 1))
    for d in range(Nmax):
        b[d, d + 1] = np.sqrt(d + 1.0)
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "boson", Nmax=Nmax)
    N_tot = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            b_i = Opr(i, 0, False, b)
            n_i = b_i.dagger() * b_i
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                b_j = Opr(j, 0, False, b)
                m.add_Ham((-t) * (b_i.dagger() * b_j))
                m.add_Ham((-t) * (b_j.dagger() * b_i))
            m.add_Ham((0.5 * U) * (n_i * n_i - n_i))
            N_tot += n_i
    return m, N_tot


def main(device="cuda"):
    rows = []
    m, N = build(3, 3, Nmax=2, device=device)
    dim = m.enumerate_basis_full([N], [9.0])
    print(f"3x3 Nmax=2 N=9 sector dim = {dim}")
    E0 = solve(rows, m, "full N=9", nev=1, ncv=1)
    print(f"E0 = {E0:.9f}")
    assert abs(E0 - (-25.81136094)) < 1e-8  # square_Bose_Hubbard.cc:100
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
