"""Spin-1/2 Heisenberg antiferromagnet on the triangular lattice (4x4).

The port of ``examples/triangular_heisenberg.py``, after the reference
examples examples/trans_absent/latt_triangular/
triangular_Heisenberg_spin_half.cc (full-sector E0) and the trans_symmetric
variant (momentum sectors and static correlators).

Run:  python -m quantum_basis_tpu_torch.examples.triangular_heisenberg
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr
from quantum_basis_tpu_torch.examples import solve

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()
E0_FULL = -8.555514918
# the reference's values at the momenta (kx, ky) of this model, as the JAX
# package's tests/test_golden_zoo.py labels them (the JAX example puts
# -7.588987242 at (2,2), where this model has -7.944709784)
GOLDEN_K = {(0, 0): -8.555514918, (0, 1): -8.002263841,
            (0, 2): -7.944709784, (0, 3): -8.002263841,
            (1, 2): -7.588987242}


def build(Lx, Ly, J=1.0, device="cuda"):
    lat = Lattice("triangular", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            for dx, dy in ((1, 0), (1, 1), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                m.add_Ham((0.5 * J) * (Opr(i, 0, False, SP) * Opr(j, 0, False, SM)
                                       + Opr(i, 0, False, SM) * Opr(j, 0, False, SP)))
                m.add_Ham(J * (Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ)))
    Sz_tot = Mopr()
    for s in range(lat.n_sites):
        Sz_tot += Opr(s, 0, False, SZ)
    return m, Sz_tot


def main(device="cuda"):
    rows = []
    # full sector (trans_absent …cc:107)
    m, Sz = build(4, 4, device=device)
    dim = m.enumerate_basis_full([Sz], [0.0])
    print(f"triangular 4x4 Sz=0 dim = {dim}")
    E0 = solve(rows, m, "full Sz=0", nev=1, ncv=1)
    print(f"E0(full) = {E0:.9f}")
    assert abs(E0 - E0_FULL) < 1e-8

    # momentum sectors + correlators (trans_symmetric …cc:135-146)
    mk, Szk = build(4, 4, device=device)
    for (kx, ky), e_ref in GOLDEN_K.items():
        mk.enumerate_basis_repr([kx, ky], [Szk], [0.0])
        e0k = solve(rows, mk, f"k=({kx},{ky})", "repr")
        print(f"E0(k=({kx},{ky})) = {e0k:.9f}")
        assert abs(e0k - e_ref) < 1e-8, ((kx, ky), e0k)

    # the last sector solved is k=(1,2): re-enumerate k=(0,0) for correlators
    mk.enumerate_basis_repr([0, 0], [Szk], [0.0])
    solve(rows, mk, "k=(0,0) again", "repr")
    c01 = mk.measure_repr_static(Opr(0, 0, False, SZ) * Opr(1, 0, False, SZ), 0, 0)
    c02 = mk.measure_repr_static(Opr(0, 0, False, SZ) * Opr(2, 0, False, SZ), 0, 0)
    cpm = mk.measure_repr_static(Opr(0, 0, False, SP) * Opr(1, 0, False, SM), 0, 0)
    print(f"<Sz0Sz1> = {c01.real:+.10f}   <Sz0Sz2> = {c02.real:+.10f}   "
          f"<S+0S-1> = {cpm.real:+.10f}")
    assert abs(c01.real - (-0.0594132980)) < 1e-8
    assert abs(c02.real - 0.0265006291) < 1e-8
    assert abs(cpm.real - (-0.1188265961)) < 1e-8
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
