"""Square-lattice Fermi-Hubbard model at half filling (4x2).

The port of ``examples/square_fermi_hubbard.py``, after the reference
examples examples/trans_absent/latt_square/square_Fermi_Hubbard.cc (full
sector: E0 and the <c†_up,1 c_up,5> correlator) and
examples/trans_symmetric/latt_square/square_Fermi_Hubbard.cc (all 8 momentum
sectors); with the species-factorized builders (``build_factorized``,
``build_factorized_sector``) that the Hubbard 4x4 benchmarks use.

Run:  python -m quantum_basis_tpu_torch.examples.square_fermi_hubbard
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr, ProductModel
from quantum_basis_tpu_torch.examples import solve
from quantum_basis_tpu_torch.ops.operators import OprProd

C_UP = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0.0]])
C_DN = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0.0]])
C1 = np.array([[0.0, 1.0], [0.0, 0.0]])  # spinless annihilation
N1 = np.array([0.0, 1.0])                # spinless occupation (diagonal)
E0_4X2 = -14.07605866
# the reference's 8 values (BASELINE.md) at the momenta (kx, ky) of this
# model, as the JAX package's tests/test_golden_zoo.py labels them (the JAX
# example labels them in another order, and its (1,0) assert fails)
GOLDEN_K = {(0, 0): -14.07605866, (0, 1): -10.50470669,
            (1, 0): -12.16861094, (1, 1): -12.19847764,
            (2, 0): -10.54300366, (2, 1): -14.03137587,
            (3, 0): -12.16861094, (3, 1): -12.19847764}


def build(Lx, Ly, t=1.0, U=1.1, device="cuda"):
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "electron")
    Nup, Ndn = Mopr(), Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            cu, cd = Opr(i, 0, True, C_UP), Opr(i, 0, True, C_DN)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
                m.add_Ham((-t) * (cu.dagger() * cu_j))
                m.add_Ham((-t) * (cu_j.dagger() * cu))
                m.add_Ham((-t) * (cd.dagger() * cd_j))
                m.add_Ham((-t) * (cd_j.dagger() * cd))
            m.add_Ham(U * ((cu.dagger() * cu) * (cd.dagger() * cd)))
            Nup += cu.dagger() * cu
            Ndn += cd.dagger() * cd
    return m, lat, Nup, Ndn


def _factor(Lx, Ly, Nf, t, device):
    """The spinless hopping factor on the lattice, enumerated at Nf
    fermions."""
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    ms = Model(lat, device=device)
    ms.add_orbital(lat.n_sites, "spinless-fermion")
    Nop = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            ci = Opr(i, 0, True, C1)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cj = Opr(j, 0, True, C1)
                ms.add_Ham((-t) * (ci.dagger() * cj))
                ms.add_Ham((-t) * (cj.dagger() * ci))
            Nop += ci.dagger() * ci
    ms.enumerate_basis_full([Nop], [float(Nf)])
    return ms, lat


def _coupling(lat):
    pairs = []
    for s in range(lat.n_sites):
        n_s = Mopr([OprProd(1.0, [Opr(s, 0, False, N1)])])
        pairs.append((n_s, n_s))
    return pairs


def build_factorized_sector(Lx, Ly, Nup, Ndn, t=1.0, U=1.1, device="cuda"):
    """Factorized Hubbard in an arbitrary (N_up, N_dn) sector: two factor
    Models over the same spinless space with independent particle numbers
    (the spin- and charge-gap sectors of BASELINE config #3)."""
    mu, lat = _factor(Lx, Ly, Nup, t, device)
    md, _ = _factor(Lx, Ly, Ndn, t, device)
    return ProductModel(mu, md, coupling=_coupling(lat), coupling_scale=U)


def build_factorized(Lx, Ly, t=1.0, U=1.1, Nf=None, device="cuda"):
    """Species-factorized Hubbard.

    In the species-major Jordan-Wigner ordering the up and down species
    decouple into two copies of a SPINLESS-fermion hopping factor on the
    same lattice, coupled only by the diagonal U sum_i n_i^up (x) n_i^dn.
    Eigenvalues are ordering-independent, so this cross-checks against the
    site-major 'electron' encoding of :func:`build` at 1e-8 (reference
    golden: trans_absent square_Fermi_Hubbard.cc:113).

    Returns (ProductModel, factor Model); the factor sector is N = Nf
    fermions (default half filling).
    """
    if Nf is None:
        Nf = Lx * Ly // 2
    ms, lat = _factor(Lx, Ly, Nf, t, device)
    return ProductModel(ms, None, coupling=_coupling(lat),
                        coupling_scale=U), ms


def main(device="cuda"):
    rows = []
    # full sector (trans_absent square_Fermi_Hubbard.cc:113,122)
    m, lat, Nup, Ndn = build(4, 2, device=device)
    dim = m.enumerate_basis_full([Nup, Ndn], [4.0, 4.0])
    print(f"4x2, 4up 4dn sector dim = {dim}")
    E0 = solve(rows, m, "full (4,4)", nev=1, ncv=1)
    print(f"E0(full) = {E0:.9f}")
    assert abs(E0 - E0_4X2) < 1e-8
    hop = m.measure_full_static(
        Opr(1, 0, True, C_UP).dagger() * Opr(5, 0, True, C_UP), 0, 0)
    print(f"<c†_up,1 c_up,5> = {hop.real:+.10f}")
    assert abs(hop.real - 0.3957690742) < 1e-8

    # all 8 momentum sectors (trans_symmetric …cc:126-133)
    mk, latk, Nupk, Ndnk = build(4, 2, device=device)
    for (kx, ky), e_ref in GOLDEN_K.items():
        mk.enumerate_basis_repr([kx, ky], [Nupk, Ndnk], [4.0, 4.0])
        e0k = solve(rows, mk, f"k=({kx},{ky})", "repr")
        print(f"E0(k=({kx},{ky})) = {e0k:.9f}")
        assert abs(e0k - e_ref) < 1e-8, ((kx, ky), e0k)
    print("All checks passed.")
    return rows


if __name__ == "__main__":
    main()
