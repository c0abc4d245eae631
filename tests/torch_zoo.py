"""Model builders for the PyTorch port (quantum_basis_tpu_torch).

The same Hamiltonians as tests/models_zoo.py (which builds them with the JAX
package's classes), built with the port's classes on a chosen device, so a
test can run one model through both packages. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import (Lattice, Model, Mopr, Opr, ProductModel,
                                     TiltedLattice)
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis

# Under pytest-xdist several test processes run side by side. With PyTorch's
# default of one intra-op thread per core each of them starts a full OpenMP
# team for every small CPU op, and the teams spin against one another: the
# projected chain-16 solve then takes minutes instead of seconds. One thread
# per worker is the fastest setting for the small shapes tested there.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SP_HALF = {
    "Sz": np.array([0.5, -0.5]),
    "Sp": np.array([[0.0, 1.0], [0.0, 0.0]]),
    "Sm": np.array([[0.0, 0.0], [1.0, 0.0]]),
}
SP_ONE = {
    "Sz": np.array([1.0, 0.0, -1.0]),
    "Sp": np.sqrt(2.0) * np.array([[0, 1, 0], [0, 0, 1], [0, 0, 0.0]]),
    "Sm": np.sqrt(2.0) * np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0.0]]),
}
# electron: |0>, |up>, |dn>, |up dn>
C_UP = np.array([[0, 1, 0, 0], [0, 0, 0, 0], [0, 0, 0, 1], [0, 0, 0, 0.0]])
C_DN = np.array([[0, 0, 1, 0], [0, 0, 0, -1], [0, 0, 0, 0], [0, 0, 0, 0.0]])
# tJ: |0>, |up>, |dn>
TJ_C_UP = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 0.0]])
TJ_C_DN = np.array([[0, 0, 1], [0, 0, 0], [0, 0, 0.0]])
# spinless fermion: |0>, |1>
C_SPINLESS = np.array([[0.0, 1.0], [0.0, 0.0]])
N_SPINLESS = np.array([0.0, 1.0])  # its occupation (diagonal)

_KAGOME_BONDS = [
    (0, 2, (1, 0)), (0, 2, (0, 0)),
    (1, 0, (0, 1)), (1, 0, (0, 0)),
    (2, 1, (-1, -1)), (2, 1, (0, 0)),
]


def _heis_bond(m, i, j, ops, J=1.0):
    m.add_Ham(0.5 * J * (Opr(i, 0, False, ops["Sp"]) * Opr(j, 0, False, ops["Sm"])
                         + Opr(i, 0, False, ops["Sm"]) * Opr(j, 0, False, ops["Sp"])))
    m.add_Ham(J * (Opr(i, 0, False, ops["Sz"]) * Opr(j, 0, False, ops["Sz"])))


def sz_pair(i=0, j=1):
    """Sz_i Sz_j on a spin-1/2 orbital 0."""
    return Opr(i, 0, False, SP_HALF["Sz"]) * Opr(j, 0, False, SP_HALF["Sz"])


def heisenberg_chain(L, spin="1/2", device="cpu"):
    """Spin-1/2 or spin-1 Heisenberg chain (reference:
    examples/*/latt_chain/chain_Heisenberg_spin_{half,one}.cc)."""
    ops = SP_HALF if spin == "1/2" else SP_ONE
    m = Model(Lattice("chain", [L], ["pbc"]), device=device)
    m.add_orbital(L, "spin-1/2" if spin == "1/2" else "spin-1")
    for x in range(L):
        _heis_bond(m, x, (x + 1) % L, ops)
    sz = Mopr()
    for x in range(L):
        sz += Opr(x, 0, False, ops["Sz"])
    return m, {"Sz": sz}


def three_spin_chain_with(Lattice, Model, Opr, Mopr, L, K=0.7, **model_kw):
    """Heisenberg chain plus the three-site exchange
    K (S+_i S-_{i+1} + S-_i S+_{i+1}) Sz_{i+2}: Hermitian, real, conserves
    Sz, and its three-slot support fits no pair window. Built with the given
    package's classes."""
    m = Model(Lattice("chain", [L], ["pbc"]), **model_kw)
    m.add_orbital(L, "spin-1/2")
    sz = Mopr()
    for x in range(L):
        j, k = (x + 1) % L, (x + 2) % L
        sp_i, sm_i = (Opr(x, 0, False, SP_HALF["Sp"]),
                      Opr(x, 0, False, SP_HALF["Sm"]))
        sp_j, sm_j = (Opr(j, 0, False, SP_HALF["Sp"]),
                      Opr(j, 0, False, SP_HALF["Sm"]))
        sz_k = Opr(k, 0, False, SP_HALF["Sz"])
        m.add_Ham(0.5 * (sp_i * sm_j + sm_i * sp_j))
        m.add_Ham(Opr(x, 0, False, SP_HALF["Sz"])
                  * Opr(j, 0, False, SP_HALF["Sz"]))
        m.add_Ham(K * (sp_i * sm_j * sz_k) + K * (sm_i * sp_j * sz_k))
        sz += Opr(x, 0, False, SP_HALF["Sz"])
    return m, {"Sz": sz}


def dm_chain_with(Lattice, Model, Opr, Mopr, L, D=0.3, **model_kw):
    """Spin-1/2 Heisenberg chain with a Dzyaloshinskii-Moriya term
    i D (S+_i S-_j - S-_i S+_j) / 2 on every bond: complex amplitudes.
    Built with the given package's classes, so a test can build the same
    model in both packages."""
    m = Model(Lattice("chain", [L], ["pbc"]), **model_kw)
    m.add_orbital(L, "spin-1/2")
    sz = Mopr()
    for x in range(L):
        j = (x + 1) % L
        sp_i, sm_i = (Opr(x, 0, False, SP_HALF["Sp"]),
                      Opr(x, 0, False, SP_HALF["Sm"]))
        sp_j, sm_j = (Opr(j, 0, False, SP_HALF["Sp"]),
                      Opr(j, 0, False, SP_HALF["Sm"]))
        m.add_Ham(0.5 * (sp_i * sm_j + sm_i * sp_j))
        m.add_Ham(Opr(x, 0, False, SP_HALF["Sz"])
                  * Opr(j, 0, False, SP_HALF["Sz"]))
        m.add_Ham((0.5j * D) * (sp_i * sm_j) + (-0.5j * D) * (sm_i * sp_j))
        sz += Opr(x, 0, False, SP_HALF["Sz"])
    return m, {"Sz": sz}


def dm_chain(L, D=0.3, device="cpu"):
    return dm_chain_with(Lattice, Model, Opr, Mopr, L, D, device=device)


def boson_triples(L, complex_=False, seed=5, device="cpu"):
    """Bosons (Nmax = 4) on a ring of L sites with H = sum over every three
    sites i < j < k of M_i M_j M_k, M a seeded 5x5 Hermitian matrix with a
    zero diagonal (real, or complex with ``complex_``). Each triple gives a
    row 64 images, so a row has 64 C(L, 3) image columns (640, 1280, 2240,
    3584 at L = 5, 6, 7, 8): rows wider than the ELL builds' warps fit in a
    block's shared memory. H is
    symmetric under every permutation of the sites, so it has momentum
    sectors; no quantum number is conserved."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((5, 5))
    if complex_:
        a = a + 1j * rng.standard_normal((5, 5))
    M = (a + a.conj().T) / 2
    np.fill_diagonal(M, 0.0)
    m = Model(Lattice("chain", [L], ["pbc"]), device=device)
    m.add_orbital(L, "boson", Nmax=4)
    for i in range(L):
        for j in range(i + 1, L):
            for k in range(j + 1, L):
                m.add_Ham(Opr(i, 0, False, M) * Opr(j, 0, False, M)
                          * Opr(k, 0, False, M))
    return m, {}


def tj_chain(L, t=1.0, J=1.0, device="cpu"):
    """t-J chain of the reference's self-test (src/main_test.cc; the same
    terms as tests/test_golden_chain.py::build_tj_chain)."""
    lat = Lattice("chain", [L], ["pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "tJ")
    Sz_total, N_total = Mopr(), Mopr()

    def site_ops(s):
        cu, cd = Opr(s, 0, True, TJ_C_UP), Opr(s, 0, True, TJ_C_DN)
        return (cu, cd, cu.dagger() * cd, cd.dagger() * cu,
                0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd),
                cu.dagger() * cu + cd.dagger() * cd)

    for x in range(L):
        i = lat.coor2site([x], 0)
        j = lat.coor2site([x + 1], 0)
        cu_i, cd_i, Sp_i, Sm_i, Sz_i, N_i = site_ops(i)
        cu_j, cd_j, Sp_j, Sm_j, Sz_j, N_j = site_ops(j)
        m.add_Ham((-t) * (cu_i.dagger() * cu_j))
        m.add_Ham((-t) * (cu_j.dagger() * cu_i))
        m.add_Ham((-t) * (cd_i.dagger() * cd_j))
        m.add_Ham((-t) * (cd_j.dagger() * cd_i))
        m.add_Ham(0.5 * J * (Sp_i * Sm_j + Sm_i * Sp_j))
        m.add_Ham(J * (Sz_i * Sz_j))
        m.add_Ham((-0.25 * J) * (N_i * N_j))
        Sz_total += Sz_i
        N_total += N_i
    return m, {"Sz": Sz_total, "N": N_total}


def kagome_heisenberg(Lx, Ly, J=1.0, device="cpu"):
    """Kagome Heisenberg antiferromagnet (reference:
    examples/trans_absent/latt_kagome/kagome_Heisenberg_spin_half.cc)."""
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in _KAGOME_BONDS:
                _heis_bond(m, lat.coor2site([x, y], si),
                           lat.coor2site([x + dx, y + dy], sj), SP_HALF, J)
    sz = Mopr()
    for s in range(lat.n_sites):
        sz += Opr(s, 0, False, SP_HALF["Sz"])
    return m, {"Sz": sz}


def bose_hubbard_square(Lx, Ly, Nmax, t=1.0, U=1.1, device="cpu"):
    """Bose-Hubbard model on the square lattice (reference:
    examples/trans_absent/latt_square/square_Bose_Hubbard.cc)."""
    b = np.zeros((Nmax + 1, Nmax + 1))
    for d in range(Nmax):
        b[d, d + 1] = np.sqrt(d + 1.0)
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "boson", Nmax=Nmax)
    Nb = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            b_i = Opr(i, 0, False, b)
            n_i = b_i.dagger() * b_i
            for dx, dy in ((1, 0), (0, 1)):
                b_j = Opr(lat.coor2site([x + dx, y + dy], 0), 0, False, b)
                m.add_Ham((-t) * (b_i.dagger() * b_j))
                m.add_Ham((-t) * (b_j.dagger() * b_i))
            m.add_Ham((0.5 * U) * (n_i * n_i - n_i))
            Nb += n_i
    return m, {"N": Nb}


def tj_sz(s):
    """Sz on site s of a t-J orbital 0."""
    cu, cd = Opr(s, 0, True, TJ_C_UP), Opr(s, 0, True, TJ_C_DN)
    return 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd)


def kagome_tj(Lx, Ly, t=1.0, J=1.0, device="cpu"):
    """Kagome t-J model (reference: examples/*/latt_kagome/kagome_tJ.cc)."""
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "tJ")
    N_tot, Sz_tot = Mopr(), Mopr()

    def site_ops(s):
        cu, cd = Opr(s, 0, True, TJ_C_UP), Opr(s, 0, True, TJ_C_DN)
        return {
            "cu": cu, "cd": cd,
            "Sp": cu.dagger() * cd, "Sm": cd.dagger() * cu,
            "Sz": 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd),
            "N": cu.dagger() * cu + cd.dagger() * cd,
        }

    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in _KAGOME_BONDS:
                i = lat.coor2site([x, y], si)
                j = lat.coor2site([x + dx, y + dy], sj)
                oi, oj = site_ops(i), site_ops(j)
                m.add_Ham((-t) * (oi["cu"].dagger() * oj["cu"]))
                m.add_Ham((-t) * (oj["cu"].dagger() * oi["cu"]))
                m.add_Ham((-t) * (oi["cd"].dagger() * oj["cd"]))
                m.add_Ham((-t) * (oj["cd"].dagger() * oi["cd"]))
                m.add_Ham((0.5 * J) * (oi["Sp"] * oj["Sm"] + oi["Sm"] * oj["Sp"]))
                m.add_Ham(J * (oi["Sz"] * oj["Sz"]))
                m.add_Ham((-0.25 * J) * (oi["N"] * oj["N"]))
    for s in range(lat.n_sites):
        o = site_ops(s)
        N_tot += o["N"]
        Sz_tot += o["Sz"]
    return m, {"N": N_tot, "Sz": Sz_tot}


def spinless_fermion_honeycomb(Lx, Ly, t=1.0, V1=4.0, device="cpu"):
    """Spinless fermions on the honeycomb lattice (reference:
    examples/*/latt_honeycomb/honeycomb_Spinless_Fermion.cc)."""
    lat = Lattice("honeycomb", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spinless-fermion")
    Nf = Mopr()
    n_diag = np.array([0.0, 1.0])
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            c_i = Opr(i, 0, True, C_SPINLESS)
            n_i = Opr(i, 0, False, n_diag)
            for cx, cy in ((x, y), (x - 1, y), (x, y - 1)):
                j = lat.coor2site([cx, cy], 1)
                c_j = Opr(j, 0, True, C_SPINLESS)
                n_j = Opr(j, 0, False, n_diag)
                m.add_Ham((-t) * (c_i.dagger() * c_j))
                m.add_Ham((-t) * (c_j.dagger() * c_i))
                m.add_Ham(V1 * (n_i * n_j))
                m.add_Ham((-0.5 * V1) * n_i)
                m.add_Ham((-0.5 * V1) * n_j)
            Nf += n_i + Opr(lat.coor2site([x, y], 1), 0, False, n_diag)
    return m, {"N": Nf}


def kondo_chain(L, J_Kondo, t=1.0, device="cpu"):
    """Kondo chain: electron orbital 0, local spin-1/2 orbital 1 (reference:
    examples/*/latt_chain/chain_Kondo.cc)."""
    m = Model(Lattice("chain", [L], ["pbc"]), device=device)
    m.add_orbital(L, "electron")
    m.add_orbital(L, "spin-1/2")
    N_tot, Sz_tot = Mopr(), Mopr()
    for x in range(L):
        j = (x + 1) % L
        cu_i, cd_i = Opr(x, 0, True, C_UP), Opr(x, 0, True, C_DN)
        cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
        n_up = cu_i.dagger() * cu_i
        n_dn = cd_i.dagger() * cd_i
        splus_i = cu_i.dagger() * cd_i
        sminus_i = cd_i.dagger() * cu_i
        sz_i = 0.5 * (cu_i.dagger() * cu_i) - 0.5 * (cd_i.dagger() * cd_i)
        Splus_i = Opr(x, 1, False, SP_HALF["Sp"])
        Sminus_i = Opr(x, 1, False, SP_HALF["Sm"])
        Sz_i = Opr(x, 1, False, SP_HALF["Sz"])
        m.add_Ham((-t) * (cu_i.dagger() * cu_j))
        m.add_Ham((-t) * (cu_j.dagger() * cu_i))
        m.add_Ham((-t) * (cd_i.dagger() * cd_j))
        m.add_Ham((-t) * (cd_j.dagger() * cd_i))
        m.add_Ham((0.5 * J_Kondo) * (Splus_i * sminus_i + Sminus_i * splus_i))
        m.add_Ham(J_Kondo * (Sz_i * sz_i))
        N_tot += n_up + n_dn
        Sz_tot += Sz_i + sz_i
    return m, {"N": N_tot, "Sz": Sz_tot}


def fermi_hubbard_square(Lx, Ly, t=1.0, U=1.1, device="cpu"):
    """Fermi-Hubbard model in the site-major 'electron' encoding (reference:
    examples/*/latt_square/square_Fermi_Hubbard.cc)."""
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "electron")
    Nup, Ndn = Mopr(), Mopr()
    for x in range(Lx):
        for y in range(Ly):
            i = lat.coor2site([x, y], 0)
            cu_i, cd_i = Opr(i, 0, True, C_UP), Opr(i, 0, True, C_DN)
            for dx, dy in ((1, 0), (0, 1)):
                j = lat.coor2site([x + dx, y + dy], 0)
                cu_j, cd_j = Opr(j, 0, True, C_UP), Opr(j, 0, True, C_DN)
                m.add_Ham((-t) * (cu_i.dagger() * cu_j))
                m.add_Ham((-t) * (cu_j.dagger() * cu_i))
                m.add_Ham((-t) * (cd_i.dagger() * cd_j))
                m.add_Ham((-t) * (cd_j.dagger() * cd_i))
            m.add_Ham(U * ((cu_i.dagger() * cu_i) * (cd_i.dagger() * cd_i)))
            Nup += cu_i.dagger() * cu_i
            Ndn += cd_i.dagger() * cd_i
    return m, {"Nup": Nup, "Ndn": Ndn}


def hubbard_factor(Lx, Ly, Nf, t=1.0, device="cpu"):
    """One species of the factorized Hubbard model: spinless fermions
    hopping on the square lattice, the N = Nf sector enumerated."""
    lat = Lattice("square", [Lx, Ly], ["pbc", "pbc"])
    ms = Model(lat, device=device)
    ms.add_orbital(lat.n_sites, "spinless-fermion")
    Nop = Mopr()
    for x in range(Lx):
        for y in range(Ly):
            ci = Opr(lat.coor2site([x, y], 0), 0, True, C_SPINLESS)
            for dx, dy in ((1, 0), (0, 1)):
                cj = Opr(lat.coor2site([x + dx, y + dy], 0), 0, True,
                         C_SPINLESS)
                ms.add_Ham((-t) * (ci.dagger() * cj))
                ms.add_Ham((-t) * (cj.dagger() * ci))
            Nop += ci.dagger() * ci
    ms.enumerate_basis_full([Nop], [float(Nf)])
    return ms


def site_occupation(s):
    """n_s of a spinless-fermion factor, as a Mopr."""
    return Mopr() + Opr(s, 0, False, N_SPINLESS)


def hubbard_factorized(Lx, Ly, t=1.0, U=1.1, Nup=None, Ndn=None,
                       device="cpu"):
    """Species-factorized Hubbard model (the same construction as
    examples/square_fermi_hubbard.py::build_factorized and
    build_factorized_sector): in the species-major Jordan-Wigner ordering
    the up and down species are two spinless-fermion hopping factors coupled
    only by the diagonal U sum_i n_i^up (x) n_i^dn. Half filling shares one
    factor; unequal (Nup, Ndn) builds two. Returns (ProductModel, up
    factor)."""
    half = Lx * Ly // 2
    Nup = half if Nup is None else Nup
    Ndn = Nup if Ndn is None else Ndn
    mu = hubbard_factor(Lx, Ly, Nup, t, device)
    md = None if Ndn == Nup else hubbard_factor(Lx, Ly, Ndn, t, device)
    pairs = [(site_occupation(s), site_occupation(s))
             for s in range(Lx * Ly)]
    return ProductModel(mu, md, coupling=pairs, coupling_scale=U), mu


def _fold(coor, A):
    """Integer coordinates folded into the supercell of the rows of A."""
    alpha = np.asarray(coor) @ np.linalg.inv(np.asarray(A, dtype=float))
    return tuple(np.asarray(coor) - np.floor(alpha + 1e-12).astype(int)
                 @ np.asarray(A))


def tilted_cosets(A):
    """Coset representatives of Z^2 / A Z^2 (A's rows span the
    superlattice): scan a box, keep coordinates with distinct folded values
    (as tests/test_tilted.py::_tilted_square_5)."""
    A = np.asarray(A)
    n = int(round(abs(np.linalg.det(A))))
    r = int(np.abs(A).sum())
    seen, out = set(), []
    for x in range(-r, r + 1):
        for y in range(-r, r + 1):
            c0 = _fold([x, y], A)
            if c0 not in seen:
                seen.add(c0)
                out.append([x, y])
                if len(out) == n:
                    return out
    raise AssertionError("failed to enumerate cosets")


def tilted_momenta(A):
    """One integer momentum per character of Z^2 / A Z^2: m and m' give the
    same phases e^{2 pi i m.(R A^-1)} iff m - m' is an integer combination
    of A's columns, so these are the cosets of the rows of A^T."""
    return tilted_cosets(np.asarray(A).T)


def tilted_heisenberg_with(TiltedLattice, Model, Opr, Mopr, A, **model_kw):
    """Spin-1/2 nearest-neighbour Heisenberg model on the tilted square
    cluster with superlattice rows A (|det A| sites), built with the given
    package's classes. Returns (model, {"Sz": total Sz})."""
    lat = TiltedLattice(2, 1, np.eye(2), np.asarray(A), [[0.0, 0.0]],
                        [(c, 0) for c in tilted_cosets(A)])
    m = Model(lat, **model_kw)
    m.add_orbital(lat.n_sites, "spin-1/2")
    bonds = set()
    for s in range(lat.n_sites):
        coor, sub = lat.site2coor(s)
        for d in ((1, 0), (0, 1)):
            j = lat.coor2site([coor[0] + d[0], coor[1] + d[1]], sub)
            bonds.add((min(s, j), max(s, j)))
    sz = Mopr()
    for i, j in sorted(bonds):
        m.add_Ham(0.5 * (Opr(i, 0, False, SP_HALF["Sp"])
                         * Opr(j, 0, False, SP_HALF["Sm"])
                         + Opr(i, 0, False, SP_HALF["Sm"])
                         * Opr(j, 0, False, SP_HALF["Sp"])))
        m.add_Ham(Opr(i, 0, False, SP_HALF["Sz"])
                  * Opr(j, 0, False, SP_HALF["Sz"]))
    for s in range(lat.n_sites):
        sz += Opr(s, 0, False, SP_HALF["Sz"])
    return m, {"Sz": sz}


def tilted_heisenberg(A, device="cpu"):
    return tilted_heisenberg_with(TiltedLattice, Model, Opr, Mopr, A,
                                  device=device)


def holstein_chain_with(Lattice, Model, Opr, Mopr, L, Nmax, t=1.0, w=1.0,
                        g=1.0, **model_kw):
    """Holstein polaron chain (PBC): orbital 0 spinless fermions, orbital 1
    bosons with at most ``Nmax`` phonons per site;
    H = -t sum (c+_i c_{i+1} + h.c.) + w sum n^b_i - g sum n_i (b+_i + b_i).
    Built with the given package's classes. Returns (model, {"N_e": electron
    number, "c_dag": {site: c+_site}}); the generator of the variational
    basis is H itself."""
    b = np.diag(np.sqrt(np.arange(1, Nmax + 1, dtype=np.float64)), k=1)
    nb = np.diag(np.arange(Nmax + 1, dtype=np.float64))
    m = Model(Lattice("chain", [L], ["pbc"]), **model_kw)
    m.add_orbital(L, "spinless-fermion")
    m.add_orbital(L, "boson", Nmax=Nmax)
    n_e = Mopr()
    c_dag = {}
    for x in range(L):
        j = (x + 1) % L
        m.add_Ham(-t * (Opr(x, 0, True, C_SPINLESS.T) * Opr(j, 0, True, C_SPINLESS)
                        + Opr(j, 0, True, C_SPINLESS.T)
                        * Opr(x, 0, True, C_SPINLESS)))
        m.add_Ham(w * Opr(x, 1, False, nb))
        m.add_Ham(-g * (Opr(x, 0, False, N_SPINLESS)
                        * (Opr(x, 1, False, b) + Opr(x, 1, False, b.T))))
        n_e += Opr(x, 0, False, N_SPINLESS)
        c_dag[x] = Opr(x, 0, True, C_SPINLESS.T)
    m.Ham_vrnl = m.Ham
    return m, {"N_e": n_e, "c_dag": c_dag}


def holstein_chain(L, Nmax, t=1.0, w=1.0, g=1.0, device="cpu"):
    return holstein_chain_with(Lattice, Model, Opr, Mopr, L, Nmax, t, w, g,
                               device=device)


def center_oracle(space, lattice, labels):
    """Host oracle of the translate-to-center canonical form (reference:
    translate2center_OBC, src/basis.cc:661-704): per label the mean
    fractional position of its non-vacuum sites, disp = floor(center0 -
    center1 + 1e-12) (0 for an all-vacuum state), then the label and the
    fermion parity of ``StateSpace.transform`` under the translation plan of
    disp. Returns (canon, disp, sign) numpy arrays."""
    labels = np.asarray(labels, dtype=np.int64)
    pos = np.asarray([np.asarray(lattice.site2coor(s)[0], dtype=np.float64)
                      + lattice.pos_sub[lattice.site2coor(s)[1]]
                      for s in range(lattice.n_sites)])
    V = space.decode(labels)
    occ = np.zeros((labels.size, lattice.n_sites), dtype=bool)
    for s in range(space.n_slots):
        occ[:, space.slot_site[s]] |= V[:, s] != 0
    npos = occ.sum(axis=1)
    center1 = (occ @ pos) / np.maximum(npos, 1)[:, None]
    disp = np.floor(pos.mean(axis=0) - center1 + 1e-12).astype(np.int64)
    disp[npos == 0] = 0
    canon = np.empty_like(labels)
    sign = np.empty(labels.size)
    for d in np.unique(disp, axis=0):
        rows = np.all(disp == d, axis=1)
        plan = lattice.translation_plan(list(np.mod(d, lattice.L)))
        canon[rows], parity = space.transform(labels[rows], plan)
        sign[rows] = 1.0 - 2.0 * parity
    return canon, disp, sign


# Inputs of the multi-process tests, made from seeds as the JAX package's
# tests make them (tests/test_sample_sort.py, tests/test_halo_sharded.py).


def sort_inputs() -> dict:
    """The inputs of tests/test_sample_sort.py."""
    out = {}
    for n in (64, 1000, 40000):
        rng = np.random.default_rng(11 + n)
        out[f"random_{n}"] = rng.integers(0, 1 << 48, size=n, dtype=np.int64)
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        np.zeros(5000, dtype=np.int64),
        rng.integers(0, 100, size=5000, dtype=np.int64),
        rng.integers(1 << 40, (1 << 40) + 50, size=5000, dtype=np.int64)])
    rng.shuffle(vals)
    out["skewed"] = vals
    m, c = heisenberg_chain(14)
    labels = enumerate_basis(m.space, [c["Sz"]], [0.0], device="cpu")
    np.random.default_rng(0).shuffle(labels)
    out["labels"] = labels
    out["overflow"] = np.full(2048, 42, dtype=np.int64)
    out["duplicates"] = np.full(512, 7, dtype=np.int64)
    return out


def rand_vec(n, complex_vec, seed):
    rng = np.random.default_rng(seed)
    re = rng.normal(size=n)
    return re + 1j * rng.normal(size=n) if complex_vec else re


def banded_ell(n=8192, W=6, band=40, seed=2):
    """tests/test_halo_sharded.py's banded matrix: (cols, vals, diag)."""
    rng = np.random.default_rng(seed)
    rows = np.arange(n)[:, None]
    cols = np.clip(rows + rng.integers(-band, band + 1, size=(n, W)), 0,
                   n - 1)
    return cols, rng.normal(size=(n, W)), rng.normal(size=n)


def odd_ell(n=37, W=3, seed=0):
    """tests/test_halo_sharded.py's matrix of odd size."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, size=(n, W)), rng.normal(size=(n, W)),
            rng.normal(size=n))


_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "torch_mp_worker.py")


class WorkerGroup:
    """A gloo group of ``ranks`` processes of tests/torch_mp_worker.py that
    runs one suite, started at once; :meth:`results` waits for it (at most
    ``timeout`` seconds, then every process still running is killed) and
    returns each rank's (arrays, scalars). The rendezvous file and the
    results live in ``out_dir``, one per group, so parallel test workers
    never share a port or a file."""

    def __init__(self, suite: str, ranks: int, out_dir, timeout: float = 240):
        self.suite, self.ranks, self.out_dir = suite, ranks, str(out_dir)
        self.deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        rdv = os.path.join(self.out_dir, "rendezvous")
        self.procs = [subprocess.Popen(
            [sys.executable, _WORKER, str(r), str(ranks), rdv, suite,
             self.out_dir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, env=env)
            for r in range(ranks)]
        self._results = None

    def close(self):
        """Kill every process of the group that still runs."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def results(self):
        if self._results is None:
            outs = []
            try:
                for p in self.procs:
                    left = max(self.deadline - time.monotonic(), 1.0)
                    outs.append(p.communicate(timeout=left)[0])
            finally:
                self.close()
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                if p.returncode != 0:
                    raise AssertionError(
                        f"{self.suite} rank {r}/{self.ranks} exited "
                        f"{p.returncode}:\n" + "\n".join(
                            out.splitlines()[-20:]))
            self._results = []
            for r in range(self.ranks):
                base = os.path.join(self.out_dir, f"{self.suite}_r{r}")
                with np.load(base + ".npz") as z:
                    arrays = dict(z)
                with open(base + ".json") as f:
                    self._results.append((arrays, json.load(f)))
        return self._results
