"""The port's fermion and boson example drivers
(``quantum_basis_tpu_torch.examples``) against the JAX package's
``examples/``.

Each port ``build(..., device="cpu")`` and the JAX example's ``build`` give
the same Hamiltonian: E0 of a full sector and of a momentum sector agree to
1e-10 at a reduced size; the factorized Hubbard builders give the JAX
``ProductModel``'s E0 (1e-10). The triangular-31 KPM driver runs on a
13-site tilted triangular cluster written as TOML, against the JAX
functions on the same file (moments 1e-10). Where the example is cheap on
the CPU (t-J 12, Bose-Hubbard 3x3, the 2x2 square Kondo lattice, the 3x2
honeycomb), the port's ``main(device="cpu")`` runs at its golden size with
the card's routing table pinned (``config.ROUTING["cuda"]``) and its own
1e-8 golden asserts hold.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import examples.chain_kondo as jkondo
import examples.chain_tj as jtj
import examples.honeycomb_spinless_fermion as jhoney
import examples.square_bose_hubbard as jbose
import examples.square_fermi_hubbard as jhub
import examples.square_kondo as jsk
import examples.triangular31_tJ_sqw_kpm as jtri31
from quantum_basis_tpu.lattice.tilted import TiltedLattice as JaxTilted
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.benchmarks.bsr_bench import tilted_cosets
from quantum_basis_tpu_torch.examples import (chain_kondo, chain_tj,
                                              honeycomb_spinless_fermion,
                                              square_bose_hubbard,
                                              square_fermi_hubbard,
                                              square_kondo,
                                              triangular31_tJ_sqw_kpm)

TOL = 1e-10


def _e0(m, which):
    m.locate_E0_lanczos(which)
    return (m.eigenvals_full if which == "full" else m.eigenvals_repr)[0]


# (name, port builder, JAX builder, args, kwargs, indices of the conserved
#  operators among the outputs, their values, momenta)
CASES = [
    ("tj_chain8_N6", chain_tj.build, jtj.build, (8,), {}, (1, 2),
     (0.0, 6.0), [[1]]),
    ("kondo_chain4_N4", chain_kondo.build, jkondo.build, (4,),
     {"J_K": 4.0}, (1,), (4.0,), []),
    ("kondo_chain4_N4_Sz0", chain_kondo.build, jkondo.build, (4,),
     {"J_K": 1.1}, (1, 2), (4.0, 0.0), [[1]]),
    ("bose_hubbard_2x3_N6", square_bose_hubbard.build, jbose.build,
     (2, 3, 2), {}, (1,), (6.0,), []),
    ("hubbard_2x2", square_fermi_hubbard.build, jhub.build, (2, 2), {},
     (2, 3), (2.0, 2.0), [[1, 0]]),
    ("square_kondo_2x2", square_kondo.build, jsk.build, (2, 2, 1.1), {},
     (1, 2), (2.0, 0.0), [[1, 0]]),
    ("honeycomb_3x2_N4", honeycomb_spinless_fermion.build, jhoney.build,
     (3, 2), {}, (1,), (4.0,), [[1, 1]]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_builds_match_jax(case):
    _, pb, jb, args, kw, idx, vals, momenta = case
    pt, pj = pb(*args, device="cpu", **kw), jb(*args, **kw)
    mt, mj = pt[0], pj[0]
    ct, cj = [pt[i] for i in idx], [pj[i] for i in idx]
    assert mt.enumerate_basis_full(ct, list(vals)) == \
        mj.enumerate_basis_full(cj, list(vals))
    assert abs(_e0(mt, "full") - _e0(mj, "full")) < TOL
    for k in momenta:
        assert mt.enumerate_basis_repr(k, ct, list(vals)) == \
            mj.enumerate_basis_repr(k, cj, list(vals))
        assert abs(_e0(mt, "repr") - _e0(mj, "repr")) < TOL, k


@pytest.mark.parametrize("sector", [None, (3, 2)])
def test_factorized_hubbard_matches_jax(sector):
    if sector is None:
        pt, _ = square_fermi_hubbard.build_factorized(4, 2, device="cpu")
        pj, _ = jhub.build_factorized(4, 2)
    else:
        pt = square_fermi_hubbard.build_factorized_sector(4, 2, *sector,
                                                          device="cpu")
        pj = jhub.build_factorized_sector(4, 2, *sector)
    assert (pt.na, pt.nb) == (pj.na, pj.nb)
    et = pt.locate_E0_lanczos(mixed=False, ncv=16)
    ej = pj.locate_E0_lanczos(mixed=False, ncv=16)
    assert abs(et - ej) < TOL
    if sector is None:
        assert abs(et - square_fermi_hubbard.E0_4X2) < 1e-8


def _tri13_toml(path):
    """A 13-site tilted triangular cluster (A = [[4, 1], [-1, 3]])."""
    A = [[4, 1], [-1, 3]]
    lines = ["dim = 2", "num_sub = 1", "a0 = [1.0, 0.0]",
             f"a1 = [0.5, {float(np.sqrt(3) / 2)!r}]", f"A0 = {A[0]}",
             f"A1 = {A[1]}", "pos_sub0 = [0.0, 0.0]"]
    for c in tilted_cosets(A):
        lines += ["[[sub0]]", f"site = {list(c)}"]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def test_triangular31_driver_on_a_small_cluster(tmp_path):
    toml = _tri13_toml(tmp_path / "tri13.toml")
    out = str(tmp_path / "sqw13")
    rows, rec = triangular31_tJ_sqw_kpm.main(toml, n_elec=2, n_moments=32,
                                             out=out, device="cpu")
    assert json.loads((tmp_path / "sqw13.json").read_text())["dim"] == \
        rec["dim"]
    assert rec["n_sites"] == 13 and len(rec["runs"]) == 13
    lat = JaxTilted.from_toml(toml)
    mj, nj, szj = jtri31.build_tj(lat)
    assert mj.enumerate_basis_full([nj, szj], [2.0, 0.0]) == rec["dim"]
    mj.locate_E0_lanczos(nev=1, ncv=1)
    assert abs(mj.eigenvals_full[0] - rec["E0"]) < TOL
    disps, _ = lat.translation_group()
    Ainv = np.linalg.inv(lat.A.astype(float))
    for run, d in list(zip(rec["runs"], disps))[1:3]:
        kfrac = np.asarray(d, float) @ Ainv
        assert np.allclose(run["kfrac"], kfrac)
        nrm, mu, _, _ = mj.measure_full_dynamic_kpm(
            jtri31.sz_q(lat, kfrac), 0, 0, 32,
            bounds=(run["e_min"], run["e_max"]))
        assert abs(nrm - run["norm"]) < TOL
        np.testing.assert_allclose(run["mu"], np.asarray(mu), atol=TOL)


@pytest.mark.parametrize("name", ["chain_tj", "square_bose_hubbard",
                                  "square_kondo",
                                  "honeycomb_spinless_fermion"])
def test_main_at_golden_size(name):
    """The driver at its golden size on the card's routing table: its
    asserts hold and every sector is reported with its engine."""
    mod = {"chain_tj": chain_tj, "square_bose_hubbard": square_bose_hubbard,
           "square_kondo": square_kondo,
           "honeycomb_spinless_fermion": honeycomb_spinless_fermion}[name]
    with config.pinned(**config.ROUTING["cuda"]):
        rows = mod.main(device="cpu")
    want = {"chain_tj": 13, "square_bose_hubbard": 1, "square_kondo": 5,
            "honeycomb_spinless_fermion": 7}[name]
    assert len(rows) == want
    assert all(r["engine"] and r["dim"] > 0 and r["s"] >= 0 for r in rows)
