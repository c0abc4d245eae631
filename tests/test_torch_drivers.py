"""The port's benchmark drivers (``quantum_basis_tpu_torch.benchmarks``) at
reduced sizes on the CPU, against the JAX package.

- ``flagship_kagome24`` on the 2x2 kagome cluster: its own checks (sum of
  sector dims, min_k E0 = E0(full) to 1e-10) hold, E0 is the 12-site golden
  (1e-8) and every sector's E0 equals the JAX model's (1e-10).
- ``flagship_kagome24_sqw`` on the 2x2 cluster: per-target bounds, |mu_n| <=
  1, the moments of one q equal to the JAX model's ``measure_repr_dynamic_kpm``
  with the same bounds (1e-10); held against its own record it passes,
  against a record with one norm moved by 1e-6 it fails.
- ``hubbard4x4`` on 4x2: the golden (1e-8), the residual under its gate.
- ``hubbard4x4_gaps`` on 4x2: each sector's E0 equal to the JAX
  ``ProductModel``'s (1e-10), the gaps from those energies; a reused (h, h)
  record that failed its gate is refused, and a sector over its gate leaves
  its gap null and fails the run.
- ``bsr_bench`` on one case through the plain version: the kernel's plain
  version and the ELL agree, the calibration is written.
- ``routing``: one momentum sector on both routes agrees, and
  ``config.pinned`` restores the routing tables.
"""

from __future__ import annotations

import copy
import json
import math
import os
import sys

import numpy as np
import pytest

import quantum_basis_tpu as qj
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.benchmarks import (bsr_bench, flagship_kagome24,
                                                flagship_kagome24_sqw,
                                                hubbard4x4, hubbard4x4_gaps,
                                                routing)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import flagship_kagome24 as jflag  # noqa: E402  (the JAX package's builder)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import square_fermi_hubbard as jhub  # noqa: E402

E0_KAGOME12 = -5.444875217
TOL = 1e-10


def test_flagship_kagome_2x2(tmp_path):
    out = str(tmp_path / "flag.json")
    rec = flagship_kagome24.main(2, 2, device="cpu", out=out)
    assert json.loads(open(out).read())["E0_full"] == rec["E0_full"]
    assert rec["checks"]["sum_dims"] and \
        rec["checks"]["min_k_matches_full_1e-10"]
    assert abs(rec["E0_full"] - E0_KAGOME12) < 1e-8
    assert not config.mixed_precision  # restored
    mj, szj = jflag.build(2, 2)
    for s in rec["sectors"]:
        mj.enumerate_basis_repr(s["k"], [szj], [0.0])
        mj.locate_E0_lanczos(which="repr")
        assert abs(mj.eigenvals_repr[0] - s["E0"]) < TOL, s["k"]
        assert s["engine"] and s["solve_s"] >= 0


@pytest.fixture(scope="module")
def sqw_2x2(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sqw") / "sqw.json")
    return flagship_kagome24_sqw.main(2, 2, n_moments=48, k0=(0, 0),
                                      device="cpu", out=out)


def test_kagome_sqw_matches_jax(sqw_2x2):
    rec = sqw_2x2
    assert len(rec["runs"]) == 4 and rec["runs"][0]["norm"] == 0.0
    assert abs(rec["E0"] - E0_KAGOME12) < 1e-8
    for r in rec["runs"][1:]:
        lo, hi = r["sector_bounds"]
        assert (r["e_min"], r["e_max"]) == (lo, hi)
        assert np.all(np.abs(r["mu"]) <= 1 + 1e-9)
    mj, szj = jflag.build(2, 2)
    lat = mj.lattice
    mj.enumerate_basis_repr([0, 0], [szj], [0.0], sec=0)
    mj.locate_E0_lanczos(which="repr", sec=0)
    r = rec["runs"][1]
    qx, qy = r["q"]
    A = qj.Mopr()
    for s in range(lat.n_sites):
        coor, _ = lat.site2coor(s)
        ph = np.exp(-2j * np.pi * (qx * coor[0] / 2 + qy * coor[1] / 2))
        A += (ph / np.sqrt(lat.n_sites)) * qj.Opr(s, 0, False, jflag.SZ)
    mj.enumerate_basis_repr(r["k_target"], [szj], [0.0], sec=1)
    nrm, mu, _, _ = mj.measure_repr_dynamic_kpm(
        A, 0, 1, 48, bounds=(r["e_min"], r["e_max"]))
    assert abs(nrm - r["norm"]) < TOL
    np.testing.assert_allclose(r["mu"], np.asarray(mu), atol=TOL)


def test_kagome_sqw_against_a_reference(sqw_2x2, tmp_path):
    ref = copy.deepcopy(sqw_2x2)
    again = flagship_kagome24_sqw.main(2, 2, n_moments=48, k0=(0, 0),
                                       reference=ref, device="cpu",
                                       out=str(tmp_path / "a.json"))
    assert max(r.get("mu_err", 0.0) for r in again["runs"]) < 1e-12
    ref["runs"][2]["norm"] += 1e-6
    with pytest.raises(AssertionError, match="norm off"):
        flagship_kagome24_sqw.main(2, 2, n_moments=48, k0=(0, 0),
                                   reference=ref, device="cpu",
                                   out=str(tmp_path / "b.json"))


def test_hubbard_4x2(tmp_path):
    rec = hubbard4x4.main(4, 2, device="cpu", out=str(tmp_path / "h.json"))
    assert abs(rec["E0"] - hubbard4x4.E0_4X2) < 1e-8
    assert rec["gate_passed"] and rec["residual_f64"] < rec["residual_gate"]
    assert rec["golden_4x2"]["gate_passed"]


def test_gaps_4x2_match_jax(tmp_path):
    rec = hubbard4x4_gaps.main(4, 2, device="cpu",
                               out=str(tmp_path / "g.json"))
    e = {}
    for nu, nd in hubbard4x4_gaps.gap_sectors(4, 2):
        pm = jhub.build_factorized_sector(4, 2, nu, nd)
        e[(nu, nd)] = pm.locate_E0_lanczos(mixed=False, ncv=16)
        s = rec["sectors"][f"{nu},{nd}"]
        assert abs(s["E0"] - e[(nu, nd)]) < TOL, (nu, nd)
        assert s["gate_passed"]
    assert abs(rec["spin_gap"] - (e[(5, 3)] - e[(4, 4)])) < 1e-9
    assert abs(rec["charge_gap"]
               - (e[(5, 4)] + e[(4, 3)] - 2 * e[(4, 4)])) < 1e-9
    # reusing the (h, h) record gives the same gaps
    again = hubbard4x4_gaps.main(4, 2, e88=rec["sectors"]["4,4"],
                                 device="cpu", out=str(tmp_path / "r.json"))
    assert again["sectors"]["4,4"]["source"] == "reused"
    assert abs(again["charge_gap"] - rec["charge_gap"]) < 1e-12


def test_gaps_guard_unconverged_sectors(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="gate"):
        hubbard4x4_gaps.main(4, 2, e88={"E0": -14.0, "residual_f64": 1.0,
                                        "gate_passed": False},
                             device="cpu", out=str(tmp_path / "x.json"))
    real = hubbard4x4.solve_sector

    def failing(pm, maxit=4000, ncv=6):
        rec = real(pm, maxit, ncv)
        if (pm.na, pm.nb) == (56, 56):     # the (5, 3) sector
            rec["gate_passed"] = False
        return rec

    monkeypatch.setattr(hubbard4x4_gaps, "solve_sector", failing)
    out = tmp_path / "y.json"
    with pytest.raises(AssertionError, match="residual gate"):
        hubbard4x4_gaps.main(4, 2, device="cpu", out=str(out))
    written = json.loads(out.read_text())
    assert written["spin_gap"] is None and written["charge_gap"] is not None


def test_bsr_bench_plain_version(tmp_path):
    out = str(tmp_path / "bsr.json")
    rec = bsr_bench.main(["chain16_k0"], device="cpu", out=out)
    (case,) = rec["cases"]
    assert case["dim"] == 810 and case["agree_max_rel_diff"] < 1e-5
    assert rec["device"] == "cpu"
    assert rec["calibration"]["breakeven_blowup"] > 0
    assert json.loads(open(out).read())["cases"][0]["workload"] == \
        "chain16_k0"


def test_routing_both_routes_agree():
    before = {t: dict(v) for t, v in config.ROUTING.items()}
    recs = {}
    for route, pin in (("pkh", math.inf), ("explicit", 0.0)):
        with config.pinned(fullspace_repr_max_blowup=pin):
            assert config.route("fullspace_repr_max_blowup", "cpu") == pin
            recs[route], _ = routing._solve(routing.chain(16, 8), "cpu",
                                            "repr", [1])
    assert recs["pkh"]["engine"] == "ProjectedFullOp"
    assert recs["explicit"]["engine"] == "EllMatrix"
    assert abs(recs["pkh"]["E0"] - recs["explicit"]["E0"]) < TOL
    assert config.ROUTING == before
