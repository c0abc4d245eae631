"""The ported scaling and communication-roofline drivers on the CPU.

``benchmarks/scaling.py`` of the port runs its groups of 1, 2 and 4 gloo
processes at small sizes (chain L = 12 Sz=0, Hubbard 4x2) and
``benchmarks/comm_roofline.py`` models its lines:

- every line carries its fields, the device "cpu" and the rank count, and
  the efficiency against the same engine's 1-rank time;
- the bytes each rank receives per apply equal the closed forms:
  ``KronSharded`` (P - 1) rows of the padded first factor over P times the
  second factor's dim, ``MatvecSharded`` (P - 1) / P of the padded vector,
  ``FullSpaceSharded`` the boundary pieces of every roll, the halo engine
  the largest rank's unique off-rank columns;
- the halo figures equal the JAX package's ``EllShardedHalo.halo_stats()``
  for the same matrix and P;
- the model's efficiencies follow from its t_comp and t_comm.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.parallel import EllShardedHalo, basis_mesh
from quantum_basis_tpu_torch.benchmarks import comm_roofline, scaling

L = 12
RANKS = 4


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling") / "scaling.jsonl"
    got = scaling.main(["--L", str(L), "--ranks", str(RANKS), "--hubbard",
                        "4x2", "--device", "cpu", "--out", str(out),
                        "--timeout", "240"])
    assert got == comm_roofline.read_lines(str(out))
    return got


def _by(lines, engine, metric="apply", dtype="float64"):
    return {l["ranks"]: l for l in lines if l["engine"] == engine
            and l["metric"] == metric and l["dtype"] == dtype}


def test_lines_carry_their_fields(lines):
    engines = {(l["engine"], l["metric"], l["dtype"]) for l in lines}
    assert engines == {("FullSpaceSharded", "iter", "float64"),
                       ("FullSpaceSharded", "apply", "float64"),
                       ("EllShardedHalo", "apply", "float64"),
                       ("MatvecSharded", "apply", "float64"),
                       ("KronSharded", "apply", "float32"),
                       ("KronSharded", "apply", "float64")}
    assert sorted({l["ranks"] for l in lines}) == [1, 2, 4]
    for l in lines:
        assert l["device"] == "cpu" and l["card"] == "cpu"
        assert l["backend"] == "gloo"
        assert l[f"ms_per_{l['metric']}"] > 0
        assert l["peak_bytes_per_rank"] is None  # no device memory on a CPU
        if l["ranks"] == 1:
            assert l["efficiency_vs_1"] == 1.0 and l["link"] is None
            assert l["bytes_per_rank_per_apply"] == 0
        elif l["metric"] == "apply":
            assert l["link"]["bytes_per_s"] > 0
        assert l["efficiency_vs_1"] > 0


def test_kron_and_allgather_bytes(lines):
    for dt, item in (("float32", 4), ("float64", 8)):
        for P, l in _by(lines, "KronSharded", dtype=dt).items():
            na = -(-70 // P) * P
            assert l["bytes_per_rank_per_apply"] == \
                (P - 1) * (na // P) * 70 * item
    m, c = tz.heisenberg_chain(L)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    db = m.sec_full[0].dbasis
    for P, l in _by(lines, "MatvecSharded").items():
        n_pad = -(-db.n_blocks // P) * P * db.block_rows
        assert l["bytes_per_rank_per_apply"] == (P - 1) * (n_pad // P) * 8


def test_fullspace_bytes(lines):
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp

    m, c = tz.heisenberg_chain(L)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    fs = FullSpaceOp(m.compiled_Ham, m.sec_full[0].labels, device="cpu")
    deltas = [d for d, _, _ in fs._rolls._coefs]
    for P, l in _by(lines, "FullSpaceSharded").items():
        nl = fs.N // P
        sent = []
        for r in range(P):
            n = 0
            for d in deltas:
                t, o2 = (r + d // nl) % P, d % nl
                n += (nl - o2 if t != r else 0) + \
                    (o2 if (t + 1) % P != r else 0)
            sent.append(n)
        assert l["bytes_per_rank_per_apply"] == max(sent) * 8
        assert _by(lines, "FullSpaceSharded", "iter")[P][
            "bytes_per_rank_per_apply"] == max(sent) * 8


def test_halo_figures_equal_jax(lines):
    mj, cj = jz.heisenberg_chain(L)
    mj.enumerate_basis_full([cj["Sz"]], [0.0])
    ell = mj.generate_Ham_sparse_full(0)
    m, c = tz.heisenberg_chain(L)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    ell_t = m.generate_Ham_sparse_full(0)   # the same matrix, in the port
    cols, vals = ell_t.cols.numpy(), ell_t.vals.numpy()
    for P, l in _by(lines, "EllShardedHalo").items():
        assert l["halo_stats"] == EllShardedHalo(ell, basis_mesh(P)) \
            .halo_stats()
        nl = -(-ell_t.n // (8 * P)) * 8
        recv = []
        for q in range(P):
            rows = slice(q * nl, min((q + 1) * nl, ell_t.n))
            c = cols[rows][vals[rows] != 0]
            recv.append(np.unique(c[c // nl != q]).size)
        assert l["bytes_per_rank_per_apply"] == max(recv) * 8
        assert l["halo_stats"]["halo_nnz"] == sum(recv)


def test_comm_model(lines, tmp_path):
    src = tmp_path / "scaling.jsonl"
    src.write_text("".join(json.dumps(l) + "\n" for l in lines))
    model = comm_roofline.main(["--scaling", str(src), "--out",
                                str(tmp_path / "model.jsonl")])
    assert {(r["engine"], r["dtype"]) for r in model} == {
        ("FullSpaceSharded", "float64"), ("EllShardedHalo", "float64"),
        ("MatvecSharded", "float64"), ("KronSharded", "float32"),
        ("KronSharded", "float64")}
    assert sorted({r["ranks"] for r in model}) == [2, 4]
    for r in model:
        one = _by(lines, r["engine"], dtype=r["dtype"])[1]
        at = _by(lines, r["engine"], dtype=r["dtype"])[r["ranks"]]
        assert r["t_comp_ms"] == one["ms_per_apply"] / r["ranks"]
        assert r["bytes_per_rank_per_apply"] == at["bytes_per_rank_per_apply"]
        assert r["t_comm_ms"] == pytest.approx(
            r["bytes_per_rank_per_apply"] / r["link_bytes_per_s"] * 1e3)
        tc, tm = r["t_comp_ms"], r["t_comm_ms"]
        assert r["efficiency_no_overlap"] == pytest.approx(tc / (tc + tm))
        assert r["efficiency_overlap"] == pytest.approx(tc / max(tc, tm))
        assert r["efficiency_measured"] == at["efficiency_vs_1"]
        assert r["device"] == "cpu" and "t_comm_nvlink_nominal_ms" not in r
