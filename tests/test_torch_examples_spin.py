"""The port's spin example drivers (``quantum_basis_tpu_torch.examples``)
against the JAX package's ``examples/``.

Each port ``build(..., device="cpu")`` and the JAX example's ``build`` give
the same Hamiltonian: E0 of a full sector and of momentum sectors agree to
1e-10 at a reduced size. Where the example is cheap on the CPU, the port's
``main(device="cpu")`` runs at its golden size with the card's routing
table pinned (``config.ROUTING["cuda"]``, so the CPU drives the routes the
card takes), and its own 1e-8 golden asserts hold.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

import examples.chain_heisenberg_spin_half as jhalf
import examples.chain_heisenberg_spin_one as jone
import examples.kagome_heisenberg_tj as jkag
import examples.triangular_heisenberg as jtri
from quantum_basis_tpu.ops.operators import Mopr as JaxMopr, Opr as JaxOpr
from quantum_basis_tpu.ops.operators import OprProd as JaxOprProd
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.examples import (chain_dynamics_sqw,
                                              chain_heisenberg_spin_half,
                                              chain_heisenberg_spin_one,
                                              kagome_heisenberg_tj,
                                              triangular_heisenberg)

TOL = 1e-10


def _e0(m, which, sec=0):
    m.locate_E0_lanczos(which, sec=sec)
    return (m.eigenvals_full if which == "full" else m.eigenvals_repr)[0]


# (name, port builder, JAX builder, args, index of Sz among the outputs,
#  Sz value, momenta)
CASES = [
    ("spin_half_chain10", chain_heisenberg_spin_half.build, jhalf.build,
     (10,), 1, 0.0, [[1]]),
    ("spin_one_chain6", chain_heisenberg_spin_one.build, jone.build, (6,), 1,
     0.0, [[0], [2]]),
    ("triangular_3x3", triangular_heisenberg.build, jtri.build, (3, 3), 1,
     0.5, [[1, 0]]),
    ("kagome_heisenberg_2x2", kagome_heisenberg_tj.build_heisenberg,
     jkag.build_heisenberg, (2, 2), 1, 0.0, [[1, 1]]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_builds_match_jax(case):
    _, pb, jb, args, i_sz, sz, momenta = case
    pt, pj = pb(*args, device="cpu"), jb(*args)
    mt, mj = pt[0], pj[0]
    dt = mt.enumerate_basis_full([pt[i_sz]], [sz])
    dj = mj.enumerate_basis_full([pj[i_sz]], [sz])
    assert dt == dj
    assert abs(_e0(mt, "full") - _e0(mj, "full")) < TOL
    for k in momenta:
        assert mt.enumerate_basis_repr(k, [pt[i_sz]], [sz]) == \
            mj.enumerate_basis_repr(k, [pj[i_sz]], [sz])
        assert abs(_e0(mt, "repr") - _e0(mj, "repr")) < TOL, k


def test_chain_dynamics_matches_jax(tmp_path):
    """S(q, w) of the chain: the port's driver writes its JSON (no PNG),
    making the directory it is given;
    the norms equal the JAX model's measure_full_dynamic, and they sum to
    L/4 over q != 0 (the singlet's sum rule)."""
    L = 8
    rows, rec = chain_dynamics_sqw.main(L, str(tmp_path / "new" / "sqw"),
                                        device="cpu")
    on_disk = json.loads((tmp_path / "new" / "sqw.json").read_text())
    assert on_disk["norms"] == rec["norms"]
    assert not (tmp_path / "new" / "sqw.png").exists()
    assert np.all(np.isfinite(np.asarray(rec["S"])))
    assert abs(sum(n * n for n in rec["norms"]) - L / 4) < 1e-10
    mj, szj = jhalf.build(L)
    mj.enumerate_basis_full([szj], [0.0])
    mj.locate_E0_lanczos(nev=1, ncv=1)
    assert abs(rec["E0"] - mj.eigenvals_full[0]) < TOL
    for qi in (1, L // 2):
        q = 2.0 * np.pi * qi / L
        A = JaxMopr()
        for x in range(L):
            A += complex(np.exp(-1j * q * x) / np.sqrt(L)) * JaxMopr(
                [JaxOprProd(1.0, [JaxOpr(x, 0, False, jhalf.SZ)])])
        norm, a, _ = mj.measure_full_dynamic(A, 0, 0, 40)
        assert abs(norm - rec["norms"][qi - 1]) < TOL
    assert rows[0]["engine"] == "dense" and rows[0]["dim"] == 70


@pytest.mark.parametrize("name", ["chain_heisenberg_spin_half",
                                  "kagome_heisenberg_tj"])
def test_main_at_golden_size(name):
    """The driver at its golden size (chain-16; kagome-12 and kagome t-J
    2x2) on the card's routing table: its asserts hold, every sector is
    reported with its engine, and no momentum sector runs as P_k H."""
    mod = {"chain_heisenberg_spin_half": chain_heisenberg_spin_half,
           "kagome_heisenberg_tj": kagome_heisenberg_tj}[name]
    with config.pinned(**config.ROUTING["cuda"]):
        rows = mod.main(device="cpu")
    n_k = 16 if name == "chain_heisenberg_spin_half" else 4
    repr_rows = [r for r in rows if r["sector"].startswith(("k=", "t-J k="))]
    assert len(repr_rows) == n_k
    assert all(r["engine"] != "ProjectedFullOp" for r in repr_rows)
    assert all(r["s"] >= 0 and r["dim"] > 0 for r in rows)
