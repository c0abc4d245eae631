"""``Model(mesh=)`` and ``ProductModel(mesh=)`` of the port in gloo groups.

Two groups of separate processes, of 2 and 3 ranks (tests/torch_mp_worker.py,
suite "model"), drive the public API on a basis mesh:

- chain-16 Sz=0 full sector: E0 = -7.142296361 (1e-8), equal to the
  single-device port (1e-10), on the halo engine with the JAX package's
  ``halo_stats()``; the solver log (restart steps, Ritz values,
  residuals) equal to the JAX package's mesh solve on P devices, hence the
  same matvec count; <Sz0 Sz1> through ``measure_full_static``;
- chain-16 k=0 through ``enumerate_basis_repr(method="dnc")`` on the mesh:
  the golden (1e-8) and the single-device port (1e-10);
- t-J chain-10 N=8 Sz=0 (dim 3,150): the degenerate pair E0 = E1, equal to
  the single-device port (1e-10), the deflate-and-verify pass deciding
  alike on every rank;
- Hubbard 4x2 through ``ProductModel(mesh=)``, pure f64 and mixed: the
  golden -14.07605866 (1e-8) and the single-device port (1e-10), the
  published vector whole, normalized and an eigenvector.

Checkpointing on a group is tests/test_torch_mesh_ckpt.py.

Every rank must report the same numbers bit for bit.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.parallel import basis_mesh
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest

RANKS = (2, 3)
E0_CHAIN16 = -7.142296361
E0_HUBBARD_4X2 = -14.07605866


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {P: tz.WorkerGroup("model", P, tmp_path_factory.mktemp(f"model{P}"))
          for P in RANKS}
    yield gs
    for g in gs.values():
        g.close()


def _scalar(groups, P, name):
    results = groups[P].results()
    vals = [s[name] for _, s in results]
    assert all(v == vals[0] for v in vals), vals
    return vals[0]


def _array(groups, P, name):
    results = groups[P].results()
    first = results[0][0][name]
    for arrays, _ in results[1:]:
        np.testing.assert_array_equal(arrays[name], first)
    return first


@pytest.fixture(scope="module")
def single_device():
    """The same sectors solved by the port on one device (no mesh), on their
    explicit ELL matrices (on one thread: the worker groups run beside)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.generate_Ham_sparse_full()
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    out["chain16"] = m.eigenvals_full[0]
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0], method="dnc")
    evals, _ = eigs_smallest(m.generate_Ham_sparse_repr(), m.dim_repr(),
                             nev=1, complex_vec=True)
    out["chain16_k0"] = evals[0]
    m, c = tz.tj_chain(10)
    m.enumerate_basis_full([c["Sz"], c["N"]], [0.0, 8.0])
    m.generate_Ham_sparse_full()
    m.locate_E0_lanczos("full", nev=2, ncv=2)
    out["tj10"] = m.eigenvals_full[:2]
    pm, _ = tz.hubbard_factorized(4, 2)
    out["hubbard"] = pm.locate_E0_lanczos(maxit=600, ncv=16, mixed=False)
    out["hubbard_op"] = pm.op(torch.float64)
    torch.set_num_threads(threads)
    return out


def _log_lines(path):
    """(steps, theta, residual) of every restart line of a solver log."""
    return [tuple(line.split()[2:7:2]) for line in
            path.read_text().splitlines()]


def _total_steps(log):
    """Matrix applications of all runs in a log: the step counter restarts
    at every solver run (the solve, then its deflate-and-verify pass)."""
    steps = [int(line[0]) for line in log]
    return sum(a for a, b in zip(steps, steps[1:] + [0]) if b <= a)


@pytest.mark.parametrize("P", RANKS)
def test_full_sector_on_mesh(groups, single_device, P, tmp_path,
                             monkeypatch):
    monkeypatch.setattr(jax_config, "solver_log_dir", str(tmp_path))
    mj, cj = jz.heisenberg_chain(16)
    mj.set_mesh(basis_mesh(P))
    mj.enumerate_basis_full([cj["Sz"]], [0.0])
    mj.locate_E0_lanczos("full", nev=1, ncv=1)

    e0 = _scalar(groups, P, "chain16_E0")
    assert abs(e0 - E0_CHAIN16) < 1e-8
    assert abs(e0 - single_device["chain16"]) < 1e-10
    assert abs(e0 - mj.eigenvals_full[0]) < 1e-10
    assert _scalar(groups, P, "chain16_engine") == "EllShardedHalo"
    assert _scalar(groups, P, "chain16_halo") \
        == mj.sec_full[0]._mesh_mv[1].halo_stats()
    # the same start vector over the same padded length, the same restarts
    port_logs = [_log_lines(Path(groups[P].out_dir) / f"log_r{r}"
                            / "log_lanczos.txt") for r in range(P)]
    jax_log = _log_lines(tmp_path / "log_lanczos.txt")
    assert all(log == jax_log for log in port_logs)
    assert _scalar(groups, P, "chain16_applies") == _total_steps(jax_log)
    assert abs(_scalar(groups, P, "chain16_SzSz") - (-0.1487978408)) < 1e-7
    v = _array(groups, P, "chain16_vec")
    assert v.shape == (12870,) and abs(np.linalg.norm(v) - 1.0) < 1e-12


@pytest.mark.parametrize("P", RANKS)
def test_repr_sector_on_mesh(groups, single_device, P):
    e0 = _scalar(groups, P, "chain16_k0_E0")
    assert _scalar(groups, P, "chain16_k0_dim") == 810
    assert abs(e0 - E0_CHAIN16) < 1e-8
    assert abs(e0 - single_device["chain16_k0"]) < 1e-10


@pytest.mark.parametrize("P", RANKS)
def test_degenerate_pair_on_mesh(groups, single_device, P):
    e0, e1 = _scalar(groups, P, "tj10_E01")
    want0, want1 = single_device["tj10"]
    assert abs(want0 - want1) < 1e-10  # a degenerate pair
    assert abs(e0 - want0) < 1e-10 and abs(e1 - want1) < 1e-10


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("P", RANKS)
def test_product_model_on_mesh(groups, single_device, P, mixed):
    tag = "mixed" if mixed else "pure"
    e0 = _scalar(groups, P, f"hubbard_{tag}_E0")
    assert abs(e0 - E0_HUBBARD_4X2) < 1e-8
    assert abs(e0 - single_device["hubbard"]) < 1e-10
    v = _array(groups, P, f"hubbard_{tag}_vec")
    assert v.shape == (4900,) and abs(np.linalg.norm(v) - 1.0) < 1e-9
    op = single_device["hubbard_op"]
    x = torch.as_tensor(v)
    assert float(torch.linalg.vector_norm(op(x) - e0 * x)) < 1e-7
