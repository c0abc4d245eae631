"""Checkpoint and resume of the port's mesh solves, against the JAX package.

Two gloo groups of separate processes, of 2 and 3 ranks
(tests/torch_mp_worker.py, suite "ckpt"), with ``config.enable_ckpt`` on:

- chain-12 Sz=0 through ``Model(mesh=)``: the solve, interrupted after a
  save by an engine that raises on every rank at the same apply, leaves a
  restart record and no stage record; the resumed solve gives the cold E0
  (1e-10) with fewer applies, deletes the restart record and writes the
  stage record; a further call makes no apply;
- the records hold whole vectors under the JAX package's key (``_mesh{P}``)
  with its shape and dtype, and the JAX package's mesh solve on P CPU
  devices resumes from the port's restart record to the same E0 (1e-10)
  and loads its stage record without a solve;
- ``ProductModel(mesh=)`` Hubbard 4x2, mixed: a repeated call makes no
  apply; with the stage record gone the f32 stage reloads its whole Ritz
  vector and makes no apply either; out of device memory in the f32 stage
  the solve raises on every rank (no rank falls back alone);
- a record that rank 0 fails to write or delete makes every rank raise.

Every rank must report the same numbers bit for bit.
"""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.parallel import basis_mesh
from quantum_basis_tpu.utils.ckpt import CkptStore as JaxStore

RANKS = (2, 3)
E0_CHAIN12 = -5.387390917445
E0_HUBBARD_4X2 = -14.07605866


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {P: tz.WorkerGroup("ckpt", P, tmp_path_factory.mktemp(f"ckpt{P}"))
          for P in RANKS}
    yield gs
    for g in gs.values():
        g.close()


def _scalar(groups, P, name):
    vals = [s[name] for _, s in groups[P].results()]
    assert all(v == vals[0] for v in vals), vals
    return vals[0]


def _jax_chain12(P):
    """The JAX package's chain-12 Sz=0 on a P-device mesh, and its key."""
    m, c = jz.heisenberg_chain(12)
    m.set_mesh(basis_mesh(P))
    m.enumerate_basis_full([c["Sz"]], [0.0])
    key = f"lczsE0_full_sec0_K_nev1_mesh{P}_h{m._ham_fingerprint():08x}"
    return m, key


def _copy_records(groups, P, sub, dest):
    for f in (Path(groups[P].out_dir) / sub).iterdir():
        shutil.copy(f, dest)


@pytest.mark.parametrize("P", RANKS)
def test_mesh_solve_resumes(groups, P):
    cold = _scalar(groups, P, "cold_E0")
    assert abs(cold - E0_CHAIN12) < 1e-8
    assert _scalar(groups, P, "interrupted")
    assert _scalar(groups, P, "restart_record") is not None
    assert not _scalar(groups, P, "stage_after_interruption")
    assert abs(_scalar(groups, P, "resumed_E0") - cold) < 1e-10
    assert 0 < _scalar(groups, P, "resumed_applies") \
        < _scalar(groups, P, "cold_applies")
    assert not _scalar(groups, P, "restart_after_resume")
    assert _scalar(groups, P, "stage_after_resume")
    assert _scalar(groups, P, "again_applies") == 0
    assert _scalar(groups, P, "again_E0") == _scalar(groups, P, "resumed_E0")


@pytest.mark.parametrize("P", RANKS)
def test_records_have_the_jax_layout(groups, P):
    mj, key = _jax_chain12(P)
    assert _scalar(groups, P, "key") == key
    mv, _ = mj._mesh_engine(mj.sec_full[0], "full")
    assert _scalar(groups, P, "engine") == type(mv).__name__
    assert _scalar(groups, P, "n_pad") == mv.n_pad
    fields, shape, dtype = _scalar(groups, P, "restart_record")
    assert fields == ["Hm", "Vim", "Vre", "it", "m"]
    assert shape == [13, mv.n_pad] and dtype == "float64"
    rec = JaxStore(str(Path(groups[P].out_dir) / "restart")).load(
        key + "_krylov")
    assert rec["Vre"].shape == (13, mv.n_pad) and rec["Vim"].shape == (1, 1)
    # rows past the sector are zero in every basis vector
    assert not rec["Vre"][:, mj.sec_full[0].dim:].any()
    stage = JaxStore(str(Path(groups[P].out_dir) / "stage")).load(key)
    assert stage["v0_re"].shape == (924,) and stage["v0_im"].shape == (1,)


@pytest.mark.parametrize("P", RANKS)
def test_jax_mesh_solve_resumes_from_port_record(groups, P, tmp_path,
                                                 monkeypatch):
    _copy_records(groups, P, "restart", tmp_path)
    monkeypatch.setattr(jax_config, "enable_ckpt", True)
    monkeypatch.setattr(jax_config, "ckpt_dir", str(tmp_path))
    monkeypatch.setattr(jax_config, "solver_log_dir", str(tmp_path / "log"))
    mj, key = _jax_chain12(P)
    mj.locate_E0_lanczos("full", nev=1, ncv=1)
    assert abs(mj.eigenvals_full[0] - _scalar(groups, P, "cold_E0")) < 1e-10
    # its first restart line already counts the steps of the port's run
    first = (tmp_path / "log" / "log_lanczos.txt").read_text().splitlines()[0]
    assert int(first.split()[2]) > _scalar(groups, P, "restart_it")
    assert JaxStore(str(tmp_path)).load(key + "_krylov") is None


@pytest.mark.parametrize("P", RANKS)
def test_jax_mesh_solve_loads_port_stage_record(groups, P, tmp_path,
                                                monkeypatch):
    import quantum_basis_tpu.solvers.restarted as jax_restarted

    _copy_records(groups, P, "stage", tmp_path)
    monkeypatch.setattr(jax_config, "enable_ckpt", True)
    monkeypatch.setattr(jax_config, "ckpt_dir", str(tmp_path))

    def boom(*a, **k):
        raise AssertionError("the JAX package solved despite the record")

    monkeypatch.setattr(jax_restarted, "eigs_smallest", boom)
    mj, _ = _jax_chain12(P)
    mj.locate_E0_lanczos("full", nev=1, ncv=1)
    assert mj.eigenvals_full[0] == _scalar(groups, P, "resumed_E0")
    np.testing.assert_array_equal(np.asarray(mj.eigenvecs_full[0][0]),
                                  groups[P].results()[0][0]["resumed_vec"])


@pytest.mark.parametrize("P", RANKS)
def test_product_model_mesh_records(groups, P):
    e0 = _scalar(groups, P, "prod_E0")
    assert abs(e0 - E0_HUBBARD_4X2) < 1e-8
    assert _scalar(groups, P, "prod_again_E0") == e0
    assert _scalar(groups, P, "prod_again_applies") == [0, 0]
    assert _scalar(groups, P, "prod_key").endswith(f"_mesh{P}")
    # the f32 stage's record holds the whole padded vector (70 rows padded
    # to a multiple of P, times 70)
    assert _scalar(groups, P, "prod_f32res") == [-(-70 // P) * P * 70]
    assert _scalar(groups, P, "prod_warm_f32_stage") == 0
    assert abs(_scalar(groups, P, "prod_warm_E0") - e0) < 1e-10


@pytest.mark.parametrize("P", RANKS)
def test_product_model_mesh_oom_raises(groups, P):
    """Out of device memory in the f32 stage, the one-device fallback would
    run on the ranks that hit it and leave the others in a collective: on a
    group the solve raises instead."""
    assert _scalar(groups, P, "prod_oom") == "raised"


@pytest.mark.parametrize("P", RANKS)
def test_failed_write_raises_on_every_rank(groups, P):
    got = [(s["failed_save"], s["failed_delete"])
           for _, s in groups[P].results()]
    assert got == [("OSError", "OSError")] + [
        ("RuntimeError", "RuntimeError")] * (P - 1)
