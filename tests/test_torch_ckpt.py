"""Checkpoint and resume through the port (utils/ckpt.py and the solver and
model hooks): the cases of tests/test_ckpt.py, the RQI and ProductModel
records, and the interchange with the JAX package: equal Hamiltonian
fingerprints, hence equal keys; records and basis files written by either
package read by the other. Energies after a resume agree with dense
diagonalization to 1e-9 (the solver's own tolerance is 1e-10 * |E|).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.basis.io import (
    basis_load as jax_basis_load,
    basis_save as jax_basis_save,
)
from quantum_basis_tpu.ops.compile import (
    operator_fingerprint as jax_fingerprint,
)
from quantum_basis_tpu.solvers.restarted import eigs_smallest as jax_eigs
from quantum_basis_tpu.utils.ckpt import CkptStore as JaxStore
from quantum_basis_tpu_torch import CkptStore, basis_load, basis_save, config
from quantum_basis_tpu_torch.models import model as model_mod
from quantum_basis_tpu_torch.models import product as product_mod
from quantum_basis_tpu_torch.ops.bsr import ell_to_bsr
from quantum_basis_tpu_torch.ops.compile import operator_fingerprint
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.solvers import restarted
from quantum_basis_tpu_torch.solvers.cg import eigenvec_cg
from quantum_basis_tpu_torch.solvers.lanczos import (
    lanczos_dynamics,
    lanczos_ground,
)
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish
from quantum_basis_tpu_torch.utils import ckpt as ckpt_mod
from quantum_basis_tpu_torch.utils.rng import vec_randomize


@pytest.fixture
def ckpt_dir(tmp_path, monkeypatch):
    """Checkpointing on, in both packages, into one temporary directory;
    every restart boundary saves."""
    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, "enable_ckpt", True)
        monkeypatch.setattr(cfg, "ckpt_dir", str(tmp_path))
    monkeypatch.setattr(restarted, "_SAVE_PERIOD", 0.0)
    return tmp_path


def _chain_setup(L=10):
    """(matrix-free H, dense H, dim) of the Sz = 0 sector of chain-L."""
    m, c = tz.heisenberg_chain(L)
    n = m.enumerate_basis_full([c["Sz"]], [0.0])
    s = m.sec_full[0]
    return s.matvec, dense_matrix(m.compiled_Ham, s.labels).real, n


def _boom(*a, **k):
    raise AssertionError("the solver ran again despite the stage record")


def test_store_roundtrip(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec/with:odd chars", {"a": np.arange(5), "x": 3.5, "n": 7})
    rec = st.load("rec/with:odd chars")
    np.testing.assert_array_equal(rec["a"], np.arange(5))
    assert float(rec["x"]) == 3.5 and int(rec["n"]) == 7
    # the other package reads the same file under the same key
    np.testing.assert_array_equal(
        JaxStore(str(tmp_path)).load("rec/with:odd chars")["a"], np.arange(5))
    assert st._path("rec/with:odd chars") == JaxStore(
        str(tmp_path))._path("rec/with:odd chars")
    st.delete("rec/with:odd chars")
    assert st.load("rec/with:odd chars") is None
    assert list(tmp_path.iterdir()) == []      # no temp file left behind


def test_store_corruption_returns_none(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec", {"a": np.arange(100)})
    path = st._path("rec")
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF  # flip a byte mid-file
    open(path, "wb").write(bytes(data))
    assert st.load("rec") is None  # CRC or zip validation rejects


def test_store_truncation_returns_none(tmp_path):
    st = CkptStore(str(tmp_path))
    st.save("rec", {"a": np.arange(1000)})
    path = st._path("rec")
    data = open(path, "rb").read()
    open(path, "wb").write(data[: len(data) // 2])
    assert st.load("rec") is None


def test_thick_restart_resume(ckpt_dir):
    """Interrupt eigs_smallest via maxit, resume from the record: fewer
    matvecs than a cold run, the dense eigenvalues, the record removed."""
    mv, Hd, n = _chain_setup(10)  # dim 252
    evals = np.linalg.eigvalsh(Hd)
    with pytest.raises(RuntimeError):
        eigs_smallest(mv, n, nev=2, ncv=8, maxit=9, ckpt_key="resume_test")
    assert list(ckpt_dir.iterdir()), "no checkpoint written before the crash"
    rec = CkptStore(str(ckpt_dir)).load("resume_test")
    assert rec["Vre"].shape == (9, n) and rec["Vre"].dtype == np.float64

    n0 = mv.n_applies
    got, vecs = eigs_smallest(mv, n, nev=2, ncv=8, maxit=600,
                              ckpt_key="resume_test", verify_degenerate=False)
    resumed = mv.n_applies - n0
    np.testing.assert_allclose(got, evals[:2], atol=1e-9)
    assert CkptStore(str(ckpt_dir)).load("resume_test") is None
    n0 = mv.n_applies
    eigs_smallest(mv, n, nev=2, ncv=8, maxit=600, verify_degenerate=False)
    assert resumed < mv.n_applies - n0

    # a record that does not fit (another precision) is ignored, not used
    with pytest.raises(RuntimeError):
        eigs_smallest(mv, n, nev=2, ncv=8, maxit=9, ckpt_key="resume_test")
    st = CkptStore(str(ckpt_dir))
    rec = st.load("resume_test")
    rec["Vre"] = rec["Vre"].astype(np.float32)
    st.save("resume_test", rec)
    n0 = mv.n_applies
    got, _ = eigs_smallest(mv, n, nev=2, ncv=8, maxit=600,
                           ckpt_key="resume_test", verify_degenerate=False)
    assert mv.n_applies - n0 > resumed
    np.testing.assert_allclose(got, evals[:2], atol=1e-9)


def test_model_stage_checkpoint(ckpt_dir, monkeypatch):
    """Stage record: a second locate_E0_lanczos loads the stored eigenpair
    without running the solver; so does a momentum sector's."""
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    e0 = m.eigenvals_full[0]
    skey = f"lczsE0_full_sec0_nev1_h{m._ham_fingerprint():08x}"
    assert CkptStore(str(ckpt_dir)).load(skey) is not None
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    m16, c16 = tz.heisenberg_chain(16)
    m16.enumerate_basis_repr([1], [c16["Sz"]], [0.0])
    m16.locate_E0_lanczos("repr")
    rkey = f"lczsE0_repr_sec0_K1_nev1_h{m16._ham_fingerprint():08x}"
    assert CkptStore(str(ckpt_dir)).load(rkey) is not None

    monkeypatch.setattr(model_mod, "eigs_smallest", _boom)
    m2, c2 = tz.heisenberg_chain(12)
    m2.enumerate_basis_full([c2["Sz"]], [0.0])
    m2.locate_E0_lanczos("full", nev=1, ncv=1)
    assert m2.eigenvals_full[0] == e0
    assert torch.equal(m2.eigenvecs_full[0], m.eigenvecs_full[0])
    m3, c3 = tz.heisenberg_chain(16)
    m3.enumerate_basis_repr([1], [c3["Sz"]], [0.0])
    m3.locate_E0_lanczos("repr")
    assert m3.eigenvals_repr[0] == m16.eigenvals_repr[0]
    assert m3.eigenvecs_repr[0].dtype == torch.complex128
    assert torch.equal(m3.eigenvecs_repr[0], m16.eigenvecs_repr[0])


def test_cg_resume(ckpt_dir):
    """eigenvec_cg: interrupt via maxit, resume from the saved iterate."""
    mv, Hd, n = _chain_setup(10)
    w, V = np.linalg.eigh(Hd)
    E0 = float(w[0])
    re, _ = vec_randomize(n, seed=3)
    # bias the start toward the eigenvector so CG (a refiner) converges
    v0 = 0.2 * re / np.linalg.norm(re) + V[:, 0]
    v0 = torch.as_tensor(v0 / np.linalg.norm(v0))
    # interrupted run: checkpoint every 5 iterations, stop at 12
    _, res_mid, _ = eigenvec_cg(mv, E0, v0, maxit=12, tol=1e-11,
                                ckpt_key="cg_test", ckpt_every=5)
    assert res_mid > 1e-11  # genuinely unconverged
    rec = CkptStore(str(ckpt_dir)).load("cg_test")
    assert rec is not None and int(rec["m"]) >= 5
    # resume: continues from the saved iterate and converges
    v, res, m_total = eigenvec_cg(mv, E0, v0, maxit=3000, tol=1e-11,
                                  ckpt_key="cg_test", ckpt_every=500)
    assert res < 1e-9
    assert abs(np.vdot(v.numpy(), V[:, 0])) > 1.0 - 1e-8
    assert m_total > int(rec["m"])  # the count carried over
    assert CkptStore(str(ckpt_dir)).load("cg_test") is None  # cleaned up


def test_lanczos_dynamics_resume(ckpt_dir, monkeypatch):
    """Dynamics a/b recording: crash after a mid-run checkpoint, resume,
    coefficients identical to an uninterrupted run."""
    mv, Hd, n = _chain_setup(10)
    re, _ = vec_randomize(n, seed=7)
    v0 = torch.as_tensor(re / np.linalg.norm(re))
    monkeypatch.setattr(config, "enable_ckpt", False)
    a_ref, b_ref = lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test")
    assert list(ckpt_dir.iterdir()) == []   # off: a key alone writes nothing
    monkeypatch.setattr(config, "enable_ckpt", True)

    class CrashingStore(CkptStore):
        saves = 0

        def save(self, key, payload):
            super().save(key, payload)
            CrashingStore.saves += 1
            if CrashingStore.saves == 2:
                raise RuntimeError("simulated crash after checkpoint")

    monkeypatch.setattr(ckpt_mod, "active_store",
                        lambda: CrashingStore(str(ckpt_dir)))
    with pytest.raises(RuntimeError, match="simulated crash"):
        lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test", ckpt_chunk=8)
    rec = CkptStore(str(ckpt_dir)).load("dyn_test")
    assert rec is not None and int(rec["k"]) == 16

    monkeypatch.setattr(ckpt_mod, "active_store",
                        lambda: CkptStore(str(ckpt_dir)))
    n0 = mv.n_applies
    a, b = lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test", ckpt_chunk=8)
    assert mv.n_applies - n0 == 8
    np.testing.assert_allclose(a, a_ref, atol=1e-9)
    np.testing.assert_allclose(b, b_ref, atol=1e-9)
    assert CkptStore(str(ckpt_dir)).load("dyn_test") is None
    # a record of another start vector under the same key is not resumed
    with pytest.raises(RuntimeError, match="simulated crash"):
        CrashingStore.saves = 0
        monkeypatch.setattr(ckpt_mod, "active_store",
                            lambda: CrashingStore(str(ckpt_dir)))
        lanczos_dynamics(mv, v0, 24, ckpt_key="dyn_test", ckpt_chunk=8)
    monkeypatch.setattr(ckpt_mod, "active_store",
                        lambda: CkptStore(str(ckpt_dir)))
    re2, _ = vec_randomize(n, seed=8)
    n0 = mv.n_applies
    lanczos_dynamics(mv, torch.as_tensor(re2 / np.linalg.norm(re2)), 24,
                     ckpt_key="dyn_test", ckpt_chunk=8)
    assert mv.n_applies - n0 == 24


def test_stage_key_carries_ham_fingerprint(ckpt_dir):
    """Changing one coupling must invalidate the stage record: model B run
    beside model A's records (same sector dim) is not handed A's
    eigenvalues."""
    from quantum_basis_tpu_torch import Opr

    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    m2, c2 = tz.heisenberg_chain(12)
    SZ = np.array([0.5, -0.5])
    m2.add_Ham(0.37 * (Opr(0, 0, False, SZ) * Opr(1, 0, False, SZ)))
    assert m2._ham_fingerprint() != m._ham_fingerprint()
    m2.enumerate_basis_full([c2["Sz"]], [0.0])
    m2.locate_E0_lanczos("full", nev=1, ncv=1)
    assert m2.eigenvals_full[0] != m.eigenvals_full[0]  # solved fresh


def test_lanczos_ground_and_rqi_resume(ckpt_dir):
    """The two polish kernels: stopped after one cycle / one outer step,
    they resume from their record and clean it up on convergence."""
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    ell = m._repr_ell(m.sec_repr[0])
    ref, _ = eigs_smallest(ell, ell.n, nev=1, ncv=12, complex_vec=True)
    re, im = vec_randomize(ell.n, seed=1, complex_valued=True)
    v0 = torch.as_tensor(re + 1j * im)
    out = lanczos_ground(ell, v0, maxit=11, inner=10, ckpt_key="lg_test")
    assert out["niter"] >= 11 and out["residual"] > 1e-6
    assert int(CkptStore(str(ckpt_dir)).load("lg_test")["used"]) == out["niter"]
    out = lanczos_ground(ell, v0, maxit=4000, inner=40, ckpt_key="lg_test")
    assert abs(out["E0"] - ref[0]) < 1e-9
    assert CkptStore(str(ckpt_dir)).load("lg_test") is None

    bsr32 = ell_to_bsr(ell, dtype=torch.float32)
    _, v32 = eigs_smallest(bsr32, ell.n, nev=1, ncv=12, complex_vec=True,
                           tol=1e-5, verify_degenerate=False)
    first = rqi_polish(ell, v32[0], fs32=bsr32, max_outer=1,
                       ckpt_key="rqi_test")
    assert not first["converged"]
    rec = CkptStore(str(ckpt_dir)).load("rqi_test")
    assert bool(rec["pending"]) and int(rec["outer"]) == 1
    assert float(rec["best_rnorm"]) == first["residual"]
    seen = []
    out = rqi_polish(ell, v32[0], fs32=bsr32, ckpt_key="rqi_test",
                     log=lambda i, th, rn, ni: seen.append((i, rn)))
    assert out["converged"] and abs(out["E0"] - ref[0]) < 1e-10
    # the count went on from the record, and the first resumed evaluation
    # is that of the corrected iterate, not of the start vector again
    assert seen[0][0] == 1 and seen[0][1] < 0.5 * first["residual"]
    assert CkptStore(str(ckpt_dir)).load("rqi_test") is None


@pytest.mark.parametrize("over", [0, 1])
def test_polish_records_capped_before_gathering(ckpt_dir, monkeypatch, over):
    """lanczos_ground and rqi_polish refuse a record past the device's
    ckpt_max_bytes from the vectors' shapes, before they gather a
    whole vector (GroupStore.whole); at the cap exactly the record is
    written. Each record holds two whole complex vectors."""
    from quantum_basis_tpu_torch.solvers.reduce import GroupStore

    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    ell = m._repr_ell(m.sec_repr[0])
    monkeypatch.setitem(config.MEMORY["cpu"], "ckpt_max_bytes",
                        2 * ell.n * 16 - over)
    gathered = []
    whole = GroupStore.whole
    monkeypatch.setattr(GroupStore, "whole",
                        lambda self, x: gathered.append(x.shape) or whole(
                            self, x))
    re, im = vec_randomize(ell.n, seed=1, complex_valued=True)
    v0 = torch.as_tensor(re + 1j * im)
    lanczos_ground(ell, v0, maxit=11, inner=10, ckpt_key="lg_cap")
    rqi_polish(ell, v0, fs32=ell, max_outer=1, ckpt_key="rqi_cap")
    store = CkptStore(str(ckpt_dir))
    written = [store.load(k) is not None for k in ("lg_cap", "rqi_cap")]
    assert written == [not over] * 2
    assert bool(gathered) == (not over)


def test_product_model_stage_record(ckpt_dir, monkeypatch):
    pm, _ = tz.hubbard_factorized(4, 2)
    e0 = pm.locate_E0_lanczos(mixed=False, ncv=16, log=lambda *a: None)
    assert abs(e0 - (-14.07605866)) < 1e-8
    key = f"prodE0_{pm.na}x{pm.nb}_nev1_h{pm._fingerprint():08x}"
    assert CkptStore(str(ckpt_dir)).load(key) is not None
    monkeypatch.setattr(product_mod, "eigs_smallest", _boom)
    pm2, _ = tz.hubbard_factorized(4, 2)
    assert pm2.locate_E0_lanczos(mixed=False, ncv=16) == e0
    assert torch.equal(pm2.eigenvecs[0], pm.eigenvecs[0])
    n0 = tz.site_occupation(0)
    assert pm2.measure_product_static(n0, n0) == pm.measure_product_static(
        n0, n0)
    # another U: another key, so it is solved (the poisoned solver raises)
    pm3, _ = tz.hubbard_factorized(4, 2, U=2.0)
    assert pm3._fingerprint() != pm._fingerprint()
    with pytest.raises(AssertionError, match="despite the stage record"):
        pm3.locate_E0_lanczos(mixed=False, ncv=16)
    # the JAX package's key for the same model is the same
    from examples.square_fermi_hubbard import build_factorized

    pmj, _ = build_factorized(4, 2)
    assert pmj._fingerprint() == pm._fingerprint()


def test_basis_files_interchangeable(tmp_path):
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    labels = m.sec_full[0].labels
    pt, pj = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    basis_save(pt, labels)
    jax_basis_save(pj, labels)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    np.testing.assert_array_equal(jax_basis_load(pt), labels)
    np.testing.assert_array_equal(basis_load(pj), labels)
    data = bytearray(open(pt, "rb").read())
    data[40] ^= 0x01
    open(pt, "wb").write(bytes(data))
    with pytest.raises(ValueError):
        basis_load(pt)
    open(pt, "wb").write(bytes(data[:30]))
    with pytest.raises(ValueError):
        basis_load(pt)


FINGERPRINT_MODELS = {
    "chain8": lambda z: z.heisenberg_chain(8),
    "chain8_spin1": lambda z: z.heisenberg_chain(8, "1"),
    "kagome_2x2": lambda z: z.kagome_heisenberg(2, 2),
    "kagome_tj_1x2": lambda z: z.kagome_tj(1, 2),
    "bose_hubbard_2x2": lambda z: z.bose_hubbard_square(2, 2, 2),
    "honeycomb_3x2": lambda z: z.spinless_fermion_honeycomb(3, 2),
    "kondo4": lambda z: z.kondo_chain(4, 4.0),
    "hubbard_2x2": lambda z: z.fermi_hubbard_square(2, 2),
}


@pytest.mark.parametrize("name", sorted(FINGERPRINT_MODELS))
def test_operator_fingerprint_equals_jax(name):
    mt, _ = FINGERPRINT_MODELS[name](tz)
    mj, _ = FINGERPRINT_MODELS[name](jz)
    assert mt._ham_fingerprint() == mj._ham_fingerprint()
    assert operator_fingerprint(mt.compiled_Ham) == jax_fingerprint(
        mj.compiled_Ham)


def test_records_cross_between_the_packages(ckpt_dir, monkeypatch):
    """Stage records and thick-restart records written by one package are
    loaded by the other, under the key it would compute itself."""
    # a stage record of the JAX package, loaded by the port
    mj, cj = jz.heisenberg_chain(12)
    mj.enumerate_basis_full([cj["Sz"]], [0.0])
    mj.locate_E0_lanczos("full", nev=1, ncv=1)
    monkeypatch.setattr(model_mod, "eigs_smallest", _boom)
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    assert m.eigenvals_full[0] == mj.eigenvals_full[0]
    np.testing.assert_array_equal(m.eigenvecs_full[0].numpy(),
                                  np.asarray(mj.eigenvecs_full[0][0]))
    monkeypatch.undo()
    # and the reverse, on another sector index
    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, "enable_ckpt", True)
        monkeypatch.setattr(cfg, "ckpt_dir", str(ckpt_dir))
    monkeypatch.setattr(restarted, "_SAVE_PERIOD", 0.0)
    m.enumerate_basis_full([c["Sz"]], [1.0], sec=1)
    m.locate_E0_lanczos("full", nev=1, ncv=1, sec=1)
    import quantum_basis_tpu.solvers.restarted as jax_restarted

    monkeypatch.setattr(jax_restarted, "eigs_smallest", _boom)
    mj.enumerate_basis_full([cj["Sz"]], [1.0], sec=1)
    mj.locate_E0_lanczos("full", nev=1, ncv=1, sec=1)
    assert mj.eigenvals_full[0] == m.eigenvals_full[0]
    monkeypatch.undo()
    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, "enable_ckpt", True)
        monkeypatch.setattr(cfg, "ckpt_dir", str(ckpt_dir))
    monkeypatch.setattr(restarted, "_SAVE_PERIOD", 0.0)

    # a thick-restart record of the JAX package, resumed by the port
    from test_solvers import _chain_setup as jax_chain_setup

    mvj, Hd, n = jax_chain_setup(10)
    mv, _, _ = _chain_setup(10)
    evals = np.linalg.eigvalsh(Hd)
    with pytest.raises(RuntimeError):
        jax_eigs(mvj, n, nev=2, ncv=8, maxit=9, ckpt_key="cross_a")
    n0 = mv.n_applies
    got, _ = eigs_smallest(mv, n, nev=2, ncv=8, maxit=600, ckpt_key="cross_a",
                           verify_degenerate=False)
    resumed = mv.n_applies - n0
    np.testing.assert_allclose(got, evals[:2], atol=1e-9)
    n0 = mv.n_applies
    eigs_smallest(mv, n, nev=2, ncv=8, maxit=600, verify_degenerate=False)
    assert resumed < mv.n_applies - n0
    # and one of the port, resumed by the JAX package: its first restart
    # line already counts the steps done before the interruption
    with pytest.raises(RuntimeError):
        eigs_smallest(mv, n, nev=2, ncv=8, maxit=9, ckpt_key="cross_b")
    monkeypatch.setattr(jax_config, "solver_log_dir", str(ckpt_dir / "log"))
    got, _ = jax_eigs(mvj, n, nev=2, ncv=8, maxit=600, ckpt_key="cross_b",
                      verify_degenerate=False)
    np.testing.assert_allclose(got, evals[:2], atol=1e-9)
    first = (ckpt_dir / "log" / "log_lanczos.txt").read_text().splitlines()[0]
    assert int(first.split()[2]) > 9
    assert JaxStore(str(ckpt_dir)).load("cross_b") is None
