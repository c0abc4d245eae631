"""The port's full-label-space solve route against the JAX package.

``Model._fullspace_op`` must return the engine the JAX model returns (type
and dtype) for each zoo model, ``None`` once an explicit ELL was asked for
and above the blowup bound. ``eigs_smallest(mask=)`` keeps every Ritz vector
inside the sector. ``locate_E0_lanczos()`` and ``locate_E0_iram()`` through
the engines give the JAX package's eigenvalues to 1e-10 with the same number
of operator applies for the same seed (within one restart cycle where a
level is degenerate). Under ``config.mixed_precision`` (with the
``polish_n`` of ``config.MEMORY`` lowered to reach the large-N branch at
test size) the f32 bulk
+ RQI polish and, forced, the 2-vector Lanczos fallback reach the pure-f64 E0
to 1e-10 under the residual gate; a starved polish raises with ``E0`` and
``residual`` attached. Chain-16 golden E0 = -7.142296361 to 1e-8.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
from quantum_basis_tpu.models import model as jax_model_mod
from quantum_basis_tpu.ops import apply_contract as jax_contract
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.models import model as model_mod
from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
from quantum_basis_tpu_torch.utils.rng import vec_randomize
from test_torch_fullspace import ZOO, build_both

E0_CHAIN16 = -7.142296361


def _gate(e0):
    return max(1e3 * config.lanczos_precision * max(abs(e0), 1.0), 5e-10)


def _residual(mt, sec=0):
    s = mt.sec_full[sec]
    v = s.evecs[0]
    return float(torch.linalg.vector_norm(
        s.matvec(v) - s.evals[0] * v) / torch.linalg.vector_norm(v))


@pytest.fixture
def jax_solver_log(tmp_path, monkeypatch):
    """Counts the JAX solver's Lanczos steps (= operator applies) from its
    per-restart log: the last step count of each thick-restart run, summed."""
    monkeypatch.setattr(qj.config, "solver_log_dir", str(tmp_path))

    def count():
        its = [int(line.split()[2]) for line in
               (tmp_path / "log_lanczos.txt").read_text().splitlines()]
        runs = [its[i] for i in range(len(its))
                if i + 1 == len(its) or its[i + 1] <= its[i]]
        return sum(runs)

    return count


@pytest.mark.parametrize("name", sorted(ZOO))
def test_fullspace_op_routing_matches_jax(name):
    mj, mt = build_both(name)
    sj, st = mj.sec_full[0], mt.sec_full[0]
    for jdt, tdt in (("float64", torch.float64), ("float32", torch.float32)):
        fj = mj._fullspace_op(sj, dtype=jdt)
        ft = mt._fullspace_op(st, dtype=tdt)
        assert type(ft).__name__ == type(fj).__name__ == "ContractOp"
        assert isinstance(ft, ContractOp) and ft.dtype == tdt
        assert str(fj.dtype) == jdt and ft.device == mt.device
        assert mt._fullspace_op(st, dtype=tdt) is ft  # cached per dtype
    assert mt._fullspace_op(st) is mt._fullspace_op(st, dtype=torch.float64)
    # above the blowup bound, and once an explicit ELL was asked for
    big = mt.space.label_space / st.dim
    mj2, mt2 = build_both(name)
    assert mt2._fullspace_op(mt2.sec_full[0], max_blowup=big / 2) is None
    assert mj2._fullspace_op(mj2.sec_full[0], max_blowup=big / 2) is None
    mt.generate_Ham_sparse_full(check=False)
    assert mt._fullspace_op(st) is None
    assert mt._fullspace_op(st, dtype=torch.float32) is None


def test_fullspace_op_falls_back_to_rolls_in_f64_only(monkeypatch):
    """Where the contraction engine cannot take the operator, float64 runs
    on the roll engine and float32 has no engine: the JAX routing."""
    monkeypatch.setattr(model_mod, "supports_contract", lambda c: False)
    monkeypatch.setattr(jax_contract, "supports_contract", lambda c: False)
    monkeypatch.setattr(model_mod, "_DENSE_CUTOFF", 100)  # dim 495
    monkeypatch.setattr(jax_model_mod, "_DENSE_CUTOFF", 100)
    mj, mt = build_both("honeycomb_3x2_N4")
    fj = mj._fullspace_op(mj.sec_full[0])
    ft = mt._fullspace_op(mt.sec_full[0])
    assert type(fj).__name__ == "FullSpaceOp" and isinstance(ft, FullSpaceOp)
    assert mj._fullspace_op(mj.sec_full[0], dtype="float32") is None
    assert mt._fullspace_op(mt.sec_full[0], dtype=torch.float32) is None
    mt.locate_E0_lanczos()
    mj.locate_E0_lanczos()
    assert ft.n_applies > 0 and mt.sec_full[0].matvec.n_applies == 0
    assert abs(mt.eigenvals_full[0] - mj.eigenvals_full[0]) < 1e-10
    # t-J: neither engine (d = 3 and no contraction): the sector's matvec
    _, mtj = build_both("tj_chain8")
    assert mtj._fullspace_op(mtj.sec_full[0]) is None


def test_masked_eigs_keeps_ritz_vectors_in_sector():
    """Chain-12 Sz=1: its lowest level lies above the Sz=0 ground state, so
    an unmasked start vector finds the other sector's state."""
    mt, ot = tz.heisenberg_chain(12)
    mt.enumerate_basis_full([ot["Sz"]], [1.0])
    st = mt.sec_full[0]
    w = np.linalg.eigvalsh(dense_matrix(mt.compiled_Ham, st.labels))
    fs = ContractOp(mt.compiled_Ham, st.labels, dtype=torch.float64,
                    device="cpu")
    vals, vecs = eigs_smallest(fs, fs.N, nev=3, ncv=14, seed=1, mask=fs.mask)
    np.testing.assert_allclose(vals, w[:3], rtol=0, atol=1e-10)
    for v in vecs:
        assert float((v * (1.0 - fs.mask)).abs().max()) < 1e-13
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-12
    # a warm start is projected too
    v0 = torch.as_tensor(vec_randomize(fs.N, seed=4)[0])
    vals_w, vecs_w = eigs_smallest(fs, fs.N, nev=1, ncv=12, mask=fs.mask,
                                   v0=v0)
    assert abs(vals_w[0] - w[0]) < 1e-10
    assert float((vecs_w[0] * (1.0 - fs.mask)).abs().max()) < 1e-13
    free, _ = eigs_smallest(fs, fs.N, nev=1, ncv=12, seed=1)
    assert free[0] < w[0] - 1e-3  # out-of-sector states entered


@pytest.mark.parametrize("name,solver", [
    ("chain12_Sz0", "lanczos"), ("hubbard_4x2_half", "lanczos"),
    ("dm_chain10_Sz0", "lanczos"), ("chain12_Sz0", "iram"),
    ("tj_chain8", "iram")])
def test_solves_through_engines_match_jax(name, solver, jax_solver_log,
                                          monkeypatch):
    mj, mt = build_both(name)
    # dims 252 and 560 lie below the dense cutoff
    monkeypatch.setattr(model_mod, "_DENSE_CUTOFF", 100)
    monkeypatch.setattr(jax_model_mod, "_DENSE_CUTOFF", 100)
    st = mt.sec_full[0]
    fs = mt._fullspace_op(st)
    assert isinstance(fs, ContractOp) and fs.dtype == torch.float64
    if solver == "lanczos":
        mt.locate_E0_lanczos(nev=2, ncv=2)
        mj.locate_E0_lanczos(nev=2, ncv=2)
    else:
        mt.locate_E0_iram(nev=4, ncv=12)
        mj.locate_E0_iram(nev=4, ncv=12)
    np.testing.assert_allclose(mt.eigenvals_full, mj.eigenvals_full,
                               rtol=0, atol=1e-10)
    assert st.matvec.n_applies == 0  # not the sector's matrix-free apply
    if name == "tj_chain8":
        # E1 is a degenerate pair: which vectors of it the deflate-and-verify
        # runs lock onto depends on rounding, and a run may need one restart
        # cycle more or fewer
        assert abs(fs.n_applies - jax_solver_log()) <= 12
    else:
        assert fs.n_applies == jax_solver_log()
    for v in mt.eigenvecs_full:  # sector coordinates, native dtype
        assert v.shape == (st.dim,)
        assert v.dtype == (torch.complex128 if st.matvec.is_complex
                           else torch.float64)
    assert _residual(mt) < _gate(mt.eigenvals_full[0])


@pytest.mark.parametrize("branch", ["thick_restart", "rqi", "lanczos_ground"])
def test_mixed_precision_reaches_f64_e0(branch, monkeypatch):
    mt, ot = tz.heisenberg_chain(14)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    mt.locate_E0_lanczos()
    e_f64 = mt.eigenvals_full[0]
    st = mt.sec_full[0]
    assert torch.float32 not in st._fs_cache

    calls = []
    real_rqi = model_mod.rqi_polish

    def spy_rqi(fs64, v0, fs32, **kw):
        out = real_rqi(fs64, v0, fs32=fs32, **kw)
        calls.append(out)
        if branch == "lanczos_ground":  # RQI reports a stall
            out = dict(out, converged=False,
                       vector=v0 + 1e-3 * torch.roll(v0, 1) * fs64.mask)
        return out

    real_ground = model_mod.lanczos_ground

    def spy_ground(fs, x, **kw):
        calls.append("ground")
        return real_ground(fs, x, **kw)

    monkeypatch.setattr(model_mod, "rqi_polish", spy_rqi)
    monkeypatch.setattr(model_mod, "lanczos_ground", spy_ground)
    monkeypatch.setattr(config, "mixed_precision", True)
    if branch != "thick_restart":
        monkeypatch.setitem(config.MEMORY["cpu"], "polish_n", 1 << 10)
    fs64 = st._fs_cache[torch.float64]
    n64 = fs64.n_applies
    mt.locate_E0_lanczos()
    fs32 = st._fs_cache[torch.float32]
    assert isinstance(fs32, ContractOp) and fs32.dtype == torch.float32
    assert fs32.n_applies > 0
    assert abs(mt.eigenvals_full[0] - e_f64) < 1e-10
    assert mt.eigenvecs_full[0].dtype == torch.float64
    assert _residual(mt) < _gate(e_f64)
    if branch == "thick_restart":
        assert calls == []  # N = 2^14 is below polish_n: f64 thick restart
        assert 0 < fs64.n_applies - n64
    elif branch == "rqi":
        assert len(calls) == 1 and calls[0]["converged"]
        # one f64 apply per RQI outer step, the bulk of the work in f32
        assert fs64.n_applies - n64 == calls[0]["n_outer"] < 8
    else:
        assert calls[-1] == "ground" and len(calls) == 2


def test_polish_gate_raises_when_starved(monkeypatch):
    """A polish that runs out of ``maxit`` above its residual gate must fail
    with E0 and the residual attached, not publish an unconverged E0."""
    mt, ot = tz.heisenberg_chain(16)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    fs = mt._fullspace_op(mt.sec_full[0])
    monkeypatch.setitem(config.MEMORY["cpu"], "polish_n", 1)
    real_ground = model_mod.lanczos_ground
    # maxit=1 still buys one whole cycle; make the cycle short
    monkeypatch.setattr(
        model_mod, "lanczos_ground",
        lambda fs_, x, **kw: real_ground(fs_, x, **{**kw, "inner": 10}))
    v0 = torch.as_tensor(vec_randomize(fs.N, seed=3)[0])
    with pytest.raises(RuntimeError, match="unconverged") as ei:
        model_mod.Model._solve_fullspace(fs, 1, 12, 1, 1, False, None, v0)
    assert ei.value.residual >= _gate(ei.value.E0)
    assert E0_CHAIN16 - 1e-6 < ei.value.E0 < 0.0


def test_chain16_golden_through_contract_engine():
    """Golden E0 and correlator through the engine route
    (src/main_test.cc:88); the eigenvector comes back in sector coordinates
    and the measurement machinery works on it."""
    mt, ot = tz.heisenberg_chain(16)
    dim = mt.enumerate_basis_full([ot["Sz"]], [0.0])
    mt.locate_E0_lanczos(nev=1, ncv=1)
    assert abs(mt.eigenvals_full[0] - E0_CHAIN16) < 1e-8
    assert isinstance(mt._fullspace_op(mt.sec_full[0]), ContractOp)
    assert mt.eigenvecs_full[0].shape == (dim,)
    corr = mt.measure_full_static(tz.sz_pair(0, 1), 0, 0)
    assert abs(corr.real - (-0.1487978408)) < 1e-8


def test_initialize_sets_mixed_precision(monkeypatch):
    monkeypatch.setattr(config, "mixed_precision", False)
    config.initialize(quiet=True)
    assert config.mixed_precision is False
    config.initialize(quiet=True, mixed_precision=True)
    assert config.mixed_precision is True
    assert not hasattr(config, "kron_f32_precision")
    assert torch.backends.cuda.matmul.allow_tf32 is False
