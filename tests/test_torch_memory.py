"""The port's memory sizes, one table per device type (``config.MEMORY``).

The "cpu" table equals the JAX package's values (its config, its module
constants and its defaults), so every CPU test that compares the two
packages takes the same branches in both. Every reader takes the value of
its own device's table: a value put into the "cpu" table moves what a CPU
model does, and the "cuda" table, set to the opposite extreme, moves
nothing here. The ``cuda``-marked test holds a model on the card to the
"cuda" values (``python -m pytest --noconftest tests/test_torch_memory.py
-m cuda`` on the GPU machine; JAX is imported only inside the tests that
compare with it).
"""

from __future__ import annotations

import inspect
import math

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.models import model as model_mod
from quantum_basis_tpu_torch.models import product as product_mod
from quantum_basis_tpu_torch.ops import apply_repr as apply_repr_mod
from quantum_basis_tpu_torch.utils.ckpt import CkptStore
from quantum_basis_tpu_torch.utils.rng import vec_randomize

NAMES = ("ckpt_max_bytes", "direct_lookup_max", "apply_block_budget",
         "repr_block_budget", "polish_n", "product_mixed_above",
         "product_ncv")
E0_HUBBARD_4X2 = -14.076058659


def _jax_value(name):
    """The JAX package's value of one memory size."""
    from quantum_basis_tpu import config as jax_config
    from quantum_basis_tpu.models import model as jax_model
    from quantum_basis_tpu.models.product import ProductModel as JaxProduct
    from quantum_basis_tpu.ops import apply as jax_apply
    from quantum_basis_tpu.ops import apply_repr as jax_apply_repr

    return {
        "ckpt_max_bytes": jax_config.ckpt_max_bytes,
        "direct_lookup_max": jax_config.direct_lookup_max,
        "apply_block_budget": jax_apply._BLOCK_BUDGET,
        "repr_block_budget": jax_apply_repr._BLOCK_BUDGET,
        "polish_n": jax_model._POLISH_N,
        # a literal in ProductModel.locate_E0_lanczos,
        # quantum_basis_tpu/models/product.py:167
        "product_mixed_above": 1 << 22,
        "product_ncv": inspect.signature(
            JaxProduct.locate_E0_lanczos).parameters["ncv"].default,
    }[name]


@pytest.mark.parametrize("name", NAMES)
def test_cpu_table_is_the_jax_packages(name):
    assert set(config.MEMORY["cpu"]) == set(NAMES) == set(
        config.MEMORY["cuda"])
    assert config.MEMORY["cpu"][name] == _jax_value(name)
    assert config.memory(name, "cpu") == config.MEMORY["cpu"][name]
    assert config.memory(name, torch.device("cuda")) \
        == config.MEMORY["cuda"][name]


def test_no_module_copy_of_a_size_remains():
    """MEMORY is the one place of every size: no config global and no
    module constant of the old names is left."""
    for name in NAMES:
        assert not hasattr(config, name), name
    assert not hasattr(apply_repr_mod, "_BLOCK_BUDGET")
    assert not hasattr(model_mod, "_POLISH_N")
    assert not hasattr(product_mod, "_MIXED_ABOVE")
    assert inspect.signature(product_mod.ProductModel.locate_E0_lanczos
                             ).parameters["ncv"].default is None


def test_pinned_holds_a_size_in_every_table():
    saved = {t: dict(v) for t, v in config.MEMORY.items()}
    with config.pinned(apply_block_budget=1 << 12, polish_n=3,
                       prefer_bsr=True):
        assert config.memory("apply_block_budget", "cpu") == 1 << 12
        assert config.memory("apply_block_budget", "cuda") == 1 << 12
        assert config.memory("polish_n", "cpu") == \
            config.memory("polish_n", "cuda") == 3
        assert config.prefer_bsr is True
    assert config.MEMORY == saved and config.prefer_bsr is None
    with pytest.raises(RuntimeError):
        with config.pinned(ckpt_max_bytes=1):
            raise RuntimeError
    assert config.MEMORY == saved


def _other_extreme(monkeypatch, name, value):
    """Put ``value`` into the "cpu" table and the opposite extreme into the
    "cuda" table, which a CPU model must not read."""
    monkeypatch.setitem(config.MEMORY["cpu"], name, value)
    monkeypatch.setitem(config.MEMORY["cuda"], name,
                        1 if value > 1 << 20 else 1 << 40)


@pytest.mark.parametrize("budget", [1 << 14, 1 << 20])
def test_block_rows_follow_the_table(monkeypatch, budget):
    m, c = tz.heisenberg_chain(14)
    _other_extreme(monkeypatch, "apply_block_budget", budget)
    dim = m.enumerate_basis_full([c["Sz"]], [-2.0])
    work = max(m.compiled_Ham.nnz_per_row, 1) * m.space.n_slots
    want = min(1 << int(math.log2(max(1024, budget // work))), dim)
    assert m.sec_full[0].dbasis.block_rows == want


@pytest.mark.parametrize("budget", [1 << 12, 1 << 22])
def test_repr_block_rows_follow_the_table(monkeypatch, budget):
    m, c = tz.heisenberg_chain(14)
    _other_extreme(monkeypatch, "repr_block_budget", budget)
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0])
    rb = m.sec_repr[0].dbasis
    per_row = max(m.compiled_Ham.nnz_per_row, 1) * rb.tset.G
    want = 1 << int(math.log2(max(256, budget // per_row)))
    assert rb.block_rows == min(want, rb.n)


@pytest.mark.parametrize("bound, mode", [(1 << 14, "direct"),
                                         ((1 << 14) - 1, "lin")])
def test_lookup_mode_follows_the_table(monkeypatch, bound, mode):
    m, c = tz.heisenberg_chain(14)
    _other_extreme(monkeypatch, "direct_lookup_max", bound)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    idx = m.sec_full[0].dbasis.index
    assert idx.mode == mode
    labels = torch.as_tensor(m.sec_full[0].labels)
    assert torch.equal(idx.lookup(labels), torch.arange(labels.numel()))


@pytest.mark.parametrize("polish_n, rqi", [(1 << 14, False), (1 << 10, True)])
def test_polish_branch_follows_the_table(monkeypatch, polish_n, rqi):
    """The warm-started f64 stage at N = 2^14: a thick restart up to
    polish_n, the RQI polish above it."""
    m, c = tz.heisenberg_chain(14)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    fs = m._fullspace_op(m.sec_full[0])
    fs32 = m._fullspace_op(m.sec_full[0], dtype=torch.float32)
    _other_extreme(monkeypatch, "polish_n", polish_n)
    calls = []
    real = model_mod.rqi_polish
    monkeypatch.setattr(model_mod, "rqi_polish",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    v0 = fs.to_full(torch.as_tensor(
        vec_randomize(m.sec_full[0].dim, seed=3)[0]))
    evals, _ = model_mod.Model._solve_fullspace(
        fs, 1, 12, 400, 1, False, None, v0, fs32)
    assert bool(calls) == rqi
    m.locate_E0_lanczos()
    assert abs(evals[0] - m.eigenvals_full[0]) < 1e-10


@pytest.mark.parametrize("above, ncv", [(1 << 22, 9), (1 << 10, 7)])
def test_product_pipeline_and_ncv_follow_the_table(monkeypatch, above, ncv):
    """Hubbard 4x2 (dim 4,900) with mixed=None and ncv=None: pure f64 up to
    product_mixed_above, the mixed pipeline above it, each at product_ncv."""
    pm, _ = tz.hubbard_factorized(4, 2)
    _other_extreme(monkeypatch, "product_mixed_above", above)
    monkeypatch.setitem(config.MEMORY["cpu"], "product_ncv", ncv)
    monkeypatch.setitem(config.MEMORY["cuda"], "product_ncv", 40)
    seen = []
    real_eigs = product_mod.eigs_smallest
    real_f32 = product_mod.Model._f32_stage_cached
    monkeypatch.setattr(product_mod, "eigs_smallest",
                        lambda *a, **kw: seen.append(("f64", kw["ncv"]))
                        or real_eigs(*a, **kw))
    monkeypatch.setattr(product_mod.Model, "_f32_stage_cached",
                        staticmethod(lambda fs, nev, ncv_, *a: seen.append(
                            ("mixed", ncv_)) or real_f32(fs, nev, ncv_, *a)))
    e0 = pm.locate_E0_lanczos(log=lambda *a: None)
    assert seen == [("mixed" if pm.dim > above else "f64", ncv)]
    assert abs(e0 - E0_HUBBARD_4X2) < 1e-8
    assert pm._last_residual < max(1e3 * config.lanczos_precision * abs(e0),
                                   5e-10)


def test_hubbard_4x2_at_the_tables_defaults_matches_jax():
    """ProductModel(ncv=None, mixed=None) on the CPU: the JAX package's
    E0 with its own defaults, and the golden, to 1e-8."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples"))
    import square_fermi_hubbard as jh

    pm, _ = tz.hubbard_factorized(4, 2)
    e0 = pm.locate_E0_lanczos(ncv=None, log=lambda *a: None)
    pj, _ = jh.build_factorized(4, 2)
    assert abs(e0 - pj.locate_E0_lanczos()) < 1e-8
    assert abs(e0 - E0_HUBBARD_4X2) < 1e-8


@pytest.mark.parametrize("fits", [True, False])
def test_product_completion_record_under_the_cap(tmp_path, monkeypatch, fits):
    """A finished product solve writes its completion record when the
    eigenvector fits under the device's ckpt_max_bytes; a second model of
    the same Hamiltonian then resumes from it with no apply. Past the cap
    nothing is written and the second model solves again."""
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))
    pm, _ = tz.hubbard_factorized(4, 2)
    nbytes = pm.dim * 8
    _other_extreme(monkeypatch, "ckpt_max_bytes",
                   nbytes if fits else nbytes - 1)
    e0 = pm.locate_E0_lanczos(mixed=False, log=lambda *a: None)
    key = f"prodE0_{pm.na}x{pm.nb}_nev1_h{pm._fingerprint():08x}"
    rec = CkptStore(str(tmp_path)).load(key)
    assert (rec is not None) == fits
    pm2, _ = tz.hubbard_factorized(4, 2)
    assert pm2.locate_E0_lanczos(mixed=False, log=lambda *a: None) == e0
    applies = sum(op.n_applies for op in pm2._ops.values())
    if fits:
        assert applies == 0 and pm2._last_residual == pm._last_residual
        assert torch.equal(pm2.eigenvecs[0], pm.eigenvecs[0])
    else:
        assert applies > 0


def test_gaps_driver_resumes_finished_sectors(tmp_path):
    """hubbard4x4_gaps with a checkpoint directory: a second run resumes
    every sector from its completion record with no apply, same gaps."""
    from quantum_basis_tpu_torch.benchmarks import hubbard4x4_gaps

    kw = dict(device="cpu", ckpt_dir=str(tmp_path / "ckpt"))
    first = hubbard4x4_gaps.main(4, 2, out=str(tmp_path / "a.json"), **kw)
    again = hubbard4x4_gaps.main(4, 2, out=str(tmp_path / "b.json"), **kw)
    for key, rec in again["sectors"].items():
        assert first["sectors"][key]["applies"] > 0
        assert rec["applies"] == 0 and rec["gate_passed"], key
        assert rec["E0"] == first["sectors"][key]["E0"]
    assert again["spin_gap"] == first["spin_gap"]
    assert again["charge_gap"] == first["charge_gap"]
    assert not config.enable_ckpt


@pytest.mark.cuda
def test_cuda_models_use_the_cuda_table(monkeypatch):
    """On the card, chain-24 Sz=-4's DeviceBasis has the block rows of the
    "cuda" apply_block_budget and the lookup of its direct_lookup_max, and
    a ProductModel (Hubbard 4x2) takes the pipeline and ncv of the "cuda"
    product_mixed_above and product_ncv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    m, c = tz.heisenberg_chain(24, device="cuda")
    dim = m.enumerate_basis_full([c["Sz"]], [-4.0])
    db = m.sec_full[0].dbasis
    work = max(m.compiled_Ham.nnz_per_row, 1) * m.space.n_slots
    budget = config.memory("apply_block_budget", "cuda")
    want = min(1 << int(math.log2(max(1024, budget // work))), dim)
    assert db.block_rows == want
    assert (db.index.mode == "direct") == (
        m.space.label_space <= config.memory("direct_lookup_max", "cuda"))
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(dim),
                        device="cuda")
    assert torch.isfinite(m.sec_full[0].matvec(x)).all()
    del m, db, x

    pm, _ = tz.hubbard_factorized(4, 2, device="cuda")
    seen = []
    real_eigs = product_mod.eigs_smallest
    real_f32 = product_mod.Model._f32_stage_cached
    monkeypatch.setattr(product_mod, "eigs_smallest",
                        lambda *a, **kw: seen.append(("f64", kw["ncv"]))
                        or real_eigs(*a, **kw))
    monkeypatch.setattr(product_mod.Model, "_f32_stage_cached",
                        staticmethod(lambda fs, nev, ncv_, *a: seen.append(
                            ("mixed", ncv_)) or real_f32(fs, nev, ncv_, *a)))
    e0 = pm.locate_E0_lanczos(log=lambda *a: None)
    mixed = pm.dim > config.memory("product_mixed_above", "cuda")
    ncv = config.memory("product_ncv", "cuda")
    assert seen == [("mixed" if mixed else "f64", max(ncv, 6) if not mixed
                     else ncv)]
    assert abs(e0 - E0_HUBBARD_4X2) < 1e-8
