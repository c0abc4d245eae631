"""The port's routing bounds, one table per device type (``config.ROUTING``).

The "cpu" table equals the JAX package's values (its config and the default
arguments of ``Model._fullspace_op`` / ``_fullspace_repr_op``), so every CPU
test that compares routes with the JAX package stays valid. The "cuda" table
routes hand-picked sectors as its comments say: the rules run through the
model's own methods on CPU models with the "cuda" values pinned (and, for
the BSR rule, with the model's device type read as "cuda").
"""

from __future__ import annotations

import inspect

import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.models.model import Model as JaxModel
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp

NAMES = ("fullspace_max_blowup", "fullspace_mixed_max_blowup",
         "fullspace_repr_max_blowup", "bsr_blowup_max", "bsr_stored_max_bytes",
         "bsr_auto_max_dim", "kpm_fullspace_max_N", "kron_dense_max_dim")
CUDA = config.ROUTING["cuda"]


def _default(fn, arg):
    return inspect.signature(fn).parameters[arg].default


def test_cpu_table_is_the_jax_packages():
    cpu = config.ROUTING["cpu"]
    assert set(cpu) == set(NAMES) == set(CUDA)
    # the JAX package has one full-sector bound, mixed precision or not
    for name in NAMES[:2]:
        assert cpu[name] == _default(JaxModel._fullspace_op, "max_blowup")
    assert cpu["fullspace_repr_max_blowup"] == _default(
        JaxModel._fullspace_repr_op, "max_blowup")
    for name in NAMES[3:-1]:
        assert cpu[name] == getattr(jax_config, name), name
    # KronOp's layout: the JAX package takes the dense layout at every size
    # where float64 dots are trusted (its CPU), the ELL only where not
    assert not jax_config.use_f64_reduce_dots()
    assert cpu["kron_dense_max_dim"] == float("inf")


def test_route_reads_the_device_type_and_pins_win():
    saved = {t: dict(v) for t, v in config.ROUTING.items()}
    for name in NAMES:
        assert not hasattr(config, name)  # ROUTING is the one source
        assert config.route(name, "cpu") == config.ROUTING["cpu"][name]
        assert config.route(name, torch.device("cuda")) == CUDA[name]
        with config.pinned(**{name: 3.0}, prefer_bsr=True):
            assert config.route(name, "cpu") == config.route(name, "cuda") \
                == 3.0
            assert config.prefer_bsr is True
        assert config.prefer_bsr is None
    assert config.ROUTING == saved
    with pytest.raises(AttributeError):
        with config.pinned(no_such_bound=1.0):
            pass


def test_model_defaults_follow_the_table(monkeypatch):
    """``_fullspace_op`` / ``_fullspace_repr_op`` read their device's entry
    when no ``max_blowup`` is passed."""
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    blowup = m.space.label_space / m.sec_repr[0].dim
    assert isinstance(m._fullspace_repr_op(m.sec_repr[0]), ProjectedFullOp)
    monkeypatch.setitem(config.ROUTING["cpu"], "fullspace_repr_max_blowup",
                        blowup / 2)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    assert m._fullspace_repr_op(m.sec_repr[0]) is None
    m.enumerate_basis_full([c["Sz"]], [0.0])
    assert isinstance(m._fullspace_op(m.sec_full[0]), ContractOp)
    monkeypatch.setitem(config.ROUTING["cpu"], "fullspace_max_blowup", 1.0)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    assert m._fullspace_op(m.sec_full[0]) is None
    # under mixed precision the mixed bound decides, for both precisions
    monkeypatch.setattr(config, "mixed_precision", True)
    for dt in (torch.float64, torch.float32):
        assert isinstance(m._fullspace_op(m.sec_full[0], dtype=dt),
                          ContractOp)
    monkeypatch.setitem(config.ROUTING["cpu"], "fullspace_mixed_max_blowup",
                        1.0)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    assert m._fullspace_op(m.sec_full[0]) is None


def _cuda_pins():
    return config.pinned(**CUDA)


# (model, conserved value, blowup = label space / dim): the full sectors of
# the drivers and the chain-24 sweep of benchmarks/routing.py
FULL = [("chain16", 0.0), ("chain14_up3", -4.0)]


@pytest.mark.parametrize("case", FULL)
def test_cuda_full_sectors_route_by_blowup(case):
    tag, sz = case
    L = 16 if tag == "chain16" else 14
    m, c = tz.heisenberg_chain(L)
    with _cuda_pins():
        dim = m.enumerate_basis_full([c["Sz"]], [sz])
        blowup = m.space.label_space / dim
        fs = m._fullspace_op(m.sec_full[0])
    want = blowup <= CUDA["fullspace_max_blowup"]
    assert (fs is not None) == want, (tag, blowup)


@pytest.mark.parametrize("k", [0, 3])
def test_cuda_momentum_sectors_take_the_explicit_route(k):
    """chain-16 momentum sectors (blowup 81): on the card's table they take
    the explicit ELL, and solve to the same energy as P_k H."""
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
    blowup = m.space.label_space / m.sec_repr[0].dim
    assert blowup > CUDA["fullspace_repr_max_blowup"]
    m.locate_E0_lanczos(which="repr")
    e_pkh = m.eigenvals_repr[0]
    with _cuda_pins():
        m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
        assert m._fullspace_repr_op(m.sec_repr[0]) is None
        m.locate_E0_lanczos(which="repr")
        assert m.sec_repr[0].ell is not None
    assert abs(m.eigenvals_repr[0] - e_pkh) < 1e-10


@pytest.mark.parametrize("case", ["chain16_k0", "kagome_tj22_k00"])
def test_cuda_bsr_rule(case):
    """The BSR bulk-stage rule on the card's table: a sector routes to the
    float32 BSR engine iff its fill-in blowup and stored bytes are inside
    the "cuda" bounds (decided by ``_repr_bsr32`` with the model's device
    type read as "cuda"; the matrices stay on the CPU)."""
    from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats

    if case == "chain16_k0":
        m, c = tz.heisenberg_chain(16)
        m.enumerate_basis_repr([0], [c["Sz"]], [0.0])
    else:
        m, c = tz.kagome_tj(2, 2)
        m.enumerate_basis_repr([0, 0], [c["N"], c["Sz"]], [8.0, 0.0])
    s = m.sec_repr[0]
    st = bsr_fill_stats(m._repr_ell(s))
    want = (st["blowup"] <= CUDA["bsr_blowup_max"]
            and st["stored"] * 8 <= CUDA["bsr_stored_max_bytes"])
    m.device = torch.device("cuda")
    try:
        got = m._repr_bsr32(s)
    finally:
        m.device = torch.device("cpu")
    assert isinstance(got, BsrMatrix) == want, st


def test_cuda_kpm_runs_at_the_sector_dim():
    """KPM on a chain-16 momentum sector (2^16 labels, above the card's
    kpm_fullspace_max_N): on the "cuda" table the recurrence runs on the
    sector's matrix-free MatvecRepr (its dim 810 above bsr_auto_max_dim:
    no ELL is built for a BSR decision), not on P_k H, and gives the P_k H
    moments."""
    from quantum_basis_tpu_torch.benchmarks.routing import SZ_HALF, _sz_q
    from quantum_basis_tpu_torch.examples import kpm_engine_of

    m, c = tz.heisenberg_chain(16)
    assert m.space.label_space > CUDA["kpm_fullspace_max_N"]
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0], sec=0)
    m.locate_E0_lanczos(which="repr", sec=0)
    A = _sz_q(m.lattice, [4], SZ_HALF)
    out = {}
    for table in ("cpu", "cuda"):
        with config.pinned(**config.ROUTING[table]):
            m.enumerate_basis_repr([12], [c["Sz"]], [0.0], sec=1)
            nrm, mu, _, _ = m.measure_repr_dynamic_kpm(A, 0, 1, 32,
                                                       bounds=(-8.0, 6.0))
            out[table] = (kpm_engine_of(m, 1), nrm, mu)
    assert out["cpu"][0] == "ProjectedFullOp"
    assert out["cuda"][0] == "MatvecRepr"
    assert abs(out["cpu"][1] - out["cuda"][1]) < 1e-12
    assert max(abs(a - b) for a, b in zip(out["cpu"][2], out["cuda"][2])) \
        < 1e-10
