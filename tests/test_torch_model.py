"""The port's explicit momentum-sector route (ELL, BSR kernel) end to end,
against the JAX package and the reference goldens (BASELINE.md).

Both packages solve these sectors as P_k H in the full label space by
default (tests/test_torch_model_repr_fs.py); here that engine is switched
off in both, as tests/test_pallas_bsr.py does for the JAX package, so that
the explicit route, which a tilted cluster or a large blowup takes, is
driven on the chain.

chain-16 k=0 Sz=0 through ``Model.enumerate_basis_repr`` ->
``locate_E0_lanczos(which="repr")`` -> ``measure_repr_static``: E0 =
-7.142296361 and <Sz0 Sz1> = -0.1487978408 to 1e-8, both equal to the JAX
package's values to 1e-10. On the CPU the f32 bulk tier runs the BSR kernel's
plain version.
"""

from __future__ import annotations

import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.models.model import Model as JaxModel
from quantum_basis_tpu.ops.operators import Opr as JaxOpr
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.models.model import Model
from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.sparse import EllMatrix

E0_CHAIN16 = -7.142296361
SZ01_CHAIN16 = -0.1487978408


def _jax_chain(L, k, monkeypatch, prefer_bsr):
    """JAX reference on its explicit-sparse branch (the projected full-space
    fast path switched off, as tests/test_pallas_bsr.py does)."""
    monkeypatch.setattr(jax_config, "prefer_bsr", prefer_bsr)
    monkeypatch.setattr(JaxModel, "_fullspace_repr_op",
                        lambda self, sector, dtype=None: None)
    m, c = jz.heisenberg_chain(L)
    m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
    return m


@pytest.fixture(autouse=True)
def _explicit_route(monkeypatch):
    """The port's projected full-space engine off: the explicit route."""
    monkeypatch.setattr(Model, "_fullspace_repr_op",
                        lambda self, sector, max_blowup=256.0, dtype=None: None)


def _jax_sz01(m):
    sz = jz.SP_HALF["Sz"]
    return m.measure_repr_static(JaxOpr(0, 0, False, sz)
                                 * JaxOpr(1, 0, False, sz), 0)


def test_chain16_k0_bsr_route(monkeypatch):
    monkeypatch.setattr(config, "prefer_bsr", True)
    m, c = tz.heisenberg_chain(16)
    assert m.enumerate_basis_repr([0], [c["Sz"]], [0.0]) == 810
    m.locate_E0_lanczos(which="repr")
    e0 = m.eigenvals_repr[0]
    assert abs(e0 - E0_CHAIN16) < 1e-8
    bsr32 = m.sec_repr[0].bsr32
    assert isinstance(bsr32, BsrMatrix) and bsr32.dtype.itemsize == 4
    sz01 = m.measure_repr_static(tz.sz_pair(0, 1), 0)
    assert abs(sz01.real - SZ01_CHAIN16) < 1e-8 and abs(sz01.imag) < 1e-12

    mj = _jax_chain(16, 0, monkeypatch, True)
    mj.locate_E0_lanczos(which="repr")
    assert abs(e0 - mj.eigenvals_repr[0]) < 1e-10
    assert abs(sz01 - _jax_sz01(mj)) < 1e-10


def test_chain16_k0_default_route_on_cpu(monkeypatch):
    """Without prefer_bsr a CPU model keeps the f64 ELL Krylov route."""
    monkeypatch.setattr(config, "prefer_bsr", None)
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0])
    m.locate_E0_lanczos(which="repr")
    s = m.sec_repr[0]
    assert s.bsr32 is None and isinstance(s.spmv, EllMatrix)
    assert abs(m.eigenvals_repr[0] - E0_CHAIN16) < 1e-8


def test_chain16_k1_two_levels_f64_bsr(monkeypatch):
    """nev=2 forced onto the f64 BSR engine matches the JAX ELL route."""
    monkeypatch.setattr(config, "prefer_bsr", True)
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    m.locate_E0_lanczos(which="repr", nev=2, ncv=2)
    s = m.sec_repr[0]
    assert isinstance(s.spmv, BsrMatrix) and s.spmv.dtype.itemsize == 8
    mj = _jax_chain(16, 1, monkeypatch, None)
    mj.locate_E0_lanczos(which="repr", nev=2, ncv=2)
    assert len(m.eigenvals_repr) == 2
    for a, b in zip(m.eigenvals_repr, mj.eigenvals_repr):
        assert abs(a - b) < 1e-10
    assert abs(m.eigenvals_repr[0] - (-6.523407057)) < 1e-8


@pytest.mark.parametrize("k", [3, 6])
def test_dense_sector_matches_jax(monkeypatch, k):
    """Sectors at or below the dense cutoff are solved densely on the host."""
    m, c = tz.heisenberg_chain(12)
    assert m.enumerate_basis_repr([k], [c["Sz"]], [0.0]) <= 600
    m.locate_E0_lanczos(which="repr")
    mj = _jax_chain(12, k, monkeypatch, None)
    mj.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10
    assert abs(m.measure_repr_static(tz.sz_pair(0, 1), 0)
               - _jax_sz01(mj)) < 1e-10
