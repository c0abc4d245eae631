"""The port's full-sector slice end to end on the CPU, against the JAX
package and the reference goldens.

``Model.enumerate_basis_full`` -> ``locate_E0_lanczos`` / ``locate_E0_iram``
/ ``locate_Emax_iram`` -> ``measure_full_static``. Chain-12 Sz=0: E0 =
-5.387390917445 to 1e-10 through the matrix-free, explicit-ELL and dense
routes; f64 eigenvalues within 1e-10 of the JAX ``Model``. These tests hold
the branch that solves on the sector's own matvec, so the full-label-space
engines are switched off in both packages (tests/test_torch_model_mixed.py
holds the engine route); expectation values within 1e-10 of the JAX package
when its eigenvector is carried across through ``interop``. Eigenvectors of a
degenerate pair are compared through their projector, never raw.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
import quantum_basis_tpu_torch as qt
from test_torch_apply import build_both
from quantum_basis_tpu.models.model import Model as JaxModel
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.interop import full_sector_from_numpy, vec_to_split
from quantum_basis_tpu_torch.models import model as model_mod
from quantum_basis_tpu_torch.ops.apply import MatvecFull
from quantum_basis_tpu_torch.ops.sparse import EllMatrix

E0_CHAIN12 = -5.387390917445


@pytest.fixture
def jax_sector_route(monkeypatch):
    """Both Models on the branch without a full-label-space engine:
    thick-restart Lanczos on the sector's own matvec (the JAX package's
    models/model.py:551-556)."""
    for cls in (JaxModel, qt.Model):
        monkeypatch.setattr(
            cls, "_fullspace_op",
            lambda self, sector, max_blowup=64.0, dtype=None: None)


def _np(v: torch.Tensor) -> np.ndarray:
    return v.numpy()


def _jnp(v) -> np.ndarray:
    return np.asarray(v[0]) + (0.0 if v[1] is None else 1j * np.asarray(v[1]))


def test_default_which_is_full_and_device_default():
    for fn in (qt.Model.locate_E0_lanczos, qt.Model.locate_E0_iram,
               qt.Model.locate_Emax_iram):
        assert inspect.signature(fn).parameters["which"].default == "full"
        jfn = getattr(JaxModel, fn.__name__)
        for name in ("nev", "ncv", "maxit", "sec", "seed"):
            assert (inspect.signature(fn).parameters[name].default
                    == inspect.signature(jfn).parameters[name].default)
    assert inspect.signature(qt.Model).parameters["device"].default == "cuda"


@pytest.mark.parametrize("route", ["matrix_free", "ell", "dense"])
def test_chain12_e0_three_routes(route, monkeypatch, jax_sector_route):
    mt, ot = tz.heisenberg_chain(12)
    mj, oj = jz.heisenberg_chain(12)
    assert mt.enumerate_basis_full([ot["Sz"]], [0.0]) == 924
    assert mt.dim_full() == 924 == mj.enumerate_basis_full([oj["Sz"]], [0.0])
    s = mt.sec_full[0]
    if route == "dense":
        monkeypatch.setattr(model_mod, "_DENSE_CUTOFF", 1000)
    elif route == "ell":
        mt.generate_Ham_sparse_full(check="exact")
        mj.generate_Ham_sparse_full(check="exact")
        assert isinstance(s.matvec, EllMatrix)
    else:
        assert isinstance(s.matvec, MatvecFull)
    mt.locate_E0_lanczos(nev=2, ncv=2)  # the default which is "full"
    mj.locate_E0_lanczos(nev=2, ncv=2)
    assert abs(mt.eigenvals_full[0] - E0_CHAIN12) < 1e-10
    assert len(mt.eigenvals_full) == 2 and len(mt.eigenvecs_full) == 2
    np.testing.assert_allclose(mt.eigenvals_full, mj.eigenvals_full[:2],
                               rtol=0, atol=1e-10)
    if route != "dense":
        assert s.matvec.n_applies > 0
    # non-degenerate levels: the vectors agree up to a sign
    for vt, vj in zip(mt.eigenvecs_full, mj.eigenvecs_full):
        assert not vt.is_complex() and vt.dtype == torch.float64
        assert abs(abs(np.vdot(_jnp(vj), _np(vt))) - 1.0) < 1e-9
    sz01 = mt.measure_full_static(tz.sz_pair(0, 1), 0, 0)
    assert abs(sz01.real - E0_CHAIN12 / 36.0) < 1e-9 and sz01.imag == 0.0


def test_complex_hamiltonian_matches_jax(jax_sector_route):
    """The DM chain (complex amplitudes), L=12: matrix-free and ELL."""
    mt, ot = tz.dm_chain(12, 0.3)
    mj, oj = tz.dm_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 12, 0.3)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    mj.enumerate_basis_full([oj["Sz"]], [0.0])
    mt.locate_E0_lanczos(nev=2, ncv=1)
    mj.locate_E0_lanczos(nev=2, ncv=1)
    e_free = list(mt.eigenvals_full)
    np.testing.assert_allclose(e_free, mj.eigenvals_full[:2], rtol=0,
                               atol=1e-10)
    assert mt.eigenvecs_full[0].is_complex() and len(mt.eigenvecs_full) == 1
    ell = mt.generate_Ham_sparse_full()
    assert ell.is_complex
    mt.locate_E0_lanczos(nev=2)
    np.testing.assert_allclose(mt.eigenvals_full, e_free, rtol=0, atol=1e-10)
    # <S+_0 S-_1> has an imaginary part here; compare with the JAX value
    # on the JAX eigenvector carried into the port
    op_t = qt.Opr(0, 0, False, tz.SP_HALF["Sp"]) * qt.Opr(
        1, 0, False, tz.SP_HALF["Sm"])
    op_j = qj.Opr(0, 0, False, tz.SP_HALF["Sp"]) * qj.Opr(
        1, 0, False, tz.SP_HALF["Sm"])
    want = mj.measure_full_static(op_j, 0, 0)
    assert abs(want.imag) > 1e-3
    own = mt.measure_full_static(op_t, 0, 0)
    assert abs(own - want) < 1e-8  # two solves of the same state
    mc, _ = tz.dm_chain(12, 0.3)
    full_sector_from_numpy(mc, mj.sec_full[0].labels, mj.eigenvals_full,
                           mj.sec_full[0].evecs)
    assert abs(mc.measure_full_static(op_t, 0, 0) - want) < 1e-10


def test_tj8_iram_degenerate_pair(jax_sector_route, monkeypatch):
    """t-J chain-8, N=6, Sz=0 (dim 560, solved iteratively here): the
    deflate-and-verify pass must find both copies of the degenerate E1."""
    import test_golden_chain as g

    mt, ot = tz.tj_chain(8)
    mj, szj, nj = g.build_tj_chain(8)
    assert mt.enumerate_basis_full([ot["Sz"], ot["N"]], [0.0, 6.0]) == 560
    mj.enumerate_basis_full([szj, nj], [0.0, 6.0])
    st = mt.sec_full[0]
    H = model_mod.dense_matrix(mt.compiled_Ham, st.labels)
    w, U = np.linalg.eigh(H)
    assert abs(w[1] - w[2]) < 1e-10 < abs(w[0] - w[1])  # a degenerate pair

    monkeypatch.setattr(model_mod, "_DENSE_CUTOFF", 100)
    mt.locate_E0_iram("full", nev=4, ncv=12)
    assert st.matvec.n_applies > 0
    mj.locate_E0_iram("full", nev=4, ncv=12)  # dense in the JAX package
    np.testing.assert_allclose(mt.eigenvals_full, w[:4], rtol=0, atol=1e-9)
    np.testing.assert_allclose(mt.eigenvals_full, mj.eigenvals_full[:4],
                               rtol=0, atol=1e-9)
    assert st.evals == mt.eigenvals_full and mt._e0_sec == 0
    # the projector onto the pair, not the raw vectors
    V = np.stack([_np(v) for v in mt.eigenvecs_full[1:3]], axis=1)
    P = V @ V.conj().T
    Pref = U[:, 1:3] @ U[:, 1:3].conj().T
    assert np.abs(P - Pref).max() < 1e-6


@pytest.mark.parametrize("which", ["full", "repr"])
def test_locate_emax_and_e0_iram(which, jax_sector_route, monkeypatch):
    mt, ot = tz.heisenberg_chain(14)
    mj, oj = jz.heisenberg_chain(14)
    if which == "full":
        mt.enumerate_basis_full([ot["Sz"]], [0.0])
        mj.enumerate_basis_full([oj["Sz"]], [0.0])
    else:
        monkeypatch.setattr(JaxModel, "_fullspace_repr_op",
                            lambda self, sector, dtype=None: None)
        monkeypatch.setattr(config, "prefer_bsr", True)  # the f64 BSR engine
        mt.enumerate_basis_repr([0], [ot["Sz"]], [0.0])
        mj.enumerate_basis_repr([0], [oj["Sz"]], [0.0])
    top = mt.locate_Emax_iram(which, nev=2)
    top_j = mj.locate_Emax_iram(which, nev=2)
    np.testing.assert_allclose(top, top_j, rtol=0, atol=1e-10)
    assert abs(top[0] - 3.5) < 1e-10  # the ferromagnetic multiplet, L/4
    mt.locate_E0_iram(which, nev=3, ncv=10)
    mj.locate_E0_iram(which, nev=3, ncv=10)
    got = mt.eigenvals_full if which == "full" else mt.eigenvals_repr
    want = mj.eigenvals_full if which == "full" else mj.eigenvals_repr
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    if which == "repr":
        from quantum_basis_tpu_torch.ops.bsr import BsrMatrix

        spmv = mt.sec_repr[0].spmv
        assert isinstance(spmv, BsrMatrix) and spmv.dtype == torch.float64


def test_measure_full_static_chained_list(jax_sector_route):
    """A chained operator list on a fermionic model, the JAX eigenvector
    carried across: c^dag_{0,up} c_{2,up} applied after n_1, and a
    number-changing pair (c_{1,dn} then c^dag_{3,dn}) whose intermediate
    state leaves the sector and is dropped."""
    mj, mt, _ = build_both("kondo4_N4_Sz0")
    mj.locate_E0_lanczos(nev=1)
    sj = mj.sec_full[0]
    st = full_sector_from_numpy(mt, sj.labels, mj.eigenvals_full, sj.evecs)
    assert st.dim == sj.dim and st.evals == list(mj.eigenvals_full)

    def ops(mod, zoo):
        cu0, cu2 = (mod.Opr(0, 0, True, zoo.C_UP),
                    mod.Opr(2, 0, True, zoo.C_UP))
        cd1, cd3 = (mod.Opr(1, 0, True, zoo.C_DN),
                    mod.Opr(3, 0, True, zoo.C_DN))
        n1 = cd1.dagger() * cd1
        return {"hop_after_n": [cu0.dagger() * cu2, n1],
                "single": (0.5 + 0.25j) * (cu0.dagger() * cu2),
                "leaves_sector": [cd3.dagger(), cd1],
                "SzSz": mod.Opr(0, 1, False, zoo.SP_HALF["Sz"])
                * mod.Opr(1, 1, False, zoo.SP_HALF["Sz"])}

    oj, ot = ops(qj, jz), ops(qt, tz)
    for name in oj:
        want = mj.measure_full_static(oj[name], 0, 0)
        got = mt.measure_full_static(ot[name], 0, 0)
        assert abs(got - want) < 1e-10, name
    assert abs(mj.measure_full_static(oj["hop_after_n"], 0, 0)) > 1e-3
    assert mt.measure_full_static(ot["leaves_sector"], 0, 0) == 0.0
    # H itself: <H> = E0
    e0 = mt.measure_full_static(mt.Ham, 0, 0)
    assert abs(e0.real - mj.eigenvals_full[0]) < 1e-9


def test_unported_routes_name_their_slice(monkeypatch, tmp_path):
    mt, ot = tz.heisenberg_chain(8)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    # the basis mesh is ported (tests/test_torch_model_mesh.py); a mesh
    # that is not a BasisMesh is refused
    with pytest.raises(TypeError, match="BasisMesh"):
        qt.Model(mesh=object())
    # the variational sector is ported (tests/test_torch_vrnl.py): both
    # solvers run it; the other solvers refuse it
    mt.build_basis_vrnl([1], 0, [0.0], [0.0], 3, [ot["Sz"]], [3.0], sec=1)
    mt.locate_E0_lanczos("vrnl", sec=1)
    mt.locate_E0_iram("vrnl", nev=1, sec=1)
    # one magnon at k = 0 over the all-up chain of 8: L/4 - 1 + cos 0
    assert mt.eigenvals_vrnl == pytest.approx([2.0], abs=1e-12)
    with pytest.raises(ValueError, match="variational"):
        mt.locate_Emax_iram("vrnl")
    with pytest.raises(ValueError):
        mt.locate_E0_lanczos("half")
    # dynamics and interior windows are ported (tests/test_torch_dynamics.py)
    # and so is checkpointing (tests/test_torch_ckpt.py): no raise; a dense
    # sector writes no record
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))
    mt.locate_E0_lanczos()
    assert not list(tmp_path.iterdir())


def test_exports_follow_the_jax_package():
    import importlib

    assert set(qj.__all__) == set(qt.__all__)
    for name in qt.__all__:
        assert hasattr(qt, name)
    # every subpackage exports the JAX subpackage's names (lattice a
    # superset: TiltedLattice)
    for sub in ("ops", "basis", "models", "utils", "lattice", "solvers",
                "parallel"):
        jax_sub = importlib.import_module(f"quantum_basis_tpu.{sub}")
        port_sub = importlib.import_module(f"quantum_basis_tpu_torch.{sub}")
        assert set(jax_sub.__all__) <= set(port_sub.__all__), sub
        for name in jax_sub.__all__:
            assert getattr(port_sub, name).__name__ == name, (sub, name)
