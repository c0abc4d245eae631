"""Port host helpers and 2-vector solvers against the JAX package.

``dense_matrix`` and ``tridiag_eig`` are the same numpy code: 1e-14.
``lanczos_dynamics`` records the same (a, b) coefficients from the same
start vector to 1e-10 over 24 steps (once Ritz values converge the
recurrence amplifies the rounding differences of the two back ends'
reductions: at 40 steps on the 252-state chain they reach 1e-9).
``lanczos_ground`` E0 agrees with the JAX package and with dense ``eigh`` to
1e-10, its vector to 1e-7 up to a phase (the residual gate is ~1e-8). ``energy_scale`` bounds agree to 1e-8.
``eigenvec_cg`` reaches the same residual class and the same vector. The
checkpoint hooks are not ported: ``ckpt_key`` raises.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from test_torch_apply import MODELS, build_both
from quantum_basis_tpu.ops.dense import dense_matrix as jax_dense_matrix
from quantum_basis_tpu.solvers import cg as jax_cg
from quantum_basis_tpu.solvers import lanczos as jax_lanczos
from quantum_basis_tpu.solvers.tridiag import tridiag_eig as jax_tridiag_eig
from quantum_basis_tpu.utils.rng import vec_randomize as jax_vec_randomize
from quantum_basis_tpu_torch.interop import vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.solvers.cg import eigenvec_cg
from quantum_basis_tpu_torch.solvers.lanczos import (
    energy_scale,
    lanczos_dynamics,
    lanczos_ground,
)
from quantum_basis_tpu_torch.solvers.tridiag import tridiag_eig, tridiag_eigvals
from quantum_basis_tpu_torch.utils.rng import vec_randomize


@pytest.mark.parametrize("name", sorted(MODELS))
def test_dense_matrix_matches_jax(name):
    mj, mt, cplx = build_both(name)
    Hj = jax_dense_matrix(mj.compiled_Ham, mj.sec_full[0].labels)
    Ht = dense_matrix(mt.compiled_Ham, mt.sec_full[0].labels)
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-14)
    assert np.abs(Ht - Ht.conj().T).max() < 1e-14
    assert (np.abs(Ht.imag).max() > 1e-3) == cplx
    # and the device apply is this matrix
    x = np.random.default_rng(2).standard_normal(Ht.shape[0])
    y = mt.sec_full[0].matvec(vec_from_split(x, np.zeros_like(x), device="cpu"))
    np.testing.assert_allclose(y.numpy(), Ht @ x, rtol=0, atol=1e-12)


def test_tridiag_matches_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal(30), np.abs(rng.standard_normal(30)) + 0.1
    ev, sv = tridiag_eig(a, b)
    evj, svj = jax_tridiag_eig(a, b)
    np.testing.assert_allclose(ev, evj, rtol=0, atol=1e-14)
    np.testing.assert_allclose(np.abs(sv), np.abs(svj), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tridiag_eigvals(a, b), ev, rtol=0, atol=1e-12)
    T = np.diag(a) + np.diag(b[:29], 1) + np.diag(b[:29], -1)
    np.testing.assert_allclose(ev, np.linalg.eigvalsh(T), rtol=0, atol=1e-12)
    assert tridiag_eig(a[:1], b[:1])[1].shape == (1, 1)


def _start(n, cplx, seed=3):
    re, im = vec_randomize(n, seed=seed, complex_valued=cplx)
    rj, ij = jax_vec_randomize(n, seed=seed, complex_valued=cplx)
    np.testing.assert_array_equal(re, rj)
    return re, im


@pytest.mark.parametrize("name", ["chain12_Sz0", "dm_chain10_Sz0",
                                  "tj_chain8_N6_Sz0"])
def test_lanczos_dynamics_coefficients(name):
    mj, mt, cplx = build_both(name)
    n = mt.sec_full[0].dim
    re, im = _start(n, cplx)
    aj, bj = jax_lanczos.lanczos_dynamics(
        mj.sec_full[0].matvec,
        (np.asarray(re), None if im is None else np.asarray(im)), 24)
    at, bt = lanczos_dynamics(mt.sec_full[0].matvec, vec_from_split(re, im, device="cpu"),
                              24)
    assert at.shape == bt.shape == (24,)
    np.testing.assert_allclose(at, np.asarray(aj), rtol=0, atol=1e-10)
    np.testing.assert_allclose(bt, np.asarray(bj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["chain12_Sz0", "dm_chain10_Sz0"])
def test_lanczos_ground_matches_jax_and_dense(name):
    mj, mt, cplx = build_both(name)
    st = mt.sec_full[0]
    re, im = _start(st.dim, cplx, seed=1)
    oj = jax_lanczos.lanczos_ground(
        mj.sec_full[0].matvec,
        (np.asarray(re), None if im is None else np.asarray(im)),
        maxit=1500, inner=40)
    ot = lanczos_ground(st.matvec, vec_from_split(re, im, device="cpu"), maxit=1500,
                        inner=40)
    w, U = np.linalg.eigh(dense_matrix(mt.compiled_Ham, st.labels))
    assert abs(ot["E0"] - w[0]) < 1e-10
    assert abs(ot["E0"] - oj["E0"]) < 1e-10
    gate = max(1e3 * 2e-12 * abs(w[0]), 5e-10)
    assert ot["residual"] < gate and oj["residual"] < gate
    assert ot["niter"] <= oj["niter"]  # the port's replay stops early
    v = ot["vector"].numpy()
    vj = np.asarray(oj["vector"][0]) + (
        0.0 if oj["vector"][1] is None else 1j * np.asarray(oj["vector"][1]))
    assert abs(abs(np.vdot(v, U[:, 0])) - 1.0) < 1e-12
    assert abs(abs(np.vdot(v, vj)) - 1.0) < 1e-12
    ph = np.vdot(vj, v)
    np.testing.assert_allclose(v, vj * ph / abs(ph), rtol=0, atol=1e-7)

    # first excited state by deflation ("sr_val1")
    re2, im2 = _start(st.dim, cplx, seed=7)
    o1 = lanczos_ground(st.matvec, vec_from_split(re2, im2, device="cpu"), maxit=3000,
                        inner=40, deflate=(ot["vector"],))
    assert abs(o1["E0"] - w[1]) < 1e-9
    assert abs(torch.vdot(ot["vector"], o1["vector"])) < 1e-9


def test_energy_scale_matches_jax():
    mj, mt, _ = build_both("chain12_Sz0")
    st = mt.sec_full[0]
    re, _ = _start(st.dim, False, seed=5)
    lo_j, hi_j = jax_lanczos.energy_scale(mj.sec_full[0].matvec,
                                          (np.asarray(re), None), m_steps=64)
    lo, hi = energy_scale(st.matvec, vec_from_split(re, device="cpu"), m_steps=64)
    assert abs(lo - lo_j) < 1e-8 and abs(hi - hi_j) < 1e-8
    w = np.linalg.eigvalsh(dense_matrix(mt.compiled_Ham, st.labels))
    assert lo < w[0] and hi > w[-1]
    assert lo > w[0] - 0.2 * (w[-1] - w[0])


@pytest.mark.parametrize("name", ["chain12_Sz0", "dm_chain10_Sz0"])
def test_eigenvec_cg_matches_jax(name):
    mj, mt, cplx = build_both(name)
    st = mt.sec_full[0]
    w, U = np.linalg.eigh(dense_matrix(mt.compiled_Ham, st.labels))
    # a perturbed eigenvector, as a coarser solve would leave it
    rng = np.random.default_rng(8)
    v0 = U[:, 0] + 1e-3 * (rng.standard_normal(st.dim)
                           + (1j * rng.standard_normal(st.dim) if cplx
                              else 0.0))
    split = (np.ascontiguousarray(v0.real),
             np.ascontiguousarray(v0.imag) if cplx else None)
    vj, res_j, it_j = jax_cg.eigenvec_cg(mj.sec_full[0].matvec, w[0], split,
                                         maxit=400, tol=1e-11)
    vt, res_t, it_t = eigenvec_cg(st.matvec, w[0], vec_from_split(*split, device="cpu"),
                                  maxit=400, tol=1e-11)
    assert res_t < 1e-9 and res_j < 1e-9
    assert abs(it_t - it_j) <= 2
    v = vt.numpy()
    assert abs(abs(np.vdot(v, U[:, 0])) - 1.0) < 1e-12
    tr, ti = vec_to_split(vt)
    np.testing.assert_allclose(tr, np.asarray(vj[0]), rtol=0, atol=1e-9)
    if cplx:
        np.testing.assert_allclose(ti, np.asarray(vj[1]), rtol=0, atol=1e-9)


def test_checkpoint_hooks_raise(tmp_path, monkeypatch):
    """The checkpoint hooks are ported (tests/test_torch_ckpt.py): a
    ``ckpt_key`` raises nowhere. With checkpointing off it writes nothing and
    changes nothing; with it on, a finished run leaves no record behind."""
    from quantum_basis_tpu_torch import config

    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))
    mt, ot = tz.heisenberg_chain(8)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    mv = mt.sec_full[0].matvec
    x = vec_from_split(vec_randomize(mv.n, seed=1)[0], device="cpu")
    x = x / torch.linalg.vector_norm(x)
    ref = lanczos_ground(mv, x)
    a_ref, b_ref = lanczos_dynamics(mv, x, 4)
    for on in (False, True):
        monkeypatch.setattr(config, "enable_ckpt", on)
        assert lanczos_ground(mv, x, ckpt_key="k")["E0"] == ref["E0"]
        a, b = lanczos_dynamics(mv, x, 4, ckpt_key="k")
        np.testing.assert_allclose(a, a_ref, rtol=0, atol=1e-14)
        np.testing.assert_allclose(b, b_ref, rtol=0, atol=1e-14)
        _, res, _ = eigenvec_cg(mv, ref["E0"], ref["vector"], ckpt_key="k")
        assert res < 1e-9
        assert not tmp_path.exists() or list(tmp_path.iterdir()) == []
