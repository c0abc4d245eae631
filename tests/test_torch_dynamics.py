"""Dynamics through the port's ``Model`` against the JAX package's.

Each case solves its ground state in the port and hands the same vector to
the JAX model, so the two packages' measurements see one phi:

- ``measure_full_dynamic`` / ``measure_repr_dynamic`` (continued fractions):
  norms and (alphas, betas) to 1e-10 up to the Krylov breakdown, cut as
  ``tests/test_dynamics.py::_compare_contfrac`` cuts them, on chain-10
  Sz(q=3), the sector-changing S^-(q=1) of chain-8 and the fermionic c_up(q)
  of the kagome t-J 2x2 cluster; the port's full and momentum-sector results
  agree with each other as in the JAX package's own test.
- ``measure_full_dynamic_kpm`` / ``measure_repr_dynamic_kpm``: the projected
  full-space fast path and the ELL fallback (``kpm_fullspace_max_N = 1``) to
  1e-10; the fallback on the float32 BSR engine (``prefer_bsr``, the plain
  version on the CPU) to 5e-5 against the JAX ELL fallback.
- ``locate_Es`` to 1e-10, and to dense ``eigh``.
- The zero-norm guard: an A that annihilates phi gives a zero norm and no
  coefficients from all four methods (the JAX ``measure_repr_dynamic``
  divides by the zero norm instead).
- The slice on a tilted cluster of 10 sites (no full-space engine): S(q, w)
  moments at all 10 momenta through the BSR fallback, with
  sum_q norm_q^2 = N/4 to 1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import models_zoo as jz
import torch_zoo as tz
from test_dynamics import _compare_contfrac
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp
from quantum_basis_tpu_torch.solvers.chebyshev import kpm_moments


def _aq(pkg, sites, phases, mat, fermion=False):
    """A = sum_s phase_s / sqrt(N) O_s with the given package's classes."""
    out = pkg.Mopr()
    for s, ph in zip(sites, phases):
        out += (ph / np.sqrt(len(sites))) * pkg.Opr(s, 0, fermion, mat)
    return out


def _chain_aq(pkg, L, q, mat):
    x = np.arange(L)
    return _aq(pkg, x, np.exp(-2j * np.pi * q * x / L), mat)


def _give_jax(mj, mt, which, sec=0):
    """Hand the port's eigenvector of ``sec`` to the JAX model's sector."""
    st = (mt.sec_full if which == "full" else mt.sec_repr)[sec]
    sj = (mj.sec_full if which == "full" else mj.sec_repr)[sec]
    v = st.evecs[0].numpy()
    sj.evecs = [(jnp.asarray(v.real.copy()),
                 jnp.asarray(v.imag.copy()) if np.iscomplexobj(v) else None)]


def _chain10_szq(mj, mt, oj, ot):
    L, q, k0 = 10, 3, 5       # the L = 10 ground state sits at k = pi
    full = ([0.0], [0.0])
    repr_ = ([k0], [0.0], [(k0 - q) % L], [0.0])
    return "Sz", full, repr_, (
        _chain_aq(jz, L, q, jz.SP_HALF["Sz"]),
        _chain_aq(tz, L, q, tz.SP_HALF["Sz"])), 9, 1e-8


def _chain8_smq(mj, mt, oj, ot):
    L, q = 8, 1
    return "Sz", ([0.0], [-1.0]), ([0], [0.0], [(-q) % L], [-1.0]), (
        _chain_aq(jz, L, q, jz.SP_HALF["Sm"]),
        _chain_aq(tz, L, q, tz.SP_HALF["Sm"])), 10, 1e-8


def _kagome_cup(mj, mt, oj, ot):
    lat = mt.lattice
    sites = range(lat.n_sites)
    ph = [np.exp(-2j * np.pi * lat.site2coor(s)[0][0] / 2) for s in sites]
    return "NSz", ([8.0, 0.0], [7.0, -0.5]), (
        [0, 0], [8.0, 0.0], [1, 0], [7.0, -0.5]), (
        _aq(jz, sites, ph, jz.TJ_C_UP, fermion=True),
        _aq(tz, sites, ph, tz.TJ_C_UP, fermion=True)), 8, 1e-7


CASES = {
    "chain10_Szq3": (lambda z, **kw: z.heisenberg_chain(10, **kw),
                     _chain10_szq),
    "chain8_Smq1": (lambda z, **kw: z.heisenberg_chain(8, **kw),
                    _chain8_smq),
    "kagome_tj22_cup": (lambda z, **kw: z.kagome_tj(2, 2, **kw), _kagome_cup),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_contfrac_full_and_repr_match_jax(name, monkeypatch):
    build, case = CASES[name]
    mj, oj = build(jz)
    mt, ot = build(tz, device="cpu")
    qn, (v0, v1), (k0, r0, k1, r1), (Aj, At), m_steps, atol_fr = case(
        mj, mt, oj, ot)
    cons_j = [oj["N"], oj["Sz"]] if qn == "NSz" else [oj["Sz"]]
    cons_t = [ot["N"], ot["Sz"]] if qn == "NSz" else [ot["Sz"]]
    # full sectors: the ground state on the explicit ELL (fast on the CPU)
    for sec, vals in ((0, v0), (1, v1)):
        mt.enumerate_basis_full(cons_t, vals, sec=sec)
        mj.enumerate_basis_full(cons_j, vals, sec=sec)
    mt.generate_Ham_sparse_full(0)
    mt.locate_E0_lanczos("full", sec=0)
    _give_jax(mj, mt, "full")
    full_t = mt.measure_full_dynamic(At, 0, 1, m_steps)
    full_j = mj.measure_full_dynamic(Aj, 0, 1, m_steps)
    _compare_contfrac(*full_j, *full_t, atol=1e-10)

    # momentum sectors, the ground state on the explicit route
    mt.enumerate_basis_repr(k0, cons_t, r0, sec=0)
    mt.enumerate_basis_repr(k1, cons_t, r1, sec=1)
    mj.enumerate_basis_repr(k0, cons_j, r0, sec=0)
    mj.enumerate_basis_repr(k1, cons_j, r1, sec=1)
    monkeypatch.setattr(mt, "_fullspace_repr_op", lambda *a, **k: None)
    mt.locate_E0_lanczos("repr", sec=0)
    assert abs(mt.eigenvals_repr[0] - mt.eigenvals_full[0]) < 1e-9
    _give_jax(mj, mt, "repr")
    repr_t = mt.measure_repr_dynamic(At, 0, 1, m_steps)
    repr_j = mj.measure_repr_dynamic(Aj, 0, 1, m_steps)
    _compare_contfrac(*repr_j, *repr_t, atol=1e-10)
    # the same resolvent in both bases
    _compare_contfrac(*full_t, *repr_t, atol=atol_fr)


def _chain10_pair():
    """Chain-10 in both packages: ground state at k = 5 (handed from the
    port to the JAX model) and the target sector k = 2 of Sz(q = 3)."""
    mj, oj = jz.heisenberg_chain(10)
    mt, ot = tz.heisenberg_chain(10, device="cpu")
    for m, o in ((mj, oj), (mt, ot)):
        m.enumerate_basis_repr([5], [o["Sz"]], [0.0], sec=0)
        m.enumerate_basis_repr([2], [o["Sz"]], [0.0], sec=1)
        m.enumerate_basis_full([o["Sz"]], [0.0], sec=0)
    mt.locate_E0_lanczos("repr", sec=0)
    mt.locate_E0_lanczos("full", sec=0)
    _give_jax(mj, mt, "repr")
    _give_jax(mj, mt, "full")
    return mj, mt


@pytest.mark.parametrize("route", ["fullspace", "ell", "bsr32"])
def test_kpm_routes_match_jax(route, monkeypatch):
    bounds = (-8.0, 8.0)
    if route != "fullspace":
        monkeypatch.setitem(config.ROUTING["cpu"], "kpm_fullspace_max_N", 1)
        monkeypatch.setattr(jax_config, "kpm_fullspace_max_N", 1)
    if route == "bsr32":
        monkeypatch.setattr(config, "prefer_bsr", True)
    mj, mt = _chain10_pair()
    if route == "ell":
        mj.generate_Ham_sparse_repr(1)
        mt.generate_Ham_sparse_repr(1)
    Aj = _chain_aq(jz, 10, 3, jz.SP_HALF["Sz"])
    At = _chain_aq(tz, 10, 3, tz.SP_HALF["Sz"])
    nj, muj, lo_j, hi_j = mj.measure_repr_dynamic_kpm(Aj, 0, 1, 24,
                                                      bounds=bounds)
    nt, mu, lo, hi = mt.measure_repr_dynamic_kpm(At, 0, 1, 24, bounds=bounds)
    dst = mt.sec_repr[1]
    assert (lo, hi) == bounds and abs(nt - nj) < 1e-12 and nt > 0.1
    assert mu.dtype == np.float64 and mu.shape == (24,)
    if route == "fullspace":
        assert isinstance(mt._fullspace_repr_op(dst), ProjectedFullOp)
        assert dst.ell is None
    if route == "bsr32":
        assert isinstance(dst.bsr32, BsrMatrix)
        assert dst.bsr32.dtype == torch.float32
        np.testing.assert_allclose(mu, muj, rtol=0, atol=5e-5)
    else:
        assert dst.bsr32 is None
        np.testing.assert_allclose(mu, muj, rtol=0, atol=1e-10)
    if route == "fullspace":
        # the full sector, bounds from energy_scale on both sides
        fj = mj.measure_full_dynamic_kpm(Aj, 0, 0, 24)
        ft = mt.measure_full_dynamic_kpm(At, 0, 0, 24)
        assert abs(ft[0] - fj[0]) < 1e-12
        assert abs(ft[2] - fj[2]) < 1e-10 and abs(ft[3] - fj[3]) < 1e-10
        np.testing.assert_allclose(ft[1], fj[1], rtol=0, atol=1e-10)


@pytest.mark.parametrize("which", ["full", "repr"])
def test_locate_Es_matches_jax_and_dense(which):
    mj, oj = jz.heisenberg_chain(8)
    mt, ot = tz.heisenberg_chain(8, device="cpu")
    for m, o in ((mj, oj), (mt, ot)):
        if which == "full":
            m.enumerate_basis_full([o["Sz"]], [0.0])
        else:
            m.enumerate_basis_repr([0], [o["Sz"]], [0.0])
    if which == "full":
        s = mt.sec_full[0]
        evals = np.linalg.eigvalsh(dense_matrix(mt.compiled_Ham, s.labels))
    else:
        s = mt.sec_repr[0]
        ell = mt._repr_ell(s)
        evals = np.linalg.eigvalsh(np.stack([
            ell(e).numpy() for e in torch.eye(s.dim, dtype=torch.complex128)]))
    lo, hi = evals[1] - 1e-6, evals[3] + 1e-6
    kw = dict(which=which, nev_max=4, degree=120)
    got = mt.locate_Es(lo, hi, **kw)
    got_j = mj.locate_Es(lo, hi, **kw)
    want = evals[(evals >= lo) & (evals <= hi)]
    assert len(got) == len(got_j) == want.size
    np.testing.assert_allclose(got, got_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    vals = mt.eigenvals_full if which == "full" else mt.eigenvals_repr
    assert vals == got and len(s.evecs) == len(got)
    mv = s.matvec if which == "full" else mt._repr_spmv(s)
    for t, v in zip(got, s.evecs):
        assert float(torch.linalg.vector_norm(mv(v) - t * v)) < 1e-6


def test_zero_norm_guard():
    """Sz(q=0) annihilates an Sz = 0 ground state: every method returns a
    zero norm and no coefficients, never NaN."""
    mt, ot = tz.heisenberg_chain(8, device="cpu")
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    mt.enumerate_basis_repr([0], [ot["Sz"]], [0.0], sec=0)
    mt.locate_E0_lanczos("full")
    mt.locate_E0_lanczos("repr")
    A = _chain_aq(tz, 8, 0, tz.SP_HALF["Sz"])
    for out in (mt.measure_full_dynamic(A, 0, 0, 10),
                mt.measure_repr_dynamic(A, 0, 0, 10)):
        assert out[0] == 0.0 and out[1].size == 0 and out[2].size == 0
    for out in (mt.measure_full_dynamic_kpm(A, 0, 0, 16),
                mt.measure_repr_dynamic_kpm(A, 0, 0, 16)):
        assert out == (0.0, out[1], 0.0, 0.0) and out[1].size == 0


def test_tilted10_sqw_through_the_bsr_fallback(monkeypatch):
    """All 10 momenta of the tilted cluster A = [[3,1],[-1,3]] from its
    ground-state sector: the target sectors have no full-space engine, so
    the moments run on the float32 BSR engine; sum_q norm^2 = N/4."""
    A = [[3, 1], [-1, 3]]
    m, c = tz.tilted_heisenberg(A)
    momenta = tz.tilted_momenta(A)
    assert len(momenta) == 10
    e0 = []
    for k in momenta:
        m.enumerate_basis_repr(list(k), [c["Sz"]], [0.0], sec=0)
        m.locate_E0_lanczos("repr", sec=0)
        e0.append(m.eigenvals_repr[0])
    k0 = np.asarray(momenta[int(np.argmin(e0))])
    m.enumerate_basis_repr(list(k0), [c["Sz"]], [0.0], sec=0)
    m.locate_E0_lanczos("repr", sec=0)
    monkeypatch.setattr(config, "prefer_bsr", True)
    lat = m.lattice
    sites = range(lat.n_sites)
    coords = [lat.site2coor(s)[0] for s in sites]
    norms2 = []
    for q in momenta:
        ph = np.exp(-2j * np.pi * lat.k_dot_R(q, coords))
        m.enumerate_basis_repr(list(k0 - np.asarray(q)), [c["Sz"]], [0.0],
                               sec=1)
        assert m._fullspace_repr_op(m.sec_repr[1]) is None
        nrm, mu, lo, hi = m.measure_repr_dynamic_kpm(
            _aq(tz, sites, ph, tz.SP_HALF["Sz"]), 0, 1, 32)
        norms2.append(nrm ** 2)
        if np.allclose(ph, 1.0):  # q = 0: Sz(0)|gs> = 0 at Sz = 0
            assert nrm == 0.0
            continue
        dst = m.sec_repr[1]
        assert isinstance(dst.bsr32, BsrMatrix)
        assert abs(mu[0] - 1.0) < 1e-6 and np.max(np.abs(mu)) <= 1 + 1e-5
        # the same moments from the float64 ELL with the same bounds
        v, _ = m._injected(_aq(tz, sites, ph, tz.SP_HALF["Sz"]),
                           m.sec_repr[0], dst, 0, True)
        mu64, _, _ = kpm_moments(m._repr_ell(dst), v, 32, bounds=(lo, hi))
        np.testing.assert_allclose(mu, mu64, rtol=0, atol=5e-5)
    assert abs(sum(norms2) - lat.n_sites / 4) < 1e-12
