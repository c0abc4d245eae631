"""Momentum sectors solved in the full label space (``P_k H`` on the
contraction engine) through the port's ``Model``, against the JAX package,
the reference goldens and the port's own explicit route.

Energies agree with the JAX package to 1e-10 (both solve to 1e-10 * |E|
in float64 from the same Lehmer start vector, so the restart histories,
hence the matvec counts, are equal too), with the goldens of BASELINE.md to
1e-8; eigenvectors up to a phase (overlap above 1 - 1e-8); measurements to
1e-10; the host-side vector conversions to 1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.ops.apply_repr import (
    mopr_x_vec_repr as jax_mopr_x_vec_repr,
)
from quantum_basis_tpu.ops.operators import Mopr as JaxMopr, Opr as JaxOpr
from quantum_basis_tpu_torch import Mopr, Opr, config, interop
from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
from quantum_basis_tpu_torch.ops.apply_repr import mopr_x_vec_repr
from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest

CHAIN16 = {0: -7.142296361, 1: -6.523407057, 2: -5.990986863}


def _restart_steps(path):
    """The step counter of every restart line of a solver log."""
    return [int(line.split()[2]) for line in path.read_text().splitlines()]


def _total_steps(steps):
    """Matrix applications of all runs in a log: the counter restarts at
    every solver run (the solve, then its deflate-and-verify pass)."""
    ends = [a for a, b in zip(steps, steps[1:] + [0]) if b <= a]
    return sum(ends)


@pytest.mark.parametrize("k", sorted(CHAIN16))
def test_chain16_projected_solve_matches_jax(k, tmp_path, monkeypatch):
    monkeypatch.setattr(config, "solver_log_dir", str(tmp_path / "port"))
    monkeypatch.setattr(jax_config, "solver_log_dir", str(tmp_path / "jax"))
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
    sec = m.sec_repr[0]
    m.locate_E0_lanczos(which="repr")
    fs = m._fullspace_repr_op(sec)
    assert isinstance(fs, ProjectedFullOp) and isinstance(fs.base, ContractOp)
    assert fs.n_applies > 0 and sec.ell is None and sec.bsr32 is None
    assert abs(m.eigenvals_repr[0] - CHAIN16[k]) < 1e-8
    assert sec.evecs[0].shape == (sec.dim,)

    mj, cj = jz.heisenberg_chain(16)
    mj.enumerate_basis_repr([k], [cj["Sz"]], [0.0])
    assert mj._fullspace_repr_op(mj.sec_repr[0]) is not None
    mj.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10
    # same start vector, same restarts: the same count of matvecs
    steps = _restart_steps(tmp_path / "port" / "log_lanczos.txt")
    assert steps == _restart_steps(tmp_path / "jax" / "log_lanczos.txt")
    assert fs.n_applies == _total_steps(steps)
    # the eigenvector over the representatives, up to a phase
    vr, vi = mj.sec_repr[0].evecs[0]
    vj = np.asarray(vr) + 1j * np.asarray(vi)
    assert abs(np.vdot(vj, sec.evecs[0].numpy())) > 1.0 - 1e-8
    # a measurement after the projected solve
    sz = jz.SP_HALF["Sz"]
    want = mj.measure_repr_static(JaxOpr(0, 0, False, sz)
                                  * JaxOpr(2, 0, False, sz), 0)
    got = m.measure_repr_static(tz.sz_pair(0, 2), 0)
    assert abs(got - want) < 1e-10
    assert len(sec._meas_cache) == 1
    assert m.measure_repr_static(tz.sz_pair(0, 2), 0) == got
    assert len(sec._meas_cache) == 1      # the cached matvec was used again


def test_chain16_mixed_precision_matches_jax(monkeypatch):
    """f32 bulk on the float32 P_k H, f64 stage from its Ritz vector."""
    monkeypatch.setattr(config, "mixed_precision", True)
    monkeypatch.setattr(jax_config, "mixed_precision", True)
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    m.locate_E0_lanczos(which="repr")
    sec = m.sec_repr[0]
    fs32 = sec._fsrepr_cache[torch.float32]
    assert isinstance(fs32, ProjectedFullOp) and fs32.dtype == torch.float32
    assert fs32.n_applies > 0 and sec._fsrepr_cache[torch.float64].n_applies > 0
    assert abs(m.eigenvals_repr[0] - CHAIN16[1]) < 1e-8
    mj, cj = jz.heisenberg_chain(16)
    mj.enumerate_basis_repr([1], [cj["Sz"]], [0.0])
    mj.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10


@pytest.mark.parametrize("k", [0, 1, 3])
def test_chain14_projected_equals_explicit_route(k):
    """P_k H in the full label space against the port's ELL over the
    representatives: E0 to 1e-9 and the eigenvector read back by
    ``from_full`` up to a phase; ``_repr_to_full`` inverts ``from_full``."""
    m, c = tz.heisenberg_chain(14)
    m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
    sec = m.sec_repr[0]
    assert sec.dim > 60
    fs = m._fullspace_repr_op(sec)
    ev_fs, vec_fs = eigs_smallest(fs, fs.N, nev=1, ncv=12, maxit=400,
                                  complex_vec=True, mask=fs.mask)
    ev_ell, vec_ell = eigs_smallest(m._repr_ell(sec), sec.dim, nev=1, ncv=12,
                                    maxit=400, complex_vec=True)
    assert abs(ev_fs[0] - ev_ell[0]) < 1e-9
    coef = sec.dbasis.from_full(vec_fs[0])
    assert abs(torch.vdot(coef, vec_ell[0])) > 1.0 - 1e-8
    back = m._repr_to_full(sec, coef)
    assert abs(float(torch.linalg.vector_norm(back)) - 1.0) < 1e-12
    assert float((sec.dbasis.from_full(back) - coef).abs().max()) < 1e-12
    assert abs(abs(torch.vdot(back, vec_fs[0])) - 1.0) < 1e-8


def test_hubbard4x2_fermionic_signs_match_jax():
    """Two-dimensional translations with boundary signs and complex phases
    (k = (1, 0) of 4 x 2): E0 against the JAX package."""
    qn = [4.0, 4.0]
    m, c = tz.fermi_hubbard_square(4, 2)
    assert m.enumerate_basis_repr([1, 0], [c["Nup"], c["Ndn"]], qn) == 608
    m.locate_E0_lanczos(which="repr")
    assert isinstance(m._fullspace_repr_op(m.sec_repr[0]), ProjectedFullOp)
    mj, cj = jz.fermi_hubbard_square(4, 2)
    mj.enumerate_basis_repr([1, 0], [cj["Nup"], cj["Ndn"]], qn)
    mj.locate_E0_lanczos(which="repr")
    assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10


def test_kagome_tj_projected_apply_equals_repr_apply():
    """Kagome t-J 2x2, N = 8, Sz = 0, k = (0, 1) (three-state sites, fermion
    signs, complex phases; 3^12 labels over dim 8,640): for a seeded vector
    over the representatives, expanding it, applying P_k H and reading it
    back equals the matrix-free momentum-sector apply. (The whole solve of
    this sector runs on the card; on the CPU it takes minutes.)"""
    m, c = tz.kagome_tj(2, 2)
    assert m.enumerate_basis_repr([0, 1], [c["N"], c["Sz"]], [8.0, 0.0]) == 8640
    sec = m.sec_repr[0]
    fs = m._fullspace_repr_op(sec)
    assert isinstance(fs, ProjectedFullOp)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=sec.dim) + 1j * rng.normal(size=sec.dim))
    x = x / torch.linalg.vector_norm(x)
    xf = m._repr_to_full(sec, x)
    want = sec.matvec(x)
    # y = H x is not normalized: read the coefficients back by hand
    y = fs(xf)[torch.as_tensor(sec.labels)] / sec.dbasis.sqrt_nu[: sec.dim]
    # xf is the expansion of x up to the norm of its seed vector
    scale = torch.vdot(sec.dbasis.from_full(xf), x)
    ratio = torch.vdot(want, y) / torch.vdot(want, want)
    assert abs(abs(scale) - 1.0) < 1e-12
    assert float((y - ratio * want).abs().max()) < 1e-12 * float(
        y.abs().max())


def test_two_sz_sectors_on_one_model_keep_their_own_masks():
    """Sz = 0 then Sz = 1 on the same model share the base engine but not
    the quantum-number mask: each E0 equals the ELL solve of its own sector.
    (In the JAX package the shared engine keeps the first enumeration's
    mask.)"""
    m, c = tz.heisenberg_chain(16)
    m.enumerate_basis_repr([0], [c["Sz"]], [0.0], sec=0)
    m.enumerate_basis_repr([0], [c["Sz"]], [1.0], sec=1)
    s0, s1 = m.sec_repr[0], m.sec_repr[1]
    assert s0.dim != s1.dim
    fs0, fs1 = m._fullspace_repr_op(s0), m._fullspace_repr_op(s1)
    assert fs0.base is fs1.base and fs0.mask is not fs1.mask
    assert int(fs0.mask.sum()) == 12870 and int(fs1.mask.sum()) == 11440
    for sec, s in ((1, s1), (0, s0)):
        m.locate_E0_lanczos(which="repr", sec=sec)
        ref, _ = eigs_smallest(m._repr_ell(s), s.dim, nev=1, ncv=12,
                               complex_vec=True)
        assert abs(s.evals[0] - ref[0]) < 1e-9
    assert s0.evals[0] < s1.evals[0] - 0.1


def _spinless_chain(z, L, N):
    """Spinless fermions hopping on a ring (tests/test_project.py), built
    with the port's or the JAX package's classes."""
    if z is tz:
        from quantum_basis_tpu_torch import Lattice, Model
        from quantum_basis_tpu_torch import Mopr as M, Opr as O
        m = Model(Lattice("chain", [L], ["pbc"]), device="cpu")
    else:
        from quantum_basis_tpu import Lattice, Model
        from quantum_basis_tpu import Mopr as M, Opr as O
        m = Model(Lattice("chain", [L], ["pbc"]))
    m.add_orbital(L, "spinless-fermion")
    Nf = M()
    for x in range(L):
        c_i = O(x, 0, True, tz.C_SPINLESS)
        c_j = O((x + 1) % L, 0, True, tz.C_SPINLESS)
        m.add_Ham((-1.0) * (c_i.dagger() * c_j))
        m.add_Ham((-1.0) * (c_j.dagger() * c_i))
        Nf += c_i.dagger() * c_i
    m.enumerate_basis_full([Nf], [float(N)])
    return m


@pytest.mark.parametrize("case", ["chain8_spin", "ring6_fermion"])
def test_projectQ_and_transform_vec_match_jax(case):
    if case == "chain8_spin":
        L = 8
        m, c = tz.heisenberg_chain(L)
        mj, cj = jz.heisenberg_chain(L)
        m.enumerate_basis_full([c["Sz"]], [0.0])
        mj.enumerate_basis_full([cj["Sz"]], [0.0])
    else:
        L = 6
        m, mj = _spinless_chain(tz, L, 3), _spinless_chain(jz, L, 3)
    n = m.dim_full(0)
    rng = np.random.default_rng(7)
    x = rng.normal(size=n) + 1j * rng.normal(size=n)
    plan = m.lattice.translation_plan([2])
    np.testing.assert_allclose(
        m.transform_vec_full(plan, 0, torch.as_tensor(x)),
        mj.transform_vec_full(plan, 0, x), atol=1e-12)
    acc = np.zeros(n, dtype=np.complex128)
    for k in range(L):
        y = m.projectQ_full([k], 0, x)          # includes the self-check
        np.testing.assert_allclose(y, mj.projectQ_full([k], 0, x), atol=1e-12)
        np.testing.assert_allclose(m.projectQ_full([k], 0, y), y, atol=1e-10)
        acc += y
    np.testing.assert_allclose(acc, x, atol=1e-10)     # sum_k P_k = 1
    with pytest.raises(ValueError):
        m.transform_vec_full(np.arange(L)[::-1] * 0, 0, x)


@pytest.mark.parametrize("q", [1, 6])
def test_mopr_x_vec_repr_matches_jax(q):
    """A = sum_x e^{-i q x} Sz_x maps k = 0 to k = -q on chain-12."""
    L = 12
    m, c = tz.heisenberg_chain(L)
    mj, cj = jz.heisenberg_chain(L)
    A, Aj = Mopr(), JaxMopr()
    for x in range(L):
        ph = np.exp(-2j * np.pi * q * x / L)
        A += complex(ph) * Opr(x, 0, False, tz.SP_HALF["Sz"])
        Aj += complex(ph) * JaxOpr(x, 0, False, jz.SP_HALF["Sz"])
    kd = (-q) % L
    for mm, cc in ((m, c), (mj, cj)):
        mm.enumerate_basis_repr([0], [cc["Sz"]], [0.0], sec=0)
        mm.enumerate_basis_repr([kd], [cc["Sz"]], [0.0], sec=1)
    src, dst = m.sec_repr[0].dbasis, m.sec_repr[1].dbasis
    rng = np.random.default_rng(9)
    x = rng.normal(size=src.n) + 1j * rng.normal(size=src.n)
    yr, yi = jax_mopr_x_vec_repr(
        mj.compile_op(Aj), mj.sec_repr[0].dbasis, mj.sec_repr[1].dbasis,
        (np.asarray(x.real), np.asarray(x.imag)))
    want = np.asarray(yr) + 1j * np.asarray(yi)
    got = mopr_x_vec_repr(m.compile_op(A), src, dst, torch.as_tensor(x))
    assert np.linalg.norm(want) > 0.1
    assert np.max(np.abs(got.numpy() - want)) < 1e-12


def test_repr_sector_carried_over_from_jax():
    """A JAX momentum sector (labels, representatives, eigenvector)
    installed in a port model: same basis, same measurement, and its
    expansion to the full label space is an eigenvector of P_k H."""
    mj, cj = jz.heisenberg_chain(12)
    mj.enumerate_basis_repr([0], [cj["Sz"]], [0.0])
    mj.locate_E0_lanczos(which="repr")
    _, labels, reps = mj._repr_cache
    sj = mj.sec_repr[0]
    m, c = tz.heisenberg_chain(12)
    s = interop.repr_sector_from_numpy(
        m, [0], labels, reps, evals=sj.evals[:1],
        evecs=[(np.asarray(sj.evecs[0][0]), np.asarray(sj.evecs[0][1]))],
        conserve_lst=[c["Sz"]], val_lst=[0.0])
    np.testing.assert_array_equal(s.labels, sj.labels)
    np.testing.assert_allclose(s.dbasis.nus, sj.dbasis.nus, atol=1e-14)
    sz = jz.SP_HALF["Sz"]
    want = mj.measure_repr_static(JaxOpr(0, 0, False, sz)
                                  * JaxOpr(1, 0, False, sz), 0)
    assert abs(m.measure_repr_static(tz.sz_pair(0, 1), 0) - want) < 1e-10
    fs = m._fullspace_repr_op(s)
    vf = m._repr_to_full(s, s.evecs[0], fs=fs)
    assert float(torch.linalg.vector_norm(fs(vf) - s.evals[0] * vf)) < 1e-8
    cr, ci = sj.dbasis.from_full((np.asarray(vf.real), np.asarray(vf.imag)))
    got = s.dbasis.from_full(vf).numpy()
    assert np.max(np.abs(got - (np.asarray(cr) + 1j * np.asarray(ci)))) < 1e-12
