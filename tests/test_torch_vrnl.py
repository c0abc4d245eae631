"""The variational (vrnl) sector of the port against the JAX package's.

The same seeded numpy inputs go through both packages (the port on
``device="cpu"``):

- ``CenterTranslator.canonicalize`` on random labels of a 16-site chain, a
  4x4 square, a 2x2 kagome cluster (fractional sublattice offsets), a chain
  of two spinless fermions and the 16-site Holstein chain (0-16 fermions):
  canonical labels, displacements and signs bit-equal, and equal to the host
  oracle ``torch_zoo.center_oracle`` on the Holstein chain;
- on a Holstein chain (L=8, Nmax=2): the grown basis bit-equal, the six
  skeleton arrays and their CRC32 bit-equal, ``at_momentum`` to 1e-12,
  ``MatvecVrnl`` to 1e-12 max|y|, ``locate_E0_lanczos`` / ``locate_E0_iram``
  on the dense (dim 91) and the Krylov (dim 1152) branch to 1e-10, the
  ground-state fields to 1e-12, ``moprXgs_vrnl`` / ``moprXvec_vrnl`` (y and
  pG) / ``measure_vrnl_static`` on one eigenvector handed to both to 1e-10,
  ``measure_vrnl_dynamic`` to 1e-10 and ``wannier_mat_vrnl`` to 1e-9;
- the cases of tests/test_vrnl.py through the port: the one-magnon
  dispersion, the two-magnon oracle, single-pole dynamics, ``moprXvec_vrnl``
  against its oracle, the analytic Wannier matrix, the static measurement,
  and the per-k Wannier records, which load across the two packages.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
import quantum_basis_tpu_torch as qt
from quantum_basis_tpu import config as jax_config
from quantum_basis_tpu.basis.vrnl import CenterTranslator as JaxCT
from quantum_basis_tpu.ops.apply_vrnl import MatvecVrnl as JaxMatvecVrnl
from quantum_basis_tpu_torch import Mopr, Opr, config
from quantum_basis_tpu_torch.basis.vrnl import CenterTranslator
from quantum_basis_tpu_torch.interop import vrnl_sector_from_numpy
from quantum_basis_tpu_torch.ops.apply_vrnl import MatvecVrnl
from quantum_basis_tpu_torch.ops.operators import OprProd
from test_vrnl import _oracle_canon, _oracle_two_magnon, _seed_flip

SKELETON = ("rows", "cols", "amp_re", "amp_im", "disp", "diag")


def _bare_models(orbital, n_sites, lat_name="chain", dims=None):
    """One orbital on a named PBC lattice in both packages (no H)."""
    out = []
    for pkg in (qj, qt):
        dims = dims or [n_sites]
        lat = pkg.Lattice(lat_name, dims, ["pbc"] * len(dims))
        m = pkg.Model(lat) if pkg is qj else pkg.Model(lat, device="cpu")
        m.add_orbital(n_sites, orbital)
        out.append(m)
    return out


def _canon_case(name):
    """(JAX model, port model, labels) of a canonicalization case."""
    rng = np.random.default_rng(11)
    if name == "chain16":
        mj, mt = _bare_models("spin-1/2", 16)
    elif name == "square4x4":
        mj, mt = _bare_models("spin-1/2", 16, "square", [4, 4])
    elif name == "kagome2x2":
        mj, _ = jz.kagome_heisenberg(2, 2)
        mt, _ = tz.kagome_heisenberg(2, 2)
    elif name == "two_fermions":
        mj, mt = _bare_models("spinless-fermion", 12)
        pairs = rng.integers(0, 12, size=(3000, 2))
        pairs = pairs[pairs[:, 0] != pairs[:, 1]]
        return mj, mt, (1 << pairs[:, 0]) + (1 << pairs[:, 1])
    else:  # holstein16: 0-16 fermions per label
        mj, _ = tz.holstein_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr,
                                       16, 3)
        mt, _ = tz.holstein_chain(16, 3)
    labels = rng.integers(0, mt.space.label_space, size=3000)
    return mj, mt, labels


@pytest.mark.parametrize("name", ["chain16", "square4x4", "kagome2x2",
                                  "two_fermions", "holstein16"])
def test_canonicalize_bit_equal(name):
    mj, mt, labels = _canon_case(name)
    got = CenterTranslator(mt.space, mt.lattice, device="cpu").canonicalize(
        labels)
    want = JaxCT(mj.space, mj.lattice).canonicalize(labels)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    if name in ("two_fermions", "holstein16"):
        oracle = tz.center_oracle(mt.space, mt.lattice, labels)
        for g, w in zip(got, oracle):
            assert np.array_equal(g, w)
    if name == "holstein16":
        # two fermions never cross the boundary on their way to the center;
        # up to 16 do, and the sign is exercised
        assert np.any(got[2] < 0)


def test_label_space_bound():
    """The translator's labels are exact only below 2^53, in both packages
    (float64 stride pass in the JAX package): the port refuses beyond."""
    _, m = _bare_models("spin-1", 34)  # 3^34 > 2^53
    with pytest.raises(OverflowError):
        CenterTranslator(m.space, m.lattice, device="cpu")


# --------------------------------------------------- the Holstein chain case

L_H, NMAX_H = 8, 2
# (sec, momentum, depth): the dense branch, the Krylov branch, the gs momentum
SECTORS = ((0, 0.25, 6), (1, 0.125, 10), (2, 0.0, 6))


def _b_k(pkg, k, L=L_H, dagger=True):
    """B_k = sum_x e^{2 pi i k x} c+_x (or its c_x twin)."""
    c = np.array([[0.0, 1.0], [0.0, 0.0]])
    out = pkg.Mopr()
    for x in range(L):
        out += complex(np.exp(2j * np.pi * k * x)) * pkg.Mopr(
            [pkg.OprProd(1.0, [pkg.Opr(x, 0, True, c.T if dagger else c)])])
    return out


@pytest.fixture(scope="module")
def holstein():
    """Both packages' Holstein chains with the sectors of SECTORS grown."""
    mj, oj = tz.holstein_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr,
                                    L_H, NMAX_H)
    mt, ot = tz.holstein_chain(L_H, NMAX_H)
    seed = int(mt.space.strides[mt.space.slot(L_H // 2, 0)])
    for sec, k, depth in SECTORS:
        for m, o in ((mj, oj), (mt, ot)):
            m.build_basis_vrnl([seed], 0, [0.0], [k], depth, [o["N_e"]], [1.0],
                               sec=sec)
    return mj, oj, mt, ot


def _skeleton(m, sec):
    m.generate_Ham_sparse_vrnl(sec)
    return m.sec_vrnl[sec].vmat


def test_grow_bit_equal(holstein):
    mj, _, mt, _ = holstein
    for sec, _, _ in SECTORS:
        a, b = mj.sec_vrnl[sec].labels, mt.sec_vrnl[sec].labels
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert [mt.dim_vrnl(s) for s, _, _ in SECTORS] == [91, 1152, 91]


def test_grow_from_several_seeds():
    """Non-canonical seeds, one of them outside the conserved sector; the
    port's frontier growth against the JAX package's whole-basis rounds."""
    from quantum_basis_tpu.basis.vrnl import grow_basis_vrnl as jax_grow
    from quantum_basis_tpu.ops.compile import compile_operator as jax_compile
    from quantum_basis_tpu_torch.basis.vrnl import grow_basis_vrnl
    from quantum_basis_tpu_torch.ops.compile import compile_operator

    mj, oj = tz.holstein_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr,
                                    6, 2)
    mt, ot = tz.holstein_chain(6, 2)
    sp = mt.space
    vals = np.zeros((3, sp.n_slots), dtype=np.int64)
    vals[0, sp.slot(1, 0)] = 1
    vals[1, sp.slot(5, 0)], vals[1, sp.slot(4, 1)] = 1, 2
    vals[2, sp.slot(0, 0)], vals[2, sp.slot(3, 0)] = 1, 1  # N_e = 2
    seeds = sp.encode(vals)
    want = jax_grow(jax_compile(mj.Ham, mj.space), mj.center_translator,
                    seeds, 4, [oj["N_e"]], [1.0])
    got = grow_basis_vrnl(compile_operator(mt.Ham, sp), mt.center_translator,
                          seeds, 4, [ot["N_e"]], [1.0], chunk=16)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_skeleton_bit_equal(holstein):
    mj, _, mt, _ = holstein
    for sec, _, _ in SECTORS[:2]:
        a, b = _skeleton(mj, sec), _skeleton(mt, sec)
        crc = [0, 0]
        for name in SKELETON:
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes(), name
            crc = [zlib.crc32(np.ascontiguousarray(x).tobytes(), crc[0]),
                   zlib.crc32(np.ascontiguousarray(y).tobytes(), crc[1])]
        assert crc[0] == crc[1]


def test_at_momentum(holstein):
    mj, _, mt, _ = holstein
    a, b = _skeleton(mj, 0), _skeleton(mt, 0)
    for k in (0.0, 0.3, 0.625):
        np.testing.assert_allclose(b.at_momentum([k]), a.at_momentum([k]),
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("upper", [True, False])
def test_matvec_vrnl(holstein, upper):
    mj, _, mt, _ = holstein
    a, b = _skeleton(mj, 1), _skeleton(mt, 1)
    k = [0.125] if upper else [0.0]
    rng = np.random.default_rng(3)
    x = rng.normal(size=b.n) + 1j * rng.normal(size=b.n)
    y = MatvecVrnl(b, k, upper_triangle=upper)(
        torch.as_tensor(x)).numpy()
    yr, yi = JaxMatvecVrnl(a, k, upper_triangle=upper)(
        (jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy())))
    y_jax = np.asarray(yr) + 1j * np.asarray(yi)
    tol = 1e-12 * np.abs(y_jax).max()
    assert np.abs(y - y_jax).max() <= tol
    if upper:
        assert np.abs(y - b.at_momentum(k) @ x).max() <= tol


@pytest.mark.parametrize("sec", [0, 1])
@pytest.mark.parametrize("method", ["lanczos", "iram"])
def test_locate_vrnl(holstein, sec, method):
    mj, _, mt, _ = holstein
    for m in (mj, mt):
        if method == "lanczos":
            m.locate_E0_lanczos(which="vrnl", sec=sec)
        else:
            m.locate_E0_iram(which="vrnl", nev=2, sec=sec)
    got, want = mt.eigenvals_vrnl, mj.eigenvals_vrnl
    assert len(got) == len(want) >= 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    v = mt.eigenvecs_vrnl[0]
    assert v.dtype == torch.complex128 and v.device.type == "cpu"
    r = mt.sec_vrnl[sec].matvec(v) - got[0] * v
    assert float(torch.linalg.vector_norm(r)) < 1e-8


def test_gs_fields(holstein):
    """gs_E0 / gs_omega / gs_norm on the Holstein vacuum (E0 = 0) away from
    and at its momentum, and on a ferromagnetic background (E0 = L/4)."""
    mj, _, mt, _ = holstein
    pairs = [(mj, mt, sec) for sec in (0, 2)]
    magnons = []
    for pkg in (qj, qt):
        m, cons = (jz.heisenberg_chain(8) if pkg is qj
                   else tz.heisenberg_chain(8))
        m.build_basis_vrnl(_seed_flip(m.space, 8, [4]), 0, [0.0], [0.0], 2,
                           [cons["Sz"]], [3.0])
        magnons.append(m)
    pairs.append((*magnons, 0))
    for a, b, sec in pairs:
        got = []
        for m in (a, b):
            m.generate_Ham_sparse_vrnl(sec)
            s = m.sec_vrnl[sec]
            got.append((s.gs_E0, s.gs_omega, s.gs_norm, s.gs_label))
        np.testing.assert_allclose(got[1], got[0], rtol=0, atol=1e-12)
    assert [b.sec_vrnl[sec].gs_norm for _, b, sec in pairs] == [0.0, 1.0, 1.0]
    assert magnons[1].sec_vrnl[0].gs_E0 == pytest.approx(2.0, abs=1e-12)


def _hand_over(mj, mt, sec):
    """Solve the JAX sector densely and install its eigenvectors in the port
    through vrnl_sector_from_numpy."""
    mj.locate_E0_lanczos(which="vrnl", ncv=3, sec=sec)
    s = mj.sec_vrnl[sec]
    vrnl_sector_from_numpy(
        mt, s.labels, s.momentum, s.gs_label, s.gs_momentum, s.gs_omega,
        s.gs_norm, s.evals, [(np.asarray(re), np.asarray(im))
                             for re, im in s.evecs], sec=sec)
    return np.asarray(s.evecs[0][0]) + 1j * np.asarray(s.evecs[0][1])


def test_measurements_on_one_vector(holstein):
    mj, oj, mt, ot = holstein
    phi = _hand_over(mj, mt, 0)
    _hand_over(mj, mt, 2)
    # B_k |gs>: the electron created over the vacuum
    for k in (0.25, 0.1):
        got = mt.moprXgs_vrnl(_b_k(qt, k), 0).numpy()
        want = mj.moprXgs_vrnl(_b_k(qj, k), 0)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    # B x: a phased phonon operator plus N_e (y only), and c_x onto the
    # vacuum of the gs-momentum sector (pG only)
    for pkg_ops, sec_new in (("phonon", 0), ("annihilate", 2)):
        ops = {}
        for pkg, o in ((qj, oj), (qt, ot)):
            if pkg_ops == "phonon":
                op = pkg.Mopr()
                for x in range(L_H):
                    op += complex(np.exp(0.4j * x)) * pkg.Mopr([pkg.OprProd(
                        1.0, [pkg.Opr(x, 1, False, np.diag([1.0, 2.0], k=1))])])
                op += o["N_e"]
            else:
                op = _b_k(pkg, -0.25, dagger=False)
            ops[pkg] = op
        y_t, pg_t = mt.moprXvec_vrnl(ops[qt], 0, sec_new, phi)
        y_j, pg_j = mj.moprXvec_vrnl(ops[qj], 0, sec_new, phi)
        np.testing.assert_allclose(y_t.numpy(), y_j, rtol=0, atol=1e-10)
        assert abs(pg_t - pg_j) < 1e-10
        assert (abs(pg_j) > 1e-3) == (pkg_ops == "annihilate")
    # <phi|O|phi>: N_e (through compile_diagonal_complex), H, and a diagonal
    # with complex coefficients (through the term tables)
    for name in ("N_e", "H", "nq"):
        args = []
        for pkg, m, o in ((qj, mj, oj), (qt, mt, ot)):
            if name == "H":
                args.append(m.Ham)
            elif name == "N_e":
                args.append(o["N_e"])
            else:
                nq = pkg.Mopr()
                for x in range(L_H):
                    nq += complex(np.exp(0.7j * x)) * pkg.Mopr([pkg.OprProd(
                        1.0, [pkg.Opr(x, 0, False, np.array([0.0, 1.0]))])])
                args.append(nq)
        want = mj.measure_vrnl_static(args[0], 0)
        got = mt.measure_vrnl_static(args[1], 0)
        assert abs(got - want) < 1e-10, name
    assert abs(mt.measure_vrnl_static(ot["N_e"], 0) - 1.0) < 1e-10
    assert abs(mt.measure_vrnl_static(mt.Ham, 0) - mt.sec_vrnl[0].evals[0]) \
        < 1e-10


@pytest.mark.parametrize("sec", [0, 1])
def test_measure_vrnl_dynamic(holstein, sec):
    mj, _, mt, _ = holstein
    k = dict((s, kk) for s, kk, _ in SECTORS)[sec]
    got = mt.measure_vrnl_dynamic(_b_k(qt, k), sec, m_steps=8)
    want = mj.measure_vrnl_dynamic(_b_k(qj, k), sec, m_steps=8)
    assert abs(got[0] - want[0]) < 1e-10 and abs(got[0] - 1.0) < 1e-12
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=1e-10)
    # the first Lanczos coefficient of B_k|0> is the free band -2t cos 2 pi k
    assert abs(got[1][0] + 2.0 * np.cos(2 * np.pi * k)) < 1e-12


def test_wannier_holstein(holstein):
    mj, oj, mt, ot = holstein
    momenta = [[j / L_H] for j in range(4)]
    mus = []
    for pkg, m, o in ((qj, mj, oj), (qt, mt, ot)):
        ar = [([float(r)], pkg.Opr(r, 0, False, np.array([0.0, 1.0])))
              for r in range(L_H)]
        mus.append(m.wannier_mat_vrnl(ar, momenta, lambda model, idx: 0,
                                      sec=2))
    np.testing.assert_allclose(mus[1], mus[0], rtol=0, atol=1e-9)


# ------------------------------------------- cases of tests/test_vrnl.py


def _magnon_model(L):
    m, cons = tz.heisenberg_chain(L)
    m.Ham_vrnl = m.Ham
    return m, cons


def _sm(x, k=None, op="Sm"):
    out = Mopr([OprProd(1.0, [Opr(x, 0, False, tz.SP_HALF[op])])])
    return out if k is None else complex(np.exp(2j * np.pi * k * x)) * out


def test_one_magnon_dispersion():
    L = 8
    m, cons = _magnon_model(L)
    seeds = _seed_flip(m.space, L, [L // 2])
    for kint in range(L):
        assert m.build_basis_vrnl(seeds, 0, [0.0], [kint / L], depth=3,
                                  conserve_lst=[cons["Sz"]],
                                  val_lst=[0.5 * L - 1.0]) == 1
        m.generate_Ham_sparse_vrnl(0)
        sec = m.sec_vrnl[0]
        assert sec.gs_omega == 1 and abs(sec.gs_E0 - L / 4.0) < 1e-10
        m.locate_E0_lanczos(which="vrnl")
        want = L / 4.0 - 1.0 + np.cos(2 * np.pi * kint / L)
        assert abs(m.eigenvals_vrnl[0] - want) < 1e-10


def test_two_magnon_vs_oracle():
    L = 12
    m, cons = _magnon_model(L)
    seeds = _seed_flip(m.space, L, [L // 2 - 1, L // 2])
    for kint in [0, 1, 5]:
        kfrac = kint / L
        dim = m.build_basis_vrnl(seeds, 0, [0.0], [kfrac], depth=2,
                                 conserve_lst=[cons["Sz"]],
                                 val_lst=[0.5 * L - 2.0])
        states, H_oracle = _oracle_two_magnon(L, kfrac, (L // 2 - 1, L // 2),
                                              2)
        assert dim == len(states)
        m.generate_Ham_sparse_vrnl(0)
        H = m.sec_vrnl[0].vmat.at_momentum([kfrac], upper_triangle=False)
        np.testing.assert_allclose(np.linalg.eigvalsh(H),
                                   np.linalg.eigvalsh(H_oracle), atol=1e-10)
        np.testing.assert_allclose(m.sec_vrnl[0].vmat.at_momentum([kfrac]),
                                   H, atol=1e-12)


def test_single_pole_dynamics():
    L, kint = 8, 3
    m, cons = _magnon_model(L)
    m.build_basis_vrnl(_seed_flip(m.space, L, [L // 2]), 0, [0.0],
                       [kint / L], depth=2, conserve_lst=[cons["Sz"]],
                       val_lst=[0.5 * L - 1.0])
    Bq = Mopr()
    for x in range(L):
        Bq += _sm(x, kint / L)
    norm, alphas, _ = m.measure_vrnl_dynamic(Bq, 0, m_steps=5)
    assert abs(norm - 1.0) < 1e-9
    want = L / 4.0 - 1.0 + np.cos(2 * np.pi * kint / L)
    assert abs(float(alphas[0]) - want) < 1e-9
    # a B_q that leaves nothing in the basis: the zero-norm guard
    nrm, a0, b0 = m.measure_vrnl_dynamic(_sm(0, op="Sp"), 0, m_steps=5)
    assert nrm == 0.0 and a0.size == b0.size == 0


def test_moprXvec_vrnl_vs_oracle():
    L, kint, qint = 8, 1, 2
    m, cons = _magnon_model(L)
    m.build_basis_vrnl(_seed_flip(m.space, L, [L // 2]), 0, [0.0],
                       [kint / L], depth=2, conserve_lst=[cons["Sz"]],
                       val_lst=[0.5 * L - 1.0])
    m.build_basis_vrnl(_seed_flip(m.space, L, [L // 2 - 1, L // 2]), 0,
                       [0.0], [(kint + qint) / L], depth=6,
                       conserve_lst=[cons["Sz"]], val_lst=[0.5 * L - 2.0],
                       sec=1)
    sec1 = m.sec_vrnl[1]
    Bq = Mopr()
    for x in range(L):
        Bq += _sm(x, qint / L)
    x0 = np.asarray([1.0 + 0.0j])
    y, pG = m.moprXvec_vrnl(Bq, 0, 1, x0)
    assert abs(pG) < 1e-12
    c = int(np.floor((L - 1) / 2.0))
    lab_to_idx = {int(lab): i for i, lab in enumerate(sec1.labels)}
    y_oracle = np.zeros(sec1.dim, dtype=np.complex128)
    for x in range(L):
        if x == c:
            continue
        canon, d = _oracle_canon(L, (x, c))
        lab = int(_seed_flip(m.space, L, canon)[0])
        y_oracle[lab_to_idx[lab]] += (np.exp(2j * np.pi * qint * x / L)
                                      * np.exp(2j * np.pi * (kint + qint)
                                               * d / L))
    np.testing.assert_allclose(y.numpy(), y_oracle, atol=1e-10)
    m.build_basis_vrnl(_seed_flip(m.space, L, [L // 2]), 0, [0.0], [0.0],
                       depth=2, conserve_lst=[cons["Sz"]], val_lst=[0.5 * L],
                       sec=2)
    Bp = Mopr()
    for x in range(L):
        Bp += _sm(x, -kint / L, op="Sp")
    y2, pG2 = m.moprXvec_vrnl(Bp, 0, 2, x0)
    assert np.allclose(y2.numpy(), 0.0, atol=1e-12)
    assert abs(pG2 - np.exp(-2j * np.pi * kint * c / L)) < 1e-10


def test_vrnl_static_measurement():
    L = 8
    m, cons = _magnon_model(L)
    m.build_basis_vrnl(_seed_flip(m.space, L, [3, 4]), 0, [0.0], [1 / L],
                       depth=6, conserve_lst=[cons["Sz"]],
                       val_lst=[0.5 * L - 2.0])
    m.locate_E0_lanczos(which="vrnl", nev=1, ncv=1)
    assert abs(m.measure_vrnl_static(cons["Sz"], 0, 0) - (0.5 * L - 2.0)) \
        < 1e-9


def _wannier_run(pkg, L=8, nk=3):
    m, cons = (jz.heisenberg_chain(L) if pkg is qj
               else tz.heisenberg_chain(L))
    m.build_basis_vrnl(_seed_flip(m.space, L, [L // 2]), 0, [0.0], [0.0],
                       depth=2, conserve_lst=[cons["Sz"]],
                       val_lst=[0.5 * L - 1.0])
    m.generate_Ham_sparse_vrnl(0)
    ar = [([float(r)], pkg.Opr(r, 0, False, tz.SP_HALF["Sz"]))
          for r in range(L)]
    return m.wannier_mat_vrnl(ar, [[kk / L] for kk in range(nk)],
                              lambda model, idx: 0, sec=0)


def test_wannier_one_magnon():
    L = 8
    mu = _wannier_run(qt, L, nk=4)
    c = int(np.floor((L - 1) / 2.0))
    for i1 in range(4):
        for i2 in range(4):
            want = (0.5 * L - 1.0 if i1 == i2
                    else -np.exp(2j * np.pi * (i1 - i2) * c / L))
            assert abs(mu[i1, i2] - want) < 1e-9


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_wannier_records_across_packages(tmp_path, monkeypatch, writer):
    """Per-k records: a rerun in the same package and a run in the other
    package load every record and call no eigh."""
    for cfg in (config, jax_config):
        monkeypatch.setattr(cfg, "enable_ckpt", True)
        monkeypatch.setattr(cfg, "ckpt_dir", str(tmp_path))
    first, other = (qt, qj) if writer == "port" else (qj, qt)
    mu1 = _wannier_run(first)
    assert len(list(tmp_path.iterdir())) == 3

    def boom(*a, **k):
        raise AssertionError("eigh re-ran despite the per-k records")

    monkeypatch.setattr(np.linalg, "eigh", boom)
    for pkg in (first, other):
        np.testing.assert_allclose(_wannier_run(pkg), mu1, rtol=0,
                                   atol=1e-12)
