"""The momentum-sector kernels (``ops/apply_repr.py``: ``repr_rows``,
``repr_scatter``, ``repr_images`` over ``pack_rows``' columns and
``translation_tables``; ``csrc/apply_repr.cu`` on the card) on the CPU,
where the wrappers run their plain versions, against the JAX package.

The same sector (the JAX enumeration's representatives, carried over
through ``interop.repr_sector_from_numpy``) goes through both packages,
the vectors from numpy with a fixed seed; H.x, A.x and the ELL to 1e-12
absolute, labels and signs exactly:

- (a) ``_repr_rows_plain`` against the JAX ``MatvecRepr`` on a spin-1/2
  chain (bit fields), a spin-1 chain (mixed radix),
  kagome t-J and the honeycomb spinless fermions (Jordan-Wigner strings,
  fermionic translation signs) and the three-site chain (arity 3 columns),
  at real (kagome's) and complex momenta, in all three index modes
  (``lin`` where the representatives admit one);
- (b) ``_repr_scatter_plain`` against the JAX ``mopr_x_vec_repr`` for
  Sz(q) from k to k - q (every column diagonal) and S^-(q) from Sz=0 into
  Sz=-1 (off-diagonal), and for a fermionic density wave;
- (c) ``build_sparse_repr`` on ``_repr_images_plain`` against the JAX
  ``build_sparse_repr``, as dense matrices;
- (d) the kernels' translation (T_g(r) plus the changed slots' terms, the
  first g at the minimum, the sign from popcounts against the Q masks)
  against ``TranslationSet.transform_all`` on random labels of each space,
  ties included;
- (e) the dispatch: CPU tensors run the plain versions and count no
  launch, a ``meta`` tensor raises, and the argument checks of a CUDA
  launch refuse what the kernels do not take.

One ``cuda``-marked test holds the three kernels against their plain
versions on the card; it skips here. The JAX package is imported inside
the tests that compare with it: the card's machine has no JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import interop
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.ops import apply_repr as ar
from quantum_basis_tpu_torch.ops.apply import pack_rows
from quantum_basis_tpu_torch.ops.apply_repr import (
    MatvecRepr,
    _check_args,
    _orbit_min_plain,
    _repr_images_plain,
    _repr_rows_plain,
    _repr_scatter_plain,
    column_slots,
    mopr_x_vec_repr,
    phase_table,
    repr_images,
    repr_rows,
    repr_scatter,
    scatter_args,
    translation_tables,
)
from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

MODES = ["direct", "lin", "bsearch"]


def _three_spin(pkg):
    if pkg == "torch":
        return tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr,
                                        tz.Mopr, 12, device="cpu")
    import quantum_basis_tpu as qj

    return tz.three_spin_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 12)


CASES = {
    # name: (builder of a model zoo, conserved names, values, k); the
    # phases e^{-i k.R} of kagome's k = (0, 1) on Ly = 2 are real
    "chain12_k1": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], [1]),
    "spin1_chain8_k2": (lambda z: z.heisenberg_chain(8, spin="1"), ["Sz"],
                        [0.0], [2]),
    "kagome_tj_1x2_k01": (lambda z: z.kagome_tj(1, 2), ["N", "Sz"],
                          [4.0, 0.0], [0, 1]),
    "honeycomb_3x2_k10": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                          ["N"], [4.0], [1, 0]),
    "three_spin12_k3": (None, ["Sz"], [0.0], [3]),
}


def _model(name, pkg):
    build = CASES[name][0]
    if build is None:
        return _three_spin(pkg)
    if pkg == "torch":
        return build(tz)
    import models_zoo as jz

    return build(jz)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """The JAX sector: (labels, reps, x, H x, dense H) on numpy."""
    from quantum_basis_tpu.ops.sparse import build_sparse_repr as jax_build

    _, names, vals, k = CASES[name]
    mj, oj = _model(name, "jax")
    mj.enumerate_basis_repr(k, [oj[c] for c in names], vals)
    sj = mj.sec_repr[0]
    _, labels, reps = mj._repr_cache
    rng = np.random.default_rng(17)
    re, im = rng.standard_normal(sj.dim), rng.standard_normal(sj.dim)
    yr, yi = sj.matvec((re, im))
    ej = jax_build(sj.matvec)
    Hj = _dense(sj.dim, np.asarray(ej.cols),
                np.asarray(ej.vre) + 1j * np.asarray(ej.vim),
                np.asarray(ej.diag))
    return (np.asarray(labels), np.asarray(reps), re + 1j * im,
            np.asarray(yr) + 1j * np.asarray(yi), Hj)


def _dense(n, cols, vals, diag):
    H = np.zeros((n, n), dtype=np.complex128)
    np.add.at(H, (np.repeat(np.arange(n), cols.shape[1]), cols.reshape(-1)),
              vals.reshape(-1))
    H[np.arange(n), np.arange(n)] += diag
    return H


def _port_case(name, mode="direct", device="cpu"):
    """The port's model and its sector (the JAX representatives) with the
    index in ``mode`` (``lin`` falls back to ``bsearch`` where the
    representatives admit no Lin table)."""
    labels, reps = _jax_case(name)[:2]
    mt, _ = _model(name, "torch")
    s = interop.repr_sector_from_numpy(mt, CASES[name][3], labels, reps)
    rb = s.dbasis
    if mode != "direct":
        rb.index = BasisIndex(rb.labels_np, mt.space.label_space, mode=mode,
                              lin_split=digit_split(mt.space), device=device)
    assert rb.index.mode in (mode, "bsearch")
    return mt, s


def _close(got, want, atol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert np.max(np.abs(got - want)) <= atol, np.max(np.abs(got - want))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_repr_rows_plain_matches_jax(name, mode):
    """(a) H x through the kernel's formulation equals the JAX MatvecRepr
    to 1e-12; MatvecRepr on CPU tensors is that plain version."""
    _, _, x, want, _ = _jax_case(name)
    mt, s = _port_case(name, mode)
    mv = s.matvec
    assert isinstance(mv, MatvecRepr)
    xt = torch.as_tensor(x)
    ar.reset_launches()
    y = _repr_rows_plain(*mv.args(), xt)
    _close(y, want)
    torch.testing.assert_close(mv(xt), y, rtol=0, atol=0)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)
    if name == "three_spin12_k3":
        assert mv.tables.gsel is not None          # arity 3 columns
    if name.startswith(("kagome", "honeycomb")):
        assert mv.trans.qmask is not None and s.dbasis.fodd is not None


def _scatter_case(kind):
    """(port model, source and destination sectors, compiled A, x, the JAX
    package's A x) for one scatter case."""
    import models_zoo as jz
    from quantum_basis_tpu import Mopr as JMopr, Opr as JOpr
    from quantum_basis_tpu.ops.apply_repr import mopr_x_vec_repr as jax_mxv

    if kind == "fermion_density_wave":
        q = (1, 0)
        build, names, vals, k = CASES["honeycomb_3x2_k10"]
        dst_vals = vals
    else:
        q = 1 if kind == "sz_q" else 5
        build, names, vals, k = CASES["chain12_k1"]
        dst_vals = [0.0] if kind == "sz_q" else [-1.0]
    mj, oj = build(jz)
    mt, _ = build(tz)
    kd = [(a - b) % L for a, b, L in zip(k, np.atleast_1d(q),
                                         mt.lattice.L)]
    A, Aj = tz.Mopr(), JMopr()
    if kind == "fermion_density_wave":
        lat = mt.lattice
        n_diag = np.array([0.0, 1.0])
        for i in range(lat.n_sites):
            ph = np.exp(-2j * np.pi * float(
                lat.k_dot_R(q, lat.site2coor(i)[0])[0]))
            A += complex(ph) * tz.Opr(i, 0, False, n_diag)
            Aj += complex(ph) * JOpr(i, 0, False, n_diag)
    else:
        op = "Sz" if kind == "sz_q" else "Sm"
        for x in range(12):
            ph = np.exp(-2j * np.pi * q * x / 12)
            A += complex(ph) * tz.Opr(x, 0, False, tz.SP_HALF[op])
            Aj += complex(ph) * JOpr(x, 0, False, jz.SP_HALF[op])
    mj.enumerate_basis_repr(k, [oj[c] for c in names], vals, sec=0)
    _, labels0, reps0 = mj._repr_cache
    mj.enumerate_basis_repr(kd, [oj[c] for c in names], dst_vals, sec=1)
    _, labels1, reps1 = mj._repr_cache
    src = interop.repr_sector_from_numpy(mt, k, labels0, reps0, sec=0)
    dst = interop.repr_sector_from_numpy(mt, kd, labels1, reps1, sec=1)
    rng = np.random.default_rng(9)
    n = src.dim
    x = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    yr, yi = jax_mxv(mj.compile_op(Aj), mj.sec_repr[0].dbasis,
                     mj.sec_repr[1].dbasis, (x.real, x.imag))
    want = np.asarray(yr) + 1j * np.asarray(yi)
    return mt, src, dst, mt.compile_op(A), x, want


@pytest.mark.parametrize("kind", ["sz_q", "sminus_q", "fermion_density_wave"])
def test_repr_scatter_plain_matches_jax(kind):
    """(b) A x from sector k into k - q equals the JAX mopr_x_vec_repr to
    1e-12: Sz(q) (every column diagonal: the no-translation path), S^-(q)
    into Sz=-1 and a fermionic density wave on the honeycomb lattice."""
    mt, src, dst, op, x, want = _scatter_case(kind)
    tabs = pack_rows(op, "cpu")
    assert tabs.diag_only == (kind != "sminus_q")
    assert np.linalg.norm(want) > 0.1
    got = mopr_x_vec_repr(op, src.dbasis, dst.dbasis, torch.as_tensor(x))
    _close(got, want)
    plain = _repr_scatter_plain(*scatter_args(op, src.dbasis, dst.dbasis),
                                torch.as_tensor(x), src.dim)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(CASES))
def test_build_sparse_repr_on_images_matches_jax(name):
    """(c) The ELL built from repr_images' rows equals the JAX
    build_sparse_repr as a dense matrix (1e-12); the rows are
    _repr_images_plain's."""
    Hj = _jax_case(name)[4]
    mt, s = _port_case(name)
    ell = build_sparse_repr(s.matvec)
    Ht = _dense(s.dim, ell.cols.numpy(), ell.vals.numpy(), ell.diag.numpy())
    _close(Ht, Hj)
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, _, phase = s.matvec.args()
    c, v = repr_images(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase, 0,
                       s.dim)
    c2, v2 = _repr_images_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                phase, 0, s.dim)
    torch.testing.assert_close(c, c2, rtol=0, atol=0)
    torch.testing.assert_close(v, v2, rtol=0, atol=0)
    assert c.shape == (s.dim, tabs.n_cols)
    # one row block at a time gives the same rows
    h = s.dim // 2
    c3, v3 = repr_images(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase, h,
                         s.dim - h)
    torch.testing.assert_close(c3, c[h:], rtol=0, atol=0)
    torch.testing.assert_close(v3, v[h:], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["chain12_k1", "spin1_chain8_k2",
                                  "kagome_tj_1x2_k01", "honeycomb_3x2_k10",
                                  "three_spin12_k3"])
def test_incremental_translation_and_mask_parity_exact(name):
    """(d) The kernels' translation of every image of random labels (rows
    of the whole label space, not only the sector's, plus states whose
    orbits tie) equals transform_all's: the minimum label and the sign
    exactly, and g* is the first g that reaches the minimum."""
    mt, _ = _model(name, "torch")
    space, tset = mt.space, mt.tset
    rt = translation_tables(tset)
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    rng = np.random.default_rng(5)
    lab = rng.integers(0, space.label_space, size=400)
    # periodic states: every translation of one maps to a few labels
    V = np.zeros((4, space.n_slots), np.int64)
    V[1, ::2] = 1
    V[2] = np.arange(space.n_slots) % 2
    V[3, ::3] = 1
    V = np.minimum(V, space.dims - 1)
    lab = torch.as_tensor(np.concatenate([lab, space.encode(V)]))
    Vr = space.decode(lab)
    fodd = None
    if space.fermionic:
        F = torch.as_tensor(space.fermion_count_table)[
            torch.arange(space.n_slots), Vr]
        fodd = ((F.long() & 1) << torch.arange(space.n_slots)).sum(-1)
    from quantum_basis_tpu_torch.ops.apply import _row_images

    amp, tgt = _row_images(tabs, lab, Vr, fodd)
    rmin, gs, sig = _orbit_min_plain(rt, column_slots(tabs).long(), Vr,
                                     fodd, tgt)
    Vm = space.decode(tgt)
    tl, tsign = tset.transform_all(
        Vm, tset.fermion_counts(Vm) if tset.fermionic else None)
    want_min = tl.min(-1).values
    first = torch.as_tensor(np.argmin(tl.numpy(), axis=-1))
    live = amp != 0
    assert torch.equal(rmin[live], want_min[live])
    assert torch.equal(gs[live], first[live])
    assert torch.equal(sig[live],
                       tsign.gather(-1, first[..., None])[..., 0][live])
    ties = (tl == want_min[..., None]).sum(-1) > 1
    assert bool((ties & live).any())                  # ties were taken
    if space.fermionic:
        assert bool((sig[live] < 0).any())            # signs were taken


def test_dispatch_cpu_counts_nothing_meta_raises():
    """(e) CPU tensors run the plain versions and count no launch; a meta
    tensor raises."""
    mt, s = _port_case("chain12_k1")
    mv = s.matvec
    x = torch.as_tensor(_jax_case("chain12_k1")[2])
    ar.reset_launches()
    y = repr_rows(*mv.args(), x)
    args = mv.args()
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = args
    z = repr_scatter(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag,
                     phase_table(s.dbasis.tset, s.dbasis.momentum, +1), x,
                     s.dim)
    # H is Hermitian: its scatter from k into k is the same matrix
    torch.testing.assert_close(z, y, rtol=0, atol=1e-12)
    repr_images(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase, 0, s.dim)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)
    xm = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        repr_rows(*args, xm)
    with pytest.raises(ValueError, match="unsupported device"):
        repr_scatter(*args, xm, s.dim)
    with pytest.raises(ValueError, match="unsupported device"):
        repr_images(rt, tabs, ix, labels, fodd, isn.to("meta"), sqrt_nu,
                    phase, 0, s.dim)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)


def test_cuda_arg_checks_refuse_what_the_kernels_do_not_take():
    """(e) The checks a CUDA launch makes first, run on CPU tensors."""
    mt, s = _port_case("kagome_tj_1x2_k01")
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = s.matvec.args()
    x = torch.zeros(s.dim, dtype=torch.complex128)
    n = s.dim
    _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x, n)
    bad = {
        "x real": (labels, fodd, isn, sqrt_nu, diag, phase, x.real.clone()),
        "x strided": (labels, fodd, isn, sqrt_nu, diag, phase,
                      torch.zeros(2 * n, dtype=torch.complex128)[::2]),
        "labels int32": (labels.int(), fodd, isn, sqrt_nu, diag, phase, x),
        "labels short": (labels[: n - 1], fodd, isn, sqrt_nu, diag, phase,
                         x),
        "fodd missing": (labels, None, isn, sqrt_nu, diag, phase, x),
        "isn float32": (labels, fodd, isn.float(), sqrt_nu, diag, phase, x),
        "sqrt_nu short": (labels, fodd, isn, sqrt_nu[: n - 1], diag, phase,
                          x),
        "diag float32": (labels, fodd, isn, sqrt_nu, diag.float(), phase, x),
        "phase complex": (labels, fodd, isn, sqrt_nu, diag,
                          torch.complex(phase[:, 0], phase[:, 1]), x),
    }
    for what, a in bad.items():
        with pytest.raises(ValueError):
            _check_args(rt, tabs, ix, *a, n)
            raise AssertionError(f"{what} passed the checks")
    half = ar.TransTables(sp=rt.sp, sstride=rt.sstride, sdim=rt.sdim,
                          oddmask=rt.oddmask, qmask=None, bits=rt.bits)
    with pytest.raises(ValueError, match="fermionic"):
        _check_args(half, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                    x, n)
    wide = ar.TransTables(sp=torch.zeros((64, rt.G), dtype=torch.int64),
                          sstride=torch.ones(64, dtype=torch.int64),
                          sdim=torch.ones(64, dtype=torch.int64),
                          oddmask=None, qmask=None, bits=True)
    with pytest.raises(ValueError, match="63 slots"):
        _check_args(wide, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase,
                    x, n)


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda(monkeypatch):
    """repr_rows, repr_scatter and repr_images on the card against their
    plain versions (1e-12 of max|y|; the images' columns exactly): a
    spin-1/2 chain at k = 1 (bit fields), the spin-1 chain (mixed radix),
    kagome t-J and the honeycomb fermions (signs), the three-site chain
    (arity 3), each in every index mode the representatives admit, with
    the tables in shared memory and in device memory, the rows' translated
    labels in shared memory and, with TR_SHARED_MAX = 0, in the device
    scratch; a spin-1/2 chain of 40 sites in a narrow Sz sector (2^40
    labels: a binary-search index, G = 40); Sz(q) and S^-(q) scattered."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"

    def close(got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-12 * max(float(want.abs().max()), 1e-300), err

    def check(mv, src=None):
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = mv.args()
        n = mv.n
        g = torch.Generator().manual_seed(3)
        x = torch.complex(torch.randn(n, generator=g, dtype=torch.float64),
                          torch.randn(n, generator=g, dtype=torch.float64)
                          ).to(dev)
        before = dict(ar.launches)
        close(mv(x), _repr_rows_plain(*mv.args(), x))
        ph = phase_table(mv.basis.tset, mv.basis.momentum, +1)
        close(repr_scatter(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag,
                           ph, x, n),
              _repr_scatter_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                  diag, ph, x, n))
        c, v = repr_images(rt, tabs, ix, labels, fodd, isn, sqrt_nu, phase,
                           0, n)
        c2, v2 = _repr_images_plain(rt, tabs, ix, labels, fodd, isn,
                                    sqrt_nu, phase, 0, n)
        torch.cuda.synchronize()
        assert torch.equal(c, c2)
        close(v, v2)
        assert all(ar.launches[k] == before[k] + 1 for k in ar.KERNELS)

    cases = [(tz.heisenberg_chain(12, device=dev), ["Sz"], [0.0], [1]),
             (tz.heisenberg_chain(8, spin="1", device=dev), ["Sz"], [0.0],
              [2]),
             (tz.kagome_tj(1, 2, device=dev), ["N", "Sz"], [4.0, 0.0],
              [0, 1]),
             (tz.spinless_fermion_honeycomb(3, 2, device=dev), ["N"], [4.0],
              [1, 0]),
             (tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr, tz.Mopr,
                                       12, device=dev), ["Sz"], [0.0], [3])]
    for (m, ops), names, vals, k in cases:
        m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
        rb = m.sec_repr[0].dbasis
        for mode in MODES:
            if mode != "direct":
                rb.index = BasisIndex(rb.labels_np, m.space.label_space,
                                      mode=mode,
                                      lin_split=digit_split(m.space),
                                      device=dev)
            mv = MatvecRepr(m.compiled_Ham, rb)
            for tmax, rmax in ((ar.TABLES_SHARED_MAX, ar.TR_SHARED_MAX),
                               (0, 0)):
                monkeypatch.setattr(ar, "TABLES_SHARED_MAX", tmax)
                monkeypatch.setattr(ar, "TR_SHARED_MAX", rmax)
                check(mv)
            monkeypatch.undo()
    m, ops = tz.heisenberg_chain(40, device=dev)
    m.enumerate_basis_repr([3], [ops["Sz"]], [17.0])
    rb = m.sec_repr[0].dbasis
    assert rb.index.mode == "bsearch" and rb.tset.G == 40
    check(m.sec_repr[0].matvec)
    monkeypatch.setattr(ar, "TR_SHARED_MAX", 0)
    check(m.sec_repr[0].matvec)
