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
  launch refuse what the kernels do not take;
- (f) the entry path's per-entry tables (each entry's change of every
  translated label, its Fodd change) against the JAX TranslationSet's
  translation of every image, and the keyed minimum's orbit minimum,
  first g and sign;
- (g) both formulations the kernels take (the entry path, the general
  path) against the JAX MatvecRepr, build_sparse_repr and
  mopr_x_vec_repr, and an operator with no image column;
- (h) the entry path's bounds, the absent-row direct index, a launch
  record built from CPU tensors without a launch (its fields, blob,
  moved checks and refusals) and the label buffer's rules (one a device,
  grown, the previous basis' labels cleared).

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
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.ops import apply_repr as ar
from quantum_basis_tpu_torch.ops.apply import pack_rows
from quantum_basis_tpu_torch.ops.apply_repr import (
    MatvecRepr,
    _orbit_min_plain,
    _repr_ell_plain,
    _repr_rows_plain,
    _repr_scatter_plain,
    column_slots,
    mopr_x_vec_repr,
    phase_table,
    scatter_args,
    translation_tables,
)
from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

MODES = ["direct", "lin", "bsearch"]


def _with(make, L):
    def build(pkg):
        if pkg == "torch":
            return make(tz.Lattice, tz.Model, tz.Opr, tz.Mopr, L,
                        device="cpu")
        import quantum_basis_tpu as qj

        return make(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, L)
    return build


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
    "three_spin12_k3": (_with(tz.three_spin_chain_with, 12), ["Sz"], [0.0],
                        [3]),
    # complex amplitudes (a Dzyaloshinskii-Moriya term)
    "dm_chain10_k2": (_with(tz.dm_chain_with, 10), ["Sz"], [0.0], [2]),
}
# the cases built through the package's classes (not a model zoo)
_WITH = ("three_spin12_k3", "dm_chain10_k2")


def _model(name, pkg):
    build = CASES[name][0]
    if name in _WITH:
        return build(pkg)
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
    _repr_images_plain's images compacted (_repr_ell_plain)."""
    Hj = _jax_case(name)[4]
    mt, s = _port_case(name)
    ell = build_sparse_repr(s.matvec)
    Ht = _dense(s.dim, ell.cols.numpy(), ell.vals.numpy(), ell.diag.numpy())
    _close(Ht, Hj)
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, _, phase = s.matvec.args()
    img = s.matvec.record("repr_images")
    c, v = img.images(0, s.dim)
    c2, v2 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                             phase, 0, s.dim)
    torch.testing.assert_close(c, c2, rtol=0, atol=0)
    torch.testing.assert_close(v, v2, rtol=0, atol=0)
    assert c.shape == (s.dim, ell.width) and torch.equal(c, ell.cols)
    # a part of the rows gives the same rows, at its own width
    h = s.dim // 2
    c3, v3 = img.images(h, s.dim - h)
    w = c3.shape[1]
    torch.testing.assert_close(c3, c[h:, :w], rtol=0, atol=0)
    torch.testing.assert_close(v3, v[h:, :w], rtol=0, atol=0)
    assert not bool(v[h:, w:].abs().any())


@pytest.mark.parametrize("name", ["chain12_k1", "spin1_chain8_k2",
                                  "kagome_tj_1x2_k01", "honeycomb_3x2_k10",
                                  "three_spin12_k3", "dm_chain10_k2"])
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


def _random_rows(space, seed=5):
    """Random labels of the whole label space plus periodic states whose
    orbits tie, their slot values and odd-count slots (or None)."""
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, space.label_space, size=400)
    V = np.zeros((4, space.n_slots), np.int64)
    V[1, ::2] = 1
    V[2] = np.arange(space.n_slots) % 2
    V[3, ::3] = 1
    V = np.minimum(V, space.dims - 1)
    lab = torch.as_tensor(np.concatenate([lab, space.encode(V)]))
    Vr = space.decode(lab).long()
    fodd = None
    if space.fermionic:
        F = torch.as_tensor(space.fermion_count_table)[
            torch.arange(space.n_slots), Vr]
        fodd = ((F.long() & 1) << torch.arange(space.n_slots)).sum(-1)
    return lab, Vr, fodd


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_tables_match_jax_translation(name):
    """(f) The entry path's per-entry tables against the JAX package's
    translation of every image of random labels: each live image's change
    of every translated label (erow's words, shifted back) equals the JAX
    TranslationSet's T_g(m) - T_g(r), and its Fodd change the parity of m's
    fermion counts; the keyed minimum gives the JAX orbit minimum, the
    first g* at it (ties taken) and its sign exactly."""
    import jax.numpy as jnp

    from quantum_basis_tpu_torch.ops.apply import _OFFSET, _row_images

    mt, _ = _model(name, "torch")
    mj, _ = _model(name, "jax")
    space, tj = mt.space, mj.tset
    rt = translation_tables(mt.tset)
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    et = ar.entry_tables(rt, tabs)
    G = rt.G
    assert et.gb == min(b for b in ar.BUCKETS if b >= G)
    assert et.erow.shape == (tabs.ad.shape[0], et.gb + 4)
    assert (et.fx is not None) == space.fermionic
    lab, Vr, fodd = _random_rows(space)
    amp, tgt = _row_images(tabs, lab, Vr, fodd)
    live = (amp != 0) & ~tabs.diagonal[None, :]

    def jax_translate(V):
        F = (space.fermion_count_table[np.arange(space.n_slots), V]
             if space.fermionic else np.zeros_like(V))
        tl, sg = tj.transform_all(jnp.asarray(V), jnp.asarray(F))
        return np.asarray(tl), np.asarray(sg), F
    Vm = space.decode(tgt).numpy()
    tl_m, sg_m, F_m = jax_translate(Vm)
    tl_r = jax_translate(Vr.numpy())[0]
    # the tables, entry by entry
    c = (Vr[:, tabs.slots.long()] * tabs.strides).sum(-1)
    idx = (tabs.rec[:, 0].long() & _OFFSET) + c
    words = et.erow[idx][..., 4:4 + G].long()
    delta = torch.where(words >= 0, words, words + (1 << 32))
    delta = torch.where(delta >= 1 << 31, delta - (1 << 32), delta)
    want = tl_m - tl_r[:, None, :]
    got = (delta.numpy() >> et.shift)
    L = live.numpy()
    assert np.array_equal(got[L], want[L])
    if space.fermionic:
        fm = ((F_m & 1) << np.arange(space.n_slots)).sum(-1)
        assert np.array_equal((fodd[:, None] ^ et.fx[idx]).numpy()[L], fm[L])
    # the keyed minimum against the JAX orbit minimum and first g*
    amp2, rmin, gs, sig = ar._entry_images_plain(et, rt, tabs, Vr, fodd)
    assert torch.equal(amp2[live], amp[live].to(torch.complex128))
    want_min = tl_m.min(-1)
    first = np.argmin(tl_m, axis=-1)
    assert np.array_equal(rmin.numpy()[L], want_min[L])
    assert np.array_equal(gs.numpy()[L], first[L])
    assert np.array_equal(sig.numpy()[L],
                          np.take_along_axis(sg_m, first[..., None],
                                             -1)[..., 0][L])
    ties = (tl_m == want_min[..., None]).sum(-1) > 1
    assert bool((ties & L).any())                      # ties were taken
    if space.fermionic:
        assert bool((sig.numpy()[L] < 0).any())         # signs were taken


@pytest.mark.parametrize("path", ["entry", "general"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_paths_match_jax(name, path, monkeypatch):
    """(g) H x through each formulation the kernels take, the entry path
    (the per-entry tables) and the general one (ENTRY_TABLES_MAX = 0: the
    per-slot int64 translation), equals the JAX MatvecRepr to 1e-12, and
    the ELL built from repr_images' rows the JAX build_sparse_repr."""
    if path == "general":
        monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", 0)
    _, _, x, want, Hj = _jax_case(name)
    mt, s = _port_case(name)
    args = s.matvec.args()
    plan = ar.entry_plan(*args[:3])
    assert (plan is None) == (path == "general")
    _close(_repr_rows_plain(*args, torch.as_tensor(x)), want)
    ell = build_sparse_repr(s.matvec)
    _close(_dense(s.dim, ell.cols.numpy(), ell.vals.numpy(),
                  ell.diag.numpy()), Hj)


@pytest.mark.parametrize("kind", ["sz_q", "sminus_q", "fermion_density_wave"])
def test_repr_scatter_general_path_matches_jax(kind, monkeypatch):
    """(g) A x through the general path's formulation (ENTRY_TABLES_MAX =
    0) equals the JAX mopr_x_vec_repr to 1e-12, as the entry path does
    (test (b))."""
    monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", 0)
    mt, src, dst, op, x, want = _scatter_case(kind)
    args = scatter_args(op, src.dbasis, dst.dbasis)
    assert ar.entry_plan(*args[:3]) is None
    _close(_repr_scatter_plain(*args, torch.as_tensor(x), src.dim), want)
    _close(mopr_x_vec_repr(op, src.dbasis, dst.dbasis, torch.as_tensor(x)),
           want)


def test_entry_plan_limits(monkeypatch):
    """(h) The entry path's bounds: G above the last bucket, keys past 2^32
    (label space << shift), 2^31 rows and the staged blob past
    ENTRY_TABLES_MAX send the operator to the general path."""
    mt, s = _port_case("chain12_k1")
    rt, tabs, ix = s.matvec.args()[:3]
    et = ar.entry_plan(rt, tabs, ix)
    assert et is not None and et.gb == 16 and et.shift == 4
    assert ar.entry_plan(rt, tabs,
                         ix._replace(label_space=(1 << 28) - 1)) is et
    assert ar.entry_plan(rt, tabs, ix._replace(label_space=1 << 28)) is None
    assert ar.entry_plan(rt, tabs, ix._replace(n=1 << 31)) is None
    wide = ar.TransTables(sp=torch.zeros((rt.S, 33), dtype=torch.int64),
                          sstride=rt.sstride, sdim=rt.sdim, oddmask=None,
                          qmask=None, bits=True)
    assert ar.entry_plan(wide, tabs, ix) is None
    _, size = ar._blob_layout(tabs.n_cols, tabs.ad.shape[0], rt.S, rt.G, 16,
                              False)
    monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", size)
    assert ar.entry_plan(rt, tabs, ix) is et
    monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", size - 1)
    assert ar.entry_plan(rt, tabs, ix) is None


def test_all_diagonal_operator_in_fermionic_space():
    """(b) An operator with no image column at all (a real diagonal, folded
    out of the term tables) in a fermionic space: the total density N
    scattered from the honeycomb sector into itself is N x = 4 x, through
    the launch record's entry path (empty entry tables) and the general
    path."""
    mt, s = _port_case("honeycomb_3x2_k10")
    ops = _model("honeycomb_3x2_k10", "torch")[1]
    op = mt.compile_op(ops["N"])
    tabs = pack_rows(op, "cpu")
    assert tabs.n_cols == 0 and tabs.ad.shape[0] == 0
    x = torch.as_tensor(_jax_case("honeycomb_3x2_k10")[2])
    rec = ar.scatter_launch(op, s.dbasis, s.dbasis)
    assert rec.entry is not None and rec.entry.fx.numel() == 0
    _close(rec(x), 4.0 * x.numpy())
    _close(mopr_x_vec_repr(op, s.dbasis, s.dbasis, x), 4.0 * x.numpy())


def test_absent_row_direct_index():
    """(h) A momentum basis' direct table marks the labels it does not hold
    with row n (IndexTables.absent): lookups stay in range and checked;
    the entry path takes only such a direct table (a plain one, the general
    path); the row kernels (K2) refuse it."""
    from quantum_basis_tpu_torch.basis.index import lookup_tables
    from quantum_basis_tpu_torch.ops.apply import _check_cuda_args

    mt, s = _port_case("chain12_k1")
    rb = s.dbasis
    ix = rb.index.tables
    assert ix.mode == "direct" and ix.absent
    n, labels = ix.n, ix.labels
    absent = torch.ones(ix.label_space, dtype=torch.bool)
    absent[labels] = False
    assert bool((ix.t0[absent] == n).all())
    assert torch.equal(ix.t0[labels].long(), torch.arange(n))
    tgt = torch.arange(ix.label_space)
    j = lookup_tables(ix, tgt)
    assert int(j.min()) >= 0 and int(j.max()) == n - 1
    assert torch.equal(rb.index.lookup_checked(tgt)[1], ~absent)
    rt, tabs = s.matvec.args()[:2]
    assert ar.entry_plan(rt, tabs, ix) is not None
    plain = BasisIndex(rb.labels_np, mt.space.label_space, device="cpu")
    assert not plain.tables.absent and int(plain.tables.t0[absent].max()) == 0
    assert ar.entry_plan(rt, tabs, plain.tables) is None
    assert BasisIndex(rb.labels_np, mt.space.label_space, mode="bsearch",
                      device="cpu", absent_row=True).tables.absent is False
    full = pack_rows(mt.compiled_Ham, "cpu")
    V = mt.space.decode(labels).to(torch.int8)
    x = torch.zeros(n, dtype=torch.float64)
    _check_cuda_args(full, plain.tables, labels, V, None, None, x, 0, n)
    with pytest.raises(ValueError, match="absent"):
        _check_cuda_args(full, ix, labels, V, None, None, x, 0, n)


@pytest.mark.parametrize("name", ["honeycomb_3x2_k10", "three_spin12_k3"])
def test_launch_record_built_on_cpu(name, monkeypatch):
    """(h) A launch record built from CPU tensors, without a launch: its
    fields (the path, the G bucket, the blob's regions and contents, the
    destination's row records), the checks moved to it (made once, when it
    is built), what a call still checks of x, and the plain version it
    runs on CPU tensors."""
    mt, s = _port_case(name)
    mv = s.matvec
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = mv.args()
    n = s.dim
    x = torch.as_tensor(_jax_case(name)[2])
    ar.reset_launches()
    # the card's bound: the CPU table holds 0 (no label buffer)
    monkeypatch.setitem(config.MEMORY["cpu"], "repr_label_buffer_max",
                        config.MEMORY["cuda"]["repr_label_buffer_max"])
    rec = mv.record()
    assert mv.record() is rec                       # built once
    assert rec.kind == "repr_rows" and rec.rows == n and rec.n_out == n
    p = rec.p
    et = rec.entry
    assert et is not None and p.gb == et.gb and p.G == rt.G
    # by label: the buffer is the device's, written at each launch
    assert rec.by_label and p.xlab is None and p.rrec is None
    assert (p.rows, p.n, p.E, p.S, p.threads) == (n, ix.n, tabs.n_cols,
                                                 rt.S, ar.THREADS)
    assert p.mode == 0 and p.x is None and p.y is None
    off, size = ar._blob_layout(tabs.n_cols, tabs.ad.shape[0], rt.S, rt.G,
                                et.gb, rt.qmask is not None)
    assert p.blob_bytes == size
    assert (p.o_erow, p.o_fx, p.o_sp, p.o_slot, p.o_phase, p.o_q) == tuple(
        off[k] for k in ("erow", "fx", "sp", "slot", "phase", "q"))
    blob = next(t for t in rec._keep if t.data_ptr() == p.blob)
    assert blob.dtype == torch.int32 and 4 * blob.numel() == size

    def region(name, words, dt=torch.int32):
        return blob[off[name] // 4: off[name] // 4 + words].view(dt)
    E, M = tabs.n_cols, tabs.ad.shape[0]
    assert torch.equal(region("rec", 4 * E).view(E, 4), tabs.rec)
    assert torch.equal(region("erow", M * (et.gb + 4)), et.erow.view(-1))
    assert torch.equal(region("sp", rt.S * (et.gb + 4)), et.sp32.view(-1))
    assert torch.equal(region("phase", 4 * rt.G, torch.float64),
                       phase.view(-1))
    if rt.qmask is not None:
        assert p.o_fx >= 0 and p.o_q >= 0
        assert torch.equal(region("fx", 2 * M, torch.int64), et.fx)
        assert torch.equal(region("q", 2 * rt.G * rt.S, torch.int64),
                           rt.qmask.view(-1))
    rrec = s.dbasis.row_records()
    assert torch.equal(rrec[:, 0], ix.labels)
    assert torch.equal(rrec[:, 1].view(torch.float64), sqrt_nu[:n])
    # a CPU call runs the plain version and launches nothing
    torch.testing.assert_close(rec(x), _repr_rows_plain(*mv.args(), x),
                               rtol=0, atol=0)
    img = mv.record("repr_images")
    assert img.p.rrec == rrec.data_ptr() and not img.by_label
    assert img.p.xlab is None
    c, v = img.images(0, n)
    c2, v2 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                             phase, 0, n)
    assert torch.equal(c, c2) and torch.equal(v, v2)
    sc = ar.scatter_launch(mt.compiled_Ham, s.dbasis, s.dbasis)
    torch.testing.assert_close(sc(x), rec(x), rtol=0, atol=1e-12)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)
    # what a call checks of x, and what a record refuses to be called with
    for bad in (x.real.clone(), torch.zeros(2 * n, dtype=torch.complex128)
                [::2], x[: n - 1].clone()):
        with pytest.raises(ValueError):
            ar._check_x(bad, rec.device, rec.rows)
    with pytest.raises(ValueError, match="unsupported device"):
        rec(x.to("meta"))
    with pytest.raises(TypeError):
        img(x)
    with pytest.raises(TypeError):
        rec.images(0, n)
    with pytest.raises(ValueError, match="outside"):
        img.images(1, n)
    with pytest.raises(ValueError, match="unknown repr kernel"):
        ar.ReprLaunch("repr_gather", *mv.args(), n)
    # the checks moved to the record: made when it is built
    bad = {"labels int32": (3, labels.int()), "fodd missing": (4, None),
           "isn float32": (5, isn.float()), "sqrt_nu short": (6, sqrt_nu[:1]),
           "diag float32": (7, diag.float()),
           "phase complex": (8, torch.complex(phase[:, 0], phase[:, 1]))}
    for what, (k, t) in bad.items():
        a = list(mv.args())
        a[k] = t
        if what == "fodd missing" and rt.qmask is None \
                and tabs.wmask is None:
            continue
        with pytest.raises(ValueError):
            ar.ReprLaunch("repr_rows", *a, n)
            raise AssertionError(f"{what} passed the checks")
    with pytest.raises(ValueError, match="row records"):
        ar.ReprLaunch("repr_images", *mv.args(), n, rrec=rrec[1:])
    # past the label buffer's bound repr_rows takes the general path
    monkeypatch.setitem(config.MEMORY["cpu"], "repr_label_buffer_max",
                        16 * ix.label_space - 1)
    small = ar.ReprLaunch("repr_rows", *mv.args(), n)
    assert small.entry is None and not small.by_label and small.p.gb == 0
    assert ar.ReprLaunch("repr_images", *mv.args(), n).entry is not None
    # the general path: no blob, no G bucket; a new index, a new record
    monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", 0)
    gen = ar.ReprLaunch("repr_rows", *mv.args(), n)
    assert gen.entry is None and gen.p.gb == 0 and gen.p.blob is None
    torch.testing.assert_close(gen(x), rec(x), rtol=0, atol=1e-12)
    s.dbasis.index = BasisIndex(s.dbasis.labels_np, mt.space.label_space,
                                mode="bsearch", device="cpu")
    rec2 = mv.record()
    assert rec2 is not rec and rec2.p.mode == 2 and rec2.entry is None
    torch.testing.assert_close(rec2(x), rec(x), rtol=0, atol=1e-12)


def test_label_buffer_is_one_a_device():
    """(h) The label buffer, held to its rules with CPU tensors: one a
    device; grown (zeros) to the largest label space asked; the previous
    basis' labels handed to the clear when another basis claims it, and
    nothing cleared while one basis keeps it; freed with the basis that
    used it last."""
    lb = ar.LabelBuffer(torch.device("cpu"))
    cleared = []

    def clear(buf, labels):
        cleared.append(labels)
        buf[labels] = 0.0
    a, b = torch.tensor([1, 5, 9]), torch.tensor([2, 5])
    buf = lb.claim(a, 12, 0, clear)
    assert buf.shape == (12, 2) and not bool(buf.any()) and lb.owner is a
    buf[a] = 7.0                                    # a's pre-pass
    assert lb.claim(a, 12, 0, clear) is buf and cleared == []
    assert lb.claim(b, 10, 0, clear) is buf         # no smaller buffer
    assert len(cleared) == 1 and cleared[0] is a and lb.owner is b
    assert not bool(buf.any())
    buf[b] = 3.0
    big = lb.claim(a, 20, 0, clear)                 # grown: zeros
    assert big.shape == (20, 2) and not bool(big.any()) and len(cleared) == 1
    assert lb.owner is a and lb.buf is big
    buf = lb.claim(b, 20, 0, clear)                 # a's labels cleared
    assert buf is big and cleared[-1] is a and lb.owner is b
    del a, cleared[:]                               # a gone: b holds it
    assert lb.buf is big
    del b, buf, big                                 # b gone: freed
    assert lb.buf is None and lb.owner is None
    dev = torch.device("cuda", 0)
    assert ar.LabelBuffer.of(dev) is ar.LabelBuffer.of("cuda:0")


def test_dispatch_cpu_counts_nothing_meta_raises():
    """(e) CPU tensors run the plain versions and count no launch; a meta
    tensor raises."""
    mt, s = _port_case("chain12_k1")
    mv = s.matvec
    x = torch.as_tensor(_jax_case("chain12_k1")[2])
    ar.reset_launches()
    y = mv(x)
    args = mv.args()
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = args
    sc = ar.scatter_launch(mt.compiled_Ham, s.dbasis, s.dbasis)
    z = sc(x)
    # H is Hermitian: its scatter from k into k is the same matrix
    torch.testing.assert_close(z, y, rtol=0, atol=1e-12)
    mv.record("repr_images").images(0, s.dim)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)
    xm = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        mv.record()(xm)
    with pytest.raises(ValueError, match="unsupported device"):
        sc(xm)
    with pytest.raises(ValueError, match="unsupported device"):
        ar.ReprLaunch("repr_images", rt, tabs, ix, labels.to("meta"), fodd,
                      isn, sqrt_nu, None, phase, s.dim)
    assert ar.launches == dict.fromkeys(ar.KERNELS, 0)


def _check_args(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase, x,
                rows):
    """Every check before a launch: x's (each call's), then the launch
    record's (made when it is built)."""
    ar._check_x(x, x.device, rows)
    ar.ReprLaunch("repr_rows", rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                  diag, phase, rows)


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
    plain versions (1e-12 of max|y|; the images' columns exactly), through
    the engines' launch records and records built apart: a spin-1/2 chain
    at k = 1 (bit fields, G bucket 16), the spin-1 chain (mixed radix,
    bucket 8), kagome t-J and the honeycomb fermions (signs, bucket 8), the
    three-site chain (arity 3), the DM chain (complex amplitudes) and a
    chain of 20 sites (bucket 32), each in every index mode the
    representatives admit, on the entry path and on the general path
    (ENTRY_TABLES_MAX = 0) with its tables in shared memory and in device
    memory and the rows' translated labels in shared memory and, with
    TR_SHARED_MAX = 0, in the device scratch; a spin-1/2 chain of 40 sites
    in a narrow Sz sector (2^40 labels: the general path's int64, a
    binary-search index, G = 40); the H scatter of chain-20 repeated 20
    times, its spread within 1e-13 of max|y|. repr_rows reaches rows by
    label (the device's label buffer) on the entry path; two sectors'
    engines in turns, and one on another stream, share that one buffer
    (the previous sector's labels cleared at each change)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"

    def close(got, want, spread=0.0):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        scale = max(float(want.abs().max()), 1e-300)
        assert err <= max(1e-12 * scale, 4 * spread), err

    def check(mv, entry):
        rec = mv.record()
        assert (rec.entry is not None) == entry, rec.p.gb
        # the engine reaches rows by label on the entry path
        assert rec.by_label == entry
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = mv.args()
        n = mv.n
        g = torch.Generator().manual_seed(3)
        x = torch.complex(torch.randn(n, generator=g, dtype=torch.float64),
                          torch.randn(n, generator=g, dtype=torch.float64)
                          ).to(dev)
        before = dict(ar.launches)
        yp = _repr_rows_plain(*mv.args(), x)
        close(mv(x), yp)
        assert (rec.p.xlab is not None) == entry
        if entry:
            spaces.append(ix.label_space)
        close(ar.ReprLaunch("repr_rows", *mv.args(), n)(x), yp)
        ph = phase_table(mv.basis.tset, mv.basis.momentum, +1)
        sargs = (rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, ph)
        zp = _repr_scatter_plain(*sargs, x, n)
        sc = ar.ReprLaunch("repr_scatter", *sargs, n,
                           rrec=mv.basis.row_records())
        close(sc(x), zp)
        close(sc(x), zp)
        img = ar.ReprLaunch("repr_images", rt, tabs, ix, labels, fodd, isn,
                            sqrt_nu, None, phase, n)
        c, v = img.images(0, n)
        c2, v2 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                 phase, 0, n)
        torch.cuda.synchronize()
        assert torch.equal(c, c2)
        close(v, v2)
        h = n // 2
        c3, v3 = mv.record("repr_images").images(h, n - h)
        c4, v4 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                 phase, h, n - h)
        torch.cuda.synchronize()
        assert torch.equal(c3, c4)
        close(v3, v4)
        # an images call is two launches: the count pass and the rows
        want = {"repr_rows": 2, "repr_scatter": 2, "repr_images": 4}
        assert rec.p.gb == (rec.entry.gb if entry else 0)
        assert all(ar.launches[k] == before[k] + want[k] for k in ar.KERNELS)

    settings = (  # (entry path, ENTRY_TABLES_MAX, TABLES_SHARED_MAX,
                  # TR_SHARED_MAX)
        (True, ar.ENTRY_TABLES_MAX, ar.TABLES_SHARED_MAX, ar.TR_SHARED_MAX),
        (False, 0, ar.TABLES_SHARED_MAX, ar.TR_SHARED_MAX),
        (False, 0, 0, 0))
    cases = [(tz.heisenberg_chain(12, device=dev), ["Sz"], [0.0], [1]),
             (tz.heisenberg_chain(8, spin="1", device=dev), ["Sz"], [0.0],
              [2]),
             (tz.kagome_tj(1, 2, device=dev), ["N", "Sz"], [4.0, 0.0],
              [0, 1]),
             (tz.spinless_fermion_honeycomb(3, 2, device=dev), ["N"], [4.0],
              [1, 0]),
             (tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr, tz.Mopr,
                                       12, device=dev), ["Sz"], [0.0], [3]),
             (tz.dm_chain(10, device=dev), ["Sz"], [0.0], [2]),
             (tz.heisenberg_chain(20, device=dev), ["Sz"], [0.0], [3])]
    buckets, spaces = set(), []
    for (m, ops), names, vals, k in cases:
        m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
        rb = m.sec_repr[0].dbasis
        for mode in MODES:
            if mode != "direct":
                rb.index = BasisIndex(rb.labels_np, m.space.label_space,
                                      mode=mode,
                                      lin_split=digit_split(m.space),
                                      device=dev)
            for entry, emax, tmax, rmax in settings:
                monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", emax)
                monkeypatch.setattr(ar, "TABLES_SHARED_MAX", tmax)
                monkeypatch.setattr(ar, "TR_SHARED_MAX", rmax)
                mv = MatvecRepr(m.compiled_Ham, rb)
                check(mv, entry)
                if entry:
                    buckets.add(mv.record().p.gb)
            monkeypatch.undo()
    assert buckets == set(ar.BUCKETS)
    # two sectors of one space in turns, and one on another stream: one
    # label buffer, the other sector's labels cleared at each change
    m, ops = tz.heisenberg_chain(16, device=dev)
    for sec, k in enumerate(([1], [2])):
        m.enumerate_basis_repr(k, [ops["Sz"]], [0.0], sec=sec)
    mvs = [m.sec_repr[sec].matvec for sec in (0, 1)]
    xs = [torch.randn(mv.n, dtype=torch.complex128, device=dev)
          for mv in mvs]
    want = [_repr_rows_plain(*mv.args(), x) for mv, x in zip(mvs, xs)]
    for sec in (0, 1, 0, 1, 1, 0):
        assert mvs[sec].record().by_label
        close(mvs[sec](xs[sec]), want[sec])
    assert ar.LabelBuffer.of(dev).owner is mvs[0].basis.index.labels
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        y1 = mvs[1](xs[1])
    close(y1, want[1])
    close(mvs[0](xs[0]), want[0])
    # one buffer, of the largest label space taken by label (chain-20's)
    assert ar.LabelBuffer.held_bytes() == 16 * max(spaces)
    # the atomics' spread: the H scatter of chain-20 repeated
    mv = MatvecRepr(m.compiled_Ham, rb)
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, _ = mv.args()
    ph = phase_table(rb.tset, rb.momentum, +1)
    sc = ar.ReprLaunch("repr_scatter", rt, tabs, ix, labels, fodd, isn,
                       sqrt_nu, diag, ph, mv.n, rrec=rb.row_records())
    x = torch.randn(mv.n, dtype=torch.complex128, device=dev)
    runs = torch.stack([sc(x) for _ in range(20)])
    torch.cuda.synchronize()
    spread = float((runs - runs[0]).abs().max())
    zp = _repr_scatter_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag,
                             ph, x, mv.n)
    assert spread <= 1e-13 * float(zp.abs().max()), spread
    close(runs[-1], zp, spread)
    m, ops = tz.heisenberg_chain(40, device=dev)
    m.enumerate_basis_repr([3], [ops["Sz"]], [17.0])
    rb = m.sec_repr[0].dbasis
    assert rb.index.mode == "bsearch" and rb.tset.G == 40
    check(m.sec_repr[0].matvec, False)
    monkeypatch.setattr(ar, "TR_SHARED_MAX", 0)
    check(MatvecRepr(m.compiled_Ham, rb), False)
