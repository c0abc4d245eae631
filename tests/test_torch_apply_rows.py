"""The fused row apply (``ops/apply.py::apply_rows`` / ``scatter_rows`` over
the tables of ``pack_rows``, the kernels of ``csrc/apply_rows.cu``) on the
CPU, where both wrappers run their plain versions, against the JAX package.

The same model and sector go through both packages, the vectors from numpy
with a fixed seed; every comparison is to 1e-12 absolute:

- ``MatvecFull`` as the port routes it (one ``apply_rows`` call) against the
  JAX ``MatvecFull`` on the five models of ``test_torch_apply.py`` (the
  complex DM chain, the Jordan-Wigner-carrying t-J, Kondo and honeycomb), in
  all three index modes, on real and complex vectors; and on Hubbard 3x2,
  whose slots hold two fermions;
- ``mopr_x_vec`` (one ``scatter_rows`` call) against the JAX ``mopr_x_vec``
  from Sz=0 into Sz=-1 and for a fermionic hop with a complex coefficient,
  in every index mode of the destination;
- the packed Jordan-Wigner parity, popcount(Fodd & Wmask) mod 2, against
  (F @ W^T) mod 2 on Hubbard 3x2;
- a range of rows (``MatvecSharded``'s call) equal to the same rows of the
  whole apply, rows past the sector zero;
- the dispatch: a CPU tensor leaves the launch counts at 0, a ``meta``
  tensor raises, and the argument checks of a CUDA launch refuse what the
  kernel does not take.

One ``cuda``-marked test holds the kernels against their plain versions on
a chain-16 sector (and a t-J and a DM chain) in all three index modes; it
skips here. The JAX package is imported inside the tests that compare with
it: the card's machine, which runs the cuda-marked test, has no JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.interop import vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops import apply as ap
from quantum_basis_tpu_torch.ops.apply import (
    DeviceBasis,
    MatvecFull,
    _apply_rows_plain,
    _check_cuda_args,
    _parity,
    _scatter_rows_plain,
    apply_rows,
    mopr_x_vec,
    pack_rows,
    scatter_rows,
)

MODES = ["direct", "lin", "bsearch"]


def _jax():
    """The JAX package and its model builders."""
    import models_zoo as jz
    import quantum_basis_tpu as qj

    return jz, qj


def _tj8(pkg):
    if pkg == "torch":
        return tz.tj_chain(8)
    import test_golden_chain as g

    m, sz, n = g.build_tj_chain(8)
    return m, {"Sz": sz, "N": n}


def _dm10(pkg):
    if pkg == "torch":
        return tz.dm_chain(10, 0.3)
    _, qj = _jax()
    return tz.dm_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 10, 0.3)


def _zoo(pkg):
    return tz if pkg == "torch" else _jax()[0]


MODELS = {
    # name: (model function of "torch" / "jax", conserved names, values,
    #        complex Hamiltonian)
    "chain12_Sz0": (lambda p: _zoo(p).heisenberg_chain(12), ["Sz"], [0.0],
                    False),
    "tj_chain8_N6_Sz0": (_tj8, ["Sz", "N"], [0.0, 6.0], False),
    "kondo4_N4_Sz0": (lambda p: _zoo(p).kondo_chain(4, 1.3), ["N", "Sz"],
                      [4.0, 0.0], False),
    "honeycomb_3x2_N4": (lambda p: _zoo(p).spinless_fermion_honeycomb(3, 2),
                         ["N"], [4.0], False),
    "dm_chain10_Sz0": (_dm10, ["Sz"], [0.0], True),
    # two fermions a slot: the parity reads F mod 2
    "hubbard3x2_3_3": (lambda p: _zoo(p).fermi_hubbard_square(3, 2),
                       ["Nup", "Ndn"], [3.0, 3.0], False),
}
_BUILT: dict = {}
_JAX_Y: dict = {}


def _both(name):
    """(JAX model, port model), each with its sector 0 enumerated."""
    if name not in _BUILT:
        build, names, vals, _ = MODELS[name]
        out = []
        for pkg in ("jax", "torch"):
            m, ops = build(pkg)
            m.enumerate_basis_full([ops[c] for c in names], vals)
            out.append(m)
        _BUILT[name] = tuple(out)
    return _BUILT[name]


def _vec(n, vec, seed=11):
    rng = np.random.default_rng(seed)
    re = rng.standard_normal(n)
    return re, (rng.standard_normal(n) if vec == "complex" else None)


def _jax_apply(name, vec):
    if (name, vec) not in _JAX_Y:
        mj = _both(name)[0]
        re, im = _vec(mj.sec_full[0].dim, vec)
        yr, yi = mj.sec_full[0].matvec((re, im))
        _JAX_Y[name, vec] = (np.asarray(yr),
                             None if yi is None else np.asarray(yi))
    return _JAX_Y[name, vec]


def _assert_close(y: torch.Tensor, yr, yi):
    tr, ti = vec_to_split(y)
    np.testing.assert_allclose(tr, yr, rtol=0, atol=1e-12)
    if yi is None:
        assert ti is None or np.max(np.abs(ti)) == 0.0
    else:
        np.testing.assert_allclose(ti, yi, rtol=0, atol=1e-12)


def _basis(model, labels, mode, device="cpu", block_rows=64):
    """A DeviceBasis of ``labels`` whose index takes ``mode``."""
    index = BasisIndex(labels, model.space.label_space, mode=mode,
                       lin_split=digit_split(model.space), device=device)
    assert index.mode == mode   # a quantum-number sector is Lin-consistent
    return DeviceBasis(model.space, labels, index, block_rows=block_rows,
                       device=device)


def _rows(db):
    """The flat per-row arrays apply_rows / scatter_rows take."""
    return (db.labels_b.view(-1), db.V_b.view(-1, db.space.n_slots),
            db.fodd)


@pytest.mark.parametrize("vec", ["real", "complex"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(MODELS))
def test_matvec_full_packed_plain_matches_jax(name, mode, vec):
    mj, mt = _both(name)
    cplx = MODELS[name][3]
    st = mt.sec_full[0]
    np.testing.assert_array_equal(st.labels, mj.sec_full[0].labels)
    db = _basis(mt, st.labels, mode)
    assert db.n_blocks > 1 and db.pad > 0
    mv = MatvecFull(mt.compiled_Ham, db)
    assert mv.is_complex == cplx == mj.sec_full[0].matvec.is_complex
    re, im = _vec(st.dim, vec)
    x = vec_from_split(re, im, device="cpu")
    if cplx and vec == "real":
        with pytest.raises(ValueError):
            mv(x)
        return
    ap.launch_count = 0
    y = mv(x)
    assert ap.launch_count == 0          # the plain version, no launch
    assert y.is_complex() == (vec == "complex")
    _assert_close(y, *_jax_apply(name, vec))


def test_row_range_equals_whole_apply():
    """apply_rows over a range of rows (MatvecSharded's call: row0, n_out,
    n_valid) gives those rows of the whole apply, rows past the sector zero,
    with the plain version's row blocks held small (several per call)."""
    mt, ops = tz.tj_chain(10)
    mt.enumerate_basis_full([ops["Sz"], ops["N"]], [0.0, 8.0])
    st = mt.sec_full[0]
    n = st.dim
    db = _basis(mt, st.labels, "bsearch", block_rows=1000)
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    diag = MatvecFull(mt.compiled_Ham, db).diag_b.view(-1)
    re, im = _vec(n, "complex", seed=3)
    x = vec_from_split(re, im, device="cpu")
    with config.pinned(apply_block_budget=1):   # 1024-row blocks
        y = apply_rows(tabs, db.index.tables, *_rows(db), diag[:n], x, 0, n,
                       n)
        assert n > 2 * 1024
        for row0, n_out in ((0, 700), (700, n), (n - 5, 9), (n, 4)):
            z = torch.zeros(n_out, dtype=y.dtype)
            k = max(0, min(n - row0, n_out))   # rows inside the sector
            z[:k] = y[row0: row0 + k]
            pad = torch.zeros(n_out, dtype=torch.float64)
            pad[:k] = diag[row0: row0 + k]
            got = apply_rows(tabs, db.index.tables, *_rows(db), pad, x,
                             row0, n_out, n)
            assert got.shape == (n_out,)
            torch.testing.assert_close(got, z, rtol=0, atol=1e-14)


def _sminus_q(mod, L, q):
    """S^-_q = sum_x exp(i q x) S^-_x / sqrt(L): complex coefficients."""
    out = mod.Mopr()
    for x in range(L):
        out += (np.exp(1j * q * x) / np.sqrt(L)) * mod.Opr(
            x, 0, False, tz.SP_HALF["Sm"])
    return out


@pytest.mark.parametrize("mode", MODES)
def test_mopr_x_vec_between_sectors_matches_jax(mode):
    """S^-_q maps Sz=0 into Sz=-1 (the destination's index in ``mode``),
    real and complex vectors; within Sz=0 every image is dropped."""
    from quantum_basis_tpu.ops.apply import mopr_x_vec as jax_mopr_x_vec

    jz, qj = _jax()
    L, q = 10, 2 * np.pi * 3 / 10
    mj, oj = jz.heisenberg_chain(L)
    mt, ot = tz.heisenberg_chain(L)
    for m, o in ((mj, oj), (mt, ot)):
        m.enumerate_basis_full([o["Sz"]], [0.0], sec=0)
        m.enumerate_basis_full([o["Sz"]], [-1.0], sec=1)
    src = mt.sec_full[0].dbasis
    dst = _basis(mt, mt.sec_full[1].labels, mode)
    op_t = mt.compile_op(_sminus_q(tz, L, q))
    op_j = mj.compile_op(_sminus_q(qj, L, q))
    for vec in ("real", "complex"):
        re, im = _vec(src.n, vec, seed=5)
        yr, yi = jax_mopr_x_vec(op_j, mj.sec_full[0].dbasis,
                                mj.sec_full[1].dbasis, (re, im))
        ap.scatter_launch_count = 0
        y = mopr_x_vec(op_t, src, dst, vec_from_split(re, im, device="cpu"))
        assert ap.scatter_launch_count == 0
        assert y.shape == (dst.n,) and y.is_complex()
        _assert_close(y, np.asarray(yr), np.asarray(yi))
    same = _basis(mt, mt.sec_full[0].labels, mode)
    y = mopr_x_vec(op_t, src, same, vec_from_split(re, device="cpu"))
    assert float(y.abs().max()) == 0.0


@pytest.mark.parametrize("mode", MODES)
def test_mopr_x_vec_fermionic_complex_matches_jax(mode):
    """(0.3 + 0.8i) c^dag_{0,up} c_{4,up} in a t-J sector, with a string
    across sites 1..3 and the diagonal S^z_0 S^z_1 beside it: the scatter
    direction carries the sign and the amplitude unconjugated."""
    import test_golden_chain as g
    from quantum_basis_tpu.ops.apply import mopr_x_vec as jax_mopr_x_vec

    jz, qj = _jax()
    mj, szj, nj = g.build_tj_chain(6)
    mt, ot = tz.tj_chain(6)
    mj.enumerate_basis_full([szj, nj], [0.0, 4.0])
    mt.enumerate_basis_full([ot["Sz"], ot["N"]], [0.0, 4.0])

    def op(mod, c_up, sz):
        hop = (0.3 + 0.8j) * (mod.Opr(0, 0, True, c_up).dagger()
                              * mod.Opr(4, 0, True, c_up))
        szsz = mod.Opr(0, 0, False, sz) * mod.Opr(1, 0, False, sz)
        return hop + 0.7 * szsz

    sz = np.diag([0.0, 0.5, -0.5])
    st = mt.sec_full[0]
    re, im = _vec(st.dim, "complex", seed=9)
    yr, yi = jax_mopr_x_vec(mj.compile_op(op(qj, jz.TJ_C_UP, sz)),
                            mj.sec_full[0].dbasis, mj.sec_full[0].dbasis,
                            (re, im))
    op_t = mt.compile_op(op(tz, tz.TJ_C_UP, sz))
    assert op_t.groups and not op_t.diag_terms.q_zero()
    assert pack_rows(op_t, "cpu").wmask is not None
    y = mopr_x_vec(op_t, st.dbasis, _basis(mt, st.labels, mode),
                   vec_from_split(re, im, device="cpu"))
    _assert_close(y, np.asarray(yr), np.asarray(yi))


def test_popcount_parity_matches_matmul():
    """The packed sign, popcount(Fodd & Wmask) mod 2 per image column,
    equals the JAX package's (F @ W^T) mod 2 per term on Hubbard 3x2, whose
    slots hold 0, 1 or 2 fermions."""
    mt, ops = tz.fermi_hubbard_square(3, 2)
    mt.enumerate_basis_full([ops["Nup"], ops["Ndn"]], [3.0, 3.0])
    db = mt.sec_full[0].dbasis
    F = db.F_b.view(-1, mt.space.n_slots).long()
    assert (F == 2).any() and db.fodd is not None
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    assert tabs.wmask is not None
    got = _parity(db.fodd[:, None] & tabs.wmask)            # (rows, E)
    e = 0
    seen = set()
    for g in mt.compiled_Ham.groups:
        T, _, K = g.dlt.shape
        want = (F @ torch.as_tensor(g.W.T.astype(np.int64))) % 2  # (rows, T)
        for t in range(T):
            for _ in range(K):
                torch.testing.assert_close(got[:, e], want[:, t], rtol=0,
                                           atol=0)
                seen.update(want[:, t].unique().tolist())
                e += 1
    assert e == tabs.n_cols and seen == {0, 1}


def test_dispatch_cpu_counts_nothing_meta_raises():
    mt, ops = tz.heisenberg_chain(8)
    mt.enumerate_basis_full([ops["Sz"]], [0.0])
    db = mt.sec_full[0].dbasis
    n = db.n
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(n))
    ap.launch_count = ap.scatter_launch_count = 0
    y = apply_rows(tabs, db.index.tables, *_rows(db), None, x, 0, n, n)
    z = scatter_rows(tabs, db.index.tables, *_rows(db), None, x, n)
    assert ap.launch_count == ap.scatter_launch_count == 0
    torch.testing.assert_close(y, z, rtol=0, atol=1e-13)   # H real symmetric
    torch.testing.assert_close(
        y, _apply_rows_plain(tabs, db.index.tables, *_rows(db), None, x, 0,
                             n, n), rtol=0, atol=0)
    xm = x.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        apply_rows(tabs, db.index.tables, *_rows(db), None, xm, 0, n, n)
    with pytest.raises(ValueError, match="unsupported device"):
        scatter_rows(tabs, db.index.tables, *_rows(db), None, xm, n)
    assert ap.launch_count == ap.scatter_launch_count == 0


def test_cuda_arg_checks_refuse_what_the_kernel_does_not_take():
    """The checks a CUDA launch makes first, run on CPU tensors."""
    mt, ops = tz.tj_chain(6)
    mt.enumerate_basis_full([ops["Sz"], ops["N"]], [0.0, 4.0])
    db = mt.sec_full[0].dbasis
    n = db.n
    tabs = pack_rows(mt.compiled_Ham, "cpu")
    labels, V, fodd = _rows(db)
    diag = torch.zeros(n, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.float64)
    ix = db.index.tables
    _check_cuda_args(tabs, ix, labels, V, fodd, diag, x, n, n)
    bad = {
        "V": (labels, V.long(), fodd, diag, x),
        "fodd": (labels, V, None, diag, x),
        "diag": (labels, V, fodd, diag.float(), x),
        "x": (labels, V, fodd, diag, x.float()),
        "labels": (labels[: n - 1], V, fodd, diag, x),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError):
            _check_cuda_args(tabs, ix, *args[:4], args[4], n, n)
    with pytest.raises(ValueError):   # a strided vector
        _check_cuda_args(tabs, ix, labels, V, fodd, diag,
                         torch.zeros(2 * n, dtype=torch.float64)[::2], n, n)
    ctabs = pack_rows(tz.dm_chain(6, 0.3)[0].compiled_Ham, "cpu")
    assert ctabs.is_complex
    with pytest.raises(ValueError, match="complex"):
        _check_cuda_args(ctabs, ix, labels, V, fodd, diag, x, n, n)


def _sz_q(L, q):
    """Sz(q) = sum_x exp(i q x) Sz_x / sqrt(L): complex diagonal columns."""
    out = tz.Mopr()
    for x in range(L):
        out += (np.exp(1j * q * x) / np.sqrt(L)) * tz.Opr(
            x, 0, False, tz.SP_HALF["Sz"])
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_kernels_match_plain_on_cuda(mode, monkeypatch):
    """apply_rows and scatter_rows on the card against their plain versions
    (1e-12 of max|y|), each kernel path in every index mode: slot values
    from label bit fields (chain-16, the DM chain L=12 with complex
    amplitudes, the three-site chain L=12 whose arity-3 columns take the
    generic path) and from staged V (t-J-10 with Jordan-Wigner strings,
    spin-1 L=10); tables in shared memory and, with the bound set to 0,
    through the read-only cache; in direct mode the position table with
    int32 rows; real and complex vectors, a range of rows past the sector's
    end; Sz(q) (every column diagonal, complex) in both
    directions; S^-_q into Sz=-1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"

    def close(got, want):
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        assert err <= 1e-12 * max(float(want.abs().max()), 1e-300), err

    def gather_and_scatter(tabs, db, diag):
        n = db.n
        ix = db.index.tables
        assert ix.t0.dtype == (torch.int32 if ix.mode == "direct"
                               else torch.int64)
        for vec in ("real", "complex"):
            if tabs.is_complex and vec == "real":
                continue
            re, im = _vec(n, vec, seed=7)
            x = vec_from_split(re, im, device=dev)
            before = ap.launch_count
            yk = apply_rows(tabs, ix, *_rows(db), diag, x, 0, n, n)
            assert ap.launch_count == before + 1
            close(yk, _apply_rows_plain(tabs, ix, *_rows(db), diag, x, 0,
                                        n, n))
            r0 = n // 3    # rows past the sector's end come out zero
            pad = None
            if diag is not None:
                pad = torch.zeros(n, dtype=torch.float64, device=dev)
                pad[: n - r0] = diag[r0:]
            close(apply_rows(tabs, ix, *_rows(db), pad, x, r0, n, n),
                  _apply_rows_plain(tabs, ix, *_rows(db), pad, x, r0, n,
                                    n))
            before = ap.scatter_launch_count
            zk = scatter_rows(tabs, ix, *_rows(db), diag, x, n)
            assert ap.scatter_launch_count == before + 1
            close(zk, _scatter_rows_plain(tabs, ix, *_rows(db), diag, x,
                                          n))

    cases = [(tz.heisenberg_chain(16, device=dev), ["Sz"], [0.0], True),
             (tz.tj_chain(10, device=dev), ["Sz", "N"], [0.0, 8.0], False),
             (tz.dm_chain(12, 0.3, device=dev), ["Sz"], [0.0], True),
             (tz.heisenberg_chain(10, spin="1", device=dev), ["Sz"], [0.0],
              False),
             (tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr, tz.Mopr,
                                       12, device=dev), ["Sz"], [0.0], True)]
    shared_max = ap.TABLES_SHARED_MAX
    for (m, ops), names, vals, bits in cases:
        m.enumerate_basis_full([ops[c] for c in names], vals)
        st = m.sec_full[0]
        db = _basis(m, st.labels, mode, device=dev, block_rows=None)
        tabs = pack_rows(m.compiled_Ham, dev)
        assert tabs.bits == bits
        diag = MatvecFull(m.compiled_Ham, db).diag_b.view(-1)[: db.n]
        for smax in (shared_max, 0):
            monkeypatch.setattr(ap, "TABLES_SHARED_MAX", smax)
            gather_and_scatter(tabs, db, diag)
    monkeypatch.setattr(ap, "TABLES_SHARED_MAX", shared_max)
    m, ops = tz.heisenberg_chain(16, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0], sec=0)
    m.enumerate_basis_full([ops["Sz"]], [-1.0], sec=1)
    src = _basis(m, m.sec_full[0].labels, mode, device=dev, block_rows=None)
    szq = pack_rows(m.compile_op(_sz_q(16, 2 * np.pi * 5 / 16)), dev)
    assert bool(szq.diagonal.all()) and szq.is_complex
    gather_and_scatter(szq, src, None)
    dst = _basis(m, m.sec_full[1].labels, mode, device=dev, block_rows=None)
    tabs = pack_rows(m.compile_op(_sminus_q(tz, 16, 2 * np.pi * 5 / 16)), dev)
    re, im = _vec(src.n, "complex", seed=2)
    x = vec_from_split(re, im, device=dev)
    ix = dst.index.tables
    close(scatter_rows(tabs, ix, *_rows(src), None, x, src.n),
          _scatter_rows_plain(tabs, ix, *_rows(src), None, x, src.n))
