"""Port explicit full-sector ELL (build_sparse_full) against the JAX package.

The ELL extracted from the port's ``MatvecFull`` must equal the JAX
package's entry for entry after row compaction: ``cols`` exactly, ``vals``
and ``diag`` to 1e-14 (both sum the same few table amplitudes per entry),
over one or several row blocks and in every index mode. Both Hermiticity
checks pass on H and raise on a deliberately non-Hermitian ELL;
``Model.generate_Ham_sparse_full`` / ``generate_Ham_sparse_repr`` switch the
sector's matvec to the ELL and keep the matrix-free apply. The
``cuda``-marked tests hold the ``ell_rows`` kernel against its plain
version on the card, on every row stage (in registers two rows a warp at
E <= 16, a row a warp at 17-32 and 33-64 image columns, the shared stage
past 64) and with the rows' lengths it writes; the JAX package is imported
inside the CPU tests only, so this file runs on a machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.interop import ell_from_numpy
from quantum_basis_tpu_torch.ops import ell_build, sparse
from quantum_basis_tpu_torch.ops.apply import DeviceBasis, MatvecFull
from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr
from quantum_basis_tpu_torch.ops.sparse import (
    EllMatrix,
    build_sparse_full,
    hermiticity_exact,
    hermiticity_probe,
    row_lengths,
)

# tests/test_torch_apply.py's MODELS
MODELS = ("chain12_Sz0", "dm_chain10_Sz0", "honeycomb_3x2_N4",
          "kondo4_N4_Sz0", "tj_chain8_N6_Sz0")


def build_both(name):
    from test_torch_apply import build_both as both

    return both(name)


def _jax_ell(mj):
    from quantum_basis_tpu.ops.sparse import build_sparse_full

    return build_sparse_full(mj.sec_full[0].matvec)


@pytest.mark.parametrize("name", MODELS)
def test_build_sparse_full_matches_jax(name):
    mj, mt, cplx = build_both(name)
    ej = _jax_ell(mj)
    st = mt.sec_full[0]
    # several row blocks, a padded last one: per-block compaction + padding
    db = DeviceBasis(mt.space, st.labels, st.dbasis.index, block_rows=100,
                     device="cpu")
    for mv in (st.matvec, MatvecFull(mt.compiled_Ham, db)):
        et = build_sparse_full(mv)
        assert (et.n, et.width, et.is_complex) == (ej.n, ej.width, cplx)
        assert et.vals.dtype == (torch.complex128 if cplx
                                 else torch.float64)
        np.testing.assert_array_equal(et.cols.numpy(), np.asarray(ej.cols))
        np.testing.assert_allclose(et.vals.real.numpy(), np.asarray(ej.vre),
                                   rtol=0, atol=1e-14)
        if cplx:
            np.testing.assert_allclose(et.vals.imag.numpy(),
                                       np.asarray(ej.vim), rtol=0,
                                       atol=1e-14)
        else:
            assert ej.vim is None
        np.testing.assert_allclose(et.diag.numpy(), np.asarray(ej.diag),
                                   rtol=0, atol=1e-14)
    # the JAX ELL carried across applies like the port's own
    carried = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(et.n))
    np.testing.assert_allclose(carried(x).numpy(), et(x).numpy(), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(et(x).numpy(), st.matvec(
        x.to(torch.complex128) if cplx else x).numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_build_rowlen_is_row_lengths(name, monkeypatch):
    """The rows' lengths the plain ``ell_rows`` returns (each row's count
    of entries) equal ``row_lengths`` of its values, over one block and
    over row blocks of 100; ``build_sparse_full``'s matrix carries them, so
    no ``row_lengths`` pass runs on it."""
    _, mt, _ = build_both(name)
    st = mt.sec_full[0]
    db = DeviceBasis(mt.space, st.labels, st.dbasis.index, block_rows=100,
                     device="cpu")
    for mv in (st.matvec, MatvecFull(mt.compiled_Ham, db)):
        b = mv.basis
        args = (mv.tables, b.index.tables, b.labels_b.view(-1),
                b.V_b.view(-1, b.space.n_slots), b.fodd, b.n)
        cols, vals, rowlen = ell_build.ell_rows(*args, b.block_rows)
        assert rowlen.dtype == torch.int32 and rowlen.shape == (b.n,)
        np.testing.assert_array_equal(rowlen.numpy(),
                                      row_lengths(vals).numpy())
        assert int(rowlen.max()) == vals.shape[1]
        with monkeypatch.context() as mp:
            mp.setattr(sparse, "row_lengths", None)     # not called
            ell = build_sparse_full(mv)
            assert torch.equal(ell.rowlen, rowlen)


@pytest.mark.parametrize("name", ["chain12_Sz0", "dm_chain10_Sz0"])
def test_hermiticity_checks(name):
    _, mt, cplx = build_both(name)
    ell = build_sparse_full(mt.sec_full[0].matvec)
    hermiticity_exact(ell)
    hermiticity_probe(ell, ell.n, cplx)
    hermiticity_probe(mt.sec_full[0].matvec, ell.n, True)

    # one entry changed: H[i, j] != conj(H[j, i])
    vals = ell.vals.clone()
    i = int(torch.nonzero(vals[:, 0] != 0)[0])
    vals[i, 0] = vals[i, 0] * 1.5
    bad = EllMatrix(ell.cols, vals, ell.diag)
    with pytest.raises(AssertionError, match="not Hermitian"):
        hermiticity_exact(bad)
    with pytest.raises(AssertionError, match="Hermiticity probe"):
        hermiticity_probe(bad, bad.n, cplx)

    # one entry with no transpose partner at all
    vals = ell.vals.clone()
    vals[i, 0] = 0.0
    with pytest.raises(AssertionError, match="unpaired"):
        hermiticity_exact(EllMatrix(ell.cols, vals, ell.diag))

    if cplx:
        # an anti-Hermitian imaginary part only the exact check must see
        vals = ell.vals.clone()
        vals[i, 0] = vals[i, 0].conj() if vals[i, 0].imag != 0 \
            else vals[i, 0] + 0.25j
        with pytest.raises(AssertionError):
            hermiticity_exact(EllMatrix(ell.cols, vals, ell.diag))


def test_generate_ham_sparse_full_switches_matvec():
    mt, ot = tz.heisenberg_chain(12)
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    s = mt.sec_full[0]
    free = s.matvec
    for check in (True, "probe", "exact", False):
        ell = mt.generate_Ham_sparse_full(check=check)
        assert isinstance(ell, EllMatrix) and s.matvec is ell
        assert s.matvec_free is free


def test_generate_ham_sparse_repr_matches_jax():
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import EllMatrix as JaxEll

    mj, oj = jz.heisenberg_chain(12)
    mt, ot = tz.heisenberg_chain(12)
    mj.enumerate_basis_repr([1], [oj["Sz"]], [0.0])
    mt.enumerate_basis_repr([1], [ot["Sz"]], [0.0])
    ej = mj.generate_Ham_sparse_repr(check="exact")
    et = mt.generate_Ham_sparse_repr(check="exact")
    s = mt.sec_repr[0]
    assert isinstance(ej, JaxEll) and s.matvec is et and s.ell is et
    assert isinstance(s.matvec_free, MatvecRepr)
    np.testing.assert_array_equal(et.cols.numpy(), np.asarray(ej.cols))
    np.testing.assert_allclose(et.vals.real.numpy(), np.asarray(ej.vre),
                               rtol=0, atol=1e-13)
    np.testing.assert_allclose(et.vals.imag.numpy(), np.asarray(ej.vim),
                               rtol=0, atol=1e-13)
    # the solve and a second extraction still work after the switch
    mt.locate_E0_lanczos(which="repr")
    mj.locate_E0_lanczos(which="repr")
    assert abs(mt.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10
    assert mt.generate_Ham_sparse_repr(check=False) is et


def _indexed(mt, mode, device="cpu", block_rows=None):
    """A MatvecFull of mt's sector 0 over a basis indexed in ``mode``."""
    st = mt.sec_full[0]
    ix = BasisIndex(st.labels, mt.space.label_space, mode=mode,
                    lin_split=digit_split(mt.space), device=device)
    return MatvecFull(mt.compiled_Ham, DeviceBasis(
        mt.space, st.labels, ix, block_rows=block_rows, device=device))


@pytest.mark.parametrize("mode", ["lin", "bsearch"])
@pytest.mark.parametrize("name", ["chain12_Sz0", "honeycomb_3x2_N4"])
def test_build_sparse_full_index_modes_match_jax(name, mode):
    """The ELL over a lin or binary-search index, in row blocks of 37 (the
    last one past the sector's end), equals the JAX package's: columns and
    W exactly, values to 1e-14, H.x to 1e-12."""
    mj, mt, _ = build_both(name)
    ej = _jax_ell(mj)
    mv = _indexed(mt, mode, block_rows=37)
    assert mv.basis.index.mode == mode
    assert mv.n % 37 and mv.basis.n_blocks > 2
    et = build_sparse_full(mv)
    assert et.width == ej.width
    np.testing.assert_array_equal(et.cols.numpy(), np.asarray(ej.cols))
    np.testing.assert_allclose(et.vals.numpy(), np.asarray(ej.vre), rtol=0,
                               atol=1e-14)
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(et.n))
    y = np.asarray(ej((x.numpy(), None))[0])
    np.testing.assert_allclose(et(x).numpy(), y, rtol=0, atol=1e-12)


def test_build_sparse_full_without_off_diagonal_columns():
    """An operator with no image column (Sz Sz alone) builds a zero-width
    ELL whose apply is the diagonal."""
    m, ops = tz.heisenberg_chain(8)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    zz = m.compile_op(tz.sz_pair(0, 1))
    mv = MatvecFull(zz, m.sec_full[0].dbasis)
    assert mv.tables.n_cols == 0
    ell = build_sparse_full(mv)
    assert ell.width == 0 and ell.cols.shape == (mv.n, 0)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(mv.n))
    torch.testing.assert_close(ell(x), mv(x), rtol=0, atol=1e-14)


@pytest.mark.cuda
def test_ell_rows_kernel_matches_plain_on_cuda(monkeypatch):
    """The ``ell_rows`` kernel on the card against its plain version on the
    same CUDA tensors: columns and W exactly, values to 1e-14 of max|v|,
    the rows' lengths it writes equal to ``row_lengths`` of its values and
    to the plain version's, with a direct, a lin and a binary-search
    index, on every register stage: two rows a warp (E <= 16: a spin-1/2
    chain's bit fields, the spin-1 chain's slot values from V, t-J and
    Kondo's Jordan-Wigner signs, the DM chain's complex amplitudes), a row
    a warp (17-32: the honeycomb fermions, the three-site chain's arity 3,
    the DM chain of 20 sites, complex), two images a lane (33-64: kagome
    2x3); the path each build takes (``ell_build.trace``); two launches a
    build; and the built ELL's H x against MatvecFull's (1e-12 of max|y|).
    The shared stage past 64 columns: ``test_ell_rows_wide_rows_on_cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    cases = [(tz.heisenberg_chain(12, device=dev), ["Sz"], [0.0]),
             (tz.heisenberg_chain(8, spin="1", device=dev), ["Sz"], [0.0]),
             (tz.tj_chain(8, device=dev), ["Sz", "N"], [0.0, 6.0]),
             (tz.kondo_chain(4, 1.3, device=dev), ["N", "Sz"], [4.0, 0.0]),
             (tz.spinless_fermion_honeycomb(3, 2, device=dev), ["N"], [4.0]),
             (tz.dm_chain(10, device=dev), ["Sz"], [0.0]),
             (tz.dm_chain(20, device=dev), ["Sz"], [0.0]),
             (tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr, tz.Mopr,
                                       12, device=dev), ["Sz"], [0.0]),
             (tz.kagome_heisenberg(2, 3, device=dev), ["Sz"], [0.0])]
    paths = set()
    for (m, ops), names, vals in cases:
        m.enumerate_basis_full([ops[c] for c in names], vals)
        for mode in ("direct", "lin", "bsearch"):
            mv = _indexed(m, mode, dev)
            db, tabs = mv.basis, mv.tables
            args = (tabs, db.index.tables, db.labels_b.view(-1),
                    db.V_b.view(-1, db.space.n_slots), db.fodd, db.n)
            before = ell_build.launch_count
            monkeypatch.setattr(ell_build, "trace", [])
            c, v, rl = ell_build.ell_rows(*args, db.block_rows)
            c2, v2, rl2 = ell_build._ell_rows_plain(*args, db.block_rows)
            torch.cuda.synchronize()
            assert ell_build.launch_count == before + 2
            (rec,) = ell_build.trace
            E = tabs.n_cols
            assert rec["path"] == ell_build.PATHS[
                1 if E <= 16 else 2 if E <= 32 else 3]
            paths.add(rec["path"])
            assert c.shape == c2.shape and torch.equal(c, c2)
            assert v.dtype == v2.dtype
            scale = max(float(v2.abs().max()), 1e-300)
            assert float((v - v2).abs().max()) <= 1e-14 * scale
            assert torch.equal(rl, row_lengths(v)) and torch.equal(rl, rl2)
            x = torch.randn(db.n, dtype=torch.float64, device=dev)
            if mv.is_complex:
                x = x.to(torch.complex128)
            y = mv(x)
            got = EllMatrix(c, v, mv.diag_b.reshape(-1)[:db.n], rl)(x)
            torch.cuda.synchronize()
            assert float((got - y).abs().max()) <= 1e-12 * float(
                y.abs().max())
    assert paths == set(ell_build.PATHS[1:4])


@pytest.mark.cuda
def test_ell_rows_wide_rows_on_cuda(monkeypatch):
    """``ell_rows`` on rows of 640 to 2240 image columns (bosons with a
    dense three-site term on every triple, real and complex): at 1280
    complex and 2240 columns fewer than 8 warps' scratch fits a block's
    shared memory, so a block runs fewer warps. Then every row's scratch
    in the device buffer (ROW_SHARED_MAX = 0), of one block
    (ROW_SCRATCH_MAX = 1) or of many. Each build against the plain version
    (columns and W exactly, values to 1e-14 of max|v|, the rows' lengths
    against ``row_lengths``) and its H x against MatvecFull's (1e-12 of
    max|y|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    cases = [(5, False, None, None), (6, True, None, None),
             (7, False, None, None), (7, True, None, None),
             (5, False, 0, None), (6, True, 0, 1), (7, True, 0, None)]
    for L, cplx, shared, scratch in cases:
        m, _ = tz.boson_triples(L, cplx, device=dev)
        m.enumerate_basis_full([], [])
        mv = m.sec_full[0].matvec
        assert mv.tables.n_cols == 64 * L * (L - 1) * (L - 2) // 6
        with monkeypatch.context() as mp:
            if shared is not None:
                mp.setattr(ell_build, "ROW_SHARED_MAX", shared)
            if scratch is not None:
                mp.setattr(ell_build, "ROW_SCRATCH_MAX", scratch)
            db, tabs = mv.basis, mv.tables
            args = (tabs, db.index.tables, db.labels_b.view(-1),
                    db.V_b.view(-1, db.space.n_slots), db.fodd, db.n)
            mp.setattr(ell_build, "trace", [])
            c, v, rl = ell_build.ell_rows(*args, db.block_rows)
            (rec,) = ell_build.trace
        c2, v2, _ = ell_build._ell_rows_plain(*args, db.block_rows)
        torch.cuda.synchronize()
        assert rec["path"] == ("device" if shared == 0 else "shared")
        assert c.shape == c2.shape and torch.equal(c, c2)
        assert torch.equal(rl, row_lengths(v))
        assert v.dtype == v2.dtype == (torch.complex128 if cplx
                                       else torch.float64)
        scale = float(v2.abs().max())
        assert float((v - v2).abs().max()) <= 1e-14 * scale
        x = torch.randn(db.n, dtype=torch.float64, device=dev)
        if mv.is_complex:
            x = x.to(torch.complex128)
        y = mv(x)
        got = EllMatrix(c, v, mv.diag_b.reshape(-1)[:db.n])(x)
        torch.cuda.synchronize()
        assert float((got - y).abs().max()) <= 1e-12 * float(y.abs().max())
