"""Port full-sector apply (MatvecFull, mopr_x_vec) against the JAX package.

The same model and quantum-number sector go through both packages. H.x of
the port's ``MatvecFull`` on seeded random vectors (real and complex) must
agree with the JAX ``MatvecFull`` to 1e-12, for each of the three basis
index modes (``direct``, ``bsearch`` and a forced ``lin``). ``mopr_x_vec``
(the scatter direction: no conjugate, images that leave the destination
sector dropped) must agree to 1e-12 between two different sectors and for a
fermionic operator with a complex coefficient.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
from quantum_basis_tpu.ops.apply import mopr_x_vec as jax_mopr_x_vec
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.interop import vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops.apply import (
    DeviceBasis,
    MatvecFull,
    _choose_block,
    mopr_x_vec,
)


def _dm(z):
    if z is tz:
        return tz.dm_chain(10, 0.3)
    return tz.dm_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 10, 0.3)


def _tj8(z):
    if z is tz:
        return tz.tj_chain(8)
    import test_golden_chain as g

    m, sz, n = g.build_tj_chain(8)
    return m, {"Sz": sz, "N": n}


MODELS = {
    # name: (model function, conserved names, values, complex Hamiltonian)
    "chain12_Sz0": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], False),
    "tj_chain8_N6_Sz0": (_tj8, ["Sz", "N"], [0.0, 6.0], False),
    "kondo4_N4_Sz0": (lambda z: z.kondo_chain(4, 1.3), ["N", "Sz"],
                      [4.0, 0.0], False),
    "honeycomb_3x2_N4": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                         ["N"], [4.0], False),
    "dm_chain10_Sz0": (_dm, ["Sz"], [0.0], True),
}


def build_both(name):
    build, names, vals, cplx = MODELS[name]
    mj, oj = build(jz)
    mt, ot = build(tz)
    mj.enumerate_basis_full([oj[c] for c in names], vals)
    mt.enumerate_basis_full([ot[c] for c in names], vals)
    return mj, mt, cplx


def _jax_apply(mv, re, im):
    yr, yi = mv((np.asarray(re), None if im is None else np.asarray(im)))
    return np.asarray(yr), None if yi is None else np.asarray(yi)


def _assert_close(y: torch.Tensor, yr, yi):
    tr, ti = vec_to_split(y)
    np.testing.assert_allclose(tr, yr, rtol=0, atol=1e-12)
    if yi is None:
        assert ti is None or np.max(np.abs(ti)) == 0.0
    else:
        np.testing.assert_allclose(ti, yi, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["direct", "bsearch", "lin"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_matvec_full_matches_jax(name, mode):
    mj, mt, cplx = build_both(name)
    sj, st = mj.sec_full[0], mt.sec_full[0]
    assert st.dim == sj.dim > 0
    np.testing.assert_array_equal(st.labels, sj.labels)
    index = BasisIndex(st.labels, mt.space.label_space, mode=mode,
                       lin_split=digit_split(mt.space), device="cpu")
    assert index.mode == mode  # a quantum-number sector is Lin-consistent
    # small blocks: several row blocks and a padded last one
    db = DeviceBasis(mt.space, st.labels, index, block_rows=100,
                     device="cpu")
    assert db.n_blocks > 1 and db.pad > 0
    mv = MatvecFull(mt.compiled_Ham, db)
    assert mv.is_complex == cplx == sj.matvec.is_complex
    rng = np.random.default_rng(11)
    re, im = rng.standard_normal(st.dim), rng.standard_normal(st.dim)
    _assert_close(mv(vec_from_split(re, im, device="cpu")),
                  *_jax_apply(sj.matvec, re, im))
    if cplx:
        with pytest.raises(ValueError):
            mv(vec_from_split(re, device="cpu"))
    else:
        y = mv(vec_from_split(re, device="cpu"))
        assert not y.is_complex()
        _assert_close(y, *_jax_apply(sj.matvec, re, None))
    # the sector's own matvec (default index and block size) agrees too
    _assert_close(st.matvec(vec_from_split(re, im, device="cpu")),
                  *_jax_apply(sj.matvec, re, im))


def test_device_basis_storage_and_block_choice():
    """int8 slot values and fermion counts; the block size follows the
    budget rule of the JAX package (the "cpu" table's budget)."""
    from quantum_basis_tpu.ops.apply import _choose_block as jax_choose

    mt, ot = tz.kondo_chain(4, 1.3)
    mt.enumerate_basis_full([ot["N"], ot["Sz"]], [4.0, 0.0])
    db = mt.sec_full[0].dbasis
    assert db.V_b.dtype == torch.int8 and db.F_b.dtype == torch.int8
    V = mt.space.decode(db.labels_np)
    np.testing.assert_array_equal(
        db.V_b.reshape(-1, mt.space.n_slots)[: db.n].numpy(), V)
    F = np.take_along_axis(mt.space.fermion_count_table,
                           V.astype(np.int64).T, axis=1).T
    np.testing.assert_array_equal(
        db.F_b.reshape(-1, mt.space.n_slots)[: db.n].numpy(), F)
    for n, w in ((2704156, 24 * 24), (65536, 16 * 32), (500, 7)):
        assert _choose_block(n, w, "cpu") == jax_choose(n, w)


def _sminus_q(z, L, q):
    """S^-_q = sum_x exp(i q x) S^-_x / sqrt(L): complex coefficients."""
    mod = tz if z is tz else qj
    out = mod.Mopr()
    for x in range(L):
        out += (np.exp(1j * q * x) / np.sqrt(L)) * mod.Opr(
            x, 0, False, tz.SP_HALF["Sm"])
    return out


def test_mopr_x_vec_between_sectors():
    """S^-_q maps the Sz=0 sector into Sz=-1; images elsewhere are dropped."""
    L, q = 10, 2 * np.pi * 3 / 10
    mj, oj = jz.heisenberg_chain(L)
    mt, ot = tz.heisenberg_chain(L)
    for m, o in ((mj, oj), (mt, ot)):
        m.enumerate_basis_full([o["Sz"]], [0.0], sec=0)
        m.enumerate_basis_full([o["Sz"]], [-1.0], sec=1)
    rng = np.random.default_rng(5)
    n = mt.sec_full[0].dim
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    for xr, xi in ((re, None), (re, im)):
        yr, yi = jax_mopr_x_vec(
            mj.compile_op(_sminus_q(jz, L, q)), mj.sec_full[0].dbasis,
            mj.sec_full[1].dbasis,
            (np.asarray(xr), None if xi is None else np.asarray(xi)))
        y = mopr_x_vec(mt.compile_op(_sminus_q(tz, L, q)),
                       mt.sec_full[0].dbasis, mt.sec_full[1].dbasis,
                       vec_from_split(xr, xi, device="cpu"))
        assert y.shape == (mt.sec_full[1].dim,) and y.is_complex()
        _assert_close(y, np.asarray(yr), np.asarray(yi))
    # S^- applied within Sz=0 leaves the sector entirely: all dropped
    y = mopr_x_vec(mt.compile_op(_sminus_q(tz, L, q)), mt.sec_full[0].dbasis,
                   mt.sec_full[0].dbasis, vec_from_split(re, device="cpu"))
    assert float(y.abs().max()) == 0.0


def test_mopr_x_vec_fermionic_complex_no_conjugate():
    """A non-Hermitian fermionic hop with a complex coefficient in a t-J
    sector: the scatter direction carries the Jordan-Wigner sign and the
    amplitude unconjugated (MatvecFull conjugates)."""
    import test_golden_chain as g

    mj, szj, nj = g.build_tj_chain(6)
    mt, ot = tz.tj_chain(6)
    mj.enumerate_basis_full([szj, nj], [0.0, 4.0])
    mt.enumerate_basis_full([ot["Sz"], ot["N"]], [0.0, 4.0])

    def hop(mod, c_up):
        # (0.3 + 0.8i) c^dag_{0,up} c_{4,up}: a string across sites 1..3
        return (0.3 + 0.8j) * (mod.Opr(0, 0, True, c_up).dagger()
                               * mod.Opr(4, 0, True, c_up))

    rng = np.random.default_rng(9)
    n = mt.sec_full[0].dim
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    yr, yi = jax_mopr_x_vec(mj.compile_op(hop(qj, jz.TJ_C_UP)),
                            mj.sec_full[0].dbasis, mj.sec_full[0].dbasis,
                            (np.asarray(re), np.asarray(im)))
    op_t = mt.compile_op(hop(tz, tz.TJ_C_UP))
    y = mopr_x_vec(op_t, mt.sec_full[0].dbasis, mt.sec_full[0].dbasis,
                   vec_from_split(re, im, device="cpu"))
    _assert_close(y, np.asarray(yr), np.asarray(yi))
    # and against the dense matrix <j|O|i> of the port's own host oracle
    from quantum_basis_tpu_torch.ops.dense import dense_matrix

    O = dense_matrix(op_t, mt.sec_full[0].labels)
    np.testing.assert_allclose(y.numpy(), O @ (re + 1j * im), rtol=0,
                               atol=1e-12)
    assert np.abs(O - O.conj().T).max() > 0.1  # really not Hermitian
