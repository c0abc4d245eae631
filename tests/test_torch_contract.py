"""The port's window-contraction engine against the JAX package.

The contraction plan (rotations, windows with their terms, leftover roll
terms) must equal the JAX plan, and every window matrix ``window_G`` and pair
tensor ``_pair_G`` must agree to 1e-15. ``ContractOp`` ``H x`` on seeded
sector vectors must agree with the JAX ``ContractOp`` over the whole label
space and with the port's matrix-free ``MatvecFull`` on the sector: 1e-12 x
max|y| in float64; a float32 engine within 5e-6 x max|y| of the float64
truth. Cases: chain-12 (no roll terms left), spin-1 chain-8 (mixed radix),
honeycomb fermions (JW), kagome 2x2, bosons, a t-J chain (d = 3, sign
prefactors), a complex (DM) chain, the two forced pair-window cases, and a
three-site term that ends on the roll fallback. An engine rebuilt from the
JAX engine's arrays through ``interop.contract_from_numpy`` gives the same
``H x``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
from quantum_basis_tpu.ops import apply_contract as jc
from quantum_basis_tpu_torch.interop import contract_from_numpy
from quantum_basis_tpu_torch.ops import apply_contract as tc
from test_torch_fullspace import jax_apply, sector_vector


def _dm(z):
    if z is tz:
        return tz.dm_chain(10, 0.3)
    return tz.dm_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 10, 0.3)


def _tj(z):
    if z is tz:
        return tz.tj_chain(10)
    import test_golden_chain as g

    m, sz, n = g.build_tj_chain(10)
    return m, {"Sz": sz, "N": n}


def _three_spin(z):
    if z is tz:
        return tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr,
                                        tz.Mopr, 10, device="cpu")
    return tz.three_spin_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 10)


def _spin_one(z):
    return (z.heisenberg_chain(8, "1") if z is jz
            else z.heisenberg_chain(8, spin="1"))


CASES = {
    # name: (model function, conserved names, values, max_window)
    "chain12": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], 1024),
    "spin1_chain8": (_spin_one, ["Sz"], [0.0], 1024),
    "honeycomb_3x2_N4": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                         ["N"], [4.0], 1024),
    "kagome_2x2": (lambda z: z.kagome_heisenberg(2, 2), ["Sz"], [0.0], 1024),
    "bose_2x2_N4": (lambda z: z.bose_hubbard_square(2, 2, 2), ["N"], [4.0],
                    1024),
    "tj_chain10_N6": (_tj, ["Sz", "N"], [0.0, 6.0], 1024),
    "dm_chain10": (_dm, ["Sz"], [0.0], 1024),
    "pairs_chain10": (lambda z: z.heisenberg_chain(10), ["Sz"], [0.0], 2),
    "pairs_honeycomb_3x2_N3": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                               ["N"], [3.0], 2),
    "rolls_three_spin10": (_three_spin, ["Sz"], [0.0], 2),
}
_BUILT = {}


def build_both(name):
    """(JAX model, port model, max_window), sector enumerated; cached."""
    if name not in _BUILT:
        build, names, vals, mw = CASES[name]
        mj, oj = build(jz)
        mt, ot = build(tz)
        mj.enumerate_basis_full([oj[c] for c in names], vals)
        mt.enumerate_basis_full([ot[c] for c in names], vals)
        _BUILT[name] = (mj, mt, mw)
    return _BUILT[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_plan_and_window_matrices_equal_jax(name):
    mj, mt, mw = build_both(name)
    pj = jc.ContractPlan(mj.compiled_Ham, max_window=mw)
    pt = tc.ContractPlan(mt.compiled_Ham, max_window=mw)
    assert pt.rotations == pj.rotations and pt.frames == pj.frames
    assert pt.roll_terms == pj.roll_terms
    assert ([(w.frame, w.a, w.b, w.D, w.terms) for w in pt.windows]
            == [(w.frame, w.a, w.b, w.D, w.terms) for w in pj.windows])
    assert pt.describe() == pj.describe()
    for wt, wj in zip(pt.windows, pj.windows):
        Gt, Gj = pt.window_G(wt, wt.terms), pj.window_G(wj, wj.terms)
        assert np.abs(Gt - Gj).max() <= 1e-15
        for ti in wt.terms:
            np.testing.assert_array_equal(pt.w_out(wt, ti), pj.w_out(wj, ti))
    assert (tc.supports_contract(mt.compiled_Ham, max_window=mw)
            == jc.supports_contract(mj.compiled_Ham, max_window=mw))
    for ti in pt.roll_terms:
        slots, dims, jstr, M, w = mt.compiled_Ham.term_matrices[ti]
        sup = sorted(set(int(s) for s in slots))
        if len(sup) != 2:
            continue
        args_j = mj.compiled_Ham.term_matrices[ti]
        w_in = np.where(np.isin(np.arange(w.size), sup), w, 0)
        Gt = tc._pair_G(mt.space, slots, dims, jstr, M, w_in, *sup)
        Gj = jc._pair_G(mj.space, *args_j[:4], w_in, *sup)
        assert np.abs(Gt - Gj).max() <= 1e-15


@pytest.mark.parametrize("name", sorted(CASES))
def test_contract_apply_matches_jax_and_matvec_full(name):
    mj, mt, mw = build_both(name)
    st = mt.sec_full[0]
    labels = st.labels
    cj = jc.ContractOp(mj.compiled_Ham, labels, dtype=jnp.float64,
                       max_window=mw)
    c64 = tc.ContractOp(mt.compiled_Ham, labels, dtype=torch.float64,
                        max_window=mw, device="cpu")
    c32 = tc.ContractOp(mt.compiled_Ham, labels, max_window=mw, device="cpu")
    assert c64.dtype == torch.float64 and c32.dtype == torch.float32
    assert c64.is_complex == cj.is_complex == st.matvec.is_complex
    assert (len(c64._wins), len(c64._pairs), len(c64._rolls)) == (
        len(cj._wins), len(cj._pairs), len(cj._passes))
    assert len(c64._signs) == len(cj._signs)
    assert c64.nnz_estimate == cj.nnz_estimate
    if name.startswith("pairs"):
        assert c64._pairs and not c64._wins
    if name.startswith("rolls"):
        assert len(c64._rolls) > 0
    if name == "chain12":
        assert not c64.plan.roll_terms  # the PBC bond sits in a rotated frame
        assert len({w[0] for w in c64._wins}) == 2
    if name == "tj_chain10_N6":
        assert c64._signs  # the wrap hops carry a sign prefactor
    for cplx in ([True] if c64.is_complex else [False, True]):
        x = sector_vector(c64.N, labels, 3, cplx)
        want = jax_apply(cj, x)
        scale = np.abs(want).max()
        y64 = c64(torch.as_tensor(x))
        assert y64.dtype == (torch.complex128 if cplx else torch.float64)
        assert np.abs(y64.numpy() - want).max() <= 1e-12 * scale
        y_sec = st.matvec(torch.as_tensor(x[labels]))
        assert (c64.to_sector(y64) - y_sec).abs().max() <= 1e-12 * scale
        assert (y64 * (1.0 - c64.mask)).abs().max() <= 1e-13 * scale
        y32 = c32(torch.as_tensor(x))
        assert y32.dtype == (torch.complex64 if cplx else torch.float32)
        assert np.abs(y32.numpy() - want).max() <= 5e-6 * scale


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("name", ["chain12", "tj_chain10_N6", "dm_chain10",
                                  "pairs_honeycomb_3x2_N3",
                                  "rolls_three_spin10"])
def test_engine_from_jax_arrays(name, dt):
    """The JAX engine's params, as numpy arrays, carried into the port."""
    mj, mt, mw = build_both(name)
    labels = mt.sec_full[0].labels
    cj = jc.ContractOp(mj.compiled_Ham, labels, dtype=jnp.dtype(dt),
                       max_window=mw)
    diag, win_G, signs, pair_G = cj.params

    def split(gs):
        return [(np.asarray(re), None if im is None else np.asarray(im))
                for re, im in gs]

    ct = contract_from_numpy(
        cj.N, [(f, hi, D, lo, sidx) for f, hi, D, lo, _, _, sidx in cj._wins],
        cj._frame_shape,
        [(A, dh, Mm, dl, L, sidx)
         for A, dh, Mm, dl, L, _, _, sidx in cj._pairs],
        np.asarray(diag), split(win_G), [np.asarray(s) for s in signs],
        split(pair_G), mask=np.asarray(cj.mask), passes=cj._passes,
        strides=mt.space.strides, dtype=getattr(torch, dt), device="cpu")
    assert ct.dtype == getattr(torch, dt) and ct.is_complex == cj.is_complex
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    x = sector_vector(ct.N, labels, 9, True)
    want = jax_apply(cj, x, dtype=np.dtype(dt))
    tol = 1e-12 if dt == "float64" else 5e-6
    assert (np.abs(ct(torch.as_tensor(x)).numpy() - want).max()
            <= tol * np.abs(want).max())


def test_device_is_the_callers_choice():
    import inspect

    from quantum_basis_tpu_torch import interop
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp

    for cls in (tc.ContractOp, FullSpaceOp):
        assert inspect.signature(cls).parameters["device"].default == "cuda"
    for fn in (interop.contract_from_numpy, interop.kron_from_numpy,
               interop.vec_from_split, interop.ell_from_numpy,
               interop.bsr_from_numpy):
        dev = inspect.signature(fn).parameters["device"]
        assert dev.kind is inspect.Parameter.KEYWORD_ONLY
        assert dev.default is inspect.Parameter.empty
