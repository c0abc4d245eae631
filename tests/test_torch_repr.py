"""Port momentum-sector apply (MatvecRepr) against the JAX package.

The same model and sector go through both packages; the port's basis of
representatives and norms must match, and H.x on one random complex vector
(numpy seed) must agree to 1e-12.
"""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu_torch.interop import vec_from_split, vec_to_split

SECTORS = {
    # name: (builder, conserved names, values, momentum)
    "chain12_k1": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], [1]),
    "kagome_tj_1x2_k01": (lambda z: z.kagome_tj(1, 2), ["N", "Sz"],
                          [4.0, 0.0], [0, 1]),
    "honeycomb_3x2_k10": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                          ["N"], [4.0], [1, 0]),
}


def build_both(name):
    """(JAX model, port model) with sector 0 enumerated in both."""
    build, names, vals, k = SECTORS[name]
    mj, oj = build(jz)
    mt, ot = build(tz)
    mj.enumerate_basis_repr(k, [oj[c] for c in names], vals)
    mt.enumerate_basis_repr(k, [ot[c] for c in names], vals)
    return mj, mt


@pytest.mark.parametrize("name", sorted(SECTORS))
def test_matvec_repr_matches_jax(name):
    mj, mt = build_both(name)
    sj, st = mj.sec_repr[0], mt.sec_repr[0]
    assert st.dim == sj.dim > 0
    np.testing.assert_array_equal(st.labels, sj.labels)
    np.testing.assert_allclose(st.dbasis.nus, sj.dbasis.nus, rtol=0,
                               atol=1e-14)
    rng = np.random.default_rng(11)
    re, im = rng.standard_normal(st.dim), rng.standard_normal(st.dim)
    yr, yi = sj.matvec((np.asarray(re), np.asarray(im)))
    y = st.matvec(vec_from_split(re, im, device="cpu"))
    tr, ti = vec_to_split(y)
    np.testing.assert_allclose(tr, np.asarray(yr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ti, np.asarray(yi), rtol=0, atol=1e-12)


def test_matvec_repr_small_blocks():
    """Several row blocks with a padded last block give the same H.x."""
    from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr, ReprBasis

    mt, ot = tz.heisenberg_chain(16)
    mt.enumerate_basis_repr([1], [ot["Sz"]], [0.0])
    st = mt.sec_repr[0]
    rb = st.dbasis
    assert rb.n_blocks == 1
    small = ReprBasis(mt.space, rb.tset, None, rb.momentum,
                      reps_all=mt._repr_cache[2], work_per_row=1 << 14)
    assert small.n_blocks > 1 and small.pad > 0
    rng = np.random.default_rng(2)
    x = vec_from_split(rng.standard_normal(st.dim),
                       rng.standard_normal(st.dim), device="cpu")
    y = MatvecRepr(mt.compiled_Ham, small)(x)
    np.testing.assert_allclose(y.numpy(), st.matvec(x).numpy(), rtol=0,
                               atol=1e-12)
