"""Port explicit sparse build (ELL) against the JAX package.

``build_sparse_repr`` must give the same matrix (dense-equal to 1e-12), the
ELL apply the same H.x (1e-12), and the device row compaction the same
layout and values as the JAX package's numpy ``_compact_rows_np``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from quantum_basis_tpu.ops.sparse import _compact_rows_np, build_sparse_repr as jax_build
from quantum_basis_tpu_torch.interop import ell_from_numpy, vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr, compact_rows
from test_torch_repr import SECTORS, build_both


def dense(n, cols, vals, diag):
    H = np.zeros((n, n), dtype=np.complex128)
    np.add.at(H, (np.repeat(np.arange(n), cols.shape[1]), cols.reshape(-1)),
              vals.reshape(-1))
    H[np.arange(n), np.arange(n)] += diag
    return H


@pytest.mark.parametrize("name", sorted(SECTORS))
def test_build_sparse_repr_matches_jax(name):
    mj, mt = build_both(name)
    ej = jax_build(mj.sec_repr[0].matvec)
    et = build_sparse_repr(mt.sec_repr[0].matvec)
    n = et.n
    vj = np.asarray(ej.vre) + 1j * np.asarray(ej.vim)
    Hj = dense(n, np.asarray(ej.cols), vj, np.asarray(ej.diag))
    Ht = dense(n, et.cols.numpy(), et.vals.numpy(), et.diag.numpy())
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-12)
    assert et.width == ej.width
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    yr, yi = ej((np.asarray(re), np.asarray(im)))
    tr, ti = vec_to_split(et(vec_from_split(re, im, device="cpu")))
    np.testing.assert_allclose(tr, np.asarray(yr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ti, np.asarray(yi), rtol=0, atol=1e-12)
    # the same JAX arrays carried over through interop apply identically
    ec = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
    cr, ci = vec_to_split(ec(vec_from_split(re, im, device="cpu")))
    np.testing.assert_allclose(cr, np.asarray(yr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ci, np.asarray(yi), rtol=0, atol=1e-12)


@pytest.mark.parametrize("complex_vals", [False, True])
def test_compact_rows_matches_numpy(complex_vals):
    rng = np.random.default_rng(9)
    n, W = 64, 24
    cols = rng.integers(-1, 12, size=(n, W)).astype(np.int64)
    vre = rng.standard_normal((n, W))
    vre[rng.random((n, W)) < 0.2] = 0.0
    vim = rng.standard_normal((n, W)) if complex_vals else None
    if complex_vals:
        vim[rng.random((n, W)) < 0.2] = 0.0
    # a pair that cancels exactly: dropped after the merge
    cols[0, :2] = 5
    vre[0, :2] = [1.5, -1.5]
    if complex_vals:
        vim[0, :2] = [0.25, -0.25]
    vre[cols < 0] = 0.0
    if complex_vals:
        vim[cols < 0] = 0.0
    cn, rn, inn = _compact_rows_np(cols.copy(), vre.copy(),
                                   None if vim is None else vim.copy())
    vals = vre + 1j * vim if complex_vals else vre
    ct, vt = compact_rows(torch.as_tensor(cols), torch.as_tensor(vals))
    np.testing.assert_array_equal(ct.numpy(), cn)
    np.testing.assert_array_equal(vt.numpy().real, rn)
    if complex_vals:
        np.testing.assert_array_equal(vt.numpy().imag, inn)
