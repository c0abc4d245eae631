"""Port explicit full-sector ELL (build_sparse_full) against the JAX package.

The ELL extracted from the port's ``MatvecFull`` must equal the JAX
package's entry for entry after row compaction: ``cols`` exactly, ``vals``
and ``diag`` to 1e-14 (both sum the same few table amplitudes per entry).
Both Hermiticity checks pass on H and raise on a deliberately non-Hermitian
ELL; ``Model.generate_Ham_sparse_full`` / ``generate_Ham_sparse_repr``
switch the sector's matvec to the ELL and keep the matrix-free apply.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from test_torch_apply import MODELS, build_both
from quantum_basis_tpu.ops.sparse import build_sparse_full as jax_build_full
from quantum_basis_tpu_torch.interop import ell_from_numpy
from quantum_basis_tpu_torch.ops.apply import DeviceBasis, MatvecFull
from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr
from quantum_basis_tpu_torch.ops.sparse import (
    EllMatrix,
    build_sparse_full,
    hermiticity_exact,
    hermiticity_probe,
)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_build_sparse_full_matches_jax(name):
    mj, mt, cplx = build_both(name)
    ej = jax_build_full(mj.sec_full[0].matvec)
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
