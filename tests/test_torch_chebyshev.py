"""The port's Chebyshev solvers (solvers/chebyshev.py) against the JAX
package's.

``kpm_moments`` records the same operator-resolved moments from the same
start vector on the same chain (given bounds, and bounds from
``energy_scale``) to 1e-12; ``jackson_kernel``, ``kpm_density`` and the
window filter are the same numpy code (1e-12). ``eigs_window`` finds the same
interior eigenpairs as the JAX package (same seeds, count estimate and
subspace size) to 1e-10, equal to dense ``eigh`` to 1e-10, with residuals
under 1e-6. The float32 BSR engine carries the recurrence in float64 vectors:
its moments agree with the float64 ELL's to 5e-5.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.solvers import chebyshev as jax_cheb
from quantum_basis_tpu_torch.ops.bsr import ell_to_bsr
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.ops.sparse import build_sparse_full
from quantum_basis_tpu_torch.solvers import chebyshev
from quantum_basis_tpu_torch.utils.rng import vec_randomize


def _chains(L):
    mj, oj = jz.heisenberg_chain(L)
    mt, ot = tz.heisenberg_chain(L, device="cpu")
    mj.enumerate_basis_full([oj["Sz"]], [0.0])
    mt.enumerate_basis_full([ot["Sz"]], [0.0])
    return mj.sec_full[0].matvec, mt.sec_full[0]


@pytest.mark.parametrize("bounds", [None, (-5.5, 3.5)])
def test_kpm_moments_match_jax_and_dense(bounds):
    mvj, st = _chains(10)
    re, _ = vec_randomize(st.dim, seed=3)
    muj, lo_j, hi_j = jax_cheb.kpm_moments(mvj, (np.asarray(re), None), 40,
                                           bounds=bounds)
    mu, lo, hi = chebyshev.kpm_moments(st.matvec, torch.as_tensor(re), 40,
                                       bounds=bounds)
    assert mu.dtype == np.float64 and mu.shape == (40,)
    assert abs(lo - lo_j) < 1e-12 and abs(hi - hi_j) < 1e-12
    np.testing.assert_allclose(mu, muj, rtol=0, atol=1e-12)
    # the exact moments from the eigendecomposition
    w, U = np.linalg.eigh(dense_matrix(st.matvec.compiled, st.labels).real)
    c, d = chebyshev._rescale(lo, hi)
    wt = (U.T @ (re / np.linalg.norm(re))) ** 2
    exact = [np.sum(wt * np.cos(k * np.arccos((w - c) / d)))
             for k in range(40)]
    np.testing.assert_allclose(mu, exact, rtol=0, atol=1e-10)


def test_kpm_moments_on_the_float32_bsr_engine():
    """The float32 BSR engine (its plain version on the CPU) returns
    complex64 for a complex128 vector; the recurrence promotes every apply
    back, so the moments are float64 and equal the ELL's to 5e-5."""
    _, st = _chains(10)
    ell = build_sparse_full(st.matvec)
    bsr = ell_to_bsr(ell, dtype=torch.float32)
    re, im = vec_randomize(st.dim, seed=4, complex_valued=True)
    v = torch.as_tensor(re + 1j * im)
    mu64, _, _ = chebyshev.kpm_moments(ell, v, 64, bounds=(-6.0, 4.0))
    mu32, _, _ = chebyshev.kpm_moments(bsr, v, 64, bounds=(-6.0, 4.0))
    assert abs(mu32[0] - 1.0) < 1e-12
    np.testing.assert_allclose(mu32, mu64, rtol=0, atol=5e-5)
    assert np.max(np.abs(mu32)) <= 1.0 + 1e-5


def test_jackson_density_and_filter_match_jax():
    for n in (1, 2, 17, 192):
        np.testing.assert_allclose(chebyshev.jackson_kernel(n),
                                   jax_cheb.jackson_kernel(n), rtol=0,
                                   atol=1e-12)
    rng = np.random.default_rng(11)
    mu = rng.standard_normal(48) * np.exp(-0.05 * np.arange(48))
    es = np.linspace(-6.0, 5.0, 301)
    np.testing.assert_allclose(
        chebyshev.kpm_density(mu, -6.2, 5.3, es),
        jax_cheb.kpm_density(mu, -6.2, 5.3, es), rtol=0, atol=1e-12)
    for a, b in ((-4.0, -2.5), (-9.0, 0.0), (1.0, 9.0)):
        np.testing.assert_allclose(
            chebyshev._window_filter_coeffs(a, b, 120, -6.0, 5.0),
            jax_cheb._window_filter_coeffs(a, b, 120, -6.0, 5.0), rtol=0,
            atol=1e-12)
    assert chebyshev._rescale(-6.0, 5.0) == jax_cheb._rescale(-6.0, 5.0)


def test_eigs_window_matches_jax_and_dense():
    mvj, st = _chains(10)
    H = dense_matrix(st.matvec.compiled, st.labels).real
    evals = np.linalg.eigvalsh(H)
    lo, hi = evals[3] - 1e-6, evals[6] + 1e-6
    want = evals[(evals >= lo) & (evals <= hi)]
    kw = dict(nev_max=6, degree=120, n_iter=40,
              bounds=(evals[0] - 0.2, evals[-1] + 0.2))
    got, vecs = chebyshev.eigs_window(st.matvec, st.dim, lo, hi, **kw)
    got_j, _ = jax_cheb.eigs_window(mvj, st.dim, lo, hi, **kw)
    assert len(got) == len(got_j) == want.size
    np.testing.assert_allclose(got, got_j, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
    for t, v in zip(got, vecs):
        assert v.dtype == torch.float64
        assert np.linalg.norm(H @ v.numpy() - t * v.numpy()) < 1e-6
    with pytest.raises(ValueError, match="raise nev_max"):
        chebyshev.eigs_window(st.matvec, st.dim, evals[0] - 1.0, evals[60],
                              nev_max=4, degree=60, bounds=kw["bounds"])
