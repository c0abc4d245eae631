"""The port's stochastic-trace KPM (solvers/kpm.py) against the JAX
package's.

``kpm_moments`` draws the same random vectors (same seeds; the same
quantum-number mask on a full-space matvec) and records the same
doubling-trick moments to 1e-12; ``kpm_dos`` is the same numpy code (1e-12).
``jackson_kernel`` is defined once in the port (solvers/chebyshev.py) and
``kpm`` re-exports it; it equals both of the JAX package's definitions.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.solvers import chebyshev as jax_cheb
from quantum_basis_tpu.solvers import kpm as jax_kpm
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.solvers import chebyshev, kpm


def _full_space_chains(L):
    """Chain-L over all 2^L labels (no conserved quantity) in both
    packages, and the Sz = 0 mask over them."""
    mj, _ = jz.heisenberg_chain(L)
    mt, _ = tz.heisenberg_chain(L, device="cpu")
    mj.enumerate_basis_full()
    mt.enumerate_basis_full()
    st = mt.sec_full[0]
    ups = np.array([bin(int(x)).count("1") for x in st.labels])
    return mj.sec_full[0].matvec, st, (ups == L // 2).astype(np.float64)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("complex_vec", [False, True])
def test_kpm_moments_match_jax(masked, complex_vec):
    mvj, st, mask = _full_space_chains(8)
    bounds = (-4.0, 2.5)
    kw = dict(n_random=3, seed=5, complex_vec=complex_vec)
    muj = jax_kpm.kpm_moments(mvj, st.dim, 31, bounds,
                              mask=mask if masked else None, **kw)
    mu = kpm.kpm_moments(st.matvec, st.dim, 31, bounds,
                         mask=torch.as_tensor(mask) if masked else None, **kw)
    assert mu.shape == (31,)
    np.testing.assert_allclose(mu, muj, rtol=0, atol=1e-12)
    # the exact trace over the (masked) space, to stochastic accuracy
    H = dense_matrix(st.matvec.compiled, st.labels).real
    if masked:
        H = H[np.ix_(mask == 1, mask == 1)]
    w = np.linalg.eigvalsh(H)
    x = np.clip((w - sum(bounds) / 2) / ((bounds[1] - bounds[0]) / 2), -1, 1)
    exact = np.cos(np.arange(8)[:, None] * np.arccos(x)).mean(axis=1)
    np.testing.assert_allclose(mu[:8], exact, rtol=0, atol=0.25)
    assert abs(mu[0] - 1.0) < 1e-12


def test_jackson_kernel_defined_once_and_dos_matches_jax():
    assert kpm.jackson_kernel is chebyshev.jackson_kernel
    for n in (3, 64, 192):
        np.testing.assert_allclose(kpm.jackson_kernel(n),
                                   jax_kpm.jackson_kernel(n), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(kpm.jackson_kernel(n),
                                   jax_cheb.jackson_kernel(n), rtol=0,
                                   atol=1e-12)
    rng = np.random.default_rng(2)
    mu = rng.standard_normal(64) * np.exp(-0.04 * np.arange(64))
    es = np.linspace(-4.5, 3.0, 257)
    for kernel in ("jackson", "none"):
        np.testing.assert_allclose(
            kpm.kpm_dos(mu, es, (-4.6, 3.1), kernel=kernel),
            jax_kpm.kpm_dos(mu, es, (-4.6, 3.1), kernel=kernel), rtol=0,
            atol=1e-12)
