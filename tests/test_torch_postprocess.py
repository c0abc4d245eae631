"""The port's continued fractions (utils/contfrac.py) and post-processing
(postprocess.py) against the JAX package's: the same numpy code on seeded
inputs, to 1e-12. The plot functions write their files (skipped where
matplotlib is missing; the port imports it only inside them)."""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz  # noqa: F401  (puts the JAX package on its CPU)
import torch_zoo as tz
from quantum_basis_tpu import postprocess as jax_post
from quantum_basis_tpu.utils import contfrac as jax_cf
from quantum_basis_tpu_torch import postprocess
from quantum_basis_tpu_torch.utils import contfrac


def _coeffs(m, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(m), np.abs(rng.standard_normal(m)) + 0.2


def test_continued_fraction_and_greens_function_match_jax():
    a, b = _coeffs(17, 1)
    assert abs(contfrac.continued_fraction(a, b)
               - jax_cf.continued_fraction(a, b)) < 1e-12
    z = np.linspace(-4.0, 4.0, 201) + 0.07j
    np.testing.assert_allclose(contfrac.greens_function(z, 0.8, a, b),
                               jax_cf.greens_function(z, 0.8, a, b), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError):
        contfrac.continued_fraction(a, b[:-1])
    # the resolvent of the tridiagonal matrix: G(z) = norm2 <0|(z - T)^-1|0>
    T = np.diag(a) + np.diag(b[1:], 1) + np.diag(b[1:], -1)
    g = [np.linalg.inv(zz * np.eye(a.size) - T)[0, 0] for zz in z[::20]]
    np.testing.assert_allclose(contfrac.greens_function(z[::20], 1.0, a, b),
                               g, rtol=0, atol=1e-12)


def test_spectral_function_and_sqw_kpm_match_jax():
    a, b = _coeffs(30, 2)
    om = np.linspace(0.0, 6.0, 301)
    np.testing.assert_allclose(
        postprocess.spectral_function(om, 0.7, a, b, E0=-3.1, eta=0.08),
        jax_post.spectral_function(om, 0.7, a, b, E0=-3.1, eta=0.08),
        rtol=0, atol=1e-12)
    mu = np.random.default_rng(3).standard_normal(64) * np.exp(
        -0.05 * np.arange(64))
    mu[0] = 1.0
    np.testing.assert_allclose(
        postprocess.sqw_kpm(om, 0.7, mu, -5.0, 4.0, -3.1),
        jax_post.sqw_kpm(om, 0.7, mu, -5.0, 4.0, -3.1), rtol=0, atol=1e-12)
    assert not postprocess.sqw_kpm(om, 0.0, np.zeros(0), 0.0, 0.0, 0.0).any()


def test_plots_write_files(tmp_path):
    pytest.importorskip("matplotlib")
    runs = [_coeffs(12, s) for s in range(3)]
    runs = [(0.5 + 0.1 * i, a, b) for i, (a, b) in enumerate(runs)]
    om = np.linspace(0.0, 4.0, 50)
    S = postprocess.plot_sqw([0, 1, 2], runs, om, -2.0,
                             str(tmp_path / "sqw.png"))
    assert S.shape == (3, 50)
    np.testing.assert_allclose(S, jax_post.plot_sqw(
        [0, 1, 2], runs, om, -2.0, str(tmp_path / "sqw_jax.png")), rtol=0,
        atol=1e-12)
    m, _ = tz.kagome_heisenberg(2, 2, device="cpu")
    pos = postprocess.plot_lattice(m.lattice, str(tmp_path / "lat.png"),
                                   bonds=[(0, 1), (1, 2)])
    assert pos.shape == (12, 2)
    postprocess.plot_convergence([(1, 1e-2), (2, 1e-5), (3, 1e-9)],
                                 str(tmp_path / "conv.png"))
    for name in ("sqw.png", "lat.png", "conv.png"):
        assert (tmp_path / name).stat().st_size > 0
