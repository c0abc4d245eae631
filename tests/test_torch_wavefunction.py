"""The port's ``Wavefunction`` against the JAX package's.

The cases of tests/test_misc_components.py::test_wavefunction_algebra_and_apply
through both classes, and a fermionic ``apply`` on a seeded superposition
(the Holstein chain's Hamiltonian, whose real diagonal goes through
``compile_diagonal_complex``, plus a phonon-number diagonal with complex
coefficients, which the term tables carry): labels equal, amplitudes to
1e-12. ``compile_diagonal_complex`` itself on complex coefficients against
the JAX package's, and its refusal of an operator that is not diagonal.
"""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
import quantum_basis_tpu_torch as qt
from quantum_basis_tpu.basis.wavefunction import Wavefunction as JaxWavefunction
from quantum_basis_tpu.ops.compile import (
    compile_diagonal_complex as jax_compile_diagonal_complex)
from quantum_basis_tpu_torch.basis.wavefunction import Wavefunction
from quantum_basis_tpu_torch.ops.compile import compile_diagonal_complex


def _same(w, wj):
    assert np.array_equal(w.labels, wj.labels)
    np.testing.assert_allclose(w.amps, wj.amps, rtol=0, atol=1e-12)


def test_wavefunction_algebra_and_apply():
    mj, _ = jz.heisenberg_chain(6)
    mt, _ = tz.heisenberg_chain(6)
    for cls, pkg, m, kw in ((JaxWavefunction, qj, mj, {}),
                            (Wavefunction, qt, mt, {"device": "cpu"})):
        w = cls.from_label(0, 1.0)  # all-up
        sm2 = pkg.Mopr([pkg.OprProd(1.0, [pkg.Opr(2, 0, False,
                                                  tz.SP_HALF["Sm"])])])
        w2 = w.apply(sm2, m.space, **kw)
        assert w2.size == 1 and abs(w2.norm() - 1.0) < 1e-12
        hw = w.apply(m.Ham, m.space, **kw)
        assert hw.size == 1 and abs(hw.amps[0] - 6 / 4.0) < 1e-12
        s = w + w
        assert abs(s.inner(w) - 2.0) < 1e-12
        assert abs((0.5 * s).norm() - 1.0) < 1e-12
        assert (w + (-1.0) * w).size == 0
    _same(Wavefunction.from_label(0).apply(mt.Ham, mt.space, device="cpu"),
          JaxWavefunction.from_label(0).apply(mj.Ham, mj.space))


def test_fermionic_apply_with_complex_diagonal():
    mj, oj = tz.holstein_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr,
                                    6, 2)
    mt, ot = tz.holstein_chain(6, 2)
    rng = np.random.default_rng(4)
    labels = rng.integers(0, mt.space.label_space, size=40)
    amps = rng.normal(size=40) + 1j * rng.normal(size=40)
    out = []
    for cls, pkg, m, kw in ((JaxWavefunction, qj, mj, {}),
                            (Wavefunction, qt, mt, {"device": "cpu"})):
        op = m.Ham
        for x in range(6):
            op = op + complex(np.exp(0.3j * x)) * pkg.Mopr([pkg.OprProd(
                1.0, [pkg.Opr(x, 1, False, np.array([0.0, 1.0, 2.0]))])])
        out.append(cls(labels, amps).apply(op, m.space, **kw))
    _same(out[1], out[0])
    assert out[1].size > 40


def test_compile_diagonal_complex():
    mj, _ = jz.heisenberg_chain(6)
    mt, _ = tz.heisenberg_chain(6)
    labels = np.arange(64)
    vals = []
    for pkg, m, fn in ((qj, mj, jax_compile_diagonal_complex),
                       (qt, mt, compile_diagonal_complex)):
        op = pkg.Mopr()
        for x in range(6):
            op += complex(np.exp(1j * x)) * pkg.Mopr([pkg.OprProd(
                1.0, [pkg.Opr(x, 0, False, tz.SP_HALF["Sz"]),
                      pkg.Opr((x + 1) % 6, 0, False, tz.SP_HALF["Sz"])])])
        vals.append(fn(op, m.space)(m.space.decode(labels)))
        with pytest.raises(ValueError):
            fn(m.Ham, m.space)
    assert vals[1].dtype == np.complex128
    np.testing.assert_allclose(vals[1], vals[0], rtol=0, atol=1e-14)
