"""The port's factorized kron engine and ``ProductModel`` against the JAX
package.

``KronOp`` ``H x`` in float64 and float32 against the JAX ``KronOp`` (both of
its layouts) and against ``numpy.kron`` of the dense factors, on Hubbard 2x2
(one shared factor) and on an asymmetric (N_up, N_dn) = (3, 2) sector of 4x2
(two factors): 1e-12 x max|y| in float64, 5e-6 x max|y| for the float32
engine. An engine rebuilt from the JAX arrays through
``interop.kron_from_numpy`` gives the same ``H x``. ``ProductModel``: the
2x2 spectrum against the port's site-major electron model (1e-8), the
Hubbard 4x2 golden E0 = -14.07605866 (1e-8) pure f64 and mixed, the
asymmetric sector against the generic engine, double occupancy through
``measure_product_static`` against the JAX value.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_zoo as tz
import quantum_basis_tpu as qj
from quantum_basis_tpu.ops.operators import OprProd
from quantum_basis_tpu_torch import ProductModel, config
from quantum_basis_tpu_torch.interop import kron_from_numpy
from quantum_basis_tpu_torch.models import product as product_mod
from quantum_basis_tpu_torch.ops.apply_kron import (
    KronOp,
    _compact_coupling,
    _ell_to_dense,
)
from quantum_basis_tpu_torch.ops.dense import dense_matrix

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import square_fermi_hubbard as jh  # noqa: E402  (the JAX package's model functions)

E0_HUBBARD_4X2 = -14.07605866
_BUILT = {}


def both(name):
    """(JAX ProductModel, port ProductModel) for a named sector; cached."""
    if name not in _BUILT:
        if name == "2x2":
            _BUILT[name] = (jh.build_factorized(2, 2, Nf=2)[0],
                            tz.hubbard_factorized(2, 2, Nup=2)[0])
        elif name == "4x2_3_2":
            _BUILT[name] = (jh.build_factorized_sector(4, 2, 3, 2),
                            tz.hubbard_factorized(4, 2, Nup=3, Ndn=2)[0])
        else:
            _BUILT[name] = (jh.build_factorized(4, 2)[0],
                            tz.hubbard_factorized(4, 2)[0])
    return _BUILT[name]


def _jax_apply(op, x, dtype=np.float64):
    return np.asarray(op.apply(op.params, (jnp.asarray(x, dtype), None))[0],
                      np.float64)


def _numpy_kron(pm):
    """H = A (x) I + I (x) B + U P from the dense factor Hamiltonians."""
    def dense(m):
        s = m.sec_full[0]
        return dense_matrix(m.compiled_Ham, s.labels).real

    A = dense(pm.model_a)
    B = dense(pm.model_b or pm.model_a)
    P = pm._coupling_matrix()
    return (np.kron(A, np.eye(pm.nb)) + np.kron(np.eye(pm.na), B)
            + pm.coupling_scale * np.diag(P.reshape(-1)))


@pytest.mark.parametrize("name", ["2x2", "4x2_3_2"])
def test_kron_apply_matches_jax_and_numpy_kron(name):
    pj, pt = both(name)
    assert (pt.na, pt.nb, pt.dim) == (pj.na, pj.nb, pj.dim)
    assert (pt.model_b is None) == (name == "2x2")
    o64, o32 = pt.op(torch.float64), pt.op(torch.float32)
    assert isinstance(o64, KronOp) and pt.op() is o64
    assert o64.dtype == torch.float64 and o32.dtype == torch.float32
    assert o64.device.type == "cpu" and not o64.is_complex
    assert o64.mask is None and o64.N == pt.dim
    assert (o64._Bt is o64._Ad) == (name == "2x2")  # a shared factor
    assert o64._P.dtype == torch.int8
    jd = pj.op(jnp.float64, layout="dense")
    je = pj.op(jnp.float64, layout="ell")
    assert o64.nnz_estimate == jd.nnz_estimate
    x = np.random.default_rng(7).standard_normal(pt.dim)
    y64 = o64(torch.as_tensor(x)).numpy()
    scale = np.abs(y64).max()
    for want in (_jax_apply(jd, x), _jax_apply(je, x), _numpy_kron(pt) @ x):
        assert np.abs(y64 - want).max() <= 1e-12 * scale
    y32 = o32(torch.as_tensor(x, dtype=torch.float32))
    assert y32.dtype == torch.float32
    assert np.abs(y32.numpy() - y64).max() <= 5e-6 * scale
    j32 = _jax_apply(pj.op(jnp.float32, layout="dense"), x, np.float32)
    assert np.abs(y32.numpy() - j32).max() <= 5e-6 * scale
    with pytest.raises(NotImplementedError, match="real engine"):
        o64(torch.as_tensor(x + 0j))
    assert o64.n_applies == 1 and o32.n_applies == 1


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("name", ["2x2", "4x2_3_2"])
def test_kron_from_jax_arrays(name, dt):
    pj, _ = both(name)
    jop = pj.op(jnp.dtype(dt), layout="dense")
    (Ad,), (Bt,), adiag, bdiag, P = jop.params
    ot = kron_from_numpy(np.asarray(Ad), np.asarray(Ad) if Bt is Ad
                         else np.asarray(Bt), np.asarray(adiag),
                         np.asarray(bdiag), np.asarray(P), jop._pscale,
                         device="cpu")
    assert ot.dtype == getattr(torch, dt) and (ot.na, ot.nb) == (pj.na, pj.nb)
    x = np.random.default_rng(8).standard_normal(pj.dim)
    want = _jax_apply(jop, x, np.dtype(dt))
    got = ot(torch.as_tensor(x)).numpy()
    tol = 1e-12 if dt == "float64" else 5e-6
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_ell_to_dense_and_compact_coupling():
    _, pt = both("4x2_3_2")
    ell_a, ell_b = pt._factor_ells()
    for ell, m in ((ell_a, pt.model_a), (ell_b, pt.model_b)):
        H = dense_matrix(m.compiled_Ham, m.sec_full[0].labels).real
        np.testing.assert_allclose(
            _ell_to_dense(ell, torch.float64).numpy()
            + np.diag(ell.diag.numpy()), H, rtol=0, atol=1e-14)
    assert _compact_coupling(np.array([[0.0, 2.0], [1.0, 3.0]])).dtype \
        == np.int8
    assert _compact_coupling(np.array([[0.5, 2.0]])).dtype == np.float32
    P = pt._coupling_matrix()
    assert P.shape == (pt.na, pt.nb) and P.max() == 2.0  # min(N_up, N_dn)


def test_product_model_2x2_spectrum_matches_site_major_model():
    """Full 36-dim spectrum of Hubbard 2x2 (2 up, 2 down): the factorized
    engine (species-major JW) against the port's generic model in the
    site-major 'electron' encoding: two algorithms, two JW orderings."""
    _, pt = both("2x2")
    assert pt.dim == 36
    op = pt.op(torch.float64)
    Hk = torch.stack([op(e) for e in torch.eye(36, dtype=torch.float64)],
                     dim=1).numpy()
    np.testing.assert_allclose(Hk, Hk.T, atol=1e-12)
    m, o = tz.fermi_hubbard_square(2, 2)
    assert m.enumerate_basis_full([o["Nup"], o["Ndn"]], [2.0, 2.0]) == 36
    Hg = dense_matrix(m.compiled_Ham, m.sec_full[0].labels)
    np.testing.assert_allclose(np.linalg.eigvalsh(Hk),
                               np.linalg.eigvalsh(Hg), rtol=0, atol=1e-8)


@pytest.mark.parametrize("mixed", [False, True, None])
def test_product_model_hubbard_4x2_golden(mixed, monkeypatch):
    pt = tz.hubbard_factorized(4, 2)[0]
    assert pt.dim == 70 * 70
    if mixed is None:  # the automatic choice, its bound lowered to reach it
        monkeypatch.setitem(config.MEMORY["cpu"], "product_mixed_above",
                            1 << 10)
    E0 = pt.locate_E0_lanczos(mixed=mixed, ncv=16 if mixed is False else 6)
    assert abs(E0 - E0_HUBBARD_4X2) < 1e-8
    assert pt.eigenvals == [E0] and pt.eigenvecs[0].dtype == torch.float64
    v = pt.eigenvecs[0]
    res = float(torch.linalg.vector_norm(pt.op()(v) - E0 * v))
    assert res < max(1e3 * config.lanczos_precision * abs(E0), 5e-10)
    if mixed is False:
        assert torch.float32 not in pt._ops and pt.solve_info == {}
    else:
        info = pt.solve_info
        assert info["rqi_converged"] and not info["f32_stage_oom_fallback"]
        assert info["f32_stage_matvecs"] > 0 < info["rqi_inner_f32_matvecs"]
        assert info["f64_matvecs"] == info["rqi_outer"] < 8
        assert pt._last_residual < 1e-6
        # the inner CG checks its stop flag every 16 steps: a few applies
        # after it stopped are made and not counted as steps
        counted = info["f32_stage_matvecs"] + info["rqi_inner_f32_matvecs"]
        extra = pt.op(torch.float32).n_applies - counted
        assert 0 <= extra < 16 * info["rqi_outer"]


def test_product_model_gate_and_oom_fallback(monkeypatch):
    """The f32 stage's out-of-memory branch takes the rolling 2-vector
    Lanczos and still reaches the golden; a stalled polish raises with E0
    and the residual attached."""
    pt = tz.hubbard_factorized(4, 2)[0]

    def no_memory(*a, **k):
        raise torch.OutOfMemoryError("the Krylov basis does not fit")

    monkeypatch.setattr(product_mod.Model, "_f32_stage_cached",
                        staticmethod(no_memory))
    logged = []
    E0 = pt.locate_E0_lanczos(mixed=True, log=logged.append)
    assert abs(E0 - E0_HUBBARD_4X2) < 1e-8
    assert pt.solve_info["f32_stage_oom_fallback"] and len(logged) == 1

    stall = {"converged": False, "residual": 1e-5, "E0": -14.0,
             "vector": pt.eigenvecs[0], "n_outer": 1, "n_inner": 0}
    monkeypatch.setattr(product_mod, "rqi_polish", lambda *a, **k: stall)
    monkeypatch.setattr(product_mod, "lanczos_ground", lambda *a, **k: stall)
    with pytest.raises(RuntimeError, match="unconverged") as ei:
        pt.locate_E0_lanczos(mixed=True, log=logged.append)
    assert ei.value.E0 == -14.0 and ei.value.residual == 1e-5


def test_asymmetric_sector_matches_generic_engine():
    """(N_up, N_dn) = (3, 2) on 4x2 against the site-major electron model
    and the JAX ProductModel."""
    pj, pt = both("4x2_3_2")
    assert pt.dim == 56 * 28
    E0 = pt.locate_E0_lanczos(mixed=False, ncv=16)
    m, o = tz.fermi_hubbard_square(4, 2)
    assert m.enumerate_basis_full([o["Nup"], o["Ndn"]], [3.0, 2.0]) == pt.dim
    m.locate_E0_lanczos(nev=1, ncv=1)
    assert abs(E0 - m.eigenvals_full[0]) < 1e-8
    assert abs(E0 - pj.locate_E0_lanczos(mixed=False, ncv=16)) < 1e-10


def test_measure_product_static_matches_jax():
    """<n_up,0 n_dn,0>, a one-factor density and a hopping operator (an
    off-diagonal factor operator) against the JAX values on the JAX
    eigenvector, and the double occupancy against its direct sum."""
    pj, pt = both("4x2")
    pj.locate_E0_lanczos(mixed=False, ncv=16)
    pt.eigenvecs = [torch.as_tensor(np.array(pj.eigenvecs[0][0]))]
    nj = qj.Mopr([OprProd(1.0, [qj.Opr(0, 0, False, jh.N1)])])
    nt = tz.site_occupation(0)

    def hop(mod, c):
        a, b = mod.Opr(0, 0, True, c), mod.Opr(1, 0, True, c)
        return mod.Mopr() + a.dagger() * b + b.dagger() * a

    hj, ht = hop(qj, jh.C1), hop(tz, tz.C_SPINLESS)
    for (aj, bj), (at, bt) in (((nj, nj), (nt, nt)), ((nj, None), (nt, None)),
                               ((None, nj), (None, nt)), ((hj, nj), (ht, nt)),
                               ((hj, hj), (ht, ht))):
        want = pj.measure_product_static(aj, bj)
        assert abs(pt.measure_product_static(at, bt) - want) < 1e-10
    psi = pt.eigenvecs[0].numpy().reshape(pt.na, pt.nb)
    ms = pt.model_a
    occ = ms.space.decode(ms.sec_full[0].labels)[:, 0].astype(float)
    direct = float(np.einsum("rc,r,c->", psi**2, occ, occ))
    assert abs(pt.measure_product_static(nt, nt) - direct) < 1e-12
    assert abs(pt.measure_product_static() - 1.0) < 1e-12
    # the port's own solve gives the same double occupancy
    pt.locate_E0_lanczos(mixed=False, ncv=16)
    assert abs(pt.measure_product_static(nt, nt) - direct) < 1e-8


def test_unported_product_routes_name_their_slice(monkeypatch, tmp_path):
    ms = tz.hubbard_factor(2, 2, 2)
    # the basis mesh is ported (tests/test_torch_model_mesh.py); a mesh
    # that is not a BasisMesh is refused
    with pytest.raises(TypeError, match="BasisMesh"):
        ProductModel(ms, mesh=object())
    pm = ProductModel(ms)
    with pytest.raises(TypeError, match="BasisMesh"):
        pm.set_mesh(object())
    # checkpointing is ported: it writes a stage record instead of raising
    # (tests/test_torch_ckpt.py covers the records)
    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))
    e0 = pm.locate_E0_lanczos()
    assert np.isfinite(e0) and len(list(tmp_path.iterdir())) == 1
