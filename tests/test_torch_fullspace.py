"""The port's masked-roll full-label-space engine against the JAX package.

``supports_fullspace`` must give the JAX package's answer on the zoo (t-J is
rejected: d = 3 fermionic slots have no popcount parity). ``FullSpaceOp``
``H x`` on seeded sector vectors (real, and complex where H is) must agree
with the JAX ``FullSpaceOp`` over the whole label space and with the port's
own matrix-free ``MatvecFull`` on the sector, to 1e-12 x max|y|; amplitudes
outside the sector stay exactly zero; ``to_full``/``to_sector`` round-trip.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
import quantum_basis_tpu as qj
from quantum_basis_tpu.ops.apply_fullspace import (
    FullSpaceOp as JaxFullSpaceOp,
    supports_fullspace as jax_supports_fullspace,
)
from quantum_basis_tpu_torch.ops.apply_fullspace import (
    FullSpaceOp,
    _parity,
    supports_fullspace,
)


def _dm(z):
    if z is tz:
        return tz.dm_chain(10, 0.3)
    return tz.dm_chain_with(qj.Lattice, qj.Model, qj.Opr, qj.Mopr, 10, 0.3)


def _tj(z):
    if z is tz:
        return tz.tj_chain(8)
    import test_golden_chain as g

    m, sz, n = g.build_tj_chain(8)
    return m, {"Sz": sz, "N": n}


ZOO = {
    # name: (model function, conserved names, values, supported)
    "chain12_Sz0": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], True),
    "honeycomb_3x2_N4": (lambda z: z.spinless_fermion_honeycomb(3, 2),
                         ["N"], [4.0], True),
    "hubbard_4x2_half": (lambda z: z.fermi_hubbard_square(4, 2),
                         ["Nup", "Ndn"], [4.0, 4.0], True),
    "bose_2x2_N4": (lambda z: z.bose_hubbard_square(2, 2, 2), ["N"], [4.0],
                    True),
    "dm_chain10_Sz0": (_dm, ["Sz"], [0.0], True),
    "kagome_tj_1x2": (lambda z: z.kagome_tj(1, 2), ["N", "Sz"], [4.0, 0.0],
                      False),
    "tj_chain8": (_tj, ["Sz", "N"], [0.0, 6.0], False),
}


def build_both(name):
    build, names, vals, _ = ZOO[name]
    mj, oj = build(jz)
    mt, ot = build(tz)
    mj.enumerate_basis_full([oj[c] for c in names], vals)
    mt.enumerate_basis_full([ot[c] for c in names], vals)
    return mj, mt


def sector_vector(N, labels, seed, cplx):
    """A seeded vector supported on the sector, over the label space."""
    rng = np.random.default_rng(seed)
    x = np.zeros(N, dtype=np.complex128 if cplx else np.float64)
    x[labels] = rng.normal(size=labels.size)
    if cplx:
        x[labels] += 1j * rng.normal(size=labels.size)
    return x


def jax_apply(op, x, dtype=np.float64):
    """The JAX engine on a numpy vector; returns a complex or real array."""
    xr = np.asarray(x.real, dtype)
    xi = np.asarray(x.imag, dtype) if np.iscomplexobj(x) else None
    yr, yi = op((xr, xi))
    if yi is None:
        return np.asarray(yr, np.float64)
    return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_supports_fullspace_matches_jax(name):
    build, _, _, supported = ZOO[name]
    mj, _ = build(jz)
    mt, _ = build(tz)
    assert (supports_fullspace(mt.compiled_Ham)
            == jax_supports_fullspace(mj.compiled_Ham) == supported)
    if not supported:
        with pytest.raises(ValueError, match="popcount"):
            FullSpaceOp(mt.compiled_Ham, device="cpu")


@pytest.mark.parametrize("name", sorted(n for n in ZOO if ZOO[n][3]))
def test_fullspace_apply_matches_jax_and_matvec_full(name):
    mj, mt = build_both(name)
    st = mt.sec_full[0]
    labels = st.labels
    fj = JaxFullSpaceOp(mj.compiled_Ham, labels)
    ft = FullSpaceOp(mt.compiled_Ham, labels, device="cpu")
    assert ft.dtype == torch.float64 and ft.device.type == "cpu"
    assert ft.is_complex == fj.is_complex == st.matvec.is_complex
    assert ft.N == fj.N and ft.n_passes == len(fj._passes)
    assert ft.nnz_estimate == fj.nnz_estimate
    np.testing.assert_array_equal(ft.mask.numpy(), np.asarray(fj.mask))
    np.testing.assert_allclose(ft.diag_full.numpy(), np.asarray(fj.diag_full),
                               rtol=0, atol=1e-13)
    for cplx in ([True] if ft.is_complex else [False, True]):
        x = sector_vector(ft.N, labels, 7, cplx)
        y = ft(torch.as_tensor(x))
        assert y.is_complex() == cplx
        want = jax_apply(fj, x)
        scale = np.abs(want).max()
        assert np.abs(y.numpy() - want).max() <= 1e-12 * scale
        y_sec = st.matvec(torch.as_tensor(x[labels]))
        assert (ft.to_sector(y) - y_sec).abs().max() <= 1e-12 * scale
        # out-of-sector amplitudes remain exactly zero
        assert (y * (1.0 - ft.mask)).abs().max() == 0.0
    assert ft.n_applies == (1 if ft.is_complex else 2)


def test_to_full_to_sector_round_trip():
    _, mt = build_both("chain12_Sz0")
    labels = mt.sec_full[0].labels
    ft = FullSpaceOp(mt.compiled_Ham, labels, device="cpu")
    rng = np.random.default_rng(1)
    for x in (torch.as_tensor(rng.normal(size=labels.size)),
              torch.as_tensor(rng.normal(size=labels.size)
                              + 1j * rng.normal(size=labels.size))):
        full = ft.to_full(x)
        assert full.shape == (ft.N,) and full.dtype == x.dtype
        assert torch.equal(ft.to_sector(full), x)
        assert torch.equal(full * ft.mask, full)
        assert int((full != 0).sum()) == labels.size


def test_parity_is_popcount_mod_2():
    v = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2**31 - 1, size=4096), dtype=torch.int32)
    want = [bin(int(a)).count("1") & 1 for a in v]
    assert _parity(v).tolist() == want
