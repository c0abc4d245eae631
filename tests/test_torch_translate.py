"""The port's block-transpose translations, momentum projector and projected
full-space operator against the JAX package's and the permutation oracle.

Translations and signs are exact (a permutation and +-1); ``P_k`` agrees
with the JAX ``MomentumProjector.apply_host`` to 1e-13 (sums of L_d terms of
size one); idempotence and the resolution of identity to 1e-12;
``ProjectedFullOp`` H x to 1e-12 * max|y| in float64 and 5e-6 * max|y| with
the float32 engine (its matrix products run in float32).
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.site_basis import SiteBasis as JaxSiteBasis
from quantum_basis_tpu.basis.state import StateSpace as JaxStateSpace
from quantum_basis_tpu.lattice import Lattice as JaxLattice
from quantum_basis_tpu.ops.translate_fullspace import (
    MomentumProjector as JaxProjector,
    RollTranslations as JaxRolls,
)
from quantum_basis_tpu_torch import Lattice, SiteBasis, StateSpace, interop
from quantum_basis_tpu_torch.ops.translate_fullspace import (
    MomentumProjector,
    ProjectedFullOp,
    RollTranslations,
)

CASES = {
    "chain6_spin": (("chain", [6], ["pbc"]), ["spin-1/2"]),
    "chain6_fermion": (("chain", [6], ["pbc"]), ["spinless-fermion"]),
    "square2x3_spin": (("square", [2, 3], ["pbc", "pbc"]), ["spin-1/2"]),
    "kagome2x2_spin": (("kagome", [2, 2], ["pbc", "pbc"]), ["spin-1/2"]),
    "honeycomb3x2_fermion": (("honeycomb", [3, 2], ["pbc", "pbc"]),
                             ["spinless-fermion"]),
    "triangular2x2_tJ": (("triangular", [2, 2], ["pbc", "pbc"]), ["tJ"]),
    "kondo4": (("chain", [4], ["pbc"]), ["electron", "spin-1/2"]),
}


def _port(name):
    latt_args, kinds = CASES[name]
    lat = Lattice(*latt_args)
    space = StateSpace([(SiteBasis.named(k), lat.Nsites) for k in kinds])
    return lat, space, RollTranslations(space, lat, device="cpu")


def _jax(name):
    latt_args, kinds = CASES[name]
    lat = JaxLattice(*latt_args)
    space = JaxStateSpace([(JaxSiteBasis.named(k), lat.Nsites)
                           for k in kinds])
    return lat, space, JaxRolls(space, lat)


@pytest.mark.parametrize("name", sorted(CASES))
def test_translate_and_signs_match_permutation_oracle(name):
    lat, space, rolls = _port(name)  # the constructor self-checks unit shifts
    assert RollTranslations.supported(space, lat)
    _, _, jrolls = _jax(name)
    N = space.label_space
    x = torch.as_tensor(np.random.default_rng(1).normal(size=N))
    labels = np.arange(N, dtype=np.int64)
    disps, plans = lat.translation_group()
    for g in range(len(disps)):
        new_labels, parity = space.transform(labels, plans[g])
        want = np.zeros(N)
        want[new_labels] = x.numpy() * np.where(parity % 2 == 0, 1.0, -1.0)
        y = x
        for d in range(lat.dim):
            r = int(disps[g][d]) % int(lat.L[d])
            if not r:
                continue
            sg, sg_j = rolls.sign(d, r), jrolls.sign_host(d, r)
            assert (sg is None) == (sg_j is None)
            if sg is not None:
                assert sg.dtype == torch.int8
                np.testing.assert_array_equal(sg.numpy(), sg_j)
                signed = rolls.translate(y * sg, d, r)
                # the sign over destination labels gives the same vector
                assert torch.equal(signed,
                                   rolls.translate(y, d, r)
                                   * rolls.sign_dst(d, r))
                y = signed
            else:
                y = rolls.translate(y, d, r)
        np.testing.assert_array_equal(y.numpy(), want)
        np.testing.assert_array_equal(
            rolls.translate_disp(x, disps[g]).numpy(),
            jrolls.translate_disp(x.numpy(), disps[g]))


def test_translate_chains_when_the_axes_do_not_fit_one_permute(monkeypatch):
    """Past the axis limit of one copy the digit groups are permuted in
    chunks: same vector."""
    from quantum_basis_tpu_torch.ops import translate_fullspace as tf

    lat, space, rolls = _port("kagome2x2_spin")
    x = torch.as_tensor(np.random.default_rng(2).normal(size=space.label_space))
    whole = rolls.translate(x, 0, 1)
    assert len(rolls._perms(0, 1)) == 1
    monkeypatch.setattr(tf, "_MAX_PERMUTE_DIMS", 6)
    chunked = RollTranslations(space, lat, device="cpu")
    assert len(chunked._perms(0, 1)) > 1
    assert torch.equal(chunked.translate(x, 0, 1), whole)


@pytest.mark.parametrize("name,k", [("chain6_spin", [1]),
                                    ("chain6_fermion", [2]),
                                    ("square2x3_spin", [1, 2]),
                                    ("honeycomb3x2_fermion", [2, 1]),
                                    ("kondo4", [3])])
def test_projector_matches_jax_and_algebra(name, k):
    lat, space, rolls = _port(name)
    _, _, jrolls = _jax(name)
    N = space.label_space
    rng = np.random.default_rng(5)
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    xt = torch.as_tensor(x)
    jproj = JaxProjector(jrolls, k, force_complex=True)
    re, im = jproj.apply_host(x.real, x.imag)
    proj = MomentumProjector(rolls, k)
    y = proj.apply(xt)
    assert np.max(np.abs(y.numpy() - (re + 1j * im))) < 1e-13
    assert float((proj.apply(y) - y).abs().max()) < 1e-12     # idempotent
    # the same projector carried over from the JAX one's arrays
    specs = {(d, r): jrolls._specs(d, r)
             for d, _, shifts in jproj.dims for r, _ in shifts}
    carried = interop.projector_from_numpy(
        N, k, jproj.dims, jproj._phases_np, jproj._signs_np, specs,
        device="cpu")
    assert float((carried.apply(xt) - y).abs().max()) < 1e-13
    # a real float32 vector comes back complex64
    assert proj.apply(xt.real.float()).dtype == torch.complex64
    # resolution of identity: the sum over all momenta recovers x
    ranges = [range(int(lat.L[d])) if lat.bc[d] == "pbc" else range(1)
              for d in range(lat.dim)]
    tot = sum(MomentumProjector(rolls, list(kk)).apply(xt)
              for kk in itertools.product(*ranges))
    assert float((tot - xt).abs().max()) < 1e-12


HX_CASES = {
    "chain12": (lambda z: z.heisenberg_chain(12), lambda c: ([c["Sz"]], [0.0]),
                [5]),
    "hubbard4x2": (lambda z: z.fermi_hubbard_square(4, 2),
                   lambda c: ([c["Nup"], c["Ndn"]], [4.0, 4.0]), [1, 1]),
    "kagome2x2": (lambda z: z.kagome_heisenberg(2, 2),
                  lambda c: ([c["Sz"]], [0.0]), [0, 1]),
}


@pytest.mark.parametrize("name", sorted(HX_CASES))
def test_projected_hx_matches_jax(name):
    build, qn, k = HX_CASES[name]
    m, c = build(tz)
    mj, cj = build(jz)
    m.enumerate_basis_repr(k, *qn(c))
    mj.enumerate_basis_repr(k, *qn(cj))
    sec, secj = m.sec_repr[0], mj.sec_repr[0]
    fs, fsj = m._fullspace_repr_op(sec), mj._fullspace_repr_op(secj)
    assert isinstance(fs, ProjectedFullOp) and fsj is not None
    assert fs.is_complex and fs.dtype == torch.float64
    np.testing.assert_array_equal(fs.mask.numpy(), np.asarray(fsj.mask))
    N = fs.N
    rng = np.random.default_rng(11)
    x = rng.normal(size=N) + 1j * rng.normal(size=N)
    yr, yi = fsj((np.asarray(x.real), np.asarray(x.imag)))
    want = np.asarray(yr) + 1j * np.asarray(yi)
    scale = np.max(np.abs(want))
    y = fs(torch.as_tensor(x))
    assert np.max(np.abs(y.numpy() - want)) < 1e-12 * scale
    # the projection hook: mask, P_k, renormalise, as the JAX host hook
    pr, pi = fsj.project_host(x.real, x.imag)
    pj = pr + 1j * pi
    p = fs.project(torch.as_tensor(x)).numpy()
    assert np.max(np.abs(p - pj / np.linalg.norm(pj))) < 1e-13
    fs32 = m._fullspace_repr_op(sec, dtype=torch.float32)
    assert isinstance(fs32, ProjectedFullOp) and fs32.dtype == torch.float32
    assert fs32.projector is fs.projector
    y32 = fs32(torch.as_tensor(x).to(torch.complex64))
    assert y32.dtype == torch.complex64
    assert np.max(np.abs(y32.numpy() - want)) < 5e-6 * scale
