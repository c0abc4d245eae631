"""The port's distributed sample sort and sharded dnc enumeration against the
JAX package.

Two gloo groups of separate processes, of 2 and 3 ranks
(tests/torch_mp_worker.py, suite "sort"), each rank passing its part of the
inputs of tests/test_sample_sort.py (random n = 64, 1000, 40000; skewed with
duplicates; shuffled chain-14 labels; all-equal keys). Every rank's result
must equal ``np.sort`` and the JAX package's ``sample_sort`` on a P-device
mesh bit for bit. The documented difference: the input that overflows the
JAX package's default slack on 8 devices (its
``test_sample_sort_receive_overflow_is_loud``) sorts here, since every
exchange carries its exact size. The sharded enumerators
(``enumerate_basis_dnc_sharded`` on Hubbard 4x2, ``enumerate_reps_dnc_sharded``
on chain-12) are bit-identical to the JAX package's and to the port's
single-rank enumerators, and the ``tile_select`` shares add up to the whole.
"""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.enumerate import (
    enumerate_basis_dnc as jax_enumerate_basis_dnc,
)
from quantum_basis_tpu.basis.translation import TranslationSet
from quantum_basis_tpu.basis.weisse import (
    enumerate_reps_dnc as jax_enumerate_reps_dnc,
)
from quantum_basis_tpu.parallel import (
    basis_mesh,
    enumerate_basis_dnc_sharded as jax_basis_sharded,
    enumerate_reps_dnc_sharded as jax_reps_sharded,
)
from quantum_basis_tpu.parallel.sample_sort import sample_sort as jax_sort
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis_dnc
from quantum_basis_tpu_torch.basis.weisse import enumerate_reps_dnc

RANKS = (2, 3)
# the slack the JAX package's own tests give each input
JAX_SLACK = {"skewed": 4.0, "duplicates": 8.0}
CASES = ["random_64", "random_1000", "random_40000", "skewed", "labels",
         "duplicates"]


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {P: tz.WorkerGroup("sort", P, tmp_path_factory.mktemp(f"sort{P}"))
          for P in RANKS}
    yield gs
    for g in gs.values():
        g.close()


@pytest.fixture(scope="module")
def inputs():
    return tz.sort_inputs()


def _same_on_every_rank(results, name):
    first = results[0][0][name]
    for arrays, _ in results[1:]:
        np.testing.assert_array_equal(arrays[name], first)
    return first


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("P", RANKS)
def test_sample_sort_matches_numpy_and_jax(groups, inputs, P, case):
    vals = inputs[case]
    want = jax_sort(vals, basis_mesh(P), slack=JAX_SLACK.get(case, 2.5))
    np.testing.assert_array_equal(want, np.sort(vals))
    got = _same_on_every_rank(groups[P].results(), case)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("P", RANKS)
def test_overflowing_input_sorts(groups, inputs, P):
    """All keys equal route every element to one rank: the JAX package's
    default slack overflows on 8 devices and raises; the port's exchange
    has no capacity and sorts it."""
    vals = inputs["overflow"]
    with pytest.raises(RuntimeError, match="overflow"):
        jax_sort(vals, basis_mesh(8), slack=2.5)
    got = _same_on_every_rank(groups[P].results(), "overflow")
    np.testing.assert_array_equal(got, np.sort(vals))


@pytest.mark.parametrize("P", RANKS)
def test_local_parts_in_rank_order(groups, inputs, P):
    """``sample_sort_sharded``: each rank's part, concatenated in rank
    order, is the sorted whole."""
    parts = [arrays["local_random_40000"] for arrays, _ in groups[P].results()]
    assert all(p.size for p in parts)
    np.testing.assert_array_equal(np.concatenate(parts),
                                  np.sort(inputs["random_40000"]))


@pytest.mark.parametrize("P", RANKS)
def test_sharded_basis_enumeration_bit_identical(groups, P):
    m, o = jz.fermi_hubbard_square(4, 2)
    args = (m.space, [o["Nup"], o["Ndn"]], [4.0, 4.0])
    want = jax_basis_sharded(*args, basis_mesh(P), leaf=1 << 6)
    mt, ot = tz.fermi_hubbard_square(4, 2)
    single = enumerate_basis_dnc(mt.space, [ot["Nup"], ot["Ndn"]],
                                 [4.0, 4.0], leaf=1 << 6)
    got = _same_on_every_rank(groups[P].results(), "basis_dnc")
    assert got.size == 4900
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)


@pytest.mark.parametrize("P", RANKS)
def test_sharded_reps_enumeration_bit_identical(groups, P):
    m, c = jz.heisenberg_chain(12, "1/2")
    tset = TranslationSet(m.space, m.lattice)
    want, dim_j = jax_reps_sharded(tset, [c["Sz"]], [0.0], basis_mesh(P),
                                   block=1 << 10, with_dim=True)
    mt, ct = tz.heisenberg_chain(12)
    single, dim_t = enumerate_reps_dnc(mt.tset, [ct["Sz"]], [0.0],
                                       block=1 << 10, with_dim=True)
    results = groups[P].results()
    got = _same_on_every_rank(results, "reps_dnc")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, single)
    assert {s["reps_dim"] for _, s in results} == {dim_j} == {dim_t} == {924}


@pytest.mark.parametrize("P", RANKS)
def test_tile_select_shares_make_the_whole(P):
    """One-pass ``n_parts`` == per-rank ``tile_select`` calls == the JAX
    package's shares, and together the single-rank output; the streamed
    representative tiles likewise."""
    mt, ot = tz.fermi_hubbard_square(4, 2)
    args = (mt.space, [ot["Nup"], ot["Ndn"]], [4.0, 4.0])
    parts = enumerate_basis_dnc(*args, leaf=1 << 6, n_parts=P)
    m, o = jz.fermi_hubbard_square(4, 2)
    jparts = jax_enumerate_basis_dnc(m.space, [o["Nup"], o["Ndn"]],
                                     [4.0, 4.0], leaf=1 << 6, n_parts=P)
    assert len(parts) == len(jparts) == P
    for r in range(P):
        share = enumerate_basis_dnc(*args, leaf=1 << 6, tile_select=(r, P),
                                    sort=False)
        np.testing.assert_array_equal(parts[r], share)
        np.testing.assert_array_equal(parts[r], jparts[r])
    np.testing.assert_array_equal(np.sort(np.concatenate(parts)),
                                  enumerate_basis_dnc(*args, leaf=1 << 6))

    mc, cc = tz.heisenberg_chain(12)
    whole, dim = enumerate_reps_dnc(mc.tset, [cc["Sz"]], [0.0], block=1 << 8,
                                    with_dim=True)
    jm, jc = jz.heisenberg_chain(12, "1/2")
    jt = TranslationSet(jm.space, jm.lattice)
    shares, dims = [], 0
    for r in range(P):
        share, d = enumerate_reps_dnc(mc.tset, [cc["Sz"]], [0.0],
                                      block=1 << 8, with_dim=True,
                                      tile_select=(r, P), sort=False)
        jshare, jd = jax_enumerate_reps_dnc(jt, [jc["Sz"]], [0.0],
                                            block=1 << 8, with_dim=True,
                                            tile_select=(r, P), sort=False)
        np.testing.assert_array_equal(share, jshare)
        assert d == jd
        shares.append(share)
        dims += d
    np.testing.assert_array_equal(np.sort(np.concatenate(shares)), whole)
    assert dims == dim
