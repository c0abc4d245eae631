"""The port's streaming divide-and-conquer representatives
(basis/weisse.py) against direct classification over the materialized sector
and against the JAX package: exact, on the cases of tests/test_weisse_dnc.py.
"""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.translation import TranslationSet as JaxTset
from quantum_basis_tpu.basis.weisse import enumerate_reps_dnc as jax_dnc
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
)
from quantum_basis_tpu_torch.basis.weisse import enumerate_reps_dnc

CASES = {
    "chain12": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0], 1 << 12),
    "hubbard4x2": (lambda z: z.fermi_hubbard_square(4, 2), ["Nup", "Ndn"],
                   [4.0, 4.0], 1 << 12),
    "honeycomb3x2": (lambda z: z.spinless_fermion_honeycomb(3, 2), ["N"],
                     [4.0], 1 << 12),
    "kondo6": (lambda z: z.kondo_chain(6, 1.1), ["N", "Sz"], [6.0, 0.0],
               1 << 12),
    "chain8_unconstrained": (lambda z: z.heisenberg_chain(8), [], [],
                             1 << 10),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dnc_equals_direct_and_jax(name):
    build, names, vals, block = CASES[name]
    m, c = build(tz)
    mj, cj = build(jz)
    conserve = [c[n] for n in names]
    tset = TranslationSet(m.space, m.lattice, device="cpu")
    labels = (enumerate_basis(m.space, conserve, vals, device="cpu")
              if conserve else np.arange(m.space.label_space, dtype=np.int64))
    dnc, dim = enumerate_reps_dnc(tset, conserve, vals, with_dim=True,
                                  block=block)
    assert dim == labels.size
    np.testing.assert_array_equal(dnc, enumerate_reps(tset, labels))
    np.testing.assert_array_equal(
        dnc, jax_dnc(JaxTset(mj.space, mj.lattice), [cj[n] for n in names],
                     vals, block=block))


def test_tile_select_names_its_slice():
    """``tile_select`` is ported (the multi-device slice): each rank's share
    of the streamed tiles equals the JAX package's, and the shares make the
    whole (tests/test_torch_sample_sort.py merges them over gloo groups)."""
    m, c = tz.heisenberg_chain(8)
    mj, cj = jz.heisenberg_chain(8)
    tset = TranslationSet(m.space, m.lattice, device="cpu")
    whole, dim = enumerate_reps_dnc(tset, [c["Sz"]], [0.0], block=1 << 4,
                                    with_dim=True)
    shares, dims = [], 0
    for r in range(2):
        share, d = enumerate_reps_dnc(tset, [c["Sz"]], [0.0], block=1 << 4,
                                      with_dim=True, tile_select=(r, 2),
                                      sort=False)
        jshare, jd = jax_dnc(JaxTset(mj.space, mj.lattice), [cj["Sz"]],
                             [0.0], block=1 << 4, with_dim=True,
                             tile_select=(r, 2), sort=False)
        np.testing.assert_array_equal(share, jshare)
        assert d == jd and share.size
        shares.append(share)
        dims += d
    np.testing.assert_array_equal(np.sort(np.concatenate(shares)), whole)
    assert dims == dim == 70


def test_model_dnc_gives_the_direct_sector_and_energy():
    """``method="dnc"``: same representatives, norms and E0(k) as
    ``"direct"``, with the quantum-number mask built from the conserved
    operators (the sector's labels never exist)."""
    m, c = tz.heisenberg_chain(16)
    mn, cn = tz.heisenberg_chain(16)
    d_dim = m.enumerate_basis_repr([3], [c["Sz"]], [0.0])
    n_dim = mn.enumerate_basis_repr([3], [cn["Sz"]], [0.0], method="dnc")
    s_d, s_n = m.sec_repr[0], mn.sec_repr[0]
    assert d_dim == n_dim > 600
    np.testing.assert_array_equal(s_d.labels, s_n.labels)
    np.testing.assert_array_equal(s_d.dbasis.nus, s_n.dbasis.nus)
    assert s_d.qn[3] is not None and s_n.qn[3] is None
    fs_d, fs_n = m._fullspace_repr_op(s_d), mn._fullspace_repr_op(s_n)
    np.testing.assert_array_equal(fs_d.mask.numpy(), fs_n.mask.numpy())
    assert int(fs_n.mask.sum()) == 12870    # C(16, 8), never materialized
    # a second momentum on one model shares the engine and the mask
    mn.enumerate_basis_repr([1], [cn["Sz"]], [0.0], sec=1, method="dnc")
    fs_1 = mn._fullspace_repr_op(mn.sec_repr[1])
    assert fs_1.base is fs_n.base and fs_1.mask is fs_n.mask
    assert fs_1.projector is not fs_n.projector
    m.locate_E0_lanczos(which="repr")
    mn.locate_E0_lanczos(which="repr")
    assert abs(s_d.evals[0] - s_n.evals[0]) < 1e-12
    with pytest.raises(ValueError):
        m.enumerate_basis_repr([3], [c["Sz"]], [0.0], method="weisse")
