"""Port enumeration, index and translation orbits against the JAX package.

Sector labels, orbit representatives and momentum-sector norms of the port
(quantum_basis_tpu_torch, CPU tensors) must equal the JAX package's: labels
and representatives exactly, norms to 1e-14.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.enumerate import enumerate_basis as jax_enumerate
from quantum_basis_tpu.basis.translation import (
    TranslationSet as JaxTranslationSet,
    enumerate_reps as jax_enumerate_reps,
    sector_norms as jax_sector_norms,
)
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
    sector_norms,
)

CASES = {
    # name: (builder, conserved names, values, momenta, sector dim)
    "chain12_Sz0": (lambda z: z.heisenberg_chain(12), ["Sz"], [0.0],
                    [[0], [1], [5], [6]], 924),
    "kagome_tj_2x2_N8_Sz0": (lambda z: z.kagome_tj(2, 2), ["N", "Sz"],
                             [8.0, 0.0], [[0, 0], [0, 1], [1, 0], [1, 1]],
                             34650),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sector_labels_reps_norms_equal(name):
    build, names, vals, momenta, dim = CASES[name]
    mj, oj = build(jz)
    mt, ot = build(tz)
    lab_j = jax_enumerate(mj.space, [oj[k] for k in names], vals)
    lab_t = enumerate_basis(mt.space, [ot[k] for k in names], vals,
                            device="cpu", chunk=1 << 16)
    assert lab_t.size == dim
    np.testing.assert_array_equal(lab_t, lab_j)

    tj = JaxTranslationSet(mj.space, mj.lattice)
    tt = TranslationSet(mt.space, mt.lattice, device="cpu")
    reps_j = jax_enumerate_reps(tj, lab_j)
    reps_t = enumerate_reps(tt, lab_t)
    np.testing.assert_array_equal(reps_t, reps_j)
    for k in momenta:
        np.testing.assert_allclose(sector_norms(tt, reps_t, k),
                                   jax_sector_norms(tj, reps_j, k),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("mode", ["direct", "bsearch"])
def test_index_lookup(mode):
    rng = np.random.default_rng(5)
    space = 1 << 12
    labels = np.sort(rng.choice(space, size=700, replace=False))
    idx = BasisIndex(labels, space, mode=mode, device="cpu")
    tgt = torch.as_tensor(rng.integers(0, space, size=(30, 40)))
    j, valid = idx.lookup_checked(tgt)
    pos = np.searchsorted(labels, tgt.numpy())
    present = np.isin(tgt.numpy(), labels)
    np.testing.assert_array_equal(valid.numpy(), present)
    np.testing.assert_array_equal(j.numpy()[present], pos[present])
