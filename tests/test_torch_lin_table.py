"""Port Lin tables, the Lin index mode and divide-and-conquer enumeration
against the JAX package.

All comparisons are exact (integers): ``Ja[label % SA] + Jb[label // SA]``
reproduces every row index; a momentum-sector representative subset has no
consistent Lin assignment (``LinTableError``) and ``BasisIndex`` falls back
to ``bsearch``; ``enumerate_basis_dnc`` labels equal the port's scan and the
JAX package's labels.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.enumerate import enumerate_basis as jax_enumerate
from quantum_basis_tpu.basis.lin_table import (
    LinTable as JaxLinTable,
    digit_split as jax_digit_split,
)
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.enumerate import (
    _enumerate_scan,
    enumerate_basis,
    enumerate_basis_dnc,
)
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import (
    LinTable,
    LinTableError,
    digit_split,
)


def _tj8(z):
    if z is tz:
        return tz.tj_chain(8)
    import test_golden_chain as g

    m, sz, n = g.build_tj_chain(8)
    return m, {"Sz": sz, "N": n}


SECTORS = {
    # name: (model function, conserved names, values, sector dim)
    "chain14_Sz0": (lambda z: z.heisenberg_chain(14), ["Sz"], [0.0], 3432),
    "chain12_Sz1": (lambda z: z.heisenberg_chain(12), ["Sz"], [1.0], 792),
    "tj_chain8_N6_Sz0": (_tj8, ["Sz", "N"], [0.0, 6.0], 560),
    "bose_hubbard_2x3_N4": (lambda z: z.bose_hubbard_square(2, 3, 3),
                            ["N"], [4.0], 120),
    "kondo4_N4_Sz0": (lambda z: z.kondo_chain(4, 1.3), ["N", "Sz"],
                      [4.0, 0.0], None),
}


@pytest.mark.parametrize("name", sorted(SECTORS))
def test_dnc_labels_equal_scan_and_jax(name):
    build, names, vals, dim = SECTORS[name]
    mj, oj = build(jz)
    mt, ot = build(tz)
    cons = [ot[c] for c in names]
    dnc = enumerate_basis_dnc(mt.space, cons, vals)
    assert dnc is not None and dnc.dtype == np.int64
    if dim is not None:
        assert dnc.size == dim
    np.testing.assert_array_equal(
        dnc, _enumerate_scan(mt.space, cons, vals, "cpu"))
    np.testing.assert_array_equal(
        dnc, enumerate_basis(mt.space, cons, vals, device="cpu"))
    np.testing.assert_array_equal(
        dnc, jax_enumerate(mj.space, [oj[c] for c in names], vals))
    # a small leaf forces the recursive join of slot groups
    np.testing.assert_array_equal(
        dnc, enumerate_basis_dnc(mt.space, cons, vals, leaf=8))


def test_dnc_declines_non_separable_operator():
    """A conserved operator coupling two slots is not a per-slot sum: the
    DnC path returns None and enumerate_basis falls through to the scan."""
    mt, ot = tz.heisenberg_chain(8)
    szsz = tz.sz_pair(0, 1) + tz.sz_pair(2, 3)
    assert enumerate_basis_dnc(mt.space, [szsz], [0.5]) is None
    labels = enumerate_basis(mt.space, [szsz], [0.5], device="cpu")
    V = mt.space.decode(labels)
    s = 0.5 - V  # Sz of each slot
    assert labels.size == 64 and np.all(
        np.abs(s[:, 0] * s[:, 1] + s[:, 2] * s[:, 3] - 0.5) < 1e-12)
    assert enumerate_basis(mt.space, [ot["Sz"]], [9.0],
                           device="cpu").size == 0


@pytest.mark.parametrize("name", sorted(SECTORS))
def test_lin_table_reproduces_every_row(name, monkeypatch):
    # the port carries the JAX package's numpy BFS, so that is the
    # counterpart: its C++ accelerator is switched off for the comparison
    from quantum_basis_tpu import native

    monkeypatch.setattr(native, "have_native", lambda: False)
    build, names, vals, _ = SECTORS[name]
    mj, _ = build(jz)
    mt, ot = build(tz)
    labels = enumerate_basis(mt.space, [ot[c] for c in names], vals,
                             device="cpu")
    sa = digit_split(mt.space)
    assert sa == jax_digit_split(mj.space)
    lt = LinTable(labels, mt.space.label_space, sa)
    j = np.arange(labels.size)
    np.testing.assert_array_equal(lt.Ja[labels % sa] + lt.Jb[labels // sa], j)
    np.testing.assert_array_equal(lt.lookup_np(labels), j)
    # the same lookups as the JAX package's tables (whose gauge may differ)
    ltj = JaxLinTable(labels, mj.space.label_space, sa)
    np.testing.assert_array_equal(ltj.lookup_np(labels), j)
    assert (lt.sa, lt.sb) == (ltj.sa, ltj.sb)


def test_lin_index_mode_and_fallback(monkeypatch):
    mt, ot = tz.heisenberg_chain(12)
    mt.enumerate_basis_repr([0], [ot["Sz"]], [0.0])
    sector = enumerate_basis(mt.space, [ot["Sz"]], [0.0], device="cpu")
    reps = mt.sec_repr[0].labels
    sa = digit_split(mt.space)
    space = mt.space.label_space

    # above direct_lookup_max a full sector takes the Lin mode by itself
    monkeypatch.setitem(config.MEMORY["cpu"], "direct_lookup_max", 16)
    idx = BasisIndex(sector, space, lin_split=sa, device="cpu")
    assert idx.mode == "lin"
    tgt = torch.as_tensor(sector)
    assert torch.equal(idx.lookup(tgt), torch.arange(sector.size))
    # labels outside the sector are flagged, whatever row they map to
    rng = np.random.default_rng(1)
    probe = torch.as_tensor(rng.integers(-5, space + 5, size=4000))
    j, valid = idx.lookup_checked(probe)
    assert int(j.min()) >= 0 and int(j.max()) < sector.size
    np.testing.assert_array_equal(valid.numpy(),
                                  np.isin(probe.numpy(), sector))
    for mode in ("direct", "bsearch"):
        other = BasisIndex(sector, space, mode=mode, device="cpu")
        j2, valid2 = other.lookup_checked(probe)
        assert torch.equal(valid, valid2)
        assert torch.equal(j[valid], j2[valid2])

    # a representative subset is not Lin-consistent: bsearch takes over
    with pytest.raises(LinTableError):
        LinTable(reps, space, sa)
    idx = BasisIndex(reps, space, lin_split=sa, device="cpu")
    assert idx.mode == "bsearch"
    assert torch.equal(idx.lookup(torch.as_tensor(reps)),
                       torch.arange(reps.size))
    assert BasisIndex(reps, space, device="cpu").mode == "bsearch"
    with pytest.raises(ValueError):
        BasisIndex(sector, space, mode="lin", device="cpu")
    with pytest.raises(ValueError):
        BasisIndex(sector, space, mode="hash", device="cpu")
