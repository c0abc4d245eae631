"""The port's ``TiltedLattice`` against the JAX package's, and tilted-cluster
momentum sectors through ``Model``.

A tilted cluster has no mixed-radix site numbering, so ``_fullspace_repr_op``
gives no engine and ``locate_E0_lanczos(which="repr")`` takes the explicit
route (dense below the cutoff, ELL or BSR above). Group tables are compared
exactly; energies to 1e-10 against the JAX package and to 1e-9 against the
full sector (two independent solves to solver tolerance).
"""

from __future__ import annotations

import numpy as np
import pytest

import models_zoo as jz  # noqa: F401  (puts the JAX package on its CPU)
import torch_zoo as tz
from quantum_basis_tpu import Model as JaxModel, Mopr as JaxMopr, Opr as JaxOpr
from quantum_basis_tpu.lattice.tilted import TiltedLattice as JaxTilted
from quantum_basis_tpu_torch import TiltedLattice, config
from quantum_basis_tpu_torch.ops.translate_fullspace import RollTranslations

CLUSTERS = {"square5": [[2, 1], [-1, 2]], "square18": [[3, 3], [-3, 3]]}


def _lattices(A):
    sites = [(c, 0) for c in tz.tilted_cosets(A)]
    args = (2, 1, np.eye(2), np.asarray(A), [[0.0, 0.0]], sites)
    return TiltedLattice(*args), JaxTilted(*args)


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_group_tables_equal(name):
    A = CLUSTERS[name]
    lt, lj = _lattices(A)
    assert lt.Nsites == lj.Nsites == int(round(abs(np.linalg.det(A))))
    assert lt.L is None
    dt, pt = lt.translation_group()
    dj, pj = lj.translation_group()
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(pt, pj)
    for k in tz.tilted_momenta(A):
        np.testing.assert_array_equal(lt.k_dot_R(k, dt), lj.k_dot_R(k, dj))
    rng = np.random.default_rng(1)
    for coor in rng.integers(-9, 10, size=(12, 2)):
        np.testing.assert_array_equal(lt.fold(coor), lj.fold(coor))
        assert lt.coor2site(coor) == lj.coor2site(coor)
    # the momenta are the distinct characters of the group
    chars = {tuple(np.round(np.exp(2j * np.pi * lt.k_dot_R(k, dt)), 9))
             for k in tz.tilted_momenta(A)}
    assert len(chars) == lt.Nsites


def test_from_toml(tmp_path):
    A = CLUSTERS["square5"]
    path = tmp_path / "square5.toml"
    lines = ["dim = 2", "num_sub = 1", "a0 = [1.0, 0.0]", "a1 = [0.0, 1.0]",
             f"A0 = {A[0]}", f"A1 = {A[1]}", "pos_sub0 = [0.0, 0.0]"]
    for c in tz.tilted_cosets(A):
        lines += ["[[sub0]]", f"site = {list(c)}"]
    path.write_text("\n".join(lines) + "\n")
    lt, lj = TiltedLattice.from_toml(str(path)), JaxTilted.from_toml(str(path))
    built, _ = _lattices(A)
    for lat in (lj, built):
        np.testing.assert_array_equal(lt.translation_group()[1],
                                      lat.translation_group()[1])
    assert lt.Nsites == 5 and lt.num_sub == 1 and lt.dim == 2


def test_square5_sectors_complete_and_match_full_and_jax():
    """Sum of k-sector dims = sector dim; min_k E0(k) = full E0; every E0(k)
    equal to the JAX package's (dense solves)."""
    A = CLUSTERS["square5"]
    m, c = tz.tilted_heisenberg(A)
    mj, cj = tz.tilted_heisenberg_with(JaxTilted, JaxModel, JaxOpr, JaxMopr, A)
    dim_full = m.enumerate_basis_full([c["Sz"]], [0.5])
    m.locate_E0_lanczos("full")
    dims, e0s = 0, []
    for k in tz.tilted_momenta(A):
        dims += m.enumerate_basis_repr(list(k), [c["Sz"]], [0.5], sec=1)
        assert m._fullspace_repr_op(m.sec_repr[1]) is None
        assert not RollTranslations.supported(m.space, m.lattice)
        m.locate_E0_lanczos("repr", sec=1)
        mj.enumerate_basis_repr(list(k), [cj["Sz"]], [0.5], sec=1)
        mj.locate_E0_lanczos("repr", sec=1)
        assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10
        e0s.append(m.eigenvals_repr[0])
    assert dims == dim_full == 10
    assert abs(min(e0s) - m.eigenvals_full[0]) < 1e-9


def test_square18_explicit_route(monkeypatch):
    """18 sites, Sz = 0 (dim 48,620): the sector dims add up; k = 0 (dim
    2,704, above the dense cutoff) takes the explicit route, here forced onto
    the f32 BSR bulk tier (its plain version on the CPU) with the f64 polish,
    and agrees with the JAX package's ELL route."""
    from quantum_basis_tpu_torch.ops.bsr import BsrMatrix

    A = CLUSTERS["square18"]
    m, c = tz.tilted_heisenberg(A)
    dims = [m.enumerate_basis_repr(list(k), [c["Sz"]], [0.0])
            for k in tz.tilted_momenta(A)]
    assert sum(dims) == 48620 and len(dims) == 18
    monkeypatch.setattr(config, "prefer_bsr", True)
    assert m.enumerate_basis_repr([0, 0], [c["Sz"]], [0.0]) > 600
    s = m.sec_repr[0]
    assert m._fullspace_repr_op(s) is None
    m.locate_E0_lanczos("repr")
    assert isinstance(s.bsr32, BsrMatrix) and s.bsr32.dtype.itemsize == 4
    mj, cj = tz.tilted_heisenberg_with(JaxTilted, JaxModel, JaxOpr, JaxMopr, A)
    mj.enumerate_basis_repr([0, 0], [cj["Sz"]], [0.0])
    assert mj._fullspace_repr_op(mj.sec_repr[0]) is None
    mj.locate_E0_lanczos("repr")
    assert abs(m.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10
