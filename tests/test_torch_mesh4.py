"""The port's multi-device route on a group of 4 ranks, against the JAX
package on a 4-device CPU mesh.

One gloo group of 4 separate processes (tests/torch_mp_worker.py, suite
"mesh4"), the rank count of the 4-card run, with the inputs of
tests/test_torch_sharded.py and test_torch_sample_sort.py:

- ``MatvecSharded`` (chain-12, honeycomb), ``EllShardedHalo`` (six matrices,
  with ``halo_stats()`` equal to the JAX engine's), ``FullSpaceSharded``
  (chain-10 and honeycomb, N = 2^10 and 2^12 in slices of 256 and 1024
  labels: rolls by more than a slice, and ranks with pieces for two peers),
  ``KronSharded`` (Hubbard 4x2, 70 rows padded to 72): H x to 1e-12 x
  max|y| of the JAX engine's;
- ``sample_sort``: random, duplicated and all-equal keys, equal to
  ``np.sort`` and (where its slack allows) the JAX package's sort;
- ``Model(mesh=)`` chain-16 Sz=0: E0 equal to the JAX package's mesh solve
  (1e-10) on the halo engine, with its ``halo_stats()``.

Every rank must report the same numbers bit for bit.
"""

from __future__ import annotations

import functools
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import models_zoo as jz
import torch_zoo as tz
from quantum_basis_tpu.basis.enumerate import enumerate_basis
from quantum_basis_tpu.ops.apply import DeviceBasis
from quantum_basis_tpu.ops.apply_fullspace import FullSpaceOp
from quantum_basis_tpu.ops.sparse import EllMatrix
from quantum_basis_tpu.parallel import (
    EllShardedHalo,
    MatvecSharded,
    basis_mesh,
)
from quantum_basis_tpu.parallel.fullspace_sharded import FullSpaceSharded
from quantum_basis_tpu.parallel.kron_sharded import KronSharded
from quantum_basis_tpu.parallel.sample_sort import sample_sort as jax_sort

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

P = 4


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = tz.WorkerGroup("mesh4", P, tmp_path_factory.mktemp("mesh4"))
    yield g
    g.close()


def _port(group, name, key="arrays"):
    """One output of every rank, asserted equal across the ranks."""
    results = group.results()
    i = 0 if key == "arrays" else 1
    first = results[0][i][name]
    for res in results[1:]:
        if i == 0:
            np.testing.assert_array_equal(res[i][name], first)
        else:
            assert res[i][name] == first
    return first


def _close(got, want, tol=1e-12):
    want = np.asarray(want)
    scale = np.max(np.abs(want))
    assert scale > 0
    assert np.max(np.abs(got - want)) <= tol * scale


def _cvec(y):
    re, im = (np.asarray(p) if p is not None else None for p in y)
    return re if im is None else re + 1j * im


@pytest.mark.parametrize("name,build,conserve,val,B,seed", [
    ("chain12", lambda: jz.heisenberg_chain(12, "1/2"), "Sz", 0.0, 64, 3),
    ("honeycomb", lambda: jz.spinless_fermion_honeycomb(3, 2), "N", 4.0, 32,
     4)])
def test_allgather_engine(group, name, build, conserve, val, B, seed):
    m, c = build()
    labels = enumerate_basis(m.space, [c[conserve]], [val])
    mvs = MatvecSharded(m.compiled_Ham, DeviceBasis(m.space, labels,
                                                    block_rows=B),
                        basis_mesh(P))
    x = np.random.default_rng(seed).standard_normal(labels.size)
    _close(_port(group, f"allgather_{name}"),
           mvs.unpad(mvs(mvs.pad((x, None))))[0])
    assert _port(group, f"allgather_{name}_n_pad", "scalars") == mvs.n_pad


@functools.cache
def _jax_ell(name):
    if name in ("banded", "odd"):
        cols, vals, diag = tz.banded_ell() if name == "banded" \
            else tz.odd_ell()
        return EllMatrix(cols, vals, None, diag)
    if name == "honeycomb":
        m, o = jz.spinless_fermion_honeycomb(3, 2)
        m.enumerate_basis_full([o["N"]], [4.0])
        return m.generate_Ham_sparse_full(0)
    m, c = jz.heisenberg_chain(12, "1/2")
    if name == "chain12_k2":
        m.enumerate_basis_repr([2], [c["Sz"]], [0.0])
        return m.generate_Ham_sparse_repr(0)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    return m.generate_Ham_sparse_full(0)


@pytest.mark.parametrize("name,complex_vec", [
    ("chain12", False), ("chain12_k2", True), ("chain12_k2", False),
    ("honeycomb", False), ("banded", False), ("odd", False)])
def test_halo_engine(group, name, complex_vec):
    ell = _jax_ell(name)
    hs = EllShardedHalo(ell, basis_mesh(P))
    x = tz.rand_vec(ell.n, complex_vec, 5)
    xs = (x.real, x.imag) if complex_vec else (x, None)
    _close(_port(group, f"halo_{name}_{'c' if complex_vec else 'r'}"),
           _cvec(hs.unpad(hs(hs.pad(xs)))))
    assert _port(group, f"halo_{name}", "scalars") == hs.halo_stats()


@pytest.mark.parametrize("name,build,conserve,val", [
    ("chain10", lambda: jz.heisenberg_chain(10, "1/2"), "Sz", 0.0),
    ("honeycomb", lambda: jz.spinless_fermion_honeycomb(3, 2), "N", 4.0)])
def test_fullspace_engine(group, name, build, conserve, val):
    m, c = build()
    m.enumerate_basis_full([c[conserve]], [val])
    s = m.sec_full[0]
    fs = FullSpaceOp(m.compiled_Ham, s.labels)
    assert _port(group, f"fullspace_{name}", "scalars") == "ok"
    fss = FullSpaceSharded(fs, basis_mesh(P))
    x = tz.rand_vec(s.dim, fs.is_complex, 11)
    xs = (jnp.asarray(x.real), jnp.asarray(x.imag) if fs.is_complex
          else None)
    y = fss(fss.to_full(xs))
    _close(_port(group, f"fullspace_{name}"), _cvec(y))
    _close(_port(group, f"fullspace_{name}_sector"), _cvec(fs.to_sector(y)))


def test_kron_engine(group):
    from square_fermi_hubbard import build_factorized

    pm, _ = build_factorized(4, 2)
    ell_a, ell_b = pm._factor_ells()
    sh = KronSharded(ell_a, ell_b, coupling=pm._coupling_matrix(),
                     coupling_scale=pm.coupling_scale, mesh=basis_mesh(P),
                     dtype=jnp.float64, layout="dense")
    x = np.random.default_rng(7).standard_normal(pm.dim)
    _close(_port(group, "kron"),
           np.asarray(sh.unpad(sh(sh.pad((x, None))))[0]))
    assert _port(group, "kron_na", "scalars") == sh.na == 72
    pad_rows = _port(group, "kron_padded_rows")
    assert pad_rows.shape == (2, pm.nb) and not pad_rows.any()


@pytest.mark.parametrize("case,slack", [("random_40000", 2.5),
                                        ("duplicates", 8.0),
                                        ("overflow", None)])
def test_sample_sort(group, case, slack):
    vals = tz.sort_inputs()[case]
    got = _port(group, f"sort_{case}")
    np.testing.assert_array_equal(got, np.sort(vals))
    if slack is not None:
        np.testing.assert_array_equal(got, jax_sort(vals, basis_mesh(P),
                                                    slack=slack))


def test_model_on_mesh(group):
    mj, cj = jz.heisenberg_chain(16)
    mj.set_mesh(basis_mesh(P))
    mj.enumerate_basis_full([cj["Sz"]], [0.0])
    mj.locate_E0_lanczos("full", nev=1, ncv=1)
    e0 = _port(group, "chain16_E0", "scalars")
    assert abs(e0 - (-7.142296361)) < 1e-8
    assert abs(e0 - mj.eigenvals_full[0]) < 1e-10
    assert _port(group, "chain16_engine", "scalars") == "EllShardedHalo"
    jmv = mj.sec_full[0]._mesh_mv[1]
    assert _port(group, "chain16_halo", "scalars") == jmv.halo_stats()
