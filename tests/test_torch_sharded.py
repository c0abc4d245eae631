"""The port's sharded engines against the JAX package's on a P-device mesh.

Two gloo groups of separate processes, of 2 and 3 ranks
(tests/torch_mp_worker.py, suite "sharded"; 3 gives odd shard sizes), run
on the models of tests/test_sharded.py, test_halo_sharded.py,
test_fullspace_sharded.py and test_kron_sharded.py, with the same seeded
inputs:

- ``MatvecSharded`` (chain-12 Sz=0, 64-row blocks; spinless fermions on the
  honeycomb 3x2, N=4, 32-row blocks): H x and ``n_pad`` against the JAX
  engine;
- ``EllShardedHalo`` (chain-12 Sz=0 real; chain-12 k=2 complex on a complex
  and on a real vector; the fermionic honeycomb; a banded random matrix; a
  37-row matrix): H x, and ``halo_stats()`` equal to the JAX engine's
  exactly;
- ``FullSpaceSharded`` (chain-10, honeycomb): H x and ``to_sector`` against
  the JAX engine on 2 ranks; on 3 ranks both packages refuse (the label
  space does not divide);
- ``KronSharded`` on the Hubbard 4x2 factors (70 rows, padded to 72 on 3
  ranks): H x against the JAX engine, padded rows exactly zero.

H x agrees to 1e-12 x max|y| everywhere.
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

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))

RANKS = (2, 3)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    gs = {P: tz.WorkerGroup("sharded", P,
                            tmp_path_factory.mktemp(f"sharded{P}"))
          for P in RANKS}
    yield gs
    for g in gs.values():
        g.close()


def _port(groups, P, name, key="arrays"):
    """One output of every rank, asserted equal across the ranks."""
    results = groups[P].results()
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


ALLGATHER = {"chain12": (lambda: jz.heisenberg_chain(12, "1/2"), "Sz", 0.0,
                         64, 3),
             "honeycomb": (lambda: jz.spinless_fermion_honeycomb(3, 2), "N",
                           4.0, 32, 4)}


@pytest.mark.parametrize("name", sorted(ALLGATHER))
@pytest.mark.parametrize("P", RANKS)
def test_allgather_engine_matches_jax(groups, P, name):
    build, conserve, val, B, seed = ALLGATHER[name]
    m, c = build()
    labels = enumerate_basis(m.space, [c[conserve]], [val])
    mvs = MatvecSharded(m.compiled_Ham, DeviceBasis(m.space, labels,
                                                    block_rows=B),
                        basis_mesh(P))
    x = np.random.default_rng(seed).standard_normal(labels.size)
    want = mvs.unpad(mvs(mvs.pad((x, None))))[0]
    _close(_port(groups, P, f"allgather_{name}"), want)
    assert _port(groups, P, f"allgather_{name}_n_pad", "scalars") == mvs.n_pad


@functools.cache
def _jax_ell(name):
    """The JAX package's ELL of one halo case (built once per module)."""
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


HALO = [("chain12", False), ("chain12_k2", True), ("chain12_k2", False),
        ("honeycomb", False), ("banded", False), ("odd", False)]


@pytest.mark.parametrize("name,complex_vec", HALO)
@pytest.mark.parametrize("P", RANKS)
def test_halo_engine_matches_jax(groups, P, name, complex_vec):
    ell = _jax_ell(name)
    hs = EllShardedHalo(ell, basis_mesh(P))
    x = tz.rand_vec(ell.n, complex_vec, 5)
    xs = (x.real, x.imag) if complex_vec else (x, None)
    want = _cvec(hs.unpad(hs(hs.pad(xs))))
    got = _port(groups, P, f"halo_{name}_{'c' if complex_vec else 'r'}")
    _close(got, want)
    assert _port(groups, P, f"halo_{name}", "scalars") == hs.halo_stats()


FULLSPACE = {"chain10": (lambda: jz.heisenberg_chain(10, "1/2"), "Sz", 0.0),
             "honeycomb": (lambda: jz.spinless_fermion_honeycomb(3, 2), "N",
                           4.0)}


@pytest.mark.parametrize("name", sorted(FULLSPACE))
@pytest.mark.parametrize("P", RANKS)
def test_fullspace_engine_matches_jax(groups, P, name):
    build, conserve, val = FULLSPACE[name]
    m, c = build()
    m.enumerate_basis_full([c[conserve]], [val])
    s = m.sec_full[0]
    fs = FullSpaceOp(m.compiled_Ham, s.labels)
    status = _port(groups, P, f"fullspace_{name}", "scalars")
    if fs.N % P:
        with pytest.raises(ValueError, match="divide the mesh"):
            FullSpaceSharded(fs, basis_mesh(P))
        assert "divide the mesh" in status
        return
    assert status == "ok"
    fss = FullSpaceSharded(fs, basis_mesh(P))
    x = tz.rand_vec(s.dim, fs.is_complex, 11)
    xs = (jnp.asarray(x.real), jnp.asarray(x.imag) if fs.is_complex
          else None)
    y = fss(fss.to_full(xs))
    _close(_port(groups, P, f"fullspace_{name}"), _cvec(y))
    _close(_port(groups, P, f"fullspace_{name}_sector"),
           _cvec(fs.to_sector(y)))


@pytest.mark.parametrize("P", RANKS)
def test_kron_engine_matches_jax(groups, P):
    from square_fermi_hubbard import build_factorized

    pm, _ = build_factorized(4, 2)
    ell_a, ell_b = pm._factor_ells()
    sh = KronSharded(ell_a, ell_b, coupling=pm._coupling_matrix(),
                     coupling_scale=pm.coupling_scale, mesh=basis_mesh(P),
                     dtype=jnp.float64, layout="dense")
    x = np.random.default_rng(7).standard_normal(pm.dim)
    want = np.asarray(sh.unpad(sh(sh.pad((x, None))))[0])
    _close(_port(groups, P, "kron"), want)
    assert _port(groups, P, "kron_na", "scalars") == sh.na
    pad_rows = _port(groups, P, "kron_padded_rows")
    assert pad_rows.shape == (sh.na - 70, pm.nb) and not pad_rows.any()
