"""Port solvers against the JAX package on one shared ELL matrix.

The JAX package's chain-16 k=1 momentum-sector ELL (complex) is carried into
the port, so both thick-restart Lanczos solvers and both RQI polishes work on
the same matrix from the same start; eigenvalues must agree to 1e-10.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import models_zoo as jz
from quantum_basis_tpu.ops.pallas_bsr import ell_to_bsr as jax_ell_to_bsr
from quantum_basis_tpu.ops.sparse import build_sparse_repr as jax_build
from quantum_basis_tpu.solvers.restarted import eigs_smallest as jax_eigs
from quantum_basis_tpu.solvers.rqi import rqi_polish as jax_rqi
from quantum_basis_tpu_torch.interop import ell_from_numpy, vec_to_split
from quantum_basis_tpu_torch.ops.bsr import ell_to_bsr
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish


@pytest.fixture(scope="module")
def shared_ell():
    m, c = jz.heisenberg_chain(16)
    m.enumerate_basis_repr([1], [c["Sz"]], [0.0])
    ej = jax_build(m.sec_repr[0].matvec)
    return ej, ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")


def _residual(op, v, e):
    return float(torch.linalg.vector_norm(op(v) - e * v))


@pytest.mark.parametrize("nev", [1, 2])
def test_eigs_smallest_matches_jax(shared_ell, nev):
    ej, et = shared_ell
    vals_j, _ = jax_eigs(ej, ej.n, nev=nev, ncv=12, complex_vec=True)
    vals_t, vecs_t = eigs_smallest(et, et.n, nev=nev, ncv=12,
                                   complex_vec=True)
    np.testing.assert_allclose(vals_t, vals_j, rtol=0, atol=1e-10)
    for e, v in zip(vals_t, vecs_t):
        assert v.dtype == torch.complex128
        assert _residual(et, v, e) < 1e-8


def test_rqi_polish_matches_jax(shared_ell):
    """f32 BSR bulk start, then the f64 polish in both packages."""
    ej, et = shared_ell
    bsr32 = ell_to_bsr(et, dtype=torch.float32)
    _, v32 = eigs_smallest(bsr32, et.n, nev=1, ncv=12, complex_vec=True,
                           tol=1e-5, verify_degenerate=False)
    assert v32[0].dtype == torch.complex64
    out_t = rqi_polish(et, v32[0], fs32=bsr32)
    re, im = vec_to_split(v32[0])
    jb32 = jax_ell_to_bsr(ej, interpret=True, dtype=np.float32)
    out_j = jax_rqi(ej, (np.asarray(re), np.asarray(im)), fs32=jb32)
    assert out_t["converged"] and out_j["converged"]
    assert abs(out_t["E0"] - out_j["E0"]) < 1e-10
    vals_j, _ = jax_eigs(ej, ej.n, nev=1, ncv=12, complex_vec=True)
    assert abs(out_t["E0"] - vals_j[0]) < 1e-10
    assert _residual(et, out_t["vector"], out_t["E0"]) < 1e-8
