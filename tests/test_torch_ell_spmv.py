"""The port's ELL apply (``ops/sparse.py::ell_spmv``) against the JAX package.

The JAX package's explicit matrices (``build_sparse_full`` of two full
sectors, ``generate_Ham_sparse_repr`` of a momentum sector), carried across
with ``interop.ell_from_numpy``, go through both applies on seeded vectors:
the port's wrapper on CPU tensors (its plain version) against
``quantum_basis_tpu.ops.sparse.EllMatrix.apply`` to 1e-12 of max|y| in each
of the three instances (real values and a real x, real values and a complex
x, complex values). A diagonal-only matrix, an empty one, a row of padding
and the two-pointer form (``xd`` and ``xs`` apart, as the halo engine calls
it) against the plain expression; a momentum solve through
``Model(device="cpu")`` on the explicit route makes every apply through the
wrapper and gives the JAX package's E0 to 1e-10. The ``cuda``-marked tests
hold the ``csrc/ell_spmv.cu`` kernel against its plain version on the card
and check that a failed build raises; the JAX package is imported inside
the CPU tests only, so this file runs on a machine without JAX.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.interop import ell_from_numpy
from quantum_basis_tpu_torch.ops import cuda_build, sparse
from quantum_basis_tpu_torch.ops.apply_vrnl import MatvecVrnl
from quantum_basis_tpu_torch.ops.sparse import (
    EllMatrix,
    _ell_spmv_plain,
    ell_spmv,
)

TOL = 1e-12

# name: (JAX model function, conserved names and values, momentum or None)
MATRICES = {
    "chain12_Sz0": (lambda jz: jz.heisenberg_chain(12), ["Sz"], [0.0], None),
    "honeycomb_3x2_N4": (lambda jz: jz.spinless_fermion_honeycomb(3, 2),
                         ["N"], [4.0], None),
    "chain12_k1": (lambda jz: jz.heisenberg_chain(12), ["Sz"], [0.0], [1]),
}


@functools.lru_cache(maxsize=None)
def jax_ell(name):
    """The JAX package's EllMatrix of ``name``'s sector."""
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import build_sparse_full

    build, names, vals, k = MATRICES[name]
    m, ops = build(jz)
    if k is None:
        m.enumerate_basis_full([ops[c] for c in names], vals)
        return build_sparse_full(m.sec_full[0].matvec)
    m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
    return m.generate_Ham_sparse_repr(check=False)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= TOL * scale


@pytest.mark.parametrize("name,vec", [
    ("chain12_Sz0", "real"), ("chain12_Sz0", "complex"),
    ("honeycomb_3x2_N4", "real"), ("honeycomb_3x2_N4", "complex"),
    ("chain12_k1", "complex")])
def test_ell_spmv_matches_jax(name, vec):
    """The wrapper on the carried JAX arrays, alone and through
    ``EllMatrix``, equals ``EllMatrix.apply``; y's type follows the
    instance."""
    ej = jax_ell(name)
    assert ej.is_complex == (MATRICES[name][3] is not None)
    ell = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
    rng = np.random.default_rng(7)
    xr = rng.standard_normal(ej.n)
    xi = rng.standard_normal(ej.n) if vec == "complex" else None
    yr, yi = ej.apply(ej.params, (xr, xi))
    want = np.asarray(yr) + (0 if yi is None else 1j * np.asarray(yi))
    x = torch.as_tensor(xr if xi is None else xr + 1j * xi)
    before = sparse.launch_count
    got = ell_spmv(ell.cols, ell.vals, ell.diag, x)
    assert got.dtype == (torch.float64 if yi is None else torch.complex128)
    _close(got.numpy(), want)
    n0 = ell.n_applies
    _close(ell(x).numpy(), want)
    assert ell.n_applies == n0 + 1
    assert sparse.launch_count == before  # the plain version counts nothing


def test_ell_spmv_diagonal_only_and_empty():
    """W = 0 applies the diagonal, to a real or a complex x; n = 0 gives an
    empty y of x's type."""
    n = 50
    rng = np.random.default_rng(3)
    diag = torch.as_tensor(rng.standard_normal(n))
    cols = torch.zeros((n, 0), dtype=torch.int64)
    for vals in (torch.zeros((n, 0), dtype=torch.float64),
                 torch.zeros((n, 0), dtype=torch.complex128)):
        for x in (torch.as_tensor(rng.standard_normal(n)),
                  torch.as_tensor(tz.rand_vec(n, True, 4))):
            y = ell_spmv(cols, vals, diag, x)
            assert y.shape == (n,)
            assert y.dtype == (torch.complex128 if vals.is_complex()
                               or x.is_complex() else torch.float64)
            torch.testing.assert_close(y, (diag * x).to(y.dtype), rtol=0,
                                       atol=0)
    e = ell_spmv(torch.zeros((0, 0), dtype=torch.int64),
                 torch.zeros((0, 0), dtype=torch.complex128),
                 torch.zeros(0, dtype=torch.float64),
                 torch.zeros(0, dtype=torch.float64))
    assert e.shape == (0,) and e.dtype == torch.complex128


def test_ell_spmv_padded_row_and_two_pointers():
    """A row of padding slots (column 0, value 0) gives diag x there; with
    ``xs`` apart from ``xd`` (columns past n into the second pointer's
    tail) the wrapper equals the numpy sum, and a real x takes the complex
    values' type."""
    n, W, m = 37, 5, 61
    rng = np.random.default_rng(9)
    cols = rng.integers(0, m, size=(n, W))
    vals = rng.standard_normal((n, W)) + 1j * rng.standard_normal((n, W))
    cols[4], vals[4] = 0, 0
    diag = rng.standard_normal(n)
    xd, xs = rng.standard_normal(n), rng.standard_normal(m)
    want = diag * xd + (vals * xs[cols]).sum(axis=1)
    y = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals),
                 torch.as_tensor(diag), torch.as_tensor(xd),
                 torch.as_tensor(xs))
    assert y.dtype == torch.complex128
    _close(y.numpy(), want)
    assert y[4] == diag[4] * xd[4]
    # the real instance, the same columns
    want = diag * xd + (vals.real * xs[cols]).sum(axis=1)
    y = ell_spmv(torch.as_tensor(cols), torch.as_tensor(vals.real.copy()),
                 torch.as_tensor(diag), torch.as_tensor(xd),
                 torch.as_tensor(xs))
    assert y.dtype == torch.float64
    _close(y.numpy(), want)


def test_momentum_solve_through_wrapper_matches_jax(monkeypatch):
    """chain-16 Sz=0 k=1 (dim 810, above the dense cutoff) on the explicit
    route (P_k H switched off): every Lanczos apply is one ``ell_spmv``
    call, and E0 equals the JAX package's, on its own ELL, to 1e-10."""
    import models_zoo as jz

    calls = []

    def spy(*args):
        calls.append(len(args))
        return ell_spmv(*args)
    monkeypatch.setattr(sparse, "ell_spmv", spy)
    mt, ot = tz.heisenberg_chain(16)
    mt.enumerate_basis_repr([1], [ot["Sz"]], [0.0])
    with config.pinned(fullspace_repr_max_blowup=0.0):
        mt.locate_E0_lanczos(which="repr")
    s = mt.sec_repr[0]
    assert s.dim > 600 and isinstance(s.spmv, EllMatrix)
    assert s.spmv.n_applies > 0 and len(calls) == s.spmv.n_applies
    mj, oj = jz.heisenberg_chain(16)
    mj.enumerate_basis_repr([1], [oj["Sz"]], [0.0])
    mj._fullspace_repr_op = lambda *a, **kw: None  # its ELL route too
    mj.locate_E0_lanczos(which="repr")
    assert abs(mt.eigenvals_repr[0] - mj.eigenvals_repr[0]) < 1e-10


def _random_ell(n, W, vals_complex, pad_rows, seed, m=None, dev="cuda"):
    """A seeded (n, W) ELL over a vector of m (n by default) entries, rows
    ``pad_rows`` all padding and the tail of every third row padded."""
    rng = np.random.default_rng(seed)
    m = n if m is None else m
    cols = rng.integers(0, m, size=(n, W))
    vals = rng.standard_normal((n, W))
    if vals_complex:
        vals = vals + 1j * rng.standard_normal((n, W))
    cols[::3, W // 2:], vals[::3, W // 2:] = 0, 0
    cols[pad_rows], vals[pad_rows] = 0, 0
    return (torch.as_tensor(cols, device=dev),
            torch.as_tensor(vals, device=dev),
            torch.as_tensor(rng.standard_normal(n), device=dev))


@pytest.mark.cuda
def test_ell_spmv_kernel_matches_plain_on_cuda():
    """The kernel on the card against ``_ell_spmv_plain`` on the same CUDA
    tensors, to 1e-12 of max|y|, in all three instances, at widths from 0
    to 70 (every group size, rows wider than a warp), with rows of padding,
    row counts off the block's, and the two-pointer form; one launch a
    call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    for W in (0, 1, 2, 3, 5, 8, 13, 20, 24, 32, 33, 70):
        for n in (1, 37, 5003):
            for vc, xc in ((False, False), (False, True), (True, True)):
                for m in (None, n + 29):
                    cols, vals, diag = _random_ell(n, W, vc, [0, n // 2],
                                                   seed=W * 7 + n, m=m)
                    xs = torch.as_tensor(tz.rand_vec(m or n, xc, W + 1),
                                         device=dev)
                    xd = xs if m is None else torch.as_tensor(
                        tz.rand_vec(n, xc, W + 2), device=dev)
                    before = sparse.launch_count
                    y = ell_spmv(cols, vals, diag, xd, xs)
                    cdt = torch.complex128 if vc or xc else torch.float64
                    want = _ell_spmv_plain(cols, vals, diag, xd.to(cdt),
                                           xs.to(cdt))
                    torch.cuda.synchronize()
                    assert sparse.launch_count == before + 1
                    assert y.dtype == want.dtype == cdt
                    scale = max(float(want.abs().max()), 1e-300)
                    assert float((y - want).abs().max()) <= TOL * scale, \
                        (W, n, vc, xc, m)


@pytest.mark.cuda
def test_ell_matrix_and_engines_launch_on_cuda():
    """``EllMatrix`` (a built chain ELL) and ``MatvecVrnl`` (the Holstein
    chain at depth 8, k = 1/4) take the kernel on CUDA tensors: one launch
    an apply, y equal to the plain version's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    m, ops = tz.heisenberg_chain(14, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    ell = m.generate_Ham_sparse_full(check=False)
    m2, ops2 = tz.holstein_chain(16, 3, device=dev)
    seed = int(m2.space.strides[m2.space.slot(8, 0)])
    m2.build_basis_vrnl([seed], 0, [0.0], [0.0], 8, [ops2["N_e"]], [1.0])
    m2.generate_Ham_sparse_vrnl(0)
    vr = MatvecVrnl(m2.sec_vrnl[0].vmat, [0.25])
    for mat in (ell, vr):
        x = torch.as_tensor(tz.rand_vec(mat.n, True, 5), device=dev)
        before = sparse.launch_count
        y = mat(x)
        want = _ell_spmv_plain(mat.cols, mat.vals, mat.diag, x, x)
        torch.cuda.synchronize()
        assert sparse.launch_count == before + 1
        assert float((y - want).abs().max()) <= TOL * float(
            want.abs().max())


@pytest.mark.cuda
def test_ell_spmv_build_failure_raises_on_cuda(monkeypatch):
    """Where the kernel cannot be built, a CUDA call raises: no fallback to
    the plain version, no launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")

    def fail(*a, **kw):
        raise RuntimeError("nvcc failed on ell_spmv.cu (test)")
    monkeypatch.setattr(sparse, "_lib", None)
    monkeypatch.setattr(cuda_build, "load", fail)
    cols, vals, diag = _random_ell(100, 6, False, [], seed=1)
    x = torch.ones(100, dtype=torch.float64, device="cuda")
    before = sparse.launch_count
    with pytest.raises(RuntimeError, match="nvcc failed"):
        ell_spmv(cols, vals, diag, x)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        EllMatrix(cols, vals, diag)(x)
    assert sparse.launch_count == before


def test_ell_spmv_argument_checks():
    """The checks the wrapper makes before a launch (device, type, shape,
    contiguity) pass the main path's arrays and reject the others; they
    read no card, so they run here on CPU tensors."""
    from quantum_basis_tpu_torch.ops.sparse import _check_cuda_args

    n, W = 12, 4
    cols = torch.zeros((n, W), dtype=torch.int64)
    vals = torch.zeros((n, W), dtype=torch.complex128)
    diag = torch.zeros(n, dtype=torch.float64)
    x = torch.zeros(n, dtype=torch.complex128)
    _check_cuda_args(cols, vals, diag, x, x)
    _check_cuda_args(cols, vals.real.contiguous(), diag, x.real.contiguous(),
                     torch.zeros(n + 5, dtype=torch.float64))
    bad = [(cols.to(torch.int32), vals, diag, x, x),
           (cols, vals.to(torch.complex64), diag, x, x),
           (cols, vals.t().contiguous().t(), diag, x, x),
           (cols[:, :2], vals, diag, x, x),
           (cols, vals, diag.to(torch.float32), x, x),
           (cols, vals, diag, x[:-1], x),
           (cols, vals, diag, x, x.real.contiguous()),
           (cols, vals, diag, x, x[:0]),
           (cols, vals[0], diag, x, x)]
    for args in bad:
        with pytest.raises(ValueError):
            _check_cuda_args(*args)
