"""Port BSR layout and SpMV against the JAX package's Pallas BSR.

The JAX package's ELL matrices are carried into the port (interop) so both
packages block the same matrix: the port's layout (bi, bj, blocks) must be
bit-equal to ``ell_to_bsr``'s, and its apply (the plain PyTorch version on
CPU tensors) must agree with the Pallas kernel run in interpret mode:
1e-11 in float64, 5e-5 relative in float32. The CUDA kernel itself is held
against the plain version by the ``cuda``-marked test, which needs a card.

The JAX package is imported inside the tests that use it, so this file also
imports on the GPU machine, which has no JAX: there the card test runs with
``python -m pytest --noconftest tests/test_torch_bsr.py -m cuda``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from quantum_basis_tpu_torch.interop import (
    bsr_from_numpy,
    ell_from_numpy,
    vec_from_split,
    vec_to_split,
)
from quantum_basis_tpu_torch.ops.bsr import (
    _bsr_matvec_plain,
    bsr_fill_stats,
    bsr_spmv,
    ell_to_bsr,
)
from quantum_basis_tpu_torch.ops.sparse import EllMatrix


def _jax_ell(name):
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import build_sparse_repr as jax_build

    if name == "chain10_full":
        m, c = jz.heisenberg_chain(10)
        m.enumerate_basis_full([c["Sz"]], [0.0])
        return m.generate_Ham_sparse_full(0)
    if name == "honeycomb_3x2_full":
        m, c = jz.spinless_fermion_honeycomb(3, 2)
        m.enumerate_basis_full([c["N"]], [4.0])
        return m.generate_Ham_sparse_full(0)
    L, k = {"chain12_k1": (12, 1), "chain16_k0": (16, 0)}[name]
    m, c = jz.heisenberg_chain(L)
    m.enumerate_basis_repr([k], [c["Sz"]], [0.0])
    return jax_build(m.sec_repr[0].matvec)


def _port_ell(ej):
    return ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")


ELLS = ["chain10_full", "honeycomb_3x2_full", "chain12_k1", "chain16_k0"]
DTYPES = {"float64": (np.float64, torch.float64),
          "float32": (np.float32, torch.float32)}


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("name", ELLS)
def test_layout_bit_equal_and_apply(name, dt):
    from quantum_basis_tpu.ops.pallas_bsr import (
        bsr_fill_stats as jax_fill_stats,
        ell_to_bsr as jax_ell_to_bsr,
    )

    np_dt, t_dt = DTYPES[dt]
    ej = _jax_ell(name)
    jb = jax_ell_to_bsr(ej, interpret=True, dtype=np_dt)
    tb = ell_to_bsr(_port_ell(ej), dtype=t_dt)
    assert tb.nb == jb.nb and tb.dtype == t_dt
    np.testing.assert_array_equal(tb.bi.numpy(), np.asarray(jb._bi))
    np.testing.assert_array_equal(tb.bj.numpy(), np.asarray(jb._bj))
    np.testing.assert_array_equal(tb.blocks_re.numpy(),
                                  np.asarray(jb.blocks_re))
    assert tb.is_complex == jb.is_complex
    if jb.is_complex:
        np.testing.assert_array_equal(tb.blocks_im.numpy(),
                                      np.asarray(jb.blocks_im))
    # row_ptr brackets each row tile's blocks
    rp = tb.row_ptr.numpy()
    assert rp[0] == 0 and rp[-1] == tb.nb
    np.testing.assert_array_equal(np.diff(rp),
                                  np.bincount(tb.bi.numpy(),
                                              minlength=tb.n_pad // 128))
    assert bsr_fill_stats(_port_ell(ej)) == jax_fill_stats(ej)

    rng = np.random.default_rng(3)
    re, im = rng.standard_normal(ej.n), rng.standard_normal(ej.n)
    yr, yi = jb((np.asarray(re, np_dt), np.asarray(im, np_dt)))
    yr, yi = np.asarray(yr, np.float64), np.asarray(yi, np.float64)
    carried = bsr_from_numpy(jb.blocks_re, jb.blocks_im, jb._bi, jb._bj,
                             np.asarray(jb.diag)[:jb.n], device="cpu")
    tol = 1e-11 if dt == "float64" else 5e-5 * max(np.abs(yr).max(),
                                                   np.abs(yi).max())
    for bsr in (tb, carried):
        tr, ti = vec_to_split(bsr(vec_from_split(re, im, device="cpu")))
        np.testing.assert_allclose(tr, yr, rtol=0, atol=tol)
        np.testing.assert_allclose(ti, yi, rtol=0, atol=tol)
    if not jb.is_complex:
        yr = np.asarray(jb((np.asarray(re, np_dt), None))[0], np.float64)
        tr, ti = vec_to_split(tb(torch.as_tensor(re)))
        assert ti is None
        np.testing.assert_allclose(tr, yr, rtol=0, atol=tol)


def test_covers_row_tiles_without_blocks():
    """Every row tile gets a stored block, so the kernel writes every
    output tile (the uninitialized-tile fault the interpreter hid)."""
    n = 520  # 5 row tiles, the last partial
    cols = torch.zeros((n, 1), dtype=torch.int64)
    vals = torch.zeros((n, 1), dtype=torch.float64)
    cols[3, 0], vals[3, 0] = 7, 2.5
    ell = EllMatrix(cols, vals, torch.arange(n, dtype=torch.float64))
    bsr = ell_to_bsr(ell)
    assert set(bsr.bi.tolist()) == set(range(-(-n // 128)))
    assert bsr.row_ptr.tolist() == [0, 1, 2, 3, 4, 5]
    assert bsr_fill_stats(ell)["n_blocks"] == bsr.nb == 5
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    torch.testing.assert_close(bsr(x), ell(x), rtol=0, atol=1e-11)


def test_diagonal_only_matrix():
    n = 300
    ell = EllMatrix(torch.zeros((n, 0), dtype=torch.int64),
                    torch.zeros((n, 0), dtype=torch.float64),
                    torch.linspace(-1.0, 1.0, n, dtype=torch.float64))
    bsr = ell_to_bsr(ell)
    assert bsr.nb == -(-n // 128)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(n))
    torch.testing.assert_close(bsr(x), ell(x), rtol=0, atol=1e-11)


def test_unsupported_device_raises():
    x2d = torch.zeros((128, 1), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        bsr_spmv(None, None, None, None, None, x2d)


@pytest.mark.cuda
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_kernel_matches_plain_on_cuda(dt):
    """The CUDA kernel against its plain version on the card: a real and a
    complex momentum-sector matrix, complex and real vectors; tolerance
    1e-12 (f64) or 1e-5 (f32) times max|y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    import torch_zoo as tz
    from quantum_basis_tpu_torch.ops import bsr as bsr_mod
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    t_dt = DTYPES[dt][1]
    tol = 1e-12 if dt == "float64" else 1e-5
    rng = np.random.default_rng(6)
    cases = [(tz.heisenberg_chain(12, device="cuda"), [0], ["Sz"], [0.0]),
             (tz.kagome_tj(1, 2, device="cuda"), [0, 1], ["N", "Sz"],
              [4.0, 0.0])]
    for (m, ops), k, names, vals in cases:
        m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
        ell = build_sparse_repr(m.sec_repr[0].matvec)
        bsr = ell_to_bsr(ell, dtype=t_dt)
        for C in ([2] if bsr.is_complex else [1, 2]):
            x2d = torch.as_tensor(rng.standard_normal((bsr.n_pad, C)),
                                  dtype=t_dt, device="cuda")
            before = bsr_mod.launch_count
            yk = bsr_spmv(bsr.blocks_re, bsr.blocks_im, bsr.bi, bsr.bj,
                          bsr.row_ptr, x2d)
            assert bsr_mod.launch_count == before + 1
            yp = _bsr_matvec_plain(bsr.blocks_re, bsr.blocks_im, bsr.bi,
                                   bsr.bj, x2d)
            torch.cuda.synchronize()
            assert float((yk - yp).abs().max()) <= tol * float(yp.abs().max())
