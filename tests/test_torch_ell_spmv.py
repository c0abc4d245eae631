"""The port's ELL apply (``ops/sparse.py::ell_spmv``) against the JAX package.

The JAX package's explicit matrices (``build_sparse_full`` of two full
sectors, ``generate_Ham_sparse_repr`` of a momentum sector), carried across
with ``interop.ell_from_numpy`` (their int32 columns kept), go through both
applies on seeded vectors: the port's wrapper on CPU tensors (its plain
version) against ``quantum_basis_tpu.ops.sparse.EllMatrix.apply`` to 1e-12
of max|y| in each of the three instances (real values and a real x, real
values and a complex x, complex values). The port's own builds of the same
sectors give the JAX package's int32 columns. The row-length rule
(``row_lengths``: 1 + the last slot of nonzero value) on crafted rows, and
on every producer's ELL (both builds, the carried arrays, ``MatvecVrnl``,
the halo engine's rows). ``hermiticity_exact`` on int32 columns past
n * n = 2 ** 31. A diagonal-only matrix, an empty one, a row of padding and
the two-pointer form (``xd`` and ``xs`` apart, as the halo engine calls
it) against the plain expression; a momentum solve through
``Model(device="cpu")`` on the explicit route makes every apply through the
wrapper and gives the JAX package's E0 to 1e-10. The ``cuda``-marked tests
hold the ``csrc/ell_spmv.cu`` kernel against its plain version on the card
(int32 and int64 columns, skewed row lengths, slots past a row's length
that it must not read), reuse one launch record over many x, and check that
a failed build raises (run them on the card with ``pytest --noconftest -p
no:cacheprovider -m cuda tests/test_torch_ell_spmv.py``); the JAX package
is imported inside the CPU tests only, so this file runs on a machine
without JAX.
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
    EllLaunch,
    EllMatrix,
    _ell_spmv_plain,
    ell_spmv,
    hermiticity_exact,
    row_lengths,
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


def _rule(vals):
    """Each row's length by the stated rule, in numpy: 1 + the last slot
    whose value is nonzero, 0 for a row of padding."""
    n, W = vals.shape
    nz = vals != 0
    last = W - np.argmax(nz[:, ::-1], axis=1) if W else np.zeros(n, int)
    return np.where(nz.any(axis=1), last, 0).astype(np.int32)


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
    assert ell.cols.dtype == torch.int32
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(ej.cols))
    np.testing.assert_array_equal(ell.rowlen.numpy(),
                                  _rule(ell.vals.numpy()))
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


def _random_ell(n, W, vals_complex, pad_rows, seed, m=None, dev="cuda",
                cols_dt=torch.int64):
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
    return (torch.as_tensor(cols, device=dev, dtype=cols_dt),
            torch.as_tensor(vals, device=dev),
            torch.as_tensor(rng.standard_normal(n), device=dev))


def _skewed_ell(n, W, vals_complex, seed, dev="cuda", cols_dt=torch.int32):
    """A seeded (n, W) ELL whose rows are mostly short (0 to 2 live
    slots), with one row at W and a few at W // 2 .. W - 1."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3, size=n)
    lens[rng.integers(0, n, size=max(1, n // 50))] = rng.integers(
        W // 2, W, size=max(1, n // 50))
    lens[n // 3] = W
    slot = np.arange(W)
    cols = np.where(slot < lens[:, None], rng.integers(0, n, size=(n, W)), 0)
    vals = rng.standard_normal((n, W)) + 0.5
    if vals_complex:
        vals = vals + 1j * rng.standard_normal((n, W))
    vals = np.where(slot < lens[:, None], vals, 0)
    return (torch.as_tensor(cols, device=dev, dtype=cols_dt),
            torch.as_tensor(vals, device=dev),
            torch.as_tensor(rng.standard_normal(n), device=dev))


def _max_err(y, want):
    return float((y - want).abs().max()), max(float(want.abs().max()),
                                               1e-300)


@pytest.mark.cuda
def test_ell_spmv_kernel_matches_plain_on_cuda():
    """The kernel on the card against ``_ell_spmv_plain`` on the same CUDA
    tensors, to 1e-12 of max|y|, in all three instances and on int32 and
    int64 columns, at widths from 0 to 70 (rows wider than a warp), with
    rows of padding, row counts off the block's, and the two-pointer form;
    then on skewed row lengths (most rows 0-2 slots, one at W), where the
    group size follows the live lengths, not W; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    insts = ((False, False), (False, True), (True, True))
    for cols_dt in (torch.int32, torch.int64):
        for W in (0, 1, 2, 3, 5, 8, 13, 20, 24, 32, 33, 70):
            for n in (1, 37, 5003):
                for vc, xc in insts:
                    for m in (None, n + 29):
                        cols, vals, diag = _random_ell(
                            n, W, vc, [0, n // 2], seed=W * 7 + n, m=m,
                            cols_dt=cols_dt)
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
                        err, scale = _max_err(y, want)
                        assert err <= TOL * scale, (cols_dt, W, n, vc, xc, m)
        for W in (8, 24, 32, 64):
            for vc, xc in insts:
                cols, vals, diag = _skewed_ell(20011, W, vc, seed=W,
                                               cols_dt=cols_dt)
                rec = EllLaunch(cols, vals, diag)
                assert rec.group <= 4 and rec.group < W
                x = torch.as_tensor(tz.rand_vec(20011, xc, W), device=dev)
                y = rec(x)
                want = _ell_spmv_plain(cols, vals, diag, x.to(y.dtype),
                                       x.to(y.dtype))
                err, scale = _max_err(y, want)
                assert err <= TOL * scale, ("skewed", cols_dt, W, vc, xc)


@pytest.mark.cuda
def test_ell_spmv_reads_only_live_slots_on_cuda():
    """Given row lengths shorter than the stored rows, the kernel reads no
    slot at or past a row's length: those slots hold NaN values, and y
    equals the plain version over the rows cut at their lengths (a read
    past the length would make y NaN); int32 and int64 columns, every
    instance, every group size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    dev = "cuda"
    n, W = 9001, 40
    rng = np.random.default_rng(5)
    for cols_dt in (torch.int32, torch.int64):
        for mean in (1, 2, 3, 6, 12, 25, 40):
            lens = np.clip(rng.poisson(mean, size=n), 0, W)
            for vc, xc in ((False, False), (False, True), (True, True)):
                cols, vals, diag = _random_ell(n, W, vc, [], seed=mean,
                                               cols_dt=cols_dt)
                cols[:, W // 2:] = torch.as_tensor(
                    rng.integers(0, n, size=(n, W - W // 2)), device=dev)
                live = torch.as_tensor(np.arange(W) < lens[:, None],
                                       device=dev)
                cut = torch.where(live, vals, 0)
                poisoned = torch.where(live, vals, float("nan"))
                rowlen = torch.as_tensor(lens, dtype=torch.int32, device=dev)
                rec = EllLaunch(cols, poisoned, diag, rowlen)
                x = torch.as_tensor(tz.rand_vec(n, xc, mean), device=dev)
                y = rec(x)
                want = _ell_spmv_plain(cols, cut, diag, x.to(y.dtype),
                                       x.to(y.dtype))
                assert not bool(y.isnan().any()), (cols_dt, mean, vc, xc)
                err, scale = _max_err(y, want)
                assert err <= TOL * scale, (cols_dt, mean, vc, xc)


@pytest.mark.cuda
def test_ell_launch_record_reused_on_cuda():
    """An ``EllMatrix`` builds its launch record at its first CUDA apply
    and reuses it: 30 applies to seeded real and complex x, each equal to
    the plain version, one record, one launch and one apply counted each
    (and a strided x, which the call makes contiguous);
    the record's row lengths follow the rule and its group size half the
    mean live length."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    cols, vals, diag = _random_ell(4099, 24, False, [7], seed=3)
    ell = EllMatrix(cols, vals, diag)
    assert ell.cols.dtype == torch.int32 and ell._launch is None
    before = sparse.launch_count
    rec = None
    for i in range(30):
        x = torch.as_tensor(tz.rand_vec(ell.n, i % 2 == 1, 100 + i),
                            device="cuda")
        y = ell(x)
        rec = rec or ell._launch
        assert ell._launch is rec
        want = _ell_spmv_plain(ell.cols, vals, diag, x, x)
        err, scale = _max_err(y, want)
        assert err <= TOL * scale, i
    assert sparse.launch_count == before + 30 and ell.n_applies == 30
    # a strided x (every other entry of a longer vector) is made contiguous
    x2 = torch.as_tensor(tz.rand_vec(2 * ell.n, True, 99), device="cuda")
    y = ell(x2[::2])
    assert ell._launch is rec
    want = _ell_spmv_plain(ell.cols, vals, diag, x2[::2], x2[::2])
    err, scale = _max_err(y, want)
    assert err <= TOL * scale
    np.testing.assert_array_equal(rec.rowlen.cpu().numpy(),
                                  _rule(vals.cpu().numpy()))
    mean = float(rec.rowlen.double().mean())   # about 20 (24, 24, 12, ...)
    assert rec.group == 16 == min(g for g in sparse.GROUPS if g >= mean / 2)


@pytest.mark.cuda
def test_ell_matrix_and_engines_launch_on_cuda():
    """``EllMatrix`` (a built chain ELL) and ``MatvecVrnl`` (the Holstein
    chain at depth 8, k = 1/4) take the kernel on CUDA tensors: one launch
    an apply, y equal to the plain version's; both hold int32 columns and
    row lengths by the rule."""
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
        assert mat.cols.dtype == torch.int32
        x = torch.as_tensor(tz.rand_vec(mat.n, True, 5), device=dev)
        before = sparse.launch_count
        y = mat(x)
        want = _ell_spmv_plain(mat.cols, mat.vals, mat.diag, x, x)
        torch.cuda.synchronize()
        assert sparse.launch_count == before + 1
        assert float((y - want).abs().max()) <= TOL * float(
            want.abs().max())
        np.testing.assert_array_equal(mat.rowlen.cpu().numpy(),
                                      _rule(mat.vals.cpu().numpy()))


@pytest.mark.cuda
def test_ell_spmv_build_failure_raises_on_cuda(monkeypatch):
    """Where the kernel cannot be built, a CUDA call raises, through the
    functional wrapper and through a matrix's launch record, every time: no
    fallback to the plain version, no launch counted."""
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
    ell = EllMatrix(cols, vals, diag)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc failed"):
            ell(x)
    assert sparse.launch_count == before


def test_ell_spmv_argument_checks():
    """The checks a launch record makes of its matrix (once: device, type,
    shape, contiguity, int32 or int64 columns, int32 row lengths) and of x
    (every call) pass the main path's arrays and reject the others; they
    read no card, so they run here on CPU tensors. A record itself is a
    CUDA device's."""
    from quantum_basis_tpu_torch.ops.sparse import _check_matrix, _check_x

    n, W = 12, 4
    cols = torch.zeros((n, W), dtype=torch.int32)
    vals = torch.zeros((n, W), dtype=torch.complex128)
    diag = torch.zeros(n, dtype=torch.float64)
    rowlen = torch.zeros(n, dtype=torch.int32)
    x = torch.zeros(n, dtype=torch.complex128)
    for c in (cols, cols.long()):
        _check_matrix(c, vals, diag, rowlen)
        _check_matrix(c, vals.real.contiguous(), diag)
    _check_x(x, x, n, W, x.device)
    _check_x(x.real.contiguous(), torch.zeros(n + 5, dtype=torch.float64),
             n, W, x.device)
    bad = [(cols.to(torch.int16), vals, diag, rowlen),
           (cols.float(), vals, diag, rowlen),
           (cols, vals.to(torch.complex64), diag, rowlen),
           (cols, vals.t().contiguous().t(), diag, rowlen),
           (cols[:, :2], vals, diag, rowlen),
           (cols, vals, diag.to(torch.float32), rowlen),
           (cols, vals, diag, rowlen.long()),
           (cols, vals, diag, rowlen[:-1]),
           (cols, vals[0], diag, rowlen)]
    for args in bad:
        with pytest.raises(ValueError):
            _check_matrix(*args)
    for xd, xs in ((x[:-1], x), (x, x.real.contiguous()), (x, x[:0]),
                   (x.to(torch.complex64), x), (x, x[None])):
        with pytest.raises(ValueError):
            _check_x(xd, xs, n, W, x.device)
    with pytest.raises(ValueError, match="CUDA"):
        EllLaunch(cols, vals, diag)


@pytest.mark.parametrize("case", ["trailing_padding", "zero_inside",
                                  "all_padding", "no_slots", "full_rows"])
@pytest.mark.parametrize("cplx", [False, True])
def test_row_lengths_rule(case, cplx):
    """``row_lengths`` on crafted rows: padding after the live part, a zero
    value inside the live part (it counts: the length is one past the last
    nonzero slot), rows of padding alone (0), W = 0, and rows without
    padding (W); int32, as many rows as values, and the same over several
    passes of rows."""
    rng = np.random.default_rng(11)
    n, W = 40, 7
    vals = rng.standard_normal((n, W)) + (1j * rng.standard_normal((n, W))
                                          if cplx else 0)
    if case == "trailing_padding":
        lens = rng.integers(1, W + 1, size=n)
        vals[np.arange(W) >= lens[:, None]] = 0
        want = lens
    elif case == "zero_inside":
        vals[:, W - 2:] = 0
        vals[:, 1] = 0                  # inside the live run
        vals[::2, 2:] = 0               # a row whose one live slot is 0
        want = np.where(np.arange(n) % 2 == 0, 1, W - 2)
    elif case == "all_padding":
        vals[::3] = 0
        want = np.where(np.arange(n) % 3 == 0, 0, W)
    elif case == "no_slots":
        vals = vals[:, :0]
        want = np.zeros(n, dtype=int)
    else:
        want = np.full(n, W)
    got = row_lengths(torch.as_tensor(vals))
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _rule(vals))
    monkey = sparse._ROWLEN_SLOTS
    try:
        sparse._ROWLEN_SLOTS = 3 * max(W, 1) + 1   # passes of 3 rows
        np.testing.assert_array_equal(
            row_lengths(torch.as_tensor(vals)).numpy(), want)
    finally:
        sparse._ROWLEN_SLOTS = monkey


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_builds_give_jax_int32_columns(name):
    """The port's own build of each sector (``build_sparse_full`` through
    ``generate_Ham_sparse_full``, ``build_sparse_repr`` through
    ``generate_Ham_sparse_repr``) on the CPU holds int32 columns equal to
    the JAX package's build, values to 1e-13, and row lengths by the rule
    (equal to each row's entry count: the builds keep no zero)."""
    ej = jax_ell(name)
    builds = {"chain12_Sz0": lambda: tz.heisenberg_chain(12),
              "honeycomb_3x2_N4": lambda: tz.spinless_fermion_honeycomb(3, 2),
              "chain12_k1": lambda: tz.heisenberg_chain(12)}
    _, names, vals, k = MATRICES[name]
    m, ops = builds[name]()
    if k is None:
        m.enumerate_basis_full([ops[c] for c in names], vals)
        ell = m.generate_Ham_sparse_full(check=False)
    else:
        m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
        ell = m.generate_Ham_sparse_repr(check=False)
    assert ell.cols.dtype == torch.int32
    np.testing.assert_array_equal(ell.cols.numpy(), np.asarray(ej.cols))
    want = np.asarray(ej.vre) + (0 if ej.vim is None
                                 else 1j * np.asarray(ej.vim))
    assert np.abs(ell.vals.numpy() - want).max() <= 1e-13
    rowlen = ell.rowlen.numpy()
    np.testing.assert_array_equal(rowlen, _rule(ell.vals.numpy()))
    np.testing.assert_array_equal(rowlen,
                                  (ell.vals.numpy() != 0).sum(axis=1))


def test_vrnl_ell_int32_and_rule():
    """``MatvecVrnl``'s ELL (``_coo_to_ell``; the Holstein chain at depth 8,
    k = 1/4) holds int32 columns and row lengths by the rule, and applies
    as the dense H(k) on the CPU."""
    m, ops = tz.holstein_chain(16, 3)
    seed = int(m.space.strides[m.space.slot(8, 0)])
    m.build_basis_vrnl([seed], 0, [0.0], [0.0], 8, [ops["N_e"]], [1.0])
    m.generate_Ham_sparse_vrnl(0)
    vr = MatvecVrnl(m.sec_vrnl[0].vmat, [0.25])
    assert vr.cols.dtype == torch.int32
    vals = vr.vals.numpy()
    np.testing.assert_array_equal(vr.rowlen.numpy(), _rule(vals))
    H = np.zeros((vr.n, vr.n), dtype=np.complex128)
    np.add.at(H, (np.repeat(np.arange(vr.n), vr.width),
                  vr.cols.numpy().reshape(-1)), vals.reshape(-1))
    H[np.diag_indices(vr.n)] += vr.diag.numpy()
    x = tz.rand_vec(vr.n, True, 8)
    _close(vr(torch.as_tensor(x)).numpy(), H @ x)


class _OneRank:
    """A mesh of one rank on the CPU, enough for ``EllShardedHalo``."""

    size, rank, device = 1, 0, torch.device("cpu")

    def span(self, n):
        return 0, n

    def all_to_all(self, t, send, recv):
        return t

    def all_gather(self, t):
        return t

    def all_reduce(self, t, op="sum"):
        return t


def test_halo_rows_int32():
    """The halo engine's rank rows (one rank, the JAX package's chain-12
    k=1 ELL carried across): int32 columns remapped into ``[x | halo]``,
    row lengths by the rule and equal to the matrix's, no launch record on
    the CPU, and H x equal to ``EllMatrix.apply`` to 1e-12 of max|y|."""
    from quantum_basis_tpu_torch.parallel.halo_sharded import EllShardedHalo

    ej = jax_ell("chain12_k1")
    ell = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
    h = EllShardedHalo(ell, _OneRank())
    assert h._cols.dtype == torch.int32 and h._launch is None
    rl = row_lengths(h._vals).numpy()
    np.testing.assert_array_equal(rl, _rule(h._vals.numpy()))
    np.testing.assert_array_equal(rl[:ell.n], ell.rowlen.numpy())
    assert (rl[ell.n:] == 0).all()
    x = tz.rand_vec(ell.n, True, 6)
    yr, yi = ej.apply(ej.params, (x.real, x.imag))
    got = h.unpad(h(h.pad(torch.as_tensor(x))))
    _close(got.numpy(), np.asarray(yr) + 1j * np.asarray(yi))


@pytest.mark.parametrize("hermitian", [True, False])
def test_hermiticity_exact_int32_past_two_to_31(hermitian):
    """``hermiticity_exact`` on an int32-column ELL of n = 50,000 rows
    (n * n past 2 ** 31): entries at the far corners pair up, and an entry
    whose partner is missing is found at its own (i, j), not at a wrapped
    key."""
    n, W = 50_000, 2
    cols = np.zeros((n, W), dtype=np.int32)
    vals = np.zeros((n, W), dtype=np.complex128)
    pairs = [(0, n - 1, 0.5 + 0.25j), (3, n - 2, -1.0), (n - 4, n - 3, 2j)]
    for i, j, v in pairs:
        cols[i, 0], vals[i, 0] = j, v
        cols[j, 1], vals[j, 1] = i, np.conj(v)
    if not hermitian:
        cols[n - 7, 0], vals[n - 7, 0] = n - 5, 1.5
    ell = EllMatrix(torch.as_tensor(cols), torch.as_tensor(vals),
                    torch.zeros(n, dtype=torch.float64))
    assert ell.cols.dtype == torch.int32 and n * n > 2 ** 31
    if hermitian:
        hermiticity_exact(ell)
    else:
        with pytest.raises(AssertionError,
                           match=f"entry \\({n - 7}, {n - 5}\\) unpaired"):
            hermiticity_exact(ell)


@pytest.mark.parametrize("lens,want", [
    ([], 1), ([0, 0, 0], 1), ([2, 2, 2], 1), ([3, 3], 2), ([4, 5], 4),
    ([12, 13, 12, 13], 8), ([20, 30, 25], 16), ([32, 32], 16),
    ([64, 64, 70], 32), ([0] * 99 + [300], 2)])
def test_group_size_rule(lens, want):
    """The kernel's lanes a row: the power of two at or above half the mean
    row length, 1 for none, at most 32."""
    assert sparse.group_size(torch.tensor(lens, dtype=torch.int32)) == want
