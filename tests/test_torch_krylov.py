"""ops/krylov.py (K6) and solvers/restarted.py::_Krylov against the JAX
package's _DeviceOps.

The basis operations of the thick-restart solver (a CGS2 step, a fused
expansion of several, a restart vector, the compaction) run in both packages
on one ELL matrix, the JAX package's, carried into the port with
``interop.ell_from_numpy`` (a real full sector and a complex momentum
sector of the Heisenberg chain L = 12), from one start basis made with
numpy; the JAX split-complex pairs are joined for the comparison. Float64 to
1e-12 and float32 to 1e-5 of the largest entry compared. Then the same
sequence on a gloo group of two ranks (tests/torch_mp_worker.py, suite
"krylov") against one device, 1e-12; and, on the card only, each kernel of
csrc/krylov.cu against its plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch.interop import ell_from_numpy
from quantum_basis_tpu_torch.ops import krylov
from quantum_basis_tpu_torch.solvers.restarted import _Krylov, eigs_smallest

NCV = 8
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


def _close(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"max error {err:.3e} over {tol * scale:.3e}"


class _TorchEll32:
    """The port's ELL applied in float32, its values cast once."""

    dtype = torch.float32
    device = torch.device("cpu")

    def __init__(self, ell):
        self.is_complex = ell.is_complex
        self.cols = ell.cols
        self.vals = ell.vals.to(torch.complex64 if ell.is_complex
                                else torch.float32)
        self.diag = ell.diag.float()

    def __call__(self, x):
        return self.diag * x + (self.vals * x[self.cols]).sum(dim=1)


class _IdentityTimes2:
    """2 x I, whose Krylov space closes after one step (a breakdown)."""

    dtype = torch.float64
    device = torch.device("cpu")
    is_complex = False

    def __call__(self, x):
        return 2.0 * x


def _jax_ops(op, n, complex_vec, f32=False):
    """The JAX package's _DeviceOps on ``op`` (a JAX EllMatrix, or None for
    2 x I), in float32 where asked."""
    import jax.numpy as jnp

    from quantum_basis_tpu.solvers.restarted import _DeviceOps

    class Op:
        dtype = np.float32 if f32 else np.float64
        is_complex = complex_vec

        def __init__(self):
            if op is None:
                self.params = ()
            else:
                cols, vre, vim, diag = op.params
                dt = self.dtype
                self.params = (cols, vre.astype(dt),
                               None if vim is None else vim.astype(dt),
                               diag.astype(dt))

        def apply(self, params, x):
            if op is None:
                return (2.0 * x[0], None if x[1] is None else 2.0 * x[1])
            return op.apply(params, x)

    m = Op()
    return _DeviceOps(m, n, NCV, complex_vec), m.params, jnp


@pytest.fixture(scope="module")
def ells():
    """name -> (JAX EllMatrix, port EllMatrix, complex)."""
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import build_sparse_full
    from quantum_basis_tpu.ops.sparse import build_sparse_repr

    m, c = jz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    out = {}
    ej = build_sparse_full(m.sec_full[0].matvec)
    out["real"] = ej, ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag,
                                     device="cpu"), False
    m.enumerate_basis_repr([2], [c["Sz"]], [0.0])
    ej = build_sparse_repr(m.sec_repr[0].matvec)
    out["complex"] = ej, ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag,
                                        device="cpu"), True
    return out


def _start_basis(n, rows, m0, complex_vec, seed=5):
    """Rows 0..m0 orthonormal (numpy QR of a seeded random block), the rest
    zero."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, m0 + 1))
    if complex_vec:
        a = a + 1j * rng.standard_normal((n, m0 + 1))
    q, _ = np.linalg.qr(a)
    V = np.zeros((rows, n), dtype=q.dtype)
    V[: m0 + 1] = q.T
    return V


def _pair(V, complex_vec, dt, jnp):
    re = jnp.asarray(V.real, dt)
    im = jnp.asarray(V.imag, dt) if complex_vec else jnp.zeros((1, 1), dt)
    return re, im


def _joined(re, im, complex_vec):
    re = np.asarray(re, dtype=np.float64)
    return re + 1j * np.asarray(im, dtype=np.float64) if complex_vec else re


def _port(op, n, complex_vec, V):
    kry = _Krylov(op, n, NCV, complex_vec)
    kry.V.copy_(torch.as_tensor(V).to(kry.dtype))
    return kry


def _ops_pair(ells, kind, dt):
    ej, et, cv = ells[kind]
    f32 = dt == torch.float32
    ops, params, jnp = _jax_ops(ej, ej.n, cv, f32)
    return ej.n, (_TorchEll32(et) if f32 else et), cv, ops, params, jnp


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_expand_matches_device_ops(ells, kind, dt):
    """expand(0, ncv) (steps j = 0 .. ncv-1) against _DeviceOps.expand: the
    projection columns, the betas and every row of the basis."""
    n, op, cv, ops, params, jnp = _ops_pair(ells, kind, dt)
    V = _start_basis(n, NCV + 1, 0, cv)
    jdt = jnp.float32 if dt == torch.float32 else jnp.float64
    Vre, Vim, Hr, Hi, b = ops.expand(*_pair(V, cv, jdt, jnp), np.int32(0),
                                     params)
    kry = _port(op, n, cv, V)
    H, bt = kry.expand(0, NCV)
    tol = TOL[dt]
    Hj = _joined(Hr, Hi, cv)
    for j in range(NCV):
        _close(H[: j + 1, j], Hj[: j + 1, j], tol)
    _close(bt[:NCV], np.asarray(b, dtype=np.float64)[:NCV], tol)
    _close(kry.V.numpy(), _joined(Vre, Vim, cv), tol)


@pytest.mark.parametrize("j", [0, NCV // 2, NCV - 1])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_step_matches_device_ops(ells, kind, j):
    """One step from row j (expand(j, j + 1)) against _DeviceOps.step on a
    basis whose rows 0..j are orthonormal: h, beta, row j + 1."""
    n, op, cv, ops, params, jnp = _ops_pair(ells, kind, torch.float64)
    V = _start_basis(n, NCV + 1, j, cv, seed=11 + j)
    Vre, Vim, hr, hi, b = ops.step(*_pair(V, cv, jnp.float64, jnp),
                                   np.int32(j), params)
    kry = _port(op, n, cv, V)
    H, bt = kry.expand(j, j + 1)
    _close(H[: j + 1, j], _joined(hr, hi, cv)[: j + 1], 1e-12)
    _close(bt[j], float(b), 1e-12)
    _close(kry.V.numpy(), _joined(Vre, Vim, cv), 1e-12)


def test_breakdown_zeroes_the_next_row():
    """On 2 x I the first step breaks down (beta <= 1e-13): both packages
    zero rows 1.. and report the same tiny betas; then a restart vector
    (insert_random) is orthogonalized and normalized alike."""
    n = 64
    ops, params, jnp = _jax_ops(None, n, False)
    V = _start_basis(n, NCV + 1, 0, False)
    Vre, _, _, _, b = ops.expand(*_pair(V, False, jnp.float64, jnp),
                                 np.int32(0), params)
    kry = _port(_IdentityTimes2(), n, False, V)
    H, bt = kry.expand(0, 3)
    assert 0.0 <= bt[0] <= 1e-13 and float(b[0]) <= 1e-13
    assert not kry.V[1:].any() and not np.asarray(Vre)[1:].any()
    np.testing.assert_allclose(H[0, 0], 2.0, rtol=0, atol=1e-14)
    r = np.random.default_rng(3).standard_normal(n)
    Vj, _, bj = ops.insert_random(*_pair(np.asarray(Vre), False, jnp.float64,
                                         jnp), jnp.asarray(r),
                                  jnp.zeros(n), np.int32(0), np.int32(1))
    bp = kry.insert_random(torch.as_tensor(r), 0, 1)
    _close(bp, float(bj), 1e-12)
    _close(kry.V.numpy(), np.asarray(Vj), 1e-12)


@pytest.mark.parametrize("dt", [torch.float64, torch.float32])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_insert_random_and_compact_match_device_ops(ells, kind, dt):
    """insert_random after row 4 of a full basis, then the compaction by an
    orthonormal (ncv + 1, 3) S whose last row is zero, against
    _DeviceOps.insert_random and .compact: the norm, the rows kept
    (S^T V), the old row m and the zero rows after it."""
    n, op, cv, ops, params, jnp = _ops_pair(ells, kind, dt)
    jdt = jnp.float32 if dt == torch.float32 else jnp.float64
    V = _start_basis(n, NCV + 1, NCV, cv, seed=17)
    rng = np.random.default_rng(19)
    r = rng.standard_normal(n) + (1j * rng.standard_normal(n) if cv else 0)
    Vre, Vim, bj = ops.insert_random(
        *_pair(V, cv, jdt, jnp), jnp.asarray(r.real, jdt),
        jnp.asarray(r.imag, jdt) if cv else jnp.zeros(n, jdt),
        np.int32(4), np.int32(5))
    kry = _port(op, n, cv, V)
    bp = kry.insert_random(torch.as_tensor(r).to(kry.dtype), 4, 5)
    _close(bp, float(bj), TOL[dt])
    _close(kry.V.numpy(), _joined(Vre, Vim, cv), TOL[dt])

    S = _start_basis(NCV, 3, 2, cv, seed=23).T     # (ncv, 3) orthonormal
    Spad = np.zeros((NCV + 1, 3), dtype=S.dtype)
    Spad[:NCV] = S
    Cre, Cim = ops.compact(Vre, Vim, jnp.asarray(Spad.real, jdt),
                           jnp.asarray(Spad.imag, jdt), np.int32(NCV))
    Y = kry.compact(Spad, NCV)
    want = _joined(Cre, Cim, cv)
    _close(kry.V.numpy(), want, TOL[dt])
    _close(Y.numpy(), want[:3], TOL[dt])
    assert not kry.V[4:].any()


def test_compact_refuses_rows_past_m():
    kry = _Krylov(_IdentityTimes2(), 16, 4, False)
    S = np.zeros((5, 2))
    S[4, 0] = 1.0
    with pytest.raises(ValueError):
        kry.compact(S, 4)


@pytest.mark.parametrize("nev", [1, 2])
def test_eigs_smallest_matches_jax(nev):
    """eigs_smallest through _Krylov on two tests/models_zoo.py models
    (chain-12 Sz=0; spinless fermions on the honeycomb 3x2, N = 4)
    against the JAX
    solver on the same ELL: eigenvalues to 1e-10."""
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import build_sparse_full
    from quantum_basis_tpu.solvers.restarted import eigs_smallest as jeigs

    for m, conserve, vals in ((jz.heisenberg_chain(12), ["Sz"], [0.0]),
                              (jz.spinless_fermion_honeycomb(3, 2), ["N"],
                               [4.0])):
        model, c = m
        model.enumerate_basis_full([c[k] for k in conserve], vals)
        ej = build_sparse_full(model.sec_full[0].matvec)
        et = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
        vj, _ = jeigs(ej, ej.n, nev=nev, ncv=12)
        vt, _ = eigs_smallest(et, et.n, nev=nev, ncv=12)
        np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-10)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = tz.WorkerGroup("krylov", 2, tmp_path_factory.mktemp("krylov2"))
    yield g
    g.close()


def test_expand_on_two_ranks(group):
    """The same expand, restart vector and compaction on EllShardedHalo
    over a gloo group of 2 (the partial sums all-reduced between passes)
    against one device: 1e-12; both ranks equal."""
    from torch_mp_worker import krylov_ells, krylov_sequence

    (a0, s0), (a1, s1) = group.results()
    assert s0 == s1
    for name, ell, cv in krylov_ells():
        want = krylov_sequence(ell, ell.n, cv)
        _close(s0[f"{name}_b_insert"], want.pop("b_insert"), 1e-12)
        for key, w in want.items():
            np.testing.assert_array_equal(a0[f"{name}_{key}"],
                                          a1[f"{name}_{key}"])
            _close(a0[f"{name}_{key}"], w, 1e-12)


def test_cpu_runs_the_plain_versions():
    """A CPU basis launches nothing: the launch counts stay where they
    were."""
    before = dict(krylov.launches), krylov.launch_count
    kry = _Krylov(_IdentityTimes2(), 16, 4, False)
    kry.V[0] = 0.25
    kry.expand(0, 2)
    kry.compact(np.eye(5, 2), 4)
    assert (dict(krylov.launches), krylov.launch_count) == before


# --------------------------------------------------------------- the card


def _cuda_basis(dt, rows, n, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    real = torch.empty(0, dtype=dt).real.dtype
    V = torch.randn((rows, n), dtype=real, device="cuda", generator=g)
    if dt.is_complex:
        V = torch.complex(V, torch.randn((rows, n), dtype=real,
                                         device="cuda", generator=g))
    return V / torch.linalg.vector_norm(V, dim=1, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200_003, 200_004])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.complex64, torch.complex128])
def test_kernels_match_plain_on_cuda(dt, n):
    """Each kernel of csrc/krylov.cu against its plain version on the card,
    at r = 1, 8 and ncv + 1 = 19 (past the 16 rows pass B keeps in
    registers), on a basis of n columns (200,003: one entry a load;
    200,004: 16 bytes a load; complex128 moves 16 bytes in both): the
    partial sums' totals, w', w'', the scaled row, h, beta (1e-12 in
    float64 and complex128, 1e-5 in float32 and complex64, of the largest
    entry, or of 1 for the inner products of unit vectors); a compaction
    (keep 3 of m = 18 rows) likewise, the rows past keep + 1 zero."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    tol = 1e-12 if dt in (torch.float64, torch.complex128) else 1e-5
    rows = 20
    V0 = _cuda_basis(dt, rows, n, 1)
    w = _cuda_basis(dt, 1, n, 2)[0]
    ws = krylov.Workspace(rows, n, dt, "cuda")
    wp = krylov.Workspace(rows, n, dt, "cpu")

    def close(a, b, scale=None):
        """max |a - b| <= tol * scale (max|b| unless given: an inner
        product of unit vectors takes 1, the scale of its rounding)."""
        a, b = a.cpu(), b.cpu()
        if scale is None:
            scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= tol * max(scale, 1e-300)

    for r in (1, 8, 19):
        V, Vp = V0.clone(), V0.cpu()
        krylov.krylov_project(V, 0, r, w, ws.h1)
        krylov._project_plain(Vp, 0, r, w.cpu(), wp.h1)
        close(ws.h1[:r].sum(1), wp.h1[:r].sum(1), 1.0)
        krylov.krylov_subtract_project(V, r, ws.h1, w, ws.work, ws.h2)
        krylov._subtract_project_plain(Vp, r, wp.h1, w.cpu(), wp.work, wp.h2)
        close(ws.work, wp.work)
        close(ws.h2[:r].sum(1), wp.h2[:r].sum(1), 1.0)
        krylov.krylov_subtract_norm(V, r, ws.h2, ws.work, V[r], ws.nrm)
        krylov._subtract_norm_plain(Vp, r, wp.h2, wp.work, Vp[r], wp.nrm)
        close(V[r], Vp[r])
        close(ws.nrm.sum(), wp.nrm.sum())
        h = torch.zeros((rows, rows), dtype=dt, device="cuda")
        hp = torch.zeros((rows, rows), dtype=dt)
        krylov.krylov_scale(V[r], ws.nrm, ws.beta, True, (ws.h1, ws.h2),
                            h[:r, r - 1], r)
        krylov._scale_plain(Vp[r], wp.nrm, wp.beta, True, (wp.h1, wp.h2),
                            hp[:r, r - 1], r)
        close(V[r], Vp[r])
        close(h, hp, 1.0)
        close(ws.beta, wp.beta)
    V, Vp = V0.clone(), V0.cpu()
    S = _cuda_basis(dt, 3, 18, 4).T.contiguous()
    krylov.krylov_compact(V, S, 18)
    krylov._compact_plain(Vp, S.cpu(), 18)
    close(V, Vp)
    assert not V[4:].any()
