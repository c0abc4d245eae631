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


@pytest.mark.parametrize("dt", [torch.float32, torch.float64,
                                torch.complex64, torch.complex128])
@pytest.mark.parametrize("bulk", [True, False])
def test_compact_plan_fits_and_covers(dt, bulk):
    """krylov_compact's plan (ops/krylov.py::compact_plan) for every m from
    1 to 2000 and keep 0..m (all of them up to m = 40, then eleven
    spread over 0..m): the ring (COMPACT_STAGES slots of COMPACT_SLOT packs
    with bulk copies, none without) and two buffers of a slot's S entries
    fit in a block's shared memory (SMEM_MAX less the static bytes); G
    threads a column (a power of two
    dividing the block's threads, the rows a slot holds) take at most
    COMPACT_REGS sums each a chunk, a chunk holds every sum up to
    COMPACT_CHUNK and the chunks hold them all; and, for a few widths nv,
    the row tiles the blocks of a grid read cover rows 0..m of every column
    once a chunk."""
    item = torch.empty(0, dtype=dt).element_size()
    pack = 16 if bulk else item
    room = krylov.SMEM_MAX - krylov.SMEM_STATIC
    for m in range(1, 2001):
        keeps = range(m + 1) if m <= 40 else sorted(
            {0, 1, 3, 4, 5, m // 4, m // 3, m // 2, m - 1, m, 2 * m // 3})
        for keep in keeps:
            p = krylov.compact_plan(1000, m, keep, pack, item, bulk)
            assert p.smem == ((krylov.COMPACT_STAGES * krylov.COMPACT_SLOT
                               * pack if bulk else 0)
                              + 2 * krylov.COMPACT_SLOT_ROWS
                              * krylov.COMPACT_CHUNK * item)
            assert p.smem <= room
            assert p.G * p.tw == krylov.COMPACT_SLOT
            assert krylov.THREADS % p.G == 0 and p.G & (p.G - 1) == 0
            assert p.G <= krylov.COMPACT_SLOT_ROWS
            chunk = p.G * krylov.COMPACT_REGS
            assert min(keep, krylov.COMPACT_CHUNK) <= chunk
            assert chunk <= krylov.COMPACT_CHUNK
            assert p.chunks == max(1, -(-keep // chunk))
            assert p.stash == (p.chunks - 1) * chunk * p.tw
    for nv, m, keep, grid in ((1, 1, 1, 1), (257, 3, 2, 2), (1000, 12, 3, 3),
                              (1000, 119, 59, 4), (4097, 5, 5, 7),
                              (3000, 299, 149, 5)):
        p = krylov.compact_plan(nv, m, keep, pack, item, bulk)
        seen = np.zeros((m + 1, nv), dtype=np.int64)
        for b in range(grid):
            for i, c0, cnt in p.loads(b, grid):
                assert 0 < cnt <= p.tw
                seen[i, c0: c0 + cnt] += 1
        assert (seen == p.chunks).all()


def _emulate_compact(V, S, m, grid):
    """krylov_compact's kernel, its index arithmetic in numpy, one entry a
    pack: block b's share in tiles; for each chunk of sums, each thread's
    (j, g) packs j + p tw1 and sums k0 + g R + q (q < R), their S entries
    read from a step's buffer (entry row * C + sum); the chunks before the
    last into the block's stash (each stash entry written at most once a
    tile, read back by the thread that wrote it), the last chunk, the
    stash and the old row m into V once the tile's reads are done; the
    rows past keep zeroed over the share."""
    rows, nv = V.shape
    keep = S.shape[1]
    p = krylov.compact_plan(nv, m, keep, 16, 8)
    W, R = krylov.COMPACT_WIDE, krylov.COMPACT_REGS
    tw1, G = p.tw // W, p.G
    C = G * R
    stash = np.full((grid, max(p.stash, 1)), np.nan)
    tid = np.arange(krylov.THREADS)
    j, g = tid % tw1, tid // tw1
    for b in range(grid):
        b0, b1 = nv * b // grid, nv * (b + 1) // grid
        for c0 in range(b0, b1, p.tw):
            src = V.copy()          # the tile's reads precede its writes
            written = set()
            for k0 in range(0, max(keep, 1), C):
                last = k0 + C >= keep
                for pp in range(W):
                    col = c0 + j + pp * tw1
                    live = col < b1
                    for q in range(R):
                        c = k0 + g * R + q
                        ok = live & (c < keep)
                        cc, co, jj = c[ok], col[ok], j[ok]
                        # row i's entry of sum c - k0 in the buffer of the
                        # step holding row i
                        sb = np.zeros((m, C))
                        ci = np.arange(C)
                        inside = k0 + ci < keep
                        sb[:, inside] = S[:m, k0 + ci[inside]]
                        y = (sb[:, cc - k0] * src[:m, co]).sum(0)
                        if last:
                            V[cc, co] = y
                        else:
                            at = cc * p.tw + jj + pp * tw1
                            assert at.max(initial=0) < p.stash
                            assert not written & set(at.tolist())
                            written |= set(at.tolist())
                            stash[b, at] = y
                    if last:
                        for t in np.flatnonzero(live):
                            cs = (np.arange(0, k0, C)[:, None] + g[t] * R
                                  + np.arange(R)[None, :]).ravel()
                            V[cs, col[t]] = stash[b, cs * p.tw + j[t]
                                                  + pp * tw1]
                        V[keep, col[live & (g == 0)]] = src[
                            m, col[live & (g == 0)]]
        V[keep + 1:, b0:b1] = 0.0
    return V


@pytest.mark.parametrize("nv, m, keep, grid", [
    (2100, 12, 3, 2), (300, 30, 20, 3), (300, 80, 59, 2), (200, 150, 99, 2),
    (130, 200, 150, 1), (90, 9, 0, 2)])
def test_compact_schedule_matches_plain(nv, m, keep, grid):
    """The kernel's schedule (_emulate_compact: tiles, chunks of sums past
    COMPACT_CHUNK, the stash) computes the compaction: equal to the plain
    version to 1e-12, for keep in one chunk (3, 20, 59, with G = 1, 8, 16
    threads a column), two (99) and three (150), and keep 0."""
    rng = np.random.default_rng(nv + m + keep)
    V = rng.standard_normal((m + 1, nv))
    S = rng.standard_normal((m, keep))
    want = torch.from_numpy(V.copy())
    krylov._compact_plain(want, torch.from_numpy(S), m)
    _close(_emulate_compact(V, S, m, grid), want.numpy(), 1e-12)


@pytest.mark.parametrize("nev", [1, 2, 20])
def test_eigs_smallest_matches_jax(nev):
    """eigs_smallest through _Krylov on two tests/models_zoo.py models
    (chain-12 Sz=0; spinless fermions on the honeycomb 3x2, N = 4) at ncv
    12, and, at nev = 20, on chain-10 Sz=0 (dim 252) at ncv 114, whose
    three compactions (keep 40, then 20) move 115 rows, past the 113 that
    the first compaction kernel staged; against the JAX solver on the same
    ELL: eigenvalues to 1e-10."""
    import models_zoo as jz
    from quantum_basis_tpu.ops.sparse import build_sparse_full
    from quantum_basis_tpu.solvers.restarted import eigs_smallest as jeigs

    cases = (((jz.heisenberg_chain(12), ["Sz"], [0.0]),
              (jz.spinless_fermion_honeycomb(3, 2), ["N"], [4.0]))
             if nev < 20 else ((jz.heisenberg_chain(10), ["Sz"], [0.0]),))
    ncv = 12 if nev < 20 else 114
    for m, conserve, vals in cases:
        model, c = m
        model.enumerate_basis_full([c[k] for k in conserve], vals)
        ej = build_sparse_full(model.sec_full[0].matvec)
        et = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
        vj, _ = jeigs(ej, ej.n, nev=nev, ncv=ncv)
        vt, _ = eigs_smallest(et, et.n, nev=nev, ncv=ncv)
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
    at r = 1, 8, 13 and ncv + 1 = 19 (past the 16 rows pass B keeps in
    registers), on a basis of n columns (200,003: one entry a load;
    200,004: 16 bytes a load, krylov_project and the compaction through
    the bulk-copy ring; complex128 moves 16 bytes in both): the partial
    sums' totals, w', w'', the scaled row, h, beta (1e-12 in float64 and
    complex128, 1e-5 in float32 and complex64, of the largest entry, or of
    1 for the inner products of unit vectors); a compaction (keep 3 of m =
    18 rows) likewise, the rows past keep + 1 zero; then compactions past
    the 113 rows the first kernel staged, m + 1 = 120 and 300 with keep 3
    and m // 2 (59: one chunk of sums, 16 threads a column; 149: three
    chunks, two kept in the stash), against the plain version run on the
    card."""
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

    for r in (1, 8, 13, 19):
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
    del V, Vp, V0, ws, wp
    for rows in (120, 300):
        m = rows - 1
        V0 = _cuda_basis(dt, rows, n, 5)
        for keep in (3, m // 2):
            V, Vp = V0.clone(), V0.clone()
            S = _cuda_basis(dt, keep, m, 6 + keep).T.contiguous()
            krylov.krylov_compact(V, S, m)
            krylov._compact_plain(Vp, S, m)
            close(V, Vp)
            assert not V[keep + 1:].any()
            del V, Vp
        del V0
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dt, n, rows, keep, r", [
    (torch.float64, 2_704_156, 13, 3, 13),      # chain-24's basis, ncv 12
    (torch.float64, 2_704_156, 120, 99, 8),     # two chunks of sums
    (torch.float32, 16_777_220, 13, 8, 8)])     # rows past 2^22 packs
def test_ring_kernels_repeat_bit_equal_on_cuda(dt, n, rows, keep, r):
    """The two kernels that stream rows through the bulk-copy ring,
    krylov_compact and krylov_project, forty times each on fresh copies of
    one basis: every result bit-equal to the first, and the first within
    tolerance of the plain version (1e-12 float64, 1e-5 float32). A slot
    refilled before every warp has read it shows up as a rare wrong
    result, which one run per shape would almost never catch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    tol = 1e-12 if dt == torch.float64 else 1e-5
    m = rows - 1
    V0 = _cuda_basis(dt, rows, n, 11)
    S = _cuda_basis(dt, keep, m, 12).T.contiguous()
    Vp = V0.clone()
    krylov._compact_plain(Vp, S, m)
    first = None
    for _ in range(40):
        V = V0.clone()
        krylov.krylov_compact(V, S, m)
        if first is None:
            first = V
            err = float((V - Vp).abs().max())
            assert err <= tol * float(Vp.abs().max())
        else:
            assert torch.equal(V, first)
        del V
    del Vp, first
    w = _cuda_basis(dt, 1, n, 13)[0]
    ws = krylov.Workspace(rows, n, dt, "cuda")
    want = V0[:r].conj() @ w
    first = None
    for _ in range(40):
        ws.h1.zero_()
        krylov.krylov_project(V0, 0, r, w, ws.h1)
        got = ws.h1[:r].clone()
        if first is None:
            first = got
            assert float((got.sum(1) - want).abs().max()) <= tol
        else:
            assert torch.equal(got, first)
