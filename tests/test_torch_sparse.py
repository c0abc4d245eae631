"""Port explicit sparse build (ELL) against the JAX package.

``build_sparse_repr`` must give the same matrix (dense-equal to 1e-12), the
ELL apply the same H.x (1e-12), and the row stage the same layout and
values as the JAX package's numpy ``_compact_rows_np``: the torch
``compact_rows`` (the builds' plain version) and, emulated here step by
step, the warp's rank sort, run heads and ballots of
``csrc/ell_rows.cuh`` and the register stage of ``csrc/ell_build.cu``
(keys, bitonic exchanges, head walk, ballots, two rows a warp), on crafted
image sets. The ``cuda``-marked test holds
the ``repr_images`` kernel against its plain version on the card; the JAX
package is imported inside the CPU tests only, so this file runs on a
machine without JAX.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from quantum_basis_tpu_torch.interop import ell_from_numpy, vec_from_split, vec_to_split
from quantum_basis_tpu_torch.ops.ell_build import assemble, compact_rows
from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

# tests/test_torch_repr.py's SECTORS
SECTORS = ("chain12_k1", "honeycomb_3x2_k10", "kagome_tj_1x2_k01")
TOL = 1e-14
DROP = 2 ** 31 - 1


def build_both(name):
    from test_torch_repr import build_both as both

    return both(name)


def dense(n, cols, vals, diag):
    H = np.zeros((n, n), dtype=np.complex128)
    np.add.at(H, (np.repeat(np.arange(n), cols.shape[1]), cols.reshape(-1)),
              vals.reshape(-1))
    H[np.arange(n), np.arange(n)] += diag
    return H


@pytest.mark.parametrize("name", SECTORS)
def test_build_sparse_repr_matches_jax(name):
    from quantum_basis_tpu.ops.sparse import build_sparse_repr as jax_build

    mj, mt = build_both(name)
    ej = jax_build(mj.sec_repr[0].matvec)
    et = build_sparse_repr(mt.sec_repr[0].matvec)
    n = et.n
    vj = np.asarray(ej.vre) + 1j * np.asarray(ej.vim)
    Hj = dense(n, np.asarray(ej.cols), vj, np.asarray(ej.diag))
    Ht = dense(n, et.cols.numpy(), et.vals.numpy(), et.diag.numpy())
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=1e-12)
    assert et.width == ej.width
    rng = np.random.default_rng(4)
    re, im = rng.standard_normal(n), rng.standard_normal(n)
    yr, yi = ej((np.asarray(re), np.asarray(im)))
    tr, ti = vec_to_split(et(vec_from_split(re, im, device="cpu")))
    np.testing.assert_allclose(tr, np.asarray(yr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ti, np.asarray(yi), rtol=0, atol=1e-12)
    # the same JAX arrays carried over through interop apply identically
    ec = ell_from_numpy(ej.cols, ej.vre, ej.vim, ej.diag, device="cpu")
    cr, ci = vec_to_split(ec(vec_from_split(re, im, device="cpu")))
    np.testing.assert_allclose(cr, np.asarray(yr), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ci, np.asarray(yi), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", SECTORS)
@pytest.mark.parametrize("parts", [3, 5])
def test_build_sparse_repr_blocks_match_jax(name, parts):
    """The momentum ELL built over several row blocks (the last one past
    the sector's end) equals the JAX package's entry for entry: columns
    and W exactly, values to 1e-14, H.x to 1e-12."""
    from quantum_basis_tpu.ops.sparse import build_sparse_repr as jax_build

    mj, mt = build_both(name)
    ej = jax_build(mj.sec_repr[0].matvec)
    mv = mt.sec_repr[0].matvec
    n = mv.n
    block = n // parts + 1
    assert n % block and n > 2 * block
    cols, vals = mv.record("repr_images").images(0, n, block)
    assert cols.shape == (n, ej.width) and vals.dtype == torch.complex128
    np.testing.assert_array_equal(cols.numpy(), np.asarray(ej.cols))
    np.testing.assert_allclose(vals.real.numpy(), np.asarray(ej.vre),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(vals.imag.numpy(), np.asarray(ej.vim),
                               rtol=0, atol=1e-14)
    # the whole sector in one block gives the same rows
    c1, v1 = mv.record("repr_images").images(0, n, n)
    assert torch.equal(c1, cols) and torch.equal(v1, vals)
    x = np.random.default_rng(5).standard_normal(n)
    ell = build_sparse_repr(mv)
    y = ell(torch.as_tensor(x, dtype=torch.complex128))
    yr, yi = ej((x, np.zeros(n)))
    np.testing.assert_allclose(y.real.numpy(), np.asarray(yr), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(y.imag.numpy(), np.asarray(yi), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("complex_vals", [False, True])
def test_compact_rows_matches_numpy(complex_vals):
    from quantum_basis_tpu.ops.sparse import _compact_rows_np

    rng = np.random.default_rng(9)
    n, W = 64, 24
    cols = rng.integers(-1, 12, size=(n, W)).astype(np.int64)
    vre = rng.standard_normal((n, W))
    vre[rng.random((n, W)) < 0.2] = 0.0
    vim = rng.standard_normal((n, W)) if complex_vals else None
    if complex_vals:
        vim[rng.random((n, W)) < 0.2] = 0.0
    # a pair that cancels exactly: dropped after the merge
    cols[0, :2] = 5
    vre[0, :2] = [1.5, -1.5]
    if complex_vals:
        vim[0, :2] = [0.25, -0.25]
    vre[cols < 0] = 0.0
    if complex_vals:
        vim[cols < 0] = 0.0
    cn, rn, inn = _compact_rows_np(cols.copy(), vre.copy(),
                                   None if vim is None else vim.copy())
    vals = vre + 1j * vim if complex_vals else vre
    ct, vt = compact_rows(torch.as_tensor(cols), torch.as_tensor(vals))
    np.testing.assert_array_equal(ct.numpy(), cn)
    np.testing.assert_array_equal(vt.numpy().real, rn)
    if complex_vals:
        np.testing.assert_array_equal(vt.numpy().imag, inn)


def _crafted(case, cplx):
    """(cols (n, E) int64, vals (n, E)) of one crafted image set: -1 and 0
    where an image is dropped, as the builds' image stages give them."""
    rng = np.random.default_rng(31)
    n, E, span = {"runs": (16, 24, 6), "cancel": (4, 8, 4),
                  "at_tol": (4, 6, 3), "all_invalid": (3, 5, 4),
                  "empty": (5, 0, 1), "wide": (9, 80, 30),
                  "e13": (11, 13, 5), "e24": (10, 24, 8),
                  "e48": (9, 48, 14), "e64": (7, 64, 20)}[case]
    cols = rng.integers(0, span, size=(n, E)).astype(np.int64)
    vals = rng.standard_normal((n, E))
    if cplx:
        vals = vals + 1j * rng.standard_normal((n, E))
    off = rng.random((n, E)) < 0.15
    cols[off], vals[off] = -1, 0.0
    def row(i, c, v):
        cols[i], vals[i] = -1, 0.0
        cols[i, :len(c)], vals[i, :len(v)] = c, v
    if case == "cancel":
        # an exact cancellation inside a run, and a run that leaves 5.6e-17
        # (dropped after the merge); a row that is one run
        row(0, [2, 2, 1, 2], [1.5, -1.5, 0.75, 0.0625])
        row(1, [3, 3, 3], [0.1, 0.2, -0.3])
        cols[2] = 1
    if case == "at_tol":
        # at the tolerance: dropped before the merge, never joins a run
        # (two of them merged would pass it); just above it kept
        t = 5e-15 + 5e-15j if cplx else 1e-14
        row(0, [1, 1, 2], [t, 1.0, 1.0000000000000002e-14])
        row(1, [0, 0], [t, t])
    if case == "all_invalid":
        cols[0], vals[0] = -1, 0.0
        cols[1], vals[1] = 2, 1e-15
    if case == "e48":
        # every row but the last keeps at most 32 of its 48 images, some
        # past slot 32: the register stage compacts them into one register
        cols[:-1, 1::3], vals[:-1, 1::3] = -1, 0.0
    return cols, vals


def _warp_rows(cols, vals):
    """The row stage of csrc/ell_rows.cuh as a warp runs it: the images
    above the tolerance packed in slot order (the ballots of ``put``), each
    one's rank among them (lower columns, then its column at lower places)
    places it, a run's head sums the run in order, the heads above the
    tolerance go left in rank order; W the widest row."""
    def mag(v):
        return abs(v.real) + abs(v.imag)
    n, E = cols.shape
    rows = []
    for i in range(n):
        kept = [e for e in range(E) if mag(vals[i, e]) > TOL]
        c = [int(cols[i, e]) for e in kept] + [DROP] * (-len(kept) % 4)
        val = [vals[i, e] for e in kept]
        order = [0] * len(kept)
        for e in range(len(kept)):
            order[sum((c[f] < c[e]) or (c[f] == c[e] and f < e)
                      for f in range(len(c)))] = e
        row = []
        for q, e in enumerate(order):
            if q and c[order[q - 1]] == c[e]:
                continue
            s = val[e]
            for u in range(q + 1, len(order)):
                if c[order[u]] != c[e]:
                    break
                s = s + val[order[u]]
            if mag(s) > TOL:
                row.append((c[e], s))
        rows.append(row)
    W = max((len(r) for r in rows), default=0)
    oc = np.zeros((n, W), np.int64)
    ov = np.zeros((n, W), vals.dtype)
    for i, r in enumerate(rows):
        for k, (c, v) in enumerate(r):
            oc[i, k], ov[i, k] = c, v
    return oc, ov


_NOKEY = (1 << 32) - 1      # a dropped image's 32-bit key: the largest


def _register_rows(cols, vals, compact=True):
    """The register row stage of csrc/ell_build.cu (rows of E <= 64 image
    columns) as a warp runs it, lane by lane: a segment of SEG lanes a row
    (16, two rows a warp, where E <= 16), image e at lane e % SEG of its
    segment, register e // SEG; the 32-bit keys (j << 6 | e, the largest
    where dropped); a row of two registers whose kept keys fit 32 (with
    ``compact``) moved into one in slot order; the bitonic network over
    the segment's places, each lane's exchange directions taken from its
    bits a step, the exchanges by shuffle (width SEG) and the in-lane one
    at distance SEG; each place's value from its slot's lane; the heads,
    the run ends from the heads' ballot, the walk in place order; the
    survivors' ballot and places. The count pass counts a row in one
    register by its columns' matches (``__match_any_sync``: the lowest
    lane of a column heads its run and sums it in lane order), which must
    equal the sorted count; then the write pass into (n, W) with the rows'
    lengths."""
    def mag(v):
        return abs(v.real) + abs(v.imag)
    n, E = cols.shape
    SEG = 16 if E <= 16 else 32
    R = 2 if E > 32 else 1
    L = range(32)
    sl = [lane % SEG for lane in L]
    half = [lane // SEG for lane in L]

    def ballot(pred):                   # pred[lane] -> the 32-bit word
        return sum(1 << lane for lane in L if pred[lane])

    def seg_bits(b, lane):
        return b if SEG == 32 else (b >> (16 * half[lane])) & 0xffff

    def shfl(x, lane, src):             # __shfl_sync(x, src, SEG)
        return x[lane - lane % SEG + src % SEG]

    def popc(x):
        return bin(x).count("1")

    def steps(RS):
        """The network's steps (size, j) over SEG * RS places."""
        size = 2
        while size <= SEG * RS:
            j = size >> 1
            while j:
                yield size, j
                j >>= 1
            size <<= 1

    def directions(RS):                 # directions(): dir[lane][r]
        out = [[0] * RS for _ in L]
        shuffles = [(size, j) for size, j in steps(RS) if j != SEG]
        for lane in L:
            for r in range(RS):
                pos = sl[lane] + SEG * r
                for s, (size, j) in enumerate(shuffles):
                    if ((pos & j) == 0) == ((pos & size) == 0):
                        out[lane][r] |= 1 << s
        return out

    dirs = {RS: directions(RS) for RS in (1, R)}

    def by_slot(v, lane, slot):
        return shfl([vr[slot // SEG if R == 2 else 0] for vr in v], lane,
                    slot)

    def sorted_row(key, v, RS):
        """sorted_row: {row: (count, {place: (column, value)})}."""
        N = SEG * RS
        key = [list(kr) for kr in key]
        s = 0
        for size, j in steps(RS):
            if j == SEG:                # RS == 2: the lane's two registers
                for lane in L:
                    key[lane] = sorted(key[lane])
                continue
            new = [list(kr) for kr in key]
            for lane in L:
                for r in range(RS):
                    o = shfl([kr[r] for kr in key], lane, sl[lane] ^ j)
                    keep_min = (dirs[RS][lane][r] >> s) & 1
                    new[lane][r] = o if (o < key[lane][r]) == keep_min \
                        else key[lane][r]
            key = new
            s += 1
        for lane in range(0, 32, SEG):  # each segment sorted over its places
            flat = [key[lane + q % SEG][q // SEG] for q in range(N)]
            assert flat == sorted(flat)
        sv = [[by_slot(v, lane, key[lane][r] & 63) for r in range(RS)]
              for lane in L]
        prev = [[None] * RS for _ in L]
        for lane in L:
            up = lane - 1 if sl[lane] else lane     # __shfl_up_sync(.., 1)
            prev[lane][0] = key[up][0]
            if RS == 2:
                prev[lane][1] = (shfl([kr[0] for kr in key], lane, SEG - 1)
                                 if sl[lane] == 0 else key[up][1])
        alive = [[key[lane][r] != _NOKEY for r in range(RS)] for lane in L]
        head = [[alive[lane][r] and (sl[lane] + SEG * r == 0 or
                                     prev[lane][r] >> 6 != key[lane][r] >> 6)
                 for r in range(RS)] for lane in L]
        A = [0] * 32
        H = [0] * 32
        for r in range(RS):
            ba = ballot([alive[lane][r] for lane in L])
            bh = ballot([head[lane][r] for lane in L])
            for lane in L:
                A[lane] |= seg_bits(ba, lane) << (SEG * r)
                H[lane] |= seg_bits(bh, lane) << (SEG * r)
        length = [[0] * RS for _ in L]
        for lane in L:
            for r in range(RS):
                pos = sl[lane] + SEG * r
                if head[lane][r]:
                    above = H[lane] >> (pos + 1)
                    nxt = (pos + (above & -above).bit_length() if above
                           else N)
                    length[lane][r] = min(nxt, popc(A[lane])) - pos
        most = max(max(lr) for lr in length)   # __reduce_max_sync
        total = [list(sr) for sr in sv]
        for d in range(1, most):        # the run's next place, in order
            a = [shfl([sr[0] for sr in sv], lane, sl[lane] + d) for lane in L]
            b = ([shfl([sr[1] for sr in sv], lane, sl[lane] + d)
                  for lane in L] if RS == 2 else a)
            for lane in L:
                if d < length[lane][0]:
                    total[lane][0] = total[lane][0] + (
                        a[lane] if sl[lane] + d < SEG else b[lane])
                if RS == 2 and d < length[lane][1]:
                    total[lane][1] = total[lane][1] + b[lane]
        keep = [[head[lane][r] and mag(total[lane][r]) > TOL
                 for r in range(RS)] for lane in L]
        S = [0] * 32
        for r in range(RS):
            bk = ballot([keep[lane][r] for lane in L])
            for lane in L:
                S[lane] |= seg_bits(bk, lane) << (SEG * r)
        out = {}
        for lane in L:
            row = out.setdefault(half[lane], [popc(S[lane]), {}])
            for r in range(RS):
                if keep[lane][r]:
                    at = popc(S[lane] & ((1 << (sl[lane] + SEG * r)) - 1))
                    row[1][at] = (key[lane][r] >> 6, total[lane][r])
        return out

    def match_count(key, v):
        """match_count: each segment's count, from one register of keys
        in slot order."""
        tag = [key[lane][0] >> 6 | half[lane] << 30
               if key[lane][0] != _NOKEY else 1 << 31 | lane for lane in L]
        peers = [ballot([tag[o] == tag[lane] for o in L]) for lane in L]
        head = [key[lane][0] != _NOKEY and
                (peers[lane] & -peers[lane]).bit_length() - 1 == lane
                for lane in L]
        sv = [v[lane][0] if R == 1 else by_slot(v, lane, key[lane][0] & 63)
              for lane in L]
        total = list(sv)
        rest = [peers[lane] & (peers[lane] - 1) if head[lane] else 0
                for lane in L]
        for _ in range(max(popc(x) for x in rest)):
            src = [(rest[lane] & -rest[lane]).bit_length() - 1 if rest[lane]
                   else lane for lane in L]
            o = [shfl(sv, lane, src[lane]) for lane in L]
            for lane in L:
                if rest[lane]:
                    total[lane] = total[lane] + o[lane]
                    rest[lane] &= rest[lane] - 1
        bk = ballot([head[lane] and mag(total[lane]) > TOL for lane in L])
        return {half[lane]: popc(seg_bits(bk, lane)) for lane in L}

    def warp(k0):
        """Rows k0 .. k0 + 32 // SEG - 1: each row's (count, entries)."""
        k = [k0 + half[lane] for lane in L]
        key = [[_NOKEY] * R for _ in L]
        v = [[0.0] * R for _ in L]
        for lane in L:
            for r in range(R):
                e = sl[lane] + SEG * r
                if k[lane] < n and e < E:
                    v[lane][r] = vals[k[lane], e]
                    if mag(v[lane][r]) > TOL:
                        key[lane][r] = int(cols[k[lane], e]) << 6 | e
                        assert key[lane][r] < _NOKEY
        RS = R
        if R == 2 and compact and sum(kk != _NOKEY for kr in key
                                      for kk in kr) <= 32:
            kept = [kk for r in range(2) for kr in key for kk in [kr[r]]
                    if kk != _NOKEY]
            assert kept == sorted(kept, key=lambda kk: kk & 63)
            key = [[kept[lane] if lane < len(kept) else _NOKEY] for lane in L]
            RS = 1
        rows = sorted_row(key, v, RS)
        if RS == 1:                     # the count pass's match
            counts = match_count(key, v)
            assert all(counts[h] == rows[h][0] for h in rows)
        return {k0 + h: row for h, row in rows.items() if k0 + h < n}

    rows = {}
    for k0 in range(0, n, 32 // SEG):
        rows.update(warp(k0))
    W = max((cnt for cnt, _ in rows.values()), default=0)   # the count pass
    oc = np.zeros((n, W), np.int64)
    ov = np.zeros((n, W), vals.dtype)
    rowlen = np.zeros(n, np.int32)
    for i, (cnt, entries) in rows.items():      # the write pass
        assert sorted(entries) == list(range(cnt))
        for at, (c, val) in entries.items():
            oc[i, at], ov[i, at] = c, val
        rowlen[i] = cnt
    return oc, ov, rowlen


@pytest.mark.parametrize("complex_vals", [False, True])
@pytest.mark.parametrize("case", ["runs", "cancel", "at_tol", "all_invalid",
                                  "empty", "e13", "e24", "e48", "e64"])
def test_register_stage_matches_numpy(case, complex_vals):
    """The register row stage of ``csrc/ell_build.cu``, emulated lane by
    lane (``_register_rows``: two rows a warp at E <= 16, one image a lane
    at E <= 32, two at E <= 64, compacted into one where the kept images
    fit or not; the count pass by matches), equals ``_compact_rows_np``
    exactly on the crafted image sets (runs, exact cancellations, entries
    at the tolerance, an all-invalid row, E = 0, and random rows at E =
    13, 24, 48 and 64; odd row counts leave a half-warp empty); each row's
    length is its count, ``row_lengths``' rule."""
    from quantum_basis_tpu.ops.sparse import _compact_rows_np

    from quantum_basis_tpu_torch.ops.sparse import row_lengths

    cols, vals = _crafted(case, complex_vals)
    cn, rn, inn = _compact_rows_np(
        cols.copy(), vals.real.copy(),
        vals.imag.copy() if complex_vals else None)
    want = rn + 1j * inn if complex_vals else rn
    if case == "e48":
        kept = (abs(vals.real) + abs(vals.imag) > TOL).sum(axis=1)
        assert (kept[:-1] <= 32).all() and kept[-1] > 32
    for compact in (True, False):
        cr, vr, rowlen = _register_rows(cols, vals, compact)
        np.testing.assert_array_equal(cr, cn)
        np.testing.assert_array_equal(vr, want)
        np.testing.assert_array_equal(
            rowlen, row_lengths(torch.as_tensor(want)).numpy())


@pytest.mark.parametrize("complex_vals", [False, True])
@pytest.mark.parametrize("case", ["runs", "cancel", "at_tol", "all_invalid",
                                  "empty", "wide"])
def test_row_stage_matches_numpy(case, complex_vals):
    """The builds' row stage on crafted image sets (several duplicate runs,
    exact cancellations, entries at the tolerance, an all-invalid row, E =
    0, E = 80 > 64) equals ``_compact_rows_np`` exactly: the plain version
    (``compact_rows``), the plain version over row blocks of 5 (the last
    one past the rows' end) assembled, and the warp's algorithm."""
    from quantum_basis_tpu.ops.sparse import _compact_rows_np

    cols, vals = _crafted(case, complex_vals)
    cn, rn, inn = _compact_rows_np(
        cols.copy(), vals.real.copy(),
        vals.imag.copy() if complex_vals else None)
    want = rn + 1j * inn if complex_vals else rn
    if case == "cancel":
        assert cn.shape[1] < cols.shape[1]
        assert (cn[1] == 0).all() and cn[0, :2].tolist() == [1, 2]
    if case == "at_tol":
        assert want[0, 0] == 1.0 and cn[0, :2].tolist() == [1, 2]
        assert (cn[1] == 0).all()
    ct, vt = compact_rows(torch.as_tensor(cols), torch.as_tensor(vals))
    np.testing.assert_array_equal(ct.numpy(), cn)
    np.testing.assert_array_equal(vt.numpy(), want)
    cb, vb = assemble([compact_rows(torch.as_tensor(cols[i:i + 5]),
                                    torch.as_tensor(vals[i:i + 5]))
                       for i in range(0, cols.shape[0], 5)],
                      vt.dtype, "cpu")
    np.testing.assert_array_equal(cb.numpy(), cn)
    np.testing.assert_array_equal(vb.numpy(), want)
    cw, vw = _warp_rows(cols, vals)
    np.testing.assert_array_equal(cw, cn)
    np.testing.assert_array_equal(vw, want)


@pytest.mark.cuda
def test_repr_images_kernel_matches_plain_on_cuda(monkeypatch):
    """The ``repr_images`` kernel (a warp a row, the row stage fused) on
    the card against its plain version on the same CUDA tensors: columns
    and W exactly, values to 1e-14 of max|v|, on the entry path and on the
    general path (ENTRY_TABLES_MAX = 0), a chain (bit fields), the spin-1
    chain (mixed radix), kagome t-J and the honeycomb fermions (signs),
    the DM chain (complex amplitudes) and the three-site chain (arity 3);
    a part of the rows; two launches a build, one where every row is
    empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    import torch_zoo as tz
    from quantum_basis_tpu_torch.ops import apply_repr as ar
    from quantum_basis_tpu_torch.ops.apply_repr import _repr_ell_plain

    dev = "cuda"
    cases = [(tz.heisenberg_chain(12, device=dev), ["Sz"], [0.0], [1]),
             (tz.heisenberg_chain(8, spin="1", device=dev), ["Sz"], [0.0],
              [2]),
             (tz.kagome_tj(1, 2, device=dev), ["N", "Sz"], [4.0, 0.0],
              [0, 1]),
             (tz.spinless_fermion_honeycomb(3, 2, device=dev), ["N"], [4.0],
              [1, 0]),
             (tz.three_spin_chain_with(tz.Lattice, tz.Model, tz.Opr, tz.Mopr,
                                       12, device=dev), ["Sz"], [0.0], [3]),
             (tz.dm_chain(10, device=dev), ["Sz"], [0.0], [2])]
    for (m, ops), names, vals, k in cases:
        m.enumerate_basis_repr(k, [ops[c] for c in names], vals)
        mv = m.sec_repr[0].matvec
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, _, phase = mv.args()
        n = mv.n
        for emax in (ar.ENTRY_TABLES_MAX, 0):
            monkeypatch.setattr(ar, "ENTRY_TABLES_MAX", emax)
            img = ar.ReprLaunch("repr_images", rt, tabs, ix, labels, fodd,
                                isn, sqrt_nu, None, phase, n,
                                rrec=mv.basis.row_records())
            assert (img.entry is None) == (emax == 0)
            for row0, rows in ((0, n), (n // 3, n - n // 3 - 1)):
                before = ar.launches["repr_images"]
                c, v = img.images(row0, rows)
                c2, v2 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn,
                                         sqrt_nu, phase, row0, rows)
                torch.cuda.synchronize()
                assert ar.launches["repr_images"] == before + 2
                assert c.shape == c2.shape and torch.equal(c, c2)
                scale = max(float(v2.abs().max()), 1e-300)
                assert float((v - v2).abs().max()) <= 1e-14 * scale


@pytest.mark.cuda
def test_repr_images_wide_rows_on_cuda(monkeypatch):
    """``repr_images`` on rows of 2240 and 3584 image columns (bosons with
    a dense three-site term on every triple, k = 1; the general path, as
    the entry path's tables never hold so many columns): at 3584 fewer
    than 4 warps' regions fit a block's shared memory, so a block runs
    fewer warps. Then every warp's region in the device buffer
    (ROW_SHARED_MAX = 0), of one block (ROW_SCRATCH_MAX = 1) or of many.
    Each build against the plain version (columns and W exactly, values to
    1e-14 of max|v|) and its H x against MatvecRepr's (1e-12 of
    max|y|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    import torch_zoo as tz
    from quantum_basis_tpu_torch.ops import apply_repr as ar
    from quantum_basis_tpu_torch.ops import ell_build
    from quantum_basis_tpu_torch.ops.apply_repr import _repr_ell_plain
    from quantum_basis_tpu_torch.ops.sparse import EllMatrix

    dev = "cuda"
    for L in (7, 8):
        m, _ = tz.boson_triples(L, complex_=L == 7, device=dev)
        m.enumerate_basis_repr([1], [], [])
        mv = m.sec_repr[0].matvec
        rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = mv.args()
        n = mv.n
        assert tabs.n_cols == 64 * L * (L - 1) * (L - 2) // 6
        c2, v2 = _repr_ell_plain(rt, tabs, ix, labels, fodd, isn, sqrt_nu,
                                 phase, 0, n)
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(n, dtype=torch.complex128, device=dev, generator=g)
        y = mv(x)
        for shared, scratch in ((None, None), (0, None), (0, 1)):
            with monkeypatch.context() as mp:
                if shared is not None:
                    mp.setattr(ell_build, "ROW_SHARED_MAX", shared)
                if scratch is not None:
                    mp.setattr(ell_build, "ROW_SCRATCH_MAX", scratch)
                img = ar.ReprLaunch("repr_images", rt, tabs, ix, labels,
                                    fodd, isn, sqrt_nu, None, phase, n,
                                    rrec=mv.basis.row_records())
                assert img.entry is None
                c, v = img.images(0, n)
            torch.cuda.synchronize()
            assert c.shape == c2.shape and torch.equal(c, c2)
            scale = float(v2.abs().max())
            assert float((v - v2).abs().max()) <= 1e-14 * scale
            got = EllMatrix(c, v, diag.reshape(-1)[:n])(x)
            torch.cuda.synchronize()
            assert float((got - y).abs().max()) <= 1e-12 * float(
                y.abs().max())
