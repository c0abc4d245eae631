"""The ELL layout of the port's factorized kron engine against the JAX
package's.

``KronOp(layout="ell")`` on the CPU (the plain version of the fused kernel
``csrc/kron_ell.cu``) against the JAX ``KronOp`` in both of its layouts, on
Hubbard 2x2 and 4x2 at half filling (one shared factor) and on the
asymmetric 2x2 (N_up, N_dn) = (2, 1) sector (two factors), from one seeded
numpy vector: 1e-12 x max|y| in float64, 5e-6 x max|y| for the float32
engine; the same engine rebuilt from the JAX ELL arrays through
``interop.kron_from_numpy``. ``ProductModel.op(layout=)`` keys its engines
by (dtype, layout, mesh), and solves Hubbard 4x2 to the golden E0 =
-14.07605866 (1e-8) on either layout. ``KronSharded(layout="ell")`` on a
gloo group of 2 (tests/torch_mp_worker.py, suite "kron_ell") against
``KronOp`` (1e-12, padded rows zero). The routing entry
``kron_dense_max_dim`` is dense at every size on the CPU; an ELL engine
holds no dense factor. One ``cuda``-marked test holds the kernel against its
plain version on the card.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

import torch_zoo as tz
from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.interop import kron_from_numpy
from quantum_basis_tpu_torch.ops import apply_kron
from quantum_basis_tpu_torch.ops.apply_kron import (
    COMPACT_MAX_DIM,
    COMPACT_MAX_VALUES,
    KronOp,
    _kron_ell_plain,
    decode_slots,
    ell_arrays,
    is_compact,
    kron_ell,
    kron_layout,
    pack_slots,
)
from quantum_basis_tpu_torch.parallel.kron_sharded import KronSharded

E0_HUBBARD_4X2 = -14.07605866
# name: (Lx, Ly, N_up, N_dn)
SECTORS = {"2x2": (2, 2, 2, 2), "4x2": (4, 2, 4, 4), "2x2_2_1": (2, 2, 2, 1)}
_BUILT = {}


def _jnp():
    """jax.numpy, imported where a test compares with the JAX package: the
    card's machine, which runs the cuda-marked test, has no JAX."""
    import jax.numpy as jnp

    return jnp


def both(name):
    """(JAX ProductModel, port ProductModel) of a sector; cached."""
    if name not in _BUILT:
        sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "examples"))
        import square_fermi_hubbard as jh  # the JAX package's model functions

        lx, ly, nu, nd = SECTORS[name]
        pj = (jh.build_factorized(lx, ly, Nf=nu)[0] if nu == nd
              else jh.build_factorized_sector(lx, ly, nu, nd))
        _BUILT[name] = (pj, tz.hubbard_factorized(lx, ly, Nup=nu, Ndn=nd)[0])
    return _BUILT[name]


def _jax_apply(op, x, dtype):
    y = op.apply(op.params, (_jnp().asarray(x, dtype), None))[0]
    return np.asarray(y, np.float64)


def _close(got, want, tol):
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= tol * scale


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(SECTORS))
def test_ell_layout_matches_jax_layouts(name, dt):
    pj, pt = both(name)
    tol = 1e-12 if dt == "float64" else 5e-6
    op = pt.op(getattr(torch, dt), layout="ell")
    assert isinstance(op, KronOp) and op.layout == "ell"
    assert op._Ad is None and op._Bt is None
    assert (op._Bell is op._Aell) == (pt.model_b is None)
    jnp = _jnp()
    je = pj.op(jnp.dtype(dt), layout="ell")
    jd = pj.op(jnp.float64, layout="dense")
    assert op.nnz_estimate == je.nnz_estimate == jd.nnz_estimate
    x = np.random.default_rng(11).standard_normal(pt.dim)
    y = op(torch.as_tensor(x, dtype=getattr(torch, dt))).double().numpy()
    want64 = _jax_apply(jd, x, np.float64)
    _close(y, want64, tol)
    _close(y, _jax_apply(je, x, np.dtype(dt)), tol)
    # the engine rebuilt from the JAX ELL arrays
    Aside, Bside, adiag, bdiag, P = je.params
    as_np = lambda side: tuple(np.asarray(a) for a in side)  # noqa: E731
    A = as_np(Aside)
    ot = kron_from_numpy(A, A if Bside is Aside else as_np(Bside),
                         np.asarray(adiag), np.asarray(bdiag), np.asarray(P),
                         je._pscale, device="cpu")
    assert ot.layout == "ell" and ot.dtype == getattr(torch, dt)
    assert (ot._Bell is ot._Aell) == (Bside is Aside)
    _close(ot(torch.as_tensor(x)).double().numpy(), want64, tol)
    assert op.n_applies == 1
    # the JAX dense engine's params as they come (1-tuples)
    od = kron_from_numpy(*jd.params, jd._pscale, device="cpu")
    assert od.layout == "dense"
    _close(od(torch.as_tensor(x)).numpy(), want64, 1e-12)
    bad = (A[0] + pt.na, A[1])   # columns past the factor's rows
    with pytest.raises(ValueError, match="columns"):
        kron_from_numpy(bad, bad, np.asarray(adiag), np.asarray(bdiag),
                        np.asarray(P), je._pscale, device="cpu")


def test_ell_arrays_counts_and_rows():
    _, pt = both("2x2_2_1")
    ell_a, _ = pt._factor_ells()
    for dt in (torch.float64, torch.float32):   # compact, wide
        slots, vals, cnt = side = ell_arrays(ell_a, dt, "cpu")
        assert is_compact(side) == (dt == torch.float64)
        assert slots.dtype == cnt.dtype == torch.int32 and vals.dtype == dt
        assert torch.equal(cnt, (ell_a.vals != 0).sum(dim=1).to(torch.int32))
        # slot-major, and rows past the matrix are zero-count rows
        assert slots.shape == (ell_a.width, ell_a.n)
        _assert_same_rows(side, ell_a.cols, ell_a.vals.to(dt))
        c2, v2, n2 = ell_arrays(ell_a, dt, "cpu", 2, ell_a.n + 3)
        assert c2.shape == (ell_a.width, ell_a.n + 1)
        live = ell_a.n - 2
        assert torch.equal(n2[:live], cnt[2:]) and not n2[live:].any()
        assert not decode_slots((c2, v2, n2))[1][:, live:].any()


def _row_sorted(cols, vals, cnt):
    """Each row's live (column, value) pairs sorted, padding last as
    (-1, 0): (n, W) numpy arrays."""
    cols, vals = np.asarray(cols, np.int64).copy(), np.asarray(vals).copy()
    pad = np.arange(cols.shape[1])[None, :] >= np.asarray(cnt)[:, None]
    assert not vals[pad].any()
    cols[pad] = np.iinfo(np.int64).max
    order = np.lexsort((vals, cols), axis=1)
    return (np.take_along_axis(cols, order, 1),
            np.take_along_axis(vals, order, 1))


def _assert_same_rows(side, cols, vals):
    """A side decodes to the (n, W) ELL's rows: each row's live slots the
    same (column, value) pairs in some order, its padding zero."""
    got_cols, got_vals = decode_slots(side)
    cnt = side[2].numpy()
    gc, gv = _row_sorted(got_cols.T.numpy(), got_vals.T.numpy(), cnt)
    wc, wv = _row_sorted(cols.numpy(), vals.numpy(), cnt)
    np.testing.assert_array_equal(gc, wc)
    np.testing.assert_array_equal(gv, wv)


def _random_ell(rng, n, n_cols, W, values=None):
    """An (n, W) ELL with random counts (live slots packed left, padding
    0 at column 0); its values drawn from ``values`` when given."""
    cnt = rng.integers(0, W + 1, n)
    live = np.arange(W)[None, :] < cnt[:, None]
    vals = (rng.standard_normal((n, W)) if values is None
            else rng.choice(values, (n, W)))
    return (torch.as_tensor(rng.integers(0, n_cols, (n, W)) * live),
            torch.as_tensor(vals * live))


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("case", ["4x2", "2x2_2_1", "random"])
def test_slot_forms_round_trip(case, dt):
    """pack_slots then decode_slots gives the factor ELL back, slot by slot,
    in either form (compact in float64, wide in float32); the counts are
    one past each row's last live slot."""
    if case == "random":
        cols, vals = _random_ell(np.random.default_rng(1), 300, 500, 7,
                                 values=[-1.5, 0.25, 2.0])
        n_cols = 500
    else:
        ell = both(case)[1]._factor_ells()[0]
        cols, vals, n_cols = ell.cols, ell.vals, ell.n
    t_dt = getattr(torch, dt)
    side = pack_slots(cols, vals, n_cols, t_dt, "cpu")
    assert is_compact(side) == (dt == "float64")
    assert side[1].dtype == t_dt
    slot = torch.arange(1, vals.shape[1] + 1)
    assert torch.equal(side[2].long(), ((vals != 0) * slot).amax(dim=1))
    _assert_same_rows(side, cols * (vals != 0), vals.to(t_dt))


def _bank_loads(cols, cnt):
    """Shared-memory wavefronts of the kernel's gathers over one panel: at
    each slot position, for each quarter-warp (8 consecutive rows), the
    most distinct rows one bank group (column % 8) holds among its live
    slots."""
    n, W = cols.shape
    total = 0
    for r0 in range(0, n, 8):
        c, k_cnt = cols[r0:r0 + 8], cnt[r0:r0 + 8]
        for k in range(int(k_cnt.max(initial=0))):
            live = np.unique(c[k_cnt > k, k])
            total += np.bincount(live % 8, minlength=8).max()
    return total


def test_bank_order_keeps_rows_and_spreads_banks():
    """pack_slots reorders each row's live slots so that a quarter-warp's
    gathers spread over the bank groups: every row keeps its entries and
    its count, padding stays zero, and the wavefronts of the 4x2 factor
    and of a random ELL fall."""
    ell = both("4x2")[1]._factor_ells()[0]
    rand = _random_ell(np.random.default_rng(6), 400, 3000, 12,
                       values=[1.0, -1.0, 0.5])
    for cols, vals, n_cols in ((ell.cols, ell.vals, ell.n),
                               (*rand, 3000)):
        cols = cols * (vals != 0)
        side = pack_slots(cols, vals, n_cols, torch.float64, "cpu")
        _assert_same_rows(side, cols, vals.double())
        cnt = side[2].numpy()
        before = _bank_loads(cols.numpy(), cnt)
        after = _bank_loads(decode_slots(side)[0].T.numpy(), cnt)
        assert after < before


def test_value_table_holds_each_value_once():
    """The compact table (float64) is sorted and holds each distinct value
    of the slots (padding's 0 included) once; the 4x2 Hubbard factor's
    hoppings are -1 and 1, and -2 and 2 along the two-site direction,
    where both bonds join the same pair of sites. A float32 side holds
    its values slot by slot."""
    ell = both("4x2")[1]._factor_ells()[0]
    slots, table, _ = ell_arrays(ell, torch.float64, "cpu")
    assert table.dtype == torch.float64 and table.dim() == 1
    assert torch.equal(table, torch.unique(ell.vals.double()))
    assert table.tolist() == [-2.0, -1.0, 0.0, 1.0, 2.0]
    idx = (slots >> 16) & 0xFFFF
    assert int(idx.max()) < table.numel()
    slots32, vals32, _ = ell_arrays(ell, torch.float32, "cpu")
    assert vals32.shape == slots32.shape == (ell.width, ell.n)
    cols, vals = _random_ell(np.random.default_rng(2), 200, 200, 5,
                             values=[3.0, -2.0, 3.0, 7.5])
    _, table, _ = pack_slots(cols, vals, 200, torch.float64, "cpu")
    assert table.tolist() == [-2.0, 0.0, 3.0, 7.5]


def test_wide_form_by_shape():
    """The compact form (float64) holds dims up to 65,535 and 65,536
    distinct values; a factor of dim 65,536, or one with more than 65,536
    distinct values, takes the wide form, as every float32 factor does."""
    rng = np.random.default_rng(3)
    n = COMPACT_MAX_DIM + 1   # 65,536 rows, one slot each, two values
    cols = torch.as_tensor(rng.integers(0, n, (n, 1)))
    vals = torch.as_tensor(rng.choice([-1.0, 1.0], (n, 1)))
    assert not is_compact(pack_slots(cols, vals, n, torch.float64, "cpu"))
    side = pack_slots(cols[:-1] % (n - 1), vals[:-1], n - 1, torch.float64,
                      "cpu")
    assert is_compact(side)
    assert int(decode_slots(side)[0].max()) == n - 2   # a 16-bit column
    assert not is_compact(pack_slots(cols[:-1] % (n - 1), vals[:-1], n - 1,
                                     torch.float32, "cpu"))
    # 65,536 distinct values fit (the largest index 65,535), 65,537 do not
    m = COMPACT_MAX_VALUES // 2
    vals = torch.as_tensor(rng.permutation(2 * m + 1)[:2 * m].reshape(m, 2)
                           + 1.0)
    cols = torch.as_tensor(rng.integers(0, m, (m, 2)))
    side = pack_slots(cols, vals, m, torch.float64, "cpu")
    assert is_compact(side) and side[1].numel() == COMPACT_MAX_VALUES
    _assert_same_rows(side, cols, vals)
    vals[0, 0] = -1.0          # one more value
    vals = torch.cat([vals, torch.tensor([[-3.0, 0.0]])])
    cols = torch.cat([cols, torch.tensor([[0, 0]])])
    side = pack_slots(cols, vals, m + 1, torch.float64, "cpu")
    assert not is_compact(side) and side[1].shape == (2, m + 1)


def _as_wide(side):
    """A side in the wide slot form: its decoded columns and values."""
    cols, vals = decode_slots(side)
    return cols.to(torch.int32), vals.contiguous(), side[2]


@pytest.mark.parametrize("dt,form", [("float64", "compact"),
                                     ("float64", "wide"),
                                     ("float32", "wide")])
def test_plain_version_on_both_forms_matches_jax(dt, form):
    """The plain version on either slot form against the JAX package's
    layout="ell" apply on every sector: 1e-12 (f64), 5e-6 (f32) of max|y|."""
    tol = 1e-12 if dt == "float64" else 5e-6
    t_dt = getattr(torch, dt)
    for name in sorted(SECTORS):
        pj, pt = both(name)
        ell_a, ell_b = pt._factor_ells()
        A = ell_arrays(ell_a, t_dt, "cpu")
        B = A if ell_b is None else ell_arrays(ell_b, t_dt, "cpu")
        if form == "wide" and is_compact(A):
            wide_a = _as_wide(A)
            B = wide_a if B is A else _as_wide(B)
            A = wide_a
        assert is_compact(A) == is_compact(B) == (form == "compact")
        op = pt.op(t_dt, layout="ell")
        x = np.random.default_rng(12).standard_normal(pt.dim)
        psi = torch.as_tensor(x, dtype=t_dt).view(pt.na, pt.nb)
        y = _kron_ell_plain(A, B, op._adiag, op._bdiag, op._P, op._pscale,
                            psi, psi)
        je = pj.op(_jnp().dtype(dt), layout="ell")
        _close(y.double().numpy().reshape(-1),
               _jax_apply(je, x, np.dtype(dt)), tol)


def test_cuda_args_take_compact_slots_in_float64_only():
    """The kernel's argument check (run before a launch) takes a compact
    side in float64 and refuses one in float32, the form pack_slots never
    makes there; a wide side passes in both types."""
    _, pt = both("4x2")
    ell_a, _ = pt._factor_ells()
    psi = torch.zeros((pt.na, pt.nb), dtype=torch.float64)
    compact = ell_arrays(ell_a, torch.float64, "cpu")
    for dt, side, ok in ((torch.float64, compact, True),
                         (torch.float64, _as_wide(compact), True),
                         (torch.float32, ell_arrays(ell_a, torch.float32,
                                                    "cpu"), True),
                         (torch.float32, (compact[0], compact[1].float(),
                                          compact[2]), False)):
        x = psi.to(dt)
        diag = torch.zeros(pt.na, dtype=dt)
        args = (side, side, diag, diag, None, x, x)
        if ok:
            apply_kron._check_cuda_args(*args)
        else:
            with pytest.raises(ValueError, match="float64 only"):
                apply_kron._check_cuda_args(*args)


def test_plain_version_with_a_gathered_source():
    """The A side gathers from psi_full (the all-gathered matrix on a group
    of ranks): rows [lo, hi) of the full apply, from those rows' ELL and
    the local slice of psi."""
    _, pt = both("4x2")
    ell_a, _ = pt._factor_ells()
    op = pt.op(torch.float64, layout="ell")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(pt.dim))
    full = op(x).view(pt.na, pt.nb)
    psi = x.view(pt.na, pt.nb)
    lo, hi = 20, 45
    before = apply_kron.launch_count
    A = ell_arrays(ell_a, torch.float64, "cpu", lo, hi)
    P = op._P[lo:hi]
    y = kron_ell(A, op._Bell, op._adiag[lo:hi], op._bdiag, P, op._pscale,
                 psi[lo:hi].contiguous(), psi)
    assert torch.allclose(y, full[lo:hi], rtol=0, atol=1e-12)
    assert apply_kron.launch_count == before  # the CPU plain version
    with pytest.raises(ValueError, match="unsupported device"):
        kron_ell(A, op._Bell, op._adiag, op._bdiag, None, 0.0,
                 torch.empty((2, 2), device="meta"))


@pytest.mark.parametrize("layout", ["dense", "ell"])
def test_product_model_layout_keys_and_golden(layout):
    pt = tz.hubbard_factorized(4, 2)[0]
    op = pt.op(torch.float64, layout=layout)
    assert op.layout == layout
    assert (torch.float64, layout, False) in pt._ops
    assert pt.op(torch.float64, layout=layout) is op
    assert pt.op(torch.float64) is not op  # keyed by layout, as in JAX
    assert pt.op(torch.float64).layout == "dense"  # the CPU table's route
    # the solve takes the routed layout: pin the entry to reach the ELL
    bound = 0 if layout == "ell" else float("inf")
    with config.pinned(kron_dense_max_dim=bound):
        pm = tz.hubbard_factorized(4, 2)[0]
        E0 = pm.locate_E0_lanczos(mixed=False, ncv=16)
        assert pm.op().layout == layout
    assert abs(E0 - E0_HUBBARD_4X2) < 1e-8
    assert pm._last_residual < 1e-8


def test_routing_entry_on_the_cpu():
    """The "cpu" table is dense at every size (the JAX package's rule where
    float64 dots are trusted); the entry's bound is inclusive."""
    assert config.route("kron_dense_max_dim", "cpu") == float("inf")
    assert kron_layout(12870, 12870, "cpu") == "dense"
    _, pt = both("2x2_2_1")  # factor dims 6 and 4
    ell_a, ell_b = pt._factor_ells()
    for bound, want in ((6, "dense"), (5, "ell"), (4, "ell")):
        with config.pinned(kron_dense_max_dim=bound):
            assert kron_layout(6, 4, "cpu") == want
            assert KronOp(ell_a, ell_b).layout == want
    with pytest.raises(ValueError, match="layout"):
        KronOp(ell_a, ell_b, layout="csr")


def test_ell_engine_holds_no_dense_factor():
    _, pt = both("4x2")
    ell = pt.op(torch.float64, layout="ell")
    dense = pt.op(torch.float64, layout="dense")
    na = pt.na
    ell_bytes = sum(t.numel() * t.element_size() for t in ell._Aell)
    p_bytes = ell._P.numel() * ell._P.element_size()
    assert ell.resident_bytes < 2 * ell_bytes + p_bytes
    # no (na, na) factor: the one (na, nb) tensor is the int8 coupling
    held = [t for t in vars(ell).values() if isinstance(t, torch.Tensor)]
    held += [t for side in (ell._Aell, ell._Bell) for t in side]
    assert all(t is ell._P or tuple(t.shape) != (na, na) for t in held)
    assert dense.resident_bytes >= na * na * 8


class _OneRank:
    """The mesh protocol KronSharded reads, for one rank on the CPU."""

    size, rank, device = 1, 0, torch.device("cpu")

    def all_gather(self, x):
        return x


def test_engines_share_the_coupling_and_one_factors_arrays():
    """ProductModel compacts its coupling once for all its engines; an ELL
    engine over one factor (B=None) holds one set of ELL arrays, and so
    does KronSharded on a rank that holds every row."""
    pt = tz.hubbard_factorized(4, 2)[0]
    stored = pt._coupling_stored()
    assert stored is pt._coupling_stored() and stored.dtype == np.int8
    o64 = pt.op(torch.float64, layout="ell")
    o32 = pt.op(torch.float32, layout="ell")
    # on the CPU both engines wrap the one host array
    assert o64._P.data_ptr() == o32._P.data_ptr() == stored.ctypes.data
    ell_a, ell_b = pt._factor_ells()
    assert ell_b is None and o64._Aell is o64._Bell
    sh = KronSharded(ell_a, coupling=stored, coupling_scale=pt.coupling_scale,
                     mesh=_OneRank(), layout="ell")
    assert sh._Aell is sh._Bell
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(pt.dim))
    _close(sh(x).numpy(), o64(x).numpy(), 1e-12)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = tz.WorkerGroup("kron_ell", 2, tmp_path_factory.mktemp("kron_ell2"))
    yield g
    g.close()


@pytest.mark.parametrize("case", ["4x2", "3x2_2_3"])
def test_kron_sharded_ell_on_two_ranks(group, case):
    """KronSharded(layout="ell") and (layout="dense") on a gloo group of 2
    against the single-device KronOp(layout="ell"): 1e-12 (f64), 5e-6 (f32)
    of max|y|, every rank equal, padded rows zero."""
    from torch_mp_worker import KRON_ELL_CASES

    lx, ly, nu, nd = KRON_ELL_CASES[case]
    pm = tz.hubbard_factorized(lx, ly, Nup=nu, Ndn=nd)[0]
    x = np.random.default_rng(9).standard_normal(pm.dim)
    want = pm.op(torch.float64, layout="ell")(torch.as_tensor(x)).numpy()
    (a0, s0), (a1, s1) = group.results()
    assert s0 == s1
    na_pad = -(-pm.na // 2) * 2
    for layout in ("ell", "dense"):
        for dt, tol in (("float64", 1e-12), ("float32", 5e-6)):
            tag = f"{case}_{layout}_{dt}"
            np.testing.assert_array_equal(a0[tag], a1[tag])
            _close(a0[tag], want, tol)
            assert s0[tag + "_layout"] == layout
            assert s0[tag + "_na"] == na_pad
            pad = a0[tag + "_padded_rows"]
            assert pad.shape == (na_pad - pm.na, pm.nb) and not pad.any()


# (nrows, nfull, nb, W): synthetic applies that drive each branch of the
# kernel's two passes (a staged panel, or gathers from device memory,
# chosen by the gather axis: psi_full's rows for pass 1, nb for pass 2);
# psi_full has more rows than psi in each
CUDA_BRANCH_CASES = {
    "staged": (37, 9000, 9000, 6),        # pass 1 and 2 staged
    "global_a": (16, 20_000, 64, 5),      # pass 1 from memory
    "wide_rows": (5, 7, 30_000, 6),       # pass 2 from memory
}


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_kernel_matches_plain_on_cuda(dt):
    """The CUDA kernel against its plain version on the card, each side in
    the slot form of its type (compact in f64, wide in f32) and, in f64,
    again in the wide form, alone and beside a compact side: Hubbard 4x2
    (one factor) and the 2x2 (2, 1) sector (two factors), with and without
    the coupling, and the synthetic applies of CUDA_BRANCH_CASES (the
    staged branch, pass 1 and pass 2 gathering from device memory;
    psi_full with more rows than psi; int8 and float32 couplings); 1e-12
    (f64) or 5e-6 (f32) of max|y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    t_dt = getattr(torch, dt)
    f64 = t_dt == torch.float64
    tol = 1e-12 if f64 else 5e-6
    rng = np.random.default_rng(4)

    def check(A, B, adiag, bdiag, P, ps, psi, psi_full):
        args = (A, B, adiag, bdiag, P, ps, psi, psi_full)
        before = apply_kron.launch_count
        yk = kron_ell(*args)
        assert apply_kron.launch_count == before + 2  # two passes
        yp = _kron_ell_plain(*args)
        torch.cuda.synchronize()
        _close(yk.double().cpu().numpy(), yp.double().cpu().numpy(), tol)

    def pairs(A, B):
        """(A, B) in the type's form, and in f64 the wide form and the
        two forms side by side."""
        assert is_compact(A) == is_compact(B) == f64
        if not f64:
            return [(A, B)]
        wa, wb = _as_wide(A), _as_wide(B)
        return [(A, B), (wa, wb), (A, wb), (wa, B)]

    for lx, ly, nu, nd in ((4, 2, 4, 4), (2, 2, 2, 1)):
        pm = tz.hubbard_factorized(lx, ly, Nup=nu, Ndn=nd, device="cuda")[0]
        op = pm.op(t_dt, layout="ell")
        psi = torch.as_tensor(rng.standard_normal((pm.na, pm.nb)),
                              dtype=t_dt, device="cuda")
        for A, B in pairs(op._Aell, op._Bell):
            for P in (op._P, None):
                check(A, B, op._adiag, op._bdiag, P, op._pscale, psi, psi)

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=t_dt,
                               device="cuda")

    for nr, nfull, nb, W in CUDA_BRANCH_CASES.values():
        psi_full = rand(nfull, nb)
        lo = (nfull - nr) // 2
        psi = psi_full[lo:lo + nr].contiguous()
        ells = (_random_ell(rng, nr, nfull, W, values=[-1.0, 0.5, 2.0]),
                _random_ell(rng, nb, nb, W, values=[1.0, -0.25]))
        A, B = (pack_slots(c, v, n, t_dt, "cuda")
                for (c, v), n in zip(ells, (nfull, nb)))
        for A, B in pairs(A, B):
            for P in (torch.as_tensor(rng.integers(-3, 4, (nr, nb)),
                                      dtype=torch.int8, device="cuda"),
                      torch.as_tensor(rng.standard_normal((nr, nb)),
                                      dtype=torch.float32, device="cuda")):
                check(A, B, rand(nr), rand(nb), P, 1.1, psi, psi_full)
    # random values over 30,000 rows: more than 65,536 distinct, so the
    # wide form by shape in f64 too (chip_smoke.py phase 17's wide rows)
    nr, _, nb, W = CUDA_BRANCH_CASES["wide_rows"]
    B = pack_slots(*_random_ell(rng, nb, nb, W), nb, t_dt, "cuda")
    A = pack_slots(*_random_ell(rng, nr, nr, W), nr, t_dt, "cuda")
    assert not is_compact(B) and is_compact(A) == f64
    psi = rand(nr, nb)
    check(A, B, rand(nr), rand(nb), None, 0.0, psi, psi)


def test_routing_kron_section_quick():
    """benchmarks/routing.py's kron section on the CPU's quick cases: both
    layouts solve each sector to one E0 (1e-9), on the layout pinned."""
    from quantum_basis_tpu_torch.benchmarks import routing

    out = routing.kron_section("cpu", quick=True)
    assert set(out) == {"hubbard4x2", "hubbard4x2_3_2"}
    for tag, recs in out.items():
        assert abs(recs["dense"]["E0"] - recs["ell"]["E0"]) < 1e-9
        assert recs["ell"]["float64_resident_bytes"] \
            < recs["dense"]["float64_resident_bytes"]
    assert abs(out["hubbard4x2"]["ell"]["E0"] - E0_HUBBARD_4X2) < 1e-8
