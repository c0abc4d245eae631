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
    KronOp,
    _kron_ell_plain,
    ell_arrays,
    kron_ell,
    kron_layout,
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
    cols, vals, cnt = ell_arrays(ell_a, torch.float32, "cpu")
    assert cols.dtype == cnt.dtype == torch.int32 and vals.dtype == \
        torch.float32
    assert torch.equal(cnt, (ell_a.vals != 0).sum(dim=1).to(torch.int32))
    # slot-major, and rows past the matrix are zero-count rows
    assert cols.shape == vals.shape == (ell_a.width, ell_a.n)
    assert torch.equal(cols.T, ell_a.cols.to(torch.int32))
    c2, v2, n2 = ell_arrays(ell_a, torch.float64, "cpu", 2, ell_a.n + 3)
    assert c2.shape == (ell_a.width, ell_a.n + 1)
    live = ell_a.n - 2
    assert torch.equal(n2[:live], cnt[2:]) and not n2[live:].any()
    assert not v2[:, live:].any()


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


@pytest.mark.cuda
@pytest.mark.parametrize("dt", ["float64", "float32"])
def test_kernel_matches_plain_on_cuda(dt):
    """The CUDA kernel against its plain version on the card: Hubbard 4x2
    (one factor) and the 2x2 (2, 1) sector (two), with and without the
    coupling, and a synthetic apply with rows too long for the kernel's
    shared memory; 1e-12 (f64) or 5e-6 (f32) of max|y|."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the GPU machine")
    t_dt = getattr(torch, dt)
    tol = 1e-12 if dt == "float64" else 5e-6
    rng = np.random.default_rng(4)
    for lx, ly, nu, nd in ((4, 2, 4, 4), (2, 2, 2, 1)):
        pm = tz.hubbard_factorized(lx, ly, Nup=nu, Ndn=nd, device="cuda")[0]
        op = pm.op(t_dt, layout="ell")
        psi = torch.as_tensor(rng.standard_normal((pm.na, pm.nb)),
                              dtype=t_dt, device="cuda")
        for P in (op._P, None):
            args = (op._Aell, op._Bell, op._adiag, op._bdiag, P, op._pscale,
                    psi)
            before = apply_kron.launch_count
            yk = kron_ell(*args)
            assert apply_kron.launch_count == before + 2  # two passes
            yp = _kron_ell_plain(*args, psi)
            torch.cuda.synchronize()
            _close(yk.double().cpu().numpy(), yp.double().cpu().numpy(), tol)
    # rows too long for shared memory: one staged f32 row, f64 from global
    nr, nb, W = 5, 30_000, 6

    def side(n, ncols):
        cnt = rng.integers(0, W + 1, n)
        vals = rng.standard_normal((W, n)) * (np.arange(W)[:, None] < cnt)
        return (torch.as_tensor(rng.integers(0, ncols, (W, n)),
                                dtype=torch.int32, device="cuda"),
                torch.as_tensor(vals, dtype=t_dt, device="cuda"),
                torch.as_tensor(cnt, dtype=torch.int32, device="cuda"))

    def rand(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=t_dt,
                               device="cuda")

    psi = rand(nr, nb)
    args = (side(nr, nr), side(nb, nb), rand(nr), rand(nb), None, 0.0, psi)
    yk, yp = kron_ell(*args), _kron_ell_plain(*args, psi)
    torch.cuda.synchronize()
    _close(yk.double().cpu().numpy(), yp.double().cpu().numpy(), tol)


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
