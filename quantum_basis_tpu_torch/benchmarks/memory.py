"""Whole solves at each setting of the memory sizes (``config.MEMORY``).

Each section sweeps one or two sizes and runs, at every point, the same
sectors end to end, the set-up included; it records seconds, the peak device
memory (``torch.cuda.max_memory_allocated``), the applies and the energies,
which must agree across the points of a section (1e-10 in float64). These
runs set the "cuda" values of ``config.MEMORY``:

- ``block``: ``apply_block_budget`` at 2^24 ... 2^29 on the full sectors
  that run on the matrix-free apply on the card (Hubbard 4x2, kagome t-J
  2x2, t-J chain-12, chain-24 and kagome-24 Sz=-4, chain-24 Sz=-6) and, the
  matrix-free route pinned, chain-24 and kagome-24 Sz=0 (dim 2,704,156):
  ms per apply, the device idle share of one apply
  (``utils/profiling.trace``), and chain-24's ``mopr_x_vec`` of Sz(q);
- ``repr_block``: ``repr_block_budget`` at 2^22 ... 2^27: ``MatvecRepr``
  ms per apply (7 samples, with the spread) on kagome-24 k=(0,0) and
  chain-24 k=0, and one continued fraction (``measure_repr_dynamic``, 40
  steps) of chain-24 on its target sector's ``MatvecRepr``;
- ``repr_label``: ``repr_label_buffer_max``: ``MatvecRepr`` ms per apply
  (7 samples) with its label buffer (the bound at 16 bytes a label) and
  on the general path (the bound one byte lower) on kagome-24 k=(0,2),
  chain-24 k=0 and chain-26 k=0 (2^24, 2^24 and 2^26 labels), the
  applies checked equal (1e-12 of max|y|); then the eight momentum
  sectors of kagome-24 Sz=0 kept alive together, each applied in turns:
  the peak and the bytes the label buffer holds;
- ``lookup``: ``direct_lookup_max``: the direct, Lin and binary-search
  indexes on chain-26 and chain-28 Sz=0 (label spaces 2^26, 2^28): index
  build (the direct mode's host table included), basis, ELL build,
  matrix-free apply and the ELL solve;
- ``polish``: ``polish_n``: the warm-started float64 stage of the mixed
  full-sector solve on ContractOp as thick restart against the RQI polish,
  on chain-20, -22 and -24 and kagome-24 Sz=0 (N = 2^20, 2^22, 2^24) and
  chain-26 Sz=0 (2^26);
- ``product``: ``product_mixed_above`` and ``product_ncv``: Hubbard 4x2 and
  4x4 at half filling through ProductModel, pure float64 thick restart
  against the mixed pipeline at ncv 6, 12, 24 (E0 against the golden to
  1e-8, the float64 residual under its gate), then the (9,8) gap sector at
  the fastest 4x4 setting;
- ``ckpt``: ``ckpt_max_bytes``: save and load seconds of records of 0.28,
  1.33, 3.5 and 9.3 GB (a chain-24 restart record, the Hubbard 4x4
  eigenvector, an N = 2^24 complex restart basis, a Hubbard 4x4 float64
  basis at ncv = 6) through ``CkptStore`` in a fresh directory beside
  ``config.ckpt_dir``, the device copies included, and the disk free there;
  the rule: a save costs at most ``CKPT_SHARE`` of the solver time between
  two restart saves (``solvers/restarted._SAVE_PERIOD``).

Run:  python -m quantum_basis_tpu_torch.benchmarks.memory [--sections block,repr_block,repr_label,lookup,polish,product,ckpt] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.index import BasisIndex
from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.benchmarks import (device_ms, device_ms_samples,
                                                device_name, out_path, timed,
                                                write_json)
from quantum_basis_tpu_torch.benchmarks.hubbard4x4 import (E0_4X4,
                                                           solve_sector)
from quantum_basis_tpu_torch.benchmarks.routing import (
    SZ_HALF, _free, _peak, _solve, _sz_q, chain, example, kagome24, kagome_tj)
from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
    E0_4X2, build_factorized, build_factorized_sector)
from quantum_basis_tpu_torch.ops.apply import (DeviceBasis, MatvecFull,
                                               mopr_x_vec)
from quantum_basis_tpu_torch.solvers.restarted import _SAVE_PERIOD
from quantum_basis_tpu_torch.utils import profiling
from quantum_basis_tpu_torch.utils.ckpt import CkptStore, join_vec, split_vec

INF = math.inf
E0_TOL = 1e-10
CF_STEPS = 40
CKPT_SHARE = 0.10   # of the solver time between two restart saves

BLOCK_CASES = {   # tag: (model, the idle share of an apply traced, quick)
    "hubbard4x2_4_4": (example("square_fermi_hubbard", "build", 4, 2,
                               conserve=[(2, 4.0), (3, 4.0)]), False, True),
    "tj_chain12_N8": (example("chain_tj", "build", 12,
                              conserve=[(1, 0.0), (2, 8.0)]), False, True),
    "kagome_tj22_N8": (kagome_tj(), False, False),
    "chain24_up8": (chain(24, 8), False, False),
    "kagome24_up8": (kagome24(8), False, False),
    "chain24_up6": (chain(24, 6), False, False),
    "chain24_up12": (chain(24, 12), True, False),
    "kagome24_up12": (kagome24(12), True, False),
}
REPR_BLOCK_CASES = {   # tag: (model, momentum, quick)
    "kagome24_k00": (kagome24(12), [0, 0], False),
    "chain24_k0": (chain(24, 12), [0], False),
    "chain16_k0": (chain(16, 8), [0], True),
}
REPR_LABEL_CASES = {   # tag: (model, momentum, quick)
    "kagome24_k02": (kagome24(12), [0, 2], False),
    "chain24_k0": (chain(24, 12), [0], False),
    "chain26_k0": (chain(26, 13), [0], False),
    "chain16_k0": (chain(16, 8), [0], True),
}
CF_CASE = {False: (chain(24, 12), [0], [6]), True: (chain(16, 8), [0], [4])}
LOOKUP_CASES = {   # tag: (model, quick)
    "chain26_up13": (chain(26, 13), False),
    "chain28_up14": (chain(28, 14), False),
    "chain16_up8": (chain(16, 8), True),
}
POLISH_CASES = {
    "chain20_up10": (chain(20, 10), False),
    "chain22_up11": (chain(22, 11), False),
    "chain24_up12": (chain(24, 12), False),
    "kagome24_up12": (kagome24(12), False),
    "chain26_up13": (chain(26, 13), False),
    "chain14_up7": (chain(14, 7), True),
}
PRODUCT_CASES = {"hubbard4x2": (4, 2, E0_4X2, True),
                 "hubbard4x4": (4, 4, E0_4X4, False)}
PRODUCT_NCV = (6, 12, 24)
GAP_SECTOR = (9, 8)
# (name, shape, dtype): the records whose save and load are timed
CKPT_RECORDS = {
    False: (("chain24_restart", (13, 2_704_156), torch.float64),
            ("hubbard4x4_vector", (165_636_900,), torch.float64),
            ("fullspace24_restart_complex", (13, 1 << 24), torch.complex128),
            ("hubbard4x4_f64_basis_ncv6", (7, 165_636_900), torch.float64)),
    True: (("small_restart", (13, 1 << 14), torch.float64),
           ("small_complex", (5, 1 << 14), torch.complex128)),
}


def _shifts(lo, hi, quick):
    return tuple(range(lo, hi + 1)) if not quick else (12, 16, 20)


def _agree(tag, recs, tol=E0_TOL, key="E0"):
    e = [r[key] for r in recs if key in r]
    if e and max(e) - min(e) > tol:
        raise AssertionError(f"{tag}: {key} disagrees across points: {e}")


def _rand(n, device, dtype=torch.float64, seed=5):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(n, dtype=dtype, device=device, generator=gen)


def idle_share(fn, device) -> float | None:
    """The device's idle share of one traced fn() call (1 - the device-busy
    time over the call's wall time, tracing included); None off a card."""
    if torch.device(device).type != "cuda":
        return None
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    log_dir = tempfile.mkdtemp(prefix="memory_trace_")
    try:
        with profiling.trace(log_dir) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU)
    return 1.0 - busy_us / wall_us


# ------------------------------------------------------------ the sections

def block_section(device, quick):
    out = {}
    for tag, (make, traced, q) in BLOCK_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for shift in _shifts(24, 29, quick):
            try:
                with config.pinned(apply_block_budget=1 << shift,
                                   fullspace_max_blowup=0.0,
                                   mixed_precision=False):
                    rec, m = _solve(make, device, "full")
            except torch.OutOfMemoryError as e:
                recs[f"1<<{shift}"] = {"oom": str(e)[:200]}
                print("block", tag, shift, "out of memory", flush=True)
                continue
            s = m.sec_full[0]
            mv = s.matvec
            if not isinstance(mv, MatvecFull):
                raise AssertionError(f"{tag}: solved on {rec['engine']}, "
                                     "not the matrix-free apply")
            x = _rand(s.dim, device)
            rec.update(applies=mv.n_applies,
                       block_rows=s.dbasis.block_rows,
                       n_blocks=s.dbasis.n_blocks,
                       apply_ms=device_ms(lambda: mv(x), device, samples=5,
                                          per_sample=1))
            if traced:
                rec["apply_idle_share"] = idle_share(lambda: mv(x), device)
            if tag == "chain24_up12" or (quick and tag == "tj_chain12_N8"):
                A = m.compile_op(_sz_q(m.lattice, [6], SZ_HALF)
                                 if tag == "chain24_up12" else
                                 _sz_q(m.lattice, [3], np.array([0.0, 0.5,
                                                                 -0.5])))
                gs = s.evecs[0].to(torch.complex128)
                rec["mopr_x_vec_ms"] = device_ms(
                    lambda: mopr_x_vec(A, s.dbasis, s.dbasis, gs), device,
                    samples=5, per_sample=1)
            rec["peak_bytes"] = _peak(device)
            recs[f"1<<{shift}"] = rec
            print("block", tag, shift, json.dumps(rec), flush=True)
            del m, s, mv, x
        _agree(tag, recs.values())
        out[tag] = recs
    return out


def _contfrac(device, quick, shifts):
    """measure_repr_dynamic (CF_STEPS) of Sz(q) from chain-24's k=0 ground
    state, the target sector enumerated at each budget: its seconds, norm
    and first coefficient."""
    make, k0, q = CF_CASE[quick]
    _free(device)
    m, conserve, vals = make(device)
    m.enumerate_basis_repr(k0, conserve, vals)
    m.locate_E0_lanczos("repr", maxit=4000)
    kt = [int((a - b) % n) for a, b, n in zip(k0, q, m.lattice.L)]
    A = _sz_q(m.lattice, q, SZ_HALF)
    recs = {}
    for shift in shifts:
        m.sec_repr.pop(1, None)
        _free(device)
        with config.pinned(repr_block_budget=1 << shift):
            def run():
                m.enumerate_basis_repr(kt, conserve, vals, sec=1)
                return m.measure_repr_dynamic(A, 0, 1, CF_STEPS)
            (nrm, alphas, _), s = timed(run, device)
        mv = m.sec_repr[1].matvec
        recs[f"1<<{shift}"] = {
            "s": s, "norm": float(nrm), "alpha0": float(alphas[0]),
            "block_rows": mv.basis.block_rows,
            "engine": type(mv).__name__, "peak_bytes": _peak(device)}
        print("contfrac", shift, json.dumps(recs[f"1<<{shift}"]), flush=True)
    _agree("contfrac", recs.values(), key="norm")
    _agree("contfrac", recs.values(), key="alpha0")
    return recs


def repr_block_section(device, quick):
    out = {}
    shifts = _shifts(22, 27, quick)
    for tag, (make, k, q) in REPR_BLOCK_CASES.items():
        if quick != q:
            continue
        recs = {}
        for shift in shifts:
            _free(device)
            with config.pinned(repr_block_budget=1 << shift):
                m, conserve, vals = make(device)
                dim, s = timed(lambda: m.enumerate_basis_repr(k, conserve,
                                                              vals), device)
            mv = m.sec_repr[0].matvec
            x = _rand(dim, device, torch.complex128)
            ms = device_ms_samples(lambda: mv(x), device, samples=7,
                                   per_sample=1)
            recs[f"1<<{shift}"] = {
                "dim": dim, "enumerate_s": s, "block_rows":
                m.sec_repr[0].dbasis.block_rows, "n_blocks":
                m.sec_repr[0].dbasis.n_blocks, "engine": type(mv).__name__,
                "apply_ms": float(np.median(ms)), "apply_ms_min": min(ms),
                "apply_ms_max": max(ms), "apply_ms_samples": ms,
                "peak_bytes": _peak(device)}
            print("repr_block", tag, shift, json.dumps(recs[f"1<<{shift}"]),
                  flush=True)
            del m, mv, x
        out[tag] = recs
    out["contfrac"] = _contfrac(device, quick, shifts)
    return out


def repr_label_section(device, quick):
    from quantum_basis_tpu_torch.ops.apply_repr import LabelBuffer

    out = {}
    for tag, (make, k, q) in REPR_LABEL_CASES.items():
        if quick != q:
            continue
        _free(device)
        m, conserve, vals = make(device)
        dim = m.enumerate_basis_repr(k, conserve, vals)
        mv = m.sec_repr[0].matvec
        x = _rand(dim, device, torch.complex128)
        need = 16 * m.space.label_space
        recs, ys = {}, {}
        for point, bound in (("by_label", need), ("general", need - 1)):
            _free(device)
            with config.pinned(repr_label_buffer_max=bound):
                mv._records.clear()
                rec = mv.record()
            ys[point] = mv(x)
            ms = device_ms_samples(lambda: mv(x), device, samples=7,
                                   per_sample=3)
            recs[point] = {
                "bound": bound, "by_label": rec.by_label,
                "apply_ms": float(np.median(ms)), "apply_ms_samples": ms,
                "label_buffer_bytes": LabelBuffer.held_bytes(),
                "peak_bytes": _peak(device)}
        err = float((ys["by_label"] - ys["general"]).abs().max())
        scale = float(ys["general"].abs().max())
        if not err <= 1e-12 * scale:
            raise AssertionError(f"{tag}: by label vs general {err:.3e}")
        out[tag] = {"dim": dim, "label_space": m.space.label_space,
                    "max_abs_diff": err, **recs}
        print("repr_label", tag, json.dumps(out[tag]), flush=True)
        del m, mv, x, ys, rec
    if not quick:       # every momentum of kagome-24 Sz=0 alive at once
        _free(device)
        m, conserve, vals = kagome24(12)(device)
        ks = [[a, b] for a in range(2) for b in range(4)]
        for sec, k in enumerate(ks):
            m.enumerate_basis_repr(k, conserve, vals, sec=sec)
        xs = [_rand(m.sec_repr[sec].dim, device, torch.complex128)
              for sec in range(len(ks))]
        base = _peak(device)
        t0 = time.perf_counter()
        for _ in range(2):
            for sec in range(len(ks)):
                m.sec_repr[sec].matvec(xs[sec])
        torch.cuda.synchronize()
        out["kagome24_all_k"] = {
            "sectors": len(ks), "dims": [m.sec_repr[s].dim
                                         for s in range(len(ks))],
            "applies_s": time.perf_counter() - t0,
            "peak_before_applies": base, "peak_bytes": _peak(device),
            "label_buffer_bytes": LabelBuffer.held_bytes()}
        print("repr_label kagome24_all_k", json.dumps(
            out["kagome24_all_k"]), flush=True)
        del m, xs
    return out


def lookup_section(device, quick):
    out = {}
    for tag, (make, q) in LOOKUP_CASES.items():
        if quick != q:
            continue
        _free(device)
        m, conserve, vals = make(device)
        dim, enum_s = timed(lambda: m.enumerate_basis_full(conserve, vals),
                            device)
        s = m.sec_full[0]
        labels, space = s.labels, m.space
        work = max(m.compiled_Ham.nnz_per_row, 1)
        recs = {"dim": dim, "label_space": space.label_space,
                "enumerate_s": enum_s}
        for mode in ("direct", "lin", "bsearch"):
            s.dbasis = s.matvec = s.matvec_free = None
            s._fs_cache.clear()
            _free(device)
            idx, t_idx = timed(lambda: BasisIndex(
                labels, space.label_space, mode=mode,
                lin_split=digit_split(space), device=device), device)
            db, t_db = timed(lambda: DeviceBasis(
                space, labels, index=idx, work_per_row=work, device=device),
                device)
            s.dbasis = db
            s.matvec = mv = MatvecFull(m.compiled_Ham, db)
            x = _rand(dim, device)
            apply_ms = device_ms(lambda: mv(x), device, samples=3,
                                 per_sample=1)
            _, t_ell = timed(lambda: m.generate_Ham_sparse_full(check=False),
                             device)
            _, t_solve = timed(lambda: m.locate_E0_lanczos("full",
                                                           maxit=4000),
                               device)
            rec = {"mode": idx.mode, "index_s": t_idx, "basis_s": t_db,
                   "ell_build_s": t_ell, "solve_s": t_solve,
                   "total_s": t_idx + t_db + t_ell + t_solve,
                   "matrix_free_apply_ms": apply_ms,
                   "applies": s.matvec.n_applies,
                   "E0": float(m.eigenvals_full[0]),
                   "peak_bytes": _peak(device)}
            recs[mode] = rec
            print("lookup", tag, mode, json.dumps(rec), flush=True)
            del idx, db, mv, x
        _agree(tag, [recs[k] for k in ("direct", "lin", "bsearch")])
        out[tag] = recs
        del m, s
    return out


def polish_section(device, quick):
    out = {}
    for tag, (make, q) in POLISH_CASES.items():
        if quick != q:
            continue
        recs = {}
        for route, pin in (("thick_restart", INF), ("rqi", 0)):
            with config.pinned(polish_n=pin, mixed_precision=True,
                               fullspace_mixed_max_blowup=INF):
                rec, m = _solve(make, device, "full")
            cache = m.sec_full[0]._fs_cache
            rec["f64_applies"] = cache[torch.float64].n_applies
            rec["f32_applies"] = cache[torch.float32].n_applies
            recs[route] = rec
            print("polish", tag, route, json.dumps(rec), flush=True)
            del m, cache
        _agree(tag, recs.values())
        out[tag] = recs
    return out


def _product_point(pm, ncv, mixed, golden, device):
    rec = solve_sector(pm, ncv=ncv, mixed=mixed)
    rec.pop("solver")
    rec["solve_info"] = dict(pm.solve_info)
    for dt, name in ((torch.float64, "f64_applies"),
                     (torch.float32, "f32_applies")):
        rec[name] = sum(op.n_applies for key, op in pm._ops.items()
                        if key[0] == dt)
    rec["peak_bytes"] = _peak(device)
    if golden is not None and abs(rec["E0"] - golden) > 1e-8:
        raise AssertionError(f"E0 {rec['E0']!r} is not the golden {golden}")
    if not rec["gate_passed"]:
        raise AssertionError(f"residual {rec['residual_f64']!r} over the "
                             f"gate {rec['residual_gate']!r}")
    return rec


def product_section(device, quick):
    out = {}
    for tag, (lx, ly, golden, q) in PRODUCT_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for mixed in (False, True):
            for ncv in PRODUCT_NCV:
                _free(device)
                (pm, _), t_build = timed(
                    lambda: build_factorized(lx, ly, device=device), device)
                rec = _product_point(pm, ncv, mixed, golden, device)
                rec.update(build_s=t_build, mixed=mixed, ncv=ncv)
                name = f"{'mixed' if mixed else 'f64'}_ncv{ncv}"
                recs[name] = rec
                print("product", tag, name, json.dumps(rec), flush=True)
                del pm
        _agree(tag, recs.values())
        out[tag] = recs
    tag = "hubbard4x2" if quick else "hubbard4x4"
    best = min(out[tag].values(), key=lambda r: r["solve_s"])
    mixed, ncv = best["mixed"], best["ncv"]
    lx, ly = PRODUCT_CASES[tag][:2]
    nu, nd = (5, 3) if quick else GAP_SECTOR
    _free(device)
    pm, t_build = timed(lambda: build_factorized_sector(
        lx, ly, nu, nd, device=device), device)
    rec = _product_point(pm, ncv, mixed, None, device)
    rec.update(build_s=t_build, mixed=mixed, ncv=ncv, sector=[nu, nd])
    out[f"{tag}_gap_{nu}_{nd}"] = rec
    print("product gap", json.dumps(rec), flush=True)
    return out


def ckpt_section(device, quick):
    root = os.path.dirname(os.path.abspath(config.ckpt_dir))
    d = tempfile.mkdtemp(prefix="memory_ckpt_", dir=root)
    out = {"dir": root, "save_period_s": _SAVE_PERIOD,
           "share": CKPT_SHARE, "records": {}}
    try:
        out["disk_free_bytes"] = shutil.disk_usage(d).free
        store = CkptStore(d)
        for name, shape, dtype in CKPT_RECORDS[quick]:
            _free(device)
            x = torch.randn(shape, dtype=dtype, device=device)
            complex_vec = x.is_complex()
            nbytes = x.numel() * x.element_size()
            free = shutil.disk_usage(d).free
            if free < 2 * nbytes:
                out["records"][name] = {"bytes": nbytes, "skipped":
                                        f"{free} bytes free"}
                continue

            def save():
                re, im = split_vec(x, complex_vec)
                store.save(name, {"re": re, "im": im})

            def load():
                rec = store.load(name)
                return join_vec(rec["re"], rec["im"], complex_vec, device)

            _, save_s = timed(save, device)
            y, load_s = timed(load, device)
            if not torch.equal(x, y):
                raise AssertionError(f"{name}: the record does not load "
                                     "back equal")
            rec = {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
                   "save_GBps": nbytes / save_s / 1e9,
                   "load_GBps": nbytes / load_s / 1e9}
            out["records"][name] = rec
            print("ckpt", name, json.dumps(rec), flush=True)
            store.delete(name)
            del x, y
        rates = [r["save_GBps"] for r in out["records"].values()
                 if "save_GBps" in r]
        # the cap the rule allows at the slowest measured save rate
        out["cap_by_rule_bytes"] = int(CKPT_SHARE * _SAVE_PERIOD
                                       * min(rates) * 1e9)
    finally:
        shutil.rmtree(d, ignore_errors=True)
    print("ckpt", json.dumps({k: v for k, v in out.items()
                              if k != "records"}), flush=True)
    return out


SECTIONS = {"block": block_section, "repr_block": repr_block_section,
            "repr_label": repr_label_section, "lookup": lookup_section, "polish": polish_section,
            "product": product_section, "ckpt": ckpt_section}


def main(sections=tuple(SECTIONS), quick=False, device="cuda", out=None):
    """Runs the sections; returns the record and writes it to ``out``
    (default ``out_path("MEMORY_torch.json")``) after each section.
    ``quick``: small cases and budgets only (the ones a CPU run can take)."""
    path = out or out_path("MEMORY_torch.json")
    rec = {"device": device_name(device), "memory": dict(
        config.MEMORY[torch.device(device).type])}
    for name in sections:
        rec[name] = SECTIONS[name](device, quick)
        write_json(path, rec)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.sections.split(","), args.quick, args.device, args.out)
