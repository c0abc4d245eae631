"""Where one thick-restart cycle's time goes on the card.

A ``torch.profiler`` window over the Krylov steps of ``eigs_smallest``
(``solvers/restarted.py::_Krylov``: ``expand`` from row ``keep`` to ``ncv``,
then ``compact``) at two main-path shapes, split into

- the operator's applies (kernels named ``kron_ell`` or ``apply_rows``);
- the basis work: the K6 kernels (``krylov_*``, ``ops/krylov.py``), or, in a
  tree without them, the torch CGS2's matrix-vector products (cuBLAS
  ``gemv`` / ``dot`` kernels, with their achieved GB/s), the compaction's
  matrix product (``gemm``) and the elementwise and reduction kernels;
- copies and fills;
- the device's idle gaps, each credited to the top-level host op that ran
  during it (what is left, to the Python around the ops).

Cases: ``hubbard4x4``, the float32 ``KronOp`` of the Hubbard 4x4 half-filled
sector (dim 165,636,900; ncv = the device's ``product_ncv``, 12 on the
card), ``chain24``, the float64 matrix-free apply of the Heisenberg chain
L = 24 Sz = 0 (dim 2,704,156; ncv 12, as ``Model.locate_E0_lanczos``). A
case runs a first cycle from one start vector (warm-up), a second timed by
the host clock, and a third traced; ``compact`` takes a random orthonormal
(ncv + 1, keep) matrix, keep 3 the shape of a restart at nev = 1 (its values
do not change the cost). ``--shapes NCV:KEEP,...`` sets the cycles'
shapes, one cycle record each (a restart at nev >= 2 keeps 2 nev;
``locate_E0_lanczos`` takes ncv = max(12, 2 nev + 6)). Each K6 kernel's device time and launches in the
traced cycle are recorded by name, and the compaction of that shape is
timed alone (CUDA events, median of 7) beside one GEMM S^T V[:ncv], its
product. With ``--solve`` each case's whole solve is timed as well:
``ProductModel.locate_E0_lanczos`` with its ``solve_info`` (``f32_stage_s``,
``polish_s``, the applies of both precisions; beside it the host time of the
f32 stage's start vector), and the chain's
``locate_E0_lanczos("full")`` with its applies.

Run:  python -m quantum_basis_tpu_torch.benchmarks.krylov_trace [--cases hubbard4x4,chain24] [--shapes NCV:KEEP,...] [--solve] [--out PATH]

To trace another tree of the package (a parent commit unpacked in DIR):
``cd DIR && PYTHONPATH=. python <this file> ...``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.benchmarks import card_line, out_path, write_json
from quantum_basis_tpu_torch.solvers import restarted

APPLY_KERNELS = ("kron_ell", "apply_rows")
GEMV_KERNELS = ("gemv", "dot_kernel", "reduce_1Block")
GEMM_KERNELS = ("gemm", "splitKreduce")
KEEP = 3   # Ritz vectors a restart keeps at nev = 1: nev + max(2, nev)
K6 = ("krylov_project", "krylov_subtract_project", "krylov_subtract_norm",
      "krylov_scale", "krylov_compact")


def _kind(name: str) -> str:
    if any(k in name for k in APPLY_KERNELS):
        return "apply"
    if "krylov" in name:
        return "k6"
    if "Memcpy" in name or "Memset" in name:
        return "copy"
    if any(k in name for k in GEMV_KERNELS):
        return "gemv"
    if any(k in name for k in GEMM_KERNELS):
        return "gemm"
    return "elementwise"


def _launches():
    """The K6 kernels' launches so far, or None in a tree without them."""
    try:
        from quantum_basis_tpu_torch.ops import krylov
    except ImportError:
        return None
    return dict(krylov.launches)


def _split(prof) -> dict:
    """Device time by kind, the idle gaps and what the host did in them."""
    from torch.autograd import DeviceType

    evs = prof.events()
    kern = sorted((e for e in evs if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    if not kern:
        raise AssertionError("the profiler recorded no device time")
    host = [e for e in evs if e.device_type == DeviceType.CPU
            and e.cpu_parent is None]
    start = min(e.time_range.start for e in evs)
    end = max(e.time_range.end for e in evs)
    by_kind, names, k6 = {}, {}, {}
    busy = 0.0
    for e in kern:
        us = e.time_range.end - e.time_range.start
        k = _kind(e.name)
        by_kind.setdefault(k, [0.0, 0])
        by_kind[k][0] += us
        by_kind[k][1] += 1
        names[e.name[:60]] = names.get(e.name[:60], 0.0) + us
        for name in K6:
            if name + "<" in e.name or e.name.startswith(name):
                k6.setdefault(name, [0.0, 0])
                k6[name][0] += us / 1e3
                k6[name][1] += 1
        busy += us
    # the gaps between consecutive kernels, credited to the host ops that
    # overlap them
    gaps, credit = 0.0, {}
    for a, b in zip(kern, kern[1:]):
        g0, g1 = a.time_range.end, b.time_range.start
        if g1 <= g0:
            continue
        gaps += g1 - g0
        left = g1 - g0
        for h in host:
            ov = min(g1, h.time_range.end) - max(g0, h.time_range.start)
            if ov > 0:
                credit[h.name] = credit.get(h.name, 0.0) + ov
                left -= ov
        if left > 0:
            credit["(python between ops)"] = (
                credit.get("(python between ops)", 0.0) + left)
    window = end - start
    top = sorted(credit.items(), key=lambda kv: -kv[1])[:8]
    return {
        "window_ms": window / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1.0 - busy / window,
        "gaps_ms": gaps / 1e3,
        # idle between the first and the last kernel (the window's edges,
        # the profiler's own start and stop, left out)
        "gap_share": gaps / (busy + gaps),
        "by_kind_ms": {k: v[0] / 1e3 for k, v in by_kind.items()},
        "by_kind_kernels": {k: v[1] for k, v in by_kind.items()},
        # each K6 kernel's [device ms, launches] in the window
        "k6_kernels_ms": k6,
        "gaps_by_host_op_ms": {k: v / 1e3 for k, v in top},
        "top_kernels_ms": {k: v / 1e3 for k, v in sorted(
            names.items(), key=lambda kv: -kv[1])[:8]},
    }


def _orthonormal(rows: int, m: int, keep: int, seed: int) -> np.ndarray:
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal(
        (m, keep)))
    s = np.zeros((rows, keep))
    s[:m] = q
    return s


def _events_ms(fn, samples=7) -> float:
    """The median of ``samples`` CUDA-event times of one call of fn."""
    fn()
    out = []
    for _ in range(samples):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return float(np.median(out))


def cycle_case(tag, op, n, ncv, keep, device) -> dict:
    """Three restart cycles on ``op`` (warm-up, host-timed, traced) that
    expand rows keep..ncv and compact to keep; then the compaction alone
    beside the GEMM."""
    from torch.profiler import ProfilerActivity, profile

    kry = restarted._Krylov(op, n, ncv, False)
    x = restarted._random_start(op, n, 1, False, kry.V.device)
    kry.V[0] = restarted._projected(op, x, getattr(op, "mask", None)).to(
        kry.dtype)
    del x
    S = _orthonormal(ncv + 1, ncv, keep, 7)

    def one(m0):
        kry.expand(m0, ncv)
        kry.compact(S, ncv)

    one(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one(keep)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one(keep)
        torch.cuda.synchronize()
    after = _launches()
    steps = ncv - keep
    s = kry.V.element_size()
    rec = {"case": tag, "card": card_line(device), "dim": n, "ncv": ncv,
           "keep": keep, "dtype": str(kry.dtype), "steps": steps,
           "rows_projected": [keep + 1, ncv], "cycle_host_ms": host_ms,
           "step_host_ms": host_ms / steps}
    rec.update(_split(prof))
    # the compaction alone (its cost does not depend on V's values), and
    # the GEMM of its product
    from quantum_basis_tpu_torch.ops import krylov

    Sd = torch.as_tensor(S[:ncv], device=kry.V.device).to(kry.dtype)
    St = Sd.T.contiguous()
    rec["compact_ms"] = _events_ms(
        lambda: krylov.krylov_compact(kry.V, Sd, ncv))
    rec["gemm_ms"] = _events_ms(lambda: St @ kry.V[:ncv])
    del Sd, St
    rs = range(keep + 1, ncv + 1)
    # the bytes each design must move in this cycle's steps
    rec["torch_gemv_bytes"] = sum(4 * (r + 1) * n * s for r in rs)
    rec["k6_bytes"] = (sum((3 * r + 7) * n * s for r in rs)
                       + (ncv + 1 + ncv + 1) * n * s)
    gemv_ms = rec["by_kind_ms"].get("gemv")
    if gemv_ms:
        rec["gemv_GBps"] = rec["torch_gemv_bytes"] / gemv_ms / 1e6
    k6_ms = rec["by_kind_ms"].get("k6")
    if k6_ms:
        rec["k6_GBps"] = rec["k6_bytes"] / k6_ms / 1e6
    if before is not None:
        rec["k6_launches"] = {k: after[k] - before[k] for k in after}
    apply_ms = rec["by_kind_ms"].get("apply", 0.0)
    rec["outside_apply_step_ms"] = (host_ms / steps
                                    - apply_ms / steps)
    del kry
    torch.cuda.empty_cache()
    return rec


def hubbard4x4(device, solve, shapes=None) -> list:
    from quantum_basis_tpu_torch.benchmarks import hubbard4x4 as h44
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized)

    pm, _ = build_factorized(4, 4, device=device)
    op = pm.op(torch.float32)
    out = []
    for ncv, keep in shapes or [(config.memory("product_ncv", device),
                                 KEEP)]:
        out.append(cycle_case("hubbard4x4 f32 KronOp", op, op.N, ncv, keep,
                              device))
        print("krylov_trace", json.dumps(out[-1]), flush=True)
    if solve:
        # the host's share of the f32 stage: its start vector (a Lehmer
        # stream over all 165,636,900 entries, made on the host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restarted._random_start(op, op.N, 1, False, op.device)
        torch.cuda.synchronize()
        start_s = time.perf_counter() - t0
        pm._ops.clear()
        torch.cuda.empty_cache()
        n0 = _launches()
        rec = h44.solve_sector(pm)
        n1 = _launches()
        rec = {"case": "hubbard4x4 solve", "card": card_line(device),
               "E0": rec["E0"], "solve_s": rec["solve_s"],
               "applies": rec["applies"], "solver": rec["solver"],
               "residual_f64": rec["residual_f64"],
               "start_vector_s": start_s}
        if n0 is not None:
            rec["k6_launches"] = {k: n1[k] - n0[k] for k in n1}
        out.append(rec)
        print("krylov_trace", json.dumps(rec), flush=True)
    del pm, op
    torch.cuda.empty_cache()
    return out


def chain24(device, solve, shapes=None) -> list:
    from quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half import (
        build)

    m, sz = build(24, device=device)
    m.enumerate_basis_full([sz], [0.0])
    mv = m.sec_full[0].matvec
    if type(mv).__name__ != "MatvecFull" or m._fullspace_op(m.sec_full[0]):
        raise AssertionError("chain24: the sector is not on MatvecFull")
    out = []
    for ncv, keep in shapes or [(12, KEEP)]:
        out.append(cycle_case("chain24 f64 MatvecFull", mv, mv.n, ncv, keep,
                              device))
        print("krylov_trace", json.dumps(out[-1]), flush=True)
    if solve:
        n0, a0 = _launches(), mv.n_applies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.locate_E0_lanczos("full", maxit=4000)
        torch.cuda.synchronize()
        rec = {"case": "chain24 solve", "card": card_line(device),
               "E0": m.eigenvals_full[0],
               "solve_s": time.perf_counter() - t0,
               "applies": mv.n_applies - a0}
        if n0 is not None:
            n1 = _launches()
            rec["k6_launches"] = {k: n1[k] - n0[k] for k in n1}
        out.append(rec)
        print("krylov_trace", json.dumps(rec), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cases", default="hubbard4x4,chain24")
    ap.add_argument("--shapes", default=None,
                    help="NCV:KEEP,... (default: the case's ncv, keep 3)")
    ap.add_argument("--solve", action="store_true")
    ap.add_argument("--out", default=out_path("krylov_trace.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("krylov_trace: no CUDA device (it traces the card)")
    shapes = ([tuple(int(v) for v in sh.split(":"))
               for sh in args.shapes.split(",")] if args.shapes else None)
    recs = []
    for case in args.cases.split(","):
        recs += {"hubbard4x4": hubbard4x4, "chain24": chain24}[case](
            "cuda", args.solve, shapes)
    write_json(args.out, recs)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
