"""The momentum-sector kernels of one tree of the package, timed at the two
sectors the main path times, so that two trees can be run in turns on one
card.

At kagome-24 Sz=0 k=(0,2) (dim 338,356, G = 8) and chain-24 Sz=0 k=0 (dim
112,720, G = 24): ``repr_rows`` through the sector's ``MatvecRepr`` and
``repr_scatter`` of H from the sector into itself (f64 atomics) as the
tree's ``mopr_x_vec_repr`` runs it: through a launch record built once
(``ops/apply_repr.py::scatter_launch``) where the tree has one, else
through its ``repr_scatter`` function. Each is checked against its plain
version (1e-12 of max|y|; the scatter within 4x the spread of two kernel
runs where wider) and timed by CUDA events (median of 9 samples of 3
calls), by ``torch.profiler`` (the device time of the kernels the call
launches, without the wrapper) and by the host clock (one call's enqueue,
the mean of 200). One JSON line a sector, tagged with ``--tag`` and the
card's name and power limit; the records also go to ``--out``.

Run:  python -m quantum_basis_tpu_torch.benchmarks.repr_turns [--tag NAME] [--out PATH]

Another tree (a parent commit unpacked in DIR): ``cd DIR && PYTHONPATH=.
python <this file> --tag parent --out PATH``; the models come from
``tests/torch_zoo.py`` of the working directory's tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SECTORS = (("kagome24_k02", "kagome", (0, 2)), ("chain24_k0", "chain", (0,)))


def _events_ms(fn, samples=9, per_sample=3):
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return float(np.median(times))


def _device_ms(fn, tag, reps=5, windows=3):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = [e.self_device_time_total / 1e3 / e.count
              for e in prof.key_averages()
              if e.device_type != DeviceType.CPU and tag in e.key]
        if ms:                          # every kernel the tag names
            return sum(ms)
    return None                         # not measured


def _host_ms(fn, calls=200):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def _times(fn, tag):
    return {"ms": _events_ms(fn), "device_ms": _device_ms(fn, tag),
            "host_ms": _host_ms(fn)}


def _check(what, got, want, spread=0.0):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = max(1e-12 * float(want.abs().max()), 4.0 * spread)
    print(f"check {what}: {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel vs plain {err:.3e} > {tol:.3e}")


def sector(name, kind, k):
    from torch_zoo import heisenberg_chain, kagome_heisenberg

    from quantum_basis_tpu_torch.ops import apply_repr as ar

    m, ops = (kagome_heisenberg(2, 4, device="cuda") if kind == "kagome"
              else heisenberg_chain(24, device="cuda"))
    m.enumerate_basis_repr(list(k), [ops["Sz"]], [0.0])
    mv = m.sec_repr[0].matvec
    rb = mv.basis
    n = mv.n
    args = mv.args()
    g = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(n, dtype=torch.complex128, device="cuda", generator=g)
    rec = {"case": name, "dim": n, "G": rb.tset.G}
    _check(f"{name} repr_rows", mv(x), ar._repr_rows_plain(*args, x))
    rec["repr_rows"] = _times(lambda: mv(x), "repr_rows_kernel")
    ph = ar.phase_table(rb.tset, rb.momentum, +1)
    sargs = args[:8] + (ph,)
    zp = ar._repr_scatter_plain(*sargs, x, n)
    if hasattr(ar, "scatter_launch"):
        srec = ar.scatter_launch(m.compiled_Ham, rb, rb)

        def scatter():
            return srec(x)
    else:
        def scatter():
            return ar.repr_scatter(*sargs, x, n)
    z1, z2 = scatter(), scatter()
    torch.cuda.synchronize()
    spread = float((z1 - z2).abs().max())
    _check(f"{name} repr_scatter (H)", z1, zp, spread)
    rec["scatter_spread"] = spread
    rec["repr_scatter"] = _times(scatter, "repr_scatter_kernel")
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("repr_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from quantum_basis_tpu_torch.ops import apply_repr as ar

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    t0 = time.perf_counter()
    ar.build_library()
    build_s = time.perf_counter() - t0
    rows = []
    for name, kind, k in SECTORS:
        rec = sector(name, kind, k)
        rec.update(tag=a.tag, card=card, build_s=build_s)
        print("repr_turns", json.dumps(rec), flush=True)
        rows.append(rec)
        torch.cuda.empty_cache()
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "a") as f:
            for rec in rows:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
