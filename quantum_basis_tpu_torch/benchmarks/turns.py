"""One tree of the package timed at full width on the card, so that two
trees can be run in turns on one card: its momentum-sector kernels
(section ``repr``), its explicit ELL builds (section ``ell``) or its ELL
apply (section ``spmv``).

``repr``: at kagome-24 Sz=0 k=(0,2) (dim 338,356, G = 8) and chain-24 Sz=0
k=0 (dim 112,720, G = 24), ``repr_rows`` through the sector's
``MatvecRepr`` and ``repr_scatter`` of H from the sector into itself (f64
atomics) through its launch record (``ops/apply_repr.py::scatter_launch``).
Each is checked against its plain version (1e-12 of max|y|; the scatter
within 4x the spread of two kernel runs where wider) and timed by CUDA
events (median of 9 samples of 3 calls), by ``torch.profiler`` (the device
time of the kernels a call launches, without the wrapper) and by the host
clock (one call's enqueue, the mean of 200).

``ell``: ``build_sparse_repr`` at the same two momentum sectors and
``build_sparse_full`` at chain-24 Sz=0 and kagome-24 Sz=0 (dim 2,704,156)
and chain-26 Sz=0 (dim 10,400,600): each build's seconds (the host clock
around a build, the device drained before and after; three builds), its
peak device bytes above what was held before, the device time a build of
the kernels named ``repr_images_kernel`` or ``ell_rows_kernel``
(``torch.profiler``, every launch of a build summed; absent in a tree
whose build runs no such kernel), the ELL's width, and a CRC32 of its
columns (equal columns in two trees, equal checksums; taken over the int64
view, so that a tree of int64 columns and one of int32 compare).

``spmv``: the ELL apply ``EllMatrix.__call__`` (``ell_spmv``) at the
sectors of ``chip_smoke.py``'s phase 22: the two momentum sectors above
(a complex x), chain-24 and kagome-24 Sz=0 (a real and a complex x), the
Holstein chain's ``MatvecVrnl`` at depth 14, k = 1/4 (complex), and
chain-24 Sz=0's diagonal alone (W = 0, a real x). Each matrix as the tree
builds it, checked against the tree's plain version (1e-12 of max|y|),
timed as ``repr``'s kernels are (CUDA events, the ``ell_spmv_kernel``
launches' device time, the host clock over 200 calls), with its width,
columns' type, the kernel's group size where the tree chooses one, and
the CRC32 of its columns (int64 view).

One JSON line a sector, tagged with ``--tag`` and the card's name and power
limit; the records also go to ``--out``.

Run:  python -m quantum_basis_tpu_torch.benchmarks.turns {repr,ell,spmv} [--tag NAME] [--out PATH]

Another tree (a parent commit unpacked in DIR): ``cd DIR && PYTHONPATH=.
python <this file> SECTION --tag parent --out PATH``; the models come from
``tests/torch_zoo.py`` of the working directory's tree.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

MOMENTA = (("kagome24_k02", "kagome", (0, 2)), ("chain24_k0", "chain24", (0,)))
FULL = (("chain24_Sz0", "chain24", None), ("kagome24_Sz0", "kagome", None),
        ("chain26_Sz0", "chain26", None))


def _model(kind, k):
    """The sector's matvec: a momentum sector's ``MatvecRepr`` (k given),
    else the Sz=0 sector's ``MatvecFull``."""
    from torch_zoo import heisenberg_chain, kagome_heisenberg

    from quantum_basis_tpu_torch.ops.apply import MatvecFull

    m, ops = (kagome_heisenberg(2, 4, device="cuda") if kind == "kagome"
              else heisenberg_chain(26 if kind == "chain26" else 24,
                                    device="cuda"))
    if k is not None:
        m.enumerate_basis_repr(list(k), [ops["Sz"]], [0.0])
        return m, m.sec_repr[0].matvec
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    return m, (sec.matvec if isinstance(sec.matvec, MatvecFull)
               else MatvecFull(m.compiled_Ham, sec.dbasis))


def _device_ms(fn, tags, reps=5, windows=3):
    """Device ms a call of ``fn`` of the kernels whose names hold one of
    ``tags`` (every launch of a call summed), or None (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = [e.self_device_time_total / 1e3 / reps
              for e in prof.key_averages()
              if e.device_type != DeviceType.CPU
              and any(t in e.key for t in tags)]
        if ms:
            return sum(ms)
    return None


# --------------------------------------------------------------------------
# repr: the momentum-sector kernels
# --------------------------------------------------------------------------


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
    return {"ms": _events_ms(fn), "device_ms": _device_ms(fn, (tag,)),
            "host_ms": _host_ms(fn)}


def _check(what, got, want, spread=0.0):
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    tol = max(1e-12 * float(want.abs().max()), 4.0 * spread)
    print(f"check {what}: {err:.3e} (tol {tol:.3e})", flush=True)
    if not err <= tol:
        raise AssertionError(f"{what}: kernel vs plain {err:.3e} > {tol:.3e}")


def repr_case(name, kind, k):
    from quantum_basis_tpu_torch.ops import apply_repr as ar

    m, mv = _model(kind, k)
    rb = mv.basis
    n = mv.n
    args = mv.args()
    g = torch.Generator(device="cuda").manual_seed(20)
    x = torch.randn(n, dtype=torch.complex128, device="cuda", generator=g)
    rec = {"case": name, "dim": n, "G": rb.tset.G}
    _check(f"{name} repr_rows", mv(x), ar._repr_rows_plain(*args, x))
    rec["repr_rows"] = _times(lambda: mv(x), "repr_rows_kernel")
    ph = ar.phase_table(rb.tset, rb.momentum, +1)
    zp = ar._repr_scatter_plain(*(args[:8] + (ph,)), x, n)
    srec = ar.scatter_launch(m.compiled_Ham, rb, rb)
    z1, z2 = srec(x), srec(x)
    torch.cuda.synchronize()
    spread = float((z1 - z2).abs().max())
    _check(f"{name} repr_scatter (H)", z1, zp, spread)
    rec["scatter_spread"] = spread
    rec["repr_scatter"] = _times(lambda: srec(x), "repr_scatter_kernel")
    return rec


# --------------------------------------------------------------------------
# ell: the explicit ELL builds
# --------------------------------------------------------------------------


def _build_timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated() - base)


def ell_case(name, kind, k):
    from quantum_basis_tpu_torch.ops.sparse import (build_sparse_full,
                                                    build_sparse_repr)

    _, mv = _model(kind, k)
    build = ((lambda: build_sparse_full(mv)) if k is None
             else (lambda: build_sparse_repr(mv)))
    rec = {"case": name, "dim": mv.n, "s": [], "peak_bytes": []}
    for _ in range(3):
        ell, t, peak = _build_timed(build)
        rec["s"].append(t)
        rec["peak_bytes"].append(peak)
    rec["W"] = ell.width
    # over the int64 view, so that trees that store int32 and int64
    # columns compare
    rec["cols_crc32"] = zlib.crc32(
        ell.cols.cpu().numpy().astype(np.int64).tobytes())
    del ell
    rec["device_ms"] = _device_ms(
        build, ("repr_images_kernel", "ell_rows_kernel"), reps=3)
    return rec


# --------------------------------------------------------------------------
# spmv: the ELL apply
# --------------------------------------------------------------------------


SPMV = MOMENTA + FULL[:2] + (("vrnl_holstein16_k1/4", "vrnl", None),
                             ("diagonal_only", "chain24", None))


def _vrnl_matrix():
    """The Holstein chain's MatvecVrnl (L = 16, Nmax = 3, depth 14, k =
    1/4: dim 28,956), chip_smoke.py's phase-11 sector."""
    from torch_zoo import holstein_chain

    from quantum_basis_tpu_torch.ops.apply_vrnl import MatvecVrnl

    m, ops = holstein_chain(16, 3, device="cuda")
    seed = int(m.space.strides[m.space.slot(8, 0)])
    m.build_basis_vrnl([seed], 0, [0.0], [0.0], 14, [ops["N_e"]], [1.0])
    m.generate_Ham_sparse_vrnl(0)
    return MatvecVrnl(m.sec_vrnl[0].vmat, [0.25])


def spmv_case(name, kind, k):
    from quantum_basis_tpu_torch.ops.sparse import (EllMatrix,
                                                    _ell_spmv_plain,
                                                    build_sparse_full,
                                                    build_sparse_repr)

    if kind == "vrnl":
        ell = _vrnl_matrix()
    else:
        _, mv = _model(kind, k)
        ell = build_sparse_full(mv) if k is None else build_sparse_repr(mv)
        del mv
    if name == "diagonal_only":
        n = ell.n
        ell = EllMatrix(torch.zeros((n, 0), dtype=torch.int64, device="cuda"),
                        torch.zeros((n, 0), dtype=torch.float64,
                                    device="cuda"), ell.diag)
    rec = {"case": name, "dim": ell.n, "W": ell.width,
           "cols_dtype": str(ell.cols.dtype),
           "cols_crc32": zlib.crc32(
               ell.cols.cpu().numpy().astype(np.int64).tobytes())}
    vecs = (("complex",) if ell.is_complex or kind == "vrnl"
            else ("real",) if name == "diagonal_only"
            else ("real", "complex"))
    g = torch.Generator(device="cuda").manual_seed(21)
    for v in vecs:
        x = torch.randn(ell.n, dtype=torch.complex128 if v == "complex"
                        else torch.float64, device="cuda", generator=g)
        _check(f"{name} {v} x", ell(x),
               _ell_spmv_plain(ell.cols, ell.vals, ell.diag, x, x))
        rec[v] = _times(lambda: ell(x), "ell_spmv_kernel")
    launch = getattr(ell, "_launch", None)
    rec["group"] = getattr(launch, "group", None)
    return rec


SECTIONS = {"repr": (repr_case, MOMENTA), "ell": (ell_case, MOMENTA + FULL),
            "spmv": (spmv_case, SPMV)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("section", choices=sorted(SECTIONS))
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("turns: no CUDA device", file=sys.stderr)
        return 1
    # the models come from tests/torch_zoo.py of the working directory
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    run, cases = SECTIONS[a.section]
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    for name, kind, k in cases:
        rec = {"tag": a.tag, "card": card, "section": a.section,
               **run(name, kind, k)}
        line = json.dumps(rec)
        print("turns", line, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
