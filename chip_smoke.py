"""End-to-end check of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):
1. a CUDA device must be present; prints the card, its power limit and the
   torch/CUDA versions;
2. builds the BSR SpMV kernel (csrc/bsr_spmv.cu) with nvcc;
3. holds the kernel against its plain PyTorch version on the card, on the
   chain-20 k=0 and kagome t-J k=(0,1) momentum-sector matrices (f32, f64),
   chain-22 k=0 (f32), a matrix with empty row tiles and a diagonal-only
   one; tolerance 1e-12 * max|y| (f64), 1e-5 * max|y| (f32); times both
   (CUDA events, median of 25 samples);
4. drives the momentum-sector ground-state route through Model(...,
   device="cuda"): kagome t-J 2x2 N=8 Sz=0 at all four momenta against the
   reference goldens (1e-8), chain-20 k=0 Sz=0 against the port's pure-f64
   ELL Lanczos (1e-9); asserts that the solves launched the kernel and that
   each f32 bulk engine is a float32 BsrMatrix;
5. prints the kernel record, the card line, and as the last line
   {"ok": true, "device": {...}}.

Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

KAGOME_GOLDEN = {(0, 0): -15.41931496, (0, 1): -14.40277723,
                 (1, 0): -14.40277723, (1, 1): -14.40277723}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, samples=25, per_sample=5):
    """Median per-call device time of fn() in ms (CUDA events)."""
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


def sector_ell(model, momentum, conserve, vals):
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    model.enumerate_basis_repr(momentum, conserve, vals)
    return build_sparse_repr(model.sec_repr[0].matvec)


def kernel_checks(bsr_mod, dev):
    """Phase 3: kernel vs plain version; returns the measured rows."""
    from quantum_basis_tpu_torch.ops.bsr import BsrMatrix, ell_to_bsr
    from quantum_basis_tpu_torch.ops.sparse import EllMatrix
    from torch_zoo import heisenberg_chain, kagome_tj

    mats = []
    m, ops = heisenberg_chain(20, device=dev)
    ell = sector_ell(m, [0], [ops["Sz"]], [0.0])
    mats += [("chain20_k0", ell, torch.float32),
             ("chain20_k0", ell, torch.float64)]
    m, ops = kagome_tj(2, 2, device=dev)
    ell = sector_ell(m, [0, 1], [ops["N"], ops["Sz"]], [8.0, 0.0])
    mats += [("kagome_tj22_k01", ell, torch.float32),
             ("kagome_tj22_k01", ell, torch.float64)]
    m, ops = kagome_tj(2, 2, device=dev)
    ell = sector_ell(m, [0, 0], [ops["N"], ops["Sz"]], [8.0, 0.0])
    mats += [("kagome_tj22_k00", ell, torch.float32)]
    m, ops = heisenberg_chain(22, device=dev)
    ell = sector_ell(m, [0], [ops["Sz"]], [0.0])
    mats += [("chain22_k0", ell, torch.float32)]
    del m
    # one entry in tile (0, 0) of a 5-tile matrix; a diagonal-only matrix
    n = 520
    cols = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    vals = torch.zeros((n, 1), dtype=torch.float64, device=dev)
    cols[3, 0], vals[3, 0] = 7, 2.5
    ell = EllMatrix(cols, vals, torch.arange(n, dtype=torch.float64,
                                             device=dev))
    mats += [("empty_row_tiles", ell, torch.float64)]
    n = 300
    ell = EllMatrix(torch.zeros((n, 0), dtype=torch.int64, device=dev),
                    torch.zeros((n, 0), dtype=torch.float64, device=dev),
                    torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                                   device=dev))
    mats += [("diagonal_only", ell, torch.float64)]

    rng = np.random.default_rng(7)
    rows = []
    for tag, ell, dt in mats:
        bsr = ell_to_bsr(ell, dtype=dt)
        assert isinstance(bsr, BsrMatrix) and bsr.dtype == dt
        comps = [2, 1] if not bsr.is_complex else [2]
        for C in comps:
            x2d = torch.as_tensor(rng.standard_normal((bsr.n_pad, C)),
                                  dtype=dt, device=dev)
            args = (bsr.blocks_re, bsr.blocks_im, bsr.bi, bsr.bj,
                    bsr.row_ptr, x2d)
            yk = bsr_mod.bsr_spmv(*args)
            yp = bsr_mod._bsr_matvec_plain(bsr.blocks_re, bsr.blocks_im,
                                           bsr.bi, bsr.bj, x2d)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            scale = max(float(yp.abs().max()), 1e-300)
            tol = (1e-12 if dt == torch.float64 else 1e-5) * scale
            ms = cuda_ms(lambda: bsr_mod.bsr_spmv(*args))
            plain_ms = cuda_ms(lambda: bsr_mod._bsr_matvec_plain(
                bsr.blocks_re, bsr.blocks_im, bsr.bi, bsr.bj, x2d))
            row = {"case": tag, "dtype": str(dt).replace("torch.", ""),
                   "vector": "complex" if C == 2 else "real",
                   "matrix": "complex" if bsr.is_complex else "real",
                   "n": bsr.n, "n_blocks": bsr.nb,
                   "max_abs_err": err, "max_rel_err": err / scale,
                   "ms": ms, "plain_ms": plain_ms,
                   "stored_GB_per_s": bsr.nb * 128 * 128
                   * torch.finfo(dt).bits / 8
                   * (2 if bsr.is_complex else 1) / (ms * 1e-3) / 1e9}
            print("kernel_check", json.dumps(row), flush=True)
            if not err <= tol:
                raise AssertionError(f"{tag} {dt} C={C}: kernel vs plain "
                                     f"max abs err {err:.3e} > {tol:.3e}")
            rows.append(row)
    return rows


def slice_run(bsr_mod, dev):
    """Phase 4: the ground-state route through the public Model API."""
    from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
    from torch_zoo import heisenberg_chain, kagome_tj, sz_pair, tj_sz

    bsr_mod.launch_count = 0
    results = []
    m, ops = kagome_tj(2, 2, device=dev)
    for sec, k in enumerate(KAGOME_GOLDEN):
        t0 = time.perf_counter()
        dim = m.enumerate_basis_repr(list(k), [ops["N"], ops["Sz"]],
                                     [8.0, 0.0], sec=sec)
        t1 = time.perf_counter()
        m.locate_E0_lanczos(which="repr", sec=sec)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        meas = m.measure_repr_static(tj_sz(0) * tj_sz(1), sec)
        results.append({"model": "kagome_tj_2x2_N8_Sz0", "k": list(k),
                        "dim": dim, "E0": m.eigenvals_repr[0],
                        "golden": KAGOME_GOLDEN[k], "Sz0Sz1": meas.real,
                        "enumerate_s": t1 - t0, "solve_s": t2 - t1,
                        "bsr32": m.sec_repr[sec].bsr32})
    mc, opc = heisenberg_chain(20, device=dev)
    t0 = time.perf_counter()
    dim = mc.enumerate_basis_repr([0], [opc["Sz"]], [0.0])
    t1 = time.perf_counter()
    mc.locate_E0_lanczos(which="repr")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    meas = mc.measure_repr_static(sz_pair(0, 1), 0)
    results.append({"model": "chain20_Sz0", "k": [0], "dim": dim,
                    "E0": mc.eigenvals_repr[0], "Sz0Sz1": meas.real,
                    "enumerate_s": t1 - t0, "solve_s": t2 - t1,
                    "bsr32": mc.sec_repr[0].bsr32})
    launches = bsr_mod.launch_count

    for r in results:
        bsr32 = r.pop("bsr32")
        if bsr32 is None or bsr32.dtype != torch.float32:
            raise AssertionError(f"{r['model']} k={r['k']}: the f32 bulk "
                                 "stage did not route to a float32 BsrMatrix")
        r["bsr_blocks"] = bsr32.nb
        print("slice", json.dumps(r), flush=True)
        if "golden" in r and not abs(r["E0"] - r["golden"]) < 1e-8:
            raise AssertionError(f"kagome k={r['k']}: E0 {r['E0']!r} vs "
                                 f"golden {r['golden']}")
    ref, _ = eigs_smallest(mc._repr_ell(mc.sec_repr[0]), dim, nev=1,
                           ncv=12, complex_vec=True)
    print("chain20 pure-f64 ELL E0", repr(ref[0]), flush=True)
    if not abs(results[-1]["E0"] - ref[0]) < 1e-9:
        raise AssertionError(f"chain-20: E0 {results[-1]['E0']!r} vs "
                             f"f64 ELL {ref[0]!r}")
    if launches <= 0:
        raise AssertionError("the slice never launched the BSR kernel")
    print("bsr_spmv launches in the slice:", launches, flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)

    # the model builders live beside the tests (tests/torch_zoo.py)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    from quantum_basis_tpu_torch.ops import bsr as bsr_mod

    t0 = time.perf_counter()
    bsr_mod.build_library(verbose=True)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)

    dev = "cuda"
    rows = kernel_checks(bsr_mod, dev)
    launches = slice_run(bsr_mod, dev)

    main_row = next(r for r in rows if r["case"] == "kagome_tj22_k00")
    record = {"kernels": [{
        "name": "bsr_spmv",
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "quantum_basis_tpu/ops/pallas_bsr.py:289",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
    }]}
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
