"""The BSR SpMV kernel against the gather ELL on momentum-sector matrices.

The port of ``benchmarks/bsr_bench.py``. For each case it enumerates a real
momentum sector, builds its explicit ELL (complex, float64) and the float32
BSR matrix the explicit route's bulk Krylov stage runs on, times one apply
of each (CUDA events, the median of 15 samples of 5 applies) and checks on
the device that one apply of each agrees (float32 tolerance). From the
measured rates it derives the break-even block fill-in blowup: the BSR
apply streams ``stored = blowup * nnz`` block values while the ELL gathers
once per nonzero, so the BSR wins while ``blowup`` stays below
``bsr_stored_vals_per_s / ell_nnz_per_s``.

Run:  python -m quantum_basis_tpu_torch.benchmarks.bsr_bench [--cases a,b] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from quantum_basis_tpu_torch import Mopr, Opr, TiltedLattice, Model
from quantum_basis_tpu_torch.benchmarks import (device_ms, device_name,
                                                out_path, write_json)

TILTED_A = [[4, 2], [-2, 4]]   # the 20-site tilted square cluster
ALL_CASES = ("chain16_k0", "chain20_k0", "chain22_k0", "kagome_tj22_k00",
             "kagome_tj22_k01", "tilted20_k00", "kagome24_k02")
F32_TOL = 1e-5                 # of max|y|, one float32 apply


def tilted_cosets(A):
    """Coset representatives of Z^2 / A Z^2 (A's rows span the
    superlattice): scan a box, keep coordinates with distinct folded
    values."""
    A = np.asarray(A)
    Ainv = np.linalg.inv(A.astype(float))
    n = int(round(abs(np.linalg.det(A))))
    r = int(np.abs(A).sum())
    seen, out = set(), []
    for x in range(-r, r + 1):
        for y in range(-r, r + 1):
            c = np.array([x, y])
            folded = tuple(c - np.floor(c @ Ainv + 1e-12).astype(int) @ A)
            if folded not in seen:
                seen.add(folded)
                out.append([x, y])
                if len(out) == n:
                    return out
    raise ValueError("failed to enumerate the cosets of A")


def tilted_heisenberg(A, device="cuda"):
    """Spin-1/2 nearest-neighbour Heisenberg model on the tilted square
    cluster with superlattice rows A. Returns (model, total Sz)."""
    from quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half import (
        SM, SP, SZ)

    lat = TiltedLattice(2, 1, np.eye(2), np.asarray(A), [[0.0, 0.0]],
                        [(c, 0) for c in tilted_cosets(A)])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spin-1/2")
    bonds = set()
    for s in range(lat.n_sites):
        coor, sub = lat.site2coor(s)
        for d in ((1, 0), (0, 1)):
            j = lat.coor2site([coor[0] + d[0], coor[1] + d[1]], sub)
            bonds.add((min(s, j), max(s, j)))
    for i, j in sorted(bonds):
        m.add_Ham(0.5 * (Opr(i, 0, False, SP) * Opr(j, 0, False, SM)
                         + Opr(i, 0, False, SM) * Opr(j, 0, False, SP)))
        m.add_Ham(Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ))
    sz = Mopr()
    for s in range(lat.n_sites):
        sz += Opr(s, 0, False, SZ)
    return m, sz


def case_model(tag, device):
    """(model, momentum, conserved operators, values) of a bench case."""
    from quantum_basis_tpu_torch.benchmarks.flagship_kagome24 import (
        build as kagome24)
    from quantum_basis_tpu_torch.examples import chain_heisenberg_spin_half
    from quantum_basis_tpu_torch.examples.kagome_heisenberg_tj import build_tj

    if tag.startswith("chain"):
        m, sz = chain_heisenberg_spin_half.build(int(tag[5:7]), device)
        return m, [0], [sz], [0.0]
    if tag.startswith("kagome_tj22"):
        m, n, sz = build_tj(2, 2, device=device)
        return m, [int(tag[-2]), int(tag[-1])], [n, sz], [8.0, 0.0]
    if tag == "tilted20_k00":
        m, sz = tilted_heisenberg(TILTED_A, device)
        return m, [0, 0], [sz], [0.0]
    if tag == "kagome24_k02":
        m, sz = kagome24(2, 4, device=device)
        return m, [0, 2], [sz], [0.0]
    raise ValueError(f"unknown case {tag!r}")


def bench_case(tag, device):
    from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats, ell_to_bsr
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    m, k, conserve, vals = case_model(tag, device)
    m.enumerate_basis_repr(k, conserve, vals)
    ell = build_sparse_repr(m.sec_repr[0].matvec)
    st = bsr_fill_stats(ell)
    n = ell.n
    nnz = st["nnz"] + n  # + the diagonal
    bsr = ell_to_bsr(ell, dtype=torch.float32)
    gen = torch.Generator(device=device).manual_seed(3)
    x = torch.complex(torch.randn(n, dtype=torch.float64, device=device,
                                  generator=gen),
                      torch.randn(n, dtype=torch.float64, device=device,
                                  generator=gen))
    x32 = x.to(torch.complex64)
    y_ell, y_bsr = ell(x), bsr(x32)
    scale = float(y_ell.abs().max())
    err = float((y_bsr.to(torch.complex128) - y_ell).abs().max())
    if not err <= F32_TOL * scale:
        raise AssertionError(f"{tag}: BSR f32 and ELL differ by {err:.3e} "
                             f"(max|y| {scale:.3e})")
    t_ell = device_ms(lambda: ell(x), device) * 1e-3
    t_bsr = device_ms(lambda: bsr(x32), device) * 1e-3
    rec = {
        "workload": tag, "dim": n, "nnz": nnz, "ell_width": ell.width,
        "blowup": st["blowup"], "n_blocks": st["n_blocks"],
        "bsr_stored_bytes": st["stored"] * 4 * 2,
        "ell_us_per_apply": t_ell * 1e6, "bsr_us_per_apply": t_bsr * 1e6,
        "ell_nnz_per_s": nnz / t_ell, "bsr_nnz_per_s": nnz / t_bsr,
        "bsr_stored_vals_per_s": (st["stored"] + n) / t_bsr,
        "bsr_dtype": "float32", "ell_dtype": "complex128",
        "agree_max_rel_diff": err / max(scale, 1e-30),
        "winner": "bsr" if t_bsr < t_ell else "ell",
    }
    print(json.dumps(rec), flush=True)
    return rec


def main(cases=ALL_CASES, device="cuda", out=None):
    """Returns the record (cases and the calibration) and writes it to
    ``out`` (default ``out_path("BSR_BENCH_torch.json")``)."""
    rec = {"device": device_name(device), "cases": []}
    for tag in cases:
        rec["cases"].append(bench_case(tag, device))
    stream = max(c["bsr_stored_vals_per_s"] for c in rec["cases"])
    gather = max(c["ell_nnz_per_s"] for c in rec["cases"])
    rec["calibration"] = {"bsr_stream_vals_per_s": stream,
                          "ell_gather_nnz_per_s": gather,
                          "breakeven_blowup": stream / gather}
    write_json(out or out_path("BSR_BENCH_torch.json"), rec)
    print(json.dumps(rec["calibration"]), flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", default=",".join(ALL_CASES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.cases.split(","), args.device, args.out)
