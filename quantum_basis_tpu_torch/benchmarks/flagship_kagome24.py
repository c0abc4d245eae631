"""The 24-site kagome Heisenberg antiferromagnet, solved two ways.

The port of ``benchmarks/flagship_kagome24.py``: the spin-1/2
nearest-neighbour Heisenberg model on a 2x4-cell kagome lattice (24 sites),
Sz = 0 sector (dim C(24,12) = 2,704,156), solved

1. in the full sector, mixed precision on the full-label-space engines
   (float32 window contractions, float64 polish), and
2. in every momentum sector of the 2x4 Brillouin zone, on whichever engine
   the device's routing bounds choose (recorded per sector).

Checks enforced here: sum_k dim(k) == dim(full) (resolution of identity over
sectors); min_k E0(k) == E0(full) to 1e-10 (two independent algorithms); at
2x4, E0(full) = -10.759897248084 to 1e-8. The ground-state momentum is a
result: for this cluster it sits at k=(0,2), so E0(k=0) == E0(full) is
reported, not required.

Run:  python -m quantum_basis_tpu_torch.benchmarks.flagship_kagome24 [--lx 2 --ly 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from quantum_basis_tpu_torch import Lattice, Model, Mopr, Opr, config
from quantum_basis_tpu_torch.benchmarks import (device_name, out_path,
                                                write_json)
from quantum_basis_tpu_torch.examples import solve

SZ = np.array([0.5, -0.5])
SP = np.array([[0.0, 1.0], [0.0, 0.0]])
SM = SP.T.copy()
E0_2X4 = -10.759897248084   # FLAGSHIP_kagome24.json

# (sub_i, sub_j, cell displacement of j): the kagome NN bond set of the
# reference examples (examples/*/latt_kagome/kagome_Heisenberg_spin_half.cc)
KAGOME_BONDS = [
    (0, 2, (1, 0)), (0, 2, (0, 0)),
    (1, 0, (0, 1)), (1, 0, (0, 0)),
    (2, 1, (-1, -1)), (2, 1, (0, 0)),
]


def build(Lx, Ly, device="cuda"):
    lat = Lattice("kagome", [Lx, Ly], ["pbc", "pbc"])
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "spin-1/2")
    for x in range(Lx):
        for y in range(Ly):
            for si, sj, (dx, dy) in KAGOME_BONDS:
                i = lat.coor2site([x, y], si)
                j = lat.coor2site([x + dx, y + dy], sj)
                m.add_Ham(0.5 * (Opr(i, 0, False, SP) * Opr(j, 0, False, SM)
                                 + Opr(i, 0, False, SM) * Opr(j, 0, False, SP)))
                m.add_Ham(Opr(i, 0, False, SZ) * Opr(j, 0, False, SZ))
    Sz_tot = Mopr()
    for s in range(lat.n_sites):
        Sz_tot += Opr(s, 0, False, SZ)
    return m, Sz_tot


def main(lx=2, ly=4, maxit=4000, device="cuda", out=None, ckpt_dir=None):
    """Returns the record; writes it to ``out`` (default
    ``out_path("FLAGSHIP_kagome24_torch.json")``). ``ckpt_dir``: checkpoint
    every solve stage there, so a rerun resumes past finished sectors."""
    old = (config.mixed_precision, config.enable_ckpt, config.ckpt_dir)
    config.mixed_precision = True
    if ckpt_dir:
        config.enable_ckpt, config.ckpt_dir = True, ckpt_dir
    try:
        return _run(lx, ly, maxit, device, out)
    finally:
        config.mixed_precision, config.enable_ckpt, config.ckpt_dir = old


def _run(lx, ly, maxit, device, out):
    rows = []
    t_all = time.perf_counter()
    m, Sz = build(lx, ly, device)
    t0 = time.perf_counter()
    dim_full = m.enumerate_basis_full([Sz], [0.0])
    t_enum = time.perf_counter() - t0
    print(f"full Sz=0 sector dim = {dim_full}  (enumerate {t_enum:.3f} s)",
          flush=True)
    E0_full = solve(rows, m, "full Sz=0", nev=1, ncv=1, maxit=maxit)
    print(f"E0(full) = {E0_full:.12f}", flush=True)
    del m

    sectors = []
    mk, Szk = build(lx, ly, device)
    for kx in range(lx):
        for ky in range(ly):
            t0 = time.perf_counter()
            dim_k = mk.enumerate_basis_repr([kx, ky], [Szk], [0.0])
            t_enum_k = time.perf_counter() - t0
            e0k = solve(rows, mk, f"k=({kx},{ky})", "repr", maxit=maxit)
            sectors.append({"k": [kx, ky], "dim": int(dim_k), "E0": e0k,
                            "engine": rows[-1]["engine"],
                            "enum_s": t_enum_k, "solve_s": rows[-1]["s"]})
            print(f"E0(k=({kx},{ky})) = {e0k:.12f}  dim {dim_k}", flush=True)

    sum_dims = sum(s["dim"] for s in sectors)
    e0_min = min(s["E0"] for s in sectors)
    k_gs = min(sectors, key=lambda s: s["E0"])["k"]
    e0_k0 = next(s["E0"] for s in sectors if s["k"] == [0, 0])
    tol = 1e-10 * max(1.0, abs(E0_full))
    checks = {"sum_dims": sum_dims == dim_full,
              "min_k_matches_full_1e-10": abs(e0_min - E0_full) < tol,
              "k0_matches_full_1e-10": abs(e0_k0 - E0_full) < tol,
              "gs_momentum": k_gs}
    if (lx, ly) == (2, 4):
        checks["golden_1e-8"] = abs(E0_full - E0_2X4) < 1e-8
    print(f"sum_k dim = {sum_dims} vs full {dim_full}; "
          f"min_k E0 - E0(full) = {e0_min - E0_full:.3e} at k={k_gs}",
          flush=True)
    rec = {
        "workload": f"kagome_heisenberg_{lx}x{ly}_Sz0",
        "n_sites": 3 * lx * ly, "dim_full": int(dim_full),
        "E0_full": E0_full, "e0_per_site": E0_full / (3 * lx * ly),
        "full_engine": rows[0]["engine"], "sectors": sectors,
        "checks": checks,
        "timings_s": {"enumerate_full": t_enum, "solve_full": rows[0]["s"],
                      "total": time.perf_counter() - t_all},
        "device": device_name(device),
    }
    write_json(out or out_path("FLAGSHIP_kagome24_torch.json"), rec)
    print(json.dumps({k: v for k, v in rec.items() if k != "sectors"}),
          flush=True)
    failed = [k for k in ("sum_dims", "min_k_matches_full_1e-10",
                          "golden_1e-8") if checks.get(k) is False]
    if failed:
        raise AssertionError(f"kagome {lx}x{ly}: checks failed: {failed}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=2)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args()
    main(args.lx, args.ly, args.maxit, args.device, args.out, args.ckpt_dir)
