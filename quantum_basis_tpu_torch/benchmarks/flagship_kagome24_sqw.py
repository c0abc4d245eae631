"""Momentum-resolved dynamical structure factor S(q, w) of kagome-24.

The port of ``benchmarks/flagship_kagome24_sqw.py``: on the 24-site kagome
Heisenberg antiferromagnet

1. solve the ground state in its momentum sector k0 (the flagship's ground
   state momentum, (0,2) at 2x4),
2. for every q of the cell zone, build Sz(q) = (1/sqrt(N)) sum_r e^{-i q.r}
   Sz_r (cell-coordinate phases, sublattice-summed), land A_q|gs> in sector
   k0 - q, build that sector's explicit ELL (``generate_Ham_sparse_repr``)
   and record 192 operator-resolved Chebyshev moments through
   ``measure_repr_dynamic_kpm``, on whichever engine the device's routing
   bounds choose;
3. reconstruct S(q, w) with the Jackson kernel and write the record.

The spectral bounds are computed per target sector (``energy_scale`` on its
ELL), not taken from k0 alone. Given a reference record (the JAX package's
``SQW_kagome24.json``), the run uses that record's shared bounds, so that
its moments compare, after checking that they contain every target sector's
own bounds; it then requires the norms to 1e-7 and the moments to 1e-4 of
the reference. Every q requires |mu_n| <= 1 + 1e-9 (the rescaled spectrum
inside [-1, 1]).

Run:  python -m quantum_basis_tpu_torch.benchmarks.flagship_kagome24_sqw [--reference SQW_kagome24.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import Mopr, Opr
from quantum_basis_tpu_torch.benchmarks import (device_name, out_path,
                                                write_json)
from quantum_basis_tpu_torch.benchmarks.flagship_kagome24 import SZ, build
from quantum_basis_tpu_torch.examples import kpm_engine_of, solve
from quantum_basis_tpu_torch.postprocess import sqw_kpm
from quantum_basis_tpu_torch.solvers.lanczos import energy_scale

NORM_TOL = 1e-7
MU_TOL = 1e-4
MU_BOUND = 1.0 + 1e-9
BOUNDS_SLACK = 0.05


def sz_q(lat, qx, qy, Lx, Ly):
    out = Mopr()
    n = lat.n_sites
    for s in range(n):
        coor, _ = lat.site2coor(s)
        ph = np.exp(-2j * np.pi * (qx * coor[0] / Lx + qy * coor[1] / Ly))
        out += (ph / np.sqrt(n)) * Opr(s, 0, False, SZ)
    return out


def sector_bounds(ell, device):
    """The target sector's own spectral bounds (energy_scale on its ELL
    from a seeded random start)."""
    gen = torch.Generator(device=device).manual_seed(7)
    v0 = torch.randn(ell.n, dtype=torch.float64, device=device,
                     generator=gen).to(torch.complex128)
    return energy_scale(ell, v0, slack=BOUNDS_SLACK)


def main(lx=2, ly=4, n_moments=192, k0=(0, 2), maxit=4000, reference=None,
         device="cuda", out=None):
    """Returns the record; writes it to ``out`` (default
    ``out_path("SQW_kagome24_torch.json")``). ``reference``: a path to, or the
    dict of, a record to hold this run against (shared bounds, norms,
    moments)."""
    if isinstance(reference, str):
        with open(reference) as f:
            reference = json.load(f)
    ref_runs = ({tuple(r["q"]): r for r in reference["runs"]}
                if reference else {})
    rows = []
    t_all = time.perf_counter()
    k0 = [int(k0[0]), int(k0[1])]
    m, Sz_tot = build(lx, ly, device)
    lat = m.lattice
    dim0 = m.enumerate_basis_repr(k0, [Sz_tot], [0.0], sec=0)
    E0 = solve(rows, m, f"k0=({k0[0]},{k0[1]})", "repr", sec=0, maxit=maxit)
    print(f"E0(k0) = {E0:.12f}  dim {dim0}", flush=True)
    if reference:
        if abs(E0 - reference["E0"]) > 1e-8:
            raise AssertionError(f"E0(k0) {E0!r} vs {reference['E0']!r}")

    runs = []
    for qx in range(lx):
        for qy in range(ly):
            t0 = time.perf_counter()
            m.sec_repr.pop(1, None)
            kt = [(k0[0] - qx) % lx, (k0[1] - qy) % ly]
            m.enumerate_basis_repr(kt, [Sz_tot], [0.0], sec=1)
            ell = m.generate_Ham_sparse_repr(1, check=False)
            own = sector_bounds(ell, device)
            ref = ref_runs.get((qx, qy))
            if ref is not None and ref["norm"] > 0:
                bounds = (ref["e_min"], ref["e_max"])
                if not (bounds[0] <= own[0] and own[1] <= bounds[1]):
                    raise AssertionError(
                        f"q=({qx},{qy}): the sector's bounds {own} are not "
                        f"inside the reference's {bounds}")
            else:
                bounds = own
            nrm, mu, e_min, e_max = m.measure_repr_dynamic_kpm(
                sz_q(lat, qx, qy, lx, ly), 0, 1, n_moments, bounds=bounds)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            mu = np.asarray(mu)
            run = {"q": [qx, qy], "k_target": kt, "norm": nrm,
                   "mu": mu.tolist(), "e_min": e_min, "e_max": e_max,
                   "sector_bounds": list(own),
                   "engine": kpm_engine_of(m, 1),
                   "s": time.perf_counter() - t0}
            if nrm > 0 and not np.all(np.abs(mu) <= MU_BOUND):
                raise AssertionError(f"q=({qx},{qy}): max|mu_n| = "
                                     f"{np.abs(mu).max()!r} over 1")
            if ref is not None:
                run["norm_err"] = abs(nrm - ref["norm"])
                run["mu_err"] = (float(np.max(np.abs(mu - np.asarray(
                    ref["mu"])))) if nrm > 0 else 0.0)
                if run["norm_err"] > NORM_TOL or run["mu_err"] > MU_TOL:
                    raise AssertionError(
                        f"q=({qx},{qy}): norm off by {run['norm_err']:.3e}, "
                        f"moments by {run['mu_err']:.3e}")
            runs.append(run)
            print(f"q=({qx},{qy}) -> k={kt}  norm^2 = {nrm**2:.6f}  on "
                  f"{run['engine']} [{run['s']:.3f} s]", flush=True)

    live = [r for r in runs if r["norm"] > 0]
    e_max_all = max(r["e_max"] for r in live)
    omegas = np.linspace(0.0, (e_max_all - E0) * 1.02, 600)
    S = np.stack([sqw_kpm(omegas, r["norm"], np.asarray(r["mu"]),
                          r["e_min"], r["e_max"], E0)
                  if r["norm"] > 0 else np.zeros_like(omegas)
                  for r in runs])
    rec = {
        "workload": f"kagome{3 * lx * ly}_heisenberg_sqw_kpm",
        "n_sites": 3 * lx * ly, "dim_k0": int(dim0), "k0": k0, "E0": E0,
        "n_moments": n_moments, "gs_engine": rows[0]["engine"],
        "gs_s": rows[0]["s"],
        "sum_rule": {"integral": float(np.trapezoid(S, omegas,
                                                    axis=1).sum()),
                     "norms2": float(sum(r["norm"] ** 2 for r in runs))},
        "runs": runs, "device": device_name(device),
        "wall_s": time.perf_counter() - t_all,
    }
    if reference:
        n2 = rec["sum_rule"]["norms2"]
        want = reference["sum_rule"]["norms2"]
        if abs(n2 - want) > NORM_TOL:
            raise AssertionError(f"sum of norm^2 {n2!r} vs {want!r}")
    write_json(out or out_path("SQW_kagome24_torch.json"), rec)
    print(f"S(q,w) of {len(runs)} q in {rec['wall_s']:.1f} s", flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=2)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--n-moments", type=int, default=192)
    ap.add_argument("--k0", type=int, nargs=2, default=[0, 2])
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--reference", default=None,
                    help="a record to hold this run against, e.g. the JAX "
                         "package's SQW_kagome24.json")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.lx, args.ly, args.n_moments, args.k0, args.maxit,
         args.reference, args.device, args.out)
