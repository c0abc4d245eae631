"""Fermi-Hubbard 4x4 at half filling (BASELINE config #3) on one device.

The port of ``benchmarks/hubbard4x4.py``. U = 1.1, N_up = N_dn = 8, sector
dim C(16,8)^2 = 165,636,900. In the species-major Jordan-Wigner ordering the
sector factorizes as up (x) down (models/product.py, ops/apply_kron.py): the
state is a (12870, 12870) matrix and one H application is two dense matrix
products and one elementwise pass. The solve is ProductModel's own choice
for the device (``config.MEMORY``: pure float64 thick restart, or the
mixed-precision pipeline of float32 thick restart and float64
Rayleigh-quotient polish, and the basis size ncv), under the hard residual
gate.

Protocol: (1) the 4x2 golden (E0 = -14.07605866) through the same
ProductModel path on the same device; (2) the 4x4 solve: E0 =
-20.497352266554 to 1e-8, the float64 residual ||Hx - E0 x|| under the gate
max(1e3 * 2e-12 * |E0|, 5e-10); then the float32 apply timed.

Run:  python -m quantum_basis_tpu_torch.benchmarks.hubbard4x4 [--lx 4 --ly 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.benchmarks import (device_ms, device_name,
                                                out_path, timed, write_json)
from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
    E0_4X2, build_factorized)

E0_4X4 = -20.497352266554    # HUBBARD4x4.json
DIM_4X4 = 165_636_900


def residual_gate(E0: float) -> float:
    """The float64 residual bound of a converged eigenpair."""
    return max(1e3 * config.lanczos_precision * max(abs(E0), 1.0), 5e-10)


def applies(pm) -> int:
    """Applies made so far by the engines of a ProductModel."""
    return sum(op.n_applies for op in pm._ops.values())


def solve_sector(pm, maxit=4000, ncv=None, mixed=None):
    """The solve of one ProductModel sector (``ncv``, ``mixed``: None takes
    the device's table): a record with E0, the float64 residual, the gate,
    seconds, the applies of both precisions (0 when a completion record
    was resumed) and the solver's counts."""
    n0 = applies(pm)
    E0, s = timed(lambda: pm.locate_E0_lanczos(maxit=maxit, ncv=ncv,
                                               mixed=mixed), pm.device)
    resid = pm._last_residual
    gate = residual_gate(E0)
    info = dict(pm.solve_info)
    return {"dim": pm.dim, "factor_dims": [pm.na, pm.nb], "E0": E0,
            "residual_f64": resid, "residual_gate": gate,
            "gate_passed": resid is not None and resid < gate,
            "solve_s": s, "applies": applies(pm) - n0, "solver": info}


def golden_4x2(device="cuda"):
    """The 4x2 golden through ProductModel, on the device's table: its
    record."""
    (pm, _), t_build = timed(lambda: build_factorized(4, 2, device=device),
                             device)
    rec = solve_sector(pm)
    rec["build_s"] = t_build
    ok = abs(rec["E0"] - E0_4X2) < 1e-8
    print(f"4x2 golden: E0 = {rec['E0']:.9f} (ref {E0_4X2}) "
          f"[{'OK' if ok else 'FAIL'}] {rec['solve_s']:.3f} s", flush=True)
    if not ok:
        raise AssertionError(f"4x2: E0 {rec['E0']!r}")
    return rec


def main(lx=4, ly=4, maxit=4000, ncv=None, device="cuda", out=None):
    """Returns the record; writes it to ``out`` (default
    ``out_path("HUBBARD4x4_torch.json")``). At 4x4 requires the golden E0
    (1e-8) and the residual under its gate."""
    rec = {"workload": f"fermi_hubbard_{lx}x{ly}_halffilling_U1.1",
           "formulation": "species-factorized (up x down), models/product.py",
           "device": device_name(device), "golden_4x2": golden_4x2(device)}
    t_all = time.perf_counter()
    (pm, _), rec["factor_build_s"] = timed(
        lambda: build_factorized(lx, ly, device=device), device)
    print(f"factor dim {pm.na} (x) {pm.nb} = {pm.dim}", flush=True)
    rec.update(solve_sector(pm, maxit, ncv))
    print(f"E0 = {rec['E0']:.12f}  residual {rec['residual_f64']:.3e} < "
          f"gate {rec['residual_gate']:.3e}  [{rec['solve_s']:.1f} s]",
          flush=True)
    # the float32 bulk engine's apply, timed after the solve so its buffers
    # never share the device with the solver's peak
    fs32 = pm.op(torch.float32)
    gen = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(pm.dim, dtype=torch.float32, device=device, generator=gen)
    rec["f32_apply_ms"] = device_ms(lambda: fs32(x), device, samples=3,
                                    per_sample=1)
    del x
    rec["total_s"] = time.perf_counter() - t_all
    write_json(out or out_path("HUBBARD4x4_torch.json"), rec)
    print(json.dumps({k: v for k, v in rec.items() if k != "solver"}),
          flush=True)
    if (lx, ly) == (4, 4):
        if pm.dim != DIM_4X4 or abs(rec["E0"] - E0_4X4) > 1e-8:
            raise AssertionError(f"4x4: dim {pm.dim}, E0 {rec['E0']!r}")
    if not rec["gate_passed"]:
        raise AssertionError(f"residual {rec['residual_f64']!r} over the "
                             f"gate {rec['residual_gate']!r}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=4)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--ncv", type=int, default=None,
                    help="thick-restart basis size (ncv+1 vectors of 662 MB "
                         "in float32, 1.33 GB in float64 at 4x4); default "
                         "the device's product_ncv")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.lx, args.ly, args.maxit, args.ncv, args.device, args.out)
