"""Spin and charge gaps of the half-filled Hubbard cluster (config #3).

The port of ``benchmarks/hubbard4x4_gaps.py``. Beside the (h, h) ground
state (h = half the sites; (8,8) on 4x4, dim 165,636,900), it solves the
neighbouring (N_up, N_dn) sectors, each a factorized solve
(``hubbard4x4.solve_sector``) under the hard residual gate, and reports

    spin gap    Delta_s = E0(h+1, h-1) - E0(h, h)
    charge gap  Delta_c = E0(h+1, h) + E0(h, h-1) - 2 E0(h, h)

(the S_z = 1 spin excitation and the particle and hole addition energies of
the finite cluster). A gap is reported only when every sector it uses met
its residual gate; otherwise it is null and the run fails. E0(h, h) comes
from this run, or from a record passed in (``e88``, ``--reuse-e88 PATH``: a
hubbard4x4 record such as the JAX package's HUBBARD4x4.json, which must be
converged and under its gate). With ``ckpt_dir`` (``--ckpt-dir``) every
solve checkpoints there, and a sector whose completion record is there (it
is written where the eigenvector fits under the device's ckpt_max_bytes) is
resumed from it with no apply: a rerun after a crash redoes only the
sectors it had not finished.

Run:  python -m quantum_basis_tpu_torch.benchmarks.hubbard4x4_gaps [--lx 4 --ly 4] [--reuse-e88 PATH] [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.benchmarks import (device_name, out_path,
                                                timed, write_json)
from quantum_basis_tpu_torch.benchmarks.hubbard4x4 import solve_sector
from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
    build_factorized_sector)


def gap_sectors(lx, ly):
    h = lx * ly // 2
    return [(h, h), (h + 1, h - 1), (h + 1, h), (h, h - 1)]


def main(lx=4, ly=4, maxit=4000, ncv=None, e88=None, device="cuda",
         out=None, ckpt_dir=None):
    """Returns the record; writes it to ``out`` (default
    ``out_path("HUBBARD4x4_GAPS_torch.json")``). ``e88``: a converged record of
    the (h, h) sector (keys E0, residual_f64, gate_passed) to reuse;
    ``ckpt_dir``: checkpoint there and resume finished sectors."""
    if ckpt_dir is None:
        return _main(lx, ly, maxit, ncv, e88, device, out)
    with config.pinned(enable_ckpt=True, ckpt_dir=ckpt_dir):
        return _main(lx, ly, maxit, ncv, e88, device, out)


def _main(lx, ly, maxit, ncv, e88, device, out):
    t_all = time.perf_counter()
    todo = gap_sectors(lx, ly)
    sectors = {}
    if e88 is not None:
        if not e88.get("gate_passed"):
            raise ValueError("the reused (h, h) record did not pass its "
                             "residual gate")
        nu, nd = todo.pop(0)
        sectors[f"{nu},{nd}"] = {"Nup": nu, "Ndn": nd, "E0": e88["E0"],
                                 "residual_f64": e88["residual_f64"],
                                 "gate_passed": True, "source": "reused"}
    for nu, nd in todo:
        pm, t_build = timed(lambda: build_factorized_sector(
            lx, ly, nu, nd, device=device), device)
        rec = solve_sector(pm, maxit, ncv)
        rec.update({"Nup": nu, "Ndn": nd, "build_s": t_build})
        sectors[f"{nu},{nd}"] = rec
        print(f"E0({nu},{nd}) = {rec['E0']:.12f}  dim {rec['dim']:,}  "
              f"resid {rec['residual_f64']:.2e} (gate "
              f"{rec['residual_gate']:.2e})  [{rec['solve_s']:.1f} s, "
              f"{rec['applies']} applies]",
              flush=True)
        del pm
    h = lx * ly // 2
    s = {k: sectors[f"{a},{b}"] for k, (a, b) in
         zip(("hh", "spin", "add", "remove"), gap_sectors(lx, ly))}
    ok = {k: bool(v["gate_passed"]) for k, v in s.items()}
    spin_gap = (s["spin"]["E0"] - s["hh"]["E0"]
                if ok["hh"] and ok["spin"] else None)
    charge_gap = (s["add"]["E0"] + s["remove"]["E0"] - 2 * s["hh"]["E0"]
                  if ok["hh"] and ok["add"] and ok["remove"] else None)
    rec = {"workload": f"fermi_hubbard_{lx}x{ly}_U1.1_gap_sectors",
           "half_filling": h, "device": device_name(device),
           "sectors": sectors, "spin_gap": spin_gap,
           "charge_gap": charge_gap, "wall_s": time.perf_counter() - t_all}
    write_json(out or out_path("HUBBARD4x4_GAPS_torch.json"), rec)
    print(json.dumps({"spin_gap": spin_gap, "charge_gap": charge_gap}),
          flush=True)
    if spin_gap is None or charge_gap is None:
        raise AssertionError(f"sectors over their residual gate: "
                             f"{[k for k, v in ok.items() if not v]}")
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--lx", type=int, default=4)
    ap.add_argument("--ly", type=int, default=4)
    ap.add_argument("--maxit", type=int, default=4000)
    ap.add_argument("--ncv", type=int, default=None)
    ap.add_argument("--reuse-e88", default=None, metavar="PATH",
                    help="take the converged E0(h, h) from this record")
    ap.add_argument("--ckpt-dir", default=None, metavar="DIR",
                    help="checkpoint there; resume finished sectors")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    e88 = None
    if args.reuse_e88:
        with open(args.reuse_e88) as f:
            e88 = json.load(f)
    main(args.lx, args.ly, args.maxit, args.ncv, e88, args.device, args.out,
         args.ckpt_dir)
