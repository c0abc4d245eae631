"""Communication against compute for each sharded engine.

Port of ``benchmarks/comm_roofline.py``. For every engine the scaling driver
(benchmarks/scaling.py) ran at P ranks, the model is

    eff(P) = t_comp / (t_comp + t_comm)          (no overlap)
    eff(P) = t_comp / max(t_comp, t_comm)        (full overlap)

with t_comp = t(1) / P, the engine's own per-apply time on one rank in the
same run, and t_comm = (bytes each rank receives per apply) / (the link rate
measured in that run, on the same group, for that engine's collective at its
message size): NCCL's all-gather for ``KronSharded`` and the ``MatvecSharded``
fallback, its all-to-all for the halo ELL (``EllShardedHalo``, its measured
halo), its point-to-point for ``FullSpaceSharded``'s boundary pieces. The
bytes come from the engines' own shapes and ``halo_stats()``. Each model
line stands beside the efficiency the scaling driver measured, and, on a
CUDA card, beside t_comm at NVLink's nominal 450 GB/s each way.

Run:  python -m quantum_basis_tpu_torch.benchmarks.comm_roofline
          [--scaling FILE] [--out FILE]
(reads the lines the scaling driver wrote, scaling.jsonl under ``OUT_DIR``
by default: run that driver first).
Writes nothing but its ``--out``, comm_roofline.jsonl under ``OUT_DIR``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from quantum_basis_tpu_torch.benchmarks import device_ms, out_path

NVLINK_BYTES_PER_S = 450e9   # one H100's NVLink, each way, published


def slowest(mesh, value: float) -> float:
    """The largest of every rank's ``value``, on every rank."""
    t = torch.tensor([float(value)], dtype=torch.float64, device=mesh.device)
    return float(mesh.all_reduce(t, "max")[0])


def link_rate(mesh, collective: str, nbytes: int, samples: int = 5) -> dict:
    """One collective timed on ``mesh`` at a message that brings each rank
    ``nbytes`` from the other ranks (rounded to whole float32 entries):
    all-gather (each rank contributes nbytes / (P-1)), all-to-all (each
    rank sends nbytes / (P-1) to every other) or point-to-point (a ring:
    each rank sends nbytes to the next and receives as much from the one
    before). Returns the bytes, the slowest rank's ms and bytes / s."""
    P, dev = mesh.size, mesh.device
    per = max(1, int(nbytes) // (4 * (P - 1)))   # float32 entries per peer
    if collective == "all_gather":
        x = torch.ones(per, dtype=torch.float32, device=dev)

        def fn():
            mesh.all_gather(x)
    elif collective == "all_to_all":
        x = torch.ones(per * P, dtype=torch.float32, device=dev)
        counts = [per] * P

        def fn():
            mesh.all_to_all(x, counts, counts)
    elif collective == "p2p":
        per = max(1, int(nbytes) // 4)
        x = torch.ones(per, dtype=torch.float32, device=dev)
        buf = torch.empty_like(x)
        r = mesh.rank

        def fn():
            mesh.exchange([((r + 1) % P, x)], [((r - 1) % P, buf)])
    else:
        raise ValueError(f"unknown collective {collective!r}")
    got = per * 4 * (P - 1 if collective != "p2p" else 1)
    ms = slowest(mesh, device_ms(fn, dev, samples=samples, per_sample=3))
    return {"collective": collective, "bytes": got, "ms": ms,
            "bytes_per_s": got / (ms * 1e-3)}


def model(lines: list[dict]) -> list[dict]:
    """The model beside the measurement, one line per engine line of the
    scaling driver at P >= 2 (its ``apply`` lines)."""
    applies = {(l["engine"], l["workload"], l.get("dtype"), l["ranks"]): l
               for l in lines if l["metric"] == "apply"}
    out = []
    for (eng, wl, dt, P), l in sorted(applies.items(),
                                      key=lambda kv: (kv[0][:3], kv[0][3])):
        one = applies.get((eng, wl, dt, 1))
        if P == 1 or one is None:
            continue
        t_comp = one["ms_per_apply"] / P
        b = l["bytes_per_rank_per_apply"]
        rate = l["link"]["bytes_per_s"]
        t_comm = b / rate * 1e3
        rec = {
            "metric": "comm_model", "engine": eng, "workload": wl,
            "dtype": dt, "ranks": P, "collective": l["link"]["collective"],
            "bytes_per_rank_per_apply": b,
            "link_bytes_per_s": rate, "link_message_bytes": l["link"]["bytes"],
            "t_comp_ms": t_comp, "t_comm_ms": t_comm,
            "efficiency_no_overlap": t_comp / (t_comp + t_comm),
            "efficiency_overlap": t_comp / max(t_comp, t_comm),
            "efficiency_measured": l["efficiency_vs_1"],
            "ms_per_apply_measured": l["ms_per_apply"],
            "device": l["device"], "card": l["card"],
        }
        if l["backend"] == "nccl":
            rec["t_comm_nvlink_nominal_ms"] = b / NVLINK_BYTES_PER_S * 1e3
        out.append(rec)
    return out


def read_lines(path: str) -> list[dict]:
    with open(path) as f:
        return [json.loads(s) for s in f if s.strip()]


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scaling", default=out_path("scaling.jsonl"))
    ap.add_argument("--out", default=out_path("comm_roofline.jsonl"))
    args = ap.parse_args(argv)
    lines = model(read_lines(args.scaling))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        for rec in lines:
            f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return lines


if __name__ == "__main__":
    main(sys.argv[1:])
