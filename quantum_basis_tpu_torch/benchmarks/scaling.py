"""Scaling of the multi-device route over 1, 2, 4, ... ranks.

Port of ``benchmarks/scaling.py``. At each rank count P one group of P
processes (one device each: NCCL between CUDA cards, gloo between CPU
processes) measures on the same sectors:

- ``FullSpaceSharded`` on the chain of L spins, Sz = 0 (label space 2^L in
  P slices): one Lanczos iteration (the apply, two all-reduced dots, a
  norm), as the JAX driver times it, and the apply alone;
- ``EllShardedHalo`` on that sector's explicit ELL, with its
  ``halo_stats()`` (the JAX driver measures it at the largest P only), and
  ``MatvecSharded``, the all-gather fallback;
- ``KronSharded`` on the factorized Hubbard sector at half filling (4x4 by
  default, float32 and float64), the engine of ``ProductModel(mesh=)``;

each with the bytes every rank receives per apply and the link rate of its
collective at that message size (comm_roofline.link_rate), and the largest
rank's allocator peak while that engine was built and timed (on CUDA; the
sector's basis, resident throughout, included). Efficiency at P is
t(1) / (P t(P)) of the same engine in the same run. Every time is the
slowest rank's.

Run:  python -m quantum_basis_tpu_torch.benchmarks.scaling [--L 24]
          [--ranks 4] [--hubbard 4x4] [--device cpu] [--out FILE]
On CUDA it needs ``--ranks`` cards and raises with fewer. Writes JSON lines
to scaling.jsonl under ``OUT_DIR`` unless ``--out`` says otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from quantum_basis_tpu_torch.benchmarks import (card_line, device_ms,
                                                device_name, out_path)
from quantum_basis_tpu_torch.benchmarks.comm_roofline import (link_rate,
                                                               slowest)
from quantum_basis_tpu_torch.parallel import run_ranks

SAMPLES = 5
_MODULE = "quantum_basis_tpu_torch.benchmarks.scaling"


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--L", type=int, default=24)
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--hubbard", default="4x4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=out_path("scaling.jsonl"))
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--rank", nargs=4, default=None,
                    metavar=("OUT", "RANK", "RANKS", "RENDEZVOUS"),
                    help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def _line(mesh, engine, workload, metric, ms, nbytes, collective, **kw):
    """One engine's line on this rank (times and bytes the slowest's, the
    allocator's peak since the last ``_reset_peak`` the largest rank's)."""
    P = mesh.size
    nbytes = int(slowest(mesh, nbytes))
    peak = (int(slowest(mesh, torch.cuda.max_memory_allocated(mesh.device)))
            if mesh.device.type == "cuda" else None)
    rec = {"metric": metric, "engine": engine, "workload": workload,
           "ranks": P, f"ms_per_{metric}": slowest(mesh, ms),
           "bytes_per_rank_per_apply": nbytes, "link": None,
           "peak_bytes_per_rank": peak}
    if P > 1 and metric == "apply":
        msg = nbytes
        if collective == "p2p":   # one boundary piece per message
            msg = nbytes // max(1, int(slowest(mesh, kw.pop("messages"))))
        rec["link"] = link_rate(mesh, collective, msg)
    kw.pop("messages", None)
    rec.update(kw)
    return rec


def _chain(mesh, L, lines):
    """FullSpaceSharded, EllShardedHalo and MatvecSharded on chain-L Sz=0."""
    from quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half import \
        build
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_full
    from quantum_basis_tpu_torch.parallel import (EllShardedHalo,
                                                  FullSpaceSharded,
                                                  MatvecSharded)
    from quantum_basis_tpu_torch.solvers.reduce import dot, norm
    from quantum_basis_tpu_torch.utils.rng import vec_randomize

    dev, P = mesh.device, mesh.size
    wl = f"heisenberg_chain_L{L}_Sz0"
    m, Sz = build(L, device=dev)
    dim = m.enumerate_basis_full([Sz], [0.0])
    sec = m.sec_full[0]

    _reset_peak(dev)
    fs = FullSpaceOp(m.compiled_Ham, sec.labels, device=dev)
    fss = FullSpaceSharded(fs, mesh)
    re, _ = vec_randomize(fs.N, seed=1)
    v = torch.as_tensor(re)
    if fs.mask is not None:   # start inside the sector, as the solvers do
        v = v * fs.mask.cpu()
    v = fss.pad(v)
    v = v / norm(v, mesh)
    state = [torch.zeros_like(v), v, torch.zeros((), dtype=v.dtype,
                                                  device=dev)]

    def lanczos_iter():
        vp, vc, b = state
        w = fss(vc) - b * vp
        a = dot(vc, w, mesh).real
        w = w - a * vc
        b = norm(w, mesh)
        state[:] = [vc, w / b, b]

    entries, messages = fss.sent_per_apply()
    nb = entries * 8
    lines.append(_line(mesh, "FullSpaceSharded", wl + "_fullspace",
                       "iter", device_ms(lanczos_iter, dev, SAMPLES, 5), nb,
                       "p2p", N=fs.N, dtype="float64"))
    lines.append(_line(mesh, "FullSpaceSharded", wl + "_fullspace",
                       "apply", device_ms(lambda: fss(v), dev, SAMPLES, 3),
                       nb, "p2p", N=fs.N, dtype="float64",
                       messages=messages))
    del fs, fss, v, state

    _reset_peak(dev)
    ell = build_sparse_full(sec.matvec)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(dim),
                        device=dev)
    hs = EllShardedHalo(ell, mesh)
    xl = hs.pad(x)
    stats = hs.halo_stats()
    lines.append(_line(mesh, "EllShardedHalo", wl + "_ell", "apply",
                       device_ms(lambda: hs(xl), dev, SAMPLES, 5),
                       hs.n_halo * 8, "all_to_all", dim=dim,
                       dtype="float64", halo_stats=stats,
                       ell_ms_single_device=slowest(
                           mesh, device_ms(lambda: ell(x), dev, SAMPLES, 5))))
    del hs, xl, ell
    _reset_peak(dev)
    mvs = MatvecSharded(m.compiled_Ham, sec.dbasis, mesh)
    xs = mvs.pad(x)
    lines.append(_line(mesh, "MatvecSharded", wl + "_matrix_free", "apply",
                       device_ms(lambda: mvs(xs), dev, SAMPLES, 1),
                       (P - 1) * (mvs.n_pad // P) * 8, "all_gather",
                       dim=dim, dtype="float64"))


def _kron(mesh, shape, lines):
    """KronSharded (float32 and float64) on the factorized Hubbard sector."""
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import \
        build_factorized
    from quantum_basis_tpu_torch.parallel import KronSharded

    dev, P = mesh.device, mesh.size
    lx, ly = (int(s) for s in shape.split("x"))
    pm, _ = build_factorized(lx, ly, device=dev)
    ell_a, ell_b = pm._factor_ells()
    C = pm._coupling_matrix()
    for dt, name in ((torch.float32, "float32"), (torch.float64, "float64")):
        _reset_peak(dev)
        sh = KronSharded(ell_a, ell_b, coupling=C,
                         coupling_scale=pm.coupling_scale, mesh=mesh,
                         dtype=dt)
        gen = torch.Generator(device=dev).manual_seed(5)
        xl = torch.randn(sh.span[1] - sh.span[0], dtype=dt, device=dev,
                         generator=gen)
        itemsize = xl.element_size()
        lines.append(_line(
            mesh, "KronSharded", f"hubbard_{shape}_half_filling", "apply",
            device_ms(lambda: sh(xl), dev, SAMPLES, 1),
            (P - 1) * (sh.na // P) * sh.nb * itemsize, "all_gather",
            dim=pm.dim, dtype=name, factor_dims=[sh.na_logical, sh.nb]))
        del sh, xl
        if dev.type == "cuda":
            torch.cuda.empty_cache()


def rank_main(args) -> int:
    """One rank of one group: measure, and rank 0 writes the lines."""
    import torch.distributed as dist

    from quantum_basis_tpu_torch.parallel import basis_mesh, init_distributed

    out, rank, ranks, rdv = args.rank
    rank, ranks = int(rank), int(ranks)
    if args.device == "cpu":
        torch.set_num_threads(1)
    t0 = time.perf_counter()
    init_distributed(f"file://{rdv}", ranks, rank, device=args.device)
    try:
        mesh = basis_mesh(ranks, device=args.device)
        dev = mesh.device
        one = torch.ones(1, dtype=torch.float64, device=dev)
        mesh.all_reduce(one)
        group = {"start_s": slowest(mesh, time.perf_counter() - t0),
                 "all_reduce_ms": slowest(mesh, device_ms(
                     lambda: mesh.all_reduce(one), dev)),
                 "backend": mesh.backend, "device": device_name(dev)}
        lines = []
        _chain(mesh, args.L, lines)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        _kron(mesh, args.hubbard, lines)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"group": group, "lines": lines}, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> list[dict]:
    args = _args(argv)
    if args.rank is not None:
        return rank_main(args)
    if torch.device(args.device).type == "cuda":
        have = torch.cuda.device_count()
        if have < args.ranks:
            raise RuntimeError(f"{args.ranks} ranks need {args.ranks} cards, "
                               f"this machine has {have}")
    card = card_line(args.device)
    counts = [c for c in (1, 2, 4, 8, 16) if c <= args.ranks]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    lines = []
    for P in counts:
        res = args.out + f".ranks{P}.json"
        t0 = time.perf_counter()
        run_ranks([sys.executable, "-m", _MODULE, "--L", str(args.L),
                   "--hubbard", args.hubbard, "--device", args.device,
                   "--rank", res], P, args.timeout)
        with open(res) as f:
            got = json.load(f)
        os.remove(res)
        group = dict(got["group"], group_wall_s=time.perf_counter() - t0,
                     card=card)
        lines += [dict(l, **group) for l in got["lines"]]
    base = {(l["engine"], l["workload"], l.get("dtype"), l["metric"]): l
            for l in lines if l["ranks"] == 1}
    with open(args.out, "w") as f:
        for l in lines:
            one = base[(l["engine"], l["workload"], l.get("dtype"),
                        l["metric"])]
            key = f"ms_per_{l['metric']}"
            l["efficiency_vs_1"] = one[key] / (l["ranks"] * l[key])
            f.write(json.dumps(l) + "\n")
            print(json.dumps(l), flush=True)
    return lines


if __name__ == "__main__":
    out = main(sys.argv[1:])
    sys.exit(out if isinstance(out, int) else 0)
