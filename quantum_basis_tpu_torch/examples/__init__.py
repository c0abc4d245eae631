"""The example drivers, through the port: one module per model family, each
with ``build(..., device="cuda")`` and ``main(..., device="cuda")``, the same
physics and golden asserts as the JAX package's ``examples/``. Run one as

    python -m quantum_basis_tpu_torch.examples.<name>

Each ``main`` prints, per solved sector, the engine the solve ran on and its
seconds, and returns those rows (:func:`solve`).
"""

from __future__ import annotations

import json
import os
import time

import torch

from quantum_basis_tpu_torch.models.model import _DENSE_CUTOFF


def engine_of(model, which: str = "full", sec: int = 0) -> str:
    """The engine the last solve of a sector ran on, read from the sector's
    caches (builds nothing)."""
    s = (model.sec_full if which == "full" else model.sec_repr)[sec]
    if s.dim <= _DENSE_CUTOFF:
        return "dense"
    if which == "full":
        fs = s._fs_cache.get(torch.float64)
        return type(fs if fs is not None else s.matvec).__name__
    if s._fsrepr_cache.get(torch.float64) is not None:
        return "ProjectedFullOp"
    if s.bsr32 is not None:
        return "BsrMatrix f32 + EllMatrix f64"
    return type(s.spmv if s.spmv is not None else s.matvec).__name__


def kpm_engine_of(model, sec: int) -> str:
    """The engine the last ``measure_repr_dynamic_kpm`` into momentum
    sector ``sec`` ran its recurrence on (builds nothing)."""
    s = model.sec_repr[sec]
    if s._fsrepr_cache.get(torch.float64) is not None:
        return "ProjectedFullOp"
    if s.bsr32 is not None:
        return "BsrMatrix f32"
    return type(s.ell if s.ell is not None else s.matvec).__name__


def write_json(path: str, rec) -> None:
    """Write ``rec`` as JSON to ``path``, making its directory."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def solve(rows: list, model, tag: str, which: str = "full", sec: int = 0,
          **kw) -> float:
    """``model.locate_E0_lanczos(which, sec=sec, **kw)`` timed on the host
    clock to the device's end; prints and appends (tag, engine, dim,
    seconds). Returns E0 of the sector."""
    t0 = time.perf_counter()
    model.locate_E0_lanczos(which, sec=sec, **kw)
    synchronize(model.device)
    dt = time.perf_counter() - t0
    s = (model.sec_full if which == "full" else model.sec_repr)[sec]
    row = {"sector": tag, "engine": engine_of(model, which, sec),
           "dim": int(s.dim), "s": dt}
    rows.append(row)
    print(f"  [{tag}] dim {row['dim']} on {row['engine']}: {dt:.3f} s",
          flush=True)
    return float(s.evals[0])
