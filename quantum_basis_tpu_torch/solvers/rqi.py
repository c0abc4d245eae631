"""Mixed-precision Rayleigh-quotient iteration (Jacobi-Davidson polish).

Port of ``quantum_basis_tpu.solvers.rqi.rqi_polish`` (successor of the
reference's ``eigenvec_CG``, src/lanczos.cc:281-341), with the work split by
precision:

- one f64 apply per OUTER iteration evaluates theta = <x|H|x> and the exact
  residual r = Hx - theta x (|theta - lambda| <= ||r|| for Hermitian H);
- the INNER loop approximately solves the correction equation
  (I - xx*)(H - theta)(I - xx*) t = r with projected CG on the f32 operator.
  Negative curvature (f32 noise, or theta not yet converged) ends the inner
  solve early with a partial correction.

The update x <- normalize(x - t) is applied in f64, so the attainable
residual is set by the f64 outer evaluation. All vectors stay on the device
(the JAX package parks them on the host between phases to fit a 16 GB TPU);
with ``ckpt_key`` set and ``config.enable_ckpt`` on, the iterate is copied to
the host and saved after every outer evaluation and after every correction,
and a rerun resumes from the record. On operators that carry a basis mesh
every inner product and norm is summed over the ranks (solvers/reduce.py).
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.config import lanczos_precision
from quantum_basis_tpu_torch.solvers.reduce import (
    ckpt_store,
    dot,
    mesh_of,
    norm,
)
from quantum_basis_tpu_torch.utils import ckpt

_TINY = 1e-300
_CHECK_EVERY = 16  # inner CG steps between host checks of the stop flag


def _outer(fs64, x):
    """x -> (theta, normalized x, residual r, ||r||), all float64."""
    mesh = mesh_of(fs64)
    x = x / torch.clamp(norm(x, mesh), min=_TINY)
    y = fs64(x).to(x.dtype)
    theta = dot(x, y, mesh).real
    r = y - theta * x
    return float(theta), x, r, float(norm(r, mesh))


def _inner(fs32, x, b, theta, nsteps):
    """Projected CG for (I-xx*)(H32 - theta)(I-xx*) t = b, b normalized here.

    Returns (t for the normalized rhs, relative residual, steps, ||b||). The
    iteration stops at ``nsteps``, at negative curvature, or once the squared
    relative residual is below 1e-10; stopped state is frozen (alpha = 0),
    so the host checks the stop flag only every few steps.
    """
    mesh = mesh_of(fs32)

    def proj(v):
        return v - dot(x, v, mesh) * x

    b = proj(b)
    bn = float(norm(b, mesh))
    b = b / max(bn, _TINY)

    def A(v):
        return proj(fs32(v).to(v.dtype) - theta * v)

    t = torch.zeros_like(b)
    r = b
    p = b
    rs = dot(b, b, mesh).real
    live = torch.ones((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for step in range(nsteps):
        Ap = A(p)
        pAp = dot(p, Ap, mesh).real
        ok = (pAp > 1e-30) & live
        alpha = torch.where(ok, rs / torch.clamp(pAp, min=1e-30), 0.0)
        t = t + alpha * p
        r = r - alpha * Ap
        rs2 = dot(r, r, mesh).real
        beta = torch.where(ok, rs2 / torch.clamp(rs, min=1e-30), 0.0)
        p = r + beta * p
        k = k + live
        live = ok & (rs2 >= 1e-10)
        rs = rs2
        if (step + 1) % _CHECK_EVERY == 0 and not bool(live):
            break
    return t, float(torch.sqrt(rs)), int(k), bn


def _save_capped(store, key, best, x, outer, complex_vec, pending):
    """Save the iterate to resume from (x_*) and the best evaluated iterate
    (best_*) as separate fields; ``pending`` marks x_* as not yet evaluated,
    so the metadata never claims best's residual for it. Skipped past the
    device's ckpt_max_bytes (a crash then redoes this stage only). The cap
    is decided before the gather."""
    if (store.nbytes(x, complex_vec) + store.nbytes(best[2], complex_vec)
            > config.memory("ckpt_max_bytes", x.device)):
        return
    x_re, x_im = ckpt.split_vec(store.whole(x), complex_vec)
    b_re, b_im = ckpt.split_vec(store.whole(best[2]), complex_vec)
    store.save(key, {"x_re": x_re, "x_im": x_im, "outer": outer,
                     "pending": bool(pending), "best_re": b_re,
                     "best_im": b_im, "best_theta": best[1],
                     "best_rnorm": best[0]})


def rqi_polish(fs64, v0, fs32, tol=None, max_outer: int = 60,
               inner: int = 240, inner_max: int = 1920, ckpt_key=None,
               log=None):
    """Polish eigenpair ``v0`` of ``fs64`` to f64 residual tolerance.

    fs64/fs32: the same operator in float64 and float32 working precision
    (callables with ``dtype``/``device``/``is_complex``).

    Returns dict with E0, vector, residual (exact f64 ||Hx - E0 x||),
    converged, n_outer, n_inner (total f32 applies). ``log(outer, theta,
    residual, inner steps)`` is called after every outer evaluation.
    """
    complex_vec = v0.is_complex() or fs64.is_complex
    dt64 = torch.complex128 if complex_vec else torch.float64
    dt32 = torch.complex64 if complex_vec else torch.float32
    x = v0.to(device=fs64.device, dtype=dt64)
    n_inner_tot = 0
    cur_inner = int(inner)
    prev_rn = None
    best = None  # (rnorm, theta, x)
    n_outer0 = 0
    store = ckpt_store(fs64, ckpt_key)
    if store is not None:
        shape = (store.length(x),)
        rec = store.load(ckpt_key, vectors=("x_re", "x_im", "best_re",
                                            "best_im"), fits=lambda r: (
            r["x_re"].shape == shape
            and (r["x_im"].shape == shape) == complex_vec))
        if rec is not None:
            x = ckpt.join_vec(rec["x_re"], rec["x_im"], complex_vec,
                              fs64.device, torch.float64)
            n_outer0 = min(int(rec["outer"]), max_outer - 1)
            # best travels apart from the (possibly unevaluated) pending
            # iterate: if a correction diverged before the crash, the resume
            # evaluates the pending x but can still fall back to best
            if "best_re" in rec:
                best = (float(rec["best_rnorm"]), float(rec["best_theta"]),
                        ckpt.join_vec(rec["best_re"], rec["best_im"],
                                      complex_vec, fs64.device,
                                      torch.float64))
    it = n_outer0
    for it in range(n_outer0, max_outer):
        theta, x, r, rn = _outer(fs64, x)
        if tol is None:
            tol = max(1e3 * lanczos_precision * max(abs(theta), 1.0), 5e-10)
        if log is not None:
            log(it, theta, rn, cur_inner)
        if best is None or rn < best[0]:
            best = (rn, theta, x)
        if store is not None:
            _save_capped(store, ckpt_key, best, best[2], it + 1, complex_vec,
                         pending=False)
        if rn < tol:
            break
        if prev_rn is not None and rn > 0.5 * prev_rn:
            # outer contraction stalling -> buy a more accurate correction
            cur_inner = min(2 * cur_inner, inner_max)
        prev_rn = rn
        t, _, k, bn = _inner(fs32, x.to(dt32), r.to(dt32), theta, cur_inner)
        n_inner_tot += k
        # x <- x - t*||b|| (t solved against the normalized rhs)
        x = x - bn * t.to(dt64)
        if store is not None:
            # persist the UPDATED iterate at once: a crash between the inner
            # solve and the next outer evaluation must not lose the correction
            _save_capped(store, ckpt_key, best, x, it + 1, complex_vec,
                         pending=True)
    rn, theta, x = best
    converged = bool(rn < (tol if tol is not None else np.inf))
    if store is not None and converged:
        store.delete(ckpt_key)
    return {
        "E0": theta,
        "vector": x,
        "residual": rn,
        "residual_bound": rn,
        "converged": converged,
        "n_outer": it + 1,
        "n_inner": n_inner_tot,
    }
