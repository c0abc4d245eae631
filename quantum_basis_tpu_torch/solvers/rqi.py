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
residual is set by the f64 outer evaluation. All vectors stay on the device.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.config import lanczos_precision

_TINY = 1e-300
_CHECK_EVERY = 16  # inner CG steps between host checks of the stop flag


def _outer(fs64, x):
    """x -> (theta, normalized x, residual r, ||r||), all float64."""
    x = x / torch.clamp(torch.linalg.vector_norm(x), min=_TINY)
    y = fs64(x).to(x.dtype)
    theta = torch.vdot(x, y).real
    r = y - theta * x
    return float(theta), x, r, float(torch.linalg.vector_norm(r))


def _inner(fs32, x, b, theta, nsteps):
    """Projected CG for (I-xx*)(H32 - theta)(I-xx*) t = b, b normalized here.

    Returns (t for the normalized rhs, relative residual, steps, ||b||). The
    iteration stops at ``nsteps``, at negative curvature, or once the squared
    relative residual is below 1e-10; stopped state is frozen (alpha = 0),
    so the host checks the stop flag only every few steps.
    """
    def proj(v):
        return v - torch.vdot(x, v) * x

    b = proj(b)
    bn = float(torch.linalg.vector_norm(b))
    b = b / max(bn, _TINY)

    def A(v):
        return proj(fs32(v).to(v.dtype) - theta * v)

    t = torch.zeros_like(b)
    r = b
    p = b
    rs = torch.vdot(b, b).real
    live = torch.ones((), dtype=torch.bool, device=b.device)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for step in range(nsteps):
        Ap = A(p)
        pAp = torch.vdot(p, Ap).real
        ok = (pAp > 1e-30) & live
        alpha = torch.where(ok, rs / torch.clamp(pAp, min=1e-30), 0.0)
        t = t + alpha * p
        r = r - alpha * Ap
        rs2 = torch.vdot(r, r).real
        beta = torch.where(ok, rs2 / torch.clamp(rs, min=1e-30), 0.0)
        p = r + beta * p
        k = k + live
        live = ok & (rs2 >= 1e-10)
        rs = rs2
        if (step + 1) % _CHECK_EVERY == 0 and not bool(live):
            break
    return t, float(torch.sqrt(rs)), int(k), bn


def rqi_polish(fs64, v0, fs32, tol=None, max_outer: int = 60,
               inner: int = 240, inner_max: int = 1920):
    """Polish eigenpair ``v0`` of ``fs64`` to f64 residual tolerance.

    fs64/fs32: the same operator in float64 and float32 working precision
    (callables with ``dtype``/``device``/``is_complex``).

    Returns dict with E0, vector, residual (exact f64 ||Hx - E0 x||),
    converged, n_outer, n_inner (total f32 applies).
    """
    complex_vec = v0.is_complex() or fs64.is_complex
    dt64 = torch.complex128 if complex_vec else torch.float64
    dt32 = torch.complex64 if complex_vec else torch.float32
    x = v0.to(device=fs64.device, dtype=dt64)
    n_inner_tot = 0
    cur_inner = int(inner)
    prev_rn = None
    best = None  # (rnorm, theta, x)
    it = 0
    for it in range(max_outer):
        theta, x, r, rn = _outer(fs64, x)
        if tol is None:
            tol = max(1e3 * lanczos_precision * max(abs(theta), 1.0), 5e-10)
        if best is None or rn < best[0]:
            best = (rn, theta, x)
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
    rn, theta, x = best
    return {
        "E0": theta,
        "vector": x,
        "residual": rn,
        "converged": bool(rn < tol),
        "n_outer": it + 1,
        "n_inner": n_inner_tot,
    }
