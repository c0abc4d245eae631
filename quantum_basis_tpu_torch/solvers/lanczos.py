"""Memory-lean Lanczos — ground states, gaps, dynamics, spectral bounds.

Port of ``quantum_basis_tpu.solvers.lanczos``, the re-design of the
reference's multi-purpose ``lanczos`` kernel (reference:
src/lanczos.cc:134-266) and the routines built on it:

- ``lanczos_ground``  = "sr_val0/sr_vec0" (+ deflated "sr_val1/sr_vec1"):
  2-vector rolling iteration, run in *explicitly restarted cycles*: each
  cycle runs a fixed number of steps, recovers the Ritz vector by a second
  deterministic pass (the reference's own approach), then restarts the
  recurrence from that Ritz vector. Convergence is judged on the EXPLICIT
  residual ||H y - theta y||, which is trustworthy even when the rolling
  recurrence loses orthogonality (for a Hermitian H, |theta - lambda| <=
  ||r|| holds unconditionally — including degenerate levels). A plain
  unrestarted run with the reference's stagnation test can drift below the
  true eigenvalue by ~1e-6 at large m (classic Paige loss-of-orthogonality);
  restarting bounds each cycle's Krylov length so the drift never exceeds
  the explicit-residual gate.
- ``lanczos_dynamics`` = "dnmcs": fixed-step a/b recording for
  continued-fraction resolvents (orthogonality loss is benign there);
- ``energy_scale``     = kpm.cc spectral bounds (128 steps +10% slack).

Operators are callables ``y = op(x)`` on 1-d float64/complex128 tensors.
The coefficients of a cycle stay on the device and are read by the host once
per cycle. Checkpoint hooks are not ported: ``ckpt_key`` raises.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.config import lanczos_precision
from quantum_basis_tpu_torch.solvers.restarted import _project_out
from quantum_basis_tpu_torch.solvers.tridiag import tridiag_eig, tridiag_eigvals

_TINY = 1e-300


def _no_ckpt(ckpt_key):
    if ckpt_key is not None:
        raise NotImplementedError(
            "solver checkpoints are not ported yet (the checkpointing slice)")


def _step(matvec, v_prev, v_cur, b_prev, anchor, deflate):
    """The 2-vector Lanczos recurrence step shared by all three routines.

    Each step re-orthogonalizes w against the cycle's start vector (the
    "anchor"): once the ground state converges, orthogonality loss is
    concentrated along the dominant Ritz direction — which, after the first
    restart, IS the start vector — so this one extra dot+axpy per step
    suppresses the classic Paige drift at 2-vector memory cost.
    Returns (v_next, a, b) with a, b 0-d device tensors."""
    w = matvec(v_cur).to(v_cur.dtype) - b_prev * v_prev
    a = torch.vdot(v_cur, w).real
    w = w - a * v_cur
    w = _project_out(w, (anchor,) + tuple(deflate))
    b = torch.linalg.vector_norm(w)
    inv = torch.where(b > _TINY, 1.0 / torch.clamp(b, min=_TINY), 0.0)
    return w * inv, a, b


def _first_pass(matvec, v0, deflate, inner):
    """``inner`` steps from v0; returns the (a, b) coefficients on the host."""
    v_prev, v_cur = torch.zeros_like(v0), v0
    b_prev = torch.zeros((), dtype=torch.float64, device=v0.device)
    a_l, b_l = [], []
    for _ in range(inner):
        v_next, a, b_prev = _step(matvec, v_prev, v_cur, b_prev, v0, deflate)
        v_prev, v_cur = v_cur, v_next
        a_l.append(a)
        b_l.append(b_prev)
    if not a_l:
        return np.zeros(0), np.zeros(0)
    return (torch.stack(a_l).cpu().numpy(), torch.stack(b_l).cpu().numpy())


def _second_pass(matvec, v0, s_coeff, deflate):
    """y = sum_m s_m v_m, re-orthogonalized against deflate, normalized;
    also returns theta = <y|H|y> and the explicit residual ||H y - theta y||.
    The anchor term: s_0 v_0 is added first, later w's are projected
    against v_0, matching the first pass exactly (deterministic replay)."""
    v_prev, v_cur = torch.zeros_like(v0), v0
    b_prev = torch.zeros((), dtype=torch.float64, device=v0.device)
    y = torch.zeros_like(v0)
    for m, sm in enumerate(s_coeff):
        if m:
            v_next, _, b_prev = _step(matvec, v_prev, v_cur, b_prev, v0,
                                      deflate)
            v_prev, v_cur = v_cur, v_next
        y = y + float(sm) * v_cur
    y = _project_out(y, deflate)
    y = y / torch.clamp(torch.linalg.vector_norm(y), min=_TINY)
    hy = matvec(y).to(y.dtype)
    theta = torch.vdot(y, hy).real
    r = hy - theta * y
    return y, float(theta), float(torch.linalg.vector_norm(r))


def lanczos_ground(
    matvec,
    v0,
    maxit: int = 3000,
    inner: int = 100,
    tol: float = lanczos_precision,
    deflate=(),
    want_vector: bool = True,
    log=None,
    ckpt_key=None,
):
    """Lowest eigenpair of Hermitian ``matvec`` from start vector ``v0``.

    Returns dict with E0, niter, residual (explicit ||Hy - E0 y||), and the
    Ritz ``vector``. ``deflate`` projects out converged eigenvectors each
    step — the reference's "sr_val1" mode for first excited states
    (src/lanczos.cc:218-226). ``maxit`` counts matrix applications.
    """
    _no_ckpt(ckpt_key)
    deflate = tuple(deflate)
    v0 = _project_out(v0, deflate)
    v0 = v0 / torch.linalg.vector_norm(v0)

    # the residual gate: |theta - lambda| <= ||r|| for Hermitian operators,
    # so r_tol directly bounds the eigenvalue error (degeneracy-safe).
    r_tol_abs = None  # set after first theta: max(1e3*tol*scale, 5e-10)

    v = v0
    best = None  # (theta, vector, explicit residual) across cycles
    used = 0
    alphas_last = betas_last = None
    while used < maxit:
        a_np, b_np = _first_pass(matvec, v, deflate, inner)
        # truncate at Krylov breakdown (invariant subspace reached)
        brk = np.nonzero(b_np < 1e-12)[0]
        mcut = int(brk[0]) + 1 if brk.size else inner
        alphas_last, betas_last = a_np[:mcut], b_np[:mcut]
        # optimal-prefix selection: the cheap per-prefix residual estimate
        # |b_m s_{m-1}| locates where within the cycle the Ritz pair was
        # best — later steps may be pure orthogonality-loss noise.
        best_m, best_est, best_s0 = mcut, np.inf, None
        for m in range(2, mcut + 1):
            _, sv_m = tridiag_eig(a_np[:m], b_np[:m])
            est = abs(b_np[m - 1] * sv_m[m - 1, 0])
            if est < best_est:
                best_m, best_est, best_s0 = m, est, sv_m[:, 0].copy()
        if best_s0 is None:
            _, sv_m = tridiag_eig(alphas_last, betas_last)
            best_s0 = sv_m[:, 0].copy()
            best_m = best_s0.size
        # the replay stops at the chosen prefix (the JAX package pads the
        # coefficients with zeros to its fixed cycle length: same vector)
        v, theta, rnorm = _second_pass(matvec, v, best_s0, deflate)
        used += inner + best_m  # first pass + replay + residual matvec
        if log is not None:
            log(used, theta, rnorm)
        if best is None or rnorm < best[2]:
            best = (theta, v, rnorm)
        if r_tol_abs is None:
            r_tol_abs = max(1e3 * tol * max(abs(theta), 1.0), 5e-10)
        if rnorm < r_tol_abs:
            break

    theta, v, rnorm = best
    out = {
        "E0": theta,
        "niter": used,
        "residual": rnorm,
        "residual_bound": rnorm,
        "alphas": alphas_last,
        "betas": betas_last,
    }
    if want_vector:
        out["vector"] = v
    return out


def lanczos_dynamics(matvec, v_start, m_steps: int, ckpt_key=None):
    """Fixed-step Lanczos recording (alphas, betas) — the "dnmcs" mode used
    for continued-fraction dynamical correlation functions
    (reference: model::measure_full_dynamic, src/model.cc:1696-1712).

    ``v_start`` must be normalized by the caller (its norm enters S(q,w)).
    """
    _no_ckpt(ckpt_key)
    return _first_pass(matvec, v_start, (), m_steps)


def energy_scale(matvec, v0, m_steps: int = 128, slack: float = 0.1):
    """Spectral bounds [E_min, E_max] via a short Lanczos run, widened by
    ``slack`` — replaces kpm.cc's ``energy_scale`` (src/kpm.cc:45-99); used
    to rescale H for Chebyshev/KPM iterations.
    """
    v0 = v0 / torch.linalg.vector_norm(v0)
    alphas, betas = lanczos_dynamics(matvec, v0, m_steps)
    keep = np.nonzero(betas < 1e-12)[0]
    mcut = int(keep[0]) + 1 if keep.size else m_steps
    evals = tridiag_eigvals(alphas[:mcut], betas[:mcut])
    e_min, e_max = float(evals[0]), float(evals[-1])
    width = max(e_max - e_min, 1e-10)
    return e_min - slack * width, e_max + slack * width
