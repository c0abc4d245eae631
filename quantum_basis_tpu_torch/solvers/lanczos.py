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
per cycle. With ``ckpt_key`` set and ``config.enable_ckpt`` on,
``lanczos_ground`` saves its iterate after every cycle and
``lanczos_dynamics`` its recurrence state every ``ckpt_chunk`` steps, and
both resume from the record (utils/ckpt.py; same record fields as the JAX
package). On an operator that carries a basis mesh every inner product and
norm is summed over the ranks (solvers/reduce.py).
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.config import lanczos_precision
from quantum_basis_tpu_torch.utils import ckpt
from quantum_basis_tpu_torch.solvers.reduce import (
    ckpt_store,
    dot,
    mesh_of,
    norm,
)
from quantum_basis_tpu_torch.solvers.restarted import _project_out
from quantum_basis_tpu_torch.solvers.tridiag import tridiag_eig, tridiag_eigvals

_TINY = 1e-300


def _step(matvec, v_prev, v_cur, b_prev, anchor, deflate):
    """The 2-vector Lanczos recurrence step shared by all three routines.

    Each step re-orthogonalizes w against the cycle's start vector (the
    "anchor"): once the ground state converges, orthogonality loss is
    concentrated along the dominant Ritz direction — which, after the first
    restart, IS the start vector — so this one extra dot+axpy per step
    suppresses the classic Paige drift at 2-vector memory cost.
    Returns (v_next, a, b) with a, b 0-d device tensors."""
    mesh = mesh_of(matvec)
    w = matvec(v_cur).to(v_cur.dtype) - b_prev * v_prev
    a = dot(v_cur, w, mesh).real
    w = w - a * v_cur
    w = _project_out(w, (anchor,) + tuple(deflate), mesh)
    b = norm(w, mesh)
    inv = torch.where(b > _TINY, 1.0 / torch.clamp(b, min=_TINY), 0.0)
    return w * inv, a, b


def _run_steps(matvec, v_prev, v_cur, b_prev, anchor, deflate, nsteps):
    """``nsteps`` recurrence steps from the state (v_prev, v_cur, b_prev);
    returns the new state and the (a, b) coefficients on the host."""
    a_l, b_l = [], []
    for _ in range(nsteps):
        v_next, a, b_prev = _step(matvec, v_prev, v_cur, b_prev, anchor,
                                  deflate)
        v_prev, v_cur = v_cur, v_next
        a_l.append(a)
        b_l.append(b_prev)
    if not a_l:
        return v_prev, v_cur, b_prev, np.zeros(0), np.zeros(0)
    return (v_prev, v_cur, b_prev, torch.stack(a_l).cpu().numpy(),
            torch.stack(b_l).cpu().numpy())


def _first_pass(matvec, v0, deflate, inner):
    """``inner`` steps from v0; returns the (a, b) coefficients on the host."""
    b0 = torch.zeros((), dtype=torch.float64, device=v0.device)
    return _run_steps(matvec, torch.zeros_like(v0), v0, b0, v0, deflate,
                      inner)[3:]


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
    mesh = mesh_of(matvec)
    y = _project_out(y, deflate, mesh)
    y = y / torch.clamp(norm(y, mesh), min=_TINY)
    hy = matvec(y).to(y.dtype)
    theta = dot(y, hy, mesh).real
    r = hy - theta * y
    return y, float(theta), float(norm(r, mesh))


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
    deflate = tuple(deflate)
    mesh = mesh_of(matvec)
    v0 = _project_out(v0, deflate, mesh)
    v0 = v0 / norm(v0, mesh)
    complex_vec = v0.is_complex()

    # the residual gate: |theta - lambda| <= ||r|| for Hermitian operators,
    # so r_tol directly bounds the eigenvalue error (degeneracy-safe).
    r_tol_abs = None  # set after first theta: max(1e3*tol*scale, 5e-10)

    v = v0
    best = None  # (theta, vector, explicit residual) across cycles
    used = 0
    alphas_last = betas_last = None
    store = ckpt_store(matvec, ckpt_key)
    if store is not None:
        shape = (store.length(v0),)
        rec = store.load(ckpt_key, vectors=("v_re", "v_im", "b_re", "b_im"),
                         fits=lambda r: r["v_re"].shape == shape and (
                             r["v_im"].shape == shape) == complex_vec)
        if rec is not None:
            real_dt = v0.real.dtype
            v = ckpt.join_vec(rec["v_re"], rec["v_im"], complex_vec,
                              v0.device, real_dt)
            best = (float(rec["theta"]),
                    ckpt.join_vec(rec["b_re"], rec["b_im"], complex_vec,
                                  v0.device, real_dt),
                    float(rec["rnorm"]))
            used = int(rec["used"])
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
        if store is not None and (
                store.nbytes(v, complex_vec) + store.nbytes(best[1], complex_vec)
                <= config.memory("ckpt_max_bytes", v.device)):
            # capped like every per-iteration save (the device's
            # ckpt_max_bytes), before the gather
            v_re, v_im = ckpt.split_vec(store.whole(v), complex_vec)
            b_re, b_im = ckpt.split_vec(store.whole(best[1]), complex_vec)
            store.save(ckpt_key, {"v_re": v_re, "v_im": v_im, "b_re": b_re,
                                  "b_im": b_im, "theta": best[0],
                                  "rnorm": best[2], "used": used})
        if r_tol_abs is None:
            r_tol_abs = max(1e3 * tol * max(abs(theta), 1.0), 5e-10)
        if rnorm < r_tol_abs:
            break

    theta, v, rnorm = best
    if store is not None and r_tol_abs is not None and rnorm < r_tol_abs:
        store.delete(ckpt_key)
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


def lanczos_dynamics(matvec, v_start, m_steps: int, ckpt_key=None,
                     ckpt_chunk: int = 64):
    """Fixed-step Lanczos recording (alphas, betas) — the "dnmcs" mode used
    for continued-fraction dynamical correlation functions
    (reference: model::measure_full_dynamic, src/model.cc:1696-1712).

    ``v_start`` must be normalized by the caller (its norm enters S(q,w)).
    With ``ckpt_key`` set and config.enable_ckpt, the run checkpoints every
    ``ckpt_chunk`` steps: the carried state is just (v_prev, v_cur, b) plus
    the coefficients so far, the same record the reference's "dnmcs"
    checkpoint writes (src/ckpt.cc:13-340), and resumes mid-run.
    """
    store = ckpt_store(matvec, ckpt_key)
    if store is None:
        return _first_pass(matvec, v_start, (), m_steps)

    complex_vec = v_start.is_complex()
    real_dt = v_start.real.dtype
    k = 0
    alphas, betas = np.zeros(0), np.zeros(0)
    v_prev, v_cur = torch.zeros_like(v_start), v_start
    b_prev = torch.zeros((), dtype=torch.float64, device=v_start.device)
    # Fingerprint of the start vector: a same-key record from a run against
    # a different source vector (same dim) must not be resumed, because the
    # a/b coefficients would describe a different resolvent.
    # (rank 0's, of the whole vector: rank 0 decides about records)
    s_re, s_im = ckpt.split_vec(store.whole(v_start), complex_vec)
    v_fp = zlib.crc32(s_re.tobytes())
    if complex_vec:
        v_fp = zlib.crc32(s_im.tobytes(), v_fp)
    shape = (store.length(v_start),)
    rec = store.load(ckpt_key, vectors=(
        "v_prev_re", "v_prev_im", "v_cur_re", "v_cur_im"), fits=lambda r: (
            r["v_cur_re"].shape == shape and int(r["m_steps"]) == m_steps
            and int(r.get("v_fp", v_fp)) == v_fp))
    if rec is not None:
        k = int(rec["k"])
        alphas, betas = np.asarray(rec["alphas"]), np.asarray(rec["betas"])
        v_prev = ckpt.join_vec(rec["v_prev_re"], rec["v_prev_im"],
                               complex_vec, v_start.device, real_dt)
        v_cur = ckpt.join_vec(rec["v_cur_re"], rec["v_cur_im"], complex_vec,
                              v_start.device, real_dt)
        b_prev = torch.as_tensor(float(rec["b_prev"]), dtype=torch.float64,
                                 device=v_start.device)

    while k < m_steps:
        n = min(ckpt_chunk, m_steps - k)
        v_prev, v_cur, b_prev, a_np, b_np = _run_steps(
            matvec, v_prev, v_cur, b_prev, v_start, (), n)
        alphas = np.concatenate([alphas, a_np])
        betas = np.concatenate([betas, b_np])
        k += n
        if k < m_steps:
            pr, pi = ckpt.split_vec(store.whole(v_prev), complex_vec)
            cr, ci = ckpt.split_vec(store.whole(v_cur), complex_vec)
            store.save(ckpt_key, {
                "k": k, "m_steps": m_steps, "b_prev": float(b_prev),
                "v_fp": v_fp, "alphas": alphas, "betas": betas,
                "v_prev_re": pr, "v_prev_im": pi,
                "v_cur_re": cr, "v_cur_im": ci})
    store.delete(ckpt_key)
    return alphas, betas


def energy_scale(matvec, v0, m_steps: int = 128, slack: float = 0.1):
    """Spectral bounds [E_min, E_max] via a short Lanczos run, widened by
    ``slack`` — replaces kpm.cc's ``energy_scale`` (src/kpm.cc:45-99); used
    to rescale H for Chebyshev/KPM iterations.
    """
    v0 = v0 / norm(v0, mesh_of(matvec))
    alphas, betas = lanczos_dynamics(matvec, v0, m_steps)
    keep = np.nonzero(betas < 1e-12)[0]
    mcut = int(keep[0]) + 1 if keep.size else m_steps
    evals = tridiag_eigvals(alphas[:mcut], betas[:mcut])
    e_min, e_max = float(evals[0]), float(evals[-1])
    width = max(e_max - e_min, 1e-10)
    return e_min - slack * width, e_max + slack * width
