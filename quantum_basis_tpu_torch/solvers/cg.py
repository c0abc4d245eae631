"""Conjugate-gradient eigenvector refinement.

Port of ``quantum_basis_tpu.solvers.cg`` (the reference's ``eigenvec_CG``,
src/lanczos.cc:281-341): given a converged eigenvalue E0, drive
(H - E0) v -> 0 by CG with the restart-on-renormalize logic of the reference
(re-normalize v, recompute r = (E0 - H) v, restart the Krylov direction).
The loop runs on the host and reads the residual norm once per iteration;
on an operator that carries a basis mesh the inner products and norms are
summed over the ranks (solvers/reduce.py).

Use cases match the reference: polish an eigenvector from a coarser solve
(e.g. a mixed-precision Lanczos run) to full f64 solver tolerance, or
recover V0/V1 from checkpointed energies without storing Krylov bases.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.solvers.reduce import (
    ckpt_store,
    dot,
    mesh_of,
    norm,
)
from quantum_basis_tpu_torch.utils import ckpt


def eigenvec_cg(matvec, E0: float, v0: torch.Tensor, maxit: int = 1000,
                tol: float = 2e-12, ckpt_key=None, ckpt_every: int = 500):
    """Refine v0 toward the E0 eigenvector.

    ``matvec`` is a callable on 1-d float64/complex128 tensors. Returns
    (v, residual_norm, iterations). The residual is ||(H - E0) v|| with
    ||v|| = 1 (the reference's `accu`).

    With ``ckpt_key`` set and config.enable_ckpt, the run checkpoints every
    ``ckpt_every`` iterations (reference: the CG branch of
    src/ckpt.cc:343-516). Only the current iterate v and the count are
    saved: on resume CG restarts its Krylov direction from v, which the
    reference's own restart-on-renormalize logic does periodically anyway.
    """
    E0 = float(E0)
    complex_vec = v0.is_complex()
    store = ckpt_store(matvec, ckpt_key)
    mesh = mesh_of(matvec)

    def hs(x):
        """(H - E0) x."""
        return matvec(x).to(x.dtype) - E0 * x

    def restart(v):
        v = v / torch.clamp(norm(v, mesh), min=1e-300)
        r = -hs(v)                                      # r = (E0 - H) v
        return v, r, r, float(norm(r, mesh))

    def save_state(m_now, vc):
        v_re, v_im = ckpt.split_vec(store.whole(vc), complex_vec)
        store.save(ckpt_key, {"m": m_now, "E0": E0, "v_re": v_re,
                              "v_im": v_im})

    m = 1
    if store is not None:
        # Resume only when the record matches THIS problem: shape AND the
        # eigenvalue it was polishing toward. A same-key record from a run
        # with a different E0/Hamiltonian would converge to a wrong vector.
        shape = (store.length(v0),)
        rec = store.load(ckpt_key, vectors=("v_re", "v_im"), fits=lambda r: (
            r["v_re"].shape == shape and abs(float(r.get("E0", E0)) - E0)
            <= 1e-8 * max(1.0, abs(E0))))
        if rec is not None:
            m = int(rec["m"]) + 1
            v0 = ckpt.join_vec(rec["v_re"], rec["v_im"], complex_vec,
                               v0.device, v0.real.dtype)

    v, r, p, gamma = restart(v0)
    done = False
    next_save = m + ckpt_every if store is not None else np.inf
    while m < maxit:
        if m >= next_save:
            save_state(m, v)
            # resuming restarts the direction: do the same now so the saved
            # and in-memory trajectories agree (deterministic replay)
            v, r, p, gamma = restart(v)
            next_save = m + ckpt_every
        m += 1
        if gamma < tol:
            # done if the fresh residual is already converged, or v was
            # already unit-norm (reference: break without restart)
            was_unit = abs(float(norm(v, mesh)) - 1.0) <= tol
            v, r, p, gamma = restart(v)
            if gamma < tol or was_unit:
                done = True
                break
            continue
        pp = hs(p)
        delta = float(dot(p, pp, mesh).real)  # Hermitian H: real
        alpha = gamma * gamma / delta
        v = v + alpha * p
        r = r - alpha * pp
        g2 = float(norm(r, mesh))
        beta = g2 / max(gamma, 1e-300)
        p = r + (beta * beta) * p
        gamma = g2

    if store is not None:
        if done:
            store.delete(ckpt_key)
        else:
            save_state(m, v)  # unconverged: keep for resume
    v = v / norm(v, mesh)
    return v, float(norm(hs(v), mesh)), m
