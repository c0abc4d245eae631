"""Conjugate-gradient eigenvector refinement.

Port of ``quantum_basis_tpu.solvers.cg`` (the reference's ``eigenvec_CG``,
src/lanczos.cc:281-341): given a converged eigenvalue E0, drive
(H - E0) v -> 0 by CG with the restart-on-renormalize logic of the reference
(re-normalize v, recompute r = (E0 - H) v, restart the Krylov direction).
The loop runs on the host and reads the residual norm once per iteration.

Use cases match the reference: polish an eigenvector from a coarser solve
(e.g. a mixed-precision Lanczos run) to full f64 solver tolerance, or
recover V0/V1 from stored energies without storing Krylov bases.
Checkpoint hooks are not ported: ``ckpt_key`` raises.
"""

from __future__ import annotations

import torch


def eigenvec_cg(matvec, E0: float, v0: torch.Tensor, maxit: int = 1000,
                tol: float = 2e-12, ckpt_key=None):
    """Refine v0 toward the E0 eigenvector.

    ``matvec`` is a callable on 1-d float64/complex128 tensors. Returns
    (v, residual_norm, iterations). The residual is ||(H - E0) v|| with
    ||v|| = 1 (the reference's `accu`).
    """
    if ckpt_key is not None:
        raise NotImplementedError(
            "solver checkpoints are not ported yet (the checkpointing slice)")
    E0 = float(E0)

    def hs(x):
        """(H - E0) x."""
        return matvec(x).to(x.dtype) - E0 * x

    def restart(v):
        v = v / torch.clamp(torch.linalg.vector_norm(v), min=1e-300)
        r = -hs(v)                                      # r = (E0 - H) v
        return v, r, r, float(torch.linalg.vector_norm(r))

    v, r, p, gamma = restart(v0)
    m = 1
    while m < maxit:
        m += 1
        if gamma < tol:
            # done if the fresh residual is already converged, or v was
            # already unit-norm (reference: break without restart)
            was_unit = abs(float(torch.linalg.vector_norm(v)) - 1.0) <= tol
            v, r, p, gamma = restart(v)
            if gamma < tol or was_unit:
                break
            continue
        pp = hs(p)
        delta = float(torch.vdot(p, pp).real)  # Hermitian H: real
        alpha = gamma * gamma / delta
        v = v + alpha * p
        r = r - alpha * pp
        g2 = float(torch.linalg.vector_norm(r))
        beta = g2 / max(gamma, 1e-300)
        p = r + (beta * beta) * p
        gamma = g2

    v = v / torch.linalg.vector_norm(v)
    return v, float(torch.linalg.vector_norm(hs(v))), m
