"""Host-side tridiagonal eigensolve (the reference's ``hess_eigen``).

Port of ``quantum_basis_tpu.solvers.tridiag`` (numpy/scipy, unchanged).

The Lanczos tridiagonal is tiny (m <= a few thousand); solving it on host
per convergence check mirrors the reference's LAPACK ``dstedc`` call
(reference: src/lanczos.cc:355-390) and keeps the device loop free of
data-dependent control flow.
"""

from __future__ import annotations

import numpy as np

try:  # scipy may or may not be present; numpy fallback is fine at these sizes
    from scipy.linalg import eigh_tridiagonal as _eigh_tri
except Exception:  # pragma: no cover
    _eigh_tri = None


def tridiag_eigvals(alpha: np.ndarray, beta: np.ndarray) -> np.ndarray:
    """Eigenvalues of the symmetric tridiagonal (diag alpha, offdiag beta[1:m])."""
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    m = alpha.size
    if m == 1:
        return alpha.copy()
    off = beta[: m - 1] if beta.size >= m - 1 else beta
    if _eigh_tri is not None:
        return _eigh_tri(alpha, off, eigvals_only=True)
    T = np.diag(alpha) + np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigvalsh(T)


def tridiag_eig(alpha: np.ndarray, beta: np.ndarray):
    """(eigenvalues ascending, eigenvectors columns) of the tridiagonal."""
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    m = alpha.size
    if m == 1:
        return alpha.copy(), np.ones((1, 1))
    off = beta[: m - 1]
    if _eigh_tri is not None:
        return _eigh_tri(alpha, off)
    T = np.diag(alpha) + np.diag(off, 1) + np.diag(off, -1)
    return np.linalg.eigh(T)
