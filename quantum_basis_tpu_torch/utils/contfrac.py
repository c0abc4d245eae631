"""Continued-fraction evaluation for Lanczos resolvents.

Port of ``quantum_basis_tpu.utils.contfrac`` (numpy, unchanged). Evaluates
a0 + b1/(a1 + b2/(a2 + ...)) from the tridiagonal Lanczos coefficients — the
Green's-function kernel behind dynamical structure factors (reference:
src/miscellaneous.cc:341-349, math at src/qbasis.h:1505-1521). Vectorized
over an array of (complex) evaluation points z.
"""

from __future__ import annotations

import numpy as np


def continued_fraction(a, b) -> complex:
    """Scalar continued fraction a[0] + b[1]/(a[1] + b[2]/(...)).

    Matches the reference convention: b[0] is ignored; the deepest level is
    a[-1]. Inputs are 1-d arrays of equal length.
    """
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape or a.ndim != 1 or a.size == 0:
        raise ValueError("a and b must be equal-length 1-d arrays")
    res = a[-1]
    for j in range(a.size - 2, -1, -1):
        res = a[j] + b[j + 1] / res
    return res


def greens_function(z, norm2, alpha, beta) -> np.ndarray:
    """G(z) = norm2 / (z - a0 - b1^2/(z - a1 - b2^2/(...))) over points z.

    alpha/beta are the Lanczos diagonal/off-diagonal coefficients from a
    "dnmcs" run (beta[0] unused); norm2 = |A|phi>|^2. The dynamical structure
    factor is S(q, w) = -Im G(w + E0 + i*eta) / pi.
    """
    z = np.asarray(z, dtype=np.complex128)
    alpha = np.asarray(alpha, dtype=np.float64)
    beta = np.asarray(beta, dtype=np.float64)
    m = alpha.size
    res = z - alpha[m - 1]
    for j in range(m - 2, -1, -1):
        res = z - alpha[j] - beta[j + 1] ** 2 / res
    return norm2 / res
