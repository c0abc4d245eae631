"""Deterministic Lehmer-LCG random starts for reproducible Krylov runs.

Port of ``quantum_basis_tpu.utils.rng`` (numpy, unchanged), so both packages
start their Krylov solves from the same vector. Bit-for-bit port of the
*behavior* of the reference's ``vec_randomize``
(reference: src/miscellaneous.cc:371-388): a minstd_rand0 (Lehmer 16807)
generator filling a vector with uniforms in [-1, 1) followed by L2
normalization, and the seed=0 special case of a uniform 1/sqrt(n) vector.
Deterministic starts make Lanczos regressions reproducible against golden
values. Generation happens on host (numpy) — it is O(n) once per solve — and
is then placed on device.
"""

from __future__ import annotations

import numpy as np

_LEHMER_A = 16807
_LEHMER_M = 2147483647  # 2**31 - 1


def lehmer_stream(seed: int, n: int) -> np.ndarray:
    """First n states of minstd_rand0 from the given seed (seed must be > 0).

    Log-doubling: out[k:2k] = out[:k] * A^k mod M — bit-identical to the
    sequential recurrence (states < 2^31, products fit int64) but O(log n)
    numpy passes instead of a Python loop (8 s -> 0.1 s at 2^24)."""
    if seed <= 0:
        raise ValueError("Lehmer seed must be positive")
    if n == 0:
        return np.empty(0, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    out[0] = (seed % _LEHMER_M) * _LEHMER_A % _LEHMER_M
    k = 1
    a_k = _LEHMER_A  # A^k mod M
    while k < n:
        m = min(k, n - k)
        out[k:k + m] = out[:m] * a_k % _LEHMER_M
        a_k = a_k * a_k % _LEHMER_M
        k *= 2
    return out


def vec_randomize(n: int, seed: int = 1, complex_valued: bool = False):
    """Deterministic normalized random start vector.

    Returns (re, im) with im=None for real. seed=0 gives the uniform
    1/sqrt(n) vector, matching the reference's special case.
    """
    if seed == 0:
        re = np.full(n, 1.0 / np.sqrt(n), dtype=np.float64)
        return (re, np.zeros(n) if complex_valued else None)
    m = 2 * n if complex_valued else n
    stream = lehmer_stream(seed, m)
    u = stream.astype(np.float64) / _LEHMER_M  # in (0, 1)
    vals = 2.0 * u - 1.0
    if complex_valued:
        re, im = vals[0::2].copy(), vals[1::2].copy()
        nrm = np.sqrt(np.sum(re * re + im * im))
        return re / nrm, im / nrm
    nrm = np.linalg.norm(vals)
    return vals / nrm, None
