"""Vectorized mixed-radix codecs.

Port of ``quantum_basis_tpu.utils.codec`` (numpy, unchanged). Replaces the
reference's per-element ``dynamic_base`` family
(reference: src/miscellaneous.cc:143-258): digit 0 is the least-significant
digit, identical to the reference's convention. Here encode/decode operate on
whole arrays at once (numpy) instead of one
std::vector at a time; there is no ``plus1`` increment because enumeration is
performed with ``iota`` over the flat code space rather than sequential
increments.
"""

from __future__ import annotations

import numpy as np


def radix_strides(base) -> np.ndarray:
    """Stride (place value) of each digit; digit 0 least significant.

    strides[k] = prod(base[:k]).  int64 throughout; raises on overflow.
    """
    base = np.asarray(base, dtype=np.int64)
    if base.ndim != 1 or base.size == 0:
        raise ValueError("base must be a non-empty 1-d array")
    if np.any(base <= 0):
        raise ValueError("all radices must be positive")
    running = 1
    for k in range(1, base.size):
        running *= int(base[k - 1])  # exact Python int arithmetic
        if running > np.iinfo(np.int64).max // max(int(base[k]), 1):
            raise OverflowError("mixed-radix code space exceeds int64")
    strides = np.ones(base.size, dtype=np.int64)
    strides[1:] = np.cumprod(base[:-1])
    return strides


def radix_encode(digits, base) -> np.ndarray:
    """Encode digit arrays to flat codes. digits shape (..., n), base shape (n,)."""
    base = np.asarray(base, dtype=np.int64)
    digits = np.asarray(digits, dtype=np.int64)
    if digits.shape[-1] != base.size:
        raise ValueError("digits last axis must match base length")
    if np.any(digits < 0) or np.any(digits >= base):
        raise ValueError("digit out of range")
    return digits @ radix_strides(base)


def radix_decode(codes, base) -> np.ndarray:
    """Decode flat codes to digits. codes shape (...,) -> digits (..., n)."""
    base = np.asarray(base, dtype=np.int64)
    codes = np.asarray(codes, dtype=np.int64)
    strides = radix_strides(base)
    return (codes[..., None] // strides) % base


def code_space_size(base) -> int:
    """Total number of codes = prod(base); raises on int64 overflow."""
    base = np.asarray(base, dtype=np.int64)
    strides = radix_strides(base)
    total = int(strides[-1]) * int(base[-1])
    if total <= 0 or total // int(base[-1]) != int(strides[-1]):
        raise OverflowError("code space exceeds int64")
    return total
