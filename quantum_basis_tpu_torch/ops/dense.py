"""Host-side dense matrix construction from compiled term tables.

Port of ``quantum_basis_tpu.ops.dense`` (numpy, unchanged).

Used as (a) the exact oracle in tests (independent of the device apply path)
and (b) the small-sector fallback — the reference similarly falls back to
dense LAPACK ``syevd/heevd`` for dim <= 30 (reference: src/lanczos.cc:508-542).
Pure numpy; builds <j|O|i> directly (no Hermitian row-gather trick), so it
also works for non-Hermitian measurement operators.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch.ops.compile import CompiledOperator, compile_diagonal


def dense_matrix(compiled: CompiledOperator, labels: np.ndarray) -> np.ndarray:
    """O as a dense complex matrix over the given (sorted) basis labels.

    Images outside the basis are dropped (sector-escaping terms), matching
    the device path's behavior.
    """
    space = compiled.space
    labels = np.asarray(labels, dtype=np.int64)
    n = labels.size
    V = space.decode(labels)  # (n, S)
    F = np.take_along_axis(space.fermion_count_table, V.astype(np.int64).T, axis=1).T
    H = np.zeros((n, n), dtype=np.complex128)

    if not compiled.diag_terms.q_zero():
        ev = compile_diagonal(compiled.diag_terms, space)
        H[np.arange(n), np.arange(n)] += ev(V)

    rows = np.arange(n)
    for g in compiled.groups:
        T, D, K = g.dlt.shape
        for t in range(T):
            c = (V[:, g.slots[t]].astype(np.int64) * g.jstrides[t]).sum(axis=1)  # (n,)
            parity = (F.astype(np.int64) @ g.W[t].astype(np.int64)) % 2
            sign = 1.0 - 2.0 * parity
            for k in range(K):
                amp = g.amp_re[t, c, k].astype(np.complex128)
                if g.amp_im is not None:
                    amp = amp + 1j * g.amp_im[t, c, k]
                dlt = g.dlt[t, c, k]
                nz = np.abs(amp) > 0
                if not nz.any():
                    continue
                tgt = labels[nz] + dlt[nz]
                j = np.searchsorted(labels, tgt)
                j_clip = np.clip(j, 0, n - 1)
                ok = labels[j_clip] == tgt
                # amp = <tgt | O | i> including JW string sign
                np.add.at(H, (j_clip[ok], rows[nz][ok]), amp[nz][ok] * sign[nz][ok])
    return H
