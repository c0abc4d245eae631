"""Sector-filtered basis enumeration as a chunked scan on the device.

Port of ``quantum_basis_tpu.basis.enumerate.enumerate_basis`` (its device
chunk scan): candidate labels are generated as ``arange`` chunks, decoded to
slot values, filtered by the conserved diagonal operators, and kept in
ascending label order (reference: src/basis.cc:998-1109). The JAX package's
combinatorial divide-and-conquer path gives the same sorted labels and is
not ported yet, so this scan is O(label space).
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.ops.compile import compile_diagonal

_QN_TOL = 1e-5  # quantum-number match tolerance (reference: basis.cc:1068)


def enumerate_basis(space: StateSpace, conserve_lst=None, val_lst=None,
                    device="cuda", chunk: int = 1 << 20) -> np.ndarray:
    """Enumerate all labels whose conserved diagonal quantum numbers match.

    Parameters mirror ``model::enumerate_basis_full`` (reference:
    src/model.cc:253-271): ``conserve_lst`` is a list of diagonal Mopr,
    ``val_lst`` the target values. The scan runs on ``device``; returns
    sorted int64 labels as a host array.
    """
    conserve_lst = conserve_lst or []
    val_lst = val_lst or []
    if len(conserve_lst) != len(val_lst):
        raise ValueError("conserve_lst and val_lst must have equal length")
    total = space.label_space
    if not conserve_lst:
        return np.arange(total, dtype=np.int64)
    evals = [compile_diagonal(m, space) for m in conserve_lst]
    vals = [float(v) for v in val_lst]
    keep = []
    for start in range(0, total, chunk):
        labels = torch.arange(start, min(start + chunk, total),
                              dtype=torch.int64, device=device)
        V = space.decode(labels)
        ok = torch.ones(labels.shape, dtype=torch.bool, device=device)
        for ev, v in zip(evals, vals):
            ok &= (ev(V) - v).abs() < _QN_TOL
        keep.append(labels[ok])
    return torch.cat(keep).cpu().numpy()
