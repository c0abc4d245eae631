"""Divide-and-conquer momentum-sector enumeration (Weisse equivalent).

Port of ``quantum_basis_tpu.basis.weisse``. The reference's Weisse machinery
(classify_Weisse_tables + the e/w multi-arrays + zipper,
src/basis.cc:1475-2202, src/model.cc:274-487) exists so the momentum basis
can be enumerated from HALF-lattice bases, O(d^{N/2}) memory, instead of
scanning the d^N product space state by state. Here:

1. split the label space at a digit boundary SA ~ sqrt(label_space) (the
   same contiguous split as the Lin tables; the "zipper" of two half-labels
   is then a single integer add la + ib*SA);
2. enumerate both half bases (each ~sqrt-sized) and evaluate the conserved
   quantum numbers additively per half (Q = Q_A + Q_B - Q_0, valid for the
   site-sum conserved operators the reference supports), on the host;
3. stream the compatible (Q_A, Q_B) cross products through the orbit
   classifier on the device in fixed-size blocks, keeping only
   representatives (orbit minima): no full-sector array ever exists on host
   or device.

The output equals ``enumerate_reps`` over a materialized sector exactly
(tests assert this), so downstream norms and matvecs are unchanged.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from quantum_basis_tpu_torch.basis.lin_table import digit_split
from quantum_basis_tpu_torch.ops.compile import compile_diagonal

_QN_TOL = 1e-5  # quantum-number tolerance (reference: src/basis.cc:1070)


def _half_values(space, conserve_lst, labels_half):
    """Evaluate each conserved operator on half-labels (other half = 0)."""
    if not conserve_lst:
        return np.zeros((0, labels_half.size))
    V = space.decode(labels_half)
    return np.stack([np.asarray(compile_diagonal(m, space)(V))
                     for m in conserve_lst])


def rep_mask(tset, lab: torch.Tensor) -> torch.Tensor:
    """True where a label is the minimum of its translation orbit."""
    V = tset.space.decode(lab)
    tl, _ = tset.transform_all(V, tset.fermion_counts(V))
    return tl.min(dim=-1).values == lab


def enumerate_reps_dnc(tset, conserve_lst=None, val_lst=None,
                       block: int = 1 << 20, with_dim: bool = False,
                       tile_select=None, sort: bool = True):
    """Momentum representatives without materializing the sector.

    Returns sorted representative labels; with ``with_dim`` also the total
    sector dimension (counted during the stream). Matches
    ``enumerate_reps(tset, enumerate_basis(...))`` exactly. The candidates
    of a block go to ``tset.device``; only the kept labels come back.

    The streamed tiles are numbered in a fixed order;
    ``tile_select=(rank, nranks)`` processes only the tiles i with
    i % nranks == rank (and counts only their states in the dim), for a rank
    of a group enumerating its share (parallel/enumerate_sharded.py);
    ``sort=False`` leaves the kept labels in stream order.
    """
    space = tset.space
    conserve_lst = list(conserve_lst or [])
    vals = np.asarray([float(v) for v in (val_lst or [])])
    sa = digit_split(space)
    total = int(space.label_space)
    sb = (total + sa - 1) // sa

    la = np.arange(sa, dtype=np.int64)
    lb = np.arange(sb, dtype=np.int64) * sa
    qa = _half_values(space, conserve_lst, la)          # (m, sa)
    qb = _half_values(space, conserve_lst, lb)          # (m, sb)
    q0 = (_half_values(space, conserve_lst,
                       np.zeros(1, dtype=np.int64))[:, 0]
          if conserve_lst else np.zeros(0))

    reps = []
    dim = 0
    tile_no = 0

    def process(cands):
        """One streamed tile, distributable round-robin by its number."""
        nonlocal dim, tile_no
        i = tile_no
        tile_no += 1
        if tile_select is not None and i % tile_select[1] != tile_select[0]:
            return
        dim += cands.size
        for start in range(0, cands.size, block):
            lab = torch.as_tensor(cands[start:start + block],
                                  device=tset.device)
            kept = lab[rep_mask(tset, lab)]
            if kept.numel():
                reps.append(kept.cpu().numpy())

    if not conserve_lst:
        for start_b in range(sb):
            process(lb[start_b] + la)
    else:
        # bucket half-labels by their rounded conserved-value tuples
        def keys(q):
            return [tuple(col) for col in
                    np.round(q / _QN_TOL).astype(np.int64).T]

        target = tuple(np.round((vals + q0) / _QN_TOL).astype(np.int64))
        groups_a = defaultdict(list)
        for i, k in enumerate(keys(qa)):
            groups_a[k].append(i)
        groups_b = defaultdict(list)
        for i, k in enumerate(keys(qb)):
            groups_b[k].append(i)
        for k_a, idx_a in groups_a.items():
            k_need = tuple(np.asarray(target) - np.asarray(k_a))
            idx_b = groups_b.get(k_need)
            if not idx_b:
                continue
            A = la[np.asarray(idx_a)]
            B = lb[np.asarray(idx_b)]
            # stream the cross product in row strips of bounded size
            rows_per = max(1, block // max(A.size, 1))
            for start in range(0, B.size, rows_per):
                process((B[start:start + rows_per, None]
                         + A[None, :]).reshape(-1))

    out = (np.concatenate(reps) if reps else np.empty(0, dtype=np.int64))
    if sort:
        out = np.sort(out)
    return (out, dim) if with_dim else out
