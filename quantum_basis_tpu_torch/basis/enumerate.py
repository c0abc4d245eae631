"""Sector-filtered basis enumeration.

Port of ``quantum_basis_tpu.basis.enumerate``. Two paths give the same
sorted int64 labels (reference: src/basis.cc:998-1109):

- :func:`enumerate_basis_dnc`, the combinatorial divide-and-conquer over
  slot groups (host numpy), O(sector size); tried first at every size, it
  serves every conserved operator that is a sum of single-slot diagonals;
- the chunked scan on the device for the rest: candidate labels are
  generated as ``arange`` chunks, decoded to slot values, filtered by the
  conserved diagonal operators and kept in ascending order, O(label space).
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.ops.compile import compile_diagonal

_QN_TOL = 1e-5  # quantum-number match tolerance (reference: basis.cc:1068)


def _per_slot_tables(mopr, space):
    """Decompose an additive diagonal Mopr into per-slot value tables.

    Returns (tables, const) with ``tables[s][v]`` the slot-s contribution,
    or None when a term couples several slots (non-separable — rare for
    conserved quantities, which are sums of single-site operators)."""
    tabs = [np.zeros(int(space.dims[s])) for s in range(space.n_slots)]
    const = 0.0
    for t in mopr.terms:
        if t.q_identity():
            const += complex(t.coeff).real
            continue
        slots = t.slots(space)
        if len(slots) != 1 or len(t.factors) != 1:
            return None
        d = np.asarray(t.factors[0].mat)
        if d.ndim != 1:
            # Non-diagonal factor: the scan path's compile_diagonal raises
            # for this; silently taking np.diagonal here would produce a
            # wrong basis. Fall back (-> caller raises the same error).
            off = d - np.diag(np.diagonal(d))
            if np.abs(off).max(initial=0.0) > 1e-12:
                return None
            d = np.diagonal(d)
        if np.abs(np.imag(d)).max(initial=0.0) > 1e-12 \
                or abs(complex(t.coeff).imag) > 1e-12:
            return None
        tabs[int(slots[0])] = tabs[int(slots[0])] \
            + complex(t.coeff).real * np.real(d)
    return tabs, const



def enumerate_basis_dnc(space: StateSpace, conserve_lst, val_lst,
                        leaf: int = 1 << 22, tol: float = _QN_TOL,
                        tile_select=None, sort: bool = True,
                        n_parts: int | None = None):
    """Combinatorial sector enumeration by divide-and-conquer over slots.

    The chunked scan is O(d^N) regardless of sector size — hopeless
    at 3^31 (t-J on the 31-site cluster) or 4^16 (Fermi-Hubbard 4x4). For
    ADDITIVE conserved quantities QN(label) = sum_s qn_s(v_s), partial sums
    factorize over slot groups: enumerate each half of the slots bucketed
    by partial QN (windowed by what the complement can still contribute),
    then join complementary buckets — meet-in-the-middle, O(sector size +
    sqrt-ish work), the same count-constrained recursion the reference's
    basis generation performs per-site (src/basis.cc:998-1109) but
    vectorized over whole slot groups. Returns None when any conserved
    operator is not separable (caller falls back to the scan). Host numpy;
    the sorted int64 labels equal the scan's.

    The top-level join is a list of cross-product tiles in a fixed order
    (sorted bucket keys). ``tile_select=(rank, nranks)`` computes only the
    tiles i with i % nranks == rank (``sort=False`` leaves them unsorted),
    for a rank of a group enumerating its share
    (parallel/enumerate_sharded.py); ``n_parts`` returns every rank's share
    from one pass, as a list.
    """
    ops = []
    for m, v in zip(conserve_lst, val_lst):
        r = _per_slot_tables(m, space)
        if r is None:
            return None
        tabs, const = r
        ops.append((tabs, float(v) - const))
    S = space.n_slots
    dims = [int(d) for d in space.dims]
    strides = [int(s) for s in space.strides]
    nops = len(ops)
    mins = np.array([[t[s].min() for s in range(S)] for (t, _) in ops])
    maxs = np.array([[t[s].max() for s in range(S)] for (t, _) in ops])
    targets = np.array([tv for (_, tv) in ops])

    def window(a, b):
        """Feasible partial-QN interval for slot group [a, b)."""
        out = np.ones(S, dtype=bool)
        out[a:b] = False
        lo = targets - maxs[:, out].sum(axis=1) - tol
        hi = targets - mins[:, out].sum(axis=1) + tol
        return lo, hi

    def bucketize(labels, qn):
        key = np.round(qn * 4096.0).astype(np.int64)  # QNs are (half-)ints
        out = {}
        if labels.size == 0:
            return out
        order = np.lexsort(key)
        key = key[:, order]
        labels = labels[order]
        qn = qn[:, order]
        cuts = np.nonzero(np.any(np.diff(key, axis=1) != 0, axis=0))[0] + 1
        starts = np.concatenate([[0], cuts, [labels.size]])
        for i in range(starts.size - 1):
            s0 = int(starts[i])
            out[tuple(key[:, s0])] = (labels[starts[i]:starts[i + 1]],
                                      qn[:, s0].copy())
        return out

    def rec(a, b):
        """dict: quantized-QN tuple -> (partial labels, qn vector)."""
        lo, hi = window(a, b)
        size = int(np.prod([dims[s] for s in range(a, b)], dtype=np.int64))
        if size <= leaf:
            sub = np.arange(size, dtype=np.int64)
            labels = np.zeros(size, dtype=np.int64)
            qn = np.zeros((nops, size))
            c = sub
            for s in range(a, b):
                dig = c % dims[s]
                c = c // dims[s]
                labels += dig * strides[s]
                for i, (tabs, _) in enumerate(ops):
                    qn[i] += tabs[s][dig]
            keep = np.all((qn >= lo[:, None]) & (qn <= hi[:, None]), axis=0)
            return bucketize(labels[keep], qn[:, keep])
        mid = (a + b) // 2
        left = rec(a, mid)
        right = rec(mid, b)
        if len(left) > len(right):  # iterate the smaller bucket set outside
            left, right = right, left
        out = {}
        for kl, (ll, ql) in left.items():
            for kr, (lr, qr) in right.items():
                q = ql + qr
                if np.any(q < lo - tol) or np.any(q > hi + tol):
                    continue
                lab = (ll[:, None] + lr[None, :]).ravel()
                key = tuple(np.round(q * 4096.0).astype(np.int64))
                if key in out:
                    prev_lab, prev_q = out[key]
                    out[key] = (np.concatenate([prev_lab, lab]), prev_q)
                else:
                    out[key] = (lab, q)
        return out

    def tiles():
        """The top-level join's tiles (left, right) in a fixed order."""
        mid = S // 2
        left = rec(0, mid)
        right = rec(mid, S)
        for kl in sorted(left):
            ll, ql = left[kl]
            for kr in sorted(right):
                lr, qr = right[kr]
                if np.all(np.abs(ql + qr - targets) < tol):
                    yield ll, lr

    top_size = int(np.prod(dims, dtype=np.int64))
    if n_parts is not None:
        # ONE pass producing every rank's round-robin tile subset: the
        # meet-in-the-middle halves are computed once and shared, instead
        # of once per rank as a tile_select loop would pay
        parts = [[] for _ in range(n_parts)]
        for i, (ll, lr) in enumerate(tiles()):
            parts[i % n_parts].append((ll[:, None] + lr[None, :]).ravel())
        return [np.concatenate(p) if p else np.empty(0, np.int64)
                for p in parts]
    keep = []
    if tile_select is None and (top_size <= leaf or S < 2):
        top = rec(0, S)
        keep = [lab for lab, q in top.values()
                if np.all(np.abs(q - targets) < tol)]
    else:
        # explicit top-level join, so that the tiles can be distributed:
        # tile i is computed only when i % nranks == rank; the union over
        # ranks is exactly the single-rank output
        for i, (ll, lr) in enumerate(tiles()):
            if tile_select is not None \
                    and i % tile_select[1] != tile_select[0]:
                continue
            keep.append((ll[:, None] + lr[None, :]).ravel())
    if not keep:
        return np.empty(0, dtype=np.int64)
    out = np.concatenate(keep)
    return np.sort(out) if sort else out


def enumerate_basis(space: StateSpace, conserve_lst=None, val_lst=None,
                    device="cuda", chunk: int = 1 << 20) -> np.ndarray:
    """Enumerate all labels whose conserved diagonal quantum numbers match.

    Parameters mirror ``model::enumerate_basis_full`` (reference:
    src/model.cc:253-271): ``conserve_lst`` is a list of diagonal Mopr,
    ``val_lst`` the target values. Returns sorted int64 labels as a host
    array. The divide-and-conquer path runs first; a conserved operator that
    is not separable over slots falls through to the scan on ``device``.
    """
    conserve_lst = conserve_lst or []
    val_lst = val_lst or []
    if len(conserve_lst) != len(val_lst):
        raise ValueError("conserve_lst and val_lst must have equal length")
    total = space.label_space
    if not conserve_lst:
        return np.arange(total, dtype=np.int64)
    labels = enumerate_basis_dnc(space, conserve_lst, val_lst)
    if labels is not None:
        return labels
    return _enumerate_scan(space, conserve_lst, val_lst, device, chunk)


def _enumerate_scan(space, conserve_lst, val_lst, device, chunk=1 << 20):
    """The O(label space) chunked scan on ``device``."""
    total = space.label_space
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
