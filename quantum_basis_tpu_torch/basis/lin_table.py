"""Generalized Lin tables: label -> row index via two small gathers.

Port of ``quantum_basis_tpu.basis.lin_table`` (numpy host code), the
redesign of the reference's Lin-table machinery (``fill_Lin_table`` +
``ALGraph::BSF_set_JaJb``, src/basis.cc:1193-1348,
src/miscellaneous.cc:640-708): a basis row index is recovered as

    j = Ja[label % SA] + Jb[label // SA]

where SA is a digit-aligned split of the mixed-radix label space. Labels are
mixed-radix integers (slot 0 least significant), so splitting at a stride
boundary makes (i_b, i_a) = (label // SA, label % SA) the analog of the
reference's sublattice labels, and ascending label order IS Lin order: no
re-sort is needed (the reference sorts the basis by (I_b, I_a) first,
src/basis.cc:1144-1190).

The two tables have ~sqrt(label_space) entries each, against the
O(label_space) direct position table, and the lookup is 2 gathers instead of
log(n) binary-search rounds.

Construction solves the constraint system Ja[ia] + Jb[ib] = j over all basis
states by vectorized BFS label propagation in numpy (per-component gauge
seeding + alternating scatter rounds), then validates every constraint. On
failure (e.g. momentum-sector representative subsets, which are not
Lin-consistent) ``LinTableError`` is raised and callers fall back to binary
search, like the reference (src/model.cc:266-270).
"""

from __future__ import annotations

import numpy as np


class LinTableError(ValueError):
    """No consistent Lin assignment exists for this basis/split."""


def digit_split(space, target: float | None = None) -> int:
    """Digit-aligned split point SA ~ sqrt(label_space) for a StateSpace."""
    strides = np.asarray(space.strides, dtype=np.int64)
    total = int(space.label_space)
    goal = float(target) if target is not None else float(total) ** 0.5
    # candidate split = any slot stride (label % stride keeps whole digits)
    cands = sorted(set(int(s) for s in strides if 1 < s < total))
    if not cands:
        return max(1, int(total))
    return min(cands, key=lambda s: abs(np.log(s / goal)))


class LinTable:
    """Ja/Jb tables for one sorted basis; raises LinTableError if impossible."""

    def __init__(self, labels: np.ndarray, label_space: int, sa: int,
                 max_rounds: int = 10000):
        labels = np.asarray(labels, dtype=np.int64)
        n = labels.size
        self.sa = int(sa)
        self.sb = int((label_space + sa - 1) // sa)
        ia = labels % sa
        ib = labels // sa
        j = np.arange(n, dtype=np.int64)

        Ja = np.zeros(self.sa, dtype=np.int64)
        Jb = np.zeros(self.sb, dtype=np.int64)
        ka = np.zeros(self.sa, dtype=bool)   # known masks
        kb = np.zeros(self.sb, dtype=bool)

        unresolved = np.ones(n, dtype=bool)
        rounds = 0
        while unresolved.any():
            rounds += 1
            if rounds > max_rounds:
                raise LinTableError("Lin BFS did not converge")
            prog = False
            # propagate Ja -> Jb
            m = unresolved & ka[ia] & ~kb[ib]
            if m.any():
                Jb[ib[m]] = j[m] - Ja[ia[m]]
                kb[ib[m]] = True
                prog = True
            # propagate Jb -> Ja
            m = unresolved & kb[ib] & ~ka[ia]
            if m.any():
                Ja[ia[m]] = j[m] - Jb[ib[m]]
                ka[ia[m]] = True
                prog = True
            unresolved &= ~(ka[ia] & kb[ib])
            if not prog and unresolved.any():
                # seed a new connected component (gauge: Ja = 0 there)
                e = int(np.argmax(unresolved))
                ka[ia[e]] = True
                Ja[ia[e]] = 0
        # validation pass (reference: src/basis.cc:1335-1343)
        if not np.array_equal(Ja[ia] + Jb[ib], j):
            raise LinTableError("inconsistent Lin constraints for this basis")
        self.Ja = Ja
        self.Jb = Jb
        self.n = n

    def lookup_np(self, tgt: np.ndarray) -> np.ndarray:
        """Host lookup (for tests); invalid labels return arbitrary indices."""
        tgt = np.asarray(tgt, dtype=np.int64)
        ia = np.clip(tgt % self.sa, 0, self.sa - 1)
        ib = np.clip(tgt // self.sa, 0, self.sb - 1)
        return np.clip(self.Ja[ia] + self.Jb[ib], 0, max(self.n - 1, 0))
