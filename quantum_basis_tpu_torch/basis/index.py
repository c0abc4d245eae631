"""Basis index: label -> row position lookup on the device.

Port of ``quantum_basis_tpu.basis.index`` with its three lookup strategies
(src/basis.cc:1193-1348, src/model.cc:266-270):

- ``direct``: an O(1) dense position table over the whole label space,
  chosen when the label space is at most the device's
  ``direct_lookup_max`` (``config.MEMORY``);
- ``lin``: two gathers through the Lin tables of
  :mod:`quantum_basis_tpu_torch.basis.lin_table`, tried above that size when
  a split point is given; a basis with no consistent Lin assignment falls
  back to
- ``bsearch``: ``torch.searchsorted`` over the sorted label array.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.lin_table import LinTable, LinTableError


class IndexTables(NamedTuple):
    """The device arrays of one index, as a kernel reads them: ``t0`` is the
    position table (``direct``), ``Ja`` (``lin``, with ``t1`` = ``Jb`` and
    ``sa`` the split) or the sorted labels (``bsearch``); ``labels`` are the
    sorted basis labels in every mode (for checked lookups). The position
    table holds int32 rows: a direct index takes fewer than 2 ** 31 of
    them. With ``absent`` it holds n for every label not in the basis (a
    row past the last: a kernel needs no check of the label there), else
    0."""

    mode: str
    t0: torch.Tensor
    t1: torch.Tensor | None
    sa: int
    label_space: int
    n: int
    labels: torch.Tensor
    absent: bool = False


def lookup_tables(ix: IndexTables, tgt: torch.Tensor) -> torch.Tensor:
    """Row indices (int64) of target labels (any shape) through ``ix``; a
    label not in the basis maps to an arbitrary in-range row."""
    if ix.mode == "direct":    # the int32 position table
        j = ix.t0[tgt.clamp(0, ix.label_space - 1)].long()
        return j.clamp(max=max(ix.n - 1, 0)) if ix.absent else j
    if ix.mode == "lin":
        t = tgt.clamp(0, ix.label_space - 1)
        j = ix.t0[t % ix.sa] + ix.t1[t // ix.sa]
        return j.clamp(0, max(ix.n - 1, 0))
    idx = torch.searchsorted(ix.t0, tgt.contiguous())
    return idx.clamp(0, max(ix.n - 1, 0))


class BasisIndex:
    """Sorted basis labels + device lookup ``labels -> row index``.

    ``lookup(tgt)`` returns int64 row indices; labels not in the basis map to
    an arbitrary in-range row — ``lookup_checked`` also returns a validity
    mask. ``absent_row``: a direct table holds n for the labels not in the
    basis (``IndexTables.absent``; the momentum-sector kernels read it so).
    """

    def __init__(self, labels: np.ndarray, label_space: int,
                 mode: str | None = None, lin_split: int | None = None,
                 device="cuda", absent_row: bool = False):
        labels = np.asarray(labels, dtype=np.int64)
        if labels.size and np.any(labels[1:] <= labels[:-1]):
            raise ValueError("basis labels must be sorted strictly ascending")
        self.n = int(labels.size)
        self.label_space = int(label_space)
        if mode is None:
            if self.label_space <= config.memory("direct_lookup_max",
                                                 device) \
                    and self.n < 2 ** 31:
                mode = "direct"
            elif lin_split is not None and self.n:
                mode = "lin"  # try Lin; fall back to bsearch below
            else:
                mode = "bsearch"
        if mode not in ("direct", "lin", "bsearch"):
            raise ValueError(f"unknown index mode {mode!r}")
        self.labels = torch.as_tensor(labels, device=device)
        if mode == "lin":
            if lin_split is None:
                raise ValueError("index mode 'lin' needs lin_split")
            try:
                lt = LinTable(labels, self.label_space, int(lin_split))
                self._Ja = torch.as_tensor(lt.Ja, device=device)
                self._Jb = torch.as_tensor(lt.Jb, device=device)
                self._sa = int(lin_split)
            except LinTableError:
                # graceful fallback, reference: src/model.cc:266-270
                mode = "bsearch"
        if mode == "direct":
            # int32 rows: half the bytes of an int64 table, which the row
            # kernels gather from at every image (ops/apply.py)
            if self.n >= 2 ** 31:
                raise ValueError("a direct index holds int32 rows; take "
                                 "'lin' or 'bsearch' for 2 ** 31 or more")
            pos = np.full(self.label_space, self.n if absent_row else 0,
                          dtype=np.int32)
            pos[labels] = np.arange(self.n, dtype=np.int32)
            self._pos = torch.as_tensor(pos, device=device)
        self.mode = mode
        self.absent = absent_row and mode == "direct"

    @property
    def tables(self) -> IndexTables:
        """The arrays :func:`lookup_tables` and the row kernels read."""
        if self.mode == "direct":
            t0, t1, sa = self._pos, None, 0
        elif self.mode == "lin":
            t0, t1, sa = self._Ja, self._Jb, self._sa
        else:
            t0, t1, sa = self.labels, None, 0
        return IndexTables(self.mode, t0, t1, sa, self.label_space, self.n,
                           self.labels, self.absent)

    def lookup(self, tgt: torch.Tensor) -> torch.Tensor:
        """Row indices of target labels (any shape); invalid -> arbitrary."""
        return lookup_tables(self.tables, tgt)

    def lookup_checked(self, tgt: torch.Tensor):
        """(indices, valid mask) — valid iff the label is in the basis."""
        idx = self.lookup(tgt)
        return idx, self.labels[idx] == tgt
