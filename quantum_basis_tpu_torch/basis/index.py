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

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.lin_table import LinTable, LinTableError


class BasisIndex:
    """Sorted basis labels + device lookup ``labels -> row index``.

    ``lookup(tgt)`` returns int64 row indices; labels not in the basis map to
    an arbitrary in-range row — ``lookup_checked`` also returns a validity
    mask.
    """

    def __init__(self, labels: np.ndarray, label_space: int,
                 mode: str | None = None, lin_split: int | None = None,
                 device="cuda"):
        labels = np.asarray(labels, dtype=np.int64)
        if labels.size and np.any(labels[1:] <= labels[:-1]):
            raise ValueError("basis labels must be sorted strictly ascending")
        self.n = int(labels.size)
        self.label_space = int(label_space)
        if mode is None:
            if self.label_space <= config.memory("direct_lookup_max",
                                                 device):
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
            pos = np.zeros(self.label_space, dtype=np.int64)
            pos[labels] = np.arange(self.n, dtype=np.int64)
            self._pos = torch.as_tensor(pos, device=device)
        self.mode = mode

    def lookup(self, tgt: torch.Tensor) -> torch.Tensor:
        """Row indices of target labels (any shape); invalid -> arbitrary."""
        if self.mode == "direct":
            return self._pos[tgt.clamp(0, self.label_space - 1)]
        if self.mode == "lin":
            t = tgt.clamp(0, self.label_space - 1)
            j = self._Ja[t % self._sa] + self._Jb[t // self._sa]
            return j.clamp(0, max(self.n - 1, 0))
        idx = torch.searchsorted(self.labels, tgt.contiguous())
        return idx.clamp(0, max(self.n - 1, 0))

    def lookup_checked(self, tgt: torch.Tensor):
        """(indices, valid mask) — valid iff the label is in the basis."""
        idx = self.lookup(tgt)
        return idx, self.labels[idx] == tgt
