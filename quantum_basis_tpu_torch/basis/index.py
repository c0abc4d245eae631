"""Basis index: label -> row position lookup on the device.

Port of ``quantum_basis_tpu.basis.index`` with two of its three lookup
strategies (src/basis.cc:1193-1348, src/model.cc:266-270):

- ``direct``: an O(1) dense position table over the whole label space,
  chosen when the label space is at most ``config.direct_lookup_max``;
- ``bsearch``: ``torch.searchsorted`` over the sorted label array.

Lin tables are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch import config


class BasisIndex:
    """Sorted basis labels + device lookup ``labels -> row index``.

    ``lookup(tgt)`` returns int64 row indices; labels not in the basis map to
    an arbitrary in-range row — ``lookup_checked`` also returns a validity
    mask.
    """

    def __init__(self, labels: np.ndarray, label_space: int,
                 mode: str | None = None, device="cuda"):
        labels = np.asarray(labels, dtype=np.int64)
        if labels.size and np.any(labels[1:] <= labels[:-1]):
            raise ValueError("basis labels must be sorted strictly ascending")
        self.n = int(labels.size)
        self.label_space = int(label_space)
        if mode is None:
            mode = ("direct" if self.label_space <= config.direct_lookup_max
                    else "bsearch")
        if mode not in ("direct", "bsearch"):
            raise ValueError(f"unknown or unported index mode {mode!r}")
        self.mode = mode
        self.labels = torch.as_tensor(labels, device=device)
        if mode == "direct":
            pos = np.zeros(self.label_space, dtype=np.int64)
            pos[labels] = np.arange(self.n, dtype=np.int64)
            self._pos = torch.as_tensor(pos, device=device)

    def lookup(self, tgt: torch.Tensor) -> torch.Tensor:
        """Row indices of target labels (any shape); invalid -> arbitrary."""
        if self.mode == "direct":
            return self._pos[tgt.clamp(0, self.label_space - 1)]
        idx = torch.searchsorted(self.labels, tgt.contiguous())
        return idx.clamp(0, max(self.n - 1, 0))

    def lookup_checked(self, tgt: torch.Tensor):
        """(indices, valid mask) — valid iff the label is in the basis."""
        idx = self.lookup(tgt)
        return idx, self.labels[idx] == tgt
