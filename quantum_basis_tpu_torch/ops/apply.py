"""Device residency of a basis and the per-block image tables.

Port of the parts of ``quantum_basis_tpu.ops.apply`` that the momentum-sector
apply uses: :class:`DeviceBasis` (labels, slot values and fermion counts in
uniform row blocks), ``_group_device`` and ``_block_images``. Per row block
and compiled term group, ``_block_images`` computes

1. joint columns c = V[slots] . jstrides;
2. the Jordan-Wigner parities of all terms at once, (F @ W^T) mod 2, in
   float64 (exact for these small integer sums);
3. the amplitude and label-displacement table lookups, hence the target
   labels of every image.

The full-sector ``MatvecFull`` is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


class DeviceBasis:
    """Device-resident per-state data, padded into uniform row blocks.

    Holds labels (nb, B) int64, decoded slot values V (nb, B, S) int64 and
    fermion counts F (nb, B, S) float64. Padding rows repeat the first label.
    """

    def __init__(self, space, labels: np.ndarray, index, block_rows: int,
                 device="cuda"):
        labels = np.asarray(labels, dtype=np.int64)
        self.space = space
        self.index = index
        self.device = torch.device(device)
        self.n = int(labels.size)
        B = int(min(block_rows, max(self.n, 1)))
        nb = max(1, -(-self.n // B))
        pad = nb * B - self.n
        lab_pad = np.concatenate(
            [labels, np.full(pad, labels[0] if self.n else 0, np.int64)])
        V = space.decode(lab_pad).astype(np.int64)
        F = np.take_along_axis(space.fermion_count_table, V.T, axis=1).T
        self.block_rows = B
        self.n_blocks = nb
        self.pad = pad
        self.labels_np = labels
        self.labels_b = torch.as_tensor(lab_pad.reshape(nb, B),
                                        device=self.device)
        self.V_b = torch.as_tensor(V.reshape(nb, B, space.n_slots),
                                   device=self.device)
        self.F_b = torch.as_tensor(
            F.reshape(nb, B, space.n_slots).astype(np.float64),
            device=self.device)

    def pad_vec(self, x: torch.Tensor) -> torch.Tensor:
        """(n,) -> (n_blocks, block_rows), zero padded."""
        return torch.nn.functional.pad(x, (0, self.pad)).view(
            self.n_blocks, self.block_rows)


def _group_device(group, device):
    """Move one TermGroup's tables to the device, flattening (T, D)."""
    T, D, K = group.dlt.shape
    amp = group.amp_re.reshape(T * D, K)
    if group.amp_im is not None:
        amp = amp + 1j * group.amp_im.reshape(T * D, K)
    return dict(
        slots=torch.as_tensor(group.slots.astype(np.int64), device=device),
        jstrides=torch.as_tensor(group.jstrides, device=device),
        dlt=torch.as_tensor(group.dlt.reshape(T * D, K), device=device),
        amp=torch.as_tensor(amp, device=device),
        W=torch.as_tensor(group.W.T.astype(np.float64), device=device),
        D=D,
        T=T,
    )


def _block_images(g, labels, V, F):
    """Per block: (sign (B,T) float64, amplitudes (B,T,K), targets (B,T,K))."""
    c = (V[:, g["slots"]] * g["jstrides"]).sum(dim=-1)           # (B, T)
    sign = 1.0 - 2.0 * torch.remainder(F @ g["W"], 2.0)          # (B, T)
    flat = torch.arange(g["T"], device=V.device) * g["D"] + c
    tgt = labels[:, None, None] + g["dlt"][flat]                  # (B, T, K)
    return sign, g["amp"][flat], tgt
