"""Distributed sample sort over a basis mesh.

Port of ``quantum_basis_tpu.parallel.sample_sort``, the replacement for the
reference's thread-parallel host sort (``__gnu_parallel::sort``,
src/basis.cc:8-12,1127-1133) where the label array is spread over ranks and
no single rank should sort it alone. Classic sample sort over collectives,
each rank running the same steps on its own part:

1. a local ``torch.sort``;
2. P-1 regular samples per rank, all-gathered; every rank picks the same
   P-1 global splitters from the sorted sample matrix (no root), exactly as
   the JAX package does;
3. each element is binned by splitter (``searchsorted``);
4. the bin counts are exchanged, then the elements in ONE ragged
   ``all_to_all_single`` with exact per-pair sizes;
5. a local sort of what arrived. The concatenation over ranks in rank order
   is the globally sorted array.

What is left behind: the JAX package pads every bucket to a static
capacity (``slack`` times the local size; TPU collectives are
static-shaped), reports an overflow when a bucket or a receiver exceeds it
and retries with twice the slack. Here every exchange carries its exact
size, so nothing can overflow: an input that overflows the JAX package's
default slack (all keys equal, say) sorts here like any other. ``slack``
stays in the signatures for API parity and is unused.
"""

from __future__ import annotations

import numpy as np
import torch

_PAD = np.int64(2**62)  # sorts above every real label


def sample_sort_sharded(x_local: torch.Tensor, mesh,
                        slack: float = 2.5) -> torch.Tensor:
    """Sort the int64 values that all ranks hold together.

    ``x_local`` is this rank's (unsorted, any length) part, on
    ``mesh.device``. Returns this rank's part of the global sorted order:
    the concatenation over ranks, in rank order, is the sorted whole.
    (The JAX package's single-controller form takes the (P, n_local) matrix
    of all parts and returns padded buckets with counts and an overflow
    flag.) ``slack`` is unused: nothing here has a capacity.
    """
    P = mesh.size
    x = torch.sort(x_local.to(device=mesh.device, dtype=torch.int64)).values
    n = x.shape[0]
    # regular sampling: P-1 splitter candidates per rank (an empty rank
    # offers the pad value, which sorts above every label)
    idx = (torch.arange(1, P, device=x.device) * n) // P
    samples = (x[idx] if n else
               torch.full((P - 1,), int(_PAD), dtype=torch.int64,
                          device=x.device))
    flat = torch.sort(mesh.all_gather(samples)).values        # (P*(P-1),)
    # global splitters: every (P-1)'th of the gathered samples
    spl = flat[torch.arange(1, P, device=x.device) * (P - 1) - 1]
    dest = torch.searchsorted(spl, x, right=True)            # sorted x: runs
    send = torch.bincount(dest, minlength=P)
    recv = mesh.all_to_all(send, [1] * P, [1] * P)
    got = mesh.all_to_all(x, send.tolist(), recv.tolist())
    return torch.sort(got).values


def sample_sort(values, mesh, axis: str = "b",
                slack: float = 2.5) -> np.ndarray:
    """Host API: every rank passes its part of the values (numpy int64, any
    length); every rank gets the whole sorted array back as numpy. ``slack``
    is unused (kept for parity with the JAX package, whose single-controller
    form takes the whole array and retries on bucket overflow)."""
    x = torch.as_tensor(np.asarray(values, dtype=np.int64),
                        device=mesh.device)
    mine = sample_sort_sharded(x, mesh, slack)
    return mesh.all_gather_ragged(mine).cpu().numpy()
