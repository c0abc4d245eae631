"""Distributed basis enumeration: dnc tiles over the ranks + sample sort.

Port of ``quantum_basis_tpu.parallel.enumerate_sharded`` (SURVEY §5.8's
"basis enumeration/dedup across hosts"). The meet-in-the-middle
divide-and-conquer enumerators (basis/enumerate.py::enumerate_basis_dnc,
basis/weisse.py::enumerate_reps_dnc) produce their top-level cross-product
tiles in a fixed order; here each rank computes only its round-robin share
(``tile_select=(rank, P)``), and the unsorted shares are merged into the
global sorted order by the distributed sample sort
(parallel/sample_sort.py). The sorted labels are then gathered to every
rank, which builds its own device basis from them, as every process of the
JAX package holds the host labels.

Where the JAX package (single-controller) runs all ranks' shares in one
process and pads the rows to a static capacity, each rank here runs only
its own share, and the exchange has exact sizes: no rebalancing of skewed
shares is needed against bucket overflow.

Reference analog: the OpenMP chunked enumeration + gnu-parallel sort
(src/basis.cc:1045-1104), shared-memory only.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis_dnc
from quantum_basis_tpu_torch.basis.weisse import enumerate_reps_dnc
from quantum_basis_tpu_torch.parallel.sample_sort import sample_sort


def enumerate_basis_dnc_sharded(space, conserve_lst, val_lst, mesh,
                                axis: str = "b", leaf: int = 1 << 22):
    """Sector enumeration with the dnc tiles distributed over the ranks.

    Every rank calls it and gets the whole sorted label array (numpy),
    bit-identical to ``enumerate_basis_dnc``; None when a conserved operator
    is not separable (the caller falls back; every rank sees the same).
    """
    part = enumerate_basis_dnc(space, conserve_lst, val_lst, leaf=leaf,
                               tile_select=(mesh.rank, mesh.size),
                               sort=False)
    if part is None:
        return None
    return sample_sort(part, mesh, axis)


def enumerate_reps_dnc_sharded(tset, conserve_lst, val_lst, mesh,
                               axis: str = "b", block: int = 1 << 20,
                               with_dim: bool = False):
    """Momentum representatives with the streamed tiles distributed over
    the ranks; every rank gets the whole sorted array, bit-identical to
    ``enumerate_reps_dnc`` (the sector dimension is summed over the
    ranks)."""
    part, dim = enumerate_reps_dnc(tset, conserve_lst, val_lst, block=block,
                                   with_dim=True,
                                   tile_select=(mesh.rank, mesh.size),
                                   sort=False)
    out = sample_sort(part, mesh, axis)
    if not with_dim:
        return out
    d = torch.tensor([dim], dtype=torch.int64, device=mesh.device)
    return out, int(mesh.all_reduce(d)[0])
