"""Sharded ELL SpMV with a halo all-to-all exchange.

Port of ``quantum_basis_tpu.parallel.halo_sharded``: the upgrade over
:class:`~quantum_basis_tpu_torch.parallel.apply_sharded.MatvecSharded`'s
all-gather. The sparsity pattern of H is fixed, so the exact set of
off-shard source entries each rank reads ("the halo") is found once, and
every apply exchanges only those entries (SURVEY §5.8's ragged
all-to-all): the bytes moved follow the TRUE coupling between shards, not
the vector size.

Construction takes an explicit
:class:`~quantum_basis_tpu_torch.ops.sparse.EllMatrix` (the reference
likewise builds CSR once and reuses it per MultMv, src/sparse.cc:113-328):

1. rows are block-partitioned over the ranks, padded to equal shards of
   ``ceil_to(n, 8P) / P`` rows, as in the JAX package;
2. each rank finds, on its device, the sorted unique live columns of its
   rows owned by every other rank (``need``); one ragged all-to-all tells
   each owner which of its entries to send (the send index lists);
3. per apply: gather the send values, ONE ragged ``all_to_all_single``
   with exact per-pair sizes, concatenate ``[x_local | halo]``, and run the
   ELL row reduction with int32 columns remapped into that buffer (on the
   card the ``csrc/ell_spmv.cu`` kernel through one launch record,
   ``ops/sparse.py::EllLaunch``, built with the engine from the rows'
   lengths the matrix carries (its build's); the plain ``ell_spmv`` on
   the CPU).

"Live" is a stored nonzero value (``vals != 0``): padding entries create no
traffic and read local slot 0. What is left behind: the JAX package pads
every pair's exchange to the largest pair's capacity, because TPU
collectives are static-shaped. :meth:`halo_stats` still reports the JAX
package's numbers (``pair_capacity`` rounded to 8, the padded exchange
volume and its ratio to the all-gather), which the model's engine routing
reads; what this engine moves per apply is ``halo_nnz`` entries.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.ops.sparse import EllLaunch, ell_spmv
from quantum_basis_tpu_torch.parallel.mesh import RowSharded


def _ceil_to(x: int, m: int) -> int:
    return -(-int(x) // m) * m


class EllShardedHalo(RowSharded):
    """y = H x with ELL rows sharded over ``mesh`` and a halo exchange.

    Every rank constructs it from the same ``ell`` and applies it to its own
    slice ``span`` of each vector (length ``n_local``); the solver protocol
    (call, ``dtype``, ``device``, ``is_complex``, ``mesh``, ``span``) is
    every sharded engine's, with :meth:`pad` / :meth:`unpad` at the
    boundary.
    """

    def __init__(self, ell, mesh, axis: str = "b"):
        self.mesh = mesh
        self.axis = axis
        self.n = self.n_logical = int(ell.n)
        P = mesh.size
        self.P = P
        W = int(ell.width)
        self.is_complex = bool(ell.is_complex)
        self.dtype = torch.float64
        self.device = dev = mesh.device
        nl = _ceil_to(max(self.n, 1), 8 * P) // P
        self.n_local = nl
        self.n_pad = nl * P
        self.span = lo, hi = mesh.span(self.n_pad)

        # this rank's rows, zero-padded past n
        nr = max(min(hi, self.n) - lo, 0)
        cols = torch.zeros((nl, W), dtype=torch.int64, device=dev)
        vals = torch.zeros((nl, W), dtype=ell.vals.dtype, device=dev)
        diag = torch.zeros(nl, dtype=torch.float64, device=dev)
        if nr:
            cols[:nr] = ell.cols[lo:lo + nr].to(dev)
            vals[:nr] = ell.vals[lo:lo + nr].to(dev)
            diag[:nr] = ell.diag[lo:lo + nr].to(dev)
        live = vals != 0
        owner = cols // nl

        # need: sorted unique live columns owned by other ranks; sorted
        # columns are grouped by owner in rank order, as the all-to-all
        # delivers them
        remote = live & (owner != mesh.rank)
        need = torch.unique(cols[remote])
        recv_counts = torch.bincount(need // nl, minlength=P)
        send_counts = mesh.all_to_all(recv_counts, [1] * P, [1] * P)
        asked = mesh.all_to_all(need, recv_counts.tolist(),
                                send_counts.tolist())
        self._send_idx = asked - lo
        self._send_counts = send_counts.tolist()
        self._recv_counts = recv_counts.tolist()
        self.n_halo = need.numel()  # entries this rank receives per apply

        # columns remapped into the buffer [x_local (nl) | halo]
        rm = torch.where(owner == mesh.rank, cols - lo, 0)
        rm[remote] = nl + torch.searchsorted(need, cols[remote])
        self._cols = torch.where(live, rm, 0).to(torch.int32)
        self._vals = vals
        self._diag = diag
        self.width = W
        self._launch = None
        if dev.type == "cuda":
            # the rows' lengths as the matrix has them (its build's), zero
            # past n: the remapped columns keep every live slot
            rowlen = torch.zeros(nl, dtype=torch.int32, device=dev)
            if nr:
                rowlen[:nr] = ell.rowlen[lo:lo + nr].to(dev)
            self._launch = EllLaunch(self._cols, vals, diag, rowlen)

        # the JAX package's diagnostics, over all pairs
        nnz = torch.tensor([need.numel()], dtype=torch.int64, device=dev)
        cap = torch.tensor([max(1, int(recv_counts.max()))],
                           dtype=torch.int64, device=dev)
        self._halo_nnz = int(mesh.all_reduce(nnz)[0])
        self.halo_cap = _ceil_to(int(mesh.all_reduce(cap, "max")[0]), 8)
        self.n_applies = 0

    @property
    def nnz(self) -> int:
        return self.n * (self.width + 1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of H x from this rank's slice of x."""
        x = x.to(torch.complex128 if x.is_complex() else torch.float64)
        halo = self.mesh.all_to_all(x[self._send_idx], self._send_counts,
                                    self._recv_counts)
        buf = torch.cat([x, halo])
        self.n_applies += 1
        if self._launch is None:
            return ell_spmv(self._cols, self._vals, self._diag, x, buf)
        return self._launch(x, buf)

    # ---------------------------------------------------------- diagnostics

    def halo_stats(self) -> dict:
        """Exchange volume diagnostics vs the all-gather strategy, in the
        JAX package's terms (its padded per-pair capacity)."""
        allgather = self.n_pad * (self.P - 1)
        exchanged = self.P * (self.P - 1) * self.halo_cap
        return {
            "halo_nnz": self._halo_nnz,
            "pair_capacity": self.halo_cap,
            "exchanged_per_apply": exchanged,
            "allgather_per_apply": allgather,
            "traffic_ratio": exchanged / max(allgather, 1),
        }
