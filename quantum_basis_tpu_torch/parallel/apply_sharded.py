"""Sharded matrix-free apply: basis rows partitioned over the ranks.

Port of ``quantum_basis_tpu.parallel.apply_sharded``, the multi-device
replacement for the reference's OpenMP row-parallel ``model::MultMv2`` loops
(reference: src/model.cc:941-1121, §2.2/§5.8 of SURVEY.md). The row blocks
of a :class:`~quantum_basis_tpu_torch.ops.apply.DeviceBasis` are split over
the ranks, padded as in the JAX package to ``ceil(nb / P) * P`` blocks (the
padding blocks repeat block 0 and are masked to zero); each rank
all-gathers the source vector (``all_gather_into_tensor``) and computes its
own rows with the single-device row-gather
(:func:`~quantum_basis_tpu_torch.ops.apply.apply_block_rows`): no scatters.

The all-gather replicates one vector per rank per apply; the halo engine
(parallel/halo_sharded.py) moves only the entries each rank reads.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.ops.apply import _group_device, apply_block_rows
from quantum_basis_tpu_torch.ops.compile import compile_diagonal
from quantum_basis_tpu_torch.parallel.mesh import RowSharded


class MatvecSharded(RowSharded):
    """y = H x with the basis row blocks sharded over ``mesh``.

    ``dbasis`` is the whole sector's device basis on the mesh's device
    (every rank holds the labels and the index, as every JAX process does);
    this rank keeps the tables of its own blocks. Vectors are padded to
    ``n_pad`` (whole blocks, a multiple of the ranks); padding rows stay
    zero.
    """

    def __init__(self, compiled, dbasis, mesh, axis: str = "b"):
        if dbasis.labels_b.device != mesh.device:
            raise ValueError(f"the basis lives on {dbasis.labels_b.device}, "
                             f"the mesh rank on {mesh.device}")
        self.compiled = compiled
        self.basis = dbasis
        self.mesh = mesh
        self.axis = axis
        self.n = self.n_logical = dbasis.n
        self.dtype = torch.float64
        self.device = dev = mesh.device
        P = mesh.size
        nb, B = dbasis.n_blocks, dbasis.block_rows
        nbp = -(-nb // P) * P
        self.n_pad = nbp * B
        self.span = mesh.span(self.n_pad)
        nbl = nbp // P
        self.groups = [_group_device(g, dev) for g in compiled.groups]
        self.is_complex = any(g["amp"].is_complex() for g in self.groups)

        blk = torch.arange(mesh.rank * nbl, (mesh.rank + 1) * nbl,
                           device=dev)
        take = torch.where(blk < nb, blk, 0)  # padding repeats block 0
        self._labels = dbasis.labels_b[take]
        self._V = dbasis.V_b[take]
        self._F = dbasis.F_b[take]
        rows = blk[:, None] * B + torch.arange(B, device=dev)
        self._mask = (rows < self.n).to(torch.float64)
        self._diag = torch.zeros_like(self._mask)
        if not compiled.diag_terms.q_zero():
            self._diag = compile_diagonal(compiled.diag_terms,
                                          compiled.space)(self._V) * self._mask
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of H x from this rank's slice of x."""
        if self.is_complex and not x.is_complex():
            raise ValueError("complex Hamiltonian applied to real vector")
        x = x.to(torch.complex128 if x.is_complex() else torch.float64)
        xg = self.mesh.all_gather(x)
        B = self.basis.block_rows
        xb = x.view(-1, B)
        y = torch.empty_like(xb)
        for k in range(xb.shape[0]):
            y[k] = apply_block_rows(self.groups, self.basis.index,
                                    self._labels[k], self._V[k], self._F[k],
                                    self._diag[k], xb[k], xg) * self._mask[k]
        self.n_applies += 1
        return y.reshape(-1)
