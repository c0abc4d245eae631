"""Sharded matrix-free apply: basis rows partitioned over the ranks.

Port of ``quantum_basis_tpu.parallel.apply_sharded``, the multi-device
replacement for the reference's OpenMP row-parallel ``model::MultMv2`` loops
(reference: src/model.cc:941-1121, §2.2/§5.8 of SURVEY.md). The row blocks
of a :class:`~quantum_basis_tpu_torch.ops.apply.DeviceBasis` are split over
the ranks, padded as in the JAX package to ``ceil(nb / P) * P`` blocks (rows
past the sector's come out zero); each rank
all-gathers the source vector (``all_gather_into_tensor``) and computes its
own rows with one call of the single-device row-gather
(:func:`~quantum_basis_tpu_torch.ops.apply.apply_rows`, the fused kernel on
a CUDA device): no scatters.

The all-gather replicates one vector per rank per apply; the halo engine
(parallel/halo_sharded.py) moves only the entries each rank reads.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.ops.apply import apply_rows, pack_rows
from quantum_basis_tpu_torch.ops.compile import compile_diagonal
from quantum_basis_tpu_torch.parallel.mesh import RowSharded


class MatvecSharded(RowSharded):
    """y = H x with the basis row blocks sharded over ``mesh``.

    ``dbasis`` is the whole sector's device basis on the mesh's device
    (every rank holds the labels and the index, as every JAX process does);
    this rank keeps the diagonal of its own rows. Vectors are padded to
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
        self._rows = nbp // P * B
        self._row0 = mesh.rank * self._rows
        self.tables = pack_rows(compiled, dev)
        self.is_complex = self.tables.is_complex
        self._diag = torch.zeros(self._rows, dtype=torch.float64, device=dev)
        r1 = min(self._row0 + self._rows, self.n)
        if not compiled.diag_terms.q_zero() and r1 > self._row0:
            V = dbasis.V_b.view(-1, dbasis.space.n_slots)[self._row0:r1]
            self._diag[: r1 - self._row0] = compile_diagonal(
                compiled.diag_terms, compiled.space)(V)
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of H x from this rank's slice of x."""
        if self.is_complex and not x.is_complex():
            raise ValueError("complex Hamiltonian applied to real vector")
        x = x.to(torch.complex128 if x.is_complex() else torch.float64)
        xg = self.mesh.all_gather(x.contiguous())
        b = self.basis
        y = apply_rows(self.tables, b.index.tables, b.labels_b.view(-1),
                       b.V_b.view(-1, b.space.n_slots), b.fodd, self._diag,
                       xg, self._row0, self._rows, self.n)
        self.n_applies += 1
        return y
