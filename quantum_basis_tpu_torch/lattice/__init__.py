"""Lattice geometry: named Bravais lattices, TOML clusters, symmetry plans."""

from quantum_basis_tpu_torch.lattice.lattice import Lattice
from quantum_basis_tpu_torch.lattice.tilted import TiltedLattice

__all__ = ["Lattice", "TiltedLattice"]
