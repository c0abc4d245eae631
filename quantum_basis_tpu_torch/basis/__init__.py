"""State spaces, enumeration, index, translation orbits and variational
bases."""

from quantum_basis_tpu_torch.basis.site_basis import SiteBasis
from quantum_basis_tpu_torch.basis.state import StateSpace

__all__ = ["SiteBasis", "StateSpace"]
