"""The Model orchestration object."""

from quantum_basis_tpu_torch.models.model import Model

__all__ = ["Model"]
