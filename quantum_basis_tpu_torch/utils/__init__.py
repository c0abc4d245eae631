"""Host utilities: mixed-radix codecs, Lehmer random starts, continued
fractions, checkpoint records."""

from quantum_basis_tpu_torch.utils.contfrac import continued_fraction

__all__ = ["continued_fraction"]
