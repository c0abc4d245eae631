"""Host utilities: mixed-radix codecs, Lehmer random starts, continued
fractions, checkpoint records, phase timing and profiling."""

from quantum_basis_tpu_torch.utils.codec import (
    radix_decode,
    radix_encode,
    radix_strides,
)
from quantum_basis_tpu_torch.utils.contfrac import continued_fraction
from quantum_basis_tpu_torch.utils.rng import vec_randomize

__all__ = [
    "radix_decode",
    "radix_encode",
    "radix_strides",
    "continued_fraction",
    "vec_randomize",
]
