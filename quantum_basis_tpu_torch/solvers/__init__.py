"""Krylov and Chebyshev solvers: thick-restart Lanczos, the mixed-precision
RQI polish, 2-vector Lanczos (ground states, dynamics, spectral bounds), KPM
moments and Chebyshev-filtered interior windows."""

from quantum_basis_tpu_torch.solvers.lanczos import (
    energy_scale,
    lanczos_dynamics,
    lanczos_ground,
)

__all__ = ["lanczos_ground", "lanczos_dynamics", "energy_scale"]
