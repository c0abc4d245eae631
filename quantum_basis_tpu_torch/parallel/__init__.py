"""Multi-device distribution on ``torch.distributed``: process-group
start-up, the basis mesh, sharded operator applies and distributed
enumeration. One rank per device; see parallel/mesh.py for how the port's
multi-controller form relates to the JAX package's single-controller mesh."""

from quantum_basis_tpu_torch.parallel.mesh import BasisMesh, basis_mesh
from quantum_basis_tpu_torch.parallel.apply_sharded import MatvecSharded
from quantum_basis_tpu_torch.parallel.halo_sharded import EllShardedHalo
from quantum_basis_tpu_torch.parallel.fullspace_sharded import (
    FullSpaceSharded,
)
from quantum_basis_tpu_torch.parallel.kron_sharded import KronSharded
from quantum_basis_tpu_torch.parallel.sample_sort import (
    sample_sort,
    sample_sort_sharded,
)
from quantum_basis_tpu_torch.parallel.enumerate_sharded import (
    enumerate_basis_dnc_sharded,
    enumerate_reps_dnc_sharded,
)
from quantum_basis_tpu_torch.parallel.distributed import (
    global_basis_mesh,
    init_distributed,
    process_info,
    run_ranks,
    shard_array_over_mesh,
)

# the JAX package's names, then the port's own (its BasisMesh, and the
# engines and sorts the JAX package keeps in submodules)
__all__ = ["basis_mesh", "MatvecSharded", "EllShardedHalo",
           "enumerate_basis_dnc_sharded", "enumerate_reps_dnc_sharded",
           "init_distributed",
           "global_basis_mesh", "process_info", "shard_array_over_mesh",
           "BasisMesh", "FullSpaceSharded", "KronSharded", "run_ranks",
           "sample_sort", "sample_sort_sharded"]
