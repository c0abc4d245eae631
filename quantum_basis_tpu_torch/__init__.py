"""quantum_basis_tpu_torch — the PyTorch/CUDA port of quantum_basis_tpu.

A second package beside the JAX one, for one NVIDIA H100. It keeps the JAX
package's module layout and API names, uses native complex128/float64 device
tensors (complex64/float32 in the bulk tier), and replaces each Pallas TPU
kernel with a kernel written by hand for Hopper. It imports neither jax nor
quantum_basis_tpu.

Ported so far: the full-sector ground-state and static-measurement route
(``Model.enumerate_basis_full`` -> ``locate_E0_lanczos`` / ``locate_E0_iram``
-> ``measure_full_static``) on the full-label-space engines (window
contraction, masked rolls; float64 or mixed precision), the matrix-free
apply or the explicit ELL; the factorized product-sector route
(``ProductModel`` -> ``locate_E0_lanczos`` -> ``measure_product_static`` on
the dense kron engine); the momentum-sector ground-state route
(``Model.enumerate_basis_repr`` with ``method="direct"`` or the streaming
``"dnc"`` -> ``locate_E0_lanczos(which="repr")`` -> ``measure_repr_static``):
``P_k H`` in the full label space on the same engines with block-transpose
translations (ops/translate_fullspace.py), or, on a tilted cluster
(``TiltedLattice``) and wherever that gives no engine, the explicit route with
the CUDA BSR SpMV kernel (ops/bsr.py, csrc/bsr_spmv.cu); crash-consistent
checkpoint and resume of every solve (``initialize(enable_checkpoint=True)``,
``CkptStore``, ``basis_save`` / ``basis_load``); dynamics and spectra
(``Model.measure_full_dynamic`` / ``measure_repr_dynamic`` continued
fractions, ``measure_*_dynamic_kpm`` Chebyshev moments, ``locate_Es`` interior
windows; solvers/chebyshev.py, solvers/kpm.py, postprocess.py); the
variational (Trugman) sector; and the multi-device route on
``torch.distributed``, one rank per device (``Model(mesh=)``,
``ProductModel(mesh=)``, the sharded engines and the distributed enumeration
of parallel/).
"""

from quantum_basis_tpu_torch import config as config
from quantum_basis_tpu_torch.config import initialize

from quantum_basis_tpu_torch.basis.site_basis import SiteBasis
from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.ops.operators import Opr, OprProd, Mopr
from quantum_basis_tpu_torch.lattice.lattice import Lattice
from quantum_basis_tpu_torch.lattice.tilted import TiltedLattice
from quantum_basis_tpu_torch.basis.io import basis_load, basis_save
from quantum_basis_tpu_torch.utils.ckpt import CkptStore
from quantum_basis_tpu_torch.models.model import Model
from quantum_basis_tpu_torch.models.product import ProductModel

__version__ = "0.1.0"

# ``__all__`` is the JAX package's, name for name. TiltedLattice, CkptStore,
# basis_save and basis_load are importable from here as well; the JAX package
# keeps them in its submodules.

__all__ = [
    "config",
    "initialize",
    "SiteBasis",
    "StateSpace",
    "Opr",
    "OprProd",
    "Mopr",
    "Lattice",
    "Model",
    "ProductModel",
    "__version__",
]
