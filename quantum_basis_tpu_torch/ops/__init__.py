"""Operator algebra, term compiler, momentum-sector apply, ELL and BSR."""

from quantum_basis_tpu_torch.ops.operators import Opr, OprProd, Mopr

__all__ = ["Opr", "OprProd", "Mopr"]
