"""Local Hilbert-space descriptors ("orbitals").

Port of ``quantum_basis_tpu.basis.site_basis`` (numpy, unchanged). Analog
of the reference's ``basis_prop`` (reference:
src/basis.cc:31-127, src/qbasis.h:295-335). Instead of describing a bit
layout, a :class:`SiteBasis` describes one orbital's local dimension and
fermion-count map; the many-body packing into integer labels is done by
:class:`~quantum_basis_tpu_torch.basis.state.StateSpace`.

Named local bases (state orderings identical to the reference):

=================  ===  =================================  ==============
name               dim  local states                       Nfermion map
=================  ===  =================================  ==============
spin-1/2             2  |up>, |dn>                         (bosonic)
spin-1               3  |up>, |0>, |dn>                    (bosonic)
spin-3/2             4  |3/2>, |1/2>, |-1/2>, |-3/2>       (bosonic)
dimer                4  |s>, |t+>, |t->, |t0>              (bosonic)
electron             4  |0>, |up>, |dn>, |up+dn>           0,1,1,2
tJ                   3  |0>, |up>, |dn>                    0,1,1
spinless-fermion     2  |0>, |1>                           0,1
boson(Nmax)       N+1   |0>, |1>, ..., |Nmax>              (bosonic)
=================  ===  =================================  ==============
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

_NAMED = {
    "spin-1/2": (2, None),
    "spin-1": (3, None),
    "spin-3/2": (4, None),
    "dimer": (4, None),
    "electron": (4, (0, 1, 1, 2)),
    "tJ": (3, (0, 1, 1)),
    "spinless-fermion": (2, (0, 1)),
}


@dataclass(frozen=True)
class SiteBasis:
    """One orbital: local dimension, name, and per-state fermion counts."""

    dim_local: int
    name: str = "unknown"
    nfermion_map: tuple = field(default=())  # empty tuple => bosonic orbital

    def __post_init__(self):
        if not (1 <= self.dim_local <= 256):
            raise ValueError("local dimension must be in [1, 256]")
        if self.nfermion_map and len(self.nfermion_map) != self.dim_local:
            raise ValueError("nfermion_map length must equal dim_local")

    @property
    def fermionic(self) -> bool:
        """True if any local state carries fermions (cf. basis_prop::q_fermion)."""
        return bool(self.nfermion_map) and any(n > 0 for n in self.nfermion_map)

    def fermion_counts(self) -> np.ndarray:
        """Per-local-state fermion count as an int array (zeros if bosonic)."""
        if self.nfermion_map:
            return np.asarray(self.nfermion_map, dtype=np.int32)
        return np.zeros(self.dim_local, dtype=np.int32)

    @staticmethod
    def named(name: str, Nmax: int | None = None) -> "SiteBasis":
        """Construct one of the named local bases (see module docstring)."""
        if name == "boson":
            if Nmax is None or Nmax < 1:
                raise ValueError("boson basis requires Nmax >= 1")
            return SiteBasis(dim_local=Nmax + 1, name=f"boson({Nmax})")
        if name not in _NAMED:
            raise ValueError(f"unknown site basis {name!r}; known: {sorted(_NAMED)} + 'boson'")
        dim, nf = _NAMED[name]
        return SiteBasis(dim_local=dim, name=name, nfermion_map=nf or ())
