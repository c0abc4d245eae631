"""Symbolic operator algebra with fermionic sign bookkeeping.

Port of ``quantum_basis_tpu.ops.operators`` (numpy, unchanged). Host-side
analog of the reference's ``opr`` / ``opr_prod`` / ``mopr``
ring (reference: src/operators.cc, src/qbasis.h:632-922). This layer is tiny
and latency-irrelevant; it exists to let users write Hamiltonians as algebra
(``0.5*J*(Sp_i*Sm_j + Sm_i*Sp_j) + J*Sz_i*Sz_j``) which is then *compiled*
into static device term tables by :mod:`quantum_basis_tpu_torch.ops.compile`.

Conventions (identical physics to the reference):

- an :class:`Opr` is an elementary operator acting on one (site, orbital)
  slot, given as a dense d x d matrix ``mat[row, col]`` or a diagonal;
- ``fermion=True`` marks an odd fermion-parity operator (e.g. c, c†); such
  operators carry an implicit Jordan-Wigner string over all slots preceding
  theirs in orbital-major order;
- an :class:`OprProd` is ``coeff * f_1 f_2 ... f_k`` with factors kept in
  canonical ascending-slot order; reordering two odd factors flips the sign
  (the reference's fermion-fermion transposition rule,
  src/operators.cc:629-654), and same-slot factors merge by matrix product
  with fermion-parity XOR;
- a :class:`Mopr` is a sum of products with like-term combination.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch.config import opr_precision


def _as_matrix(mat):
    """Normalize user input to (is_diagonal, complex128 ndarray)."""
    arr = np.asarray(mat, dtype=np.complex128)
    if arr.ndim == 1:
        return True, arr.copy()
    if arr.ndim == 2 and arr.shape[0] == arr.shape[1]:
        if np.all(np.abs(arr - np.diag(np.diagonal(arr))) < opr_precision):
            return True, np.diagonal(arr).copy()
        return False, arr.copy()
    raise ValueError("operator matrix must be 1-d (diagonal) or square 2-d")


class Opr:
    """Elementary operator on one (site, orbital) slot."""

    def __init__(self, site: int, orbital: int, fermion: bool, mat):
        self.site = int(site)
        self.orbital = int(orbital)
        self.fermion = bool(fermion)
        self.diagonal, self.mat = _as_matrix(mat)

    # -- properties ---------------------------------------------------------

    @property
    def dim(self) -> int:
        return self.mat.shape[0]

    def dense(self) -> np.ndarray:
        return np.diag(self.mat) if self.diagonal else self.mat

    def q_zero(self) -> bool:
        return bool(np.all(np.abs(self.mat) < opr_precision))

    def q_identity(self) -> bool:
        return self.diagonal and bool(np.all(np.abs(self.mat - 1.0) < opr_precision))

    def norm(self) -> float:
        return float(np.linalg.norm(self.mat if self.diagonal else self.mat.ravel()))

    def copy(self) -> "Opr":
        return Opr(self.site, self.orbital, self.fermion, self.dense())

    def _key(self):
        """Hashable canonical key for like-term detection."""
        m = np.round(self.dense(), 12) + (0.0 + 0.0j)  # normalize -0.0 bytes
        return (self.orbital, self.site, self.fermion, m.tobytes())

    # -- algebra ------------------------------------------------------------

    def dagger(self) -> "Opr":
        """Hermitian conjugate (returns a new operator)."""
        if self.diagonal:
            return Opr(self.site, self.orbital, self.fermion, np.conj(self.mat))
        return Opr(self.site, self.orbital, self.fermion, np.conj(self.mat.T))

    def __mul__(self, other):
        if isinstance(other, Opr):
            return OprProd(1.0, [self]) * OprProd(1.0, [other])
        if isinstance(other, OprProd):
            return OprProd(1.0, [self]) * other
        if isinstance(other, Mopr):
            return Mopr([OprProd(1.0, [self])]) * other
        return OprProd(np.complex128(other), [self])

    def __rmul__(self, scalar):
        return OprProd(np.complex128(scalar), [self])

    def __add__(self, other):
        return Mopr([OprProd(1.0, [self])]) + other

    def __radd__(self, other):
        if other == 0:  # support sum()
            return Mopr([OprProd(1.0, [self])])
        return self.__add__(other)

    def __sub__(self, other):
        return Mopr([OprProd(1.0, [self])]) - other

    def __neg__(self):
        return OprProd(-1.0, [self])

    def __repr__(self):
        tag = "f" if self.fermion else "b"
        return f"Opr(site={self.site}, orb={self.orbital}, {tag}, dim={self.dim})"


class OprProd:
    """coeff * ordered product of elementary operators (canonical form).

    ``factors`` is kept sorted ascending by (orbital, site); the stored
    coefficient absorbs the fermionic reordering sign. An empty factor list
    represents coeff * identity.
    """

    def __init__(self, coeff, factors=None, _canonical=False):
        self.coeff = np.complex128(coeff)
        self.factors: list[Opr] = list(factors or [])
        if not _canonical:
            self._canonicalize()

    @staticmethod
    def _slot_key(f: Opr):
        return (f.orbital, f.site)

    def _canonicalize(self):
        """Insertion-sort factors by slot with fermionic transposition signs,
        merging same-slot factors by matrix product (left @ right)."""
        out: list[Opr] = []
        sign = 1
        for f in self.factors:
            if f.q_zero():
                self.coeff = np.complex128(0.0)
                self.factors = []
                return
            # walk from the end of `out` moving f left to its slot position;
            # factors to the RIGHT of f in `out`+... apply before f?  No:
            # `self.factors` is the product sequence left-to-right, leftmost
            # outermost. Appending f means f multiplies from the right
            # (applies first to kets among those seen so far... order within
            # the list is the operator product order). To sort, swap f with
            # its left neighbor when f's slot is smaller.
            pos = len(out)
            while pos > 0 and self._slot_key(out[pos - 1]) > self._slot_key(f):
                if out[pos - 1].fermion and f.fermion:
                    sign = -sign
                pos -= 1
            if pos > 0 and self._slot_key(out[pos - 1]) == self._slot_key(f):
                left = out[pos - 1]
                merged = Opr(
                    f.site, f.orbital, left.fermion != f.fermion,
                    left.dense() @ f.dense(),
                )
                if merged.q_zero():
                    self.coeff = np.complex128(0.0)
                    self.factors = []
                    return
                out[pos - 1] = merged
            else:
                out.insert(pos, f)
        self.coeff = self.coeff * sign
        # strip identity factors
        self.factors = [f for f in out if not f.q_identity()]
        if abs(self.coeff) < opr_precision:
            self.coeff = np.complex128(0.0)
            self.factors = []

    # -- properties ---------------------------------------------------------

    def q_zero(self) -> bool:
        return abs(self.coeff) < opr_precision

    def q_identity(self) -> bool:
        return not self.factors

    def q_diagonal(self) -> bool:
        return all(f.diagonal for f in self.factors)

    def q_fermion_odd(self) -> bool:
        """True if the product has odd total fermion parity (cannot appear in
        a physical Hamiltonian alone)."""
        return bool(sum(f.fermion for f in self.factors) % 2)

    def slots(self, space) -> tuple:
        """Slot indices of the factors (ascending) in the given StateSpace."""
        return tuple(space.slot(f.site, f.orbital) for f in self.factors)

    def _key(self):
        return tuple(f._key() for f in self.factors)

    def copy(self) -> "OprProd":
        return OprProd(self.coeff, [f.copy() for f in self.factors], _canonical=True)

    # -- algebra ------------------------------------------------------------

    def dagger(self) -> "OprProd":
        """(c f1 f2 ... fk)† = conj(c) fk† ... f1† (then re-canonicalized)."""
        return OprProd(np.conj(self.coeff), [f.dagger() for f in reversed(self.factors)])

    def transform(self, plan) -> "OprProd":
        """Relabel sites by ``plan[site] = new_site`` and re-canonicalize
        (cf. mopr::transform, src/operators.cc)."""
        plan = np.asarray(plan)
        moved = [Opr(int(plan[f.site]), f.orbital, f.fermion, f.dense())
                 for f in self.factors]
        return OprProd(self.coeff, moved)

    def __mul__(self, other):
        if isinstance(other, OprProd):
            return OprProd(self.coeff * other.coeff,
                           [f.copy() for f in self.factors]
                           + [f.copy() for f in other.factors])
        if isinstance(other, Opr):
            return self * OprProd(1.0, [other])
        if isinstance(other, Mopr):
            return Mopr([self]) * other
        return OprProd(self.coeff * np.complex128(other), self.factors, _canonical=True)

    def __rmul__(self, scalar):
        return OprProd(self.coeff * np.complex128(scalar), self.factors, _canonical=True)

    def __add__(self, other):
        return Mopr([self]) + other

    def __radd__(self, other):
        if other == 0:
            return Mopr([self])
        return self.__add__(other)

    def __sub__(self, other):
        return Mopr([self]) - other

    def __neg__(self):
        return OprProd(-self.coeff, self.factors, _canonical=True)

    def __repr__(self):
        return f"OprProd({self.coeff}, {self.factors})"


class Mopr:
    """Sum of operator products — the Hamiltonian / observable type."""

    def __init__(self, terms=None):
        """``terms``: an iterable of OprProd, or a single Opr/OprProd —
        the reference's mopr is constructible from either (qbasis.h:818)."""
        self.terms: list[OprProd] = []
        if isinstance(terms, Opr):
            terms = [OprProd(1.0, [terms])]
        elif isinstance(terms, OprProd):
            terms = [terms]
        for t in terms or []:
            self._add_term(t)

    def _add_term(self, t: OprProd):
        if t.q_zero():
            return
        key = t._key()
        for mine in self.terms:
            if mine._key() == key:
                mine.coeff = mine.coeff + t.coeff
                if abs(mine.coeff) < opr_precision:
                    self.terms.remove(mine)
                return
        self.terms.append(t.copy())

    # -- properties ---------------------------------------------------------

    def q_zero(self) -> bool:
        return not self.terms

    def q_diagonal(self) -> bool:
        return all(t.q_diagonal() for t in self.terms)

    def q_hermitian(self) -> bool:
        """Check H == H† term-by-term after simplification."""
        diff = self - self.dagger()
        return all(abs(t.coeff) < 1e-9 for t in diff.terms)

    def copy(self) -> "Mopr":
        m = Mopr()
        m.terms = [t.copy() for t in self.terms]
        return m

    def simplify(self) -> "Mopr":
        """Re-run like-term combination (terms are already combined on add)."""
        return Mopr(self.terms)

    # -- algebra ------------------------------------------------------------

    def dagger(self) -> "Mopr":
        return Mopr([t.dagger() for t in self.terms])

    def transform(self, plan) -> "Mopr":
        return Mopr([t.transform(plan) for t in self.terms])

    def _coerce(self, other) -> "Mopr":
        if isinstance(other, Mopr):
            return other
        if isinstance(other, OprProd):
            return Mopr([other])
        if isinstance(other, Opr):
            return Mopr([OprProd(1.0, [other])])
        raise TypeError(f"cannot combine Mopr with {type(other)}")

    def __add__(self, other):
        out = self.copy()
        for t in self._coerce(other).terms:
            out._add_term(t)
        return out

    def __radd__(self, other):
        if other == 0:
            return self.copy()
        return self.__add__(other)

    def __iadd__(self, other):
        for t in self._coerce(other).terms:
            self._add_term(t)
        return self

    def __sub__(self, other):
        return self + (-1.0) * self._coerce(other)

    def __mul__(self, other):
        if isinstance(other, (Mopr, OprProd, Opr)):
            rhs = self._coerce(other)
            out = Mopr()
            for a in self.terms:
                for b in rhs.terms:
                    out._add_term(a * b)
            return out
        out = Mopr()
        for t in self.terms:
            out._add_term(t * np.complex128(other))
        return out

    def __rmul__(self, scalar):
        return self.__mul__(scalar)

    def __neg__(self):
        return self.__mul__(-1.0)

    def __repr__(self):
        return f"Mopr({len(self.terms)} terms)"
