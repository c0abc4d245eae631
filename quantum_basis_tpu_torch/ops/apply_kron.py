"""Tensor-factorized sector apply: dense matmuls instead of gathers.

Port of ``quantum_basis_tpu.ops.apply_kron``. Many sector Hamiltonians
factorize over a tensor product of two smaller conserved subsectors:

    H = H_a (x) I_b  +  I_a (x) H_b  +  sum_m D_a,m (x) D_b,m

with ``D_*`` diagonal. The canonical case is the Fermi-Hubbard model in the
species-major Jordan-Wigner ordering (all spin-up modes before all
spin-down modes): the up-hopping acts only on the up-occupation factor, the
down-hopping only on the down factor, and the U term is a diagonal product
``U sum_i n_i^up (x) n_i^dn``. The 4x4 half-filled sector (dim
C(16,8)^2 = 165,636,900, far beyond anything the reference attempts: its
anchor is 4x2, examples/trans_absent/latt_square/square_Fermi_Hubbard
.cc:113) then never materializes 1.66e8 basis labels at all: the state
vector IS a (12870, 12870) matrix ``psi`` and one H application is

    y = A psi + psi B^T + (a_diag (+) b_diag + scale * P) o psi

two dense matmuls plus one elementwise pass.

Both precisions store ``A``/``B^T`` dense and apply them with
``torch.matmul``: float32 (true float32: TF32 is off, config.py) is the bulk
Krylov engine, float64 the exact twin of the polish. The JAX package's
``layout="ell"`` twin (gathers instead of matmuls, for a chip without
float64 matrix products) and its reduced-pass float32 option are left
behind. The epilogue is three in-place ``addcmul_`` on broadcast views, so
the (na, nb) diagonal is never formed.

Eigenvalues are basis-ordering independent, so results cross-check against
the site-major 'electron' encoding of the generic engines at 1e-8
(tests/test_torch_kron.py) and against the reference's 4x2 golden values.

Reference parity: replaces model::MultMv2 (src/model.cc:941-1121) for
factorizable sectors. No analog exists in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.ops.compile import compile_diagonal


def _ell_to_dense(ell, dtype) -> torch.Tensor:
    """Densify an EllMatrix's off-diagonal part on its device (once);
    accumulated in float64, then cast."""
    na = ell.n
    dense = torch.zeros((na, na), dtype=torch.float64, device=ell.device)
    if ell.width:
        rows = torch.arange(na, device=ell.device)[:, None].expand_as(ell.cols)
        # padding entries carry val 0.0 at col 0: harmless under add
        dense.index_put_((rows, ell.cols), ell.vals.to(torch.float64),
                         accumulate=True)
    return dense.to(dtype)


def _compact_coupling(P) -> np.ndarray:
    """Store the (na, nb) diagonal-coupling matrix small: int8 when its
    entries are small integers (occupation products), else float32."""
    P = np.asarray(P)
    if P.dtype == np.int8:
        return P
    rP = np.rint(P)
    if np.max(np.abs(P - rP)) < 1e-9 and np.max(np.abs(rP)) <= 127:
        return rP.astype(np.int8)
    return P.astype(np.float32)


class KronOp:
    """y = H x for H = A (x) I + I (x) B + diagonal couplings.

    ``A``/``B``: real :class:`~quantum_basis_tpu_torch.ops.sparse.EllMatrix`
    over the two factor bases, on one device (``B=None`` reuses ``A``;
    requires A symmetric, which holds for any real Hermitian factor).
    ``coupling``: optional (na, nb) array (the precomputed sum of diagonal
    outer products), multiplied by ``coupling_scale``.

    Vectors are real tensors of length na*nb, row-major ``psi[r_a, c_b]``, in
    the engine's ``dtype``; the solver protocol (call, dtype, device,
    is_complex, mask) is every other engine's.
    """

    is_complex = False
    mask = None

    def __init__(self, A, B=None, coupling=None, coupling_scale: float = 1.0,
                 dtype=None):
        if A.is_complex or (B is not None and B.is_complex):
            raise NotImplementedError("KronOp factors must be real")
        dtype = dtype or torch.float64
        Ad = _ell_to_dense(A, dtype)
        if B is None:
            # cheap exact check at small sizes only
            if A.n * A.n <= (1 << 22) and not torch.equal(Ad, Ad.T):
                raise ValueError("B=None requires symmetric A")
            Bt = Ad  # psi @ A^T == psi @ A for symmetric A; share the memory
        else:
            Bt = _ell_to_dense(B, dtype).T.contiguous()
        P = None
        if coupling is not None:
            P = torch.as_tensor(_compact_coupling(coupling), device=A.device)
        # stored nonzeros of the assembled H (for nnz/s benchmarks)
        wB = B.width if B is not None else A.width
        self._install(Ad, Bt, A.diag.to(dtype),
                      (B.diag if B is not None else A.diag).to(dtype), P,
                      float(coupling_scale) if coupling is not None else 0.0,
                      A.n * (B.n if B is not None else A.n)
                      * (A.width + wB + 1))

    @classmethod
    def from_arrays(cls, Ad, Bt, adiag, bdiag, P, pscale, nnz_estimate=0):
        """An engine from its parameter tensors (``Bt`` may be ``Ad``)."""
        op = cls.__new__(cls)
        op._install(Ad, Bt, adiag, bdiag, P, float(pscale), nnz_estimate)
        return op

    def _install(self, Ad, Bt, adiag, bdiag, P, pscale, nnz_estimate):
        self._Ad, self._Bt = Ad, Bt
        self._adiag, self._bdiag = adiag, bdiag
        self._P, self._pscale = P, pscale
        self.dtype = Ad.dtype
        self.device = Ad.device
        self.na, self.nb = int(Ad.shape[0]), int(Bt.shape[0])
        self.N = self.n = self.na * self.nb
        self.nnz_estimate = int(nnz_estimate)
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_complex():
            raise NotImplementedError("KronOp is a real engine")
        psi = x.to(self.dtype).view(self.na, self.nb)
        y = self._Ad @ psi
        y.addmm_(psi, self._Bt)
        # (a (+) b + s P) o psi, accumulated without forming the diagonal
        y.addcmul_(self._adiag[:, None], psi)
        y.addcmul_(self._bdiag[None, :], psi)
        if self._P is not None:
            y.addcmul_(self._P, psi, value=self._pscale)
        self.n_applies += 1
        return y.view(-1)


def diagonal_product_coupling(space_a, labels_a, space_b, labels_b, pairs):
    """P = sum_m u_m (x) w_m for diagonal operator pairs (op_a, op_b).

    Each op is an all-diagonal Mopr on its factor space; u_m/w_m are its
    per-basis-state values. Returns the dense (na, nb) coupling matrix
    (host numpy, computed as one (na, M) @ (M, nb) product). For the Hubbard
    U term the pairs are (n_i^up, n_i^dn) per site and P[r, c] is the number
    of doubly occupied sites: integer-valued, stored int8 downstream.
    """
    Va = space_a.decode(np.asarray(labels_a, dtype=np.int64))
    Vb = space_b.decode(np.asarray(labels_b, dtype=np.int64))
    U = np.empty((len(labels_a), len(pairs)), dtype=np.float64)
    W = np.empty((len(pairs), len(labels_b)), dtype=np.float64)
    for m, (op_a, op_b) in enumerate(pairs):
        U[:, m] = compile_diagonal(op_a, space_a)(Va)
        W[m, :] = compile_diagonal(op_b, space_b)(Vb)
    return U @ W
