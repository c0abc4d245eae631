"""Row-sharded tensor-factorized engine: the flagship's multi-device path.

Port of ``quantum_basis_tpu.parallel.kron_sharded``.
:class:`~quantum_basis_tpu_torch.ops.apply_kron.KronOp` applies a
factorizable sector Hamiltonian on the state matrix ``psi`` (na, nb); here
``psi`` is split by rows (the first factor's index) over the ranks, and each
rank all-gathers ``psi`` once per apply (one (na, nb) frame moved, as the
JAX package's reduce-scatter of column-sharded partial products moves) for
its own rows of ``A psi``; ``psi B^T``, the diagonal and the coupling are
local. The layouts are KronOp's (``layout=``, the device's routing entry
``kron_dense_max_dim`` when None):

- ``"dense"``: the rank's dense rows of ``A`` times the gathered ``psi``,
  dense ``B^T`` on the local rows, the diagonal as ``addcmul_``;
- ``"ell"``: the rank's ELL rows of ``A`` (global columns) and ``B``'s ELL,
  the whole apply one call of the fused kernel (``ops/apply_kron.kron_ell``)
  with the gathered matrix as the A side's source; no dense factor is built.

Rows are padded up to a multiple of the ranks with zero rows (zero A rows
and columns, zero diagonal, zero coupling): padded components of ``psi``
start at zero and stay zero, and the ``mask`` keeps the solvers' random
restarts inside the physical rows.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.ops.apply_kron import (
    _bytes,
    _compact_coupling,
    _ell_to_dense,
    ell_arrays,
    kron_layout,
    kron_ell,
)
from quantum_basis_tpu_torch.parallel.mesh import RowSharded


def _dense_rows(ell, lo: int, hi: int, width: int, device):
    """Rows [lo, hi) of the ELL's off-diagonal part as a dense float64
    (hi - lo, width) block; rows past the matrix are zero."""
    out = torch.zeros((hi - lo, width), dtype=torch.float64, device=device)
    top = min(hi, ell.n)
    if ell.width and top > lo:
        cols = ell.cols[lo:top].to(device)
        rows = torch.arange(top - lo, device=device)[:, None].expand_as(cols)
        # padding entries carry val 0.0 at col 0: harmless under add
        out.index_put_((rows, cols), ell.vals[lo:top].to(
            device=device, dtype=torch.float64), accumulate=True)
    return out


class KronSharded(RowSharded):
    """KronOp with ``psi``'s rows split over ``mesh``; see the module
    docstring. ``N`` / ``n`` / ``n_pad`` count the padded space,
    ``n_logical`` the sector."""

    is_complex = False

    def __init__(self, A, B=None, coupling=None, coupling_scale: float = 1.0,
                 mesh=None, dtype=None, layout: str | None = None,
                 axis: str = "b"):
        if mesh is None:
            raise ValueError("KronSharded requires a mesh")
        if A.is_complex or (B is not None and B.is_complex):
            raise NotImplementedError("KronSharded factors must be real")
        self.mesh = mesh
        self.axis = axis
        dtype = dtype or torch.float64
        self.dtype = dtype
        self.device = dev = mesh.device
        if B is None:
            B = A
        na, P = A.n, mesh.size
        self.na_logical = na
        self.na = -(-na // P) * P
        self.nb = B.n
        self.N = self.n = self.n_pad = self.na * self.nb
        self.n_logical = na * self.nb
        nal = self.na // P
        r0, r1 = mesh.rank * nal, (mesh.rank + 1) * nal
        self.span = (r0 * self.nb, r1 * self.nb)
        self.nnz_estimate = na * self.nb * (A.width + B.width + 1)

        if layout is None:
            layout = kron_layout(na, self.nb, dev)
        self.layout = layout
        self._A = self._Bt = self._Aell = self._Bell = None
        if layout == "dense":
            self._A = _dense_rows(A, r0, r1, self.na, dev).to(dtype)
            self._Bt = _ell_to_dense(B, dtype).T.contiguous().to(dev)
        elif layout == "ell":
            self._Bell = ell_arrays(B, dtype, dev)
            # one rank holding every row of its own B: one set of arrays
            self._Aell = (self._Bell if B is A and (r0, r1) == (0, na)
                          else ell_arrays(A, dtype, dev, r0, r1))
        else:
            raise ValueError(f"layout must be 'dense', 'ell' or None, not "
                             f"{layout!r}")
        adiag = torch.zeros(nal, dtype=torch.float64, device=dev)
        top = min(r1, na)
        if top > r0:
            adiag[: top - r0] = A.diag[r0:top].to(dev)
        self._adiag = adiag.to(dtype)
        self._bdiag = B.diag.to(device=dev, dtype=dtype)
        self._P, self._pscale = None, 0.0
        if coupling is not None:
            Pc = torch.as_tensor(_compact_coupling(coupling))
            Ploc = torch.zeros((nal, self.nb), dtype=Pc.dtype)
            if top > r0:
                Ploc[: top - r0] = Pc[r0:top]
            self._P = Ploc.to(dev)
            self._pscale = float(coupling_scale)
        self.mask = ((torch.arange(r0, r1, device=dev) < na)
                     .to(torch.float64)[:, None]
                     .expand(nal, self.nb).reshape(-1))
        self.n_applies = 0

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of H psi from this rank's rows of psi."""
        if x.is_complex():
            raise NotImplementedError("KronSharded is a real engine")
        psi = x.to(self.dtype).view(-1, self.nb)
        full = self.mesh.all_gather(psi)
        if self.layout == "ell":
            y = kron_ell(self._Aell, self._Bell, self._adiag, self._bdiag,
                         self._P, self._pscale, psi, full)
        else:
            y = self._A @ full
            y.addmm_(psi, self._Bt)
            y.addcmul_(self._adiag[:, None], psi)
            y.addcmul_(self._bdiag[None, :], psi)
            if self._P is not None:
                y.addcmul_(self._P, psi, value=self._pscale)
        self.n_applies += 1
        return y.view(-1)

    @property
    def resident_bytes(self) -> int:
        """Device bytes this rank's engine holds (the mask excluded)."""
        sides = (self._Aell or ()) + (self._Bell or ())
        return _bytes(self._A, self._Bt, *sides, self._adiag, self._bdiag,
                      self._P)
