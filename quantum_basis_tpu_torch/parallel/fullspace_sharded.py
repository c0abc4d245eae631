"""Sharded full-label-space roll engine.

Port of ``quantum_basis_tpu.parallel.fullspace_sharded``. The full-space
apply (ops/apply_fullspace.py) is a diagonal plus masked rolls,

    y = diag o x + sum_p roll(coef_p o x, delta_p).

Under a split of the label axis into P equal contiguous slices each rank
holds its slice of x, of the diagonal and of every pass coefficient, and a
roll by delta becomes a local shift plus a boundary exchange: the slice a
rank reads, shifted by delta, spans at most two source ranks, also when
|delta| exceeds the slice length. The part that lives on the rank itself is
accumulated in place (``addcmul_``); the part on another rank is multiplied
there and arrives by ``batch_isend_irecv``. Where the JAX package lets GSPMD
lower each roll to a collective-permute, this engine names its peers.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.parallel.mesh import RowSharded


class FullSpaceSharded(RowSharded):
    """A :class:`~quantum_basis_tpu_torch.ops.apply_fullspace.FullSpaceOp`
    split over ``mesh``: every rank passes the same engine and keeps its
    slices. Raises when the label space does not divide into the ranks.
    """

    def __init__(self, fs, mesh, axis: str = "b"):
        N = fs.N
        if N % mesh.size:
            raise ValueError("label space must divide the mesh size "
                             f"({N} % {mesh.size} != 0)")
        self.fs = fs
        self.mesh = mesh
        self.axis = axis
        self.N = self.n = self.n_pad = self.n_logical = N
        self.is_complex = fs.is_complex
        self.dtype = fs.dtype
        self.device = dev = mesh.device
        self.span = lo, hi = mesh.span(N)
        self.n_local = hi - lo

        def mine(t):
            return t[lo:hi].to(dev).clone()

        self.diag_full = mine(fs.diag_full)
        self.mask = mine(fs.mask) if fs.mask is not None else None
        self._passes = [(mine(c), a) + self._pieces(d)
                        for d, c, a in fs._rolls._coefs]
        self.n_applies = 0

    def _pieces(self, d: int):
        """The two boundary pieces of a roll by d (0 <= d < N) on this rank:
        [(source rank, source [a, b), destination offset)] for what it
        receives and [(destination rank, source [a, b))] for what it sends;
        empty pieces are left out."""
        nl, P, r = self.n_local, self.mesh.size, self.mesh.rank
        src = (r * nl - d) % self.N           # first source label read
        s_rank, o = divmod(src, nl)
        recv = [(s_rank, o, nl, 0)]
        if o:
            recv.append(((s_rank + 1) % P, 0, o, nl - o))
        dst = (r * nl + d) % self.N           # first destination written
        t_rank, o2 = divmod(dst, nl)
        send = [(t_rank, 0, nl - o2)]
        if o2:
            send.append(((t_rank + 1) % P, nl - o2, nl))
        return recv, send

    def sent_per_apply(self) -> tuple[int, int]:
        """(vector entries, messages) this rank sends to other ranks per
        apply: the boundary pieces of every pass."""
        me = self.mesh.rank
        pieces = [s1 - s0 for *_, send in self._passes
                  for p, s0, s1 in send if p != me]
        return sum(pieces), len(pieces)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slice of H x from this rank's slice of x."""
        if self.is_complex or x.is_complex():
            x = x.to(torch.complex128)
        else:
            x = x.to(torch.float64)
        y = self.diag_full * x
        me = self.mesh.rank
        for c, a, recv, send in self._passes:
            sends = [(p, c[s0:s1] * x[s0:s1]) for p, s0, s1 in send
                     if p != me]
            bufs = []
            for p, s0, s1, t0 in recv:
                if p == me:
                    y[t0:t0 + s1 - s0].addcmul_(c[s0:s1], x[s0:s1], value=a)
                else:
                    bufs.append((p, torch.empty(s1 - s0, dtype=y.dtype,
                                                device=y.device), t0))
            if sends or bufs:
                self.mesh.exchange(sends, [(p, b) for p, b, _ in bufs])
                for _, b, t0 in bufs:
                    y[t0:t0 + b.shape[0]].add_(b, alpha=a)
        self.n_applies += 1
        return y

    # sector interop: the wrapped engine's meaning, on slices
    def to_full(self, x_sector: torch.Tensor) -> torch.Tensor:
        """Whole sector-coordinate vector -> this rank's full-space slice."""
        lo, hi = self.span
        return self.fs.to_full(x_sector)[lo:hi].to(self.device)

    def to_sector(self, x_full: torch.Tensor) -> torch.Tensor:
        """This rank's full-space slice -> the whole sector-coordinate
        vector, on every rank."""
        return self.fs.to_sector(self.unpad(x_full).to(self.fs.device))
