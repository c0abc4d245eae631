"""Reductions of the Krylov solvers, on one device or over a basis mesh.

An operator that carries a ``mesh`` (the sharded engines of parallel/*)
hands the solvers this rank's contiguous slice ``span = (lo, hi)`` of every
vector. Each inner product and norm is then a local partial result summed
over the ranks, and every decision a solver takes (convergence, breakdown,
restart, deflate-and-verify) reads only such summed values, which every rank
receives alike: the ranks take the same branches and issue the same
collectives. Without a mesh these helpers are the plain torch calls.
Checkpoint records go through :class:`GroupStore` for the same reason: rank
0 decides about them for the group.
"""

from __future__ import annotations

import torch

from quantum_basis_tpu_torch.utils import ckpt


def mesh_of(op):
    """The operator's basis mesh, or None."""
    return getattr(op, "mesh", None)


def span_of(op, n: int) -> tuple[int, int]:
    """This rank's slice [lo, hi) of a length-n solver vector."""
    return getattr(op, "span", None) or (0, n)


def dot(a: torch.Tensor, b: torch.Tensor, mesh=None) -> torch.Tensor:
    """<a, b> (conjugating a); for a 2-d ``a`` the vector of <a_i, b>."""
    d = a.conj() @ b if a.dim() == 2 else torch.vdot(a, b)
    return d if mesh is None else mesh.all_reduce(d)


def norm(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """||x||_2 as a 0-d tensor."""
    if mesh is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(mesh.all_reduce(torch.linalg.vector_norm(x).square()))


def ckpt_store(op, ckpt_key):
    """The active checkpoint store for ``ckpt_key`` as this rank of the
    operator's mesh sees it (None when off)."""
    store = ckpt.active_store() if ckpt_key else None
    return GroupStore(store, mesh_of(op)) if store is not None else None


class GroupStore:
    """A checkpoint store shared by the ranks of a basis mesh.

    Records hold whole vectors, as the JAX package's single-controller
    records do, so a P-rank run writes the record the JAX package writes
    for the same key and P. Rank 0 alone decides (is there a record, does
    it fit, is a save due), writes and deletes; each decision reaches the
    other ranks by a broadcast, since a rank that decided alone would leave
    the others waiting in a collective. Every rank then reads an accepted
    record, all of them before any goes on, and keeps its own slice.
    Without a mesh, or on a group of one rank, each call is the plain
    store's.
    """

    def __init__(self, store, mesh=None):
        self.store = store
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.root = self.mesh is None or self.mesh.rank == 0

    def agree(self, flag) -> bool:
        """Rank 0's ``flag``, on every rank."""
        if self.mesh is None:
            return bool(flag)
        t = torch.tensor([1.0 if (self.root and flag) else 0.0],
                         dtype=torch.float64, device=self.mesh.device)
        return bool(self.mesh.all_reduce(t)[0] > 0)

    def length(self, x: torch.Tensor) -> int:
        """The whole length of the vectors whose slice ``x`` (last axis) is."""
        return x.shape[-1] * (self.mesh.size if self.mesh is not None else 1)

    def nbytes(self, x: torch.Tensor, complex_vec: bool) -> int:
        """Bytes of ``ckpt.split_vec(self.whole(x), complex_vec)``, from the
        shapes alone and alike on every rank: a record past the device's
        ``ckpt_max_bytes`` (``config.MEMORY``) is refused before anything is
        gathered."""
        n = x[..., :1].numel() * self.length(x)
        real = x.real.element_size()
        return 2 * n * real if complex_vec else n * real + 8  # + zeros(1)

    def whole(self, x: torch.Tensor) -> torch.Tensor:
        """The whole vector(s) whose slice ``x`` (last axis) is, on rank 0's
        host; ``x`` itself on the other ranks, whose payloads are never
        written."""
        if self.mesh is None:
            return x
        full = self.mesh.gather_root(x)
        return x if full is None else full

    def load(self, key: str, fits=None, vectors=()):
        """The record under ``key`` if rank 0 finds one and ``fits(rec)``
        (checked against whole lengths) holds, else None. The ``vectors``
        fields, whole vectors along their last axis, come cut to this rank's
        slice (a length-1 placeholder stays as it is; an absent one is
        skipped)."""
        rec = self.store.load(key) if self.root else None
        if not self.agree(rec is not None and (fits is None or fits(rec))):
            return None
        if self.mesh is None:
            return rec
        if rec is None:
            rec = self.store.load(key)
        # every rank has read it before any goes on (and may replace it);
        # a rank that could not read it makes every rank raise
        failed = torch.tensor([float(rec is None)], dtype=torch.float64,
                              device=self.mesh.device)
        if float(self.mesh.all_reduce(failed)[0]):
            raise RuntimeError(f"a rank of {self.mesh.size} cannot read the "
                               f"checkpoint record {key!r} that rank 0 "
                               "accepted")
        for name in vectors:
            a = rec.get(name)
            if a is not None and a.shape[-1] != 1:
                lo, hi = self.mesh.span(a.shape[-1])
                rec[name] = a[..., lo:hi]
        return rec

    def save(self, key: str, payload: dict) -> None:
        """Rank 0 writes ``payload``; every rank returns once it is written,
        or raises if rank 0 could not write it."""
        self._on_root(lambda: self.store.save(key, payload),
                      f"write the checkpoint record {key!r}")

    def delete(self, key: str) -> None:
        """Rank 0 deletes the record; every rank returns once it is gone,
        or raises if rank 0 could not delete it."""
        self._on_root(lambda: self.store.delete(key),
                      f"delete the checkpoint record {key!r}")

    def _on_root(self, act, what: str) -> None:
        """``act()`` on rank 0, then every rank returns or every rank
        raises (rank 0 its own error), as ``load`` does for a failed read."""
        err = None
        if self.root:
            try:
                act()
            except Exception as e:
                if self.mesh is None:
                    raise
                err = e
        if self.agree(err is not None):
            if err is not None:
                raise err
            raise RuntimeError(f"rank 0 of {self.mesh.size} could not {what}")
