"""Reductions of the Krylov solvers, on one device or over a basis mesh.

An operator that carries a ``mesh`` (the sharded engines of parallel/*)
hands the solvers this rank's contiguous slice ``span = (lo, hi)`` of every
vector. Each inner product and norm is then a local partial result summed
over the ranks, and every decision a solver takes (convergence, breakdown,
restart, deflate-and-verify) reads only such summed values, which every rank
receives alike: the ranks take the same branches and issue the same
collectives. Without a mesh these helpers are the plain torch calls.
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
    """The active checkpoint store for ``ckpt_key`` (None when off)."""
    store = ckpt.active_store() if ckpt_key else None
    if store is not None:
        refuse_sharded_ckpt(mesh_of(op))
    return store


def refuse_sharded_ckpt(mesh) -> None:
    """Checkpoint records hold whole vectors, and a rank of a group of
    several holds only a shard of each: refused there."""
    if mesh is not None and mesh.size > 1:
        raise RuntimeError(
            "checkpointing (config.enable_ckpt) is not supported on a group "
            f"of {mesh.size} ranks: each rank holds only a shard of the "
            "solver's vectors")
