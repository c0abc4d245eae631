"""The basis mesh: a 1-D group of ranks, one device each.

Port of ``quantum_basis_tpu.parallel.mesh``. The framework's single scaling
axis is the Hilbert-space (basis-row) dimension, the analog of the
reference's OpenMP row-parallel loops (reference: src/model.cc:646-679 and
§2.2 of SURVEY.md).

JAX's mesh is single-controller: one process sees every device, vectors are
global sharded arrays and XLA inserts the reductions. PyTorch's idiom is
multi-controller, and so is this port: every rank runs the same program,
holds its own contiguous row shard of every vector on its own device, and
reduces explicitly through ``torch.distributed`` on a process group. A
:class:`BasisMesh` is one rank's handle on that group: its size and rank,
its device, and the few collectives the sharded engines and the solvers
call. Complex tensors travel as ``torch.view_as_real`` views, which every
backend carries.
"""

from __future__ import annotations

import warnings

import torch
import torch.distributed as dist


def _mesh_device(device) -> torch.device:
    """``device`` with a CUDA index filled in: ``"cuda"`` is this process's
    current card, the one ``init_distributed`` selected for its rank."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)


def _default_backend(device) -> str:
    """NCCL for CUDA devices, gloo for CPU devices."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _as_real(t: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(t) if t.is_complex() else t


class BasisMesh:
    """This rank's view of a 1-D group of ranks (one device per rank).

    ``group`` is a ``torch.distributed`` process group (None: the default
    group), ``device`` the device this rank's shards live on. Vectors of
    global length ``n_pad`` (a multiple of ``size``) are split into ``size``
    contiguous slices; rank r holds :meth:`span` ``(n_pad)``.
    """

    def __init__(self, group=None, device="cuda", axis: str = "b"):
        if not dist.is_initialized():
            raise RuntimeError("no process group: call init_distributed() "
                               "first, or use basis_mesh()")
        self.group = group
        self.axis = axis
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = _mesh_device(device)
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group carries CUDA tensors only; "
                             f"device {self.device} needs a gloo group")
        # one collective of every rank first: NCCL requires it before a
        # point-to-point batch in which not every rank takes part
        self.all_reduce(torch.zeros(1, device=self.device))

    @property
    def shape(self) -> dict:
        """``{axis: size}``, as ``jax.sharding.Mesh.shape``."""
        return {self.axis: self.size}

    def __repr__(self):
        return (f"BasisMesh(size={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    def span(self, n_pad: int) -> tuple[int, int]:
        """This rank's slice [lo, hi) of a vector of global length n_pad."""
        if n_pad % self.size:
            raise ValueError(f"length {n_pad} does not split over "
                             f"{self.size} ranks")
        nl = n_pad // self.size
        return self.rank * nl, (self.rank + 1) * nl

    # ------------------------------------------------------------ collectives

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Reduce ``t`` over the ranks in place ("sum" or "max"); returns t."""
        red = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
        dist.all_reduce(_as_real(t.reshape(-1)), op=red, group=self.group)
        return t

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` (equal shapes) concatenated along dim 0."""
        out = torch.empty((self.size * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with warnings.catch_warnings():
            # newer releases rename it; the name kept exists in all of them
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(_as_real(out),
                                        _as_real(x.contiguous()),
                                        group=self.group)
        return out

    def gather_root(self, x: torch.Tensor):
        """Every rank's ``x`` (equal shapes) concatenated along the last
        axis, as a host tensor on rank 0; None on the other ranks."""
        x = x.contiguous()
        parts = ([torch.empty_like(x) for _ in range(self.size)]
                 if self.rank == 0 else None)
        root = (0 if self.group is None
                else dist.get_global_rank(self.group, 0))
        dist.gather(_as_real(x), [_as_real(p) for p in parts]
                    if parts is not None else None, dst=root,
                    group=self.group)
        if parts is None:
            return None
        return torch.cat([p.cpu() for p in parts], dim=-1)

    def all_gather_ragged(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's 1-d ``x`` (any lengths) concatenated in rank order."""
        n = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        counts = self.all_gather(n).tolist()
        width = max(counts)
        buf = torch.zeros(width, dtype=x.dtype, device=x.device)
        buf[: x.shape[0]] = x
        full = self.all_gather(buf)
        return torch.cat([full[r * width: r * width + c]
                          for r, c in enumerate(counts)])

    def all_to_all(self, x: torch.Tensor, send_counts, recv_counts):
        """Ragged all-to-all along dim 0: rows [sum(send_counts[:q]), ...) of
        ``x`` go to rank q; returns the received rows in rank order."""
        out = torch.empty((int(sum(recv_counts)),) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_to_all_single(_as_real(out), _as_real(x.contiguous()),
                               [int(c) for c in recv_counts],
                               [int(c) for c in send_counts],
                               group=self.group)
        return out

    def exchange(self, sends, recvs) -> None:
        """Point-to-point: ``sends`` / ``recvs`` are lists of (peer rank,
        tensor); the receive tensors are filled in place. At most one send
        and one receive per peer: NCCL matches the messages between two
        ranks in the order they were posted."""
        ops = [dist.P2POp(dist.isend, _as_real(t.contiguous()), peer,
                          self.group) for peer, t in sends]
        ops += [dist.P2POp(dist.irecv, _as_real(t), peer, self.group)
                for peer, t in recvs]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()


def basis_mesh(n_devices: int | None = None, axis: str = "b",
               device="cuda") -> BasisMesh:
    """A :class:`BasisMesh` over the default process group.

    The JAX package's ``basis_mesh(n)`` spans the first n devices of one
    process. Here every rank of the group calls this function and gets its
    own handle; ``n_devices``, where given, must be the group's size. With no
    process group yet, a single-rank group is started in this process (NCCL
    for a CUDA ``device``, gloo for the CPU), so a one-device mesh needs no
    launcher.
    """
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"requested {n_devices} ranks, but no process "
                             "group runs: start them with init_distributed()")
        dist.init_process_group(_default_backend(device),
                                store=dist.HashStore(), rank=0, world_size=1)
    mesh = BasisMesh(device=device, axis=axis)
    if n_devices is not None and n_devices != mesh.size:
        raise ValueError(f"requested {n_devices} ranks, the group has "
                         f"{mesh.size}")
    return mesh


class RowSharded:
    """Vector IO of an engine whose vectors are split by rows over a mesh.

    The engine sets ``mesh``, ``span`` (this rank's [lo, hi) of the global
    padded length ``n_pad``) and ``n_logical`` (the unpadded length; the
    padding sits at the end).
    """

    def pad(self, x) -> torch.Tensor:
        """Whole logical vector (every rank passes the same) -> this rank's
        slice of the padded vector, on the mesh's device."""
        x = torch.as_tensor(x)
        lo, hi = self.span
        out = torch.zeros(hi - lo, dtype=x.dtype, device=self.mesh.device)
        top = min(hi, self.n_logical)
        if top > lo:
            out[: top - lo] = x[lo:top].to(self.mesh.device)
        return out

    def unpad(self, y: torch.Tensor) -> torch.Tensor:
        """This rank's slice -> the whole logical vector, on every rank."""
        return self.mesh.all_gather(y)[: self.n_logical]
