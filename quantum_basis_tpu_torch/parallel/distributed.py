"""Process-group start-up and global meshes.

Port of ``quantum_basis_tpu.parallel.distributed``. The reference scales
across hosts with MPI (SURVEY §2.2 / §5.8); the JAX package with JAX's
multi-controller runtime. Here it is ``torch.distributed``, one rank per
device:

1. every process calls :func:`init_distributed` once at start-up;
2. each builds the same :func:`global_basis_mesh` and keeps its own row
   shard on its own device;
3. the sharded engines (parallel/*) and the solvers call the collectives
   explicitly: NCCL between CUDA devices, gloo between CPU processes.

Without arguments and without a launcher's environment
:func:`init_distributed` starts nothing and returns False, so a driver can
call it unconditionally. A launch that declares more than one rank and
fails to form its group raises: nothing falls back to independent
single-rank runs.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from quantum_basis_tpu_torch.parallel.mesh import (
    BasisMesh,
    _default_backend,
    basis_mesh,
)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, device="cuda",
                     backend: str | None = None) -> bool:
    """Start this process's rank of the group (idempotent).

    ``coordinator_address`` is a ``torch.distributed`` init method
    (``tcp://host:port``, ``file:///path``) or ``host:port``;
    ``num_processes`` / ``process_id`` the world size and this rank. Without
    them the launcher's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT``, as torchrun sets them) is read.
    ``local_device_ids`` picks this rank's card (default: ``LOCAL_RANK``,
    else the rank modulo the cards). ``backend`` defaults to NCCL for a CUDA
    ``device`` and gloo for the CPU. Returns True when a group of more than
    one rank is active.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = coordinator_address is not None or num_processes is not None
    from_env = all(k in os.environ for k in _LAUNCHER_ENV)
    if not (explicit or from_env):
        return False
    backend = backend or _default_backend(device)
    init_method = coordinator_address
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    if init_method is None:
        init_method = "env://"
    declared = (num_processes if num_processes is not None
                else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            # this rank's card: as given, else the launcher's local rank,
            # else the rank modulo the cards of the host
            local = (np.atleast_1d(local_device_ids)[0]
                     if local_device_ids is not None
                     else os.environ.get("LOCAL_RANK",
                                         rank % torch.cuda.device_count()))
            dev = torch.device("cuda", int(local))
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=declared, rank=rank)
    except (RuntimeError, ValueError, OSError) as e:
        if explicit or declared > 1:
            raise RuntimeError(
                f"torch.distributed group of {declared} ranks failed to "
                f"start (rank {rank}, {init_method}): {e}") from e
        warnings.warn(f"init_process_group failed ({e}); continuing as a "
                      "single process")
        return False
    return dist.get_world_size() > 1


def run_ranks(argv, ranks: int, timeout: float) -> list[str]:
    """Run one group: ``ranks`` processes ``argv + [rank, ranks,
    rendezvous]`` with a file:// rendezvous in a fresh temporary directory.
    Waits for all of them, kills every one still running after ``timeout``
    seconds or after a rank failed, and returns their outputs in rank
    order; raises, with the end of its output, when a rank fails.

    The group lives on one host, so NCCL's bootstrap is pinned to the
    loopback interface (``NCCL_SOCKET_IFNAME=lo`` unless the caller's
    environment sets it): the data moves over NVLink or shared memory
    either way.
    """
    tmp = tempfile.mkdtemp(prefix="qbt_ranks_")
    env = dict(os.environ)
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the ranks import this package wherever they start
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    rdv = os.path.join(tmp, "rendezvous")
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(ranks)]
    procs = [subprocess.Popen([*argv, str(r), str(ranks), rdv], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(ranks)]
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails leaves the others waiting in a collective: stop
        # the group at the first failure
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c for c in codes):
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    shutil.rmtree(tmp, ignore_errors=True)
    codes = [p.returncode for p in procs]
    # the rank that failed first, not one killed after it
    bad = ([r for r, c in enumerate(codes) if c not in (0, -9)]
           or [r for r, c in enumerate(codes) if c])
    if bad:
        r = bad[0]
        raise RuntimeError(f"rank {r} of {ranks} exited {codes[r]}:\n"
                           + "\n".join(outs[r].splitlines()[-30:]))
    return outs


def process_info():
    """(rank, ranks, devices of this process, devices of the group): one
    device per rank."""
    if not dist.is_initialized():
        return (0, 1, 1, 1)
    n = dist.get_world_size()
    return (dist.get_rank(), n, 1, n)


def global_basis_mesh(axis: str = "b", device="cuda") -> BasisMesh:
    """The mesh over every rank of the group (one device each).

    Every rank builds it and gets its own handle; rank order is the group's,
    the same on every rank after :func:`init_distributed`.
    """
    return basis_mesh(axis=axis, device=device)


def shard_array_over_mesh(x, mesh: BasisMesh, axis: str = "b"):
    """This rank's contiguous slice of a host array's first axis, on the
    mesh's device: each rank provides only its own shard. The first axis
    must divide into ``mesh.size`` equal slices."""
    x = np.asarray(x)
    lo, hi = mesh.span(x.shape[0])
    return torch.as_tensor(np.ascontiguousarray(x[lo:hi]),
                           device=mesh.device)
