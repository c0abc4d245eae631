"""Process-group start-up and the one-rank mesh of the port
(parallel/distributed.py, parallel/mesh.py), beside the JAX package's
tests/test_distributed.py.

Without a launcher's environment ``init_distributed`` starts nothing and
returns False, as the JAX package's single-process fallback does; a launch
that declares several ranks and cannot form its group raises. Then a
one-rank gloo group inside this process (file:// rendezvous, destroyed at
module teardown): ``process_info``, the global mesh, the
``shard_array_over_mesh`` round-trip, ``FullSpaceSharded`` on it against
the JAX engine on the global 8-device mesh, and ``Model(mesh=)`` against the
single-device port. The ``cuda``-marked tests run the same one-rank route
over NCCL on a card, and ``FullSpaceSharded`` on a 4-rank NCCL group where
the machine has 4 cards (``python -m pytest --noconftest
tests/test_torch_distributed.py -m cuda`` on the GPU machine; JAX is
imported only inside the tests that compare with it).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_zoo as tz
from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
from quantum_basis_tpu_torch.parallel import (
    BasisMesh,
    EllShardedHalo,
    basis_mesh,
    global_basis_mesh,
    init_distributed,
    process_info,
    run_ranks,
    shard_array_over_mesh,
)
from quantum_basis_tpu_torch.parallel.fullspace_sharded import (
    FullSpaceSharded,
)

_LAUNCHER = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
             "LOCAL_RANK")


@pytest.fixture
def no_launcher(monkeypatch):
    for k in _LAUNCHER:
        monkeypatch.delenv(k, raising=False)
    if dist.is_initialized():
        pytest.fail("a process group is already running in this process")


def test_init_distributed_single_process_fallback(no_launcher):
    assert init_distributed(device="cpu") is False
    assert not dist.is_initialized()
    assert process_info() == (0, 1, 1, 1)
    assert init_distributed(device="cpu") is False  # idempotent


def test_failed_multi_rank_launch_raises(no_launcher, monkeypatch):
    """A launcher that declares two ranks but gives no port cannot form the
    group: that raises instead of running one rank alone."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(RuntimeError, match="2 ranks failed to start"):
        init_distributed(device="cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed at teardown."""
    rdv = tmp_path_factory.mktemp("rdv") / "rendezvous"
    assert init_distributed(f"file://{rdv}", 1, 0, device="cpu") is False
    yield global_basis_mesh(device="cpu")
    dist.destroy_process_group()


def test_process_info_and_meshes(group, monkeypatch):
    assert dist.is_initialized()
    assert process_info() == (0, 1, 1, 1)
    assert (group.size, group.rank, group.backend) == (1, 0, "gloo")
    assert group.shape == {"b": 1} and group.device == torch.device("cpu")
    assert group.span(64) == (0, 64)
    assert basis_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="requested 2 ranks"):
        basis_mesh(2, device="cpu")
    # an NCCL group takes no CPU device: nothing moves to the CPU silently
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(ValueError, match="NCCL group carries CUDA"):
        BasisMesh(device="cpu")


def test_shard_array_over_mesh_roundtrip(group):
    from quantum_basis_tpu.parallel import (
        global_basis_mesh as jax_global_mesh,
        shard_array_over_mesh as jax_shard,
    )

    x = np.arange(64, dtype=np.float64)
    arr = shard_array_over_mesh(x, group)
    assert isinstance(arr, torch.Tensor) and arr.device == group.device
    np.testing.assert_array_equal(arr.numpy(), x)
    np.testing.assert_array_equal(np.asarray(jax_shard(x, jax_global_mesh())),
                                  arr.numpy())


def test_global_mesh_drives_fullspace_engine(group):
    """The mirror of the JAX package's test_global_mesh_drives_gspmd_engine:
    chain-10 on the one-rank mesh against the JAX engine on its global
    8-device mesh and the port's single-device engine (1e-12 x max|y|)."""
    import jax.numpy as jnp

    import models_zoo as jz
    from quantum_basis_tpu.ops.apply_fullspace import (
        FullSpaceOp as JaxFullSpaceOp,
    )
    from quantum_basis_tpu.parallel import global_basis_mesh as jax_mesh
    from quantum_basis_tpu.parallel.fullspace_sharded import (
        FullSpaceSharded as JaxFullSpaceSharded,
    )

    m, c = tz.heisenberg_chain(10)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    s = m.sec_full[0]
    fs = FullSpaceOp(m.compiled_Ham, s.labels, device="cpu")
    fss = FullSpaceSharded(fs, group)
    x = np.random.default_rng(3).normal(size=s.dim)
    y = fss(fss.to_full(torch.as_tensor(x))).numpy()
    y1 = fs(fs.to_full(torch.as_tensor(x))).numpy()
    mj, cj = jz.heisenberg_chain(10, "1/2")
    mj.enumerate_basis_full([cj["Sz"]], [0.0])
    fj = JaxFullSpaceOp(mj.compiled_Ham, mj.sec_full[0].labels)
    yj = np.asarray(JaxFullSpaceSharded(fj, jax_mesh())(
        fj.to_full((jnp.asarray(x), None)))[0])
    scale = np.max(np.abs(yj))
    assert np.max(np.abs(y - yj)) <= 1e-12 * scale
    np.testing.assert_array_equal(y, y1)  # one rank: the same arithmetic


def test_one_rank_model_matches_single_device(group):
    """Model(mesh=) on the one-rank group: the halo engine (no traffic:
    traffic_ratio 0) and the summed reductions give the single-device E0."""
    m, c = tz.heisenberg_chain(12)
    m.set_mesh(group)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos()
    mv = m.sec_full[0]._mesh_mv[1]
    assert isinstance(mv, EllShardedHalo)
    assert mv.halo_stats() == {"halo_nnz": 0, "pair_capacity": 8,
                               "exchanged_per_apply": 0,
                               "allgather_per_apply": 0, "traffic_ratio": 0.0}
    assert abs(m.eigenvals_full[0] - (-5.387390917445)) < 1e-10
    m1, c1 = tz.heisenberg_chain(12)
    m1.enumerate_basis_full([c1["Sz"]], [0.0])
    m1.generate_Ham_sparse_full()
    m1.locate_E0_lanczos()
    assert abs(m.eigenvals_full[0] - m1.eigenvals_full[0]) < 1e-10
    m.set_mesh(None)
    assert m.mesh is None and m.sec_full[0]._mesh_mv is None


def test_one_rank_checkpoint_under_mesh_key(group, tmp_path, monkeypatch):
    """On a one-rank group checkpointing works as without a mesh, under a
    stage key that carries ``_mesh1``: a rerun loads the stage record and
    applies nothing."""
    from quantum_basis_tpu_torch import config

    monkeypatch.setattr(config, "enable_ckpt", True)
    monkeypatch.setattr(config, "ckpt_dir", str(tmp_path))
    m, c = tz.heisenberg_chain(12)
    m.set_mesh(group)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos()
    e0, mv = m.eigenvals_full[0], m.sec_full[0]._mesh_mv[1]
    names = [p.name for p in tmp_path.iterdir()]
    assert len(names) == 1 and "_mesh1_" in names[0], names
    n = mv.n_applies
    m.locate_E0_lanczos()
    assert mv.n_applies == n and m.eigenvals_full[0] == e0
    assert abs(e0 - (-5.387390917445)) < 1e-10


_NCCL_SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import torch, torch.distributed as dist
import torch_zoo as tz
from quantum_basis_tpu_torch.parallel import (basis_mesh, init_distributed,
                                              EllShardedHalo)
init_distributed("file://" + {rdv!r}, 1, 0, device="cuda")
mesh = basis_mesh(device="cuda")
assert mesh.backend == "nccl", mesh
m, c = tz.heisenberg_chain(12, device="cuda")
m.set_mesh(mesh)
m.enumerate_basis_full([c["Sz"]], [0.0])
m.locate_E0_lanczos()
assert isinstance(m.sec_full[0]._mesh_mv[1], EllShardedHalo)
assert abs(m.eigenvals_full[0] - (-5.387390917445)) < 1e-10
dist.destroy_process_group()
print("NCCL_OK")
"""


@pytest.mark.cuda
def test_one_rank_nccl_group_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    code = _NCCL_SCRIPT.format(root=os.path.dirname(here), tests=here,
                               rdv=str(tmp_path / "rendezvous"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0 and "NCCL_OK" in out.stdout, \
        out.stdout[-2000:] + out.stderr[-2000:]


_NCCL4_SCRIPT = """
import sys
sys.path[:0] = [{root!r}, {tests!r}]
import torch, torch.distributed as dist
import torch_zoo as tz
from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
from quantum_basis_tpu_torch.parallel import (FullSpaceSharded, basis_mesh,
                                              init_distributed)
rank, ranks, rdv = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
init_distributed("file://" + rdv, ranks, rank, device="cuda")
mesh = basis_mesh(4, device="cuda")
assert mesh.backend == "nccl" and mesh.device.index == rank, mesh
m, c = tz.heisenberg_chain(16, device=mesh.device)
m.enumerate_basis_full([c["Sz"]], [0.0])
fs = FullSpaceOp(m.compiled_Ham, m.sec_full[0].labels, device=mesh.device)
fss = FullSpaceSharded(fs, mesh)
x = torch.as_tensor(tz.rand_vec(m.dim_full(), False, 11), device=mesh.device)
xf = fs.to_full(x)
want = fs(xf)
got = fss.unpad(fss(fss.pad(xf)))
err = float((got - want).abs().max() / want.abs().max())
assert err < 1e-12, err
dist.destroy_process_group()
print("NCCL4_OK", err)
"""


@pytest.mark.cuda
def test_four_rank_nccl_group_fullspace():
    """FullSpaceSharded on a 4-rank NCCL group, one card a rank (the
    boundary pieces go point to point), against FullSpaceOp (1e-12)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    here = os.path.dirname(os.path.abspath(__file__))
    code = _NCCL4_SCRIPT.format(root=os.path.dirname(here), tests=here)
    outs = run_ranks([sys.executable, "-c", code], 4, timeout=600)
    for out in outs:
        assert "NCCL4_OK" in out, out[-3000:]
