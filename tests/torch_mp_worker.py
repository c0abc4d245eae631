"""One rank of a gloo group for the port's multi-process tests.

Usage: torch_mp_worker.py <rank> <ranks> <rendezvous file> <suite> <out dir>

Starts this rank with ``init_distributed`` (file:// rendezvous), builds the
basis mesh on the CPU, runs every case of the suite ("sort", "sharded" or
"model", below) on the port (quantum_basis_tpu_torch, no JAX), and writes
``<out dir>/<suite>_r<rank>.npz`` (arrays) and ``.json`` (scalars). The
tests (tests/test_torch_sample_sort.py, test_torch_sharded.py,
test_torch_model_mesh.py) hold them against the JAX package on a P-device
mesh. Inputs are made from seeds with numpy, as the tests make them.
"""

from __future__ import annotations

import json
import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_HERE), _HERE]

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

import torch_zoo as tz  # noqa: E402
from quantum_basis_tpu_torch import config  # noqa: E402
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis  # noqa: E402
from quantum_basis_tpu_torch.parallel import (  # noqa: E402
    EllShardedHalo, MatvecSharded, basis_mesh, enumerate_basis_dnc_sharded,
    enumerate_reps_dnc_sharded, init_distributed)
from quantum_basis_tpu_torch.parallel.fullspace_sharded import (  # noqa: E402
    FullSpaceSharded)
from quantum_basis_tpu_torch.parallel.kron_sharded import KronSharded  # noqa: E402
from quantum_basis_tpu_torch.parallel.sample_sort import (  # noqa: E402
    sample_sort, sample_sort_sharded)

# ------------------------------------------------------------------ suites


def suite_sort(mesh, arrays, scalars):
    parts = {name: np.array_split(vals, mesh.size)[mesh.rank]
             for name, vals in tz.sort_inputs().items()}
    for name, part in parts.items():
        arrays[name] = sample_sort(part, mesh)
    arrays["local_random_40000"] = sample_sort_sharded(
        torch.as_tensor(parts["random_40000"]), mesh).numpy()
    m, o = tz.fermi_hubbard_square(4, 2)
    arrays["basis_dnc"] = enumerate_basis_dnc_sharded(
        m.space, [o["Nup"], o["Ndn"]], [4.0, 4.0], mesh, leaf=1 << 6)
    m, c = tz.heisenberg_chain(12)
    arrays["reps_dnc"], scalars["reps_dim"] = enumerate_reps_dnc_sharded(
        m.tset, [c["Sz"]], [0.0], mesh, block=1 << 10, with_dim=True)


def _halo_case(name, ell, mesh, arrays, scalars, complex_vecs):
    hs = EllShardedHalo(ell, mesh)
    scalars[f"halo_{name}"] = hs.halo_stats()
    for cv in complex_vecs:
        x = torch.as_tensor(tz.rand_vec(ell.n, cv, 5))
        arrays[f"halo_{name}_{'c' if cv else 'r'}"] = \
            hs.unpad(hs(hs.pad(x))).numpy()


def suite_sharded(mesh, arrays, scalars):
    from quantum_basis_tpu_torch.ops.apply import DeviceBasis
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
    from quantum_basis_tpu_torch.ops.sparse import EllMatrix

    # MatvecSharded: spin chain, spinless fermions (several blocks a rank)
    for name, (m, c), conserve, vals, B, seed in (
            ("chain12", tz.heisenberg_chain(12), "Sz", 0.0, 64, 3),
            ("honeycomb", tz.spinless_fermion_honeycomb(3, 2), "N", 4.0, 32,
             4)):
        labels = enumerate_basis(m.space, [c[conserve]], [vals], device="cpu")
        db = DeviceBasis(m.space, labels, block_rows=B, device="cpu")
        mvs = MatvecSharded(m.compiled_Ham, db, mesh)
        x = torch.as_tensor(np.random.default_rng(seed)
                            .standard_normal(labels.size))
        arrays[f"allgather_{name}"] = mvs.unpad(mvs(mvs.pad(x))).numpy()
        scalars[f"allgather_{name}_n_pad"] = mvs.n_pad

    # EllShardedHalo
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    _halo_case("chain12", m.generate_Ham_sparse_full(0), mesh, arrays,
               scalars, (False,))
    m.enumerate_basis_repr([2], [c["Sz"]], [0.0])
    _halo_case("chain12_k2", m.generate_Ham_sparse_repr(0), mesh, arrays,
               scalars, (True, False))
    m, o = tz.spinless_fermion_honeycomb(3, 2)
    m.enumerate_basis_full([o["N"]], [4.0])
    _halo_case("honeycomb", m.generate_Ham_sparse_full(0), mesh, arrays,
               scalars, (False,))
    for name, (cols, vals, diag) in (("banded", tz.banded_ell()),
                                     ("odd", tz.odd_ell())):
        ell = EllMatrix(torch.as_tensor(cols), torch.as_tensor(vals),
                        torch.as_tensor(diag))
        _halo_case(name, ell, mesh, arrays, scalars, (False,))

    # FullSpaceSharded: the label space must divide into the ranks
    for name, (m, c), conserve, vals in (
            ("chain10", tz.heisenberg_chain(10), "Sz", 0.0),
            ("honeycomb", tz.spinless_fermion_honeycomb(3, 2), "N", 4.0)):
        m.enumerate_basis_full([c[conserve]], [vals])
        s = m.sec_full[0]
        fs = FullSpaceOp(m.compiled_Ham, s.labels, device="cpu")
        try:
            fss = FullSpaceSharded(fs, mesh)
        except ValueError as e:
            scalars[f"fullspace_{name}"] = str(e)
            continue
        x = torch.as_tensor(tz.rand_vec(s.dim, fs.is_complex, 11))
        y = fss(fss.to_full(x))
        arrays[f"fullspace_{name}"] = fss.unpad(y).numpy()
        arrays[f"fullspace_{name}_sector"] = fss.to_sector(y).numpy()
        scalars[f"fullspace_{name}"] = "ok"

    # KronSharded on the Hubbard 4x2 factors (factor dim 70)
    pm, _ = tz.hubbard_factorized(4, 2)
    ell_a, ell_b = pm._factor_ells()
    sh = KronSharded(ell_a, ell_b, coupling=pm._coupling_matrix(),
                     coupling_scale=pm.coupling_scale, mesh=mesh)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(pm.dim))
    y = sh(sh.pad(x))
    arrays["kron"] = sh.unpad(y).numpy()
    arrays["kron_padded_rows"] = (sh.mesh.all_gather(y).view(sh.na, sh.nb)
                                  [sh.na_logical:].numpy())
    scalars["kron_na"] = sh.na


def suite_model(mesh, arrays, scalars, outdir):
    config.solver_log_dir = os.path.join(outdir, f"log_r{mesh.rank}")
    m, c = tz.heisenberg_chain(16)
    m.set_mesh(mesh)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    mv = m.sec_full[0]._mesh_mv[1]
    scalars["chain16_E0"] = m.eigenvals_full[0]
    scalars["chain16_engine"] = type(mv).__name__
    scalars["chain16_halo"] = mv.halo_stats()
    scalars["chain16_applies"] = mv.n_applies
    scalars["chain16_SzSz"] = m.measure_full_static(tz.sz_pair(0, 1), 0,
                                                    0).real
    arrays["chain16_vec"] = m.eigenvecs_full[0].numpy()
    config.solver_log_dir = None

    m.enumerate_basis_repr([0], [c["Sz"]], [0.0], method="dnc")
    m.locate_E0_lanczos(which="repr")
    scalars["chain16_k0_E0"] = m.eigenvals_repr[0]
    scalars["chain16_k0_dim"] = m.dim_repr()

    m, c = tz.tj_chain(10)
    m.set_mesh(mesh)
    m.enumerate_basis_full([c["Sz"], c["N"]], [0.0, 8.0])
    m.locate_E0_lanczos("full", nev=2, ncv=2)
    scalars["tj10_E01"] = m.eigenvals_full[:2]

    for mixed in (False, True):
        pm, _ = tz.hubbard_factorized(4, 2)
        pm.set_mesh(mesh)
        tag = "mixed" if mixed else "pure"
        scalars[f"hubbard_{tag}_E0"] = pm.locate_E0_lanczos(
            maxit=600, ncv=16, mixed=mixed, log=lambda *a: None)
        arrays[f"hubbard_{tag}_vec"] = pm.eigenvecs[0].numpy()

    # checkpointing on a group of several ranks is refused
    config.enable_ckpt, config.ckpt_dir = True, os.path.join(outdir, "ckpt")
    try:
        m, c = tz.heisenberg_chain(12, device="cpu")
        m.set_mesh(mesh)
        m.enumerate_basis_full([c["Sz"]], [0.0])
        m.locate_E0_lanczos()
        scalars["ckpt"] = "solved"
    except RuntimeError as e:
        scalars["ckpt"] = str(e)
    finally:
        config.enable_ckpt = False


def main():
    rank, ranks, rdv, suite, outdir = sys.argv[1:6]
    rank, ranks = int(rank), int(ranks)
    import torch.distributed as dist

    init_distributed(f"file://{rdv}", ranks, rank, device="cpu")
    try:
        mesh = basis_mesh(ranks, device="cpu")
        arrays, scalars = {}, {}
        if suite == "model":
            suite_model(mesh, arrays, scalars, outdir)
        else:
            {"sort": suite_sort, "sharded": suite_sharded}[suite](
                mesh, arrays, scalars)
        base = os.path.join(outdir, f"{suite}_r{rank}")
        np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as f:
            json.dump(scalars, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
