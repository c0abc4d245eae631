"""One rank of a gloo group for the port's multi-process tests.

Usage: torch_mp_worker.py <rank> <ranks> <rendezvous file> <suite> <out dir>

Starts this rank with ``init_distributed`` (file:// rendezvous), builds the
basis mesh on the CPU, runs every case of the suite ("sort", "sharded",
"model", "ckpt", "mesh4", "kron_ell" or "krylov", below) on the port
(quantum_basis_tpu_torch, no JAX), and writes ``<out dir>/<suite>_r<rank>.npz``
(arrays) and ``.json`` (scalars). The tests (tests/test_torch_sample_sort.py,
test_torch_sharded.py, test_torch_model_mesh.py, test_torch_mesh_ckpt.py,
test_torch_mesh4.py, test_torch_kron_ell.py, test_torch_krylov.py) hold them
against the JAX package on a P-device mesh, or against the port's
single-device engine.
Inputs are made from seeds with numpy, as the tests make them."""

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



class _Interrupting:
    """A sharded engine that raises after ``limit`` applies, on every rank
    at the same step: stands for a crash of the whole group."""

    def __init__(self, base, limit):
        self.base, self.limit, self.calls = base, limit, 0

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __call__(self, x):
        self.calls += 1
        if self.calls > self.limit:
            raise InterruptedError(f"stopped after {self.limit} applies")
        return self.base(x)


def _record_meta(store, key):
    """[fields, Vre shape, Vre dtype] of a restart record, or None."""
    rec = store.load(key)
    if rec is None:
        return None
    return [sorted(rec), list(rec["Vre"].shape), str(rec["Vre"].dtype)]


def suite_ckpt(mesh, arrays, scalars, outdir):
    """Checkpoint and resume of mesh solves (tests/test_torch_mesh_ckpt.py):
    chain-12 through Model(mesh=) interrupted after a save and resumed;
    ProductModel(mesh=) Hubbard 4x2 mixed from its records; a write that
    fails on rank 0. Rank 0 copies the restart and stage records aside for
    the JAX package to load."""
    import shutil

    import torch.distributed as dist
    from quantum_basis_tpu_torch.solvers import restarted
    from quantum_basis_tpu_torch.utils.ckpt import CkptStore

    ckdir = os.path.join(outdir, "ckpt")
    config.ckpt_dir = ckdir
    restarted._SAVE_PERIOD = 0.0  # every restart boundary saves
    store = CkptStore(ckdir)

    def aside(key, sub):
        if mesh.rank == 0:
            os.makedirs(os.path.join(outdir, sub), exist_ok=True)
            shutil.copy(store._path(key), os.path.join(outdir, sub))
        dist.barrier()

    m, c = tz.heisenberg_chain(12)
    m.set_mesh(mesh)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    sec = m.sec_full[0]
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    grp, mv, mask = sec._mesh_mv
    scalars["cold_E0"], scalars["cold_applies"] = (m.eigenvals_full[0],
                                                   mv.n_applies)
    scalars["engine"], scalars["n_pad"] = type(mv).__name__, mv.n_pad

    config.enable_ckpt = True
    key = (f"lczsE0_full_sec0_K_nev1_mesh{mesh.size}"
           f"_h{m._ham_fingerprint():08x}")
    scalars["key"] = key
    sec._mesh_mv = (grp, _Interrupting(mv, 30), mask)
    try:
        m.locate_E0_lanczos("full", nev=1, ncv=1)
        scalars["interrupted"] = False
    except InterruptedError:
        scalars["interrupted"] = True
    sec._mesh_mv = (grp, mv, mask)
    scalars["restart_record"] = _record_meta(store, key + "_krylov")
    scalars["restart_it"] = int(store.load(key + "_krylov")["it"])
    scalars["stage_after_interruption"] = store.load(key) is not None
    aside(key + "_krylov", "restart")

    n0 = mv.n_applies
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    scalars["resumed_E0"] = m.eigenvals_full[0]
    scalars["resumed_applies"] = mv.n_applies - n0
    scalars["restart_after_resume"] = store.load(key + "_krylov") is not None
    scalars["stage_after_resume"] = store.load(key) is not None
    arrays["resumed_vec"] = m.eigenvecs_full[0].numpy()
    aside(key, "stage")
    n0 = mv.n_applies
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    scalars["again_applies"] = mv.n_applies - n0
    scalars["again_E0"] = m.eigenvals_full[0]

    # ProductModel(mesh=), mixed: the f32 stage's result record, the RQI
    # polish's records and the stage record, all of whole vectors
    pm, _ = tz.hubbard_factorized(4, 2)
    pm.set_mesh(mesh)
    scalars["prod_E0"] = pm.locate_E0_lanczos(mixed=True,
                                              log=lambda *a: None)
    arrays["prod_vec"] = pm.eigenvecs[0].numpy()
    ops = (pm.op(torch.float32), pm.op(torch.float64))
    n0 = [op.n_applies for op in ops]
    scalars["prod_again_E0"] = pm.locate_E0_lanczos(mixed=True,
                                                    log=lambda *a: None)
    scalars["prod_again_applies"] = [op.n_applies - a
                                     for op, a in zip(ops, n0)]
    pkey = (f"prodE0_{pm.na}x{pm.nb}_nev1_h{pm._fingerprint():08x}"
            f"_mesh{mesh.size}")
    scalars["prod_key"] = pkey
    scalars["prod_f32res"] = list(store.load(pkey + "_f32res")["re"].shape)
    if mesh.rank == 0:
        store.delete(pkey)
    dist.barrier()
    scalars["prod_warm_E0"] = pm.locate_E0_lanczos(mixed=True,
                                                   log=lambda *a: None)
    scalars["prod_warm_f32_stage"] = pm.solve_info["f32_stage_matvecs"]
    config.enable_ckpt = False

    # out of device memory in the f32 stage: on a group the solve raises
    # (no rank falls back alone)
    from quantum_basis_tpu_torch.models.model import Model

    def oom(*a, **k):
        raise torch.OutOfMemoryError("stands for a full device")

    stage, Model._f32_stage_cached = Model._f32_stage_cached, oom
    try:
        pm.locate_E0_lanczos(mixed=True, log=lambda *a: None)
        scalars["prod_oom"] = "fell back"
    except torch.OutOfMemoryError:
        scalars["prod_oom"] = "raised"
    finally:
        Model._f32_stage_cached = stage

    # a write or delete that fails on rank 0 raises on every rank (rank 0
    # its own error), none waits in a collective
    from quantum_basis_tpu_torch.solvers.reduce import GroupStore

    class Full(CkptStore):
        def save(self, key, payload):
            raise OSError(28, "No space left on device")

        def delete(self, key):
            raise OSError(28, "No space left on device")

    full = GroupStore(Full(ckdir), mesh)
    for what, act in (("save", lambda: full.save("k", {"a": np.zeros(2)})),
                      ("delete", lambda: full.delete("k"))):
        try:
            act()
            scalars[f"failed_{what}"] = "returned"
        except Exception as e:
            scalars[f"failed_{what}"] = type(e).__name__


def suite_mesh4(mesh, arrays, scalars, outdir):
    """The engines, the sort and Model(mesh=) chain-16 on one group
    (tests/test_torch_mesh4.py, 4 ranks)."""
    suite_sharded(mesh, arrays, scalars)
    parts = {name: np.array_split(vals, mesh.size)[mesh.rank]
             for name, vals in tz.sort_inputs().items()}
    for name in ("random_40000", "duplicates", "overflow"):
        arrays[f"sort_{name}"] = sample_sort(parts[name], mesh)
    m, c = tz.heisenberg_chain(16)
    m.set_mesh(mesh)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    m.locate_E0_lanczos("full", nev=1, ncv=1)
    mv = m.sec_full[0]._mesh_mv[1]
    scalars["chain16_E0"] = m.eigenvals_full[0]
    scalars["chain16_engine"] = type(mv).__name__
    scalars["chain16_halo"] = mv.halo_stats()
    scalars["chain16_applies"] = mv.n_applies


# (Lx, Ly, N_up, N_dn) of the kron_ell suite's sectors: Hubbard 4x2 at half
# filling (70 rows, one shared factor) and the 3x2 (2, 3) sector (15 rows:
# padded to 16 on two ranks; two factors)
KRON_ELL_CASES = {"4x2": (4, 2, 4, 4), "3x2_2_3": (3, 2, 2, 3)}


def suite_kron_ell(mesh, arrays, scalars):
    """KronSharded in both layouts on the sectors of KRON_ELL_CASES
    (tests/test_torch_kron_ell.py holds them against KronOp)."""
    for name, (lx, ly, nup, ndn) in KRON_ELL_CASES.items():
        pm, _ = tz.hubbard_factorized(lx, ly, Nup=nup, Ndn=ndn)
        ell_a, ell_b = pm._factor_ells()
        x = np.random.default_rng(9).standard_normal(pm.dim)
        for layout in ("ell", "dense"):
            for dt in (torch.float64, torch.float32):
                sh = KronSharded(ell_a, ell_b, coupling=pm._coupling_matrix(),
                                 coupling_scale=pm.coupling_scale, mesh=mesh,
                                 dtype=dt, layout=layout)
                y = sh(sh.pad(torch.as_tensor(x, dtype=dt)))
                tag = f"{name}_{layout}_{str(dt)[6:]}"
                arrays[tag] = sh.unpad(y).double().numpy()
                arrays[tag + "_padded_rows"] = (
                    sh.mesh.all_gather(y).view(sh.na, sh.nb)
                    [sh.na_logical:].double().numpy())
                scalars[tag + "_layout"] = sh.layout
                scalars[tag + "_na"] = sh.na


# the krylov suite's basis: ncv vectors (rows ncv + 1), the row and step
# of its restart vector, and the vectors a compaction keeps
KRYLOV_NCV = 8
KRYLOV_INSERT = 4
KRYLOV_KEEP = 3


def krylov_ells():
    """(name, the port's ELL, complex) of the krylov suite: chain-12 Sz=0
    (real, dim 924) and its k=2 momentum sector (complex)."""
    m, c = tz.heisenberg_chain(12)
    m.enumerate_basis_full([c["Sz"]], [0.0])
    yield "chain12", m.generate_Ham_sparse_full(0), False
    m.enumerate_basis_repr([2], [c["Sz"]], [0.0])
    yield "chain12_k2", m.generate_Ham_sparse_repr(0), True


def krylov_sequence(op, n_logical, complex_vec, mesh=None):
    """One basis of solvers/restarted.py::_Krylov on ``op`` (a sharded
    engine with ``mesh``): a random start row, ``expand(0, KRYLOV_NCV)``, a
    random restart vector through ``insert_random`` after row
    KRYLOV_INSERT, then a compaction by a fixed orthonormal S. Returns the
    whole basis after each of the three (rows, n_logical), the projection
    columns and betas, and the restart vector's norm."""
    from quantum_basis_tpu_torch.solvers.restarted import _Krylov

    n = getattr(op, "n_pad", n_logical)
    lo, hi = getattr(op, "span", None) or (0, n)
    kry = _Krylov(op, n, KRYLOV_NCV, complex_vec)

    def rand_row(seed):
        x = np.zeros(n, dtype=np.complex128 if complex_vec else np.float64)
        x[:n_logical] = tz.rand_vec(n_logical, complex_vec, seed)
        x /= np.linalg.norm(x)
        return torch.as_tensor(x[lo:hi]).to(kry.dtype)

    def whole(V):
        if mesh is not None:
            V = mesh.all_gather(V.T.contiguous()).T
        return V[:, :n_logical].numpy().copy()

    out = {}
    kry.V[0] = rand_row(21)
    out["H"], out["b"] = kry.expand(0, KRYLOV_NCV)
    out["V_expand"] = whole(kry.V)
    out["b_insert"] = kry.insert_random(rand_row(22), KRYLOV_INSERT,
                                        KRYLOV_INSERT + 1)
    out["V_insert"] = whole(kry.V)
    q, _ = np.linalg.qr(np.random.default_rng(23).standard_normal(
        (KRYLOV_NCV, KRYLOV_KEEP)))
    S = np.zeros((KRYLOV_NCV + 1, KRYLOV_KEEP))
    S[:KRYLOV_NCV] = q
    kry.compact(S.astype(np.complex128) if complex_vec else S, KRYLOV_NCV)
    out["V_compact"] = whole(kry.V)
    return out


def suite_krylov(mesh, arrays, scalars):
    """krylov_sequence on EllShardedHalo engines of krylov_ells()
    (tests/test_torch_krylov.py holds them against one device)."""
    for name, ell, cv in krylov_ells():
        out = krylov_sequence(EllShardedHalo(ell, mesh), ell.n, cv, mesh)
        scalars[f"{name}_b_insert"] = out.pop("b_insert")
        for key, a in out.items():
            arrays[f"{name}_{key}"] = a


SUITES = {"sort": lambda mesh, a, s, out: suite_sort(mesh, a, s),
          "krylov": lambda mesh, a, s, out: suite_krylov(mesh, a, s),
          "kron_ell": lambda mesh, a, s, out: suite_kron_ell(mesh, a, s),
          "sharded": lambda mesh, a, s, out: suite_sharded(mesh, a, s),
          "model": suite_model, "ckpt": suite_ckpt, "mesh4": suite_mesh4}


def main():
    rank, ranks, rdv, suite, outdir = sys.argv[1:6]
    rank, ranks = int(rank), int(ranks)
    import torch.distributed as dist

    init_distributed(f"file://{rdv}", ranks, rank, device="cpu")
    try:
        mesh = basis_mesh(ranks, device="cpu")
        arrays, scalars = {}, {}
        SUITES[suite](mesh, arrays, scalars, outdir)
        base = os.path.join(outdir, f"{suite}_r{rank}")
        np.savez(base + ".npz", **arrays)
        with open(base + ".json", "w") as f:
            json.dump(scalars, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
