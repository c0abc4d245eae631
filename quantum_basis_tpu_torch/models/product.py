"""ProductModel: public API for tensor-factorized sectors.

Port of ``quantum_basis_tpu.models.product``. The model-object entry point
(the reference's single-entry philosophy, src/model.cc:74-177) for
Hamiltonians that factorize over a tensor product of two conserved
subsectors:

    H = H_a (x) I_b + I_a (x) H_b + scale * sum_m D_a,m (x) D_b,m

Each factor is an ordinary :class:`~quantum_basis_tpu_torch.models.model.Model`
with its full sector enumerated (both on one device, which is the product
model's); the coupling is a list of pairs of diagonal operators.
``locate_E0_lanczos`` runs the mixed-precision pipeline: f32 thick-restart
bulk on the float32 :class:`KronOp`, f64 Jacobi-Davidson/RQI polish on its
float64 twin, under the hard residual gate; at or below the device's
``product_mixed_above`` states it runs pure f64 thick restart. Both engines
take the device's layout (dense factors, or the fused ELL kernel above the
routing entry ``kron_dense_max_dim``).

Flagship use: Fermi-Hubbard 4x4 at half filling (species-major JW ordering;
sector dim C(16,8)^2 = 165,636,900), cross-checked against the reference's
4x2 golden value.

With ``config.enable_ckpt`` the finished solve is kept as a stage record
whose key carries both factors' Hamiltonian fingerprints and the coupling's
bytes, and each stage's solver keeps its restart state (utils/ckpt.py).

With a basis mesh (``mesh=`` or :meth:`ProductModel.set_mesh`) both routes
run on the row-sharded :class:`~quantum_basis_tpu_torch.parallel.
kron_sharded.KronSharded` (zero-row padding where the first factor's dim
does not divide into the ranks), with every reduction summed over the
ranks; the published eigenvectors are whole logical vectors on every rank,
and the records hold whole vectors (rank 0 writes them, solvers/reduce.py).
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.models.model import Model, checked_mesh
from quantum_basis_tpu_torch.ops.apply import MatvecFull
from quantum_basis_tpu_torch.ops.apply_kron import (
    KronOp,
    _compact_coupling,
    _ell_to_dense,
    diagonal_product_coupling,
)
from quantum_basis_tpu_torch.ops.sparse import build_sparse_full
from quantum_basis_tpu_torch.parallel.kron_sharded import KronSharded
from quantum_basis_tpu_torch.solvers.lanczos import lanczos_ground
from quantum_basis_tpu_torch.solvers.reduce import GroupStore, mesh_of, norm
from quantum_basis_tpu_torch.solvers.restarted import _solver_log, eigs_smallest
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish
from quantum_basis_tpu_torch.utils import ckpt
from quantum_basis_tpu_torch.utils.rng import vec_randomize


class ProductModel:
    """Two-factor product-sector model; see module docstring."""

    def __init__(self, model_a, model_b=None, coupling=(),
                 coupling_scale: float = 1.0, sec: int = 0,
                 hermiticity="exact", mesh=None):
        self.mesh = checked_mesh(mesh)  # solves route to KronSharded
        self.model_a = model_a
        self.model_b = model_b  # None => same factor twice (Hubbard)
        self.device = model_a.device
        self.coupling = list(coupling)
        self.coupling_scale = float(coupling_scale)
        self._sec = sec
        self._check = hermiticity
        self._ops: dict = {}
        self._P = None
        self._Pc = None
        self._ells = None
        self.eigenvals: list[float] = []
        self.eigenvecs: list = []
        self.solve_info: dict = {}
        self._last_residual = None
        sa = model_a.sec_full[sec]
        sb = (model_b.sec_full[sec] if model_b is not None else sa)
        self.na, self.nb = sa.dim, sb.dim
        self.dim = self.na * self.nb

    # ------------------------------------------------------------- build
    def _factor_ell(self, model):
        s = model.sec_full[self._sec]
        mv = s.matvec if isinstance(s.matvec, MatvecFull) else s.matvec_free
        ell = build_sparse_full(mv)
        Model._check_hermiticity(ell, s.dim, mv.is_complex, self._check)
        return ell

    def _factor_ells(self):
        if self._ells is None:
            self._ells = (self._factor_ell(self.model_a),
                          None if self.model_b is None
                          else self._factor_ell(self.model_b))
        return self._ells

    def _coupling_matrix(self):
        if self._P is None and self.coupling:
            ma, mb = self.model_a, (self.model_b or self.model_a)
            self._P = diagonal_product_coupling(
                ma.space, ma.sec_full[self._sec].labels, mb.space,
                mb.sec_full[self._sec].labels, self.coupling)
        return self._P

    def _coupling_stored(self):
        """The coupling as the engines store it (int8 or float32,
        ops/apply_kron._compact_coupling), compacted once for every engine."""
        if self._Pc is None and self.coupling:
            self._Pc = _compact_coupling(self._coupling_matrix())
        return self._Pc

    def op(self, dtype=None, layout=None):
        """The device engine at a given precision and layout (cached per
        ``(dtype, layout, mesh)``, the JAX package's key). ``layout``:
        ``"dense"``, ``"ell"`` or None, the device's routing entry
        ``kron_dense_max_dim`` (ops/apply_kron.py).

        With a mesh attached this is the row-sharded
        :class:`~quantum_basis_tpu_torch.parallel.kron_sharded.KronSharded`
        (same protocol; ``N`` and ``mask`` count the mesh-padded space)."""
        dtype = dtype or torch.float64
        key = (dtype, layout, self.mesh is not None)
        if key not in self._ops:
            ell_a, ell_b = self._factor_ells()
            if self.mesh is not None:
                self._ops[key] = KronSharded(
                    ell_a, ell_b, coupling=self._coupling_stored(),
                    coupling_scale=self.coupling_scale, mesh=self.mesh,
                    dtype=dtype, layout=layout)
            else:
                self._ops[key] = KronOp(
                    ell_a, ell_b, coupling=self._coupling_stored(),
                    coupling_scale=self.coupling_scale, dtype=dtype,
                    layout=layout)
        return self._ops[key]

    def set_mesh(self, mesh):
        """Attach, replace or (None) drop the basis mesh; the sharded engines
        rebuild on the next solve (mirrors Model.set_mesh)."""
        self.mesh = checked_mesh(mesh)
        self._ops = {k: v for k, v in self._ops.items() if not k[2]}

    def _fingerprint(self) -> int:
        """Content CRC of the product Hamiltonian: both factors' and the
        whole coupling matrix (a prefix would alias couplings that differ
        only on higher-index factor states)."""
        fp = self.model_a._ham_fingerprint()
        if self.model_b is not None:
            fp = zlib.crc32(self.model_b._ham_fingerprint()
                            .to_bytes(4, "little"), fp)
        P = self._coupling_matrix()
        if P is not None:
            fp = zlib.crc32(np.float64(self.coupling_scale).tobytes(), fp)
            fp = zlib.crc32(memoryview(np.ascontiguousarray(P)).cast("B"),
                            fp)
        return fp & 0xFFFFFFFF

    # ------------------------------------------------------------- solve
    def locate_E0_lanczos(self, nev: int = 1, maxit: int = 4000,
                          ncv: int | None = None, seed: int = 1,
                          mixed: bool | None = None, log=print):
        """Ground state via the mixed-precision pipeline with a hard
        residual gate (cf. model::locate_E0_lanczos, src/model.cc:1123-1316).

        ``mixed=None`` auto-selects: mixed precision above the device's
        ``product_mixed_above`` states (config.mixed_precision also forces
        it), pure f64 thick restart below; ``ncv=None`` takes the device's
        ``product_ncv`` (both ``config.MEMORY``). Results land in
        ``eigenvals``/``eigenvecs`` and the f64 residual of the first in
        ``_last_residual``; ``solve_info`` holds the stage times and counts
        of a mixed solve.
        """
        # factor dims spelled out: transposed sectors like Hubbard (9,8) vs
        # (8,7) share dim = na*nb and the same Hamiltonian terms; only the
        # factor split (and the coupling bytes) tells them apart
        key = (f"prodE0_{self.na}x{self.nb}_nev{nev}"
               f"_h{self._fingerprint():08x}")
        if self.mesh is not None:
            key += f"_mesh{self.mesh.size}"
        done = self._stage_load(key)
        if done is not None:
            self.eigenvals, self.eigenvecs, self._last_residual = done
            return self.eigenvals[0]
        if ncv is None:
            ncv = config.memory("product_ncv", self.device)
        if mixed is None:
            mixed = (config.mixed_precision or self.dim
                     > config.memory("product_mixed_above", self.device))
        if not mixed:
            fs = self.op(torch.float64)
            evals, vecs = eigs_smallest(
                fs, fs.N, nev=nev, ncv=max(ncv, 2 * nev + 4), maxit=maxit,
                seed=seed, complex_vec=False, mask=fs.mask,
                ckpt_key=key + "_krylov")
            self._last_residual = float(norm(fs(vecs[0]) - evals[0] * vecs[0],
                                             mesh_of(fs)))
            self._publish(key, evals, [self._unpad(fs, v) for v in vecs],
                          resid=self._last_residual)
            return self.eigenvals[0]

        # stage 1: f32 bulk on the float32 engine
        fs32 = self.op(torch.float32)
        n32 = fs32.n_applies
        oom = False
        t32 = time.time()
        try:
            v0 = Model._f32_stage_cached(fs32, nev, ncv, maxit, seed, False,
                                         key)
        except torch.OutOfMemoryError:
            if self.mesh is not None and self.mesh.size > 1:
                # a rank that fell back alone would leave the others
                # waiting in a collective: the group fails instead
                raise
            # the (ncv+1, N) thick-restart buffer overflowed the device; the
            # rolling 2-vector kernel needs ~5 vectors in all. tol=1e-8 makes
            # its residual gate match the thick path's f32 gate
            # (1e3 * tol * |E0|).
            oom = True
            log("f32 thick-restart out of device memory; falling back to "
                "rolling 2-vector Lanczos")
            re, _ = vec_randomize(self.dim, seed=seed)
            v32 = (fs32.pad(re) if self.mesh is not None
                   else torch.as_tensor(re, device=self.device))
            v32 = v32.to(torch.float32)
            v0 = lanczos_ground(fs32, v32, maxit=maxit, inner=48, tol=1e-8,
                                ckpt_key=key + "_f32roll")["vector"]
        if fs32.device.type == "cuda":
            torch.cuda.synchronize(fs32.device)
        t32 = time.time() - t32
        if v0 is None:
            raise RuntimeError("f32 bulk stage failed to produce a vector")
        n32 = fs32.n_applies - n32
        # stage 2: f64 RQI/JD polish on the float64 engine
        fs64 = self.op(torch.float64)
        n64 = fs64.n_applies
        v0 = v0.to(torch.float64)
        v0 = v0 / norm(v0, mesh_of(fs64))
        tp = time.time()
        out = rqi_polish(fs64, v0, fs32=fs32, ckpt_key=key + "_rqi",
                         log=lambda i, th, rn, ni: _solver_log(
                             "rqi_product", i, [th], [rn]))
        self.solve_info = {
            "f32_stage_s": round(t32, 1),
            "f32_stage_matvecs": n32,
            "f32_stage_oom_fallback": oom,
            "rqi_outer": out.get("n_outer"),
            "rqi_inner_f32_matvecs": out.get("n_inner"),
            "rqi_converged": out.get("converged"),
        }
        if not out["converged"]:
            v0 = out["vector"] / norm(out["vector"], mesh_of(fs64))
            out = lanczos_ground(fs64, v0, maxit=maxit, inner=60,
                                 ckpt_key=key + "_polish")
        if fs64.device.type == "cuda":
            torch.cuda.synchronize(fs64.device)
        self.solve_info["polish_s"] = round(time.time() - tp, 1)
        self.solve_info["f64_matvecs"] = fs64.n_applies - n64
        r_gate = max(1e3 * config.lanczos_precision
                     * max(abs(out["E0"]), 1.0), 5e-10)
        if out["residual"] >= r_gate:
            err = RuntimeError(
                f"product-sector polish unconverged: E0={out['E0']:.12f}, "
                f"residual {out['residual']:.3e} >= gate {r_gate:.3e} "
                f"(checkpoint retained; re-run to resume)")
            err.E0 = out["E0"]
            err.residual = out["residual"]
            raise err
        self._publish(key, [out["E0"]], [self._unpad(fs64, out["vector"])],
                      resid=out["residual"])
        self._last_residual = out["residual"]
        return self.eigenvals[0]

    def _unpad(self, fs, v):
        """A solver vector as the whole logical vector on this model's
        device (the mesh padding stripped; as it is without a mesh)."""
        if self.mesh is None:
            return v
        return fs.unpad(v).to(self.device)

    def _publish(self, key, evals, vecs, resid=None):
        self.eigenvals = [float(e) for e in evals]
        self.eigenvecs = list(vecs)
        self._stage_save(key, evals, vecs, resid)

    # ------------------------------------------------- stage checkpointing
    def _stage_load(self, key):
        store = ckpt.active_store()
        rec = (GroupStore(store, self.mesh).load(key) if store is not None
               else None)
        if rec is None:
            return None
        evals = [float(x) for x in rec["evals"]]
        vecs = [ckpt.join_vec(rec[f"v{i}_re"], None, False, self.device)
                for i in range(int(rec["nev"]))]
        resid = float(rec["resid"]) if "resid" in rec else None
        return evals, vecs, resid

    def _stage_save(self, key, evals, vecs, resid=None):
        store = ckpt.active_store()
        if store is None:
            return
        payload = {"nev": len(vecs), "evals": np.asarray(evals)}
        if resid is not None:
            payload["resid"] = float(resid)
        if sum(v.numel() * v.element_size() for v in vecs) \
                > config.memory("ckpt_max_bytes", self.device):
            return
        for i, v in enumerate(vecs):
            payload[f"v{i}_re"] = ckpt.split_vec(v, False)[0]
        GroupStore(store, self.mesh).save(key, payload)

    # ------------------------------------------------------- measurements
    def _factor_dense(self, model, op):
        """(diagonal (n,), dense off-diagonal (n, n) or None) of a
        factor-local Hermitian operator over the factor's sector."""
        s = model.sec_full[self._sec]
        mv = MatvecFull(model.compile_op(op), s.dbasis)
        if mv.is_complex:
            raise NotImplementedError(
                "measure_product_static takes real factor operators")
        diag = mv.diag_b.reshape(-1)[: s.dim]
        if not mv.groups:
            return diag, None
        return diag, _ell_to_dense(build_sparse_full(mv), torch.float64)

    def measure_product_static(self, op_a=None, op_b=None, which: int = 0):
        """<phi| O_a (x) O_b |phi> for factor-local Hermitian operators
        (either may be None = identity).

        The JAX package maps its matrix-free factor apply over the columns
        (rows) of the reshaped eigenvector. Here O_a acts on all columns at
        once: its diagonal scales the rows of phi, and its off-diagonal part,
        when it has one, is densified over the factor sector (n_a x n_a, as
        KronOp stores the factor Hamiltonian) and applied as one matmul;
        O_b likewise from the right."""
        phi = self.eigenvecs[which].to(torch.float64).view(self.na, self.nb)
        w = phi
        if op_a is not None:
            diag, dense = self._factor_dense(self.model_a, op_a)
            w = diag[:, None] * w + (dense @ w if dense is not None else 0.0)
        if op_b is not None:
            diag, dense = self._factor_dense(self.model_b or self.model_a,
                                             op_b)
            w = w * diag[None, :] + (w @ dense.T if dense is not None
                                     else 0.0)
        return float((phi * w).sum())
