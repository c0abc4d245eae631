"""Model orchestration: orbitals + Hamiltonian -> bases, E0, <O>.

Port of the ground-state and static-measurement routes of
``quantum_basis_tpu.models.model.Model`` (the reference's ``model<T>``,
src/model.cc), with the same user-facing flow:

    m = Model(lattice, device="cuda")
    m.add_orbital(lattice.n_sites, "spin-1/2")
    m.add_Ham(...)                               # symbolic Mopr algebra
    m.enumerate_basis_full([Sz], [0.0])
    m.locate_E0_lanczos()                        # -> m.eigenvals_full
    m.measure_full_static(Sz0 * Sz1, 0, 0)
    m.enumerate_basis_repr([0], [Sz], [0.0])     # momentum sector k = 0
    m.locate_E0_lanczos(which="repr")            # -> m.eigenvals_repr
    m.measure_repr_static(Sz0 * Sz1, 0)

Sectors are kept per integer index ``sec``. Every device object lives on
``device``; nothing moves to another device when that one is missing. A
sector at or below ``_DENSE_CUTOFF`` rows is solved densely on the host.

A larger full sector whose label space is at most 64 times its dimension is
solved over the FULL label space (``_fullspace_op``): on the
window-contraction engine (ops/apply_contract.py) in float64, or, under
``config.mixed_precision``, with the Krylov bulk on its float32 twin and a
float64 polish (Rayleigh-quotient iteration above ``_POLISH_N`` labels) under
a hard residual gate; the masked-roll engine (ops/apply_fullspace.py) is the
float64 fallback for operators the contraction engine cannot take. Other
full sectors, and every sector after ``generate_Ham_sparse_full``, run
thick-restart Lanczos in float64 on the sector's own ``matvec``: the
matrix-free :class:`MatvecFull` or the explicit ELL. A larger momentum
sector takes the explicit-sparse route: the f32 bulk Krylov stage on the BSR
kernel (ops/bsr.py) with an f64 Rayleigh-quotient polish on the ELL matrix
when ``_repr_bsr32`` routes the sector there, else thick-restart Lanczos on
the f64 ELL.

Not ported yet, each raising ``NotImplementedError``: the projected
full-label-space momentum engines (``_fullspace_repr_op``), a device mesh,
checkpoint stages, interior windows (``locate_Es``), dynamics and the
variational sector.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis
from quantum_basis_tpu_torch.basis.site_basis import SiteBasis
from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
)
from quantum_basis_tpu_torch.ops.apply import (
    DeviceBasis,
    MatvecFull,
    mopr_x_vec,
)
from quantum_basis_tpu_torch.ops.apply_contract import (
    ContractOp,
    supports_contract,
)
from quantum_basis_tpu_torch.ops.apply_fullspace import (
    FullSpaceOp,
    supports_fullspace,
)
from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr, ReprBasis
from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats, ell_to_bsr
from quantum_basis_tpu_torch.ops.compile import compile_operator
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.ops.operators import Mopr, Opr, OprProd
from quantum_basis_tpu_torch.ops.sparse import (
    build_sparse_full,
    build_sparse_repr,
    hermiticity_exact,
    hermiticity_probe,
)
from quantum_basis_tpu_torch.solvers.lanczos import lanczos_ground
from quantum_basis_tpu_torch.solvers.restarted import _masked, eigs_smallest
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish

_DENSE_CUTOFF = 600  # sectors at/below this size are solved densely on host
# Above this full-space N a warm-started f64 stage is the RQI polish (or the
# 2-vector Lanczos) instead of a thick restart. The JAX package's value, sized
# there for a 16 GB TPU; kept so that both packages take the same branch, and
# not re-measured on the GPU.
_POLISH_N = 1 << 22


def _not_ported(what: str, slice_name: str):
    return NotImplementedError(f"{what} is not ported yet ({slice_name})")


class Sector:
    """One quantum-number (and optionally momentum) sector: basis, matvec,
    eigenpairs."""

    def __init__(self):
        self.labels: np.ndarray | None = None
        self.dbasis: DeviceBasis | None = None
        self.matvec = None
        self.matvec_free = None  # the matrix-free apply once matvec is an ELL
        self.dim = 0
        self.momentum = None
        self.evals: list = []
        self.evecs: list = []
        self.ell = None       # explicit f64 ELL, built on first solve
        self.bsr32 = None     # f32 BsrMatrix when routed to the kernel
        self._routed = False  # _repr_bsr32 has decided
        self.spmv = None      # f64 engine of the pure-Krylov route
        self._fs_cache = {}   # dtype -> full-label-space engine or None


class Model:
    def __init__(self, lattice=None, device="cuda", mesh=None):
        """``device``: where every basis table, matrix and vector lives."""
        if mesh is not None:
            raise _not_ported("Model(mesh=)", "the multi-GPU slice")
        self.lattice = lattice
        self.device = torch.device(device)
        self._orbitals: list[tuple[SiteBasis, int]] = []
        self._space: StateSpace | None = None
        self.Ham = Mopr()
        self._compiled = None
        self.sec_full: dict[int, Sector] = {}
        self.sec_repr: dict[int, Sector] = {}
        self.eigenvals_full: list[float] = []
        self.eigenvecs_full: list = []  # 1-d tensors over the sector basis
        self.eigenvals_repr: list[float] = []
        self.eigenvecs_repr: list = []
        self._e0_sec = 0  # sector of the stored ground state
        self._tset = None
        self._repr_cache = None  # (key, sector labels, orbit reps)

    # ------------------------------------------------------------- building

    def add_orbital(self, n_sites: int, name, Nmax: int | None = None):
        """Declare one orbital covering ``n_sites`` sites (cf. model::add_orbital)."""
        if self._space is not None:
            raise RuntimeError("cannot add orbitals after the Hilbert space is built")
        sb = name if isinstance(name, SiteBasis) else SiteBasis.named(name, Nmax=Nmax)
        self._orbitals.append((sb, int(n_sites)))

    @property
    def space(self) -> StateSpace:
        if self._space is None:
            self._space = StateSpace(self._orbitals)
        return self._space

    def add_Ham(self, op):
        """Accumulate a term into H (accepts Opr / OprProd / Mopr)."""
        self.Ham += self._coerce_mopr(op)
        self._compiled = None

    @property
    def compiled_Ham(self):
        if self._compiled is None:
            self._compiled = compile_operator(self.Ham, self.space)
        return self._compiled

    @staticmethod
    def _coerce_mopr(op):
        if isinstance(op, Opr):
            return Mopr([OprProd(1.0, [op])])
        if isinstance(op, OprProd):
            return Mopr([op])
        return op

    def compile_op(self, op):
        return compile_operator(self._coerce_mopr(op), self.space)

    # ----------------------------------------------------------- full basis

    def enumerate_basis_full(self, conserve_lst=None, val_lst=None,
                             sec: int = 0):
        """Enumerate the (sector-filtered) full basis; build device residency.

        cf. model::enumerate_basis_full (src/model.cc:253-271).
        """
        return self._set_full_sector(
            enumerate_basis(self.space, conserve_lst, val_lst,
                            device=self.device), sec)

    def _set_full_sector(self, labels: np.ndarray, sec: int = 0) -> int:
        """Device residency and matrix-free apply for sorted sector labels."""
        s = Sector()
        s.labels = labels
        s.dim = int(labels.size)
        s.dbasis = DeviceBasis(
            self.space, labels,
            work_per_row=max(self.compiled_Ham.nnz_per_row, 1),
            device=self.device)
        s.matvec = MatvecFull(self.compiled_Ham, s.dbasis)
        self.sec_full[sec] = s
        return s.dim

    def dim_full(self, sec: int = 0) -> int:
        return self.sec_full[sec].dim

    # --------------------------------------------------- explicit sparse path

    @staticmethod
    def _check_hermiticity(ell, n, complex_vec, check):
        """check in {False, True/"probe", "exact"}: probe = randomized
        O(SpMV) test; "exact" = the reference's full O(nnz) verification
        (src/sparse.cc:235-256)."""
        if not check:
            return
        if check == "exact":
            hermiticity_exact(ell)
        else:
            hermiticity_probe(ell, n, complex_vec)

    def generate_Ham_sparse_full(self, sec: int = 0, check=True):
        """Extract the explicit ELL matrix for a full sector and switch the
        sector's matvec to it (cf. generate_Ham_sparse_full,
        src/model.cc:619-685 — like the reference, the explicit matrix is an
        optional speedup over the matrix-free apply). ``check``: False,
        "probe" (randomized, default) or "exact" (O(nnz) verification)."""
        s = self.sec_full[sec]
        if not isinstance(s.matvec, MatvecFull):
            s.matvec = s.matvec_free or MatvecFull(self.compiled_Ham, s.dbasis)
        ell = build_sparse_full(s.matvec)
        self._check_hermiticity(ell, s.dim, ell.is_complex, check)
        s.matvec_free = s.matvec  # keep the matrix-free path accessible
        s.matvec = ell
        return ell

    def generate_Ham_sparse_repr(self, sec: int = 0, check=True):
        """Explicit ELL matrix in a momentum sector (cf.
        generate_Ham_sparse_repr, src/model.cc:687-836). ``check`` as in
        :meth:`generate_Ham_sparse_full`."""
        s = self.sec_repr[sec]
        ell = self._repr_ell(s)
        self._check_hermiticity(ell, s.dim, True, check)
        if isinstance(s.matvec, MatvecRepr):
            s.matvec_free = s.matvec
        s.matvec = ell
        return ell

    # ------------------------------------------------------ momentum sectors

    @property
    def tset(self) -> TranslationSet:
        """TranslationSet over the pbc dimensions of the lattice."""
        if self._tset is None:
            self._tset = TranslationSet(self.space, self.lattice, self.device)
        return self._tset

    def enumerate_basis_repr(self, momentum, conserve_lst=None, val_lst=None,
                             sec: int = 0, method: str = "direct"):
        """Momentum-sector basis of representatives; build device residency.

        cf. model::enumerate_basis_repr (src/model.cc:274-487). Only
        ``method="direct"`` (orbit classification over the materialized
        quantum-number sector) is ported.
        """
        if method != "direct":
            raise NotImplementedError(f"enumeration method {method!r} is not ported")

        def mopr_key(m):
            return tuple(sorted(
                ((complex(np.round(t.coeff, 12)), t._key()) for t in m.terms),
                key=repr))

        key = (tuple(mopr_key(m) for m in (conserve_lst or [])),
               tuple(float(v) for v in (val_lst or [])))
        if self._repr_cache is None or self._repr_cache[0] != key:
            labels = enumerate_basis(self.space, conserve_lst, val_lst,
                                     device=self.device)
            self._repr_cache = (key, labels, enumerate_reps(self.tset, labels))
        _, labels, reps = self._repr_cache

        s = Sector()
        rbasis = ReprBasis(self.space, self.tset, labels, momentum,
                           reps_all=reps,
                           work_per_row=max(self.compiled_Ham.nnz_per_row, 1))
        s.labels = rbasis.labels_np
        s.dim = rbasis.n
        s.dbasis = rbasis
        s.matvec = MatvecRepr(self.compiled_Ham, rbasis)
        s.momentum = rbasis.momentum
        self.sec_repr[sec] = s
        return s.dim

    def dim_repr(self, sec: int = 0) -> int:
        return self.sec_repr[sec].dim

    # -------------------------------------------------------------- solvers

    def _dense_solve(self, sector: Sector, nev: int, complex_h: bool):
        H = dense_matrix(self.compiled_Ham, sector.labels)
        assert np.max(np.abs(H - H.conj().T)) < 1e-9, "H not Hermitian"
        evals, evecs = np.linalg.eigh(H)
        vecs = []
        for k in range(min(nev, sector.dim)):
            v = evecs[:, k]
            vecs.append(torch.as_tensor(
                v.copy() if complex_h else v.real.copy(), device=self.device))
        return evals[:nev].tolist(), vecs

    @staticmethod
    def _check_which(which: str):
        if which == "vrnl":
            raise _not_ported("the variational sector", "the vrnl slice")
        if which not in ("full", "repr"):
            raise ValueError(f"which must be 'full' or 'repr', not {which!r}")
        if config.enable_ckpt:
            raise _not_ported("checkpointing", "the checkpointing slice")

    def _store(self, which, sector, evals, vecs, n_vals=None, n_vecs=None):
        """Keep a solve's eigenpairs on the sector and on the model."""
        sector.evals, sector.evecs = list(evals), list(vecs)
        evals, vecs = list(evals[:n_vals]), list(vecs[:n_vecs])
        if which == "full":
            self.eigenvals_full, self.eigenvecs_full = evals, vecs
        else:
            self.eigenvals_repr, self.eigenvecs_repr = evals, vecs

    def locate_E0_lanczos(self, which: str = "full", nev: int = 1,
                          ncv: int = 1, maxit: int = 2000, sec: int = 0,
                          seed: int = 1):
        """Ground state (and optionally E1) via restarted Lanczos.

        cf. model::locate_E0_lanczos (src/model.cc:1123-1316). The engine is
        the fully-reorthogonalized thick-restart solver: unlike the
        reference's 2-vector recurrence + CG refinement pipeline it delivers
        both values and vectors to solver tolerance without a separate
        refinement stage. ``nev`` = energies wanted, ``ncv`` = vectors kept.
        """
        self._check_which(which)
        if which == "repr":
            return self._locate_E0_lanczos_repr(nev, ncv, maxit, sec, seed)
        sector = self.sec_full[sec]
        complex_h = sector.matvec.is_complex
        if sector.dim <= _DENSE_CUTOFF:
            evals, vecs = self._dense_solve(sector, max(nev, ncv), complex_h)
            self._store("full", sector, evals, vecs, nev, max(ncv, 1))
            self._e0_sec = sec
            return
        fs = self._fullspace_op(sector)
        ncv_ = max(12, 2 * nev + 6)
        v0 = fs32 = None
        if fs is not None and config.mixed_precision:
            # mixed-precision stage 1: bulk Krylov in f32 on the contraction
            # engine; its Ritz vector warm-starts the f64 stage below
            fs32 = self._fullspace_op(sector, dtype=torch.float32)
            if fs32 is not None:
                v0 = self._f32_stage_cached(fs32, nev, ncv_, maxit, seed,
                                            fs32.is_complex or complex_h)
        if fs is not None:
            evals, vecs_full = self._solve_fullspace(
                fs, nev, ncv_, maxit, seed, fs.is_complex or complex_h, v0,
                fs32=fs32)
            vecs = [fs.to_sector(v) for v in vecs_full]
        else:
            evals, vecs = eigs_smallest(
                sector.matvec, sector.dim, nev=nev, ncv=ncv_, maxit=maxit,
                seed=seed, complex_vec=complex_h)
        self._store("full", sector, evals, vecs, nev, max(ncv, 1))
        self._e0_sec = sec

    def _fullspace_op(self, sector, max_blowup: float = 64.0, dtype=None):
        """Full-label-space engine for this sector when supported and the
        label-space blowup is worth it; None otherwise. Cached per dtype.

        Both devices of the port have native float64 matmuls, so the
        window-contraction engine serves both precisions (the JAX package
        routes the same way on its CPU and GPU backends); the roll engine is
        the float64 fallback for operators the contraction engine cannot
        take. ``max_blowup`` is the JAX package's TPU calibration, not
        re-measured on the GPU. An explicit ELL (``generate_Ham_sparse_full``)
        is honoured: None.
        """
        dtype = dtype or torch.float64
        if not isinstance(sector.matvec, MatvecFull):
            return None  # explicit sparse was requested; honor it
        if dtype in sector._fs_cache:
            return sector._fs_cache[dtype]
        if self.space.label_space > max_blowup * max(sector.dim, 1):
            return None
        op = None
        if supports_contract(self.compiled_Ham):
            op = ContractOp(self.compiled_Ham, sector.labels, dtype=dtype,
                            device=self.device)
        elif dtype != torch.float32 and supports_fullspace(self.compiled_Ham):
            op = FullSpaceOp(self.compiled_Ham, sector.labels,
                             device=self.device)
        sector._fs_cache[dtype] = op
        return op

    def _fullspace_repr_op(self, *args, **kwargs):
        raise _not_ported("the projected full-label-space momentum engines "
                          "(_fullspace_repr_op)",
                          "the projected momentum-engine slice")

    @staticmethod
    def _f32_stage_cached(fs32, nev, ncv, maxit, seed, complex_vec):
        """f32 Krylov bulk stage: the lowest f32 Ritz vector, or None. (The
        JAX package also persists it as a checkpoint stage; not ported.)"""
        _, v32 = eigs_smallest(
            fs32, fs32.N, nev=nev, ncv=ncv, maxit=maxit, seed=seed,
            complex_vec=complex_vec, mask=fs32.mask,
            tol=config.mixed_precision_f32_tol, verify_degenerate=False)
        return v32[0] if v32 else None

    @staticmethod
    def _solve_fullspace(fs, nev, ncv, maxit, seed, complex_vec, v0,
                         fs32=None):
        """Full-space sector solve: thick restart, or, warm-started at
        large N, the mixed-precision RQI polish.

        The thick-restart basis holds ncv+1 full-space rows. Past
        ``_POLISH_N`` the warm-started f64 stage runs at 3-4 full-space f64
        vectors instead: the Jacobi-Davidson RQI polish (solvers/rqi.py: f64
        residuals, f32 correction solves) when the f32 engine twin is
        available, else the rolling 2-vector Lanczos (solvers/lanczos.py, the
        reference's own sr_val0 design, src/lanczos.cc:193-264), both from
        the f32 stage's Ritz vector and under a hard residual gate.
        """
        if v0 is None or nev != 1 or fs.N <= _POLISH_N:
            return eigs_smallest(fs, fs.N, nev=nev, ncv=ncv, maxit=maxit,
                                 seed=seed, complex_vec=complex_vec,
                                 mask=fs.mask, v0=v0)
        x = _masked(v0.to(device=fs.device, dtype=torch.complex128
                          if complex_vec or v0.is_complex()
                          else torch.float64), fs.mask)
        x = x / torch.linalg.vector_norm(x)
        if fs32 is not None:
            out = rqi_polish(fs, x, fs32=fs32)
            if out["converged"]:
                return [out["E0"]], [out["vector"]]
            # RQI stalled (e.g. f32 gap resolution): fall back to the f64
            # 2-vector kernel warm-started from its best iterate
            x = out["vector"] / torch.linalg.vector_norm(out["vector"])
        # long unrestarted cycles: restarting every ~60 steps discards the
        # Krylov subspace each cycle, which for small spectral gaps (kagome:
        # ~1e-3) multiplies the matvec count (contraction per unrestarted
        # step is e^{-2 sqrt(gap/spread)})
        out = lanczos_ground(fs, x, maxit=maxit, inner=120)
        # hard-fail on non-convergence, mirroring eigs_smallest: the gate is
        # lanczos_ground's own residual threshold (a rigorous eigenvalue
        # error bound for Hermitian H). Without this check a maxit-exhausted
        # polish would silently publish an unconverged E0.
        r_gate = max(1e3 * config.lanczos_precision * max(abs(out["E0"]), 1.0),
                     5e-10)
        if out["residual"] >= r_gate:
            err = RuntimeError(
                f"full-space Lanczos polish unconverged after "
                f"{out['niter']} matvecs: E0={out['E0']:.12f}, "
                f"residual {out['residual']:.3e} >= gate {r_gate:.3e}")
            err.E0 = out["E0"]
            err.residual = out["residual"]
            raise err
        return [out["E0"]], [out["vector"]]

    def locate_E0_iram(self, which: str = "full", nev: int = 2, ncv: int = 6,
                       maxit: int = 1000, sec: int = 0, seed: int = 1):
        """Several lowest eigenpairs via thick-restart Lanczos (ARPACK repl.)."""
        self._check_which(which)
        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        dense = sector.dim <= _DENSE_CUTOFF and which == "full"
        fs = (self._fullspace_op(sector) if which == "full" and not dense
              else None)
        if dense:
            evals, vecs = self._dense_solve(sector, nev,
                                            sector.matvec.is_complex)
        elif fs is not None:
            evals, vecs_full = eigs_smallest(
                fs, fs.N, nev=nev, ncv=ncv, maxit=maxit, seed=seed,
                complex_vec=fs.is_complex or sector.matvec.is_complex,
                mask=fs.mask)
            vecs = [fs.to_sector(v) for v in vecs_full]
        else:
            mv = self._repr_spmv(sector) if which == "repr" else sector.matvec
            evals, vecs = eigs_smallest(mv, sector.dim, nev=nev, ncv=ncv,
                                        maxit=maxit, seed=seed,
                                        complex_vec=mv.is_complex)
        self._store(which, sector, evals, vecs)
        if which == "full":
            self._e0_sec = sec

    def locate_Emax_iram(self, which: str = "full", nev: int = 2,
                         ncv: int = 8, maxit: int = 1000, sec: int = 0,
                         seed: int = 1):
        """Largest eigenpairs (cf. model::locate_Emax_iram,
        src/model.cc:1386-1421) via thick-restart Lanczos which='LA'."""
        self._check_which(which)
        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        complex_h = sector.matvec.is_complex if which == "full" else True
        mv = self._repr_spmv(sector) if which == "repr" else sector.matvec
        evals, vecs = eigs_smallest(
            mv, sector.dim, nev=nev, ncv=max(ncv, 2 * nev + 4), maxit=maxit,
            seed=seed, complex_vec=complex_h, which="LA")
        self._store(which, sector, evals, vecs)
        return evals

    def locate_Es(self, *args, **kwargs):
        raise _not_ported("locate_Es (interior windows)",
                          "the dynamics and spectra slice")

    def _locate_E0_lanczos_repr(self, nev, ncv, maxit, sec, seed):
        sector = self.sec_repr[sec]
        if sector.dim <= _DENSE_CUTOFF:
            evals, vecs = self._dense_solve_repr(sector, max(nev, ncv, 1))
        else:
            ncv_ = max(12, 2 * nev + 6)
            bsr32 = self._repr_bsr32(sector) if nev == 1 else None
            if bsr32 is not None:
                # f32 bulk Krylov on the BSR kernel, f64 RQI polish and
                # residual gate on the ELL
                ell = self._repr_ell(sector)
                _, v32 = eigs_smallest(
                    bsr32, sector.dim, nev=1, ncv=ncv_, maxit=maxit,
                    seed=seed, complex_vec=True,
                    tol=config.mixed_precision_f32_tol,
                    verify_degenerate=False)
                out = rqi_polish(ell, v32[0], fs32=bsr32)
                if out["converged"]:
                    evals, vecs = [out["E0"]], [out["vector"]]
                else:
                    evals, vecs = eigs_smallest(
                        ell, sector.dim, nev=1, ncv=ncv_, maxit=maxit,
                        seed=seed, complex_vec=True, v0=out["vector"])
            else:
                evals, vecs = eigs_smallest(
                    self._repr_spmv(sector), sector.dim, nev=nev, ncv=ncv_,
                    maxit=maxit, seed=seed, complex_vec=True)
        self._store("repr", sector, evals, vecs, nev, max(ncv, 1))

    def _repr_ell(self, sector):
        """Explicit f64 ELL for a momentum sector, built once per sector."""
        if sector.ell is None:
            mv = sector.matvec
            if not isinstance(mv, MatvecRepr):
                mv = sector.matvec_free or MatvecRepr(self.compiled_Ham,
                                                      sector.dbasis)
            sector.ell = build_sparse_repr(mv)
        return sector.ell

    def _repr_spmv(self, sector):
        """f64 engine of the pure-Krylov route: the ELL, or the f64 BSR
        kernel when ``config.prefer_bsr`` forces it."""
        if sector.spmv is None:
            ell = self._repr_ell(sector)
            sector.spmv = (ell_to_bsr(ell) if config.prefer_bsr
                           and ell.width > 0 else ell)
        return sector.spmv

    def _repr_bsr32(self, sector):
        """f32 BSR bulk engine for a momentum sector, or None.

        On a CUDA device the fill statistics decide (config.bsr_blowup_max,
        config.bsr_stored_max_bytes); elsewhere the route is off unless
        ``config.prefer_bsr`` is set. ``prefer_bsr`` overrides on any device.
        """
        if sector._routed:
            return sector.bsr32
        ell = self._repr_ell(sector)
        use = config.prefer_bsr
        if use is None:
            use = False
            if self.device.type == "cuda" and ell.width > 0:
                st = bsr_fill_stats(ell)
                stored_bytes = st["stored"] * 4 * (2 if ell.is_complex else 1)
                use = (st["blowup"] <= config.bsr_blowup_max
                       and stored_bytes <= config.bsr_stored_max_bytes)
        if use and ell.width > 0:
            sector.bsr32 = ell_to_bsr(ell, dtype=torch.float32)
        sector._routed = True
        return sector.bsr32

    def _dense_solve_repr(self, sector, nev: int):
        """Small momentum sectors: dense H_k from the ELL, eigh on the host."""
        n = sector.dim
        ell = self._repr_ell(sector)
        H = np.zeros((n, n), dtype=np.complex128)
        rows = np.repeat(np.arange(n), ell.width)
        np.add.at(H, (rows, ell.cols.cpu().numpy().reshape(-1)),
                  ell.vals.cpu().numpy().reshape(-1))
        H[np.arange(n), np.arange(n)] += ell.diag.cpu().numpy()
        herm_err = np.max(np.abs(H - H.conj().T))
        if herm_err >= 1e-9:
            raise AssertionError(f"H_k not Hermitian: {herm_err}")
        evals, evecs = np.linalg.eigh(H)
        vecs = [torch.as_tensor(evecs[:, i].copy(), device=self.device)
                for i in range(min(nev, n))]
        return evals[:nev].tolist(), vecs

    # --------------------------------------------------------- measurement

    def measure_full_static(self, oprs, sec: int, which: int = 0) -> complex:
        """<phi| O_k ... O_1 |phi> (chained); cf. model::measure_full_static
        (src/model.cc:1663-1694). ``oprs`` is one Mopr or a list applied
        right-to-left.
        """
        sector = self.sec_full[sec]
        phi = sector.evecs[which] if sector.evecs else self.eigenvecs_full[which]
        if not isinstance(oprs, (list, tuple)):
            oprs = [oprs]
        y = phi
        for op in reversed(list(oprs)):
            y = mopr_x_vec(self.compile_op(op), sector.dbasis, sector.dbasis, y)
        return complex(torch.vdot(phi.to(y.dtype), y))

    def measure_full_dynamic(self, *args, **kwargs):
        raise _not_ported("measure_full_dynamic",
                          "the dynamics and spectra slice")

    def measure_repr_dynamic(self, *args, **kwargs):
        raise _not_ported("measure_repr_dynamic",
                          "the dynamics and spectra slice")

    def symmetrize_op(self, op):
        """Translation-symmetrize: O_t = (1/G) sum_R T(R) O T(-R).

        cf. measure_repr_static's symmetrization (src/model.cc:1859-1893),
        done in the host symbolic algebra over all translation plans.
        """
        op = self._coerce_mopr(op)
        _, plans = self.lattice.translation_group()
        out = Mopr()
        for plan in plans:
            out += op.transform(plan)
        return (1.0 / len(plans)) * out

    def measure_repr_static(self, op, sec: int, which: int = 0) -> complex:
        """<phi_k| O |phi_k> in a momentum sector.

        cf. model::measure_repr_static (src/model.cc:1859-1893): O is
        translation-symmetrized, then split into Hermitian and anti-Hermitian
        parts so the Hermitian row-gather apply evaluates both.
        """
        sector = self.sec_repr[sec]
        phi = sector.evecs[which].to(torch.complex128)
        Ot = self.symmetrize_op(op)
        out = 0.0 + 0.0j
        for part, factor in ((0.5 * (Ot + Ot.dagger()), 1.0),
                             ((-0.5j) * (Ot - Ot.dagger()), 1.0j)):
            if part.q_zero():
                continue
            mv = MatvecRepr(compile_operator(part, self.space), sector.dbasis)
            out += factor * float(torch.vdot(phi, mv(phi)).real)
        return complex(out)
