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

A larger full sector whose label space is at most ``fullspace_max_blowup``
times its dimension (one value per device type, ``config.ROUTING``) is solved
over the FULL label space (``_fullspace_op``): on the window-contraction
engine (ops/apply_contract.py) in float64, or, under
``config.mixed_precision``, with the Krylov bulk on its float32 twin and a
float64 polish (Rayleigh-quotient iteration above the device's ``polish_n``
labels, ``config.MEMORY``) under
a hard residual gate; the masked-roll engine (ops/apply_fullspace.py) is the
float64 fallback for operators the contraction engine cannot take. Other
full sectors, and every sector after ``generate_Ham_sparse_full``, run
thick-restart Lanczos in float64 on the sector's own ``matvec``: the
matrix-free :class:`MatvecFull` or the explicit ELL.

A larger momentum sector whose label space is at most
``fullspace_repr_max_blowup`` times its dimension is solved the same way as
``P_k H`` (``_fullspace_repr_op``: the same engines with the block-transpose
momentum projector of ops/translate_fullspace.py, pure float64 or mixed),
and its eigenvector is read back at the representative labels. Where that
gives no engine (a tilted cluster, a larger blowup, an operator neither
engine takes) the sector takes the explicit-sparse route: the f32 bulk
Krylov stage on the BSR kernel (ops/bsr.py) with an f64 Rayleigh-quotient
polish on the ELL matrix when ``_repr_bsr32`` routes the sector there, else
thick-restart Lanczos on the f64 ELL. ``enumerate_basis_repr(method="dnc")``
streams the representatives without materializing the sector
(basis/weisse.py).

With ``config.enable_ckpt`` every solve stage persists its result under a key
that carries the Hamiltonian's fingerprint, and the solvers persist their
restart state (utils/ckpt.py): a rerun loads finished stages and resumes the
one that was interrupted.

Dynamics: ``measure_full_dynamic`` / ``measure_repr_dynamic`` record the
continued fraction of <phi|A^dagger (z - H)^{-1} A|phi> on the target sector's
matvec; ``measure_full_dynamic_kpm`` / ``measure_repr_dynamic_kpm`` record its
Chebyshev (KPM) moments, a momentum sector on the float64 ``P_k H`` engine up
to ``kpm_fullspace_max_N`` labels, else on the sector-dim engine (the
float32 BSR kernel where ``_repr_bsr32`` routes the sector). ``locate_Es``
finds the eigenpairs inside an energy window by Chebyshev-filtered subspace
iteration.

The variational (Trugman) sector: ``build_basis_vrnl`` grows a
translate-to-center basis from seed states on the device (basis/vrnl.py),
``generate_Ham_sparse_vrnl`` builds its momentum-independent matrix skeleton
once per basis, and ``locate_E0_lanczos(which="vrnl")`` /
``locate_E0_iram(which="vrnl")`` re-phase it for the sector's momentum and
solve (dense ``eigh`` on the host up to ``_DENSE_CUTOFF`` rows, else
thick-restart Lanczos on :class:`MatvecVrnl`); ``moprXgs_vrnl``,
``moprXvec_vrnl``, ``measure_vrnl_static`` / ``measure_vrnl_dynamic`` and
``wannier_mat_vrnl`` measure over it (ops/apply_vrnl.py).

With a basis mesh (``Model(mesh=basis_mesh())`` or :meth:`set_mesh`; one
rank per device over ``torch.distributed``, parallel/mesh.py) every rank of
the group runs the same calls: ``enumerate_basis_full`` and
``enumerate_basis_repr(method="dnc")`` distribute the divide-and-conquer
tiles over the ranks and merge them by the distributed sample sort, and the
ground-state solves of full and momentum sectors run thick-restart Lanczos
on a row-sharded engine (:meth:`_mesh_engine`: the halo-exchange ELL, or the
all-gather matrix-free apply where the halo would move more), with every
reduction summed over the ranks. The eigenvectors are gathered to whole
vectors on every rank, so the measurements run unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.basis.enumerate import _QN_TOL, enumerate_basis
from quantum_basis_tpu_torch.basis.site_basis import SiteBasis
from quantum_basis_tpu_torch.basis.state import StateSpace
from quantum_basis_tpu_torch.basis.translation import (
    TranslationSet,
    enumerate_reps,
)
from quantum_basis_tpu_torch.basis.vrnl import (
    CenterTranslator,
    VrnlMatrix,
    VrnlSector,
    grow_basis_vrnl,
)
from quantum_basis_tpu_torch.basis.weisse import enumerate_reps_dnc
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
    sector_mask,
    supports_fullspace,
)
from quantum_basis_tpu_torch.ops.apply_repr import (
    MatvecRepr,
    ReprBasis,
    mopr_x_vec_repr,
)
from quantum_basis_tpu_torch.ops.apply_vrnl import (
    MatvecVrnl,
    _images_canon,
    measure_vrnl_static,
    mopr_x_gs_vrnl,
    mopr_x_vec_vrnl,
)
from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats, ell_to_bsr
from quantum_basis_tpu_torch.ops.compile import (
    compile_diagonal,
    compile_operator,
    operator_fingerprint,
)
from quantum_basis_tpu_torch.ops.dense import dense_matrix
from quantum_basis_tpu_torch.ops.operators import Mopr, Opr, OprProd
from quantum_basis_tpu_torch.ops.sparse import (
    EllMatrix,
    build_sparse_full,
    build_sparse_repr,
    hermiticity_exact,
    hermiticity_probe,
)
from quantum_basis_tpu_torch.ops.translate_fullspace import (
    MomentumProjector,
    ProjectedFullOp,
    RollTranslations,
)
from quantum_basis_tpu_torch.parallel.apply_sharded import MatvecSharded
from quantum_basis_tpu_torch.parallel.enumerate_sharded import (
    enumerate_basis_dnc_sharded,
    enumerate_reps_dnc_sharded,
)
from quantum_basis_tpu_torch.parallel.halo_sharded import EllShardedHalo
from quantum_basis_tpu_torch.parallel.mesh import BasisMesh
from quantum_basis_tpu_torch.solvers.chebyshev import eigs_window, kpm_moments
from quantum_basis_tpu_torch.solvers.lanczos import (
    lanczos_dynamics,
    lanczos_ground,
)
from quantum_basis_tpu_torch.solvers.reduce import GroupStore, ckpt_store
from quantum_basis_tpu_torch.solvers.restarted import (
    _projected,
    _solver_log,
    eigs_smallest,
)
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish
from quantum_basis_tpu_torch.solvers.tridiag import tridiag_eigvals
from quantum_basis_tpu_torch.utils import ckpt

_DENSE_CUTOFF = 600  # sectors at/below this size are solved densely on host
_MASK_CHUNK = 1 << 22  # labels per step of the on-device quantum-number mask


def checked_mesh(mesh):
    """``mesh`` if it is a BasisMesh or None; TypeError otherwise."""
    if mesh is not None and not isinstance(mesh, BasisMesh):
        raise TypeError(f"mesh must be a BasisMesh, not {type(mesh)}")
    return mesh


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
        # momentum sectors only: the enumeration this basis came from
        # ((cache key, conserve list, values)), its P_k engines per dtype,
        # and the measurement matvecs per operator fingerprint. All of it
        # lives on the sector, so a re-enumerated sector starts clean.
        self.qn = None
        self._fsrepr_cache = {}
        self._projector = None
        self._meas_cache = {}
        self._mesh_mv = None  # (mesh, sharded engine, row mask)


class Model:
    def __init__(self, lattice=None, device="cuda", mesh=None):
        """``device``: where every basis table, matrix and vector lives.

        ``mesh``: an optional :class:`~quantum_basis_tpu_torch.parallel.mesh.
        BasisMesh`; sector enumeration and solves then run over its ranks
        (see the module docstring). Every rank of the group builds the same
        model and makes the same calls; the mesh's device is this rank's
        ``device``. The JAX package's mesh is one process over all devices
        (single-controller); here each process is one rank.
        """
        self.mesh = checked_mesh(mesh)
        self.lattice = lattice
        self.device = torch.device(device)
        self._orbitals: list[tuple[SiteBasis, int]] = []
        self._space: StateSpace | None = None
        self.Ham = Mopr()
        self.Ham_vrnl = Mopr()  # Trugman-basis generator (qbasis.h:1269)
        self._compiled = None
        self.sec_full: dict[int, Sector] = {}
        self.sec_repr: dict[int, Sector] = {}
        self.sec_vrnl: dict[int, VrnlSector] = {}
        self.eigenvals_full: list[float] = []
        self.eigenvecs_full: list = []  # 1-d tensors over the sector basis
        self.eigenvals_repr: list[float] = []
        self.eigenvecs_repr: list = []
        self.eigenvals_vrnl: list[float] = []
        self.eigenvecs_vrnl: list = []
        self._e0_sec = 0  # sector of the stored ground state
        self._tset = None
        self._repr_cache = None  # (key, sector labels, orbit reps)
        self._ham_fp = None
        self._rolls = False        # RollTranslations, None = unsupported
        self._fsrepr_bases = {}    # dtype -> engine shared by all momenta
        self._qn_mask_cache = None  # (enumeration key, {dtype: 0/1 mask})
        self._ct = None
        self._vrnl_skel = None  # (key, VrnlMatrix) cache across momenta

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
        self._ham_fp = None
        self._fsrepr_bases = {}

    def _ham_fingerprint(self) -> int:
        """Content CRC of the compiled Hamiltonian, folded into every
        solve-stage checkpoint key so that a stale ``out_Qckpt/`` written by
        a model with different couplings (same sector dim) is ignored
        instead of silently returned (cf. the reference's cache
        re-validation, src/model.cc:2163-2187)."""
        if self._ham_fp is None:
            self._ham_fp = operator_fingerprint(self.compiled_Ham)
        return self._ham_fp

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

        cf. model::enumerate_basis_full (src/model.cc:253-271). With a mesh
        the divide-and-conquer tiles are spread over the ranks and merged by
        the distributed sample sort (the same labels).
        """
        labels = None
        if self.mesh is not None and conserve_lst:
            labels = enumerate_basis_dnc_sharded(self.space, conserve_lst,
                                                 val_lst, self.mesh)
        if labels is None:
            labels = enumerate_basis(self.space, conserve_lst, val_lst,
                                     device=self.device)
        return self._set_full_sector(labels, sec)

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

        cf. model::enumerate_basis_repr (src/model.cc:274-487). Two paths,
        mirroring the reference's two algorithms:

        - ``method="direct"``: orbit classification on the device over the
          materialized quantum-number sector;
        - ``method="dnc"``: sublattice divide-and-conquer streaming (the
          Weisse-table equivalent, O(sqrt(label_space)) host memory;
          basis/weisse.py). Identical output, for sectors too large to
          materialize.
        """
        if method not in ("direct", "dnc"):
            raise ValueError(f"method must be 'direct' or 'dnc', not {method!r}")

        def mopr_key(m):
            return tuple(sorted(
                ((complex(np.round(t.coeff, 12)), t._key()) for t in m.terms),
                key=repr))

        qn_key = (tuple(mopr_key(m) for m in (conserve_lst or [])),
                  tuple(float(v) for v in (val_lst or [])))
        key = qn_key + (method,)
        if self._repr_cache is None or self._repr_cache[0] != key:
            if method == "dnc":
                if self.mesh is not None:
                    # the streamed tiles spread over the ranks, merged by
                    # the distributed sample sort (SURVEY §5.8)
                    reps = enumerate_reps_dnc_sharded(
                        self.tset, conserve_lst, val_lst, self.mesh)
                else:
                    reps = enumerate_reps_dnc(self.tset, conserve_lst,
                                              val_lst)
                labels = reps  # the full sector is never materialized
            else:
                labels = enumerate_basis(self.space, conserve_lst, val_lst,
                                         device=self.device)
                reps = enumerate_reps(self.tset, labels)
            self._repr_cache = (key, labels, reps)
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
        # what the quantum-number mask of this sector is built from: the
        # sector's labels where they exist (direct), else the conserved
        # operators (dnc)
        s.qn = (qn_key, list(conserve_lst or []), list(val_lst or []),
                labels if method == "direct" else None)
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
            raise ValueError("the variational sector is solved by "
                             "locate_E0_lanczos / locate_E0_iram only")
        if which not in ("full", "repr"):
            raise ValueError(f"which must be 'full' or 'repr', not {which!r}")

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
        if which == "vrnl":
            return self._locate_E0_vrnl(nev, ncv, maxit, sec, seed)
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
        if self.mesh is not None:
            return self._locate_E0_mesh(sector, "full", nev, ncv, maxit, sec,
                                        seed)
        key = f"lczsE0_full_sec{sec}_nev{nev}_h{self._ham_fingerprint():08x}"
        done = self._ckpt_stage_load(key, complex_h)
        if done is not None:
            evals, vecs = done
        else:
            fs = self._fullspace_op(sector)
            ncv_ = max(12, 2 * nev + 6)
            v0 = fs32 = None
            if fs is not None and config.mixed_precision:
                # mixed-precision stage 1: bulk Krylov in f32 on the
                # contraction engine; its Ritz vector warm-starts the f64
                # stage below
                fs32 = self._fullspace_op(sector, dtype=torch.float32)
                if fs32 is not None:
                    v0 = self._f32_stage_cached(
                        fs32, nev, ncv_, maxit, seed,
                        fs32.is_complex or complex_h, key)
            if fs is not None:
                evals, vecs_full = self._solve_fullspace(
                    fs, nev, ncv_, maxit, seed, fs.is_complex or complex_h,
                    key + "_krylov", v0, fs32=fs32)
                vecs = [fs.to_sector(v) for v in vecs_full]
            else:
                evals, vecs = eigs_smallest(
                    sector.matvec, sector.dim, nev=nev, ncv=ncv_,
                    maxit=maxit, seed=seed, complex_vec=complex_h,
                    ckpt_key=key + "_krylov")
            self._ckpt_stage_save(key, evals, vecs)
        self._store("full", sector, evals, vecs, nev, max(ncv, 1))
        self._e0_sec = sec

    def _fullspace_op(self, sector, max_blowup: float | None = None,
                      dtype=None):
        """Full-label-space engine for this sector when supported and the
        label-space blowup is worth it; None otherwise. Cached per dtype.

        Both devices of the port have native float64 matmuls, so the
        window-contraction engine serves both precisions (the JAX package
        routes the same way on its CPU and GPU backends); the roll engine is
        the float64 fallback for operators the contraction engine cannot
        take. ``max_blowup`` defaults to the device's
        ``fullspace_max_blowup``, or under ``config.mixed_precision`` its
        ``fullspace_mixed_max_blowup`` (``config.route``). An explicit ELL
        (``generate_Ham_sparse_full``) is honoured: None.
        """
        dtype = dtype or torch.float64
        if not isinstance(sector.matvec, MatvecFull):
            return None  # explicit sparse was requested; honor it
        if dtype in sector._fs_cache:
            return sector._fs_cache[dtype]
        if max_blowup is None:
            max_blowup = config.route(
                "fullspace_mixed_max_blowup" if config.mixed_precision
                else "fullspace_max_blowup", self.device)
        if self.space.label_space > max_blowup * max(sector.dim, 1):
            return None
        op = self._base_engine(dtype, sector.labels)
        sector._fs_cache[dtype] = op
        return op

    def _base_engine(self, dtype, sector_labels=None):
        """A full-label-space engine in the order of :meth:`_fullspace_op`:
        the contraction engine for both precisions, the roll engine for
        float64 when the contraction engine cannot take H; else None."""
        if supports_contract(self.compiled_Ham):
            return ContractOp(self.compiled_Ham, sector_labels, dtype=dtype,
                              device=self.device)
        if dtype != torch.float32 and supports_fullspace(self.compiled_Ham):
            return FullSpaceOp(self.compiled_Ham, sector_labels,
                               device=self.device)
        return None

    def _qn_mask(self, sector, dtype):
        """0/1 quantum-number mask of a momentum sector's enumeration over
        the full label space, on the device; None without conserved
        operators. From the sector's labels where the enumeration
        materialized them (``method="direct"``), else (``"dnc"``) from the
        conserved diagonal operators, in label chunks. The mask belongs to
        the enumeration, not to the shared engine: the model keeps the
        latest enumeration's, each sector's engines keep their own."""
        qn_key, conserve_lst, val_lst, labels = sector.qn
        if not conserve_lst:
            return None
        if self._qn_mask_cache is None or self._qn_mask_cache[0] != qn_key:
            self._qn_mask_cache = (qn_key, {})
        masks = self._qn_mask_cache[1]
        if dtype not in masks:
            N = int(self.space.label_space)
            if labels is not None:
                masks[dtype] = sector_mask(
                    N, torch.as_tensor(labels, device=self.device), dtype)
            else:
                evals = [compile_diagonal(m, self.space)
                         for m in conserve_lst]
                out = torch.empty(N, dtype=dtype, device=self.device)
                for start in range(0, N, _MASK_CHUNK):
                    stop = min(start + _MASK_CHUNK, N)
                    V = self.space.decode(torch.arange(
                        start, stop, dtype=torch.int64, device=self.device))
                    ok = torch.ones(stop - start, dtype=torch.bool,
                                    device=self.device)
                    for ev, v in zip(evals, val_lst):
                        ok &= (ev(V) - float(v)).abs() < _QN_TOL
                    out[start:stop] = ok
                masks[dtype] = out
        return masks[dtype]

    def _fullspace_repr_op(self, sector, max_blowup: float | None = None,
                           dtype=None):
        """Momentum-sector solve operator in the FULL label space: P_k H on
        the fast full-space engine with the block-transpose momentum
        projector (ops/translate_fullspace.py). None when unsupported
        (tilted lattices, oversized blowup, engine constraints): callers
        then take the explicit ELL/BSR route. Cached per sector and dtype.

        ``max_blowup`` defaults to the device's ``fullspace_repr_max_blowup``
        (``config.route``).

        ONE base engine per dtype is built per model and shared by every
        momentum sector (it depends on H alone); one projector per sector;
        the quantum-number mask per enumeration (:meth:`_qn_mask`), so two
        enumerations with different quantum numbers on one model never see
        each other's mask.
        """
        dtype = dtype or torch.float64
        cache = sector._fsrepr_cache
        if dtype in cache:
            return cache[dtype]
        op = None
        if max_blowup is None:
            max_blowup = config.route("fullspace_repr_max_blowup",
                                      self.device)
        if self.space.label_space <= max_blowup * max(sector.dim, 1):
            if self._rolls is False:
                try:
                    self._rolls = RollTranslations(self.space, self.lattice,
                                                   device=self.device)
                except (ValueError, KeyError):
                    self._rolls = None  # e.g. a tilted cluster
            if self._rolls is not None:
                if dtype not in self._fsrepr_bases:
                    self._fsrepr_bases[dtype] = self._base_engine(dtype)
                base = self._fsrepr_bases[dtype]
                if base is not None:
                    if sector._projector is None:
                        sector._projector = MomentumProjector(
                            self._rolls, sector.momentum)
                    op = ProjectedFullOp(base, sector._projector,
                                         mask=self._qn_mask(sector, dtype))
        cache[dtype] = op
        return op

    @staticmethod
    def _f32_stage_cached(fs32, nev, ncv, maxit, seed, complex_vec, key):
        """f32 Krylov bulk stage with a persisted result record: the lowest
        f32 Ritz vector, or None. An interrupted or repeated run reloads the
        vector instead of paying the whole stage again (cf. the stage bits of
        ckpt_lczsE0, reference src/model.cc:2521-2749)."""
        rkey = key + "_f32res"
        store = ckpt_store(fs32, rkey)
        if store is not None:
            rec = store.load(rkey, vectors=("re", "im"),
                             fits=lambda r: r["re"].shape == (fs32.N,))
            if rec is not None:
                return ckpt.join_vec(rec["re"], rec["im"], complex_vec,
                                     fs32.device)
        _, v32 = eigs_smallest(
            fs32, fs32.N, nev=nev, ncv=ncv, maxit=maxit, seed=seed,
            complex_vec=complex_vec, mask=fs32.mask,
            tol=config.mixed_precision_f32_tol, ckpt_key=key + "_f32",
            verify_degenerate=False)
        if not v32:
            return None
        if store is not None:
            re, im = ckpt.split_vec(store.whole(v32[0]))
            store.save(rkey, {"re": re, "im": im})
        return v32[0]

    @staticmethod
    def _solve_fullspace(fs, nev, ncv, maxit, seed, complex_vec, ckpt_key,
                         v0, fs32=None):
        """Full-space sector solve: thick restart, or, warm-started at
        large N, the mixed-precision RQI polish. Returns the eigenvectors
        over ALL labels of the space.

        The thick-restart basis holds ncv+1 full-space rows. Past the
        device's ``polish_n`` (``config.MEMORY``) the warm-started f64 stage
        runs at 3-4 full-space f64 vectors instead: the Jacobi-Davidson RQI
        polish (solvers/rqi.py: f64 residuals, f32 correction solves) when
        the f32 engine twin is available, else the rolling 2-vector Lanczos
        (solvers/lanczos.py, the reference's own sr_val0 design,
        src/lanczos.cc:193-264), both from the f32 stage's Ritz vector and
        under a hard residual gate.
        """
        if v0 is None or nev != 1 or fs.N <= config.memory("polish_n",
                                                            fs.device):
            return eigs_smallest(fs, fs.N, nev=nev, ncv=ncv, maxit=maxit,
                                 seed=seed, complex_vec=complex_vec,
                                 mask=fs.mask, ckpt_key=ckpt_key, v0=v0)
        x = _projected(fs, v0.to(device=fs.device, dtype=torch.complex128
                                 if complex_vec or v0.is_complex()
                                 else torch.float64), fs.mask)
        x = x / torch.linalg.vector_norm(x)
        if fs32 is not None:
            out = rqi_polish(
                fs, x, fs32=fs32,
                ckpt_key=ckpt_key + "_rqi" if ckpt_key else None,
                log=lambda i, th, rn, ni: _solver_log("rqi", i, [th], [rn]))
            if out["converged"]:
                return [out["E0"]], [out["vector"]]
            # RQI stalled (e.g. f32 gap resolution): fall back to the f64
            # 2-vector kernel warm-started from its best iterate
            x = out["vector"] / torch.linalg.vector_norm(out["vector"])
        # long unrestarted cycles: restarting every ~60 steps discards the
        # Krylov subspace each cycle, which for small spectral gaps (kagome:
        # ~1e-3) multiplies the matvec count (contraction per unrestarted
        # step is e^{-2 sqrt(gap/spread)})
        out = lanczos_ground(fs, x, maxit=maxit, inner=120,
                             ckpt_key=ckpt_key + "_polish" if ckpt_key
                             else None)
        if out["alphas"] is not None and len(out["alphas"]) >= 2:
            # on record for slow sectors: RQI stalls when the sector gap sits
            # at or below the f32 correction resolution; log the gap estimate
            # of the fallback cycle's tridiagonal: [residual, gap]
            ev = tridiag_eigvals(out["alphas"], out["betas"])[:2]
            _solver_log("rqi", -1, [out["E0"]],
                        [out["residual"], float(ev[1] - ev[0])])
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
                f"residual {out['residual']:.3e} >= gate {r_gate:.3e} "
                f"(checkpoint retained; re-run to resume)")
            err.E0 = out["E0"]
            err.residual = out["residual"]
            raise err
        return [out["E0"]], [out["vector"]]

    # ------------------------------------------------- stage checkpointing

    def _ckpt_stage_load(self, key, complex_h, mesh=None):
        """Load a completed solve stage (cf. ckpt_lczsE0_init,
        src/model.cc:2521-2749); None if absent or invalid. On a ``mesh``
        rank 0 decides and every rank loads the whole vectors."""
        store = ckpt.active_store()
        rec = (GroupStore(store, mesh).load(key) if store is not None
               else None)
        if rec is None:
            return None
        evals = [float(x) for x in rec["evals"]]
        vecs = [ckpt.join_vec(rec[f"v{i}_re"], rec[f"v{i}_im"], complex_h,
                              self.device) for i in range(int(rec["nev"]))]
        return evals, vecs

    @staticmethod
    def _ckpt_stage_save(key, evals, vecs, mesh=None):
        """Save a completed solve stage (whole vectors; on a ``mesh`` every
        rank holds them and rank 0 writes)."""
        store = ckpt.active_store()
        if store is None:
            return
        payload = {"nev": len(vecs), "evals": np.asarray(evals)}
        for i, v in enumerate(vecs):
            payload[f"v{i}_re"], payload[f"v{i}_im"] = ckpt.split_vec(v)
        GroupStore(store, mesh).save(key, payload)

    def locate_E0_iram(self, which: str = "full", nev: int = 2, ncv: int = 6,
                       maxit: int = 1000, sec: int = 0, seed: int = 1):
        """Several lowest eigenpairs via thick-restart Lanczos (ARPACK repl.)."""
        if which == "vrnl":
            return self._locate_E0_vrnl(nev, max(ncv, nev), maxit, sec, seed)
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

    def locate_Es(self, e_lo: float, e_hi: float, which: str = "full",
                  sec: int = 0, nev_max: int = 10, degree: int = 200,
                  maxit: int = 40, seed: int = 7):
        """Interior eigenpairs in [e_lo, e_hi] — the FEAST replacement
        (cf. model::locate_Es_feast, src/model.cc:1424-1466), via
        Chebyshev-filtered subspace iteration (applies only, no
        factorization) on the sector's matvec, or a momentum sector's f64
        explicit engine (``_repr_spmv``). Returns the eigenvalues, ascending.
        """
        self._check_which(which)
        sector = self.sec_full[sec] if which == "full" else self.sec_repr[sec]
        complex_h = sector.matvec.is_complex if which == "full" else True
        mv = self._repr_spmv(sector) if which == "repr" else sector.matvec
        evals, vecs = eigs_window(
            mv, sector.dim, e_lo, e_hi, nev_max=nev_max, degree=degree,
            n_iter=maxit, seed=seed, complex_vec=complex_h)
        self._store(which, sector, evals, vecs)
        return evals

    def _locate_E0_lanczos_repr(self, nev, ncv, maxit, sec, seed):
        sector = self.sec_repr[sec]
        if sector.dim <= _DENSE_CUTOFF:
            evals, vecs = self._dense_solve_repr(sector, max(nev, ncv, 1))
            self._store("repr", sector, evals, vecs, nev, max(ncv, 1))
            return
        if self.mesh is not None:
            return self._locate_E0_mesh(sector, "repr", nev, ncv, maxit, sec,
                                        seed)
        kstr = "_".join(str(x) for x in sector.momentum)
        key = (f"lczsE0_repr_sec{sec}_K{kstr}_nev{nev}"
               f"_h{self._ham_fingerprint():08x}")
        done = self._ckpt_stage_load(key, True)
        if done is not None:
            evals, vecs = done
            self._store("repr", sector, evals, vecs, nev, max(ncv, 1))
            return
        fs = self._fullspace_repr_op(sector)
        ncv_ = max(12, 2 * nev + 6)
        if fs is not None:
            # momentum-filtered full-space solve (P_k H,
            # ops/translate_fullspace.py) with the optional f32 bulk stage
            v0 = fs32 = None
            if config.mixed_precision:
                fs32 = self._fullspace_repr_op(sector, dtype=torch.float32)
                if fs32 is not None:
                    v0 = self._f32_stage_cached(
                        fs32, nev, ncv_, maxit, seed, fs32.is_complex, key)
            evals, vecs_full = self._solve_fullspace(
                fs, nev, ncv_, maxit, seed, fs.is_complex, key + "_krylov",
                v0, fs32=fs32)
            vecs = [sector.dbasis.from_full(v) for v in vecs_full]
        else:
            bsr32 = self._repr_bsr32(sector) if nev == 1 else None
            if bsr32 is not None:
                # f32 bulk Krylov on the BSR kernel, f64 RQI polish and
                # residual gate on the ELL
                ell = self._repr_ell(sector)
                _, v32 = eigs_smallest(
                    bsr32, sector.dim, nev=1, ncv=ncv_, maxit=maxit,
                    seed=seed, complex_vec=True,
                    tol=config.mixed_precision_f32_tol,
                    verify_degenerate=False, ckpt_key=key + "_bsr32")
                out = rqi_polish(ell, v32[0], fs32=bsr32,
                                 ckpt_key=key + "_bsrrqi")
                if out["converged"]:
                    evals, vecs = [out["E0"]], [out["vector"]]
                else:
                    evals, vecs = eigs_smallest(
                        ell, sector.dim, nev=1, ncv=ncv_, maxit=maxit,
                        seed=seed, complex_vec=True, v0=out["vector"],
                        ckpt_key=key + "_krylov")
            else:
                evals, vecs = eigs_smallest(
                    self._repr_spmv(sector), sector.dim, nev=nev, ncv=ncv_,
                    maxit=maxit, seed=seed, complex_vec=True,
                    ckpt_key=key + "_krylov")
        self._ckpt_stage_save(key, evals, vecs)
        self._store("repr", sector, evals, vecs, nev, max(ncv, 1))

    # ------------------------------------------------------- basis mesh

    def set_mesh(self, mesh):
        """Attach, replace or (None) drop the basis mesh; clears the sectors'
        sharded engines, so the next solve rebuilds them on the new mesh."""
        self.mesh = checked_mesh(mesh)
        for s in list(self.sec_full.values()) + list(self.sec_repr.values()):
            s._mesh_mv = None

    def _mesh_engine(self, sector, which: str):
        """Router for the sharded engines (SURVEY §2.2/§5.8).

        Builds the explicit ELL once (the reference likewise builds CSR once
        and reuses it per MultMv, src/sparse.cc:113-328) and the halo
        all-to-all engine over it, and keeps that engine when its exchange
        volume beats the all-gather (``halo_stats()["traffic_ratio"] < 1``);
        else a full sector takes the matrix-free :class:`MatvecSharded`.
        Momentum sectors always take the halo engine (there is no sharded
        row-gather for them). Returns (engine, this rank's row mask).
        """
        cached = sector._mesh_mv
        if cached is not None and cached[0] is self.mesh:
            return cached[1], cached[2]
        if which == "repr":
            ell = self._repr_ell(sector)
        else:
            if isinstance(sector.matvec, EllMatrix):
                sector.ell = sector.matvec
            if sector.ell is None:
                sector.ell = build_sparse_full(sector.matvec)
            ell = sector.ell
        mv = EllShardedHalo(ell, self.mesh)
        if which != "repr" and mv.halo_stats()["traffic_ratio"] >= 1.0:
            # the halo exchange would move more than replicating the vector
            mv = MatvecSharded(self.compiled_Ham, sector.dbasis, self.mesh)
        lo, hi = mv.span
        row_mask = (torch.arange(lo, hi, device=mv.device)
                    < sector.dim).to(torch.float64)
        sector._mesh_mv = (self.mesh, mv, row_mask)
        return mv, row_mask

    def _locate_E0_mesh(self, sector, which: str, nev, ncv, maxit, sec,
                        seed):
        """Sector solve over the basis mesh (the public-API route): thick
        restart Lanczos on the sharded engine, every reduction summed over
        the ranks, the stage record under a key with ``_mesh{P}``. The
        records hold whole vectors, as the JAX package's do: rank 0 gathers
        and writes them, every rank resumes from them (GroupStore)."""
        complex_h = which == "repr" or sector.matvec.is_complex
        kstr = ("_".join(str(x) for x in np.atleast_1d(sector.momentum))
                if sector.momentum is not None else "")
        key = (f"lczsE0_{which}_sec{sec}_K{kstr}_nev{nev}_mesh{self.mesh.size}"
               f"_h{self._ham_fingerprint():08x}")
        done = self._ckpt_stage_load(key, complex_h, self.mesh)
        if done is not None:
            evals, vecs = done
        else:
            mv, row_mask = self._mesh_engine(sector, which)
            evals, vecs_p = eigs_smallest(
                mv, mv.n_pad, nev=nev, ncv=max(12, 2 * nev + 6),
                maxit=maxit, seed=seed, complex_vec=complex_h,
                mask=row_mask, ckpt_key=key + "_krylov")
            vecs = [mv.unpad(v).to(self.device) for v in vecs_p]
            self._ckpt_stage_save(key, evals, vecs, self.mesh)
        self._store(which, sector, evals, vecs, nev, max(ncv, 1))
        if which == "full":
            self._e0_sec = sec

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

        On a CUDA device the fill statistics decide (the device's
        ``bsr_blowup_max`` and ``bsr_stored_max_bytes``, ``config.route``);
        elsewhere the route is off unless ``config.prefer_bsr`` is set.
        ``prefer_bsr`` overrides on any device.
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
                use = (st["blowup"] <= config.route("bsr_blowup_max",
                                                    self.device)
                       and stored_bytes <= config.route(
                           "bsr_stored_max_bytes", self.device))
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

    def _injected(self, A, src, dst, which, repr_):
        """|v> = A|phi> in the target sector and its norm; phi is the source
        sector's eigenvector ``which``."""
        if repr_:
            phi = src.evecs[which] if src.evecs else \
                self.eigenvecs_repr[which]
            v = mopr_x_vec_repr(self.compile_op(A), src.dbasis, dst.dbasis,
                                phi)
        else:
            phi = src.evecs[which] if src.evecs else \
                self.eigenvecs_full[which]
            v = mopr_x_vec(self.compile_op(A), src.dbasis, dst.dbasis, phi)
        return v, float(torch.linalg.vector_norm(v))

    def measure_full_dynamic(self, A, sec_old: int, sec_new: int,
                             m_steps: int, which: int = 0, ckpt_key=None):
        """Continued-fraction data for G_A(z) = <phi|A^dagger (z-H)^{-1}
        A|phi>.

        Returns (norm, alphas, betas): |v> = A|phi>, norm = ||v||, then a
        fixed-step Lanczos on the target sector records a/b
        (cf. model::measure_full_dynamic, src/model.cc:1696-1712). An A that
        annihilates phi gives (0.0, empty, empty).
        """
        dst = self.sec_full[sec_new]
        v, nrm = self._injected(A, self.sec_full[sec_old], dst, which, False)
        if nrm < 1e-12:  # A|phi> vanishes (reference: src/model.cc:1704-1706)
            return 0.0, np.zeros(0), np.zeros(0)
        alphas, betas = lanczos_dynamics(dst.matvec, v / nrm, m_steps,
                                         ckpt_key=ckpt_key)
        return nrm, alphas, betas

    def measure_repr_dynamic(self, A, sec_old: int, sec_new: int,
                             m_steps: int, which: int = 0, ckpt_key=None):
        """Continued-fraction data across momentum sectors.

        |v> = A |phi_k> lands in sector ``sec_new`` (momentum k - q for
        A = sum_x e^{-iq.x} O_x); returns (norm, alphas, betas)
        (cf. model::measure_repr_dynamic, src/model.cc:1896-1912). An A that
        annihilates phi gives (0.0, empty, empty), as in the full sector (the
        JAX package divides by the zero norm here).
        """
        dst = self.sec_repr[sec_new]
        v, nrm = self._injected(A, self.sec_repr[sec_old], dst, which, True)
        if nrm < 1e-12:
            return 0.0, np.zeros(0), np.zeros(0)
        alphas, betas = lanczos_dynamics(dst.matvec, v / nrm, m_steps,
                                         ckpt_key=ckpt_key)
        return nrm, alphas, betas

    def measure_full_dynamic_kpm(self, A, sec_old: int, sec_new: int,
                                 n_moments: int, which: int = 0, bounds=None):
        """Operator-resolved KPM data for the dynamical structure factor.

        |v> = A|phi>, norm = ||v||, then Chebyshev moments
        mu_m = <v| T_m(Hs) |v> / norm^2 on the TARGET sector's H — the KPM
        counterpart of :meth:`measure_full_dynamic` (the reference has no
        KPM dynamics; its src/kpm.cc:45-99 stops at spectral bounds).
        Returns (norm, mu, e_min, e_max); reconstruct with
        :func:`quantum_basis_tpu_torch.postprocess.sqw_kpm`.
        """
        dst = self.sec_full[sec_new]
        v, nrm = self._injected(A, self.sec_full[sec_old], dst, which, False)
        if nrm < 1e-12:
            return 0.0, np.zeros(0), 0.0, 0.0
        mu, e_min, e_max = kpm_moments(dst.matvec, v, n_moments,
                                       bounds=bounds)
        return nrm, mu, e_min, e_max

    def measure_repr_dynamic_kpm(self, A, sec_old: int, sec_new: int,
                                 n_moments: int, which: int = 0, bounds=None):
        """KPM moments of A|phi> in momentum sectors (repr counterpart of
        :meth:`measure_full_dynamic_kpm`; cf. model::measure_repr_dynamic,
        src/model.cc:1896-1912, which only records continued fractions).

        Up to the device's ``kpm_fullspace_max_N`` labels (``config.route``)
        the recurrence runs on the sector's float64 projected full-space
        engine (``P_k H``), with A|phi> expanded to the full label space
        (the repr basis embeds isometrically there, so the moments are the
        same). Otherwise, or where the sector has no such engine, it runs at
        the sector's dimension: on the float32 BSR kernel when the sector is
        routed there (``_repr_bsr32``, evaluated only up to the device's
        ``bsr_auto_max_dim`` rows or under ``config.prefer_bsr``; a sector
        routed by an earlier solve is reused at any dim), else on the
        sector's explicit float64 ELL where one was built (by that routing
        decision or an earlier solve), else on the sector's matvec. The
        rescaled recurrence is contractive, so float32 applies leave moment
        noise far below the Jackson resolution pi*(e_max-e_min)/n_moments.
        """
        dst = self.sec_repr[sec_new]
        v, nrm = self._injected(A, self.sec_repr[sec_old], dst, which, True)
        if nrm < 1e-12:
            return 0.0, np.zeros(0), 0.0, 0.0
        v = v / nrm
        fs = None
        if self.space.label_space <= config.route("kpm_fullspace_max_N",
                                                  self.device):
            fs = self._fullspace_repr_op(dst)
        if fs is not None:
            mv, v = fs, self._repr_to_full(dst, v, fs=fs)
        else:
            mv = dst.bsr32
            if mv is None and (dst.dim <= config.route("bsr_auto_max_dim",
                                                       self.device)
                               or config.prefer_bsr):
                mv = self._repr_bsr32(dst)
            if mv is None:
                mv = dst.ell if dst.ell is not None else dst.matvec
        mu, e_min, e_max = kpm_moments(mv, v, n_moments, bounds=bounds)
        return nrm, mu, e_min, e_max

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
            comp = compile_operator(part, self.space)
            # the device-resident MatvecRepr is cached per operator ON the
            # sector: a correlator sweep measures the same O at many
            # distances, and a re-enumerated sector (a new object, even at
            # the same sec, momentum and dim) can never be handed a matvec
            # bound to the former basis
            fp = operator_fingerprint(comp)
            mv = sector._meas_cache.get(fp)
            if mv is None:
                if len(sector._meas_cache) > 64:
                    sector._meas_cache.clear()
                mv = sector._meas_cache[fp] = MatvecRepr(comp, sector.dbasis)
            out += factor * float(torch.vdot(phi, mv(phi)).real)
        return complex(out)

    # ----------------------------------------------- variational (vrnl) sector

    @property
    def center_translator(self) -> CenterTranslator:
        """Batched translate-to-center canonicalizer (built lazily)."""
        if self._ct is None:
            self._ct = CenterTranslator(self.space, self.lattice, self.device)
        return self._ct

    def add_Ham_vrnl(self, op):
        """Accumulate a term into the vrnl basis *generator* (cf.
        model::add_Ham_vrnl, src/qbasis.h:1367-1371 — used only to grow
        Trugman's variational basis, not as the matrix)."""
        self.Ham_vrnl += self._coerce_mopr(op)

    def build_basis_vrnl(self, initial_labels, gs_label: int, momentum_gs,
                         momentum, depth: int, conserve_lst=None,
                         val_lst=None, sec: int = 0):
        """Grow Trugman's variational basis from seed states.

        cf. model::build_basis_vrnl (src/model.cc:489-616). ``initial_labels``
        are integer state labels (the encoding of the reference's
        ``mbasis_elem`` list); ``momentum_gs`` / ``momentum`` are fractional
        wave vectors per unit cell (phase convention exp(2*pi*i k.disp), see
        the basis/vrnl.py docstring). The basis does not depend on
        ``momentum``: the matrix skeleton of an earlier call with the same
        labels is reused.
        """
        ct = self.center_translator
        gen = compile_operator(self.Ham_vrnl if not self.Ham_vrnl.q_zero()
                               else self.Ham, self.space)
        gs_canon, _, _ = ct.canonicalize(np.asarray([gs_label], dtype=np.int64))
        gs_canon = int(gs_canon[0])
        labels = grow_basis_vrnl(gen, ct, initial_labels, depth,
                                 conserve_lst, val_lst)
        labels = labels[labels != gs_canon]  # basis.remove(gs), model.cc:570

        s = VrnlSector()
        s.labels = labels
        s.dim = int(labels.size)
        s.momentum = np.asarray(momentum, dtype=np.float64)
        s.gs_label = gs_canon
        s.gs_momentum = np.asarray(momentum_gs, dtype=np.float64)
        s.gs_omega = ct.omega_g(gs_canon)
        # gs only participates at its own momentum (src/model.cc:601-612)
        dk = np.mod(s.momentum - s.gs_momentum + 1e-10, 1.0)
        dk = np.minimum(dk, 1.0 - dk)
        s.gs_norm = float(s.gs_omega) if np.linalg.norm(dk) < 1e-8 else 0.0
        self.sec_vrnl[sec] = s
        return s.dim

    def generate_Ham_sparse_vrnl(self, sec: int = 0):
        """Build the vrnl-sector matrix skeleton (once per basis and H) and
        the device matvec at the sector momentum; also computes the
        variational GS energy (cf. generate_Ham_sparse_vrnl,
        src/model.cc:838-924)."""
        ct = self.center_translator
        s = self.sec_vrnl[sec]
        key = (s.labels.tobytes(), id(self.compiled_Ham))
        if self._vrnl_skel is None or self._vrnl_skel[0] != key:
            self._vrnl_skel = (key, VrnlMatrix(self.compiled_Ham, ct, s.labels))
        s.vmat = self._vrnl_skel[1]
        s.matvec = MatvecVrnl(s.vmat, s.momentum)

        # variational ground-state energy (src/model.cc:865-888)
        if s.gs_E0 is None:
            gs = np.asarray([s.gs_label], dtype=np.int64)
            e0 = 0.0
            if not self.compiled_Ham.diag_terms.q_zero():
                ev = compile_diagonal(self.compiled_Ham.diag_terms, self.space)
                e0 += float(np.asarray(ev(self.space.decode(gs)))[0])
            cells = self.lattice.Nsites / self.lattice.num_sub
            k = torch.as_tensor(s.gs_momentum, device=self.device)
            for _, amp, canon, disp in _images_canon(
                    self.compiled_Ham, ct, torch.as_tensor(gs,
                                                           device=self.device)):
                hit = canon[0] == s.gs_label
                ang = 2.0 * np.pi * (disp[0].to(torch.float64) @ k)
                coeff = (float(s.gs_omega) / cells) * amp[0] * torch.exp(1j * ang)
                e0 += float(torch.where(hit, coeff, 0.0).sum().real)
            s.gs_E0 = e0
        return s.matvec

    def dim_vrnl(self, sec: int = 0) -> int:
        return self.sec_vrnl[sec].dim

    def _locate_E0_vrnl(self, nev, ncv, maxit, sec, seed):
        """Dense ``eigh`` on the host up to ``_DENSE_CUTOFF`` rows (the JAX
        package's gauge of the eigenvectors), else thick-restart Lanczos on
        the sector's :class:`MatvecVrnl`."""
        s = self.sec_vrnl[sec]
        if s.matvec is None:
            self.generate_Ham_sparse_vrnl(sec)
        if s.dim <= _DENSE_CUTOFF:
            evals, evecs = np.linalg.eigh(s.vmat.at_momentum(s.momentum))
            vecs = [torch.as_tensor(evecs[:, i].copy(), device=self.device)
                    for i in range(min(max(nev, ncv, 1), s.dim))]
            evals = evals[: max(nev, 1)].tolist()
        else:
            evals, vecs = eigs_smallest(
                s.matvec, s.dim, nev=nev, ncv=max(12, 2 * nev + 6),
                maxit=maxit, seed=seed, complex_vec=True)
        self.eigenvals_vrnl = list(evals)
        self.eigenvecs_vrnl = vecs
        s.evals, s.evecs = list(evals), list(vecs)

    def moprXgs_vrnl(self, Bq, sec: int = 0) -> torch.Tensor:
        """B_q |gs> expressed over the vrnl basis (cf. src/model.cc:1915-1984)."""
        return mopr_x_gs_vrnl(self._coerce_mopr(Bq), self.sec_vrnl[sec],
                              self.center_translator)

    def moprXvec_vrnl(self, Bq, sec_old: int, sec_new: int, x):
        """(y, pG): B_q applied to a vrnl-sector vector (src/model.cc:1987-2074)."""
        return mopr_x_vec_vrnl(self._coerce_mopr(Bq), self.sec_vrnl[sec_old],
                               self.sec_vrnl[sec_new], self.center_translator, x)

    def measure_vrnl_static(self, lhs, sec: int = 0, which: int = 0) -> complex:
        """<phi|lhs|phi> over a vrnl eigenvector (src/model.cc:2077-2129)."""
        s = self.sec_vrnl[sec]
        return measure_vrnl_static(self._coerce_mopr(lhs), s,
                                   self.center_translator, s.evecs[which])

    def measure_vrnl_dynamic(self, Bq, sec: int, m_steps: int):
        """Continued-fraction data for the vrnl sector: |v> = B_q|gs>,
        returns (norm, alphas, betas) (cf. src/model.cc:2131-2143); a B_q
        that leaves nothing in the basis gives (0.0, empty, empty)."""
        s = self.sec_vrnl[sec]
        if s.matvec is None:
            self.generate_Ham_sparse_vrnl(sec)
        v = self.moprXgs_vrnl(Bq, sec)
        nrm = float(torch.linalg.vector_norm(v))
        if nrm < 1e-12:
            return 0.0, np.zeros(0), np.zeros(0)
        alphas, betas = lanczos_dynamics(s.matvec, v / nrm, m_steps)
        return nrm, alphas, betas

    def wannier_mat_vrnl(self, Ar_list, momenta_list, locate_state,
                         sec: int = 0, nev: int = 8):
        """mu[k1, k2] = <phi(k1)| B_{k1-k2} |phi(k2)> over a k-grid.

        cf. model::WannierMat_vrnl (src/model.cc:2145-2310): per momentum the
        vrnl matrix is re-phased (O(nnz), no basis rebuild), diagonalized on
        the host, a band state selected by ``locate_state(model, idx)``; then
        the overlap matrix with B_q built from ``Ar_list`` =
        [(r_i, A_{r_i}), ...] with Hermitian completion. With checkpointing
        on, each momentum's eigenpairs are a record (the reference's
        eigenvecs_[k].dat files, src/model.cc:2163-2187) under a key that
        carries the CRC32 of the skeleton: a record written by either package
        loads in the other.
        """
        import zlib

        s = self.sec_vrnl[sec]
        if s.vmat is None:
            self.generate_Ham_sparse_vrnl(sec)
        momenta = [np.asarray(k, dtype=np.float64) for k in momenta_list]
        nk = len(momenta)
        store = ckpt.active_store()
        # content fingerprint of the vrnl Hamiltonian: a stale out_Qckpt/
        # from a run with different couplings (same dim/sec/k) is ignored
        fp = 0
        for arr in (s.vmat.rows, s.vmat.cols, s.vmat.amp_re, s.vmat.amp_im,
                    s.vmat.disp, s.vmat.diag):
            fp = zlib.crc32(np.ascontiguousarray(arr).tobytes(), fp)

        band: list[np.ndarray] = []
        base_momentum = s.momentum
        for idx, k in enumerate(momenta):
            ckey = ("wannier_vrnl_sec%d_dim%d_h%08x_k%s"
                    % (sec, s.dim, fp, "_".join(f"{v:+.6f}" for v in k)))
            rec = store.load(ckey) if store is not None else None
            if rec is not None and rec["evecs"].shape[0] == s.dim:
                evals, evecs = rec["evals"], rec["evecs"]
            else:
                evals, evecs = np.linalg.eigh(s.vmat.at_momentum(k))
                if store is not None:
                    store.save(ckey, {"evals": evals, "evecs": evecs})
            s.momentum = k
            s.evals = evals[:nev].tolist()
            s.evecs = [torch.as_tensor(evecs[:, i].copy(), device=self.device)
                       for i in range(min(nev, s.dim))]
            which = int(locate_state(self, idx))
            band.append(evecs[:, which].copy())
        mu = np.zeros((nk, nk), dtype=np.complex128)
        for i1 in range(nk):
            for i2 in range(i1, nk):
                q = momenta[i1] - momenta[i2]
                Bq = Mopr()
                for r, A in Ar_list:
                    phase = np.exp(2j * np.pi * float(np.dot(q, np.asarray(r))))
                    Bq += complex(phase) * self._coerce_mopr(A)
                s.momentum = momenta[i2]
                y, _ = self.moprXvec_vrnl(Bq, sec, sec, band[i2])
                mu[i1, i2] = np.vdot(band[i1], y.cpu().numpy())
                mu[i2, i1] = np.conj(mu[i1, i2])
        s.momentum = base_momentum
        return mu

    # ------------------------------------------- full <-> momentum vectors

    def _repr_to_full(self, sector, c, fs=None):
        """Expand repr coefficients to the full label space:
        |psi> = sum_r c_r |r,k> with |r,k> = P_k|r>/sqrt(nu_r), built as P_k
        applied to the seed vector (c_r/sqrt(nu_r)) at the representative
        labels (the inverse of ``ReprBasis.from_full``). ``fs``: the
        sector's P_k engine to project with; by default one the sector has
        already built (either precision: the projection runs in complex128
        whatever the engine's type), else the float64 one."""
        if fs is None:
            fs = next((op for op in sector._fsrepr_cache.values()
                       if op is not None), None)
        if fs is None:
            fs = self._fullspace_repr_op(sector)
        if fs is None:
            raise ValueError("this sector has no full-label-space engine")
        rb = sector.dbasis
        seed = torch.zeros(fs.N, dtype=torch.complex128, device=self.device)
        idx = rb.labels_b.reshape(-1)[: rb.n]
        seed[idx] = (torch.as_tensor(c, device=self.device).to(
            torch.complex128) / rb.sqrt_nu[: rb.n])
        return fs.project(seed)

    @staticmethod
    def _host_vec(x):
        return (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x))

    def transform_vec_full(self, plan, sec: int, x):
        """y = U(plan) x with U|i> = sgn |plan(i)>: the permutation action on
        a sector vector incl. fermion parity (cf. model::transform_vec_full,
        src/model.cc:1550-1600). Host code: ``x`` a numpy array or a tensor
        (complex ok), the result a numpy array; the transformed state must
        stay in the sector."""
        s = self.sec_full[sec]
        x = self._host_vec(x)
        new_labels, parity = self.space.transform(s.labels, np.asarray(plan))
        j = np.searchsorted(s.labels, new_labels)
        j = np.clip(j, 0, max(s.dim - 1, 0))
        if not np.all(s.labels[j] == new_labels):
            raise ValueError("plan maps some states out of the sector")
        sign = 1.0 - 2.0 * parity.astype(np.float64)
        y = np.zeros(s.dim, dtype=np.promote_types(x.dtype, np.float64))
        y[j] = sign * x
        return y

    def projectQ_full(self, momentum, sec: int, x, check: bool = True):
        """P_k x with P_k = (1/G) sum_R e^{+2 pi i k.R} T(R): the momentum
        projector in the full basis (cf. model::projectQ_full,
        src/model.cc:1602-1660, incl. its momentum-eigenvector self-check).
        ``momentum`` is integer per pbc dimension; returns complex numpy.
        """
        s = self.sec_full[sec]
        x = self._host_vec(x).astype(np.complex128)
        disps, plans = self.lattice.translation_group()
        m = np.asarray(momentum, dtype=np.float64)
        L = np.asarray(self.lattice.L, dtype=np.float64)
        kfrac = np.zeros(self.lattice.dim)
        kfrac[: m.size] = m / L[: m.size]
        y = np.zeros(s.dim, dtype=np.complex128)
        for disp, plan in zip(disps, plans):
            phase = np.exp(2j * np.pi * float(np.dot(kfrac, disp)))
            y += phase * self.transform_vec_full(plan, sec, x)
        y /= len(plans)
        if check and np.linalg.norm(y) > 1e-12:
            # verify momentum eigenvector under each unit translation
            # (reference self-check, src/model.cc:1634-1650)
            for d in range(self.lattice.dim):
                if self.lattice.bc[d] != "pbc":
                    continue
                e = np.zeros(self.lattice.dim, dtype=np.int64)
                e[d] = 1
                ty = self.transform_vec_full(
                    self.lattice.translation_plan(e), sec, y)
                want = np.exp(-2j * np.pi * kfrac[d]) * y
                err = np.linalg.norm(ty - want) / np.linalg.norm(y)
                if err >= 1e-9:
                    raise AssertionError(
                        f"projectQ: not a k-eigenvector (d={d}, {err:.2e})")
        return y
