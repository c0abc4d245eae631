"""Model orchestration: orbitals + Hamiltonian -> momentum sectors, E0, <O>.

Port of the momentum-sector ground-state route of
``quantum_basis_tpu.models.model.Model`` (the reference's ``model<T>``,
src/model.cc), with the same user-facing flow:

    m = Model(lattice, device="cuda")
    m.add_orbital(lattice.n_sites, "spin-1/2")
    m.add_Ham(...)                               # symbolic Mopr algebra
    m.enumerate_basis_repr([0], [Sz], [0.0])
    m.locate_E0_lanczos(which="repr")            # -> m.eigenvals_repr
    m.measure_repr_static(Sz0 * Sz1, 0)

Every device object lives on ``device``; nothing moves to another device
when that one is missing. A sector at or below ``_DENSE_CUTOFF`` rows is
solved densely on the host. Larger sectors take the explicit-sparse route:
the f32 bulk Krylov stage on the BSR kernel (ops/bsr.py) with an f64
Rayleigh-quotient polish on the ELL matrix when ``_repr_bsr32`` routes the
sector there, else thick-restart Lanczos on the f64 ELL. The full-sector
methods and the projected full-space engine are not ported yet.
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
from quantum_basis_tpu_torch.ops.apply_repr import MatvecRepr, ReprBasis
from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats, ell_to_bsr
from quantum_basis_tpu_torch.ops.compile import compile_operator
from quantum_basis_tpu_torch.ops.operators import Mopr, Opr, OprProd
from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr
from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
from quantum_basis_tpu_torch.solvers.rqi import rqi_polish

_DENSE_CUTOFF = 600  # sectors at/below this size are solved densely on host


class Sector:
    """One quantum-number + momentum sector: basis, matvec, eigenpairs."""

    def __init__(self):
        self.labels: np.ndarray | None = None
        self.dbasis: ReprBasis | None = None
        self.matvec = None
        self.dim = 0
        self.momentum = None
        self.evals: list = []
        self.evecs: list = []
        self.ell = None       # explicit f64 ELL, built on first solve
        self.bsr32 = None     # f32 BsrMatrix when routed to the kernel
        self._routed = False  # _repr_bsr32 has decided
        self.spmv = None      # f64 engine of the pure-Krylov route


class Model:
    def __init__(self, lattice=None, device="cuda"):
        """``device``: where every basis table, matrix and vector lives."""
        self.lattice = lattice
        self.device = torch.device(device)
        self._orbitals: list[tuple[SiteBasis, int]] = []
        self._space: StateSpace | None = None
        self.Ham = Mopr()
        self._compiled = None
        self.sec_repr: dict[int, Sector] = {}
        self.eigenvals_repr: list[float] = []
        self.eigenvecs_repr: list = []
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

    def locate_E0_lanczos(self, which: str = "repr", nev: int = 1,
                          ncv: int = 1, maxit: int = 2000, sec: int = 0,
                          seed: int = 1):
        """Ground state (and optionally E1) of a momentum sector.

        cf. model::locate_E0_lanczos (src/model.cc:1123-1316). ``nev`` =
        energies wanted, ``ncv`` = vectors kept. Only ``which="repr"`` is
        ported.
        """
        if which != "repr":
            raise NotImplementedError(f"which={which!r} is not ported yet")
        if config.enable_ckpt:
            raise NotImplementedError("checkpointing is not ported yet")
        return self._locate_E0_lanczos_repr(nev, ncv, maxit, sec, seed)

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
        self.eigenvals_repr = list(evals[:nev])
        self.eigenvecs_repr = list(vecs[:max(ncv, 1)])
        sector.evals, sector.evecs = list(evals), list(vecs)

    def _repr_ell(self, sector):
        """Explicit f64 ELL for a momentum sector, built once per sector."""
        if sector.ell is None:
            sector.ell = build_sparse_repr(sector.matvec)
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
