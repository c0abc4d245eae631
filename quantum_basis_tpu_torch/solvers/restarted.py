"""Thick-restart Lanczos with full reorthogonalization (ARPACK-NG replacement,
reference: src/lanczos.cc:393-603 ``iram``/``call_arpack``).

Port of ``quantum_basis_tpu.solvers.restarted.eigs_smallest``. A fixed-size
device basis V (ncv+1, n) of complex (or real) vectors of the operator's
working precision; each step does CGS2 reorthogonalization (twice V^H w and
w - V^T h), so the projected Rayleigh matrix is exact; at each restart the
best ``keep`` Ritz vectors are compacted in place, [S^T V ; v_m], and the
iteration continues thick-restarted [Wu & Simon, SIAM J. Matrix Anal.
22(2)]. Both run in ops/krylov.py (K6): fused CUDA kernels on the card,
their plain versions on the CPU. Degenerate levels are recovered by a
deflate-and-verify pass.

Operators are callables ``y = op(x)`` on 1-d tensors with attributes
``dtype`` (float32 or float64: the working precision), ``device`` and
``is_complex``. A full-label-space solve passes the 0/1 sector ``mask``:
every start vector and every injected restart vector is multiplied by it on
the device and renormalized, so that no out-of-sector noise enters the
Krylov space. An operator with a ``project(x)`` method (the projected
momentum engines: quantum-number mask, then P_k, then renormalise) is asked
instead, and its projection takes precedence over ``mask``; it runs on the
device, on the float64 start vector before that is cast to the working
precision, like the JAX package's host-side hook.

An operator that carries a basis ``mesh`` (the sharded engines of
parallel/*) is applied to this rank's slice of each vector; the inner
products and norms are summed over the ranks (solvers/reduce.py), and the
start and restart vectors are the global ones, generated on every rank and
sliced, so a P-rank solve starts where the single-device one does.

With ``ckpt_key`` set and ``config.enable_ckpt`` on, the restart-boundary
state (basis, projected matrix, counters) is saved at most every
``_SAVE_PERIOD`` seconds and restored on re-entry: the reference's
Lanczos-step-level checkpointing (src/ckpt.cc:13-340) at restart granularity.
On a mesh the record holds the whole (ncv+1, n) basis, gathered on rank 0,
and each rank resumes from its own slice (solvers/reduce.py GroupStore).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import config
from quantum_basis_tpu_torch.ops import krylov
from quantum_basis_tpu_torch.solvers.reduce import (
    ckpt_store,
    dot,
    mesh_of,
    norm,
    span_of,
)
from quantum_basis_tpu_torch.utils import ckpt
from quantum_basis_tpu_torch.utils.rng import vec_randomize

_BREAKDOWN = 1e-13
# Seconds between two restart-boundary saves: a save copies the whole basis
# to the host and writes it out, so it is spaced; a crash then loses at most
# this much progress plus one restart cycle. The JAX package's value.
_SAVE_PERIOD = 60.0


def _vec_dtype(real_dtype, complex_vec: bool):
    if not complex_vec:
        return real_dtype
    return torch.complex64 if real_dtype == torch.float32 else torch.complex128


def _project_out(w, deflate, mesh=None):
    """w - sum_d <d, w> d."""
    for d in deflate:
        w = w - dot(d, w, mesh) * d
    return w


class DeflatedMatvec:
    """P H P + sigma (I - P) with P projecting out the given eigenvectors.

    Spectrum = original spectrum minus the deflated copies, plus ``sigma`` on
    the deflated span; ``sigma`` is chosen on the far side of the search
    window (cf. the reference's fake_pos diagonal, src/model.cc:723-727).
    """

    def __init__(self, base, vecs, sigma: float):
        self.base = base
        self.vecs = list(vecs)
        self.sigma = float(sigma)
        self.dtype = base.dtype
        self.device = base.device
        self.is_complex = base.is_complex
        self.mesh = mesh_of(base)
        self.span = getattr(base, "span", None)
        # forward the sector projection, so that the restarts of the
        # deflate-and-verify pass stay inside the sector
        if getattr(base, "project", None) is not None:
            self.project = base.project

    def __call__(self, x):
        px = _project_out(x, self.vecs, self.mesh)
        y = _project_out(self.base(px).to(x.dtype), self.vecs, self.mesh)
        return y + self.sigma * (x - px)


class _Krylov:
    """The basis-buffer operations of one solve (CGS2 steps, compaction),
    on the kernels of ops/krylov.py (their plain versions on the CPU)."""

    def __init__(self, matvec, n, ncv, complex_vec):
        self.matvec = matvec
        self.mesh = mesh_of(matvec)
        self.rows = ncv + 1
        self.dtype = _vec_dtype(matvec.dtype, complex_vec)
        lo, hi = span_of(matvec, n)
        dev = matvec.device
        self.V = torch.zeros((self.rows, hi - lo), dtype=self.dtype,
                             device=dev)
        self.ws = krylov.Workspace(self.rows, hi - lo, self.dtype, dev,
                                   self.mesh)
        # the projection columns and betas of the steps, written in place
        # by every expand (entries no step of a call writes are zeroed on
        # the host)
        self.H = torch.zeros((self.rows, self.rows), dtype=self.dtype,
                             device=dev)
        self.bvec = torch.zeros(self.rows, dtype=self.V.real.dtype,
                                device=dev)

    def expand(self, m0, ncv):
        """Steps m0..ncv-1 with no host sync: returns the projection columns
        H (rows, rows) and the betas (rows,), both on the host. A breakdown
        (beta <= 1e-13) zeroes the next vector, so later columns are zeros."""
        for j in range(m0, ncv):
            y = self.matvec(self.V[j]).to(self.dtype)
            krylov.cgs2(self.V, j + 1, y, j + 1, self.ws,
                        h_out=self.H[: j + 1, j],
                        beta_out=self.bvec[j: j + 1])
        H = self.H.cpu().numpy().astype(np.complex128)
        bvec = self.bvec.cpu().numpy().astype(np.float64)
        H[:, :m0] = 0.0     # an earlier call's columns
        bvec[:m0] = 0.0
        return H, bvec

    def insert_random(self, r, j, row):
        """Orthogonalize r (the basis' type, on its device) against rows
        0..j, normalize, put it at ``row``; returns its norm."""
        krylov.cgs2(self.V, j + 1, r, row, self.ws, zero_breakdown=False)
        return float(self.ws.beta[0])

    def compact(self, S, m):
        """Thick restart: rows <- [S^T V ; v_m] for S (rows, keep) whose
        rows from m on are zero; returns the new rows 0..keep-1."""
        if np.any(S[m:]):
            raise ValueError("compact: S has nonzero rows past m")
        Sd = torch.as_tensor(np.ascontiguousarray(
            S[:m], dtype=_NP_DTYPES[self.dtype]), device=self.V.device)
        return krylov.krylov_compact(self.V, Sd, m)


_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64,
              torch.complex64: np.complex64, torch.complex128: np.complex128}


def _host_vec(re, im, complex_vec):
    return re + 1j * im if complex_vec else re


def _masked(x, mask, mesh=None):
    """x restricted to the sector support and renormalized (x when no mask)."""
    if mask is None:
        return x
    x = x * mask.to(x.real.dtype)
    return x / torch.clamp(norm(x, mesh), min=1e-300)


def _projected(matvec, x, mask):
    """x inside the sector and renormalized: by the operator's own
    ``project`` (the momentum engines) when it has one, else by the mask."""
    project = getattr(matvec, "project", None)
    return (project(x) if project is not None
            else _masked(x, mask, mesh_of(matvec)))


def _random_start(matvec, n, seed, complex_vec, device):
    """This rank's slice of the global length-n random start vector."""
    lo, hi = span_of(matvec, n)
    re, im = vec_randomize(n, seed=seed, complex_valued=complex_vec)
    return torch.as_tensor(_host_vec(re[lo:hi], im[lo:hi] if complex_vec
                                     else None, complex_vec), device=device)


def _solver_log(purpose, it, theta, resid):
    """Per-restart convergence line (reference: log_Lanczos_<purpose>.txt,
    src/lanczos.cc:102-128); enabled by config.solver_log_dir."""
    if not config.solver_log_dir:
        return
    os.makedirs(config.solver_log_dir, exist_ok=True)
    path = os.path.join(config.solver_log_dir, f"log_{purpose}.txt")
    with open(path, "a") as f:
        th = " ".join(f"{t:.12f}" for t in theta)
        rs = " ".join(f"{r:.3e}" for r in resid)
        stamp = time.strftime("%H:%M:%S")
        f.write(f"{stamp} [{os.getpid()}] {it:8d}  theta: {th}  resid: {rs}\n")


def eigs_smallest(matvec, n, nev=2, ncv=12, maxit=1000, tol=1e-10, seed=1,
                  complex_vec=False, which="SA", deg_tol=1e-9, ckpt_key=None,
                  mask=None, v0=None, verify_degenerate=True):
    """nev smallest ('SA') or largest ('LA') eigenpairs of a Hermitian matvec.

    Returns (eigenvalues list, eigenvectors list of 1-d tensors of the
    operator's working precision).

    After nominal convergence a deflate-and-verify pass projects out the
    converged vectors, restarts from a fresh random vector, and inserts any
    value that lands strictly inside the found window (a missed degenerate
    copy). ``verify_degenerate=False`` skips it — right when only a warm
    start is wanted (the f32 bulk stage).
    """
    vals, vecs = _eigs_core(matvec, n, nev, ncv, maxit, tol, seed,
                            complex_vec, which, ckpt_key=ckpt_key, mask=mask,
                            v0=v0)
    sgn = 1.0 if which == "SA" else -1.0
    guard = 0
    while verify_degenerate and len(vals) >= nev and guard < 8:
        guard += 1
        spread = abs(vals[-1] - vals[0])
        sigma = (max(vals) + 10.0 + 3.0 * spread) if which == "SA" else \
                (min(vals) - 10.0 - 3.0 * spread)
        dmv = DeflatedMatvec(matvec, vecs, sigma)
        extra_vals, extra_vecs = _eigs_core(
            dmv, n, 1, max(8, ncv // 2), maxit, tol, seed + 1000 + guard,
            complex_vec, which, mask=mask)
        if not extra_vals:
            break
        v_extra = extra_vals[0]
        if sgn * v_extra < sgn * vals[-1] - deg_tol:
            merged = sorted(zip(vals + [v_extra], vecs + [extra_vecs[0]]),
                            key=lambda p: sgn * p[0])[:nev]
            vals = [p[0] for p in merged]
            vecs = [p[1] for p in merged]
        else:
            break
    return vals, vecs


def _eigs_core(matvec, n, nev=2, ncv=12, maxit=1000, tol=1e-10, seed=1,
               complex_vec=False, which="SA", ckpt_key=None, mask=None,
               v0=None):
    """Thick-restart Lanczos core (single starting vector).

    A checkpoint record is accepted only when its basis has this solve's
    shape, precision and complex structure; one that does not fit is ignored
    and the solve starts from its start vector.
    """
    ncv = int(min(max(ncv, nev + 2), n))
    rows = ncv + 1
    Hm = np.zeros((rows, rows), dtype=np.complex128)
    kry = _Krylov(matvec, n, ncv, complex_vec)
    if v0 is not None:
        x = _projected(matvec, v0.to(
            device=kry.V.device, dtype=torch.complex128
            if complex_vec else torch.float64), mask)
        kry.V[0] = (x / norm(x, kry.mesh)).to(kry.dtype)
    else:
        kry.V[0] = _projected(matvec, _random_start(
            matvec, n, seed, complex_vec, kry.V.device), mask).to(kry.dtype)
    m = 0
    it = 0
    store = ckpt_store(matvec, ckpt_key)
    if store is not None:
        real_np = np.float32 if matvec.dtype == torch.float32 else np.float64
        shape = (rows, n)  # the whole basis, over every rank's slice
        rec = store.load(ckpt_key, vectors=("Vre", "Vim"), fits=lambda r: (
            r["Vre"].shape == shape and r["Vre"].dtype == real_np
            and (r["Vim"].shape == shape) == bool(complex_vec)))
        if rec is not None:
            kry.V.copy_(ckpt.join_vec(rec["Vre"], rec["Vim"], complex_vec,
                                      kry.V.device))
            Hm = rec["Hm"].astype(np.complex128)
            m = int(rec["m"])
            it = int(rec["it"])
    last_save = 0.0  # monotonic time of the last restart-boundary save
    rng_seed = seed + 101
    sort_sign = 1.0 if which == "SA" else -1.0

    while it < maxit:
        while m < ncv:
            Hr, bs = kry.expand(m, ncv)
            stop = next((j for j in range(m, ncv) if bs[j] < 1e-11), ncv)
            for j in range(m, min(stop + 1, ncv)):
                col = Hr[:, j]
                Hm[: j + 1, j] = col[: j + 1]
                Hm[j, : j + 1] = np.conj(col[: j + 1])
                b_np = bs[j] if bs[j] >= 1e-11 else 0.0
                Hm[j + 1, j] = b_np
                Hm[j, j + 1] = b_np
                it += 1
            m = min(stop + 1, ncv)
            if stop < ncv:
                # invariant subspace at step `stop`: inject a random
                # orthogonal direction and resume
                r = _projected(matvec, _random_start(
                    matvec, n, rng_seed, complex_vec, kry.V.device), mask)
                rng_seed += 7
                bnorm = kry.insert_random(r.to(kry.dtype), stop, stop + 1)
                if bnorm < _BREAKDOWN * 10 or m >= n:
                    break

        # Rayleigh-Ritz on the active m x m block
        mm = min(m, ncv)
        A = Hm[:mm, :mm]
        theta, S = np.linalg.eigh(sort_sign * (A + A.conj().T) / 2.0)
        theta = sort_sign * theta
        coup = Hm[mm, :mm] if mm < rows else np.zeros(mm)
        resid = np.abs(coup @ S)
        _solver_log("lanczos", it, theta[: min(nev, mm)],
                    resid[: min(nev, mm)])
        scale = max(np.max(np.abs(theta)), 1.0)
        nconv = 0
        for i in range(min(nev, mm)):
            if resid[i] < tol * scale:
                nconv += 1
            else:
                break
        if nconv >= nev or mm >= n:
            keep = min(nev, mm)
            Spad = np.zeros((rows, keep), dtype=np.complex128)
            Spad[:mm] = S[:, :keep]
            Y = kry.compact(Spad if complex_vec else Spad.real, m)
            if store is not None:
                store.delete(ckpt_key)
            return theta[:keep].tolist(), [Y[i].clone() for i in range(keep)]

        # thick restart: keep best `keep` Ritz vectors + current residual dir
        keep = min(nev + max(2, nev), mm - 1)
        Sk = S[:, :keep]
        Spad = np.zeros((rows, keep), dtype=np.complex128)
        Spad[:mm] = Sk
        kry.compact(Spad if complex_vec else Spad.real, m)
        Hm[:, :] = 0.0
        Hm[:keep, :keep] = np.diag(theta[:keep])
        u = coup @ Sk  # coupling of v_m to kept Ritz vectors
        Hm[keep, :keep] = np.conj(u)
        Hm[:keep, keep] = u
        m = keep
        if store is not None and store.agree(
                time.monotonic() - last_save > _SAVE_PERIOD):
            # spaced in time and capped in size (the device's
            # ckpt_max_bytes): past the cap the in-progress record is
            # skipped, so a crash redoes at most this stage
            if rows * n * kry.V.element_size() <= config.memory(
                    "ckpt_max_bytes", kry.V.device):
                vre, vim = ckpt.split_vec(store.whole(kry.V), complex_vec)
                store.save(ckpt_key, {
                    "Vre": vre,
                    "Vim": vim if complex_vec else np.zeros((1, 1)),
                    "Hm": Hm, "m": m, "it": it})
            last_save = time.monotonic()
    raise RuntimeError(f"thick-restart Lanczos failed to converge in {maxit} steps")
