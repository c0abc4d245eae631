"""Chebyshev machinery: KPM moments and filtered interior eigensolving.

Port of ``quantum_basis_tpu.solvers.chebyshev``. Two capabilities built on
the same rescaled-H Chebyshev recurrence:

- :func:`kpm_moments` — operator-resolved kernel polynomial method moments
  mu_n = <v| T_n(Hs) |v> for spectral densities. The reference only
  implements the spectral-bounds step (``energy_scale``, src/kpm.cc:45-99)
  with no moment loop; this completes it.
- :func:`eigs_window` — interior eigenpairs in [E_lo, E_hi], replacing the
  reference's MKL FEAST dependency (``call_feast``, src/lanczos.cc:605-652):
  each subspace iteration applies a Chebyshev bandpass filter polynomial of
  H (applies only, no factorization), then Rayleigh-Ritz in the filtered
  subspace — the standard filtered subspace iteration [Zhou & Saad].

Operators are callables ``y = op(x)`` on 1-d float64/complex128 tensors. An
operator of lower precision (the float32 BSR kernel) returns its own type;
the recurrence casts every apply back to the vector's type, so the vectors
and the moments stay in float64. The recurrence is a Python loop of applies
whose moments stay on the device and reach the host once per call.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.solvers.lanczos import energy_scale
from quantum_basis_tpu_torch.utils.rng import vec_randomize


def _rescale(e_min, e_max):
    """H -> Hs = (H - c)/d with spectrum in [-1, 1]."""
    c = 0.5 * (e_max + e_min)
    d = 0.5 * (e_max - e_min)
    return c, d


def _rescaled(op, c, d):
    """x -> Hs x = (H x - c x) / d in the precision of x."""
    inv_d = 1.0 / d

    def hs(x):
        return torch.sub(op(x).to(x.dtype), x, alpha=c).mul_(inv_d)

    return hs


def _cheb_apply(op, c, d, coeff, x):
    """y = sum_n coeff_n T_n(Hs) x via the three-term recurrence."""
    hs = _rescaled(op, c, d)
    t_prev = x                      # T_0 x
    t_cur = hs(x)                   # T_1 x
    y = float(coeff[0]) * t_prev + float(coeff[1]) * t_cur
    for cn in coeff[2:]:
        t_prev, t_cur = t_cur, hs(t_cur).mul_(2.0).sub_(t_prev)
        y.add_(t_cur, alpha=float(cn))
    return y


def kpm_moments(matvec, v0, n_moments: int, bounds=None, slack: float = 0.05):
    """KPM moments mu_n = <v0| T_n(Hs) |v0> for n < n_moments.

    ``bounds`` = (e_min, e_max) or None (estimated via energy_scale).
    Returns (mu (n_moments,) float64 numpy, e_min, e_max). Use with a
    Jackson kernel to reconstruct spectral densities.
    """
    if bounds is None:
        e_min, e_max = energy_scale(matvec, v0, slack=slack)
    else:
        e_min, e_max = bounds
    c, d = _rescale(e_min, e_max)
    hs = _rescaled(matvec, c, d)
    x = v0 / torch.linalg.vector_norm(v0)
    t_prev = x
    t_cur = hs(x)
    mus = [torch.vdot(x, t_prev).real, torch.vdot(x, t_cur).real]
    for _ in range(n_moments - 2):
        t_prev, t_cur = t_cur, hs(t_cur).mul_(2.0).sub_(t_prev)
        mus.append(torch.vdot(x, t_cur).real)
    mu = torch.stack(mus).cpu().numpy().astype(np.float64)
    return mu[:n_moments], e_min, e_max


def jackson_kernel(n_moments: int) -> np.ndarray:
    """Jackson damping factors g_n (standard KPM kernel)."""
    n = np.arange(n_moments)
    N = n_moments + 1
    return ((N - n) * np.cos(np.pi * n / N)
            + np.sin(np.pi * n / N) / np.tan(np.pi / N)) / N


def _chebyshev_series(mu, g, e_min, e_max, energies) -> np.ndarray:
    """sum_n (2 - delta_n0) g_n mu_n T_n(x) / (pi sqrt(1 - x^2) d) at the
    rescaled energies x: the damped KPM reconstruction."""
    c, d = _rescale(e_min, e_max)
    x = np.clip((np.asarray(energies, dtype=np.float64) - c) / d,
                -1 + 1e-12, 1 - 1e-12)
    theta = np.arccos(x)
    out = g[0] * mu[0] * np.ones_like(x)
    for n in range(1, mu.size):
        out += 2.0 * g[n] * mu[n] * np.cos(n * theta)
    return out / (np.pi * np.sqrt(1.0 - x * x) * d)


def kpm_density(mu: np.ndarray, e_min: float, e_max: float,
                energies: np.ndarray) -> np.ndarray:
    """Reconstruct the spectral density from KPM moments (Jackson kernel)."""
    return _chebyshev_series(mu, jackson_kernel(mu.size), e_min, e_max,
                             energies)


def _window_filter_coeffs(a, b, degree, e_min, e_max):
    """Chebyshev expansion of the indicator of [a, b] (Jackson-damped)."""
    c, d = _rescale(e_min, e_max)
    lo, hi = (a - c) / d, (b - c) / d
    lo, hi = max(lo, -1.0), min(hi, 1.0)
    coeff = np.empty(degree)
    coeff[0] = (np.arccos(lo) - np.arccos(hi)) / np.pi
    tl, th = np.arccos(lo), np.arccos(hi)
    for k in range(1, degree):
        coeff[k] = 2.0 * (np.sin(k * tl) - np.sin(k * th)) / (np.pi * k)
    return coeff * jackson_kernel(degree)


def _random_vec(n, seed, complex_vec, device):
    re, im = vec_randomize(n, seed=seed, complex_valued=complex_vec)
    return torch.as_tensor(re + 1j * im if complex_vec else re, device=device)


def eigs_window(matvec, n, e_lo, e_hi, nev_max=10, degree=200, n_iter=30,
                tol=1e-9, seed=7, complex_vec=False, bounds=None):
    """Interior eigenpairs with eigenvalues in [e_lo, e_hi].

    Chebyshev-filtered subspace iteration — the FEAST replacement
    (reference: call_feast, src/lanczos.cc:605-652; locate_Es_feast,
    src/model.cc:1424-1466). Returns (evals list, evecs list of 1-d
    tensors), only those inside the window, ascending. The seeds, the
    eigenvalue-count estimate and the subspace size are the JAX package's,
    so the same window gives the same eigenpairs.
    """
    dev = matvec.device
    if bounds is None:
        e_min, e_max = energy_scale(
            matvec, _random_vec(n, seed + 1, complex_vec, dev), slack=0.1)
    else:
        e_min, e_max = bounds
    c, d = _rescale(e_min, e_max)
    coeff = _window_filter_coeffs(e_lo, e_hi, degree, e_min, e_max)

    def cheb(x):
        return _cheb_apply(matvec, c, d, coeff, x)

    # stochastic estimate of the eigenvalue count in the window (the same
    # idea FEAST uses to size its subspace): E[<z|f(H)|z>] = tr f(H) / n
    # for unit random z; tr f(H) ~ #eigenvalues inside.
    est = 0.0
    n_probe = 4
    for i in range(n_probe):
        z = _random_vec(n, seed + 977 * (i + 1), complex_vec, dev)
        est += float(torch.vdot(z, cheb(z)).real) * n / n_probe
    if est > 1.3 * nev_max + 2:
        raise ValueError(
            f"window [{e_lo}, {e_hi}] holds ~{est:.0f} eigenvalues; raise "
            f"nev_max (= {nev_max}) or shrink the window")

    m_sub = int(min(max(2 * nev_max, nev_max + 4), n))
    V = torch.stack([_random_vec(n, seed + 10 * i + 3, complex_vec, dev)
                     for i in range(m_sub)])                   # (m, N)

    prev = None
    for _ in range(n_iter):
        # filter, then orthonormalize (modified Gram-Schmidt, dropping
        # vectors the filter has made linearly dependent)
        ortho = []
        for v in (cheb(v) for v in V):
            for u in ortho:
                v = v - torch.vdot(u, v) * u
            nrm = float(torch.linalg.vector_norm(v))
            if nrm > 1e-12:
                ortho.append(v / nrm)
        if not ortho:
            return [], []
        V = torch.stack(ortho)
        # Rayleigh-Ritz with H: A = V^H (H V), the basis stacked as rows
        HV = torch.stack([matvec(v).to(V.dtype) for v in V])
        A = (V.conj() @ HV.T).cpu().numpy()
        theta, S = np.linalg.eigh((A + A.conj().T) / 2)
        # rotate the basis to the Ritz vectors: row k = sum_i S[i, k] V[i]
        St = torch.as_tensor(S.T if complex_vec else S.T.real, device=dev)
        V = St.to(V.dtype) @ V
        inside = [(t, i) for i, t in enumerate(theta)
                  if e_lo - 1e-9 <= t <= e_hi + 1e-9]
        if prev is not None and len(inside) == len(prev):
            deltas = [abs(t - p) for (t, _), p in zip(inside, prev)]
            if deltas and max(deltas) < tol:
                # converged: residual check on the inside set
                out_vals, out_vecs = [], []
                for t, i in inside[:nev_max]:
                    v = V[i]
                    r = matvec(v).to(v.dtype) - t * v
                    if float(torch.linalg.vector_norm(r)) < max(1e-6,
                                                                1e3 * tol):
                        out_vals.append(float(t))
                        out_vecs.append(v.clone())
                return out_vals, out_vecs
        prev = [t for t, _ in inside]
    raise RuntimeError("Chebyshev-filtered subspace iteration did not converge")
