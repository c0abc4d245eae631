"""Kernel polynomial method: stochastic-trace Chebyshev moments and DOS.

Port of ``quantum_basis_tpu.solvers.kpm``. The reference's kpm.cc contains
only the spectral-bounds step (``energy_scale``, src/kpm.cc:45-99) — no
moment loop. This module supplies the density-of-states KPM on top of the
same bounds: stochastic-trace Chebyshev moments with the doubling trick (two
moments per apply) and density-of-states reconstruction with the Jackson
kernel of :mod:`quantum_basis_tpu_torch.solvers.chebyshev` (one definition
serves both modules). The recurrence is applies and BLAS-1 on the device,
so every engine (full-space, ELL, BSR, matrix-free) plugs in.
"""

from __future__ import annotations

import numpy as np
import torch

from quantum_basis_tpu_torch.solvers.chebyshev import (
    _chebyshev_series,
    _rescale,
    _rescaled,
    jackson_kernel,
)
from quantum_basis_tpu_torch.utils.rng import vec_randomize

__all__ = ["kpm_moments", "jackson_kernel", "kpm_dos"]


def kpm_moments(matvec, n: int, n_moments: int, e_bounds, n_random: int = 8,
                seed: int = 3, complex_vec: bool = False,
                mask=None) -> np.ndarray:
    """mu[m] ~ Tr T_m(H~) / n by stochastic trace estimation.

    ``e_bounds = (e_min, e_max)`` rescales H to [-1, 1] (use
    solvers.lanczos.energy_scale, the reference's spectral-bounds step).
    With the doubling trick each apply yields two moments:
    mu_{2k} = 2 <t_k|t_k> - mu_0, mu_{2k+1} = 2 <t_{k+1}|t_k> - mu_1.
    ``mask`` (numpy array or tensor of 0/1) restricts the random vectors to
    a sector (full-space engine). The random vectors are the JAX package's.
    """
    hs = _rescaled(matvec, *_rescale(float(e_bounds[0]), float(e_bounds[1])))
    half = (n_moments + 2) // 2
    mnp = None
    if mask is not None:
        mnp = (mask.detach().cpu().numpy() if isinstance(mask, torch.Tensor)
               else np.asarray(mask))
    acc = np.zeros(2 * half + 2)
    for r_i in range(n_random):
        re, im = vec_randomize(n, seed=seed + 17 * r_i,
                               complex_valued=complex_vec)
        if mnp is not None:
            re = re * mnp
            nrm = np.linalg.norm(re) if im is None else np.sqrt(
                np.sum(re * re) + np.sum((im * mnp) ** 2))
            re = re / max(nrm, 1e-300)
            im = None if im is None else im * mnp / max(nrm, 1e-300)
        t0 = torch.as_tensor(re if im is None else re + 1j * im,
                             device=matvec.device)
        t1 = hs(t0)
        mu0 = torch.vdot(t0, t0).real
        mu1 = torch.vdot(t1, t0).real
        evens, odds = [], []
        t_prev, t_cur = t0, t1
        for _ in range(half):
            t_next = hs(t_cur).mul_(2.0).sub_(t_prev)
            evens.append(torch.vdot(t_cur, t_cur).real)
            odds.append(torch.vdot(t_next, t_cur).real)
            t_prev, t_cur = t_cur, t_next
        mu0, mu1 = float(mu0), float(mu1)
        acc[0] += mu0
        acc[1] += mu1
        acc[2: 2 + 2 * half: 2] += 2.0 * torch.stack(evens).cpu().numpy() - mu0
        acc[3: 3 + 2 * half: 2] += 2.0 * torch.stack(odds).cpu().numpy() - mu1
    return acc[:n_moments] / n_random


def kpm_dos(moments: np.ndarray, energies, e_bounds,
            kernel: str = "jackson") -> np.ndarray:
    """Density of states rho(E) reconstructed from KPM moments (per state:
    integrates to 1 over the spectrum); ``kernel`` "jackson" damps them,
    anything else leaves them undamped."""
    N = moments.size
    g = jackson_kernel(N) if kernel == "jackson" else np.ones(N)
    return _chebyshev_series(moments, g, float(e_bounds[0]),
                             float(e_bounds[1]), energies)
