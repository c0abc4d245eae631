"""Post-processing: spectral functions and plots.

Port of ``quantum_basis_tpu.postprocess`` (numpy, unchanged), the
counterpart of the reference's L10 layer (python/*.py and
examples/*/plot_*.py): Lanczos/CG convergence plots (python/lanczos_plot.py,
python/lanczos_plotCG.py), lattice plots (python/lattice_plot.py), and the
dynamical structure factor S(q, w) reconstructed from continued-fraction
coefficients (examples/trans_absent/latt_chain/plot_sqw.py) or from KPM
moments.

All plotting uses the Agg backend and writes files; nothing here touches a
display. Matplotlib is imported inside the plotting calls, so nothing at
import time needs it and compute jobs on a machine without it run.
"""

from __future__ import annotations

import numpy as np

from quantum_basis_tpu_torch.solvers.chebyshev import kpm_density
from quantum_basis_tpu_torch.utils.contfrac import greens_function


def spectral_function(omegas, norm, alphas, betas, E0: float,
                      eta: float = 0.05) -> np.ndarray:
    """S(q, w) = -Im G(w + E0 + i eta) / pi from one dynamics run.

    ``(norm, alphas, betas)`` is the output of measure_*_dynamic
    (cf. the reconstruction in examples/trans_absent/latt_chain/plot_sqw.py:
    G(z) = norm^2 / (z - a0 - b1^2 / (z - a1 - ...))).
    """
    omegas = np.asarray(omegas, dtype=np.float64)
    z = omegas + E0 + 1j * eta
    G = greens_function(z, float(norm) ** 2, np.asarray(alphas),
                        np.asarray(betas))
    return -G.imag / np.pi


def sqw_kpm(omegas, norm, mu, e_min: float, e_max: float,
            E0: float) -> np.ndarray:
    """S(q, w) reconstructed from operator-resolved KPM moments.

    ``(norm, mu, e_min, e_max)`` is the output of measure_*_dynamic_kpm:
    S(q, w) = sum_n |<n|A|0>|^2 delta(w - (E_n - E0))
            = norm^2 * rho_phi(E0 + w),
    with rho_phi the Jackson-damped KPM density of phi-hat = A|0>/norm.
    Resolution ~ pi * (e_max - e_min) / n_moments (Jackson kernel width).
    The KPM alternative to :func:`spectral_function` (continued fraction) —
    same physics, polynomially-broadened instead of Lorentzian.
    """
    omegas = np.asarray(omegas, dtype=np.float64)
    mu = np.asarray(mu, dtype=np.float64)
    if mu.size == 0 or norm == 0.0:
        return np.zeros_like(omegas)
    rho = kpm_density(mu, e_min, e_max, E0 + omegas)
    return float(norm) ** 2 * rho


def _agg_plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_sqw(q_values, runs, omegas, E0: float, path: str,
             eta: float = 0.05):
    """Heatmap of S(q, w): ``runs`` is a list of (norm, alphas, betas) per q
    (cf. plot_sqw.py). Returns the (nq, nw) array and writes ``path``."""
    omegas = np.asarray(omegas)
    S = np.stack([spectral_function(omegas, *run, E0=E0, eta=eta)
                  for run in runs])
    plt = _agg_plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    qv = np.asarray(q_values, dtype=np.float64)
    im = ax.pcolormesh(qv, omegas, S.T, shading="nearest", cmap="magma")
    fig.colorbar(im, ax=ax, label=r"$S(q,\omega)$")
    ax.set_xlabel("q")
    ax.set_ylabel(r"$\omega$")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return S


def plot_lattice(lattice, path: str, bonds: list | None = None,
                 annotate: bool = True):
    """Site scatter colored by sublattice, with optional bond segments
    (cf. python/lattice_plot.py). ``bonds`` = [(site_i, site_j), ...]."""
    plt = _agg_plt()
    pos = np.zeros((lattice.n_sites, 2))
    subs = np.zeros(lattice.n_sites, dtype=np.int64)
    for s in range(lattice.n_sites):
        p = lattice.position(s)
        pos[s, : min(2, p.size)] = p[:2]
        _, sub = lattice.site2coor(s)
        subs[s] = sub
    fig, ax = plt.subplots(figsize=(5, 5))
    if bonds:
        for i, j in bonds:
            ax.plot([pos[i, 0], pos[j, 0]], [pos[i, 1], pos[j, 1]],
                    color="0.7", lw=1, zorder=1)
    ax.scatter(pos[:, 0], pos[:, 1], c=subs, cmap="tab10", s=60, zorder=2)
    if annotate:
        for s in range(lattice.n_sites):
            ax.annotate(str(s), pos[s], fontsize=7,
                        textcoords="offset points", xytext=(4, 4))
    ax.set_aspect("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return pos


def plot_convergence(history, path: str, ylabel: str = "residual"):
    """Semilog convergence plot (cf. python/lanczos_plot.py /
    lanczos_plotCG.py). ``history`` = iterable of (iteration, value)."""
    plt = _agg_plt()
    h = np.asarray(list(history), dtype=np.float64)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.semilogy(h[:, 0], np.maximum(np.abs(h[:, 1]), 1e-300), marker=".")
    ax.set_xlabel("iteration")
    ax.set_ylabel(ylabel)
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
