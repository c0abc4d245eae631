"""KPM dynamical structure factor on the 31-site tilted triangular t-J cluster.

The port of ``examples/triangular31_tJ_sqw_kpm.py``. The reference ships the
cluster geometry (latt_special/triangular_31site.toml, generated by
python/gen_TL_shearL.py) but has no KPM dynamics; here:

1. build the t-J model on the 31-site tilted cluster (TOML-parsed; the path
   comes from the ``QBX_TRI31_TOML`` environment variable),
2. find the ground state of a dilute electron sector (N electrons, Sz = 0),
3. for each momentum q of the cluster's 31-point Brillouin zone, compute
   operator-resolved Chebyshev moments mu_m = <phi| T_m(Hs) |phi> with
   phi = Sz(q)|gs> (measure_full_dynamic_kpm), and
4. reconstruct S(q, w) with the Jackson kernel (postprocess.sqw_kpm) and
   write a JSON record; with ``--png`` also a heatmap (needs matplotlib).

Run:  QBX_TRI31_TOML=<path> python -m quantum_basis_tpu_torch.examples.triangular31_tJ_sqw_kpm [--n-elec 4] [--n-moments 256]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from quantum_basis_tpu_torch import Model, Mopr, Opr, TiltedLattice
from quantum_basis_tpu_torch.examples import solve, write_json
from quantum_basis_tpu_torch.postprocess import _agg_plt, sqw_kpm

# tJ site basis: |0>, |up>, |dn>  (same convention as the golden t-J tests)
TJ_C_UP = np.array([[0, 1, 0], [0, 0, 0], [0, 0, 0.0]])
TJ_C_DN = np.array([[0, 0, 1], [0, 0, 0], [0, 0, 0.0]])

TOML_ENV = "QBX_TRI31_TOML"


def site_ops(s):
    cu, cd = Opr(s, 0, True, TJ_C_UP), Opr(s, 0, True, TJ_C_DN)
    return {
        "cu": cu, "cd": cd,
        "Sp": cu.dagger() * cd, "Sm": cd.dagger() * cu,
        "Sz": 0.5 * (cu.dagger() * cu) - 0.5 * (cd.dagger() * cd),
        "N": cu.dagger() * cu + cd.dagger() * cd,
    }


def build_tj(lat, t=1.0, J=1.0, device="cuda"):
    """t-J with the reference's bond set (triangular: +x, +y, +x+y)."""
    m = Model(lat, device=device)
    m.add_orbital(lat.n_sites, "tJ")
    bonds = set()
    for s in range(lat.n_sites):
        coor, _ = lat.site2coor(s)
        for d in ((1, 0), (0, 1), (1, 1)):
            j = lat.coor2site([coor[0] + d[0], coor[1] + d[1]], 0)
            bonds.add((min(s, j), max(s, j)))
    if len(bonds) != 3 * lat.n_sites:
        raise ValueError(f"{len(bonds)} bonds on {lat.n_sites} sites, "
                         "not 3 per site")
    for i, j in sorted(bonds):
        oi, oj = site_ops(i), site_ops(j)
        m.add_Ham((-t) * (oi["cu"].dagger() * oj["cu"]))
        m.add_Ham((-t) * (oj["cu"].dagger() * oi["cu"]))
        m.add_Ham((-t) * (oi["cd"].dagger() * oj["cd"]))
        m.add_Ham((-t) * (oj["cd"].dagger() * oi["cd"]))
        m.add_Ham((0.5 * J) * (oi["Sp"] * oj["Sm"] + oi["Sm"] * oj["Sp"]))
        m.add_Ham(J * (oi["Sz"] * oj["Sz"]))
        m.add_Ham((-0.25 * J) * (oi["N"] * oj["N"]))
    N_tot, Sz_tot = Mopr(), Mopr()
    for s in range(lat.n_sites):
        o = site_ops(s)
        N_tot += o["N"]
        Sz_tot += o["Sz"]
    return m, N_tot, Sz_tot


def sz_q(lat, kfrac):
    """Sz(q) = (1/sqrt(N)) sum_r e^{-i q.r} Sz_r over the tilted cluster."""
    out = Mopr()
    n = lat.n_sites
    for s in range(n):
        coor, _ = lat.site2coor(s)
        phase = np.exp(-2j * np.pi * float(np.dot(kfrac, coor)))
        out += (phase / np.sqrt(n)) * site_ops(s)["Sz"]
    return out


def main(toml_path, n_elec=4, n_moments=256, n_q=0,
         out="SQW_triangular31_tJ", png=False, device="cuda"):
    """Writes ``out + ".json"``; returns the solve rows and the record."""
    rows = []
    t_all = time.time()
    lat = TiltedLattice.from_toml(toml_path)
    m, N_tot, Sz_tot = build_tj(lat, device=device)

    dim = m.enumerate_basis_full([N_tot, Sz_tot], [float(n_elec), 0.0])
    print(f"{lat.n_sites}-site t-J, N={n_elec}, Sz=0: dim = {dim}", flush=True)
    E0 = solve(rows, m, "full", nev=1, ncv=1)
    print(f"E0 = {E0:.10f}", flush=True)

    # allowed momenta: the superlattice fractions k = disp @ inv(A)
    disps, _ = lat.translation_group()
    Ainv = np.linalg.inv(lat.A.astype(float))
    kfracs = [np.asarray(d, float) @ Ainv for d in disps]
    if n_q:
        kfracs = kfracs[:n_q]

    runs = []
    bounds = None
    for qi, kfrac in enumerate(kfracs):
        t0 = time.time()
        nrm, mu, e_min, e_max = m.measure_full_dynamic_kpm(
            sz_q(lat, kfrac), 0, 0, n_moments, bounds=bounds)
        if bounds is None and nrm > 0:
            bounds = (e_min, e_max)  # H's bounds are q-independent: reuse
        runs.append({"kfrac": [float(v) for v in kfrac], "norm": nrm,
                     "mu": np.asarray(mu).tolist(),
                     "e_min": e_min, "e_max": e_max})
        print(f"q[{qi}] = ({kfrac[0]:+.3f},{kfrac[1]:+.3f})  "
              f"norm^2 = {nrm**2:.6f}  [{time.time()-t0:.1f}s]", flush=True)

    omegas = np.linspace(0.0, (bounds[1] - E0) * 1.02, 600)
    S = np.stack([sqw_kpm(omegas, r["norm"], np.asarray(r["mu"]),
                          r["e_min"], r["e_max"], E0) for r in runs])
    rec = {
        "workload": "triangular31_tJ_sqw_kpm",
        "n_sites": lat.n_sites, "n_elec": n_elec, "dim": int(dim),
        "E0": E0, "n_moments": n_moments,
        "sum_rule": {"integral": float(np.trapezoid(S, omegas, axis=1).sum()),
                     "norms2": float(sum(r["norm"] ** 2 for r in runs))},
        "runs": runs, "wall_s": round(time.time() - t_all, 1),
    }
    write_json(out + ".json", rec)
    if png:
        plt = _agg_plt()
        fig, ax = plt.subplots(figsize=(7, 4))
        im = ax.pcolormesh(np.arange(len(runs)), omegas, S.T,
                           shading="nearest", cmap="magma")
        fig.colorbar(im, ax=ax, label=r"$S(q,\omega)$")
        ax.set_xlabel("q index")
        ax.set_ylabel(r"$\omega$")
        fig.tight_layout()
        fig.savefig(out + ".png", dpi=150)
        plt.close(fig)
        print(f"wrote {out}.png")
    print(json.dumps({k: v for k, v in rec.items() if k != "runs"}))
    return rows, rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-elec", type=int, default=4)
    ap.add_argument("--n-moments", type=int, default=256)
    ap.add_argument("--n-q", type=int, default=0,
                    help="limit to the first N momenta (0 = all)")
    ap.add_argument("--out", default="SQW_triangular31_tJ")
    ap.add_argument("--png", action="store_true")
    args = ap.parse_args()
    path = os.environ.get(TOML_ENV)
    if not path:
        raise SystemExit(f"set {TOML_ENV} to the cluster's TOML file "
                         "(latt_special/triangular_31site.toml)")
    main(path, args.n_elec, args.n_moments, args.n_q, args.out, args.png)
