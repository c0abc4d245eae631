"""Dynamical structure factor S(q, w) of the spin-1/2 Heisenberg chain.

The port of ``examples/chain_dynamics_sqw.py``, after the reference workflow
of examples/trans_absent/latt_chain/chain_Heisenberg_spin_half.cc (dynamics
run) and plot_sqw.py (continued-fraction reconstruction): |v> = Sz_q |gs>,
fixed-step Lanczos for the (a, b) coefficients, S(q, w) on a grid, written
as JSON; with ``--png`` also as a heatmap (needs matplotlib).

Run:  python -m quantum_basis_tpu_torch.examples.chain_dynamics_sqw [L] [out] [--png]
"""

from __future__ import annotations

import sys

import numpy as np

from quantum_basis_tpu_torch import Mopr, Opr
from quantum_basis_tpu_torch.examples import solve, write_json
from quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half import (
    SZ, build)
from quantum_basis_tpu_torch.ops.operators import OprProd
from quantum_basis_tpu_torch.postprocess import plot_sqw, spectral_function

CF_STEPS = 40


def main(L=12, out="sqw_chain", png=False, device="cuda"):
    """Writes ``out + ".json"`` (q, omegas, S(q, w), norms) and, with
    ``png``, ``out + ".png"``. Returns the solve rows and the JSON record."""
    rows = []
    m, Sz_tot = build(L, device)
    m.enumerate_basis_full([Sz_tot], [0.0])
    E0 = solve(rows, m, "full Sz=0", nev=1, ncv=1)
    print(f"E0 = {E0:.9f}")

    runs = []
    qs = list(range(1, L))
    for qi in qs:
        q = 2.0 * np.pi * qi / L
        A = Mopr()
        for x in range(L):
            A += complex(np.exp(-1j * q * x) / np.sqrt(L)) * Mopr(
                [OprProd(1.0, [Opr(x, 0, False, SZ)])])
        norm, a, b = m.measure_full_dynamic(A, 0, 0, CF_STEPS)
        print(f"q = {qi} (2pi/L): |A|gs>| = {norm:.6f}, {len(a)} Lanczos steps")
        runs.append((norm, a, b))

    omegas = np.linspace(0.0, 4.0, 200)
    S = np.stack([spectral_function(omegas, n, a, b, E0, eta=0.06)
                  for n, a, b in runs])
    rec = {"L": L, "E0": E0, "q": [q / L for q in qs],
           "norms": [float(r[0]) for r in runs],
           "omegas": omegas.tolist(), "S": S.tolist()}
    write_json(out + ".json", rec)
    print(f"S(q,w) written to {out}.json; max = {S.max():.4f}")
    if png:
        plot_sqw([q / L for q in qs], runs, omegas, E0, out + ".png",
                 eta=0.06)
        print(f"S(q,w) heatmap written to {out}.png")
    return rows, rec


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--png"]
    main(int(args[0]) if args else 12, args[1] if len(args) > 1
         else "sqw_chain", png="--png" in sys.argv[1:])
