"""Whole solves on both sides of each routing bound (``config.ROUTING``).

For each of the eight bounds it runs the same sector on the two engines the
bound chooses between, the set-up included (enumeration, engine or ELL/BSR
build, then the solve), and records seconds, the peak device memory, the
sector's blowup and the energies (which must agree). These runs set the
"cuda" values of ``config.ROUTING``:

- ``full``: a full sector on the full-label-space engine (ContractOp /
  FullSpaceOp) in float64 and under ``config.mixed_precision``, against the
  sector's matrix-free matvec (``fullspace_max_blowup``,
  ``fullspace_mixed_max_blowup``);
- ``repr``: a momentum sector as P_k H against the explicit float64 ELL
  (``fullspace_repr_max_blowup``);
- ``bsr``: an explicit momentum sector with its float32 bulk on the BSR
  kernel and a float64 polish, against the pure float64 ELL solve
  (``bsr_blowup_max``, ``bsr_stored_max_bytes``);
- ``kpm``: 192 KPM moments of Sz(q)|gs> on P_k H, on the float32 BSR kernel,
  on the sector's matrix-free matvec and on its explicit ELL
  (``kpm_fullspace_max_N``, ``bsr_auto_max_dim``), and on the route the
  device's own table takes (``default``);
- ``kron``: Hubbard product sectors through ProductModel (its defaults on
  the device's table) with the kron engines dense and as ELL rows on the
  fused kernel (``kron_dense_max_dim``): 4x2, 4x3 and 4x4 at half filling
  (factor dims 70, 924, 12870), the 4x2 (3, 2) sector and the 4x4 gap
  sector (9, 8) (two factors): the whole solve with the factors' and the
  coupling's build (after one untimed solve on each layout and the
  kernel's build), the peak, and the float32 and float64 apply.

Run:  python -m quantum_basis_tpu_torch.benchmarks.routing [--sections full,repr,bsr,kpm,kron] [--quick] [--device cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import time

import numpy as np
import torch

from quantum_basis_tpu_torch import Mopr, Opr, config
from quantum_basis_tpu_torch.benchmarks import (device_name, out_path,
                                                timed, write_json)
from quantum_basis_tpu_torch.examples import engine_of, kpm_engine_of
from quantum_basis_tpu_torch.solvers.lanczos import energy_scale

INF = math.inf
KPM_MOMENTS = 192


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def _peak(device):
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return None


# ------------------------------------------------------------ the models

def chain(L, n_up=None):
    from quantum_basis_tpu_torch.examples.chain_heisenberg_spin_half import (
        build)

    def make(device):
        m, sz = build(L, device)
        if n_up is None:
            return m, [], []
        return m, [sz], [n_up - L / 2]
    return make


def kagome24(n_up=12):
    from quantum_basis_tpu_torch.benchmarks.flagship_kagome24 import build

    def make(device):
        m, sz = build(2, 4, device)
        if n_up is None:
            return m, [], []
        return m, [sz], [n_up - 12.0]
    return make


def kagome_tj():
    from quantum_basis_tpu_torch.examples.kagome_heisenberg_tj import build_tj

    def make(device):
        m, n, sz = build_tj(2, 2, device=device)
        return m, [n, sz], [8.0, 0.0]
    return make


def example(module, builder, *args, conserve=None):
    """A model of an example driver: module.builder(*args, device=), whose
    conserved operators are picked from its return value by ``conserve``
    (index, value) pairs."""
    def make(device):
        import importlib

        mod = importlib.import_module(
            f"quantum_basis_tpu_torch.examples.{module}")
        out = getattr(mod, builder)(*args, device=device)
        m = out[0]
        return m, [out[i] for i, _ in conserve], [v for _, v in conserve]
    return make


def tilted20():
    from quantum_basis_tpu_torch.benchmarks.bsr_bench import (
        TILTED_A, tilted_heisenberg)

    def make(device):
        m, sz = tilted_heisenberg(TILTED_A, device)
        return m, [sz], [0.0]
    return make


FULL_CASES = {   # tag: (model, quick)
    "chain16_Sz0": (chain(16, 8), True),
    "spin1_chain10_Sz0": (example("chain_heisenberg_spin_one", "build", 10,
                                  conserve=[(1, 0.0)]), True),
    "tj_chain12_N8": (example("chain_tj", "build", 12,
                              conserve=[(1, 0.0), (2, 8.0)]), True),
    "hubbard4x2_4_4": (example("square_fermi_hubbard", "build", 4, 2,
                               conserve=[(2, 4.0), (3, 4.0)]), True),
    "kagome_tj22_N8": (kagome_tj(), True),
    "chain24_up12": (chain(24, 12), False),
    "chain24_up8": (chain(24, 8), False),
    "chain24_up6": (chain(24, 6), False),
    "chain24_up5": (chain(24, 5), False),
    "chain26_up13": (chain(26, 13), False),
    "kagome24_up8": (kagome24(8), False),
    "kagome24_up6": (kagome24(6), False),
}
REPR_CASES = {   # tag: (model, momentum, quick)
    "chain16_k0": (chain(16, 8), [0], True),
    "kagome_tj22_k00": (kagome_tj(), [0, 0], True),
    "honeycomb32_N4_k00": (example("honeycomb_spinless_fermion", "build", 3,
                                   2, conserve=[(1, 4.0)]), [0, 0], True),
    "spin1_chain12_k0": (example("chain_heisenberg_spin_one", "build", 12,
                                 conserve=[(1, 0.0)]), [0], False),
    "chain20_k0": (chain(20, 10), [0], False),
    "chain24_k0": (chain(24, 12), [0], False),
    "chain24_allSz_k0": (chain(24), [0], False),
    "kagome24_k02": (kagome24(), [0, 2], False),
    "chain16_allSz_k0": (chain(16), [0], False),
    "chain20_allSz_k0": (chain(20), [0], False),
    "kagome24_allSz_k02": (kagome24(None), [0, 2], False),
}
BSR_CASES = {
    "chain16_k0": (chain(16, 8), [0], True),
    "kagome_tj22_k00": (kagome_tj(), [0, 0], True),
    "chain20_k0": (chain(20, 10), [0], False),
    "chain22_k0": (chain(22, 11), [0], False),
    "tilted20_k00": (tilted20(), [0, 0], False),
    "kagome24_k02": (kagome24(), [0, 2], False),
    "chain24_k0": (chain(24, 12), [0], False),
}
SZ_HALF = np.array([0.5, -0.5])
SZ_TJ = np.array([0.0, 0.5, -0.5])
KPM_CASES = {    # tag: (model, k0, q, the site's Sz, quick)
    "kagome_tj22_k00_q01": (kagome_tj(), [0, 0], [0, 1], SZ_TJ, True),
    "chain20_k0_q5": (chain(20, 10), [0], [5], SZ_HALF, False),
    "chain16_k0_q4": (chain(16, 8), [0], [4], SZ_HALF, False),
    "kagome24_k02_q01": (kagome24(), [0, 2], [0, 1], SZ_HALF, False),
}


# ------------------------------------------------------------ the sections

def _solve(make, device, which, k=None):
    """Enumerate and solve one sector: (record, model)."""
    _free(device)
    m, conserve, vals = make(device)

    def run():
        if which == "full":
            dim = m.enumerate_basis_full(conserve, vals)
        else:
            dim = m.enumerate_basis_repr(k, conserve, vals)
        m.locate_E0_lanczos(which, maxit=4000)
        return dim
    dim, s = timed(run, device)
    E0 = m.eigenvals_full[0] if which == "full" else m.eigenvals_repr[0]
    return {"dim": int(dim), "blowup": m.space.label_space / dim,
            "engine": engine_of(m, which), "s": s, "E0": float(E0),
            "peak_bytes": _peak(device)}, m


def _agree(tag, recs, tol):
    e = [r["E0"] for r in recs.values()]
    if max(e) - min(e) > tol:
        raise AssertionError(f"{tag}: routes disagree: {recs}")


def full_section(device, quick):
    out = {}
    for tag, (make, q) in FULL_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for route, pin, mixed in (("engine", INF, False),
                                  ("engine_mixed", INF, True),
                                  ("matvec", 0.0, False)):
            with config.pinned(fullspace_max_blowup=pin,
                               fullspace_mixed_max_blowup=pin,
                               mixed_precision=mixed):
                recs[route], _ = _solve(make, device, "full")
        _agree(tag, recs, 1e-9)
        out[tag] = recs
        print("full", tag, json.dumps(recs), flush=True)
    return out


def repr_section(device, quick):
    out = {}
    for tag, (make, k, q) in REPR_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for route, pin in (("pkh", INF), ("explicit", 0.0)):
            with config.pinned(fullspace_repr_max_blowup=pin,
                               prefer_bsr=False, mixed_precision=False):
                recs[route], _ = _solve(make, device, "repr", k)
        _agree(tag, recs, 1e-9)
        out[tag] = recs
        print("repr", tag, json.dumps(recs), flush=True)
    return out


def bsr_section(device, quick):
    from quantum_basis_tpu_torch.ops.bsr import bsr_fill_stats

    out = {}
    for tag, (make, k, q) in BSR_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for route, prefer in (("bsr", True), ("ell", False)):
            with config.pinned(fullspace_repr_max_blowup=0.0,
                               prefer_bsr=prefer):
                recs[route], m = _solve(make, device, "repr", k)
        st = bsr_fill_stats(m.sec_repr[0].ell)
        recs["bsr_blowup"] = st["blowup"]
        recs["bsr_stored_bytes"] = st["stored"] * 4 * 2
        del m
        _agree(tag, {r: recs[r] for r in ("bsr", "ell")}, 1e-9)
        out[tag] = recs
        print("bsr", tag, json.dumps(recs), flush=True)
    return out


def _sz_q(lat, q, sz):
    """Sz(q) = (1/sqrt(N)) sum_r e^{-i q.r} Sz_r over the lattice's cells
    (cell-coordinate phases, sublattice-summed); ``sz`` the site's Sz."""
    n = lat.n_sites
    dims = lat.L
    out = Mopr()
    for s in range(n):
        coor, _ = lat.site2coor(s)
        ph = np.exp(-2j * np.pi * sum(q[i] * coor[i] / dims[i]
                                      for i in range(len(q))))
        out += (ph / np.sqrt(n)) * Opr(s, 0, False, sz)
    return out


def kpm_section(device, quick):
    out = {}
    for tag, (make, k0, q, sz, qk) in KPM_CASES.items():
        if quick and not qk:
            continue
        with config.pinned(fullspace_repr_max_blowup=0.0,
                           prefer_bsr=False):
            gs, m = _solve(make, device, "repr", k0)
        dims = m.lattice.L
        kt = [int((a - b) % n) for a, b, n in zip(k0, q, dims)]
        A = _sz_q(m.lattice, q, sz)
        conserve, vals = m.sec_repr[0].qn[1], m.sec_repr[0].qn[2]
        # one set of bounds for every route, so the moments compare
        m.enumerate_basis_repr(kt, conserve, vals, sec=1)
        ell = m.generate_Ham_sparse_repr(1, check=False)
        gen = torch.Generator(device=device).manual_seed(7)
        v0 = torch.randn(ell.n, dtype=torch.float64, device=device,
                         generator=gen).to(torch.complex128)
        bounds = energy_scale(ell, v0, slack=0.05)
        recs = {"gs": gs, "target_k": kt, "bounds": list(bounds)}
        mus = {}
        routes = (("pkh", dict(kpm_fullspace_max_N=INF,
                               fullspace_repr_max_blowup=INF), False),
                  ("bsr", dict(kpm_fullspace_max_N=0, bsr_auto_max_dim=INF,
                               bsr_blowup_max=INF, bsr_stored_max_bytes=INF,
                               prefer_bsr=None), False),
                  ("matvec", dict(kpm_fullspace_max_N=0, bsr_auto_max_dim=0,
                                  prefer_bsr=None), False),
                  ("ell", dict(kpm_fullspace_max_N=0, bsr_auto_max_dim=0,
                               prefer_bsr=None), True),
                  ("default", {}, False))
        for route, pins, explicit in routes:
            m.sec_repr.pop(1, None)
            _free(device)
            with config.pinned(**pins):
                def run():
                    m.enumerate_basis_repr(kt, conserve, vals, sec=1)
                    if explicit:
                        m.generate_Ham_sparse_repr(1, check=False)
                    return m.measure_repr_dynamic_kpm(A, 0, 1, KPM_MOMENTS,
                                                      bounds=bounds)
                (nrm, mu, _, _), s = timed(run, device)
            mus[route] = np.asarray(mu)
            recs[route] = {"s": s, "norm": nrm, "peak_bytes": _peak(device),
                           "engine": kpm_engine_of(m, 1)}
        ref = mus["ell"]
        for route, mu in mus.items():
            err = float(np.max(np.abs(mu - ref)))
            recs[route]["mu_vs_ell"] = err
            if err > 1e-4:
                raise AssertionError(f"{tag}: {route} moments off by {err}")
        out[tag] = recs
        print("kpm", tag, json.dumps(recs), flush=True)
        del m
    return out


# tag: (Lx, Ly, N_up, N_dn, quick); N_up = N_dn shares one factor
KRON_CASES = {"hubbard4x2": (4, 2, 4, 4, True),
              "hubbard4x2_3_2": (4, 2, 3, 2, True),
              "hubbard4x3": (4, 3, 6, 6, False),
              "hubbard4x4": (4, 4, 8, 8, False),
              "hubbard4x4_9_8": (4, 4, 9, 8, False)}


def _kron_solve(lx, ly, nu, nd, device):
    """Build and solve one Hubbard product sector on ProductModel's
    defaults: (model, the coupling's host build s, E0)."""
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized, build_factorized_sector)

    pm = (build_factorized(lx, ly, Nf=nu, device=device)[0] if nu == nd
          else build_factorized_sector(lx, ly, nu, nd, device=device))
    t0 = time.perf_counter()
    pm._coupling_matrix()
    coupling_s = time.perf_counter() - t0
    return pm, coupling_s, pm.locate_E0_lanczos(log=lambda *a: None)


def kron_section(device, quick):
    from quantum_basis_tpu_torch.benchmarks import device_ms, timed
    from quantum_basis_tpu_torch.ops import apply_kron

    if torch.device(device).type == "cuda":
        apply_kron.build_library()   # once per process, not per solve
    # one untimed solve on each layout first: the process's first solve
    # pays the device's start-up
    for pin in (INF, 0):
        with config.pinned(kron_dense_max_dim=pin):
            _kron_solve(4, 2, 4, 4, device)
    out = {}
    for tag, (lx, ly, nu, nd, q) in KRON_CASES.items():
        if quick and not q:
            continue
        recs = {}
        for layout, pin in (("dense", INF), ("ell", 0)):
            _free(device)
            with config.pinned(kron_dense_max_dim=pin):
                (pm, coupling_s, E0), s = timed(
                    lambda: _kron_solve(lx, ly, nu, nd, device), device)
                rec = {"s": s, "coupling_build_s": coupling_s,
                       "E0": float(E0), "residual": pm._last_residual,
                       "dim": pm.dim, "factor_dims": [pm.na, pm.nb],
                       "peak_bytes": _peak(device),
                       "solve_info": dict(pm.solve_info),
                       "applies": {str(k[0]): op.n_applies
                                   for k, op in pm._ops.items()}}
                gen = torch.Generator(device=device).manual_seed(3)
                x = torch.randn(pm.dim, dtype=torch.float64, device=device,
                                generator=gen)
                for dt in (torch.float32, torch.float64):
                    op = pm.op(dt)
                    if op.layout != layout:
                        raise AssertionError(f"{tag}: {op.layout} engine")
                    xd = x.to(dt)
                    rec[f"{str(dt)[6:]}_apply_ms"] = device_ms(
                        lambda: op(xd), device, samples=5, per_sample=2)
                    rec[f"{str(dt)[6:]}_resident_bytes"] = op.resident_bytes
                del pm, x, xd, op
            recs[layout] = rec
        _agree(tag, recs, 1e-9)
        out[tag] = recs
        print("kron", tag, json.dumps(recs), flush=True)
    return out


SECTIONS = {"full": full_section, "repr": repr_section, "bsr": bsr_section,
            "kpm": kpm_section, "kron": kron_section}


def main(sections=tuple(SECTIONS), quick=False, device="cuda", out=None):
    """Runs the sections; returns the record and writes it to ``out``
    (default ``out_path("ROUTING_torch.json")``). ``quick``: only the small
    cases (the ones a CPU run can take)."""
    rec = {"device": device_name(device)}
    for name in sections:
        rec[name] = SECTIONS[name](device, quick)
    write_json(out or out_path("ROUTING_torch.json"), rec)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    main(args.sections.split(","), args.quick, args.device, args.out)
