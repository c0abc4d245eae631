"""The ELL apply's design choices measured on the card: ``csrc/ell_spmv.cu``
as the tree has it against variants of its source, and its layout against
two others, at the sectors of ``chip_smoke.py``'s phase 22.

Kernel variants, each the tree's source with one choice turned the other
way (a textual substitution that must apply exactly once, so that an edit
of the source fails here loudly): ``steps2_complex`` (two row steps a warp
over complex values, as over real ones), ``steps1_real`` (one over real
values), ``late_diag_real`` (the diagonal term loaded after the row loop
over real values, as over complex ones), ``early_diag_complex`` (before
it over complex values), ``cached_loads`` (columns and values by
``__ldg`` in place of the evict-first ``__ldcs``). Each runs through the
matrix's launch record at the group size the wrapper chooses
(``ops/sparse.py::group_size``: the power of two at or above half the
mean row length), at half and at twice it; the tree's kernel also at the
power of two at or above the mean (the rule before). Layouts, on the
tree's kernel: the same (n, W) rows copied into rows of 2W slots (the
live slots alike, twice the stride), the rows grouped by length, one
(n_L, L) ELL a length L applied with the two-pointer form (a sliced ELL's
reads in one launch a slice), the same rows with every live column set
to the row's own index (the same bytes streamed, the x gathers' scatter
taken out: a row's gathers hit one 32-byte sector), and those rows made
full (every slot live, the row length W: the whole arrays swept). Beside
them, the 32-byte sectors that a row's live columns and values touch
(at the arrays' own alignment), as a bound over the HBM rate like the
live bound (row lengths, diagonal, x and y added).

Every variant's y is checked against the plain version (1e-12 of max|y|);
times are CUDA events (the median of 15 samples of 5 calls), every
configuration twice, in turns. One JSON line a sector and vector, tagged
with the card's name and power limit, also written to ``--out``.

Run:  python -m quantum_basis_tpu_torch.benchmarks.ell_variants [--out PATH]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# name: [(text of the tree's source, its replacement), ...]
VARIANTS = {
    "steps2_complex": [(
        "constexpr int kSteps = std::is_same<V, Cplx>::value ? 1 : 2;",
        "constexpr int kSteps = 2;")],
    "steps1_real": [(
        "constexpr int kSteps = std::is_same<V, Cplx>::value ? 1 : 2;",
        "constexpr int kSteps = 1;")],
    "late_diag_real": [(
        "constexpr bool kEarlyDiag = !std::is_same<V, Cplx>::value;",
        "constexpr bool kEarlyDiag = false;")],
    "early_diag_complex": [(
        "constexpr bool kEarlyDiag = !std::is_same<V, Cplx>::value;",
        "constexpr bool kEarlyDiag = true;")],
    "cached_loads": [
        ("                c[u] = __ldcs(cols + off);",
         "                c[u] = __ldg(cols + off);"),
        ("__device__ __forceinline__ double load_val(const double* p) {\n"
         "    return __ldcs(p);",
         "__device__ __forceinline__ double load_val(const double* p) {\n"
         "    return __ldg(p);"),
        ("    const double2 t = __ldcs(reinterpret_cast<const double2*>(p));",
         "    const double2 t = __ldg(reinterpret_cast<const double2*>(p));")],
}

# tag, model, momentum (None: the Sz=0 full sector), the vectors
SECTORS = (("kagome24_k02", "kagome", (0, 2), ("complex",)),
           ("chain24_k0", "chain24", (0,), ("complex",)),
           ("chain24_Sz0", "chain24", None, ("real", "complex")),
           ("kagome24_Sz0", "kagome", None, ("real", "complex")),
           ("diagonal_only", "chain24", None, ("real",)))


def _libraries(build_dir: Path):
    """The tree's kernel and each variant built (one nvcc each, all at
    once) and loaded: {name: qbt_ell_spmv}."""
    from quantum_basis_tpu_torch.ops import cuda_build, sparse

    src = sparse._SRC.read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    paths = {"tree": sparse._SRC}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r} once")
            text = text.replace(old, new)
        paths[name] = build_dir / f"ell_spmv_{name}.cu"
        paths[name].write_text(text)
    fns = {}
    for name, lib in zip(paths, cuda_build.build(list(paths.values()))):
        lib = ctypes.CDLL(str(lib))
        lib.qbt_ell_spmv.argtypes = [ctypes.POINTER(sparse._Args),
                                     ctypes.c_void_p]
        lib.qbt_ell_spmv.restype = ctypes.c_int
        fns[name] = lib.qbt_ell_spmv
    return fns


def _events_ms(fn, samples=15, per_sample=5):
    for _ in range(3):
        fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_sample):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / per_sample)
    return float(np.median(times))


def _matrix(tag, kind, k):
    from torch_zoo import heisenberg_chain, kagome_heisenberg

    from quantum_basis_tpu_torch.ops.apply import MatvecFull
    from quantum_basis_tpu_torch.ops.sparse import (EllMatrix,
                                                    build_sparse_full,
                                                    build_sparse_repr)

    m, ops = (kagome_heisenberg(2, 4, device="cuda") if kind == "kagome"
              else heisenberg_chain(24, device="cuda"))
    if k is not None:
        m.enumerate_basis_repr(list(k), [ops["Sz"]], [0.0])
        return build_sparse_repr(m.sec_repr[0].matvec)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    mv = (sec.matvec if isinstance(sec.matvec, MatvecFull)
          else MatvecFull(m.compiled_Ham, sec.dbasis))
    ell = build_sparse_full(mv)
    if tag == "diagonal_only":
        n = ell.n
        ell = EllMatrix(torch.zeros((n, 0), dtype=torch.int32, device="cuda"),
                        torch.zeros((n, 0), dtype=torch.float64,
                                    device="cuda"), ell.diag)
    return ell


def _check(what, y, want):
    err = float((y - want).abs().max())
    scale = max(float(want.abs().max()), 1e-300)
    if not err <= 1e-12 * scale:
        raise AssertionError(f"{what}: {err:.3e} from the plain version")


# the H100 SXM's published HBM3 rate (chip_smoke.py's HBM_BYTES_PER_S)
HBM_BYTES_PER_S = 3.35e12


def _sectors(t, rowlen):
    """32-byte sectors that rows i of the (n, W) array ``t`` touch over
    their first rowlen[i] slots, summed."""
    n, W = t.shape
    e = t.element_size()
    start = (t.data_ptr() % 32
             + torch.arange(n, device=t.device, dtype=torch.int64) * (W * e))
    end = start + rowlen.long() * e
    per = torch.where(rowlen > 0, (end - 1) // 32 - start // 32 + 1, 0)
    return int(per.sum())


def sector_bound_ms(ell, x):
    """The live slots' bound counted in the 32-byte sectors that the rows'
    live columns and values touch, with the row lengths, the diagonal, x
    read once and y written once, over the HBM rate."""
    nbytes = 32 * (_sectors(ell.cols, ell.rowlen)
                   + _sectors(ell.vals, ell.rowlen))
    nbytes += ell.n * (4 + 8 + 2 * x.element_size())
    return nbytes / HBM_BYTES_PER_S * 1e3


def _layouts(ell, x, want):
    """The tree's kernel over the rows copied at twice the stride, over the
    rows grouped by length (one ELL a length), over the rows with their
    own index as every live column and over those rows made full: ms of
    each, twice; and the live sectors' bound."""
    from quantum_basis_tpu_torch.ops.sparse import EllLaunch, _ell_spmv_plain

    W = ell.width
    wide = EllLaunch(torch.nn.functional.pad(ell.cols, (0, W)).contiguous(),
                     torch.nn.functional.pad(ell.vals, (0, W)).contiguous(),
                     ell.diag, ell.rowlen)
    _check("stride 2W", wide(x), want)
    order = torch.argsort(ell.rowlen.long(), stable=True)
    lens = ell.rowlen[order]
    parts = []
    for L in torch.unique(lens).tolist():
        rows = order[lens == L]
        rl = torch.full((rows.numel(),), L, dtype=torch.int32, device="cuda")
        parts.append((EllLaunch(ell.cols[rows, :L].contiguous(),
                                ell.vals[rows, :L].contiguous(),
                                ell.diag[rows].contiguous(), rl),
                      rows, x[rows].contiguous()))
    y = torch.empty_like(want)
    for rec, rows, xd in parts:
        y[rows] = rec(xd, x)
    _check("by length", y, want)

    live = (torch.arange(W, device="cuda")[None, :]
            < ell.rowlen[:, None])
    own_cols = torch.where(live, torch.arange(ell.n, device="cuda")[:, None],
                           0).to(torch.int32)
    del live
    own = EllLaunch(own_cols, ell.vals, ell.diag, ell.rowlen)
    _check("own-row columns", own(x),
           _ell_spmv_plain(own_cols, ell.vals, ell.diag, x, x))
    full_cols = torch.arange(ell.n, dtype=torch.int32,
                             device="cuda")[:, None].expand(-1, W).contiguous()
    full_vals = torch.where(ell.vals != 0, ell.vals, 0.5)
    full = EllLaunch(full_cols, full_vals, ell.diag,
                     torch.full((ell.n,), W, dtype=torch.int32,
                                device="cuda"))
    _check("full own-row rows", full(x),
           _ell_spmv_plain(full_cols, full_vals, ell.diag, x, x))

    def grouped():
        for rec, _, xd in parts:
            rec(xd, x)
    out = {"stride_2W_ms": [], "by_length_ms": [],
           "by_length_launches": len(parts), "own_row_cols_ms": [],
           "full_rows_ms": [], "sector_bound_ms": sector_bound_ms(ell, x)}
    for _ in range(2):
        out["stride_2W_ms"].append(_events_ms(lambda: wide(x)))
        out["by_length_ms"].append(_events_ms(grouped))
        out["own_row_cols_ms"].append(_events_ms(lambda: own(x)))
        out["full_rows_ms"].append(_events_ms(lambda: full(x)))
    return out


def run_case(tag, kind, k, vecs, fns, card):
    from quantum_basis_tpu_torch.ops.sparse import (GROUPS, EllLaunch,
                                                    _ell_spmv_plain)

    ell = _matrix(tag, kind, k)
    rec = EllLaunch(ell.cols, ell.vals, ell.diag, ell.rowlen)
    mean = float(ell.rowlen.double().mean()) if ell.n else 0.0
    chosen = rec.group
    by_mean = next((g for g in GROUPS if g >= mean), GROUPS[-1])
    groups = sorted({max(1, chosen // 2), chosen, min(32, 2 * chosen)})
    g = torch.Generator(device="cuda").manual_seed(21)
    out = []
    for v in vecs:
        x = torch.randn(ell.n, dtype=torch.complex128 if v == "complex"
                        else torch.float64, device="cuda", generator=g)
        if ell.is_complex:
            x = x.to(torch.complex128)
        want = _ell_spmv_plain(ell.cols, ell.vals, ell.diag, x, x)
        r = {"case": tag, "x": v, "dim": ell.n, "W": ell.width,
             "values": "complex" if ell.is_complex else "real",
             "mean_row_length": mean, "group": chosen, "card": card,
             "ms": {}}
        for _ in range(2):
            for name, fn in fns.items():
                for G in groups + ([by_mean] if name == "tree" else []):
                    rec._fn, rec.p.G = fn, G
                    _check(f"{tag} {name} G={G}", rec(x), want)
                    r["ms"].setdefault(f"{name} G={G}", []).append(
                        _events_ms(lambda: rec(x)))
        rec._fn, rec.p.G = fns["tree"], chosen
        if ell.width and v == vecs[0]:
            r.update(_layouts(ell, x, want))
        out.append(r)
        del want
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--build-dir", default="chiprun_out/ell_variants_src")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_variants: no CUDA device", file=sys.stderr)
        return 1
    # the models come from tests/torch_zoo.py of the working directory
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    fns = _libraries(Path(a.build_dir))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    for tag, kind, k, vecs in SECTORS:
        for r in run_case(tag, kind, k, vecs, fns, card):
            line = json.dumps(r)
            print("ell_variants", line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
