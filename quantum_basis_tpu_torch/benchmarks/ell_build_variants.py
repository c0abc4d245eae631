"""The full-sector ELL build's design choices measured on the card:
``csrc/ell_build.cu`` as the tree has it against variants of its source,
at the full sectors of ``chip_smoke.py``'s phase 21.

Variants, each the tree's source with one choice turned the other way (a
textual substitution that must apply exactly once, so that an edit of the
source fails here loudly): ``one_row_a_warp`` (rows of E <= 16 image
columns a row a warp of 32 lanes, not two rows a warp of 16),
``no_compaction`` (a row of two images a lane sorted as 64 keys though
its kept images fit 32), ``count_by_sort`` (the count pass sorts a row as
the write pass does, not ``__match_any_sync``), ``shared_stage`` (every
row through the shared row stage of ``csrc/ell_rows.cuh``, the design
before the register stage, with the rows' lengths stored). Each
builds through the tree's wrapper (``build_sparse_full``, its library
swapped), its columns, values and row lengths checked equal to the tree's
build; times are the whole build by
CUDA events (the median of 7 builds) and the two passes' device time by
``torch.profiler``, every configuration twice, in turns (the tree first
and last). One JSON line a sector and variant, tagged with the card's name
and power limit, also written to ``--out``.

Run:  python -m quantum_basis_tpu_torch.benchmarks.ell_build_variants [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

# name: [(text of the tree's source, its replacement), ...]
VARIANTS = {
    "one_row_a_warp": [("    if (p.E <= 16) return kPair;\n",
                        "    if (p.E <= 16) return kOne;\n")],
    "no_compaction": [("constexpr bool kCompact = true;",
                       "constexpr bool kCompact = false;")],
    "count_by_sort": [("constexpr bool kCountByMatch = true;",
                       "constexpr bool kCountByMatch = false;")],
    "shared_stage": [("constexpr int kRegisterMaxE = 64;",
                      "constexpr int kRegisterMaxE = 0;")],
}

# tag, model: the full sectors of phase 21
SECTORS = (("chain24_Sz0", "chain24"), ("kagome24_Sz0", "kagome"),
           ("chain26_Sz0", "chain26"), ("tJ12_N8_Sz0", "tj12"))


def _libraries(build_dir: Path):
    """The tree's library and each variant's, built (one nvcc each, all at
    once) and loaded through ``ell_build.build_library``: {name: lib}."""
    from quantum_basis_tpu_torch.ops import cuda_build, ell_build

    src = ell_build._SRC.read_text()
    build_dir.mkdir(parents=True, exist_ok=True)
    shutil.copy(cuda_build.CSRC / "ell_rows.cuh", build_dir / "ell_rows.cuh")
    paths = {"tree": ell_build._SRC}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the source no longer "
                                   f"holds {old!r} once")
            text = text.replace(old, new)
        paths[name] = build_dir / f"ell_build_{name}.cu"
        paths[name].write_text(text)
    cuda_build.build(list(paths.values()), verbose=True)
    libs, tree_src = {}, ell_build._SRC
    try:
        for name, path in paths.items():
            ell_build._SRC, ell_build._lib = path, None
            libs[name] = ell_build.build_library()
    finally:
        ell_build._SRC, ell_build._lib = tree_src, None
    return libs


def _events_ms(fn, samples=7):
    fn()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _matvec(kind):
    from torch_zoo import heisenberg_chain, kagome_heisenberg, tj_chain

    from quantum_basis_tpu_torch.ops.apply import MatvecFull

    if kind == "tj12":
        m, ops = tj_chain(12, device="cuda")
        m.enumerate_basis_full([ops["Sz"], ops["N"]], [0.0, 8.0])
    else:
        m, ops = (kagome_heisenberg(2, 4, device="cuda") if kind == "kagome"
                  else heisenberg_chain(26 if kind == "chain26" else 24,
                                        device="cuda"))
        m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    return (sec.matvec if isinstance(sec.matvec, MatvecFull)
            else MatvecFull(m.compiled_Ham, sec.dbasis))


def run_case(tag, kind, libs, card):
    from quantum_basis_tpu_torch.benchmarks.turns import _device_ms
    from quantum_basis_tpu_torch.ops import ell_build
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_full

    mv = _matvec(kind)
    build = lambda: build_sparse_full(mv)      # noqa: E731
    ell_build._lib = libs["tree"]
    want = build()
    order = list(libs) + list(libs)[::-1]
    times = {name: [] for name in libs}
    dev = {name: [] for name in libs}
    try:
        for name in order:
            ell_build._lib = libs[name]
            got = build()
            torch.cuda.synchronize()
            if not (torch.equal(got.cols, want.cols)
                    and torch.equal(got.vals, want.vals)
                    and torch.equal(got.rowlen, want.rowlen)):
                raise AssertionError(f"{tag} {name}: the build differs "
                                     f"from the tree's")
            del got
            times[name].append(_events_ms(build))
            dev[name].append(_device_ms(build, ("ell_rows_kernel",),
                                        reps=3))
    finally:
        ell_build._lib = None
    E = mv.tables.n_cols
    return [{"case": tag, "variant": name, "dim": mv.n, "image_columns": E,
             "W": want.width, "card": card, "ms": times[name],
             "device_ms": dev[name]} for name in libs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--build-dir",
                    default="chiprun_out/ell_build_variants_src")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ell_build_variants: no CUDA device", file=sys.stderr)
        return 1
    # the models come from tests/torch_zoo.py of the working directory
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    libs = _libraries(Path(a.build_dir))
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    for tag, kind in SECTORS:
        for r in run_case(tag, kind, libs, card):
            line = json.dumps(r)
            print("ell_build_variants", line, flush=True)
            if a.out:
                with open(a.out, "a") as f:
                    f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
