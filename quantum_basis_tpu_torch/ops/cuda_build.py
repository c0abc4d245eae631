"""Build the package's CUDA sources (``csrc/*.cu``) with nvcc and load them.

Each source compiles at first use, for sm_90a, into a shared library with a
plain C interface under ``quantum_basis_tpu_torch/_build/`` (git-ignored),
named by a hash of the source and of every header it includes from
``csrc/`` (``#include "..."``), and is loaded with ctypes. Nothing builds at
import. :func:`build` compiles several sources at once, one nvcc each, all
started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources_of(src: Path) -> list[Path]:
    """``src`` and every header it includes with ``#include "..."``,
    directly or through another header (paths relative to the including
    file), each once, in the order first met."""
    seen, todo = [], [Path(src)]
    while todo:
        f = todo.pop(0).resolve()
        if f in seen:
            continue
        seen.append(f)
        todo += [f.parent / m.decode() for m in
                 _INCLUDE.findall(f.read_bytes())]
    return seen


def library_path(src: Path) -> Path:
    """Where the shared library of ``src`` lives: ``lib<stem>_<hash>.so``,
    the hash over the source and the headers it includes, so that an edited
    header builds a new library."""
    h = hashlib.sha1()
    for f in sources_of(src):
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{Path(src).stem}_{h.hexdigest()[:12]}.so"


def build(sources, verbose: bool = False) -> list[Path]:
    """Compile every source whose library is missing, one nvcc each, all
    running at once; returns the libraries' paths. ``verbose`` prints nvcc's
    ptxas report (registers, shared memory and spills per kernel) of each
    source this call builds. Raises with nvcc's errors if one fails."""
    outs = [library_path(Path(s)) for s in sources]
    todo = [(Path(s), o) for s, o in zip(sources, outs) if not o.exists()]
    if not todo:
        return outs
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        # --split-compile=0: the device optimisation runs on every core
        # (apply_rows.cu's 96 instances: 20 s against 55-70 s on one)
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "--split-compile=0", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for src, out, tmp, p in procs:
        _, err = p.communicate()
        if p.returncode != 0:
            failed.append(f"nvcc failed on {src.name} ({p.returncode}):\n{err}")
            continue
        if verbose:
            print(f"{src.name}:", err, end="")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def load(src: Path, verbose: bool = False) -> ctypes.CDLL:
    """Build ``src`` if needed and load its library."""
    return ctypes.CDLL(str(build([src], verbose)[0]))
