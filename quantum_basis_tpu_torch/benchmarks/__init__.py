"""The benchmark drivers, through the port: ``bsr_bench`` (the BSR kernel
against the ELL on momentum-sector matrices), ``routing`` (whole solves on
both sides of each routing bound), ``flagship_kagome24`` (the 24-site kagome
ground state, full sector and all 8 momenta), ``flagship_kagome24_sqw`` (its
S(q, w)), ``memory`` (whole solves at each setting of the memory sizes),
``hubbard4x4`` (the 4x4 Hubbard ground state, dim 165,636,900),
``hubbard4x4_gaps`` (its spin and charge gaps), ``scaling`` (the sharded
engines on 1, 2, 4, ... ranks), ``comm_roofline`` (their communication
against their compute), ``krylov_trace`` (a restart cycle's split),
``turns`` (the momentum-sector kernels, the ELL builds or the ELL apply at
full width, for turns with another tree), ``ell_variants`` (the ELL
apply's design choices against variants of its kernel and layout) and
``ell_build_variants`` (the full-sector ELL build's against variants of
its kernel). Each
runs as

    python -m quantum_basis_tpu_torch.benchmarks.<name> [--device cpu]

and writes its JSON record under ``OUT_DIR`` (git-ignored) unless ``--out``
says otherwise; the JAX package's result files at the repository root are
never written.
"""

from __future__ import annotations

import os
import subprocess
import time

import numpy as np
import torch

from quantum_basis_tpu_torch.examples import synchronize, write_json

OUT_DIR = "chiprun_out"


def out_path(name: str) -> str:
    return os.path.join(OUT_DIR, name)


def device_ms(fn, device, samples: int = 15, per_sample: int = 5) -> float:
    """Median time of one fn() call in ms: CUDA events on a CUDA device, the
    host clock elsewhere (a CPU time, never a device time)."""
    return float(np.median(device_ms_samples(fn, device, samples,
                                             per_sample)))


def device_ms_samples(fn, device, samples: int = 15,
                      per_sample: int = 5) -> list:
    """Each sample's time of one fn() call in ms, as device_ms takes them."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(2):
        fn()
    times = []
    for _ in range(samples):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(per_sample):
                fn()
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / per_sample)
        else:
            t0 = time.perf_counter()
            for _ in range(per_sample):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / per_sample)
    return times


def timed(fn, device):
    """(fn(), host seconds to the device's end)."""
    synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    synchronize(device)
    return out, time.perf_counter() - t0


def device_name(device) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def card_line(device="cuda") -> str:
    """The card's name and power limit as nvidia-smi gives them; "cpu" for
    a CPU device."""
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
