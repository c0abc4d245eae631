"""Global configuration: tolerances, routing bounds, memory sizes, matmul
precision.

Port of ``quantum_basis_tpu.config`` for the ground-state routes (momentum
sectors, full sectors and factorized product sectors), the dynamics routes
and checkpointing.
Importing this module turns TF32 off for float32 matrix products and
convolutions: the f32 bulk
tier (Krylov basis products, the window and kron matmuls, the RQI inner CG)
needs true float32, the way the JAX package forces ``Precision.HIGHEST``.
"""

from __future__ import annotations

import contextlib

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Numerical tolerances (reference: src/miscellaneous.cc:44-47).
opr_precision = 1e-12       # for comparing operator matrix elements
sparse_precision = 1e-14    # entries below this are dropped from sparse H
lanczos_precision = 2e-12   # Lanczos convergence tolerance

# Crash-consistent checkpointing (utils/ckpt.py): when set, the solvers write
# restart records and the models stage records under ckpt_dir, and a rerun
# resumes from them. initialize(enable_checkpoint=True) sets it.
enable_ckpt = False

# Directory for checkpoint files (the reference uses ``out_Qckpt/``).
ckpt_dir = "out_Qckpt"

# When set, solvers append per-restart convergence lines here (the analog of
# the reference's log_Lanczos_<purpose>.txt / log_CG.txt).
solver_log_dir = None

# Mixed-precision Krylov on full sectors: run the Lanczos bulk in float32 on
# the window-contraction engine, then polish in float64 from the f32 Ritz
# vector (models/model.py::_solve_fullspace). The final eigenpair still meets
# the f64 residual gate. Off by default; enable per run via
# initialize(mixed_precision=True) or set directly.
mixed_precision = False

# f32-stage convergence target (residual, relative to |E|); the f64 polish
# stage then runs to the caller's tolerance from this warm start.
mixed_precision_f32_tol = 1e-5

# ------------------------------------------------------------ engine routing
# The eight bounds that decide which engine a sector runs on, one table per
# device type; a model reads the table of its own device (route()).
# - fullspace_max_blowup: a full sector runs on the full-label-space engines
#   (ContractOp / FullSpaceOp) when label_space <= it * dim, else on the
#   sector's matvec (Model._fullspace_op);
#   fullspace_mixed_max_blowup: the same bound under mixed_precision, where
#   the full-label-space engine has an f32 twin and the solve an f32 bulk
#   stage (the JAX package has one bound for both).
# - fullspace_repr_max_blowup: a momentum sector runs as P_k H in the full
#   label space when label_space <= it * dim, else on the explicit route
#   (Model._fullspace_repr_op).
# - bsr_blowup_max, bsr_stored_max_bytes: an explicit momentum solve runs
#   its f32 bulk Krylov stage on the BSR SpMV kernel (ops/bsr.py) when the
#   block fill-in blowup (stored / nnz, bsr_fill_stats) and the stored f32
#   block bytes (x2 when complex) are at most these; the route is considered
#   on a CUDA device only (Model._repr_bsr32).
# - bsr_auto_max_dim: KPM dynamics on a momentum sector with no P_k H
#   engine builds the sector's explicit f64 ELL, and from it considers the
#   BSR route, only up to this dim; above it the recurrence runs on the
#   sector's matrix-free MatvecRepr. An ELL or BSR engine that an earlier
#   solve built is reused at any dim.
# - kpm_fullspace_max_N: KPM dynamics on momentum sectors runs on the float64
#   P_k H engine up to this many labels, else on the sector-dim engine.
# - kron_dense_max_dim: KronOp and KronSharded with layout=None store their
#   factors dense (matrix products) when both factor dims are at most this,
#   else as ELL rows applied by the fused kernel (ops/apply_kron.py).
# "cpu" keeps the JAX package's values (its TPU calibrations; for the kron
# layout its rule on a backend with trusted float64 dots: dense at every
# size), so a CPU run routes as the JAX package does. "cuda" holds the values measured on the
# H100 by quantum_basis_tpu_torch/benchmarks/routing.py in whole solves, the
# set-up included (PERF.md, the routing table).
ROUTING = {
    "cpu": {
        "fullspace_max_blowup": 64.0,
        "fullspace_mixed_max_blowup": 64.0,
        "fullspace_repr_max_blowup": 256.0,
        "bsr_blowup_max": 400.0,
        "bsr_stored_max_bytes": 2 << 30,
        "bsr_auto_max_dim": 1 << 16,
        "kpm_fullspace_max_N": 1 << 23,
        "kron_dense_max_dim": float("inf"),
    },
    # NVIDIA H100 80GB HBM3, 700.00 W: whole solves in s, set-up included,
    # each pair "the route named first / the other" (PERF.md section 5):
    "cuda": {
        # ContractOp in f64 / under mixed_precision / the matrix-free matvec
        # (at MEMORY["cuda"]'s apply_block_budget, 2^28), two runs where
        # they differ by more than 15%: chain-16 Sz=0 (blowup 5.1) 0.82 /
        # 0.38 / 0.21 [0.67 / 0.32 / 0.13], spin-1 chain-10 (6.6) 0.15 /
        # 0.16 / 0.15, chain-24 Sz=0 (6.2) 2.83 / 1.51 / 2.63 (2.98 / 2.81
        # / 2.17 GB peak), chain-26 Sz=0 (6.45) 12.51 / 5.27 / 10.27 (11.8 /
        # 10.9 / 8.3 GB), Hubbard 4x2 (13.4) 0.23 / 0.23 / 0.25, t-J
        # chain-12 (15.3) 0.38 / 0.30 / 0.30, kagome t-J 2x2 (15.3) 0.76 /
        # 0.48 / 0.51 [0.68 / 0.38 / 0.34], chain-24 Sz=-4 (22.8) 2.44 /
        # 1.14 / 0.78, kagome-24 Sz=-4 (22.8) 19.55 / 7.12 / 2.49, Sz=-6
        # (124.6) chain 2.57 / 1.27 / 0.30, kagome 23.59 / 7.25 / 1.18,
        # chain-24 Sz=-7 (394.7) 2.94 / 1.39 / 0.36. In f64 the matrix-free
        # apply wins or ties at every measured blowup, so the bound sits
        # below the smallest (it was 8 at a 2^24 budget, where chain-24
        # Sz=0 took 2.81 / 14.94 matrix-free).
        "fullspace_max_blowup": 5.0,
        # Under mixed_precision the f32 bulk wins at 6.2 and 6.45 (and on
        # kagome-24 Sz=0, 10.2-10.6 against 16.7-16.9 matrix-free,
        # benchmarks/memory.py) and in both runs at 13.4; 15.3 splits; from
        # 22.8 up the matrix-free apply wins every sector.
        "fullspace_mixed_max_blowup": 14.0,
        # P_k H against the explicit f64 ELL: the ELL wins at every
        # measured sector, blowup 8.0 (kagome-24, all Sz, k=(0,2)) 42.27 /
        # 5.25, 15.9 and 20.0 (chain-16, -20, all Sz) 0.21 / 0.08 and 0.63 /
        # 0.19, 24.0 (chain-24, all Sz) 10.08 / 1.56, 49.6 (kagome-24
        # k=(0,2)) 40.96 / 1.18, 60.9 (kagome t-J) 2.08 / 0.30, 80.9 to
        # 113.3, 148.8 (chain-24 k=0) 9.73 / 0.81; the bound sits below the
        # smallest measured blowup.
        "fullspace_repr_max_blowup": 6.0,
        # f32 BSR bulk + f64 polish against the f64 ELL. Off on this card
        # by policy: the bound sits below every measured fill. Per apply
        # the ELL is faster at every fill (benchmarks/bsr_bench.py: 84 to
        # 834, break-even 29.8-31.9 in three runs, whence 31). Whole
        # solves: fill 84 (chain-16 k=0) 0.44 / 0.10, 199 (kagome t-J)
        # 0.24 / 0.24, 308 (kagome-24 k=(0,2)) 1.80 / 0.92 at 53.2 / 22.4
        # GB peak, 340 (tilted-20) 0.48 / 0.49, 374 (chain-20) 0.40 / 0.49,
        # 620 (chain-22) 2.15 / 2.48, 834 (chain-24 k=0) 0.53 / 0.49. Under
        # the rule's form (fill <= bound) every bound from 84 up sends
        # chain-16 k=0 to the BSR (4.4x slower), and the seven sectors
        # together lose 0.34-1.22 s at every such bound, for 2-3x the peak
        # memory.
        "bsr_blowup_max": 31.0,
        # the largest measured stored size (kagome-24 k=(0,2): 20.9 GB of
        # f32 blocks, 53.2 GB peak in the solve). It binds only where
        # bsr_blowup_max admits a sector, which none measured here is,
        # or where a caller pins bsr_blowup_max higher.
        "bsr_stored_max_bytes": 20_865_220_608,
        # KPM (192 moments) on the explicit route (the ELL, or the BSR
        # where bsr_blowup_max admits it: the ELL at every measured fill)
        # against the sector's MatvecRepr, enumeration and ELL build
        # included. On the torch MatvecRepr the ELL won at every measured
        # dim (800 / 8,640 / 9,252 / 338,356: 0.04-0.06 / 0.22-0.32 s, and
        # 0.55 / 4.70 at kagome-24), whence 338,356 until the K9 kernels.
        # On them (benchmarks/routing.py --sections kpm, two runs), the
        # route the earlier bound took (the ELL after the fill statistics)
        # against MatvecRepr: 810 (chain-16) 0.039, 0.040 / 0.030, 0.032;
        # 8,730 (kagome t-J) 0.066, 0.058 / 0.045, 0.049; 9,252 (chain-20)
        # 0.058, 0.053 / 0.036, 0.036; 338,356 (kagome-24) 0.216, 0.283 /
        # 0.175, 0.167 (2.4 / 1.8 GB peak): MatvecRepr won at every
        # measured dim, whence 0. On the ELL apply's kernel (csrc/
        # ell_spmv.cu; two runs, the ELL built in the run / MatvecRepr):
        # 810 0.028, 0.032 / 0.025, 0.040; 8,730 0.034, 0.036 / 0.043,
        # 0.047; 9,252 0.042, 0.030 / 0.041, 0.037; 338,356 0.132, 0.145
        # / 0.198, 0.176 (1.53 / 1.49 GB peak). Both runs give the ELL the
        # largest and the kagome t-J dim, and split near even at the other
        # two: the bound is the largest measured dim.
        "bsr_auto_max_dim": 338_356,
        # KPM on P_k H against the sector-dim engines (ELL / BSR /
        # MatvecRepr): 2^16 labels (chain-16) 0.29 against 0.04 / 0.07 /
        # 0.22, 3^12 (kagome t-J) 0.60 against 0.06 / 0.08 / 0.32, 2^20
        # (chain-20) 0.48 against 0.05 / 0.07 / 0.27, 2^24 (kagome-24) 13.9
        # against 0.55 / 1.91 / 4.70; again on the K9 kernels (two runs):
        # 0.21, 0.15 / 2.2, 2.1 / 0.50, 0.48 / 13.9, 13.7 against at most
        # 0.059 / 0.059 / 0.102 / 1.43 (MatvecRepr 0.030-0.175). The bound
        # sits below the smallest measured label space.
        "kpm_fullspace_max_N": 1 << 15,
        # ProductModel's whole solve on its defaults (mixed, ncv 12), the
        # factors' and the coupling's build included, dense / ELL layout
        # (benchmarks/routing.py --sections kron, two calls; in the second
        # one untimed solve on each layout first), the larger factor dim in
        # brackets: Hubbard 4x2 (3, 2) (56) 0.123 / 0.077 and 0.142 /
        # 0.071, 4x2 (70) 0.073 / 0.061 and 0.058 / 0.072, 4x3 (924) 0.152
        # / 0.144 and 0.168 / 0.126, 4x4 (12870) 72.35 / 17.47 (13.62 /
        # 11.64 GB peak), the 4x4 gap sector (9, 8) (12870) 84.78 / 18.77
        # (13.92 / 10.37 GB). Per apply, f32 and f64 ms, dense / ELL: 70:
        # 0.057-0.078 and 0.064-0.082 / 0.040-0.061 and 0.039-0.062; 924:
        # 0.122-0.124 and 0.106-0.109 / 0.053-0.067 and 0.058-0.071; 12870:
        # 181.6 and 184.6 / 6.99 and 11.86. The ELL wins or ties at every
        # measured dim per apply; of the whole solves only one at 70 came
        # out dense-first, by less than the spread between the two calls.
        # No run shows a dim where the dense layout wins, so the card takes
        # the ELL at every size.
        "kron_dense_max_dim": 0,
    },
}

# ------------------------------------------------------------ memory sizes
# The seven sizes that set what a model holds on its device, one table per
# device type; a reader takes the table of its own device (memory()).
# - ckpt_max_bytes: a restart record (a Krylov basis, an RQI or Lanczos
#   iterate) and a ProductModel completion record larger than this are not
#   written; a Model stage record is written at any size. Without a restart
#   record a crash redoes one solver stage from its warm start; without the
#   completion record it redoes the product solve.
# - direct_lookup_max: label spaces up to this size get an O(1) direct
#   position table on the device (basis/index.py; int32 rows, 4 bytes a
#   label, where the basis has fewer than 2^31 rows); larger ones the Lin
#   tables, else binary search.
# - apply_block_budget: elements of each (rows, terms, images) intermediate
#   of the row blocks of a full sector's DeviceBasis (ops/apply.py), which
#   the ELL build walks, and of the plain versions of the row kernels; a
#   row block holds budget / (images per row * slots) rows, rounded down to
#   a power of two, at least 1024. On a CUDA device the matrix-free apply
#   and mopr_x_vec are one kernel launch each (csrc/apply_rows.cu) and make
#   no such intermediates.
# - repr_block_budget: the same for each (rows, terms, images, group)
#   intermediate of the momentum-sector apply (ops/apply_repr.py), at least
#   256 rows.
# - repr_label_buffer_max: the bytes of a device's label buffer
#   (ops/apply_repr.py::LabelBuffer, 16 a label): a momentum basis whose
#   label space fits takes the entry path of repr_rows, which gathers
#   sqrt(nu_j) x_j by label; a larger one, the general path. 0 on the CPU:
#   the JAX package has no label buffer (and CPU tensors run the plain
#   versions).
# - polish_n: above this full-space N the warm-started f64 stage of a mixed
#   full-sector solve is the RQI polish (or the 2-vector Lanczos) instead of
#   a thick restart (Model._solve_fullspace).
# - product_mixed_above, product_ncv: ProductModel.locate_E0_lanczos with
#   mixed=None takes the f32 bulk + f64 RQI pipeline above this dim, else
#   pure f64 thick restart; ncv=None takes product_ncv.
# "cpu" keeps the JAX package's values, so a CPU run takes the branches the
# JAX package takes. "cuda" holds the values measured on the H100 by
# quantum_basis_tpu_torch/benchmarks/memory.py in whole solves, set-up
# included (PERF.md, the memory table).
MEMORY = {
    "cpu": {
        "ckpt_max_bytes": 512 * 1024 * 1024,
        "direct_lookup_max": 1 << 26,
        "apply_block_budget": 1 << 24,
        "repr_block_budget": 1 << 22,
        "repr_label_buffer_max": 0,
        "polish_n": 1 << 22,
        "product_mixed_above": 1 << 22,
        "product_ncv": 6,
    },
    # NVIDIA H100 80GB HBM3, 700.00 W: whole solves in s, set-up included,
    # peak device GB (PERF.md section 5, the memory table):
    "cuda": {
        # The rule: a restart save costs at most 10% of the 60 s between
        # two (solvers/restarted._SAVE_PERIOD), so the cap is 6 s at the
        # slowest measured save rate. Saves through CkptStore, the device
        # copy included: 0.28 GB in 0.76 s, 1.33 GB (the Hubbard 4x4
        # eigenvector) 3.64 s, 3.49 GB (a complex N = 2^24 restart basis)
        # 12.76 s (0.273 GB/s, the slowest), 9.28 GB (the Hubbard 4x4 f64
        # basis at ncv = 6) 27.07 s; loads at 0.36-0.46 GB/s; 80 GB free.
        # The Hubbard completion records (1.18-1.33 GB) save under it.
        "ckpt_max_bytes": 1_640_822_776,
        # Above it the index is the Lin tables (else binary search). Index
        # + basis + ELL build + ELL solve, direct / Lin / binary search:
        # chain-26 Sz=0 (2^26 labels) 6.95 / 11.04 / 6.11, chain-28 Sz=0
        # (2^28) 27.07 / 47.75 / 24.40 (Lin's host BFS 4.9 and 22.4 s, the
        # direct table 0.39 and 1.42 s; 50.7 GB peak at 2^28). The direct
        # table beats the Lin tables, the mode taken above the bound, at
        # both label spaces, so the bound is the larger.
        "direct_lookup_max": 1 << 28,
        # The matrix-free full-sector solve at 2^24 / 2^26 / 2^27 / 2^28 /
        # 2^29: kagome-24 Sz=0 105.3 / 29.4 / 18.8 / 16.8 / 16.7 (15.2 ms
        # an apply at 2^28, 72.9 at 2^24; idle share 87% -> 18%), chain-24
        # Sz=0 10.65 / 3.47 / 2.59 / 2.59 / 2.69, kagome-24 Sz=-4 12.8 /
        # 3.14 / 2.67 / 2.45 / 2.39, chain-24 Sz=-4 3.42 / 1.14 / 0.78 /
        # 0.75 / 0.90, Sz=-6 0.87 / 0.43 / 0.35 / 0.25 / 0.23; the small
        # sectors (Hubbard 4x2, t-J chain-12, kagome t-J 2x2) 0.2-0.9 at
        # every budget; peak 1.31 / 1.36 / 1.47 GB at dim 2,704,156 (2^27 /
        # 2^28 / 2^29). Seconds stop falling at 2^28. chain-24's
        # mopr_x_vec of Sz(q) 13.5 ms at 2^27, 17.4 at 2^28, 29.2 at 2^29.
        # (Measured on the block-loop apply that csrc/apply_rows.cu has
        # since replaced on the card.)
        "apply_block_budget": 1 << 28,
        # MatvecRepr per apply (7 samples) at 2^22 / 2^24 / 2^25 / 2^26 /
        # 2^27: kagome-24 k=(0,0) 50.1 / 17.5 / 18.5 / 17.8 / 23.1 ms
        # (1.75 / 3.29 / 6.38 GB peak at 2^25 / 2^26 / 2^27), chain-24 k=0
        # 27.0 / 8.5 / 5.0 / 4.7 / 3.8 ms; their sum is least at 2^26.
        # Chain-24's continued fraction (40 steps, target sector built)
        # 1.35 / 0.46 / 0.31 / 0.32 / 0.28 s.
        "repr_block_budget": 1 << 26,
        # MatvecRepr per apply by label / on the general path (7 samples;
        # memory --sections repr_label): kagome-24 k=(0,2) (2^24 labels,
        # 256 MiB) 0.112 / 0.466 ms, chain-24 k=0 0.046 / 0.179, chain-26
        # k=0 (2^26 labels, 1 GiB) 0.125 / 0.553 (1.44 GB peak). The buffer
        # wins 4x at every measured label space; one a device, so the bound
        # is the largest measured (every kagome-24 momentum alive at once:
        # no byte added by their applies).
        "repr_label_buffer_max": 1 << 30,
        # The mixed full-sector solve on ContractOp, its warm f64 stage as
        # a thick restart / the RQI polish: chain-20 Sz=0 (N = 2^20) 1.42 /
        # 0.56, chain-22 (2^22) 2.82 / 2.19, chain-24 (2^24) 2.67 / 1.16
        # (196 / 2 f64 applies; 3.34 / 2.13 GB), kagome-24 (2^24) 40.6 /
        # 10.6 (926 / 2), chain-26 (2^26) 11.1 / 5.3 (13.1 / 8.3 GB). The
        # polish wins at every measured N, so the bound sits below the
        # smallest.
        "polish_n": 1 << 19,
        # Hubbard at half filling through ProductModel, pure f64 thick
        # restart / the mixed pipeline at ncv 6, 12, 24: 4x4 (dim
        # 165,636,900) 479.4 / 109.5, 305.7 / 74.7, 211.1 / 75.0 s (2212 /
        # 511, 1378 / 322, 898 / 317 applies; peak 21.4 / 13.6, 24.1 / 13.6,
        # 40.0 / 20.1 GB); 4x2 (dim 4,900) 1.02 (the run's first solve) /
        # 0.108, 0.132 / 0.071, 0.100 / 0.049. The mixed pipeline wins at
        # both dims, so the bound sits below the smaller; ncv 12 ties 24
        # at 4x4 in 6.5 GB less. The (9,8) gap sector at mixed ncv 12:
        # 85.8 s (471 f32 and 2 f64 applies).
        "product_mixed_above": 1 << 12,
        "product_ncv": 12,
    },
}

# prefer_bsr = True/False overrides the BSR routing on any device (the CPU
# tests force True).
prefer_bsr = None


def route(name: str, device) -> float:
    """The routing bound ``name`` for a model on ``device``: the entry of
    its device type's table in ROUTING."""
    return ROUTING[torch.device(device).type][name]


def memory(name: str, device):
    """The memory size ``name`` for a model on ``device``: the entry of its
    device type's table in MEMORY."""
    return MEMORY[torch.device(device).type][name]


@contextlib.contextmanager
def pinned(**values):
    """Hold config values for a block, then restore them. A routing bound or
    a memory size (a key of ROUTING's or MEMORY's tables) is held in every
    device type's table, so a caller that wants one route or size on
    purpose gets it on any device; any other name (``prefer_bsr``,
    ``mixed_precision``, ...) is this module's attribute."""
    g = globals()
    saved = []
    try:
        for name, v in values.items():
            tables = next((t for t in (ROUTING, MEMORY) if name in t["cpu"]),
                          None)
            if tables is not None:
                for table in tables.values():
                    saved.append((table, name, table[name]))
                    table[name] = v
            elif name in g:
                saved.append((g, name, g[name]))
                g[name] = v
            else:
                raise AttributeError(f"config has no {name!r}")
        yield
    finally:
        for where, name, v in reversed(saved):
            where[name] = v


def initialize(enable_checkpoint: bool = False, quiet: bool = False,
               mixed_precision: bool | None = None) -> None:
    """Set up the library and print an environment banner."""
    globals()["enable_ckpt"] = bool(enable_checkpoint)
    if mixed_precision is not None:
        globals()["mixed_precision"] = bool(mixed_precision)
    if quiet:
        return
    print("=" * 64)
    print("quantum_basis_tpu_torch")
    print(f"torch      : {torch.__version__} (cuda {torch.version.cuda})")
    if torch.cuda.is_available():
        print(f"device     : {torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}")
    else:
        print("device     : no CUDA device")
    print(f"checkpoint : "
          f"{'enabled -> ' + ckpt_dir if enable_ckpt else 'disabled'}")
    print("=" * 64)
