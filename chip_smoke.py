"""End-to-end check of the PyTorch port on one CUDA card.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises, so the exit code is nonzero):
1. a CUDA device must be present; prints the card, its power limit and the
   torch/CUDA versions;
2. builds the kernels (csrc/bsr_spmv.cu, csrc/kron_ell.cu,
   csrc/apply_rows.cu, csrc/krylov.cu, csrc/apply_repr.cu,
   csrc/ell_build.cu, csrc/ell_spmv.cu) with nvcc, one process each, all
   at once;
3. holds the kernel against its plain PyTorch version on the card, on a
   momentum sector of the 20-site tilted cluster (f32: the shape of the
   kernel's main path, phase 4b), on the
   chain-20 k=0 and kagome t-J k=(0,1) momentum-sector matrices (f32, f64),
   chain-22 k=0 (f32), a matrix with empty row tiles and a diagonal-only
   one; tolerance 1e-12 * max|y| (f64), 1e-5 * max|y| (f32); times both
   (CUDA events, median of 25 samples), times the one PyTorch call that
   computes the same product (``torch.sparse_bsr_tensor(...) @ x``, used
   nowhere in the package) and computes the least time the card could take
   (bytes over 3.35 TB/s against operations over the peak rate);
4. drives the momentum-sector ground-state route through Model(...,
   device="cuda"). (a) kagome t-J 2x2 N=8 Sz=0 at all four momenta against
   the reference goldens (1e-8) and chain-20 k=0 Sz=0 against the port's
   pure-f64 ELL Lanczos (1e-9), each asserted to run as P_k H on a
   ProjectedFullOp. (b) The kernel's main path: the tilted square cluster of
   20 sites (A = [[4,2],[-2,4]], nearest-neighbour Heisenberg, Sz=0, sector
   dim 184,756) through TiltedLattice -> enumerate_basis_repr at its 20
   momenta -> locate_E0_lanczos(which="repr") -> measure_repr_static, with
   no prefer_bsr: asserts that _fullspace_repr_op gives no engine, that each
   f32 bulk engine is a float32 BsrMatrix, that the kernel was launched, that
   the sector dims add up, and that min_k E0(k) equals the full-sector E0 of
   the same model (1e-9);
5. drives the full-sector route (enumerate_basis_full -> locate_E0_lanczos /
   locate_E0_iram -> measure_full_static) on the card: the self-test goldens
   (chain-16: E0 and three correlators; t-J chain-12: the degenerate pair;
   1e-8; both now solved on the window-contraction engine, asserted by
   type), then at dim 2,704,156 the chain L=24 Sz=0 (matrix-free, through
   locate_E0_lanczos("full"), which the card's table routes to MatvecFull:
   one apply_rows launch per apply, counted from 0 around the solve; and
   ELL: E0 equal to 1e-10, H x equal to 1e-12 * max|y|, the residual under
   the gate, <Sz0 Sz1> = E0/72 to 1e-9 through one scatter_rows launch)
   and the 24-site kagome Heisenberg Sz=0 sector on the ELL (E0 =
   -10.759897248084 to 1e-8), and the f64 BSR kernel through
   locate_E0_iram(which="repr") with config.prefer_bsr; prints the set-up,
   per-apply and solve times and the peak device memory;
6. the full-label-space engines at N = 2^24 on the same two sectors:
   ContractOp f64 and f32 and FullSpaceOp f64 H x against the ELL (1e-12 *
   max|y|; f32 5e-6), their per-apply times beside the ELL's and the
   matrix-free apply's, the contraction plan; locate_E0_lanczos() on
   ContractOp in pure f64 and under config.mixed_precision (f32 bulk + f64
   RQI polish): E0 equal to the ELL solve's to 1e-10 and to the golden, the
   residual under the gate, matvec counts, seconds, peak memory; chain-16
   ContractOp on a complex vector;
7. the factorized route: Hubbard 4x2 half filling through ProductModel, pure
   f64 and mixed (golden -14.07605866, 1e-8); Hubbard 4x4 half filling, U =
   1.1, dim 165,636,900, on ProductModel's defaults, so on the card's route:
   both engines asserted to be the ELL layout (kron_dense_max_dim), the
   host's build of the int8 coupling timed apart, KronOp f32 against f64
   (5e-6 * max|y|) and against the factor ELLs applied row- and column-wise
   (1e-11 * max|y|), per-apply times and resident bytes, then
   ProductModel.locate_E0_lanczos() (E0 = -20.497352266554 to
   1e-8, residual under the gate; checkpointing on, in a temporary
   directory that phase 16 reads) when the projected time fits, else a
   capped f32 Lanczos cycle whose Ritz value must lie above that E0 and
   within 1e-2 of it; measure_product_static double occupancy;
8. momentum sectors at full width, N = 2^24, on the two models of phases
   5-6, as P_k H on the contraction engine with block-transpose
   translations: chain L=24 Sz=0 k=0 (E0 equal to phase 5's ELL E0, 1e-9),
   kagome 2x4 Sz=0 k=(0,2) (E0 = -10.759897248084, 1e-8) and k=(0,0) (E0 =
   -10.70614979406, 1e-8), each in pure f64 and under
   config.mixed_precision, residual under the gate, routed by type; P_k H x
   against P_k applied to the ELL's H x and P_k idempotent (1e-12 * max|y|);
   for kagome k=(0,2) also method="dnc" (representatives equal to "direct")
   and the explicit route on the same sector; prints enumeration, projector
   and engine build seconds, per-translation ms beside its bytes bound, P_k
   and P_k H per apply, solve seconds, matvec counts, peak memory. The f64
   solve of kagome k=(0,0) is dropped (and said so) when the script would
   pass its budget;
9. resume: with config.enable_ckpt and a temporary ckpt_dir, the chain-24
   thick restart on the ELL (dim 2,704,156) is interrupted after a save by
   an exception from a counting wrapper around the matvec, then resumed:
   same E0 (1e-10), fewer matvecs than the cold run, the restart record
   deleted; a further locate_E0_lanczos() returns from the stage record
   without a matvec; prints save seconds and bytes; removes the directory;
10. dynamics and spectra through the Model entry points: (a) S(q, w) of the
   tilted cluster of phase 4b from its ground-state sector k = (-12, -4), at
   all 20 q (A = Sz(q), target sector k - q): measure_repr_dynamic_kpm with
   192 moments and bounds from energy_scale, both on the f32 BSR kernel (no
   target sector has a full-space engine): each engine a float32 BsrMatrix
   that was launched, norm 0 at q = 0, sum_q norm_q^2 = N/4 = 5 (1e-10),
   mu_0 = 1 (1e-6), |mu_n| <= 1 + 1e-5, for two q the moments of
   chebyshev.kpm_moments on the f64 ELL with the same bounds (5e-5), and
   measure_repr_dynamic (40 steps, on the target's MatvecRepr: repr_rows)
   the same norm (1e-12); (b) the flagship
   benchmarks/flagship_kagome24_sqw.py at N = 2^24: the 8 q of the cell zone
   from phase 8's k0 = (0,2) ground state, 192 moments each on the float64
   P_k H engine (kpm_fullspace_max_N pinned to 2^24, as the flagship sets it)
   with the shared bounds of SQW_kagome24.json: norms within 1e-7 and
   moments within 1e-4 of that file, sum_q norm^2 = 0.8044558613240673
   (1e-7), |mu_n| <= 1 + 1e-9, the target sector k = (0,0)'s own
   energy_scale bounds (slack 0.05) inside the shared ones, and three
   applies of its MatvecRepr timed; (c) measure_full_dynamic (40 steps) of
   Sz(q) at all 24 q of chain L=24 Sz=0 on phase 5's ELL: norm 0 at q = 0,
   sum_q norm_q^2 = L/4 = 6 (1e-10), for two q norm_q^2 =
   sum_r e^(-iqr) <Sz_0 Sz_r> from measure_full_static (translation-averaged
   correlators, 1e-9), and one q
   through measure_full_dynamic_kpm, whose S(q, w) (sqw_kpm) integrates to
   norm^2 within 2%; (d) locate_Es on chain-16 Sz=0 (dim 12,870, ELL) with a
   window of its lowest 3-6 levels: the eigenvalues of the dense sector
   matrix (eigvalsh on the card) to 1e-9, residuals under 1e-6. Prints
   seconds per q, ms per apply, moments per second and peak memory;
11. the variational (Trugman) sector at full width on the Holstein polaron
   chain (L = 16, spinless fermions and bosons with Nmax = 3, t = w = g = 1,
   label space 2^48; the generator is H, the seed the electron at site 8,
   the vacuum the ground state at k = 0, N_e = 1) through Model(...,
   device="cuda"): (a) build_basis_vrnl at depths 8, 12 and 14: dims 475,
   7,491 and 28,956, the labels and the skeleton arrays bit-equal to the JAX
   package's (CRC32), E0(k=0) non-increasing with depth and -2.466611199168856
   at depth 14 (1e-9), MatvecVrnl against at_momentum(k) @ x at depth 8 and
   9 k (1e-12 of max|y|); (b) the polaron band at k = j/16, j = 0..8, from
   one skeleton (asserted reused): locate_E0_lanczos(which="vrnl") equal to
   the JAX package's E(k) (1e-9), residual under 1e-8, measure_vrnl_static
   of N_e = 1 (1e-9), one MatvecVrnl apply timed; (c) measure_vrnl_dynamic
   of B_k = sum_x e^(2 pi i k x) c+_x, 100 steps, at the same k: norm 1 and
   alpha_0 = -2 cos 2 pi k (1e-12), and for j = 0..4 the lowest pole of the
   tridiagonal matrix at E(k) (1e-8) with the weight |<psi_0(k)|B_k|0>|^2
   (1e-6); (d) wannier_mat_vrnl of the one-magnon band of a chain of 16
   spins (A_r = Sz_r, 8 momenta) against its analytic value (1e-9), then
   again from its per-k records (config.enable_ckpt, a temporary ckpt_dir)
   with no eigh; (e) 10^5 random labels of the Holstein space canonicalized
   on the card against a host oracle (labels, displacements, fermion
   signs). No BSR launch on this path. Prints grow, skeleton, solve, apply
   and per-k seconds and the peak device memory;
12. the multi-device route (parallel/*) on this one card. (a) A 1-rank
   NCCL group in this process (file:// rendezvous in a temporary
   directory, destroyed at the end): chain L=24 Sz=0 through Model(mesh=):
   sharded dnc enumeration + sample sort (labels equal to phase 5's), the
   router's EllShardedHalo (asserted by type), locate_E0_lanczos() equal
   to phase 5's ELL E0 (1e-10) with the residual under the gate, <Sz0 Sz1>
   = E0/72 (1e-9); MatvecSharded, EllShardedHalo and FullSpaceSharded
   (N = 2^24) H x against the ELL and FullSpaceOp (1e-12 * max|y|);
   kagome 2x4 Sz=0 k=(0,2) through enumerate_basis_repr(method="dnc") and
   locate_E0_lanczos(which="repr") on the complex halo engine
   (-10.759897248084, 1e-8); KronSharded against KronOp on Hubbard 4x4 in
   both layouts (layout="ell" on the fused kernel against KronOp's ELL,
   "dense" against KronOp's dense; f64 1e-12, f32 5e-6 * max|y|);
   ProductModel(mesh=) on Hubbard 4x2,
   pure f64 and mixed (-14.07605866, 1e-8). Prints the NCCL start-up,
   enumeration, build and solve seconds, each sharded engine's per-apply
   ms beside its single-device twin's, and the peak device memory.
   (b) Two ranks on the card over gloo, which stages CUDA tensors through
   the host, as processes of this script (``--mesh-rank``): chain-24
   through Model(mesh=): E0 equal to 12a's (1e-10), halo_stats() equal to
   the host's numpy computation for P = 2; its times are labelled as not
   multi-GPU times. Groups of 2 and 4 cards over NCCL, FullSpaceSharded's
   point-to-point included, are phase 14 (``--ranks N``);
13. the drivers (quantum_basis_tpu_torch.examples and .benchmarks) on the
   card's own routing bounds (config.ROUTING["cuda"]): the main() of the 11
   example drivers that run here (every one but the triangular-31 KPM
   driver, whose cluster file the repository does not hold) at their golden
   sizes, each asserting its goldens (1e-8) and printing the engine and
   seconds of every sector; chain S(q, w) sum rule (1e-10); the kagome-24
   flagship (full sector and its 8 momenta: sum of dims = 2,704,156, min_k
   E0 = E0(full) to 1e-10, -10.759897248084 to 1e-8); its S(q, w) at 8 q x
   192 moments against SQW_kagome24.json (norms 1e-7, moments 1e-4, each
   target sector's own bounds inside the shared ones, |mu_n| <= 1 + 1e-9);
   the Hubbard gaps driver on the 4x2 cluster (four sectors, residuals under
   the gate); bsr_bench on its widened cases (the kernel against the ELL on
   the card, f32 tolerance), whose launches count in the kernel record;
14. (``python3 chip_smoke.py --ranks N`` only, on N cards of one host:
   not part of the default run) the multi-device route over NCCL: a group
   of N ranks, then (N > 2) one of 2, each rank a process of this script
   (``--ranks-worker``) on its own card. Against the single-device chain-24
   ELL solve made first on card 0: chain L=24 Sz=0 through Model(mesh=)
   (sharded dnc enumeration equal to the single-device labels,
   EllShardedHalo by type, E0 to 1e-10 and bit-equal on every rank,
   residual under the gate, <Sz0 Sz1> = E0/72 to 1e-9, halo_stats() equal
   to the host's numpy values for P; MatvecSharded, halo and
   FullSpaceSharded (2^24) H x against the rank's own MatvecFull / ELL /
   FullSpaceOp to 1e-12 max|y|); the chain-24 resume on the mesh
   (config.enable_ckpt: interrupted after a save on every rank at once,
   rank 0 holding the whole (13, n_pad) restart record; resumed to the cold
   E0, 1e-10, with fewer applies, the record deleted, the next call without
   an apply, the temporary ckpt_dir removed); kagome 2x4 Sz=0 k=(0,2) by
   dnc on the mesh (-10.759897248084, 1e-8); KronSharded against KronOp on
   Hubbard 4x4 in both layouts (f64 1e-12, f32 5e-6) and ProductModel(mesh=)
   4x2; the Hubbard 4x4 solve through ProductModel(mesh=) on the card's
   route (every engine the ELL layout; -20.497352266554, 1e-8, f64
   residual under its gate). Prints one ``mesh<P>`` record per
   workload (NCCL start-up s, a scalar all-reduce ms, enumeration, build
   and solve s, applies, per-apply ms beside the single-device engine's,
   peak bytes of the largest rank, the card line). Then the drivers
   benchmarks/scaling.py (1, 2, 4, ..., N ranks; JSON lines in
   scaling.jsonl of the benchmarks' output directory) and
   benchmarks/comm_roofline.py (comm_roofline.jsonl). Raises when the
   machine has fewer than N cards; there is no fallback to fewer ranks or
   to gloo;
15. prints the kernel record (launches on the main path: bsr_spmv's in
   phases 4, 5, 10 and 13, kron_ell's in phase 7's 4x4 solve, two per apply,
   apply_rows' in phase 5's chain-24 solve and scatter_rows' in its
   measure_full_static, the K6 kernels' in phase 5's chain-24 solve and
   phase 7's 4x4 solve, the K9 kernels' in phases 4, 8 and 10, ell_rows'
   in every ELL build of the run before phase 21 (phase 5's, the mesh
   route's, the drivers', phase 7's factors', phase 18's; by window),
   ell_spmv's in the ELL solves of phases 5
   (chain-24 and kagome-24 Sz=0) and 8 (the explicit route at kagome-24
   k=(0,2)), each asserted equal to the solve's ELL applies, each count
   set to 0 just before its path and read just after; the worst
   error against the plain version, the
   kernel's, plain version's and library call's ms and the bound at the
   main path's shape), the card line, and as the last line
   {"ok": true, "device": {...}} (with ``--ranks N``: the card line and
   the last line, whose count is N, the cards the run used);
16. (after phase 7, before 15) the memory sizes of config.MEMORY["cuda"],
   each read by a model on the card at full width: chain-24 Sz=-4's
   DeviceBasis has the block rows of apply_block_budget and its solve on
   the table's route equals the ELL's (1e-10); chain-24 k=0's ReprBasis
   has those of repr_block_budget (E0 = -10.670014516537, 1e-9), and its
   repr_rows reaches rows by label where repr_label_buffer_max holds 16
   bytes a label; the mixed solve of chain-24 Sz=0 on ContractOp (N =
   2^24) takes the polish branch of polish_n (same golden); chain-26 Sz=0
   has the lookup mode of direct_lookup_max, and 2^20 of its labels look
   up to their rows;
   Hubbard 4x2 with ProductModel's defaults takes the pipeline and ncv of
   product_mixed_above and product_ncv (golden, 1e-8); phase 7's Hubbard
   4x4 completion record (1.33 GB, under ckpt_max_bytes) is resumed by a
   new model with no apply and the same E0. When phase 7 was capped the
   record is written from the golden and a unit vector through the same
   method. Prints one ``memory`` record;
17. (after 16, before 15; ``--kron-ell`` runs it alone) the fused ELL kron
   kernel (csrc/kron_ell.cu) against its plain version and against the
   dense layout, on Hubbard 4x2 and 4x4 at half filling and the 4x4 gap
   sector (9, 8) (two factors), f64 (1e-12 * max|y|) in the compact slot
   form (chosen by type and shape) and again in the wide form, and f32
   (5e-6) in the wide form; at 4x4 its time (CUDA events; f64 in both
   forms) and per pass (torch.profiler) beside the plain version's, the
   dense layout's and the
   library call's (one torch.sparse.mm CSR product per side, checked
   against the kernel with the diagonal added, used nowhere in the
   package), the least time the card could take (bytes: psi, P and the
   factor ELLs read once, y written once; operations: 2 per live factor
   entry per column, 6 per output) and the two passes' floor in device
   memory (pass 1 reads psi and writes its sums, pass 2 reads psi, those
   sums and P and writes y), which phase 17's record keeps and the
   kernels line does not; then a synthetic apply whose rows are too long
   for one staged panel (nb = 30,000: pass 2 gathers from device memory, B
   in the wide form by shape in f64 too; f64 and f32) against the plain
   version. Its launches are not counted in the kernel record's.
18. (after 17, before 15; ``--apply-rows`` runs it alone) the fused row
   apply (csrc/apply_rows.cu) against its plain versions, 1e-12 * max|y|:
   apply_rows through MatvecFull on chain-24 Sz=0 (direct index, int32
   rows; again with lin and bsearch forced), Sz(q) on chain-24 in the
   gather direction (every column diagonal, complex), an all-pairs exchange
   with complex couplings on chain-24 (276 columns, 40 KB of tables: the
   instance that reads them through the read-only cache), kagome-24 Sz=0,
   Hubbard 4x3 (N_up, N_dn) = (6, 6) (dim 853,776, slots of two fermions),
   the DM chain L=24 Sz=0 (complex H, complex vector), the spin-1 chain
   L=16 Sz=0 (dim 5,196,627; local dim 3, so slot values staged from V),
   chain-26 Sz=0 and MatvecSharded on a 1-rank NCCL group; scatter_rows
   through mopr_x_vec of <Sz0 Sz1> (phase 5's shape), Sz(q) and S^-(q)
   from Sz=0 into Sz=-1 on chain-24. At chain-24, kagome-24, spin-1 and
   chain-26 (and the scatter at <Sz0 Sz1> and Sz(q)) it times the kernel
   (CUDA events, 9x3, around the wrapper's call; and the launch's device
   time alone, torch.profiler over 5 calls), the plain version, the
   library call (one torch.sparse CSR product of the same matrix, diagonal
   included, checked against the kernel and used nowhere in the package),
   at chain-24 the kernel in lin mode, and for the two scatters (every
   column diagonal) the row's own add as a plain store against an atomic
   add in turns; and computes the least time the card could take (bytes:
   each row's label or V, Fodd, diagonal and x read and y written once,
   the packed tables, the 32-byte sectors of the index that this run's
   nonzero images touch; over 3.35 TB/s); then solves chain-26 Sz=0 (dim
   10,400,600) through locate_E0_lanczos("full") on MatvecFull and on its
   ELL: E0 equal to 1e-10, both residuals under the gate.
19. (after 18, before 15; ``--krylov`` runs it alone) the Krylov basis work
   (csrc/krylov.cu, K6) against its plain versions, on a basis of 14 random
   unit vectors at the two main-path shapes, the Hubbard 4x4 f32 basis (n =
   165,636,900) and chain-24 Sz=0 in f64 (n = 2,704,156): a CGS2 step at r =
   4, 8 and 13 (rows 0..r-1 read, row r written; the kernels' four passes,
   the plain versions, the torch CGS2 they replaced) checked (f64 1e-12,
   f32 1e-5 of max|y|, or of 1 for inner products of unit vectors) and
   timed (CUDA events; the four launches' torch.profiler device time); at r
   = 8 each pass alone; krylov_project at r = 4, 8 and 13 beside one cuBLAS
   GEMV, and the compaction of m + 1 rows to 3 at m = 4, 8, 12 (the main
   path's) and 13 beside the GEMM S^T V, each checked against its plain
   version; with bounds from this run's shapes (bytes: (r + 1), (r + 2),
   (r + 2) and 2 vectors a pass, 2 (m + 1) for the compaction; over 3.35
   TB/s); on chain-24's dim the compaction of 120 rows (past the 113 the
   first kernel staged) in float64 and complex128 to keep 3, 59 and 99
   against the plain version (1e-12); then ||V^H V - I|| after one full
   expand of 12 steps on the 4x4 f32 KronOp (1e-5) and on chain-24's
   MatvecFull (1e-12). Phases 5 and 7 reset the K6 counts before their
   chain-24 and 4x4 solves and assert one launch of each step kernel per
   Krylov step (the solve's applies; the f32 stage's at 4x4) and at least
   one compaction; the kernel record's K6 launches are those two solves'.
20. (after 19, before 15; ``--apply-repr`` runs it alone) the
   momentum-sector kernels (csrc/apply_repr.cu, K9) against their plain
   versions: on kagome-24 Sz=0 at k = (0,0) and (0,2), chain-24 Sz=0 at k
   = 0 and 5 and the honeycomb spinless fermions 4x3 at half filling
   (2^24 labels, G = 12) at k = (0,0) and (1,0), repr_rows (MatvecRepr),
   repr_rows on the general path (int64 per slot: ENTRY_TABLES_MAX = 0;
   each sector's repr_rows after another's clears the device's one label
   buffer),
   repr_images (the ELL build's finished rows, against the plain build:
   columns and W exactly, values to 1e-14 of max|v|) and
   repr_scatter of H from the sector into itself (f64 atomics, through a
   launch record), to 1e-12 of max|y| or 4x the measured spread of two
   kernel runs where wider (stated in the output); repr_scatter of the
   diagonal wave Sz(q) (density for the fermions) from one momentum into
   the other through mopr_x_vec_repr and through its launch record (no
   translation, plain stores). At kagome-24 k=(0,2) and chain-24 k=0
   times each kernel (CUDA events; torch.profiler's device time; the host
   time of one call through the engine's launch record, for repr_rows,
   the H scatter and the wave; the general path's repr_rows) beside its
   plain version, its bound (bytes: each row's
   label, 1/sqrt(nu), Fodd, diagonal and x read once, y or the images
   written once, the tables, the 32-byte sectors of the position table,
   labels and sqrt(nu) that this run's images touch; over 3.35 TB/s) and
   one torch.sparse CSR complex128 product of the same matrix (used
   nowhere in the package), with the sector's ELL apply beside it. Phases
   4, 8 and 10 count the three kernels' launches on the main path and
   assert each one launched.
21. (after 20, before 15; ``--ell-build`` runs it alone) the explicit ELL
   builds at full width through both kernels, each against its plain
   version on the card (columns and W exactly, values to 1e-14 of max|v|)
   and the built ELL's H x against MatvecRepr's / MatvecFull's (1e-12 of
   max|y|): repr_images (csrc/apply_repr.cu) on kagome-24 Sz=0 k=(0,2),
   chain-24 Sz=0 k=0 and the honeycomb spinless fermions 4x3 at k=(0,0);
   ell_rows (csrc/ell_build.cu) on chain-24 and kagome-24 Sz=0 (dim
   2,704,156), chain-26 Sz=0 (10,400,600) and t-J-12 N=8 Sz=0. Each
   build's seconds (plain, kernel, kernel, plain), peak bytes (the
   kernel's asserted no higher than the plain build's), launches (two a
   build), CUDA-event and device ms, and bound (each row's label and the
   tables read once, the 32-byte sectors of the position table and of the
   destination records at the entries' columns, the ELL written once, and
   for ell_rows the rows' lengths; over 3.35 TB/s). For ell_rows also the
   rows' lengths the build wrote against row_lengths of its values, the
   row stage it took (ell_build.PATHS: in registers, rows a warp), its
   instances' registers (cuobjdump -res-usage of the built library), and
   the build split by CUDA events (ell_build.trace): the host work before
   the count pass, the count pass, the host gap between the passes (the
   host sync and the output allocations, their host seconds apart), the
   write pass. Phase 5 counts ell_rows' launches on its main path (the
   full sectors' ELL builds) and asserts it launched; phases 8 and 13
   print the momentum ELL builds' seconds beside their solves.
22. (after 21, before 15; ``--ell-apply`` runs it alone) the ELL apply
   (csrc/ell_spmv.cu, K3) against its plain version on the card, 1e-12 of
   max|y|, through the matrix's launch record (int32 columns, the main
   path's call) and through the functional wrapper on int64 columns: the
   explicit momentum sectors kagome-24 Sz=0 k=(0,2) (dim 338,356) and
   chain-24 Sz=0 k=0 (complex), the full sectors chain-24 and kagome-24
   Sz=0 (dim 2,704,156, real values; a real and a complex x), MatvecVrnl of
   the Holstein chain at depth 14 and k = 1/4 (phase 11's sector) and a
   diagonal-only matrix (W = 0); each timed (CUDA events 25x5, the launch's
   torch.profiler device time, the record's host time a call over 200
   calls, the int64 instance) beside its plain version, one torch.sparse
   CSR product of the same matrix with the diagonal (used nowhere in the
   package), the mean live slots a row and two bounds (bytes over 3.35
   TB/s: the live slots at int32 columns, the row lengths, the diagonal
   and x read once, y written once; and the stored columns and values in
   place of the live slots).

Phases 4a, 8 and 10b drive P_k H and phases 4b and 10a the BSR bulk stage
on purpose: they pin the JAX package's values of the bounds that select
those routes (config.ROUTING["cpu"]), as phase 5 does for its two goldens on
ContractOp, phase 6 for its solves on ContractOp and ``--profile`` for its
ContractOp windows. Phases 8 to 13 run before phase 7, whose 4x4 solve
(through benchmarks/hubbard4x4.py) is the one part that is capped when the
script would pass its budget.

``python3 chip_smoke.py --profile`` runs, instead of phases 2-15, windows
under ``torch.profiler`` (the matrix-free solve of chain-16; a matrix-free
apply, a ContractOp f64 apply and solve, 20 ELL applies and the ELL solve at
dim 2,704,156 on the chain, a ContractOp f64 apply on the kagome cluster, a
P_k H apply at N = 2^24 on both; one q of the tilted cluster's KPM S(q, w) on
the BSR kernel; phase 11's vrnl growth, skeleton, solve and MatvecVrnl
applies at depth 14; a KronOp f32 apply at dim 165,636,900 in each
layout and the 4x4 solve on ProductModel's defaults) and prints each
window's wall time,
device-busy time, idle share and its three longest device operations; it
prints no result line.
``python3 chip_smoke.py --hubbard4x4`` runs phase 7 alone with the full 4x4
solve, whatever its projected time; ``--mesh`` runs phase 12 alone (after
the chain-24 ELL solve it compares with); ``--gaps`` runs the Hubbard gaps
driver on the 4x4 cluster (four sectors of dim 1.3-1.7e8, E0(8,8) held to
-20.497352266554) with a temporary checkpoint directory, then again, every
sector resumed from its completion record with no apply and the same gaps;
``--bsr-bench`` runs bsr_bench alone; ``--kron-ell`` phase 17;
``--apply-rows`` phase 18; ``--krylov`` phase 19; ``--apply-repr`` phase
20; ``--ell-build`` phase 21; ``--ell-apply`` phase 22; ``--ranks N``
runs phase 14 alone. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import torch

from quantum_basis_tpu_torch.benchmarks import card_line

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, published peak
PEAK_FLOPS = {torch.float32: 67e12,       # outside the tensor cores
              torch.float64: 33.5e12}     # half the float32 rate
E0_CHAIN16 = -7.142296361
E0_CHAIN24 = -10.670014516537       # Sz=0 (and its k=0 sector)
CHAIN16_CORR = {"Sz0Sz1": -0.1487978408, "Sz0Sz2": 0.0617414604,
                "Sp0Sm1": -0.2975956817}
E0_TJ12 = -9.762087307
E0_KAGOME24 = -10.759897248084
E0_KAGOME24_K00 = -10.70614979406   # k = (0, 0), dim 338,376
KAGOME24_DIMS = {(0, 2): 338356, (0, 0): 338376}
TILTED_A = [[4, 2], [-2, 4]]        # 20-site tilted square cluster
TILTED_K_GS = (-12, -4)             # its ground-state sector (phase 4b)
TILTED_DIM = 184756                 # C(20, 10)
E0_HUBBARD_4X2 = -14.07605866
E0_HUBBARD_4X4 = -20.497352266554
DIM_24 = 2704156
SCRIPT_BUDGET_S = 900.0  # the 4x4 solve is capped if the script would pass it
HUBBARD4X4_DIMS = (12870, 165636900)  # factor dim C(16,8), sector dim
# phase 13: the example drivers that run on the card (the triangular-31
# driver needs its cluster's TOML file, which the repository does not hold)
EXAMPLES = ("chain_heisenberg_spin_half", "chain_dynamics_sqw",
            "chain_heisenberg_spin_one", "chain_tj", "chain_kondo",
            "square_bose_hubbard", "square_fermi_hubbard", "square_kondo",
            "honeycomb_spinless_fermion", "triangular_heisenberg",
            "kagome_heisenberg_tj")
# applies of the full Hubbard 4x4 solve (ProductModel defaults on the card:
# mixed, ncv 12; seed 1), as counted on an NVIDIA H100 80GB HBM3 (192 in the
# f32 bulk, 123 in the RQI inner solves and up to 16 uncounted ones per
# outer step; 2 f64 outer steps and the measurement); they project its time
# on the card at hand
HUBBARD4X4_F32_APPLIES = 347
HUBBARD4X4_F64_APPLIES = 3
KAGOME_GOLDEN = {(0, 0): -15.41931496, (0, 1): -14.40277723,
                 (1, 0): -14.40277723, (1, 1): -14.40277723}
# phase 10: the moments and continued-fraction steps of the JAX package's
# scripts (benchmarks/flagship_kagome24_sqw.py, examples/chain_dynamics_sqw.py)
# and the shared spectral bounds and norm sum of SQW_kagome24.json
KPM_MOMENTS = 192
CF_STEPS = 40
SQW_BOUNDS = (-12.964242089650671, 13.487894943231652)
SQW_NORM2_SUM = 0.8044558613240673
# phase 11: the Holstein polaron chain L = 16, Nmax = 3, t = w = g = 1, grown
# from the electron at site 8 over the vacuum. Per depth its dim and the
# CRC32 of the labels and of the six skeleton arrays as the JAX package
# builds them (equal bytes, so per-k records load in both packages); the
# band E(k = j/16), j = 0..8, at depth 14: scipy eigsh (tol 1e-14) of the
# JAX package's skeleton, which its own locate_E0_lanczos(which="vrnl")
# reproduces to 3e-14 at every k (E(0) = -2.466611199168856)
HOLSTEIN_L = 16
HOLSTEIN_DEPTHS = {8: (475, 1262208224, 2224542107),
                   12: (7491, 1448417759, 1953454236),
                   14: (28956, 3071596857, 3562348927)}
HOLSTEIN_BAND = (-2.4666111991688577, -2.3561659084180966,
                 -2.0841166783797584, -1.8199887671092105,
                 -1.6732057133728666, -1.6014926929171571,
                 -1.5645359820584208, -1.5465537464350307,
                 -1.5411668934441385)


def host_ms(fn, calls=200):
    """Host time of one fn() call in ms: the host clock around ``calls``
    calls that only enqueue (the device drained before, not waited for
    between them; fewer launches than the queue holds)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e3


def cuda_ms(fn, samples=25, per_sample=5):
    """Median per-call device time of fn() in ms (CUDA events)."""
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


def bsr_bound(bsr, C):
    """Least time of one BSR apply on this card in ms, and which bound it is:
    every stored block, index and x entry read once and y written once over
    the memory rate, against 2 operations per stored value and vector
    component (x2 for a complex matrix) over the peak rate of the type."""
    item = bsr.blocks_re.element_size()
    planes = 2 if bsr.is_complex else 1
    nbytes = (bsr.nb * 128 * 128 * item * planes + 2 * bsr.n_pad * C * item
              + 4 * (bsr.nb + bsr.row_ptr.numel()))
    flops = 2 * bsr.nb * 128 * 128 * planes * C
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[bsr.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_bsr_ms(bsr, x2d):
    """Time of ``torch.sparse_bsr_tensor(...) @ x`` on the same matrix and
    vector, or (None, first line of the error) where this PyTorch has no
    such product. Timed only: nothing in the package calls it."""
    try:
        vals = bsr.blocks_re if not bsr.is_complex else torch.complex(
            bsr.blocks_re, bsr.blocks_im)
        x = torch.view_as_complex(x2d)[:, None] if bsr.is_complex else x2d
        A = torch.sparse_bsr_tensor(bsr.row_ptr.long(), bsr.bj.long(), vals,
                                    size=(bsr.n_pad, bsr.n_pad))
        y = A @ x
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, str(e).splitlines()[0]
    y2d = torch.view_as_real(y[:, 0]) if bsr.is_complex else y
    return cuda_ms(lambda: A @ x), y2d, None


def sector_ell(model, momentum, conserve, vals):
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    model.enumerate_basis_repr(momentum, conserve, vals)
    return build_sparse_repr(model.sec_repr[0].matvec)


def kernel_checks(bsr_mod, dev):
    """Phase 3: kernel vs plain version; returns the measured rows."""
    from quantum_basis_tpu_torch.ops.bsr import BsrMatrix, ell_to_bsr
    from quantum_basis_tpu_torch.ops.sparse import EllMatrix
    from torch_zoo import heisenberg_chain, kagome_tj, tilted_heisenberg

    mats = []
    # the shape of the kernel's main path (phase 4b): a momentum sector of
    # the 20-site tilted cluster
    m, ops = tilted_heisenberg(TILTED_A, device=dev)
    ell = sector_ell(m, [0, 0], [ops["Sz"]], [0.0])
    mats += [("tilted20_k00", ell, torch.float32)]
    m, ops = heisenberg_chain(20, device=dev)
    ell = sector_ell(m, [0], [ops["Sz"]], [0.0])
    mats += [("chain20_k0", ell, torch.float32),
             ("chain20_k0", ell, torch.float64)]
    m, ops = kagome_tj(2, 2, device=dev)
    ell = sector_ell(m, [0, 1], [ops["N"], ops["Sz"]], [8.0, 0.0])
    mats += [("kagome_tj22_k01", ell, torch.float32),
             ("kagome_tj22_k01", ell, torch.float64)]
    m, ops = kagome_tj(2, 2, device=dev)
    ell = sector_ell(m, [0, 0], [ops["N"], ops["Sz"]], [8.0, 0.0])
    mats += [("kagome_tj22_k00", ell, torch.float32)]
    m, ops = heisenberg_chain(22, device=dev)
    ell = sector_ell(m, [0], [ops["Sz"]], [0.0])
    mats += [("chain22_k0", ell, torch.float32)]
    del m
    # one entry in tile (0, 0) of a 5-tile matrix; a diagonal-only matrix
    n = 520
    cols = torch.zeros((n, 1), dtype=torch.int64, device=dev)
    vals = torch.zeros((n, 1), dtype=torch.float64, device=dev)
    cols[3, 0], vals[3, 0] = 7, 2.5
    ell = EllMatrix(cols, vals, torch.arange(n, dtype=torch.float64,
                                             device=dev))
    mats += [("empty_row_tiles", ell, torch.float64)]
    n = 300
    ell = EllMatrix(torch.zeros((n, 0), dtype=torch.int64, device=dev),
                    torch.zeros((n, 0), dtype=torch.float64, device=dev),
                    torch.linspace(-1.0, 1.0, n, dtype=torch.float64,
                                   device=dev))
    mats += [("diagonal_only", ell, torch.float64)]

    rng = np.random.default_rng(7)
    rows = []
    for tag, ell, dt in mats:
        bsr = ell_to_bsr(ell, dtype=dt)
        assert isinstance(bsr, BsrMatrix) and bsr.dtype == dt
        comps = [2, 1] if not bsr.is_complex else [2]
        for C in comps:
            x2d = torch.as_tensor(rng.standard_normal((bsr.n_pad, C)),
                                  dtype=dt, device=dev)
            args = (bsr.blocks_re, bsr.blocks_im, bsr.bi, bsr.bj,
                    bsr.row_ptr, x2d)
            yk = bsr_mod.bsr_spmv(*args)
            yp = bsr_mod._bsr_matvec_plain(bsr.blocks_re, bsr.blocks_im,
                                           bsr.bi, bsr.bj, x2d)
            torch.cuda.synchronize()
            err = float((yk - yp).abs().max())
            scale = max(float(yp.abs().max()), 1e-300)
            tol = (1e-12 if dt == torch.float64 else 1e-5) * scale
            ms = cuda_ms(lambda: bsr_mod.bsr_spmv(*args))
            plain_ms = cuda_ms(lambda: bsr_mod._bsr_matvec_plain(
                bsr.blocks_re, bsr.blocks_im, bsr.bi, bsr.bj, x2d))
            bound_ms, bound_by = bsr_bound(bsr, C)
            # the f64 ELL apply on the same matrix and vector kind: what
            # the BSR routing bounds (bsr_blowup_max, config.ROUTING) weigh
            # against
            xe = torch.as_tensor(
                rng.standard_normal(ell.n) + (1j * rng.standard_normal(ell.n)
                                              if C == 2 else 0.0), device=dev)
            ell_ms = cuda_ms(lambda: ell(xe))
            lib_ms, ylib, lib_err = library_bsr_ms(bsr, x2d)
            if ylib is not None:
                lib_diff = float((ylib - yp).abs().max())
                if not lib_diff <= 10 * tol:
                    raise AssertionError(f"{tag} {dt} C={C}: the library "
                                         f"product differs by {lib_diff:.3e}")
            row = {"case": tag, "dtype": str(dt).replace("torch.", ""),
                   "vector": "complex" if C == 2 else "real",
                   "matrix": "complex" if bsr.is_complex else "real",
                   "n": bsr.n, "n_blocks": bsr.nb,
                   "max_abs_err": err, "max_rel_err": err / scale,
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": lib_ms,
                   "library_error": lib_err, "ell_f64_ms": ell_ms,
                   "stored_GB_per_s": bsr.nb * 128 * 128
                   * torch.finfo(dt).bits / 8
                   * (2 if bsr.is_complex else 1) / (ms * 1e-3) / 1e9}
            print("kernel_check", json.dumps(row), flush=True)
            if not err <= tol:
                raise AssertionError(f"{tag} {dt} C={C}: kernel vs plain "
                                     f"max abs err {err:.3e} > {tol:.3e}")
            rows.append(row)
    return rows


def slice_run(bsr_mod, dev):
    """Phase 4: the momentum-sector route through the public Model API.
    Returns the kernel's launches on the tilted-cluster path, the chain-20
    k=0 energy and, for phase 10a, the tilted model with its ground-state
    sector's momentum and energy."""
    from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
    from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
    from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp
    from quantum_basis_tpu_torch.solvers.restarted import eigs_smallest
    from torch_zoo import (heisenberg_chain, kagome_tj, sz_pair,
                           tilted_heisenberg, tilted_momenta, tj_sz)

    # (a) sectors the full-label-space engine takes: P_k H
    def projected(model, sec, tag):
        s = model.sec_repr[sec]
        fs = model._fullspace_repr_op(s)
        if not (isinstance(fs, ProjectedFullOp)
                and isinstance(fs.base, ContractOp) and fs.n_applies > 0
                and s.ell is None and s.bsr32 is None):
            raise AssertionError(f"{tag}: the solve did not run as P_k H on "
                                 f"the contraction engine ({fs!r})")
        return fs.n_applies

    bsr_mod.launch_count = 0
    m, ops = kagome_tj(2, 2, device=dev)
    for sec, k in enumerate(KAGOME_GOLDEN):
        t0 = time.perf_counter()
        dim = m.enumerate_basis_repr(list(k), [ops["N"], ops["Sz"]],
                                     [8.0, 0.0], sec=sec)
        t1 = time.perf_counter()
        m.locate_E0_lanczos(which="repr", sec=sec)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        meas = m.measure_repr_static(tj_sz(0) * tj_sz(1), sec)
        r = {"model": "kagome_tj_2x2_N8_Sz0", "k": list(k), "dim": dim,
             "E0": m.eigenvals_repr[0], "golden": KAGOME_GOLDEN[k],
             "Sz0Sz1": meas.real, "enumerate_s": t1 - t0,
             "solve_s": t2 - t1, "engine": "P_k H on ContractOp f64",
             "matvecs": projected(m, sec, f"kagome t-J k={k}")}
        print("slice", json.dumps(r), flush=True)
        _check(f"kagome t-J k={k} E0", r["E0"], r["golden"], 1e-8)
    del m
    mc, opc = heisenberg_chain(20, device=dev)
    t0 = time.perf_counter()
    dim = mc.enumerate_basis_repr([0], [opc["Sz"]], [0.0])
    t1 = time.perf_counter()
    mc.locate_E0_lanczos(which="repr")
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    e0_chain20 = mc.eigenvals_repr[0]
    print("slice", json.dumps({
        "model": "chain20_Sz0", "k": [0], "dim": dim, "E0": e0_chain20,
        "Sz0Sz1": mc.measure_repr_static(sz_pair(0, 1), 0).real,
        "enumerate_s": t1 - t0, "solve_s": t2 - t1,
        "engine": "P_k H on ContractOp f64",
        "matvecs": projected(mc, 0, "chain-20 k=0")}), flush=True)
    ref, _ = eigs_smallest(mc._repr_ell(mc.sec_repr[0]), dim, nev=1,
                           ncv=12, complex_vec=True)
    _check("chain-20 k=0 E0, P_k H vs pure-f64 ELL", e0_chain20, ref[0], 1e-9)
    if bsr_mod.launch_count != 0:
        raise AssertionError("a projected solve launched the BSR kernel")
    del mc

    # (b) the kernel's main path: a tilted cluster, no prefer_bsr
    bsr_mod.launch_count = 0
    mt, opt = tilted_heisenberg(TILTED_A, device=dev)
    t0 = time.perf_counter()
    dims, e0s, blocks, t_solve = [], [], [], 0.0
    for k in tilted_momenta(TILTED_A):
        dims.append(mt.enumerate_basis_repr(list(k), [opt["Sz"]], [0.0]))
        s = mt.sec_repr[0]
        if mt._fullspace_repr_op(s) is not None:
            raise AssertionError("a tilted cluster got a full-space engine")
        before = bsr_mod.launch_count
        _, dt = _timed(lambda: mt.locate_E0_lanczos(which="repr"))
        t_solve += dt
        if not (isinstance(s.bsr32, BsrMatrix)
                and s.bsr32.dtype == torch.float32
                and bsr_mod.launch_count > before):
            raise AssertionError(f"tilted k={k}: the f32 bulk stage did not "
                                 "run on a float32 BsrMatrix")
        e0s.append(mt.eigenvals_repr[0])
        blocks.append(s.bsr32.nb)
        szsz = mt.measure_repr_static(sz_pair(0, 1), 0)
    torch.cuda.synchronize()
    t_all = time.perf_counter() - t0
    launches = bsr_mod.launch_count
    k_min = int(np.argmin(e0s))
    full_dim, t_enum = _timed(lambda: mt.enumerate_basis_full([opt["Sz"]],
                                                              [0.0]))
    _, t_full = _timed(lambda: mt.locate_E0_lanczos())
    print("slice", json.dumps({
        "model": "tilted_square_20_Sz0", "A": TILTED_A, "card": card_line(),
        "momenta": len(dims), "dims": sorted(set(dims)),
        "dim_sum": sum(dims), "E0_min": e0s[k_min],
        "k_min": list(tilted_momenta(TILTED_A)[k_min]),
        "E0_full": mt.eigenvals_full[0], "Sz0Sz1_last_k": szsz.real,
        "all_sectors_s": t_all, "solves_s": t_solve,
        "bsr_blocks": [min(blocks), max(blocks)],
        "bsr_launches": launches, "full_enumerate_s": t_enum,
        "full_solve_s": t_full,
        "full_engine": type(mt._fullspace_op(mt.sec_full[0])).__name__}),
        flush=True)
    if sum(dims) != full_dim or full_dim != TILTED_DIM:
        raise AssertionError(f"tilted: sector dims sum to {sum(dims)}, the "
                             f"Sz=0 sector has {full_dim}")
    _check("tilted square 20: min_k E0(k) vs full-sector E0", e0s[k_min],
           mt.eigenvals_full[0], 1e-9)
    if launches <= 0:
        raise AssertionError("the tilted-cluster path never launched the "
                             "BSR kernel")
    print("bsr_spmv launches on the tilted-cluster path:", launches,
          flush=True)
    tilted = (mt, opt, tilted_momenta(TILTED_A)[k_min], e0s[k_min])
    return launches, e0_chain20, tilted


def _timed(fn):
    """(result, seconds) of fn(), the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _check(name, got, want, tol):
    print(f"check {name}: {got!r} vs {want!r} (tol {tol:g})", flush=True)
    if not abs(got - want) <= tol:
        raise AssertionError(f"{name}: {got!r} vs {want!r}, off by "
                             f"{abs(got - want):.3e} > {tol:g}")


def _engine_of(model, tag, sec=0, dtype=torch.float64):
    """The full-label-space engine a solve of this sector ran on; raises
    unless it is a ContractOp of the given precision that was applied and the
    sector's own matrix-free apply was not."""
    from quantum_basis_tpu_torch.ops.apply_contract import ContractOp

    sector = model.sec_full[sec]
    fs = model._fullspace_op(sector, dtype=dtype)
    if not isinstance(fs, ContractOp) or fs.dtype != dtype:
        raise AssertionError(f"{tag}: the solve did not route to a "
                             f"{dtype} ContractOp but to {fs!r}")
    if fs.n_applies <= 0 or sector.matvec.n_applies != 0:
        raise AssertionError(f"{tag}: ContractOp applies {fs.n_applies}, "
                             f"matrix-free {sector.matvec.n_applies}")
    return fs


def full_goldens(dev):
    """Phase 5a: the reference's self-test workloads (src/main_test.cc)."""
    from torch_zoo import SP_HALF, heisenberg_chain, sz_pair, tj_chain
    from quantum_basis_tpu_torch import Opr

    m, _ = heisenberg_chain(16, device=dev)
    dim, t_enum = _timed(lambda: m.enumerate_basis_full([], []))
    if dim != 65536:
        raise AssertionError(f"chain-16 full dim {dim}")
    mv = m.sec_full[0].matvec
    _, t_solve = _timed(lambda: m.locate_E0_lanczos("full", nev=1, ncv=1))
    fs = _engine_of(m, "chain16")
    _check("chain16 E0", m.eigenvals_full[0], E0_CHAIN16, 1e-8)
    ops = {"Sz0Sz1": sz_pair(0, 1), "Sz0Sz2": sz_pair(0, 2),
           "Sp0Sm1": Opr(0, 0, False, SP_HALF["Sp"])
           * Opr(1, 0, False, SP_HALF["Sm"])}
    for name, op in ops.items():
        _check(f"chain16 {name}", m.measure_full_static(op, 0, 0).real,
               CHAIN16_CORR[name], 1e-8)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(dim),
                        device=dev)
    print("full", json.dumps({
        "model": "chain16_full", "dim": dim, "E0": m.eigenvals_full[0],
        "setup_s": t_enum, "solve_s": t_solve, "engine": "ContractOp f64",
        "matvecs": fs.n_applies,
        "matvec_free_ms": cuda_ms(lambda: mv(x), samples=5, per_sample=2)}),
        flush=True)

    m, c = tj_chain(12, device=dev)
    dim, t_enum = _timed(lambda: m.enumerate_basis_full(
        [c["Sz"], c["N"]], [0.0, 8.0]))
    if dim != 34650:
        raise AssertionError(f"t-J chain-12 dim {dim}")
    _, t_solve = _timed(lambda: m.locate_E0_iram("full", nev=4, ncv=12))
    fs = _engine_of(m, "tJ12")  # 3^12 labels, blowup 15
    _check("tJ12 E0", m.eigenvals_full[0], E0_TJ12, 1e-8)
    _check("tJ12 E1", m.eigenvals_full[1], E0_TJ12, 1e-8)
    print("full", json.dumps({
        "model": "tJ12_N8_Sz0", "dim": dim, "evals": m.eigenvals_full,
        "setup_s": t_enum, "solve_s": t_solve, "engine": "ContractOp f64",
        "plan": fs.plan.describe(), "matvecs": fs.n_applies}), flush=True)


# ell_spmv's launches in the ELL solves of phases 5 and 8, by solve: the
# count set to 0 just before each solve and read just after
ELL_SPMV_LAUNCHES = {}


def ell_spmv_window(tag, rec):
    """Keeps one ELL solve's ell_spmv launches, which must equal its ELL
    applies (``rec["matvecs_ell"]``): every apply is one launch."""
    n = rec["ell_spmv_launches"]
    ELL_SPMV_LAUNCHES[tag] = n
    print(f"check {tag} ell_spmv launches {n} = the solve's ELL applies "
          f"{rec['matvecs_ell']}", flush=True)
    if not 0 < n == rec["matvecs_ell"]:
        raise AssertionError(f"{tag}: {n} ell_spmv launches for "
                             f"{rec['matvecs_ell']} ELL applies")


def full_width(dev, tag, model, sz, matrix_free, maxit):
    """One dim-2,704,156 case. Returns its record; the model keeps the ELL
    as the sector's matvec, and E0 and the eigenvector of the solve on it.
    With ``matrix_free`` the sector is first solved through
    ``locate_E0_lanczos("full")`` on the card's route, MatvecFull, whose
    every apply must be one apply_rows launch."""
    from quantum_basis_tpu_torch.basis.enumerate import enumerate_basis
    from quantum_basis_tpu_torch.ops import apply, krylov, sparse
    from quantum_basis_tpu_torch.ops.apply import MatvecFull

    torch.cuda.reset_peak_memory_stats()
    rec = {"model": tag, "card": card_line()}
    _, rec["enumerate_s"] = _timed(
        lambda: enumerate_basis(model.space, [sz], [0.0], device=dev))
    dim, t_full = _timed(lambda: model.enumerate_basis_full([sz], [0.0]))
    if dim != DIM_24:
        raise AssertionError(f"{tag}: dim {dim} != {DIM_24}")
    rec["dim"] = dim
    rec["device_basis_s"] = t_full - rec["enumerate_s"]
    sec = model.sec_full[0]
    rec["index_mode"] = sec.dbasis.index.mode
    rec["block_rows"] = sec.dbasis.block_rows
    mv = sec.matvec
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(dim),
                        device=dev)
    if matrix_free:
        # on the card's table (fullspace_max_blowup 5) the sector (blowup
        # 6.2) routes to its matrix-free apply: one kernel launch an apply
        if not isinstance(mv, MatvecFull) or model._fullspace_op(sec):
            raise AssertionError(f"{tag}: locate_E0_lanczos('full') does not "
                                 f"route to MatvecFull")
        apply.launch_count = 0
        krylov.reset_launches()
        _, rec["solve_free_s"] = _timed(
            lambda: model.locate_E0_lanczos("full", maxit=maxit))
        rec["apply_rows_launches"] = apply.launch_count
        # every apply of the solve is one Krylov step (eigs_smallest)
        rec["k6_launches"] = k6_launches(tag, mv.n_applies)
        rec["E0_free"] = model.eigenvals_full[0]
        rec["matvecs_free"] = mv.n_applies
        print(f"check {tag} apply_rows launches {apply.launch_count} = the "
              f"solve's applies {mv.n_applies}", flush=True)
        if not 0 < apply.launch_count == mv.n_applies:
            raise AssertionError(f"{tag}: {apply.launch_count} apply_rows "
                                 f"launches for {mv.n_applies} applies")
    y_free = mv(x)
    rec["matvec_free_ms"] = cuda_ms(lambda: mv(x), samples=5, per_sample=2)
    ell, rec["ell_build_s"] = _timed(
        lambda: model.generate_Ham_sparse_full(check="probe"))
    rec["ell_width"] = ell.width
    rec["ell_bytes"] = (ell.cols.numel() * ell.cols.element_size()
                        + ell.vals.numel() * ell.vals.element_size())
    y_ell = ell(x)
    diff = float((y_free - y_ell).abs().max())
    scale = float(y_ell.abs().max())
    print(f"check {tag} H x, matrix-free vs ELL: {diff:.3e} "
          f"(max|y| {scale:.3e})", flush=True)
    if not diff <= 1e-12 * scale:
        raise AssertionError(f"{tag}: matrix-free and ELL H x differ by "
                             f"{diff:.3e}")
    rec["ell_ms"] = cuda_ms(lambda: ell(x), samples=10, per_sample=3)
    n0 = ell.n_applies
    sparse.launch_count = 0
    _, rec["solve_ell_s"] = _timed(
        lambda: model.locate_E0_lanczos("full", maxit=maxit))
    rec["ell_spmv_launches"] = sparse.launch_count
    rec["E0_ell"] = e0 = model.eigenvals_full[0]
    rec["matvecs_ell"] = ell.n_applies - n0
    ell_spmv_window(f"5 {tag}", rec)
    v = model.eigenvecs_full[0]
    rec["residual"] = float(torch.linalg.vector_norm(ell(v) - e0 * v))
    rec["residual_gate"] = max(1e3 * 2e-12 * abs(e0), 5e-10)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    print("full", json.dumps(rec), flush=True)
    if not rec["residual"] < rec["residual_gate"]:
        raise AssertionError(f"{tag}: residual {rec['residual']:.3e} over "
                             f"the gate {rec['residual_gate']:.3e}")
    return rec


def full_sector_run(bsr_mod, dev, e0_chain20):
    """Phase 5: the full-sector route through the public Model API. Returns
    the BSR kernel's launches, the two full-width models for phase 6, as
    (tag, model, Sz, phase-5 record, golden E0 or None), and the launches
    of apply_rows (the chain-24 solve) and scatter_rows (its
    measure_full_static)."""
    from quantum_basis_tpu_torch import config
    from quantum_basis_tpu_torch.ops import apply
    from torch_zoo import (heisenberg_chain, kagome_heisenberg, sz_pair)

    bsr_mod.launch_count = 0
    with jax_bounds("fullspace_max_blowup"):  # both on ContractOp
        full_goldens(dev)

    m, ops = heisenberg_chain(24, device=dev)
    rec = full_width(dev, "chain24_Sz0", m, ops["Sz"], True, 4000)
    _check("chain24 E0, matrix-free vs ELL", rec["E0_free"], rec["E0_ell"],
           1e-10)
    launches_k6 = rec["k6_launches"]
    apply.scatter_launch_count = 0
    (szsz, t_meas) = _timed(
        lambda: m.measure_full_static(sz_pair(0, 1), 0, 0).real)
    scatters = apply.scatter_launch_count
    print(f"chain24 measure_full_static: {t_meas:.4f} s, {scatters} "
          f"scatter_rows launches", flush=True)
    if scatters != 1:
        raise AssertionError(f"measure_full_static: {scatters} scatter_rows "
                             f"launches, not 1")
    _check("chain24 <Sz0 Sz1> = E0 / 72", szsz, rec["E0_ell"] / 72.0, 1e-9)
    launches_k2 = {"apply_rows": rec["apply_rows_launches"],
                   "scatter_rows": scatters}
    wide = [("chain24_Sz0", m, ops["Sz"], rec, None)]

    m, ops = kagome_heisenberg(2, 4, device=dev)
    rec = full_width(dev, "kagome24_Sz0", m, ops["Sz"], False, 40000)
    _check("kagome24 E0", rec["E0_ell"], E0_KAGOME24, 1e-8)
    wide.append(("kagome24_Sz0", m, ops["Sz"], rec, E0_KAGOME24))
    del m

    # the f64 BSR kernel through this route's entry point
    mc, opc = heisenberg_chain(20, device=dev)
    mc.enumerate_basis_repr([0], [opc["Sz"]], [0.0])
    before = bsr_mod.launch_count
    old = config.prefer_bsr
    config.prefer_bsr = True
    try:
        _, t_solve = _timed(lambda: mc.locate_E0_iram(which="repr", nev=2))
    finally:
        config.prefer_bsr = old
    spmv = mc.sec_repr[0].spmv
    if spmv.dtype != torch.float64 or not hasattr(spmv, "blocks_re"):
        raise AssertionError("locate_E0_iram(which='repr') with prefer_bsr "
                             "did not run on the float64 BsrMatrix")
    if bsr_mod.launch_count <= before:
        raise AssertionError("locate_E0_iram(which='repr') never launched "
                             "the BSR kernel")
    print(f"chain20 k=0 iram on the f64 BSR kernel: {t_solve:.4f} s, "
          f"{bsr_mod.launch_count - before} launches, evals "
          f"{mc.eigenvals_repr}", flush=True)
    _check("chain20 k=0 E0, f64 BSR iram vs mixed route",
           mc.eigenvals_repr[0], e0_chain20, 1e-9)
    launches = bsr_mod.launch_count
    if launches <= 0:
        raise AssertionError("the full-sector phase never launched the "
                             "BSR kernel")
    print("bsr_spmv launches in the full-sector phase:", launches,
          flush=True)
    return launches, wide, launches_k2, launches_k6


def _hx_check(tag, y, y_ref, rel_tol):
    diff = float((y - y_ref).abs().max())
    scale = float(y_ref.abs().max())
    print(f"check {tag}: {diff:.3e} (max|y| {scale:.3e}, tol "
          f"{rel_tol:g} * max|y|)", flush=True)
    if not diff <= rel_tol * scale:
        raise AssertionError(f"{tag}: H x differs by {diff:.3e} > "
                             f"{rel_tol:g} * {scale:.3e}")
    return diff / scale


def engine_width(dev, tag, model, sz, rec5, golden):
    """Phase 6 for one dim-2,704,156 sector (N = 2^24): the three
    full-label-space engines against the sector's ELL of phase 5, then the
    solves through ``locate_E0_lanczos()`` on the contraction engine."""
    from quantum_basis_tpu_torch import config
    from quantum_basis_tpu_torch.models import model as model_mod
    from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp

    sec0 = model.sec_full[0]
    ell, labels = sec0.matvec, sec0.labels
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(sec0.dim),
                        device=dev)
    y_ell = ell(x)
    rec = {"model": tag, "card": card_line(), "dim": sec0.dim,
           "N": int(model.space.label_space),
           "ell_ms": rec5["ell_ms"], "matvec_free_ms": rec5["matvec_free_ms"]}
    for name, build, tol in (
            ("contract_f64", lambda: ContractOp(
                model.compiled_Ham, labels, dtype=torch.float64, device=dev),
             1e-12),
            ("contract_f32", lambda: ContractOp(
                model.compiled_Ham, labels, dtype=torch.float32, device=dev),
             5e-6),
            ("fullspace_f64", lambda: FullSpaceOp(
                model.compiled_Ham, labels, device=dev), 1e-12)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        op, rec[name + "_build_s"] = _timed(build)
        rec[name + "_resident_bytes"] = torch.cuda.memory_allocated() - base
        xf = op.to_full(x)
        rec[name + "_rel_err"] = _hx_check(
            f"{tag} H x, {name} vs ELL", op.to_sector(op(xf)).to(y_ell.dtype),
            y_ell, tol)
        rec[name + "_ms"] = cuda_ms(lambda: op(xf), samples=10, per_sample=3)
        rec[name + "_apply_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                           - base)
        if name == "contract_f64":
            rec["plan"] = op.plan.describe()
            rec["windows"] = [(f, hi, D, lo) for f, hi, D, lo, _, _
                              in op._wins]
        if name == "fullspace_f64":
            rec["fullspace_passes"] = op.n_passes
        del op, xf
    torch.cuda.empty_cache()

    # the solves, through the entry point, on a fresh sector of the model
    # (sector 0 keeps its explicit ELL, which the routing honours)
    model.enumerate_basis_full([sz], [0.0], sec=1)
    gate = rec5["residual_gate"]
    real_rqi, calls = model_mod.rqi_polish, []
    model_mod.rqi_polish = lambda *a, **k: (calls.append(real_rqi(*a, **k))
                                            or calls[-1])
    try:
        for mode, mixed in (("f64", False), ("mixed", True)):
            config.mixed_precision = mixed
            torch.cuda.reset_peak_memory_stats()
            fs64 = model._fullspace_op(model.sec_full[1])
            n64 = fs64.n_applies
            _, rec[f"solve_{mode}_s"] = _timed(
                lambda: model.locate_E0_lanczos(sec=1, maxit=40000))
            _engine_of(model, f"{tag} {mode}", sec=1)
            e0 = model.eigenvals_full[0]
            v = model.eigenvecs_full[0]
            rec[f"E0_{mode}"] = e0
            rec[f"matvecs_f64_{mode}"] = fs64.n_applies - n64
            rec[f"residual_{mode}"] = float(
                torch.linalg.vector_norm(ell(v) - e0 * v))
            rec[f"peak_bytes_{mode}"] = torch.cuda.max_memory_allocated()
            if mixed:
                fs32 = _engine_of(model, f"{tag} mixed f32", sec=1,
                                  dtype=torch.float32)
                rec["matvecs_f32_mixed"] = fs32.n_applies
                if len(calls) != 1 or not calls[0]["converged"]:
                    raise AssertionError(f"{tag}: the mixed solve did not "
                                         f"end in a converged RQI: {calls}")
                rec["rqi_outer"] = calls[0]["n_outer"]
                rec["rqi_inner_f32"] = calls[0]["n_inner"]
    finally:
        config.mixed_precision = False
        model_mod.rqi_polish = real_rqi
    print("engines", json.dumps(rec), flush=True)
    for mode in ("f64", "mixed"):
        _check(f"{tag} E0, ContractOp {mode} vs ELL", rec[f"E0_{mode}"],
               rec5["E0_ell"], 1e-10)
        if golden is not None:
            _check(f"{tag} E0, ContractOp {mode} vs golden",
                   rec[f"E0_{mode}"], golden, 1e-8)
        if not rec[f"residual_{mode}"] < gate:
            raise AssertionError(
                f"{tag} {mode}: residual {rec[f'residual_{mode}']:.3e} over "
                f"the gate {gate:.3e}")
    del model.sec_full[1]
    return rec


def engines_run(dev, wide):
    """Phase 6: the full-label-space engines at full width, and ContractOp
    on a complex vector at chain-16."""
    from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
    from torch_zoo import heisenberg_chain

    for case in wide:
        engine_width(dev, *case)
        torch.cuda.empty_cache()

    m, ops = heisenberg_chain(16, device=dev)
    dim = m.enumerate_basis_full([ops["Sz"]], [0.0])
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(dim)
                        + 1j * rng.standard_normal(dim), device=dev)
    y_ref = m.sec_full[0].matvec(x)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 5e-6)):
        op = ContractOp(m.compiled_Ham, m.sec_full[0].labels, dtype=dt,
                        device=dev)
        y = op(op.to_full(x))
        if not y.is_complex():
            raise AssertionError("a complex vector came back real")
        _hx_check(f"chain16 Sz=0 complex vector, ContractOp {dt} vs "
                  "matrix-free", op.to_sector(y).to(y_ref.dtype), y_ref, tol)


def _projected_engine(model, sector, dtype, tag):
    """The P_k H engine of a momentum sector at one precision; raises unless
    it is a ProjectedFullOp over a ContractOp of that precision."""
    from quantum_basis_tpu_torch.ops.apply_contract import ContractOp
    from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp

    fs = model._fullspace_repr_op(sector, dtype=dtype)
    if not (isinstance(fs, ProjectedFullOp) and isinstance(fs.base, ContractOp)
            and fs.dtype == dtype):
        raise AssertionError(f"{tag}: no {dtype} P_k H engine but {fs!r}")
    return fs


def momentum_sector(dev, tag, model, sz, k, dim_want, e0_want, e0_tol,
                    solve_f64, t_start):
    """Phase 8 for one momentum sector at N = 2^24, through
    enumerate_basis_repr -> locate_E0_lanczos(which="repr"). The model's full
    sector 0 holds the ELL of phase 5, the independent H of the checks."""
    from quantum_basis_tpu_torch import config
    from quantum_basis_tpu_torch.models import model as model_mod

    rec = {"model": tag, "k": list(k), "card": card_line(),
           "N": int(model.space.label_space)}
    torch.cuda.empty_cache()
    base_bytes = torch.cuda.memory_allocated()
    dim, rec["enumerate_direct_s"] = _timed(
        lambda: model.enumerate_basis_repr(list(k), [sz], [0.0]))
    if dim_want is not None and dim != dim_want:
        raise AssertionError(f"{tag}: dim {dim} != {dim_want}")
    rec["dim"] = dim
    sector = model.sec_repr[0]
    fs, rec["engine_f64_build_s"] = _timed(
        lambda: _projected_engine(model, sector, torch.float64, tag))
    fs32, rec["engine_f32_build_s"] = _timed(
        lambda: _projected_engine(model, sector, torch.float32, tag))
    rec["resident_bytes"] = torch.cuda.memory_allocated() - base_bytes
    rolls, proj = fs.projector.rolls, fs.projector
    rec["translations_per_apply"] = sum(len(sh) for _, _, sh in proj.dims)

    # P_k H x against P_k applied to the ELL's H x; P_k idempotent
    sec_full = model.sec_full[0]
    ell = sec_full.matvec
    rng = np.random.default_rng(8)
    xs = torch.as_tensor(rng.standard_normal(sec_full.dim)
                         + 1j * rng.standard_normal(sec_full.dim), device=dev)
    labels = torch.as_tensor(sec_full.labels, device=dev)
    xf = torch.zeros(fs.N, dtype=torch.complex128, device=dev)
    xf[labels] = xs
    y_ref = torch.zeros_like(xf)
    y_ref[labels] = ell(xs)
    y_ref = proj.apply(y_ref)
    rec["pkh_vs_ell_rel_err"] = _hx_check(
        f"{tag} k={k} P_k H x vs P_k (ELL H x)", fs(xf), y_ref, 1e-12)
    rec["pkh_f32_rel_err"] = _hx_check(
        f"{tag} k={k} P_k H x, f32 vs f64",
        fs32(xf.to(torch.complex64)).to(torch.complex128), y_ref, 5e-6)
    rec["pk_idempotent_rel_err"] = _hx_check(
        f"{tag} k={k} P_k P_k x vs P_k x", proj.apply(y_ref), y_ref, 1e-12)
    del y_ref

    # per-translation, P_k and P_k H times, and the bytes bound of a
    # translation (x read once, y written once)
    x64 = fs.project(xf)
    x32 = x64.to(torch.complex64)
    vec_bytes = x64.numel() * x64.element_size()
    rec["translate_bound_ms"] = 2 * vec_bytes / HBM_BYTES_PER_S * 1e3
    rec["translate_ms"] = {
        f"dim{d}_shift{r}": cuda_ms(lambda d=d, r=r: rolls.translate(x64, d, r),
                                    samples=5, per_sample=3)
        for d, L, _ in proj.dims for r in sorted({1, L // 2})}
    rec["translate_axes"] = {f"dim{d}_shift1": [len(c[0]) for c in
                                                rolls._perms(d, 1)]
                             for d, _, _ in proj.dims}
    # P_k as a function reads x once and writes y once; as torch ops it
    # moves, per shift, the translation (2 vectors) and acc += phase * t (3),
    # and per dimension the copy into acc and its scaling (2 + 2)
    rec["pk_bound_ms"] = rec["translate_bound_ms"]
    rec["pk_traffic_ms"] = ((5 * rec["translations_per_apply"]
                             + 4 * len(proj.dims)) * vec_bytes
                            / HBM_BYTES_PER_S * 1e3)
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rec["pk_ms"] = cuda_ms(lambda: proj.apply(x64), samples=5, per_sample=2)
    rec["pk_apply_peak_bytes"] = torch.cuda.max_memory_allocated() - before
    rec["h_complex_f64_ms"] = cuda_ms(lambda: fs.base(x64), samples=5,
                                      per_sample=2)
    torch.cuda.reset_peak_memory_stats()
    rec["pkh_f64_ms"] = cuda_ms(lambda: fs(x64), samples=5, per_sample=2)
    rec["pkh_apply_peak_bytes"] = torch.cuda.max_memory_allocated() - before
    rec["pkh_f32_ms"] = cuda_ms(lambda: fs32(x32), samples=5, per_sample=2)
    del xf, x64, x32

    # the solves through the entry point
    real_rqi, calls = model_mod.rqi_polish, []
    model_mod.rqi_polish = lambda *a, **kw: (calls.append(real_rqi(*a, **kw))
                                             or calls[-1])
    modes = (["f64"] if solve_f64 else []) + ["mixed"]
    try:
        for mode in modes:
            config.mixed_precision = mode == "mixed"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            n64, n32 = fs.n_applies, fs32.n_applies
            t_wall = time.perf_counter()
            _, rec[f"solve_{mode}_s"] = _timed(
                lambda: model.locate_E0_lanczos(which="repr", maxit=40000))
            if sector.ell is not None or sector.bsr32 is not None:
                raise AssertionError(f"{tag} {mode}: the explicit route ran")
            e0 = model.eigenvals_repr[0]
            rec[f"E0_{mode}"] = e0
            rec[f"matvecs_f64_{mode}"] = fs.n_applies - n64
            rec[f"matvecs_f32_{mode}"] = fs32.n_applies - n32
            rec[f"peak_bytes_{mode}"] = torch.cuda.max_memory_allocated()
            if rec[f"matvecs_f64_{mode}"] <= 0 or (
                    (mode == "mixed") != (rec[f"matvecs_f32_{mode}"] > 0)):
                raise AssertionError(f"{tag} {mode}: applies f64 "
                                     f"{rec[f'matvecs_f64_{mode}']}, f32 "
                                     f"{rec[f'matvecs_f32_{mode}']}")
            vf = model._repr_to_full(sector, model.eigenvecs_repr[0], fs=fs)
            rec[f"residual_{mode}"] = float(
                torch.linalg.vector_norm(fs(vf) - e0 * vf))
            del vf
            if mode == "mixed":
                if len(calls) != 1 or not calls[0]["converged"]:
                    raise AssertionError(f"{tag}: the mixed solve did not "
                                         f"end in a converged RQI: {calls}")
                rec["rqi_outer"] = calls[0]["n_outer"]
                rec["rqi_inner_f32"] = calls[0]["n_inner"]
            print(f"{tag} k={k} {mode} solve: {rec[f'solve_{mode}_s']:.2f} s "
                  f"({time.perf_counter() - t_start:.0f} s into the script, "
                  f"{time.perf_counter() - t_wall:.2f} s wall)", flush=True)
    finally:
        config.mixed_precision = False
        model_mod.rqi_polish = real_rqi
    rec["solve_f64_dropped"] = not solve_f64
    gate = max(1e3 * 2e-12 * abs(e0_want), 5e-10)
    rec["residual_gate"] = gate
    print("momentum", json.dumps(rec), flush=True)
    for mode in modes:
        _check(f"{tag} k={k} E0 {mode}", rec[f"E0_{mode}"], e0_want, e0_tol)
        if not rec[f"residual_{mode}"] < gate:
            raise AssertionError(
                f"{tag} k={k} {mode}: residual {rec[f'residual_{mode}']:.3e} "
                f"over the gate {gate:.3e}")
    return rec


def explicit_route(bsr_mod, dev, tag, model, sz, k, e0_want):
    """Phase 8, the other route on the same sector: method="dnc" against
    "direct", then the explicit ELL/BSR solve through the same entry point
    with the full-label-space engine switched off for this model."""
    from quantum_basis_tpu_torch.ops import sparse

    direct = model.sec_repr[0]
    dim, t_dnc = _timed(lambda: model.enumerate_basis_repr(
        list(k), [sz], [0.0], sec=1, method="dnc"))
    s = model.sec_repr[1]
    if dim != direct.dim or not np.array_equal(s.labels, direct.labels) \
            or not np.array_equal(s.dbasis.nus, direct.dbasis.nus):
        raise AssertionError(f"{tag}: dnc and direct representatives differ")
    rec = {"model": tag, "k": list(k), "dim": dim, "enumerate_dnc_s": t_dnc}
    mask_dnc, rec["qn_mask_dnc_s"] = _timed(
        lambda: model._qn_mask(s, torch.float64))
    fs_direct = model._fullspace_repr_op(direct)
    if mask_dnc is fs_direct.mask:
        # one enumeration key: rebuild from the operators to check the build
        model._qn_mask_cache = None
        mask_dnc, rec["qn_mask_dnc_s"] = _timed(
            lambda: model._qn_mask(s, torch.float64))
    if not torch.equal(mask_dnc, fs_direct.mask):
        raise AssertionError(f"{tag}: the dnc quantum-number mask differs")
    del mask_dnc

    launches_before = bsr_mod.launch_count
    model._fullspace_repr_op = lambda *a, **kw: None  # this model only
    try:
        torch.cuda.reset_peak_memory_stats()
        ell, rec["ell_build_s"] = _timed(lambda: model._repr_ell(s))
        rec["ell_width"] = ell.width
        rec["ell_bytes"] = (ell.cols.numel() * ell.cols.element_size()
                            + ell.vals.numel() * ell.vals.element_size())
        x = torch.as_tensor(np.random.default_rng(2).standard_normal(dim)
                            + 0j, device=dev)
        rec["ell_ms"] = cuda_ms(lambda: ell(x), samples=10, per_sample=3)
        n0 = ell.n_applies
        sparse.launch_count = 0
        _, rec["solve_s"] = _timed(
            lambda: model.locate_E0_lanczos(which="repr", sec=1, maxit=40000))
        rec["ell_spmv_launches"] = sparse.launch_count
    finally:
        del model._fullspace_repr_op
    rec["E0"] = model.sec_repr[1].evals[0]
    # the build's share of the momentum solve (the build, then the solve)
    rec["ell_build_share"] = rec["ell_build_s"] / (rec["ell_build_s"]
                                                   + rec["solve_s"])
    rec["matvecs_ell"] = ell.n_applies - n0
    ell_spmv_window(f"8 {tag} k={k}", rec)
    rec["bsr32_routed"] = s.bsr32 is not None
    rec["bsr_blocks"] = s.bsr32.nb if s.bsr32 is not None else None
    rec["bsr_launches"] = bsr_mod.launch_count - launches_before
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    print("explicit", json.dumps(rec), flush=True)
    _check(f"{tag} k={k} E0, explicit route", rec["E0"], e0_want, 1e-8)
    del model.sec_repr[1]
    return rec


def momentum_run(bsr_mod, dev, wide, t_start):
    """Phase 8: momentum sectors at N = 2^24 on the models of phases 5-6.
    Returns the kagome k=(0,2) sector with its ground state, without its
    engines, for phase 10b."""
    (ctag, chain, csz, crec, _), (ktag, kagome, ksz, _, _) = wide
    momentum_sector(dev, ctag, chain, csz, (0,), None, crec["E0_ell"], 1e-9,
                    True, t_start)
    chain.sec_repr.clear()
    chain._fsrepr_bases.clear()
    chain._qn_mask_cache = None
    torch.cuda.empty_cache()

    first = momentum_sector(dev, ktag, kagome, ksz, (0, 2),
                            KAGOME24_DIMS[(0, 2)], E0_KAGOME24, 1e-8, True,
                            t_start)
    gs_sector = kagome.sec_repr[0]
    explicit_route(bsr_mod, dev, ktag, kagome, ksz, (0, 2), E0_KAGOME24)
    # k = (0, 0) costs about what k = (0, 2) did, and phases 9, 10 and 7
    # follow (about 300 s on an H100): its f64 solve is dropped past the
    # budget
    elapsed = time.perf_counter() - t_start
    projected = first["solve_f64_s"] + first["solve_mixed_s"] + 300.0
    keep = elapsed + projected <= SCRIPT_BUDGET_S
    print(f"kagome k=(0,0): {elapsed:.0f} s into the script, projected "
          f"{projected:.0f} s more with the f64 solve: "
          f"{'kept' if keep else 'f64 solve dropped'}", flush=True)
    momentum_sector(dev, ktag, kagome, ksz, (0, 0), KAGOME24_DIMS[(0, 0)],
                    E0_KAGOME24_K00, 1e-8, keep, t_start)
    kagome.sec_repr.clear()
    kagome._fsrepr_bases.clear()
    kagome._qn_mask_cache = None
    gs_sector._fsrepr_cache, gs_sector._projector = {}, None
    torch.cuda.empty_cache()
    return gs_sector


class _Interrupting:
    """A matvec that raises after ``limit`` applies: stands for a crash (on
    a mesh, of every rank at the same step). Other attributes are the
    wrapped engine's."""

    def __init__(self, base, limit):
        self.base, self.limit, self.calls = base, limit, 0

    def __getattr__(self, name):
        return getattr(self.base, name)

    def __call__(self, x):
        self.calls += 1
        if self.calls > self.limit:
            raise InterruptedError(f"stopped after {self.limit} applies")
        return self.base(x)


def resume_run(dev, chain_case):
    """Phase 9: checkpoint, interruption and resume of the chain-24 solve on
    the ELL route (the sector's matvec is the explicit ELL of phase 5)."""
    import shutil
    import tempfile

    from quantum_basis_tpu_torch import CkptStore, config
    from quantum_basis_tpu_torch.solvers import restarted
    from quantum_basis_tpu_torch.utils import ckpt as ckpt_mod

    tag, model, _, rec5, _ = chain_case
    sector = model.sec_full[0]
    ell = sector.matvec
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=here)
    saves = []

    class TimedStore(CkptStore):
        def save(self, key, payload):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(key, payload)
            saves.append((key, time.perf_counter() - t0,
                          os.path.getsize(self._path(key))))

    old = (config.enable_ckpt, config.ckpt_dir, restarted._SAVE_PERIOD,
           ckpt_mod.active_store)
    rec = {"model": tag, "card": card_line(), "dim": sector.dim,
           "matvecs_cold": rec5["matvecs_ell"], "E0_cold": rec5["E0_ell"]}
    try:
        config.enable_ckpt, config.ckpt_dir = True, ckpt_dir
        ckpt_mod.active_store = lambda: TimedStore(ckpt_dir)
        restarted._SAVE_PERIOD = 0.0     # every restart boundary saves
        key = f"lczsE0_full_sec0_nev1_h{model._ham_fingerprint():08x}"
        sector.matvec = _Interrupting(ell, 40)
        try:
            model.locate_E0_lanczos("full", maxit=4000)
        except InterruptedError as e:
            print(f"resume: {e}; {len(saves)} records written", flush=True)
        else:
            raise AssertionError("the interrupting matvec never raised")
        finally:
            sector.matvec = ell
        store = CkptStore(ckpt_dir)
        krylov = store.load(key + "_krylov")
        if krylov is None or store.load(key) is not None:
            raise AssertionError("after the interruption there must be a "
                                 "restart record and no stage record")
        rec["record_it"] = int(krylov["it"])
        rec["record_bytes"] = saves[-1][2]
        rec["save_s"] = [round(t, 3) for _, t, _ in saves]
        (_, rec["load_s"]) = _timed(lambda: store.load(key + "_krylov"))
        del krylov

        restarted._SAVE_PERIOD = old[2]  # the resumed run saves once
        n0, n_saves = ell.n_applies, len(saves)
        _, rec["resume_s"] = _timed(
            lambda: model.locate_E0_lanczos("full", maxit=4000))
        rec["matvecs_resumed"] = ell.n_applies - n0
        rec["E0_resumed"] = model.eigenvals_full[0]
        rec["saves_in_resume"] = [(k, round(t, 3), b)
                                  for k, t, b in saves[n_saves:]]
        if store.load(key + "_krylov") is not None:
            raise AssertionError("the restart record outlived convergence")
        if store.load(key) is None:
            raise AssertionError("no stage record after the resumed solve")
        n0 = ell.n_applies
        _, rec["stage_load_s"] = _timed(
            lambda: model.locate_E0_lanczos("full", maxit=4000))
        rec["matvecs_after_stage_record"] = ell.n_applies - n0
        rec["E0_stage"] = model.eigenvals_full[0]
    finally:
        (config.enable_ckpt, config.ckpt_dir, restarted._SAVE_PERIOD,
         ckpt_mod.active_store) = old
        shutil.rmtree(ckpt_dir)
    print("resume", json.dumps(rec), flush=True)
    _check("chain24 E0, resumed vs cold", rec["E0_resumed"], rec["E0_cold"],
           1e-10)
    if not 0 < rec["matvecs_resumed"] < rec["matvecs_cold"]:
        raise AssertionError(f"resumed run: {rec['matvecs_resumed']} matvecs, "
                             f"cold {rec['matvecs_cold']}")
    if rec["matvecs_after_stage_record"] != 0 \
            or rec["E0_stage"] != rec["E0_resumed"]:
        raise AssertionError("the stage record did not short-circuit the "
                             "solve")
    return rec


def _sz_q(phases):
    """A = sum_s phase_s / sqrt(N) Sz_s on the spin-1/2 orbital 0."""
    from quantum_basis_tpu_torch import Mopr, Opr
    from torch_zoo import SP_HALF

    out = Mopr()
    for s, ph in enumerate(phases):
        out += (ph / np.sqrt(len(phases))) * Opr(s, 0, False, SP_HALF["Sz"])
    return out


def _moments_ok(tag, mu, bound_tol):
    """mu_0 = 1 (the start vector is normalized) and |mu_n| <= 1: the
    rescaled spectrum lies inside [-1, 1]."""
    if not (abs(mu[0] - 1.0) <= 1e-6
            and float(np.max(np.abs(mu))) <= 1.0 + bound_tol):
        raise AssertionError(f"{tag}: mu_0 = {mu[0]!r}, max|mu_n| = "
                             f"{np.max(np.abs(mu))!r}")


def tilted_dynamics(bsr_mod, dev, tilted):
    """Phase 10a: S(q, w) of the 20-site tilted cluster through
    measure_repr_dynamic_kpm; the target sectors have no full-space engine,
    so the Chebyshev recurrence (and its energy_scale) runs on the f32 BSR
    kernel. Returns the kernel's launches and the record."""
    from quantum_basis_tpu_torch.ops.bsr import BsrMatrix
    from quantum_basis_tpu_torch.solvers.chebyshev import kpm_moments
    from torch_zoo import tilted_momenta

    mt, opt, k_min, e0_min = tilted
    if tuple(map(int, k_min)) != TILTED_K_GS:
        raise AssertionError(f"tilted: ground state at {k_min}")
    sz, lat = opt["Sz"], mt.lattice
    coords = [lat.site2coor(s)[0] for s in range(lat.n_sites)]
    mt.enumerate_basis_repr(list(k_min), [sz], [0.0], sec=0)
    _, t_gs = _timed(lambda: mt.locate_E0_lanczos(which="repr"))
    _check("tilted 20 E0(k_min), solved again", mt.eigenvals_repr[0], e0_min,
           1e-9)
    momenta = tilted_momenta(TILTED_A)
    compare = {1, len(momenta) // 2}     # two q held against the f64 ELL
    torch.cuda.reset_peak_memory_stats()
    bsr_mod.launch_count = 0
    rows, norms2 = [], []
    for i, q in enumerate(momenta):
        ph = np.exp(-2j * np.pi * lat.k_dot_R(q, coords))
        A = _sz_q(ph)
        kt = np.asarray(k_min) - np.asarray(q)
        dim, t_enum = _timed(lambda: mt.enumerate_basis_repr(
            kt.tolist(), [sz], [0.0], sec=1))
        dst = mt.sec_repr[1]
        # the routing the entry point makes (explicit ELL, BSR fill
        # statistics and blocks), timed apart from the recurrence
        _, t_route = _timed(lambda: mt._repr_bsr32(dst))
        before = bsr_mod.launch_count
        (nrm, mu, lo, hi), t_kpm = _timed(
            lambda: mt.measure_repr_dynamic_kpm(A, 0, 1, KPM_MOMENTS))
        applies = bsr_mod.launch_count - before
        # the continued fraction on the sector's MatvecRepr (repr_rows):
        # its ELL, built above, is not made its matvec
        (nrm_cf, _, _), t_cf = _timed(
            lambda: mt.measure_repr_dynamic(A, 0, 1, CF_STEPS))
        norms2.append(nrm ** 2)
        row = {"q": list(map(int, q)), "k_target": kt.tolist(), "dim": dim,
               "norm": nrm, "e_min": lo, "e_max": hi, "launches": applies,
               "enumerate_s": t_enum, "route_s": t_route, "kpm_s": t_kpm,
               "contfrac_s": t_cf}
        _check(f"tilted q={row['q']}: continued-fraction norm vs KPM norm",
               nrm_cf, nrm, 1e-12)
        if np.allclose(ph, 1.0):       # q = 0: Sz(0)|gs> = 0 at Sz = 0
            if nrm != 0.0 or applies != 0:
                raise AssertionError(f"tilted q=0: norm {nrm!r}, "
                                     f"{applies} launches")
            rows.append(row)
            continue
        if not (isinstance(dst.bsr32, BsrMatrix)
                and dst.bsr32.dtype == torch.float32 and applies > 0):
            raise AssertionError(f"tilted q={row['q']}: the moments did not "
                                 "run on a float32 BsrMatrix")
        _moments_ok(f"tilted q={row['q']}", mu, 1e-5)
        row["ms_per_apply"] = t_kpm / applies * 1e3
        row["moments_per_s"] = KPM_MOMENTS / t_kpm
        if i in compare:
            v, _ = mt._injected(A, mt.sec_repr[0], dst, 0, True)
            mu64, _, _ = kpm_moments(mt._repr_spmv(dst), v, KPM_MOMENTS,
                                     bounds=(lo, hi))
            row["max_diff_vs_f64_ell"] = float(np.max(np.abs(mu - mu64)))
            print(f"check tilted q={row['q']} moments, BSR f32 vs ELL f64: "
                  f"{row['max_diff_vs_f64_ell']:.3e} (tol 5e-05)", flush=True)
            if not row["max_diff_vs_f64_ell"] <= 5e-5:
                raise AssertionError("tilted: f32 BSR moments differ from "
                                     "the f64 ELL's")
        rows.append(row)
    launches = bsr_mod.launch_count
    rec = {"model": "tilted_square_20_Sz0", "card": card_line(),
           "k_gs": list(map(int, k_min)), "E0": e0_min, "gs_solve_s": t_gs,
           "n_moments": KPM_MOMENTS, "launches": launches,
           "norm2_sum": sum(norms2), "peak_bytes":
           torch.cuda.max_memory_allocated(),
           "label_buffer_bytes": _label_buffer_bytes(),
           "contfrac_s_sum": sum(r["contfrac_s"] for r in rows),
           "per_q": rows}
    print(f"tilted: {len(rows)} continued fractions ({CF_STEPS} steps each, "
          f"MatvecRepr: repr_rows) {rec['contfrac_s_sum']:.4f} s", flush=True)
    print("dynamics", json.dumps(rec), flush=True)
    _check("tilted: sum_q norm_q^2 = N/4", rec["norm2_sum"],
           lat.n_sites / 4, 1e-10)
    if launches <= 0:
        raise AssertionError("phase 10a never launched the BSR kernel")
    return launches, rec


def kagome_sqw(dev, kagome_case, gs_sector, art, bounds):
    """Phase 10b: benchmarks/flagship_kagome24_sqw.py through the port, at
    N = 2^24: the q of the cell zone from the ground state of phase 8, 192
    moments each on the float64 P_k H engine with the shared ``bounds`` of
    the flagship's result ``art`` (SQW_kagome24.json), held against its
    norms and moments."""
    from quantum_basis_tpu_torch import config
    from quantum_basis_tpu_torch.ops.translate_fullspace import ProjectedFullOp
    from quantum_basis_tpu_torch.solvers.lanczos import energy_scale

    tag, km, sz, _, _ = kagome_case
    ref = {tuple(r["q"]): r for r in art["runs"]}
    k0 = tuple(art["k0"])
    if tuple(int(k) for k in gs_sector.momentum) != k0:
        raise AssertionError(f"kagome S(q,w): ground state at "
                             f"{gs_sector.momentum}, not {k0}")
    lat = km.lattice
    Lx, Ly = lat.L
    coords = np.asarray([lat.site2coor(s)[0] for s in range(lat.n_sites)])
    km.sec_repr[0] = gs_sector
    rows, norms2, extra = [], [], {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # kpm_fullspace_max_N as the JAX flagship script sets it
    with config.pinned(kpm_fullspace_max_N=1 << 24):
        for qx in range(Lx):
            for qy in range(Ly):
                ph = np.exp(-2j * np.pi * (qx * coords[:, 0] / Lx
                                           + qy * coords[:, 1] / Ly))
                A = _sz_q(ph)
                kt = [int((k0[0] - qx) % Lx), int((k0[1] - qy) % Ly)]
                dim, t_enum = _timed(lambda: km.enumerate_basis_repr(
                    kt, [sz], [0.0], sec=1))
                dst = km.sec_repr[1]
                fs, t_engine = _timed(lambda: km._fullspace_repr_op(dst))
                if not (isinstance(fs, ProjectedFullOp)
                        and fs.dtype == torch.float64):
                    raise AssertionError(f"kagome q=({qx},{qy}): no float64 "
                                         f"P_k H engine but {fs!r}")
                n0 = fs.n_applies
                (nrm, mu, lo, hi), t_kpm = _timed(
                    lambda: km.measure_repr_dynamic_kpm(
                        A, 0, 1, KPM_MOMENTS, bounds=bounds))
                applies = fs.n_applies - n0
                r = ref[(qx, qy)]
                norms2.append(nrm ** 2)
                row = {"q": [qx, qy], "k_target": kt, "dim": dim,
                       "norm": nrm, "norm_ref": r["norm"], "applies": applies,
                       "enumerate_s": t_enum, "engine_s": t_engine,
                       "kpm_s": t_kpm}
                _check(f"kagome q=({qx},{qy}) norm vs SQW_kagome24.json",
                       nrm, r["norm"], 1e-7)
                if qx == qy == 0:
                    if nrm != 0.0 or applies != 0 or r["mu"]:
                        raise AssertionError("kagome q=0: norm must be 0")
                    rows.append(row)
                    continue
                if (lo, hi) != bounds or (r["e_min"], r["e_max"]) != bounds:
                    raise AssertionError("kagome: bounds differ")
                _moments_ok(f"kagome q=({qx},{qy})", mu, 1e-9)
                row["max_diff_vs_ref"] = float(np.max(np.abs(
                    mu - np.asarray(r["mu"]))))
                print(f"check kagome q=({qx},{qy}) moments vs "
                      f"SQW_kagome24.json: {row['max_diff_vs_ref']:.3e} "
                      f"(tol 1e-04)", flush=True)
                if not row["max_diff_vs_ref"] <= 1e-4:
                    raise AssertionError("kagome: moments differ from "
                                         "SQW_kagome24.json")
                row["ms_per_apply"] = t_kpm / applies * 1e3
                row["moments_per_s"] = KPM_MOMENTS / t_kpm
                if kt == [0, 0]:
                    # the target sector k = (0,0), which holds the Sz = 0
                    # member of the ferromagnetic multiplet: its own bounds
                    # against the shared ones, which the flagship computed
                    # from k0 alone
                    g = torch.Generator(device=dev).manual_seed(11)
                    x = fs.project(torch.randn(fs.N, dtype=torch.complex128,
                                               device=dev, generator=g))
                    (elo, ehi), extra["energy_scale_s"] = _timed(
                        lambda: energy_scale(fs, x, slack=0.0))
                    w = ehi - elo
                    extra.update({
                        "sector": kt, "ritz_min": elo, "ritz_max": ehi,
                        "bounds_slack_0.05": [elo - 0.05 * w, ehi + 0.05 * w],
                        "bounds_slack_0.1": [elo - 0.1 * w, ehi + 0.1 * w]})
                    del x
                    if not (bounds[0] < elo - 0.05 * w
                            and ehi + 0.05 * w < bounds[1]):
                        raise AssertionError(
                            f"kagome k={kt}: its bounds [{elo}, {ehi}] "
                            f"(slack 0.05) leave the shared ones")
                    extra["matvec_repr_ms"] = _time_matvec_repr(dst, dev)
                rows.append(row)
    rec = {"model": tag, "card": card_line(), "k0": list(k0),
           "n_moments": KPM_MOMENTS, "bounds": list(bounds),
           "norm2_sum": sum(norms2), "peak_bytes":
           torch.cuda.max_memory_allocated(),
           "label_buffer_bytes": _label_buffer_bytes(), "per_q": rows,
           **extra}
    print("dynamics", json.dumps(rec), flush=True)
    _check("kagome: sum_q norm_q^2 vs the flagship's",
           rec["norm2_sum"], art["sum_rule"]["norms2"], 1e-7)
    km.sec_repr.clear()
    km._fsrepr_bases.clear()
    km._qn_mask_cache = None
    torch.cuda.empty_cache()
    return rec


def _time_matvec_repr(sector, dev, n=3):
    """Seconds of up to ``n`` applies of a momentum sector's matrix-free
    apply (MatvecRepr, K9); stops after one apply that takes over 60 s."""
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn(sector.dim, dtype=torch.complex128, device=dev,
                    generator=g)
    out = []
    for _ in range(n):
        _, t = _timed(lambda: sector.matvec(x))
        out.append(t * 1e3)
        if t > 60.0:
            break
    print(f"MatvecRepr apply at dim {sector.dim}: {out} ms", flush=True)
    return out


def chain_contfrac(dev, chain_case):
    """Phase 10c: continued fractions of Sz(q) at all 24 q of chain L=24
    Sz=0 on phase 5's ELL (dim 2,704,156), checked against the static
    correlators, and one q through KPM with the sum rule of its S(q, w)."""
    from quantum_basis_tpu_torch import Mopr
    from quantum_basis_tpu_torch.postprocess import sqw_kpm
    from quantum_basis_tpu_torch.solvers.lanczos import lanczos_dynamics
    from torch_zoo import sz_pair

    tag, m, _, _, _ = chain_case
    L = m.lattice.n_sites
    x = np.arange(L)
    torch.cuda.reset_peak_memory_stats()
    # one q's injection A|phi> and its Lanczos steps timed apart
    sec = m.sec_full[0]
    (v, nrm), t_inject = _timed(lambda: m._injected(
        _sz_q(np.exp(-2j * np.pi * x / L)), sec, sec, 0, False))
    _, t_steps = _timed(lambda: lanczos_dynamics(sec.matvec, v / nrm,
                                                 CF_STEPS))
    del v
    rows, norms2 = [], []
    for q in range(L):
        A = _sz_q(np.exp(-2j * np.pi * q * x / L))
        (nrm, a, b), t = _timed(
            lambda: m.measure_full_dynamic(A, 0, 0, CF_STEPS))
        norms2.append(nrm ** 2)
        rows.append({"q": q, "norm": nrm, "s": t, "steps": a.size})
        if q == 0 and (nrm != 0.0 or a.size != 0):
            raise AssertionError(f"{tag} q=0: norm must be 0")
        if q and a.size != CF_STEPS:
            raise AssertionError(f"{tag} q={q}: {a.size} coefficients")
    def corr(r):
        """<Sz_0 Sz_r>, averaged over the translations (exact for any
        vector, as norm_q^2 is)."""
        op = Mopr()
        for s in range(L):
            op += (1.0 / L) * sz_pair(s, (s + r) % L)
        return m.measure_full_static(op, 0).real

    corr, t_corr = _timed(lambda: [corr(r) for r in range(L)])
    for q in (1, L // 2):
        want = float(np.sum(np.cos(2 * np.pi * q * x / L) * np.asarray(corr)))
        _check(f"{tag} norm_q^2 = sum_r e^(-iqr) <Sz0 Szr>, q={q}",
               norms2[q], want, 1e-9)
    qk = L // 3
    (nrm, mu, lo, hi), t_kpm = _timed(lambda: m.measure_full_dynamic_kpm(
        _sz_q(np.exp(-2j * np.pi * qk * x / L)), 0, 0, KPM_MOMENTS))
    _moments_ok(f"{tag} q={qk}", mu, 1e-9)
    E0 = m.eigenvals_full[0]
    om = np.linspace(lo - E0 + 1e-3, hi - E0 - 1e-3, 4000)
    integral = float(np.trapezoid(sqw_kpm(om, nrm, mu, lo, hi, E0), om))
    rec = {"model": tag, "card": card_line(), "dim": m.sec_full[0].dim,
           "steps": CF_STEPS, "norm2_sum": sum(norms2), "inject_s": t_inject,
           "ms_per_step": t_steps / CF_STEPS * 1e3,
           "static_correlators_s": t_corr, "kpm_q": qk, "kpm_s": t_kpm,
           "kpm_moments_per_s": KPM_MOMENTS / t_kpm,
           "kpm_norm2": nrm ** 2, "sqw_integral": integral,
           "peak_bytes": torch.cuda.max_memory_allocated(), "per_q": rows}
    print("dynamics", json.dumps(rec), flush=True)
    _check(f"{tag}: sum_q norm_q^2 = L/4", rec["norm2_sum"], L / 4, 1e-10)
    if not abs(integral - nrm ** 2) <= 0.02 * nrm ** 2:
        raise AssertionError(f"{tag} q={qk}: integral of S(q,w) "
                             f"{integral!r} vs norm^2 {nrm ** 2!r}")
    return rec


def interior_window(dev, L=16):
    """Phase 10d: locate_Es on chain-16 Sz=0 (dim 12,870) on its ELL, with
    a window holding the lowest 3-6 levels, against the eigenvalues of the
    dense sector matrix (ops/dense.py, eigvalsh on the card)."""
    from quantum_basis_tpu_torch.ops.dense import dense_matrix
    from torch_zoo import heisenberg_chain

    m, ops = heisenberg_chain(L, device=dev)
    dim = m.enumerate_basis_full([ops["Sz"]], [0.0])
    ell, t_ell = _timed(lambda: m.generate_Ham_sparse_full(check="probe"))
    H, t_dense = _timed(lambda: torch.as_tensor(
        dense_matrix(m.compiled_Ham, m.sec_full[0].labels).real, device=dev))
    w, t_eigh = _timed(lambda: torch.linalg.eigvalsh(H).cpu().numpy())
    del H
    torch.cuda.empty_cache()
    # the window's upper edge sits in the widest gap after 3 to 6 levels
    n = max(range(3, 7), key=lambda k: w[k] - w[k - 1])
    lo, hi = w[0] - 0.5 * (w[1] - w[0]), 0.5 * (w[n - 1] + w[n])
    n0 = ell.n_applies
    torch.cuda.reset_peak_memory_stats()
    got, t = _timed(lambda: m.locate_Es(lo, hi))
    peak = torch.cuda.max_memory_allocated()
    applies = ell.n_applies - n0
    res = [float(torch.linalg.vector_norm(ell(v) - e * v))
           for e, v in zip(got, m.eigenvecs_full)]
    rec = {"model": f"chain{L}_Sz0", "card": card_line(), "dim": dim,
           "window": [lo, hi], "levels": n, "evals": got,
           "dense_evals": w[:n].tolist(), "residuals": res,
           "applies": applies, "locate_Es_s": t,
           "ms_per_apply": t / applies * 1e3, "ell_build_s": t_ell,
           "dense_build_s": t_dense, "eigvalsh_s": t_eigh,
           "peak_bytes": peak}
    print("dynamics", json.dumps(rec), flush=True)
    if len(got) != n:
        raise AssertionError(f"locate_Es found {len(got)} of {n} levels")
    for i, (e, r) in enumerate(zip(got, res)):
        _check(f"chain{L} locate_Es level {i} vs dense eigvalsh", e, w[i],
               1e-9)
        if not r < 1e-6:
            raise AssertionError(f"locate_Es level {i}: residual {r:.3e}")
    return rec


def dynamics_run(bsr_mod, dev, tilted, wide, gs_sector):
    """Phase 10: dynamics and spectra. Returns the kernel's launches (10a)."""
    with jax_bounds("bsr_blowup_max", "bsr_stored_max_bytes",
                    "bsr_auto_max_dim"):
        launches, _ = tilted_dynamics(bsr_mod, dev, tilted)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "SQW_kagome24.json")) as f:
        art = json.load(f)
    if tuple(art["k0"]) != (0, 2) or \
            art["sum_rule"]["norms2"] != SQW_NORM2_SUM:
        raise AssertionError("SQW_kagome24.json is not the flagship's")
    with jax_bounds("fullspace_repr_max_blowup"):
        kagome_sqw(dev, wide[1], gs_sector, art, SQW_BOUNDS)
    chain_contfrac(dev, wide[0])
    interior_window(dev)
    return launches, art


def _b_k(ops, k):
    """B_k = sum_x e^{2 pi i k x} c+_x on the Holstein chain's electrons."""
    from quantum_basis_tpu_torch import Mopr

    out = Mopr()
    for x, c_dag in ops["c_dag"].items():
        out += complex(np.exp(2j * np.pi * k * x)) * c_dag
    return out


def holstein_growth(dev, model, ops, seed):
    """Phase 11a: the basis at depths 8, 12 and 14 (k = 0), the skeleton,
    E0(k=0); MatvecVrnl against the dense H(k) at depth 8."""
    from quantum_basis_tpu_torch.ops.apply_vrnl import MatvecVrnl

    e0_prev = np.inf
    rng = np.random.default_rng(17)
    for depth, (dim_want, lab_crc, skel_crc) in HOLSTEIN_DEPTHS.items():
        torch.cuda.reset_peak_memory_stats()
        dim, t_grow = _timed(lambda: model.build_basis_vrnl(
            [seed], 0, [0.0], [0.0], depth, [ops["N_e"]], [1.0]))
        _, t_skel = _timed(lambda: model.generate_Ham_sparse_vrnl(0))
        s = model.sec_vrnl[0]
        _, t_solve = _timed(lambda: model.locate_E0_lanczos(which="vrnl"))
        peak = torch.cuda.max_memory_allocated()
        vm = s.vmat
        crc = 0
        for arr in (vm.rows, vm.cols, vm.amp_re, vm.amp_im, vm.disp,
                    vm.diag):
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
        e0 = model.eigenvals_vrnl[0]
        print("vrnl", json.dumps({
            "model": "holstein_chain16_Nmax3", "depth": depth, "dim": dim,
            "nnz": int(vm.rows.size), "grow_s": t_grow, "skeleton_s": t_skel,
            "solve_s": t_solve, "E0_k0": e0, "peak_bytes": peak,
            "labels_crc": zlib.crc32(s.labels.tobytes()),
            "skeleton_crc": crc}), flush=True)
        if dim != dim_want:
            raise AssertionError(f"depth {depth}: dim {dim}, not {dim_want}")
        if zlib.crc32(s.labels.tobytes()) != lab_crc or crc != skel_crc:
            raise AssertionError(f"depth {depth}: labels or skeleton differ "
                                 "from the JAX package's (CRC32)")
        if not e0 <= e0_prev + 1e-12:
            raise AssertionError(f"depth {depth}: E0 {e0!r} rose above "
                                 f"{e0_prev!r}")
        e0_prev = e0
        if depth == 8:
            errs = []
            for j in range(9):
                k = [j / 16]
                mv = MatvecVrnl(vm, k)
                x = rng.standard_normal(dim) + 1j * rng.standard_normal(dim)
                y = mv(torch.as_tensor(x, device=dev)).cpu().numpy()
                y_ref = vm.at_momentum(k) @ x
                errs.append(float(np.abs(y - y_ref).max()
                                  / np.abs(y_ref).max()))
            print(f"vrnl MatvecVrnl vs dense H(k) x at depth 8, 9 k: max "
                  f"rel err {max(errs):.3e}", flush=True)
            if not max(errs) <= 1e-12:
                raise AssertionError("MatvecVrnl differs from at_momentum")
    _check("holstein depth 14 E0(k=0)", e0_prev, HOLSTEIN_BAND[0], 1e-9)


def holstein_band(dev, model, ops, seed):
    """Phases 11b and 11c: the polaron band E(k) and the spectral function
    of B_k|0> at k = j/16, j = 0..8, at depth 14, from one skeleton."""
    skel = model._vrnl_skel[1]
    rng = np.random.default_rng(19)
    rows = []
    for j, e_want in enumerate(HOLSTEIN_BAND):
        k = j / 16
        t0 = time.perf_counter()
        model.build_basis_vrnl([seed], 0, [0.0], [k], 14, [ops["N_e"]], [1.0])
        _, t_solve = _timed(lambda: model.locate_E0_lanczos(which="vrnl"))
        s = model.sec_vrnl[0]
        solve_applies = s.matvec.n_applies
        if s.vmat is not skel:
            raise AssertionError(f"k={k}: the skeleton was rebuilt")
        e = model.eigenvals_vrnl[0]
        psi = model.eigenvecs_vrnl[0]
        resid = float(torch.linalg.vector_norm(s.matvec(psi) - e * psi))
        n_e = model.measure_vrnl_static(ops["N_e"])
        x = torch.as_tensor(rng.standard_normal(s.dim)
                            + 1j * rng.standard_normal(s.dim), device=dev)
        apply_ms = cuda_ms(lambda: s.matvec(x))
        # least time of one apply: cols, values, diagonal and x read once,
        # y written once, over the memory rate
        ell = s.matvec
        bound_ms = (ell.cols.numel() * ell.cols.element_size()
                    + ell.vals.numel() * 16
                    + ell.n * (8 + 16 + 16)) / HBM_BYTES_PER_S * 1e3
        # 11c: the spectral function of B_k|0>
        bk = _b_k(ops, k)
        v = model.moprXgs_vrnl(bk)
        (nrm, alphas, betas), t_dyn = _timed(
            lambda: model.measure_vrnl_dynamic(bk, 0, m_steps=100))
        rec = {"k": k, "E": e, "golden": e_want, "residual": resid,
               "N_e": n_e.real, "matvecs": solve_applies,
               "solve_s": t_solve, "apply_ms": apply_ms,
               "apply_bound_ms": bound_ms, "ell_width": ell.width,
               "norm": nrm,
               "alpha0": float(alphas[0]), "dynamics_s": t_dyn}
        if j <= 4:
            m = alphas.size
            T = (np.diag(alphas) + np.diag(betas[:m - 1], 1)
                 + np.diag(betas[:m - 1], -1))
            w, U = np.linalg.eigh(T)
            # ghost copies of the converged pole share its weight
            near = np.abs(w - w[0]) < 1e-6
            rec["pole_E"] = float(w[0])
            rec["pole_weight"] = float(nrm ** 2 * np.sum(U[0, near] ** 2))
            rec["qp_weight"] = float(abs(torch.vdot(psi, v)) ** 2)
        rec["seconds"] = time.perf_counter() - t0
        print("vrnl_band", json.dumps(rec), flush=True)
        _check(f"holstein E(k={k})", e, e_want, 1e-9)
        if not resid < 1e-8:
            raise AssertionError(f"k={k}: residual {resid:.3e}")
        _check(f"holstein N_e at k={k}", n_e.real, 1.0, 1e-9)
        _check(f"holstein |B_k|0>| at k={k}", nrm, 1.0, 1e-12)
        _check(f"holstein alpha0 at k={k}", rec["alpha0"],
               -2.0 * np.cos(2 * np.pi * k), 1e-12)
        if j <= 4:
            _check(f"holstein lowest pole at k={k}", rec["pole_E"], e, 1e-8)
            _check(f"holstein pole weight at k={k}", rec["pole_weight"],
                   rec["qp_weight"], 1e-6)
        rows.append(rec)
    return rows


def wannier_magnon(dev, L=16, nk=8):
    """Phase 11d: the Wannier matrix of the one-magnon band of the
    ferromagnetic background, against its analytic value, then reloaded
    from the per-k records with no eigh."""
    import shutil
    import tempfile

    from quantum_basis_tpu_torch import Opr, config
    from torch_zoo import SP_HALF, heisenberg_chain

    m, cons = heisenberg_chain(L, device=dev)
    vals = np.zeros((1, m.space.n_slots), dtype=np.int64)
    vals[0, L // 2] = 1
    m.build_basis_vrnl(m.space.encode(vals), 0, [0.0], [0.0], 2,
                       [cons["Sz"]], [0.5 * L - 1.0])
    ar = [([float(r)], Opr(r, 0, False, SP_HALF["Sz"])) for r in range(L)]
    momenta = [[j / L] for j in range(nk)]
    c = (L - 1) // 2
    want = np.array([[0.5 * L - 1.0 if i1 == i2 else
                      -np.exp(2j * np.pi * (i1 - i2) * c / L)
                      for i2 in range(nk)] for i1 in range(nk)])
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    old = (config.enable_ckpt, config.ckpt_dir, np.linalg.eigh)
    try:
        config.enable_ckpt, config.ckpt_dir = True, tmp
        mu, t_first = _timed(lambda: m.wannier_mat_vrnl(
            ar, momenta, lambda model, idx: 0))
        n_rec = len(os.listdir(tmp))

        def no_eigh(*a, **kw):
            raise AssertionError("eigh ran despite the per-k records")

        np.linalg.eigh = no_eigh
        mu2, t_second = _timed(lambda: m.wannier_mat_vrnl(
            ar, momenta, lambda model, idx: 0))
    finally:
        config.enable_ckpt, config.ckpt_dir, np.linalg.eigh = old
        shutil.rmtree(tmp, ignore_errors=True)
    err = float(np.abs(mu - want).max())
    print("vrnl_wannier", json.dumps({
        "model": f"chain{L}_one_magnon", "momenta": nk, "records": n_rec,
        "max_err_analytic": err, "first_s": t_first,
        "reloaded_s": t_second}), flush=True)
    if not err <= 1e-9 or n_rec != nk:
        raise AssertionError(f"Wannier: err {err:.3e}, {n_rec} records")
    if not np.abs(mu2 - mu).max() <= 1e-12:
        raise AssertionError("Wannier: the reloaded matrix differs")


def fermion_signs(dev, model, n=100_000):
    """Phase 11e: canonicalize random labels of the Holstein space on the
    card (0-16 fermions each) against the host oracle."""
    from torch_zoo import center_oracle

    ct = model.center_translator
    labels = np.random.default_rng(23).integers(0, model.space.label_space,
                                                size=n)
    lab_t = torch.as_tensor(labels, device=dev)
    (canon, disp, sign), t = _timed(lambda: ct.canonicalize_t(lab_t))
    ms = cuda_ms(lambda: ct.canonicalize_t(lab_t), samples=5, per_sample=2)
    want = center_oracle(model.space, model.lattice, labels)
    got = [canon.cpu().numpy(), disp.cpu().numpy(), sign.cpu().numpy()]
    nflip = int((got[2] < 0).sum())
    print("vrnl_signs", json.dumps({
        "labels": n, "negative_signs": nflip, "first_s": t,
        "canonicalize_ms": ms}), flush=True)
    if not all(np.array_equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("canonicalize differs from the host oracle")
    if nflip == 0:
        raise AssertionError("no fermion sign was exercised")
    return ms


def vrnl_run(bsr_mod, dev):
    """Phase 11: the variational sector at full width on the Holstein
    polaron chain (L = 16, Nmax = 3, t = w = g = 1)."""
    from torch_zoo import holstein_chain

    bsr_mod.launch_count = 0
    t0 = time.perf_counter()
    model, ops = holstein_chain(HOLSTEIN_L, 3, device=dev)
    seed = int(model.space.strides[model.space.slot(HOLSTEIN_L // 2, 0)])
    holstein_growth(dev, model, ops, seed)
    t_a = time.perf_counter() - t0
    rows = holstein_band(dev, model, ops, seed)
    t_bc = time.perf_counter() - t0 - t_a
    wannier_magnon(dev)
    canon_ms = fermion_signs(dev, model)
    if bsr_mod.launch_count != 0:
        raise AssertionError("the vrnl path launched the BSR kernel")
    print("vrnl_summary", json.dumps({
        "card": card_line(), "growth_s": t_a, "band_and_spectra_s": t_bc,
        "s_per_k": t_bc / len(rows),
        "apply_ms_median": float(np.median([r["apply_ms"] for r in rows])),
        "canonicalize_1e5_ms": canon_ms,
        "phase_s": time.perf_counter() - t0}), flush=True)


def _ceil_to(x, m):
    return -(-int(x) // m) * m


def halo_stats_host(ell, P):
    """The JAX package's halo_stats() of an ELL split over P ranks, computed
    on the host with numpy as parallel/halo_sharded.py of the JAX package
    does (per-pair np.unique of the live columns each rank reads from
    another)."""
    n = ell.n
    nl = _ceil_to(max(n, 1), 8 * P) // P
    cols = ell.cols.cpu().numpy()
    live = (ell.vals != 0).cpu().numpy()
    cap, nnz = 1, 0
    for q in range(P):
        rows = slice(q * nl, min((q + 1) * nl, n))
        c_q = cols[rows][live[rows]]
        o_q = c_q // nl
        for p in range(P):
            if p != q:
                u = np.unique(c_q[o_q == p])
                cap, nnz = max(cap, u.size), nnz + u.size
    cap = _ceil_to(cap, 8)
    exchanged, allgather = P * (P - 1) * cap, nl * P * (P - 1)
    return {"halo_nnz": nnz, "pair_capacity": cap,
            "exchanged_per_apply": exchanged,
            "allgather_per_apply": allgather,
            "traffic_ratio": exchanged / max(allgather, 1)}


def mesh_chain24(dev, mesh, chain_labels, chain_e0, rec):
    """12a, chain L=24 Sz=0: sharded enumeration, the halo engine through
    Model, MatvecSharded and FullSpaceSharded against their single-device
    twins. Returns the model (its sector's ELL serves 12b's host halo
    statistics, and phase 14's resume solves it again)."""
    from quantum_basis_tpu_torch.ops.apply_fullspace import FullSpaceOp
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_full
    from quantum_basis_tpu_torch.parallel import (EllShardedHalo,
                                                  MatvecSharded)
    from quantum_basis_tpu_torch.parallel.fullspace_sharded import (
        FullSpaceSharded)
    from torch_zoo import heisenberg_chain, sz_pair

    m, ops = heisenberg_chain(24, device=dev)
    m.set_mesh(mesh)
    dim, rec["chain24_enumerate_s"] = _timed(
        lambda: m.enumerate_basis_full([ops["Sz"]], [0.0]))
    sec = m.sec_full[0]
    same = dim == DIM_24 and np.array_equal(sec.labels, chain_labels)
    print(f"check 12a chain24 labels (sharded dnc + sample sort) equal "
          f"phase 5's: {same}", flush=True)
    if not same:
        raise AssertionError("12a: the sharded enumeration differs")
    sec.ell, rec["chain24_ell_build_s"] = _timed(
        lambda: build_sparse_full(sec.matvec))
    (mv, _), rec["chain24_halo_build_s"] = _timed(
        lambda: m._mesh_engine(sec, "full"))
    if not isinstance(mv, EllShardedHalo):
        raise AssertionError(f"12a: chain24 routed to {mv!r}")
    rec["chain24_halo_stats"] = mv.halo_stats()
    _, rec["chain24_solve_s"] = _timed(lambda: m.locate_E0_lanczos())
    rec["chain24_applies"] = mv.n_applies
    e0 = rec["chain24_E0"] = m.eigenvals_full[0]
    _check("12a chain24 E0 on the mesh vs phase 5's ELL", e0, chain_e0,
           1e-10)
    v = m.eigenvecs_full[0]
    rec["chain24_residual"] = float(torch.linalg.vector_norm(
        sec.ell(v) - e0 * v))
    gate = max(1e3 * 2e-12 * abs(e0), 5e-10)
    if not rec["chain24_residual"] < gate:
        raise AssertionError(f"12a: residual {rec['chain24_residual']:.3e} "
                             f"over the gate {gate:.3e}")
    _check("12a chain24 <Sz0 Sz1> = E0 / 72",
           m.measure_full_static(sz_pair(0, 1), 0, 0).real, e0 / 72.0, 1e-9)

    x = torch.as_tensor(np.random.default_rng(5).standard_normal(dim),
                        device=dev)
    y_ell = sec.ell(x)
    xl = mv.pad(x)
    _hx_check("12a chain24 H x, EllShardedHalo vs ELL", mv.unpad(mv(xl)),
              y_ell, 1e-12)
    rec["halo_ms"] = cuda_ms(lambda: mv(xl), samples=10, per_sample=3)
    rec["ell_ms"] = cuda_ms(lambda: sec.ell(x), samples=10, per_sample=3)
    mvs, rec["allgather_build_s"] = _timed(
        lambda: MatvecSharded(m.compiled_Ham, sec.dbasis, mesh))
    xs = mvs.pad(x)
    _hx_check("12a chain24 H x, MatvecSharded vs ELL", mvs.unpad(mvs(xs)),
              y_ell, 1e-12)
    rec["allgather_ms"] = cuda_ms(lambda: mvs(xs), samples=3, per_sample=1)
    rec["matvec_free_ms"] = cuda_ms(lambda: sec.matvec(x), samples=3,
                                    per_sample=1)
    del mvs, xs

    fs = FullSpaceOp(m.compiled_Ham, sec.labels, device=dev)
    fss, rec["fullspace_sharded_build_s"] = _timed(
        lambda: FullSpaceSharded(fs, mesh))
    xf = fs.to_full(x)
    yf = fs(xf)
    xfl = fss.pad(xf)
    yfs = fss(xfl)
    _hx_check("12a chain24 H x (N = 2^24), FullSpaceSharded vs FullSpaceOp",
              fss.unpad(yfs), yf, 1e-12)
    _hx_check("12a chain24 FullSpaceSharded to_sector vs ELL",
              fss.to_sector(yfs), y_ell, 1e-12)
    rec["fullspace_sharded_ms"] = cuda_ms(lambda: fss(xfl), samples=5,
                                          per_sample=2)
    rec["fullspace_ms"] = cuda_ms(lambda: fs(xf), samples=5, per_sample=2)
    return m


def mesh_kagome(dev, mesh, rec):
    """12a, kagome 2x4 Sz=0 k=(0,2): dnc representatives over the mesh, the
    solve on the complex halo engine."""
    from quantum_basis_tpu_torch.parallel import EllShardedHalo
    from torch_zoo import kagome_heisenberg

    m, ops = kagome_heisenberg(2, 4, device=dev)
    m.set_mesh(mesh)
    dim, rec["kagome_enumerate_s"] = _timed(lambda: m.enumerate_basis_repr(
        [0, 2], [ops["Sz"]], [0.0], method="dnc"))
    if dim != KAGOME24_DIMS[(0, 2)]:
        raise AssertionError(f"12a kagome k=(0,2): dim {dim}")
    sec = m.sec_repr[0]
    (mv, _), rec["kagome_engine_build_s"] = _timed(
        lambda: m._mesh_engine(sec, "repr"))
    if not (isinstance(mv, EllShardedHalo) and mv.is_complex):
        raise AssertionError(f"12a kagome: routed to {mv!r}")
    _, rec["kagome_solve_s"] = _timed(
        lambda: m.locate_E0_lanczos(which="repr"))
    rec["kagome_applies"] = mv.n_applies
    rec["kagome_E0"] = m.eigenvals_repr[0]
    _check("12a kagome24 k=(0,2) E0 on the halo engine", rec["kagome_E0"],
           E0_KAGOME24, 1e-8)
    rng = np.random.default_rng(9)
    x = torch.as_tensor(rng.standard_normal(dim)
                        + 1j * rng.standard_normal(dim), device=dev)
    xl = mv.pad(x)
    _hx_check("12a kagome H x, EllShardedHalo vs ELL", mv.unpad(mv(xl)),
              sec.ell(x), 1e-12)
    rec["kagome_halo_ms"] = cuda_ms(lambda: mv(xl), samples=10, per_sample=3)
    rec["kagome_ell_ms"] = cuda_ms(lambda: sec.ell(x), samples=10,
                                   per_sample=3)


def mesh_kron(dev, mesh, rec):
    """12a: KronSharded on Hubbard 4x4 against KronOp (f64 and f32) in both
    layouts, each against the single-device engine of its own layout; then
    ProductModel(mesh=) on Hubbard 4x2, pure f64 and mixed."""
    from quantum_basis_tpu_torch.ops.apply_kron import KronOp
    from quantum_basis_tpu_torch.parallel.kron_sharded import KronSharded
    from torch_zoo import hubbard_factorized

    pm, _ = hubbard_factorized(4, 4, device=dev)
    ell_a, ell_b = pm._factor_ells()
    P = pm._coupling_matrix()
    for layout in ("ell", "dense"):
        for dt, tol, dtag in ((torch.float64, 1e-12, "f64"),
                              (torch.float32, 5e-6, "f32")):
            tag = f"{dtag}_{layout}"
            ref = KronOp(ell_a, ell_b, coupling=P,
                         coupling_scale=pm.coupling_scale, dtype=dt,
                         layout=layout)
            sh, rec[f"kron_sharded_{tag}_build_s"] = _timed(
                lambda: KronSharded(ell_a, ell_b, coupling=P,
                                    coupling_scale=pm.coupling_scale,
                                    mesh=mesh, dtype=dt, layout=layout))
            gen = torch.Generator(device=dev).manual_seed(5)
            psi = torch.randn(pm.dim, dtype=dt, device=dev, generator=gen)
            y_ref = ref(psi)
            xl = sh.pad(psi)
            _hx_check(f"12a hubbard 4x4 H x, KronSharded vs KronOp {tag}",
                      sh.unpad(sh(xl)).double(), y_ref.double(), tol)
            del y_ref
            rec[f"kron_sharded_{tag}_ms"] = cuda_ms(lambda: sh(xl),
                                                    samples=3, per_sample=1)
            rec[f"kron_{tag}_ms"] = cuda_ms(lambda: ref(psi), samples=3,
                                            per_sample=1)
            del ref, sh, psi, xl
            torch.cuda.empty_cache()
    del pm, ell_a, ell_b, P

    for mixed in (False, True):
        pm, _ = hubbard_factorized(4, 2, device=dev)
        pm.set_mesh(mesh)
        e0, rec[f"product_4x2_{'mixed' if mixed else 'f64'}_s"] = _timed(
            lambda: pm.locate_E0_lanczos(mixed=mixed,
                                         ncv=6 if mixed else 16))
        if not isinstance(pm.op(), KronSharded):
            raise AssertionError("ProductModel(mesh=) did not solve on a "
                                 "KronSharded")
        _check(f"12a hubbard 4x2 E0 on the mesh, mixed={mixed}", e0,
               E0_HUBBARD_4X2, 1e-8)


def mesh_one_rank(dev, chain_labels, chain_e0):
    """Phase 12a: the multi-device route on a 1-rank NCCL group in this
    process (file:// rendezvous in a temporary directory, destroyed at the
    end). Returns its record and the chain-24 ELL."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from quantum_basis_tpu_torch.parallel import basis_mesh, init_distributed

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"phase": "12a", "card": card_line(), "ranks": 1}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        t0 = time.perf_counter()
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        mesh = basis_mesh(device=dev)
        one = torch.ones(1, dtype=torch.float64, device=mesh.device)
        mesh.all_reduce(one)  # NCCL builds its communicator at first use
        torch.cuda.synchronize()
        rec["nccl_init_s"] = time.perf_counter() - t0
        rec["backend"] = mesh.backend
        if mesh.backend != "nccl" or mesh.size != 1:
            raise AssertionError(f"12a: {mesh!r} is not a 1-rank NCCL group")
        rec["all_reduce_scalar_ms"] = cuda_ms(lambda: mesh.all_reduce(one))
        ell = mesh_chain24(dev, mesh, chain_labels, chain_e0,
                           rec).sec_full[0].ell
        torch.cuda.empty_cache()
        mesh_kagome(dev, mesh, rec)
        torch.cuda.empty_cache()
        mesh_kron(dev, mesh, rec)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    print("mesh", json.dumps(rec), flush=True)
    return rec, ell


def mesh_rank(argv) -> int:
    """One rank of phase 12b (``--mesh-rank <out> <rank> 2 <rendezvous>``):
    a 2-rank gloo group with both ranks on cuda:0, chain-24 through
    Model(mesh=); rank 0 writes its record to <out>."""
    import torch.distributed as dist
    from quantum_basis_tpu_torch.parallel import basis_mesh, init_distributed
    from torch_zoo import heisenberg_chain

    out, rank, rdv = argv[0], int(argv[1]), argv[3]
    dev = "cuda:0"
    init_distributed(f"file://{rdv}", 2, rank, device=dev, backend="gloo")
    try:
        mesh = basis_mesh(2, device=dev)
        rec = {"rank": rank, "backend": mesh.backend}
        m, ops = heisenberg_chain(24, device=dev)
        m.set_mesh(mesh)
        _, rec["enumerate_s"] = _timed(
            lambda: m.enumerate_basis_full([ops["Sz"]], [0.0]))
        (mv, _), rec["engine_build_s"] = _timed(
            lambda: m._mesh_engine(m.sec_full[0], "full"))
        rec["engine"] = type(mv).__name__
        rec["halo_stats"] = mv.halo_stats()
        _, rec["solve_s"] = _timed(lambda: m.locate_E0_lanczos())
        rec["applies"] = mv.n_applies
        rec["E0"] = m.eigenvals_full[0]
        xl = mv.pad(torch.as_tensor(np.random.default_rng(5).standard_normal(
            m.dim_full()), device=dev))
        mv(xl)
        _, t = _timed(lambda: [mv(xl) for _ in range(10)])
        rec["apply_ms"] = t * 100.0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(rec, f)
    finally:
        dist.destroy_process_group()
    return 0


def mesh_two_ranks(e0_one_rank, ell):
    """Phase 12b: two ranks on the one card over gloo, which stages CUDA
    tensors through the host (its all-reduce, all-gather and all-to-all
    carry CUDA tensors; FullSpaceSharded's point-to-point runs over NCCL
    in phase 14). Spawns the ranks as processes of this script and kills
    any that outlive the phase. Not a multi-GPU time."""
    import shutil
    import tempfile

    from quantum_basis_tpu_torch.parallel import run_ranks

    tmp = tempfile.mkdtemp(prefix="chip_smoke_gloo_")
    out = os.path.join(tmp, "rank0.json")
    t0 = time.perf_counter()
    run_ranks([sys.executable, os.path.abspath(__file__), "--mesh-rank",
               out], 2, timeout=300)
    wall = time.perf_counter() - t0
    want, t_host = _timed(lambda: halo_stats_host(ell, 2))
    with open(out) as f:
        rec = json.load(f)
    shutil.rmtree(tmp, ignore_errors=True)
    rec.update({"phase": "12b", "card": card_line(), "ranks": 2,
                "label": "2 ranks on one card over gloo, host-staged: not a "
                         "multi-GPU time",
                "host_halo_stats_s": t_host, "phase_wall_s": wall})
    print("mesh", json.dumps(rec), flush=True)
    if rec["engine"] != "EllShardedHalo" or rec["backend"] != "gloo":
        raise AssertionError(f"12b: {rec['engine']} over {rec['backend']}")
    print(f"check 12b halo_stats vs the host's for P = 2: "
          f"{rec['halo_stats']} vs {want}", flush=True)
    if rec["halo_stats"] != want:
        raise AssertionError("12b: halo_stats differ from the host's")
    _check("12b chain24 E0, 2 ranks vs 1 rank", rec["E0"], e0_one_rank,
           1e-10)
    return rec


def mesh_run(dev, chain_labels, chain_e0):
    """Phase 12: the multi-device route (parallel/*). 12a on a 1-rank NCCL
    group in this process, 12b on two gloo ranks of the one card."""
    t0 = time.perf_counter()
    rec, ell = mesh_one_rank(dev, chain_labels, chain_e0)
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t0
    mesh_two_ranks(rec["chain24_E0"], ell)
    del ell
    torch.cuda.empty_cache()
    print(f"phase 12: 12a {t_a:.1f} s, 12b "
          f"{time.perf_counter() - t0 - t_a:.1f} s", flush=True)


def _bit_equal(mesh, tag, value):
    """Every rank's float ``value`` must be the same bit for bit."""
    got = mesh.all_gather(torch.tensor([float(value)], dtype=torch.float64,
                                       device=mesh.device)).tolist()
    if any(v != got[0] for v in got):
        raise AssertionError(f"{tag}: the ranks disagree: {got}")


def _peak_all(mesh) -> int:
    """The largest rank's peak device bytes since the last reset."""
    t = torch.tensor([float(torch.cuda.max_memory_allocated())],
                     dtype=torch.float64, device=mesh.device)
    return int(mesh.all_reduce(t, "max")[0])


def ranks_resume(dev, mesh, m, rec, ckpt_dir):
    """Phase 14, the resume on the mesh: the chain-24 solve of ``m`` (already
    solved cold, record ``rec``) with config.enable_ckpt, interrupted after
    a save by an engine that raises on every rank at the same apply, then
    resumed; rank 0 writes the records and removes ``ckpt_dir``."""
    import shutil

    from quantum_basis_tpu_torch import CkptStore, config
    from quantum_basis_tpu_torch.solvers import restarted
    from quantum_basis_tpu_torch.utils import ckpt as ckpt_mod

    P, sec = mesh.size, m.sec_full[0]
    grp, mv, mask = sec._mesh_mv
    saves = []

    class TimedStore(CkptStore):
        def save(self, key, payload):
            t0 = time.perf_counter()
            super().save(key, payload)
            saves.append((time.perf_counter() - t0,
                          os.path.getsize(self._path(key))))

    out = {"workload": "chain24_resume", "E0_cold": rec["chain24_E0"],
           "applies_cold": rec["chain24_applies"]}
    old = (config.enable_ckpt, config.ckpt_dir, restarted._SAVE_PERIOD,
           ckpt_mod.active_store)
    key = (f"lczsE0_full_sec0_K_nev1_mesh{P}"
           f"_h{m._ham_fingerprint():08x}")
    store = CkptStore(ckpt_dir)
    try:
        config.enable_ckpt, config.ckpt_dir = True, ckpt_dir
        ckpt_mod.active_store = lambda: TimedStore(ckpt_dir)
        restarted._SAVE_PERIOD = 0.0     # every restart boundary saves
        sec._mesh_mv = (grp, _Interrupting(mv, 40), mask)
        try:
            m.locate_E0_lanczos("full", maxit=4000)
        except InterruptedError:
            pass
        else:
            raise AssertionError("14: the interrupting engine never raised")
        finally:
            sec._mesh_mv = (grp, mv, mask)
        krylov = store.load(key + "_krylov")
        if krylov is None or store.load(key) is not None:
            raise AssertionError("14: after the interruption there must be "
                                 "a restart record and no stage record")
        out["record_shape"] = list(krylov["Vre"].shape)
        out["record_it"] = int(krylov["it"])
        del krylov
        out["save_s_bytes_rank0"] = saves[:]
        restarted._SAVE_PERIOD = old[2]
        n0 = mv.n_applies
        _, out["resume_s"] = _timed(
            lambda: m.locate_E0_lanczos("full", maxit=4000))
        out["applies_resumed"] = mv.n_applies - n0
        out["E0_resumed"] = m.eigenvals_full[0]
        if store.load(key + "_krylov") is not None or store.load(key) is None:
            raise AssertionError("14: after the resume the restart record "
                                 "must be gone and the stage record there")
        n0 = mv.n_applies
        _, out["stage_load_s"] = _timed(
            lambda: m.locate_E0_lanczos("full", maxit=4000))
        out["applies_after_stage"] = mv.n_applies - n0
    finally:
        (config.enable_ckpt, config.ckpt_dir, restarted._SAVE_PERIOD,
         ckpt_mod.active_store) = old
        mesh.all_reduce(torch.zeros(1, device=dev)).item()  # all are done
        if mesh.rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)
    if mesh.rank == 0 and os.path.exists(ckpt_dir):
        raise AssertionError(f"14: {ckpt_dir} outlived the resume")
    if out["record_shape"] != [13, mv.n_pad]:
        raise AssertionError(f"14: restart record {out['record_shape']}")
    _check(f"14 chain24 E0 resumed on {P} ranks vs cold", out["E0_resumed"],
           out["E0_cold"], 1e-10)
    _bit_equal(mesh, "14 chain24 resumed E0", out["E0_resumed"])
    if not 0 < out["applies_resumed"] < out["applies_cold"] \
            or out["applies_after_stage"] != 0:
        raise AssertionError(f"14 resume: {out}")
    return out


def ranks_worker(argv) -> int:
    """One rank of phase 14 (``--ranks-worker <dir> <rank> <ranks>
    <rendezvous>``): the workloads of the multi-device route on this rank's
    own card of an NCCL group; rank 0 writes the records to <dir>."""
    import torch.distributed as dist
    from quantum_basis_tpu_torch.benchmarks import hubbard4x4
    from quantum_basis_tpu_torch.parallel import basis_mesh, init_distributed
    from torch_zoo import hubbard_factorized

    work, rank, P, rdv = argv[0], int(argv[1]), int(argv[2]), argv[3]
    with open(os.path.join(work, "reference.json")) as f:
        ref = json.load(f)
    t0 = time.perf_counter()
    init_distributed(f"file://{rdv}", P, rank, device="cuda")
    try:
        mesh = basis_mesh(P, device="cuda")
        dev = mesh.device
        one = torch.ones(1, dtype=torch.float64, device=dev)
        mesh.all_reduce(one)
        torch.cuda.synchronize()
        group = {"ranks": P, "backend": mesh.backend, "card": card_line(),
                 "nccl_init_s": time.perf_counter() - t0,
                 "all_reduce_scalar_ms": cuda_ms(
                     lambda: mesh.all_reduce(one))}
        cards = mesh.all_gather(torch.tensor([dev.index], device=dev))
        if mesh.backend != "nccl" or sorted(cards.tolist()) != list(range(P)):
            raise AssertionError(f"14: {mesh!r} on cards {cards.tolist()}")
        recs = []

        def workload(name, fn):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            rec = dict(group, workload=name)
            t = time.perf_counter()
            got = fn(rec)
            rec["workload_s"] = time.perf_counter() - t
            rec["peak_bytes_per_rank"] = _peak_all(mesh)
            recs.append(rec)
            return got

        labels = np.load(os.path.join(work, "chain24_labels.npy"))

        def chain(rec):
            m = mesh_chain24(dev, mesh, labels, ref["chain24_E0"], rec)
            _bit_equal(mesh, "14 chain24 E0", rec["chain24_E0"])
            want = halo_stats_host(m.sec_full[0].ell, P)
            print(f"check 14 halo_stats vs the host's for P = {P}: "
                  f"{rec['chain24_halo_stats']} vs {want}", flush=True)
            if rec["chain24_halo_stats"] != want:
                raise AssertionError("14: halo_stats differ from the host's")
            return m

        m = workload("chain24", chain)
        workload("chain24_resume", lambda rec: rec.update(ranks_resume(
            dev, mesh, m, recs[0], os.path.join(work, "ckpt"))))
        del m, labels

        def kagome(rec):
            mesh_kagome(dev, mesh, rec)
            _bit_equal(mesh, "14 kagome E0", rec["kagome_E0"])

        workload("kagome24_k02", kagome)
        workload("kron", lambda rec: mesh_kron(dev, mesh, rec))

        def hubbard(rec):
            pm, _ = hubbard_factorized(4, 4, device=dev)
            pm.set_mesh(mesh)
            out = hubbard4x4.solve_sector(pm)
            rec.update({k: out[k] for k in ("dim", "E0", "residual_f64",
                                            "residual_gate", "solve_s",
                                            "solver")})
            # the group takes the card's route (kron_dense_max_dim)
            rec["layouts"] = sorted({op.layout for op in pm._ops.values()})
            if rec["layouts"] != ["ell"]:
                raise AssertionError(f"14 hubbard 4x4: layouts "
                                     f"{rec['layouts']}")
            _check(f"14 hubbard 4x4 E0 on {P} ranks", out["E0"],
                   E0_HUBBARD_4X4, 1e-8)
            _bit_equal(mesh, "14 hubbard 4x4 E0", out["E0"])
            if not out["residual_f64"] < out["residual_gate"]:
                raise AssertionError(f"14 hubbard 4x4: residual "
                                     f"{out['residual_f64']:.3e}")

        workload("hubbard4x4", hubbard)
        if rank == 0:
            with open(os.path.join(work, "records.json"), "w") as f:
                json.dump(recs, f)
    finally:
        dist.destroy_process_group()
    return 0


def ranks_run(n_cards: int, t_start: float) -> None:
    """Phase 14 (``--ranks N``): the multi-device route on N cards of this
    host over NCCL, as a group of N ranks and then (N > 2) of 2, each rank a
    process of this script on its own card; then the scaling and
    communication-roofline drivers on 1, 2, ..., N ranks."""
    import shutil
    import tempfile

    from quantum_basis_tpu_torch.benchmarks import comm_roofline, scaling
    from quantum_basis_tpu_torch.parallel import run_ranks
    from torch_zoo import heisenberg_chain

    have = torch.cuda.device_count()
    if have < n_cards:
        raise RuntimeError(f"--ranks {n_cards} needs {n_cards} cards, this "
                           f"machine has {have}")
    work = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        # the single-device reference (phase 5's chain-24 ELL solve)
        m, ops = heisenberg_chain(24, device="cuda")
        m.enumerate_basis_full([ops["Sz"]], [0.0])
        m.generate_Ham_sparse_full(check="probe")
        _, t_ref = _timed(lambda: m.locate_E0_lanczos("full", maxit=4000))
        ref = {"chain24_E0": m.eigenvals_full[0], "chain24_ell_solve_s": t_ref}
        np.save(os.path.join(work, "chain24_labels.npy"), m.sec_full[0].labels)
        with open(os.path.join(work, "reference.json"), "w") as f:
            json.dump(ref, f)
        print("14 reference", json.dumps(ref), flush=True)
        del m, ops
        torch.cuda.empty_cache()
        for P in [n_cards] + ([2] if n_cards > 2 else []):
            t0 = time.perf_counter()
            outs = run_ranks([sys.executable, os.path.abspath(__file__),
                              "--ranks-worker", work], P, timeout=900)
            print("\n".join(f"[rank 0 of {P}] {line}"
                            for line in outs[0].splitlines()), flush=True)
            with open(os.path.join(work, "records.json")) as f:
                recs = json.load(f)
            os.remove(os.path.join(work, "records.json"))
            for rec in recs:
                print(f"mesh{P}", json.dumps(rec), flush=True)
            print(f"phase 14, {P} ranks: {time.perf_counter() - t0:.1f} s",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    t0 = time.perf_counter()
    scaling.main(["--L", "24", "--ranks", str(n_cards), "--hubbard", "4x4"])
    comm_roofline.main([])
    print(f"phase 14, scaling and comm_roofline: "
          f"{time.perf_counter() - t0:.1f} s; phase 14 "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)


def ell_apply_columns(ell, X, block=128):
    """H X for an ELL matrix and a matrix of column vectors, in column
    blocks (each gather makes an (n, width, block) intermediate)."""
    Y = ell.diag[:, None] * X
    for c in range(0, X.shape[1], block):
        Y[:, c:c + block] += (ell.vals[:, :, None]
                              * X[:, c:c + block][ell.cols]).sum(dim=1)
    return Y


def jax_bounds(*names):
    """Pin the named routing bounds to the JAX package's values (the "cpu"
    table of config.ROUTING) for a phase that drives, on purpose, the route
    those values select on this card (P_k H, the BSR bulk stage)."""
    from quantum_basis_tpu_torch import config

    return config.pinned(**{n: config.ROUTING["cpu"][n] for n in names})


def _label_buffer_bytes() -> int:
    """The bytes the repr kernels' label buffers hold on every card."""
    from quantum_basis_tpu_torch.ops.apply_repr import LabelBuffer

    return LabelBuffer.held_bytes()


class _BuildClock:
    """While entered, times every momentum ELL build that a Model makes
    (``build_sparse_repr`` as models/model.py calls it) by CUDA events on
    the current stream, so that the clock adds no drain of the device to
    the run it sits in: ``n`` builds, ``s`` their seconds (read once the
    run has drained the device)."""

    def __enter__(self):
        from quantum_basis_tpu_torch.models import model as mm

        self.mm, self.real, self.marks = mm, mm.build_sparse_repr, []

        def timed(mv):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            ell = self.real(mv)
            stop.record()
            self.marks.append((start, stop))
            return ell
        mm.build_sparse_repr = timed
        return self

    def __exit__(self, *exc):
        self.mm.build_sparse_repr = self.real

    @property
    def n(self):
        return len(self.marks)

    @property
    def s(self):
        for _, stop in self.marks:
            stop.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.marks) / 1e3


def drivers_run(bsr_mod, dev, art):
    """Phase 13: the drivers of quantum_basis_tpu_torch.examples and
    .benchmarks on the card's own routing bounds. Returns the kernel's
    launches (bsr_bench's included) and the bench record."""
    import importlib

    from quantum_basis_tpu_torch.benchmarks import (
        flagship_kagome24, flagship_kagome24_sqw, hubbard4x4_gaps, out_path)

    bsr_mod.launch_count = 0
    t13 = time.perf_counter()
    for name in EXAMPLES:
        mod = importlib.import_module(
            f"quantum_basis_tpu_torch.examples.{name}")
        kw = ({"out": out_path("sqw_chain")}
              if name == "chain_dynamics_sqw" else {})
        torch.cuda.reset_peak_memory_stats()
        with _BuildClock() as bc:
            out, dt = _timed(lambda: mod.main(device=dev, **kw))
        rows, extra = (out if isinstance(out, tuple) else (out, None))
        print("driver", json.dumps({
            "example": name, "s": dt, "ell_builds": bc.n,
            "ell_build_s": bc.s, "sectors": rows,
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "label_buffer_bytes": _label_buffer_bytes()}), flush=True)
        if name == "chain_dynamics_sqw":
            # sum over q != 0 of |Sz(q)|gs>|^2 = L/4 in the singlet
            n2 = sum(n * n for n in extra["norms"])
            _check("chain-12 S(q,w): sum_q norm^2", n2, extra["L"] / 4, 1e-10)
            if not np.all(np.isfinite(extra["S"])):
                raise AssertionError("chain-12 S(q,w) is not finite")
        torch.cuda.empty_cache()
    print(f"phase 13 examples: {time.perf_counter() - t13:.1f} s",
          flush=True)

    torch.cuda.reset_peak_memory_stats()
    with _BuildClock() as bc:
        rec, dt = _timed(lambda: flagship_kagome24.main(
            device=dev, out=out_path("FLAGSHIP_kagome24_torch.json")))
    print("driver", json.dumps({"benchmark": "flagship_kagome24", "s": dt,
                                "ell_builds": bc.n, "ell_build_s": bc.s,
                                **{k: rec[k] for k in (
                                    "dim_full", "E0_full", "full_engine",
                                    "sectors", "checks", "timings_s")},
                                "peak_bytes": torch.cuda.max_memory_allocated(),
                                "label_buffer_bytes": _label_buffer_bytes()}),
          flush=True)
    if rec["dim_full"] != DIM_24 or sum(x["dim"] for x in rec["sectors"]) \
            != DIM_24:
        raise AssertionError("kagome-24: sector dims do not add up")
    _check("kagome-24 flagship: min_k E0(k) vs E0(full)",
           min(x["E0"] for x in rec["sectors"]), rec["E0_full"], 1e-10)
    _check("kagome-24 flagship: E0(full)", rec["E0_full"], E0_KAGOME24, 1e-8)
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    with _BuildClock() as bc:
        sqw, dt = _timed(lambda: flagship_kagome24_sqw.main(
            device=dev, reference=art,
            out=out_path("SQW_kagome24_torch.json")))
    print("driver", json.dumps({
        "benchmark": "flagship_kagome24_sqw", "s": dt, "ell_builds": bc.n,
        "ell_build_s": bc.s,
        "gs_engine": sqw["gs_engine"], "gs_s": sqw["gs_s"],
        "sum_rule": sqw["sum_rule"],
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "label_buffer_bytes": _label_buffer_bytes(),
        "runs": [{k: r[k] for k in ("q", "engine", "s", "norm_err", "mu_err")}
                 for r in sqw["runs"]]}), flush=True)
    _check("kagome-24 S(q,w): sum_q norm^2", sqw["sum_rule"]["norms2"],
           SQW_NORM2_SUM, 1e-7)
    torch.cuda.empty_cache()

    gaps, dt = _timed(lambda: hubbard4x4_gaps.main(
        4, 2, device=dev,
        out=out_path("HUBBARD4x2_GAPS_torch.json")))
    print("driver", json.dumps({"benchmark": "hubbard4x4_gaps", "lattice":
                                "4x2", "s": dt, **gaps}), flush=True)
    _check("hubbard 4x2 gaps: E0(4,4)", gaps["sectors"]["4,4"]["E0"],
           E0_HUBBARD_4X2, 1e-8)

    bench, dt = _timed(lambda: bsr_bench_run(dev))
    print(f"phase 13: {time.perf_counter() - t13:.1f} s", flush=True)
    return bsr_mod.launch_count, bench


def bsr_bench_run(dev):
    """bsr_bench on its widened cases (the shapes of phase 3 and kagome-24
    k=(0,2)): the kernel against the ELL, agreement checked on the card."""
    from quantum_basis_tpu_torch.benchmarks import bsr_bench

    rec = bsr_bench.main(device=dev)
    print("bsr_bench", json.dumps(rec["calibration"]), flush=True)
    return rec


def gaps_run(dev):
    """``--gaps``: the four sectors of the 4x4 Hubbard gaps at full width,
    checkpointed in a temporary directory; then the driver again, which
    must resume every sector from its completion record with no apply."""
    from quantum_basis_tpu_torch.benchmarks import hubbard4x4_gaps, out_path

    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=here)
    try:
        rec = hubbard4x4_gaps.main(4, 4, device=dev, ckpt_dir=ckpt_dir)
        print("gaps", json.dumps(rec), flush=True)
        _check("hubbard 4x4 E0(8,8)", rec["sectors"]["8,8"]["E0"],
               E0_HUBBARD_4X4, 1e-8)
        again = hubbard4x4_gaps.main(
            4, 4, device=dev, ckpt_dir=ckpt_dir,
            out=out_path("HUBBARD4x4_GAPS_resumed_torch.json"))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print("gaps resumed", json.dumps(again), flush=True)
    for key, sec in again["sectors"].items():
        if sec["applies"] != 0 or sec["E0"] != rec["sectors"][key]["E0"]:
            raise AssertionError(f"gaps: sector {key} was not resumed from "
                                 f"its completion record: {sec}")
    _check("hubbard 4x4 spin gap, resumed", again["spin_gap"],
           rec["spin_gap"], 0.0)
    _check("hubbard 4x4 charge gap, resumed", again["charge_gap"],
           rec["charge_gap"], 0.0)
    return rec


def product_run(dev, t_start, force_full, ckpt_dir=None):
    """Phase 7: the factorized route through ProductModel. With
    ``ckpt_dir`` the full 4x4 solve checkpoints there (phase 16 resumes its
    completion record)."""
    import contextlib

    from quantum_basis_tpu_torch import config
    from quantum_basis_tpu_torch.benchmarks import hubbard4x4
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized)
    from quantum_basis_tpu_torch.ops import apply_kron, krylov
    from quantum_basis_tpu_torch.ops.apply_kron import KronOp, kron_layout
    from quantum_basis_tpu_torch.solvers.lanczos import lanczos_ground
    from quantum_basis_tpu_torch.utils.rng import vec_randomize
    from torch_zoo import hubbard_factorized, site_occupation

    for mixed in (False, True):
        pm, _ = hubbard_factorized(4, 2, device=dev)
        e0, t = _timed(lambda: pm.locate_E0_lanczos(mixed=mixed))
        print("product", json.dumps({
            "model": "hubbard_4x2_half", "dim": pm.dim, "mixed": mixed,
            "E0": e0, "solve_s": t, "solve_info": pm.solve_info}), flush=True)
        _check(f"hubbard 4x2 E0, mixed={mixed}", e0, E0_HUBBARD_4X2, 1e-8)
        if not isinstance(pm.op(), KronOp):
            raise AssertionError("ProductModel did not solve on a KronOp")

    # Hubbard 4x4 half filling, U = 1.1 (benchmarks/hubbard4x4.py), full width
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec = {"model": "hubbard_4x4_half_U1.1", "card": card_line()}
    (pm, ms), rec["factor_build_s"] = _timed(
        lambda: build_factorized(4, 4, device=dev))
    if (pm.na, pm.dim) != HUBBARD4X4_DIMS:
        raise AssertionError(f"4x4: factor dim {pm.na}, dim {pm.dim}")
    rec["dim"], rec["factor_dim"] = pm.dim, pm.na
    # the host's build of the (12870, 12870) int8 coupling, timed apart
    _, rec["coupling_build_s"] = _timed(pm._coupling_matrix)
    fs64, rec["kron_f64_build_s"] = _timed(lambda: pm.op(torch.float64))
    fs32, rec["kron_f32_build_s"] = _timed(lambda: pm.op(torch.float32))
    # ProductModel's defaults take the card's route (kron_dense_max_dim)
    rec["layout"] = route = kron_layout(pm.na, pm.nb, dev)
    for fs, dt in ((fs64, torch.float64), (fs32, torch.float32)):
        if not isinstance(fs, KronOp) or fs.dtype != dt:
            raise AssertionError(f"4x4: engine {fs!r} is not a {dt} KronOp")
        if fs.layout != route or route != "ell":
            raise AssertionError(f"4x4: {dt} engine layout {fs.layout}, "
                                 f"the card's route {route}")
        rec[f"kron_{str(dt)[6:]}_resident_bytes"] = fs.resident_bytes
    gen = torch.Generator(device=dev).manual_seed(5)
    psi = torch.randn(pm.dim, dtype=torch.float64, device=dev, generator=gen)
    y64 = fs64(psi)
    rec["f32_vs_f64_rel_err"] = _hx_check(
        "hubbard 4x4 H x, KronOp f32 vs f64", fs32(psi.float()).double(), y64,
        5e-6)
    # the same product from the factor ELL applied to every column of psi,
    # to every row, and the diagonal coupling
    ell_a, _ = pm._factor_ells()
    X = psi.view(pm.na, pm.nb)
    y_ref = ell_apply_columns(ell_a, X)
    y_ref += ell_apply_columns(ell_a, X.T.contiguous()).T
    y_ref += pm.coupling_scale * torch.as_tensor(
        pm._coupling_matrix(), device=dev) * X
    rec["kron_vs_ell_rel_err"] = _hx_check(
        "hubbard 4x4 H x, KronOp f64 vs factor ELLs", y64, y_ref.view(-1),
        1e-11)
    del y_ref, X, y64
    x32 = psi.float()
    rec["kron_f32_ms"] = cuda_ms(lambda: fs32(x32), samples=3, per_sample=1)
    rec["kron_f64_ms"] = cuda_ms(lambda: fs64(psi), samples=3, per_sample=1)
    del psi, x32
    torch.cuda.empty_cache()

    # the solve; its count of applies on this card is in PERF.md section 5.
    # Beside each apply a Krylov step reads and writes the basis: the K6
    # kernels' (3r + 7) float32 vectors at the memory rate, r the rows
    # projected, on average (K6_KEEP + 1 + ncv) / 2 after a restart
    ncv = config.memory("product_ncv", dev)
    r_mean = (K6_KEEP + 1 + ncv) / 2
    step_ms = (3 * r_mean + 7) * pm.dim * 4 / HBM_BYTES_PER_S * 1e3
    projected = (HUBBARD4X4_F32_APPLIES * (rec["kron_f32_ms"] + step_ms)
                 + HUBBARD4X4_F64_APPLIES * rec["kron_f64_ms"]) * 1.15e-3
    elapsed = time.perf_counter() - t_start
    rec["projected_solve_s"] = projected
    rec["capped"] = capped = (not force_full
                              and elapsed + projected > SCRIPT_BUDGET_S)
    print(f"hubbard 4x4: projected solve {projected:.0f} s after "
          f"{elapsed:.0f} s of the script; "
          f"{'capped' if capped else 'full'} solve", flush=True)
    if capped:
        # one unrestarted f32 Lanczos cycle as long as the time left allows:
        # its Ritz value is variational, so above E0
        steps = int(max(20, min(400, (SCRIPT_BUDGET_S - elapsed)
                                / (2.3e-3 * rec["kron_f32_ms"]))))
        v0 = torch.as_tensor(vec_randomize(pm.dim, seed=1)[0],
                             device=dev).float()
        applied0 = hubbard4x4.applies(pm)
        apply_kron.launch_count = 0   # the kernel's main path: the solve
        out, rec["solve_s"] = _timed(lambda: lanczos_ground(
            fs32, v0, maxit=1, inner=steps, want_vector=False))
        rec["kron_ell_launches"] = apply_kron.launch_count
        rec["applies"] = hubbard4x4.applies(pm) - applied0
        rec["capped_steps"], rec["E0"] = steps, out["E0"]
        rec["residual"] = out["residual"]
        rec["k6_launches"] = {}
    else:
        # the ported driver's solve (benchmarks/hubbard4x4.py)
        with (config.pinned(enable_ckpt=True, ckpt_dir=ckpt_dir)
              if ckpt_dir else contextlib.nullcontext()):
            apply_kron.launch_count = 0   # the kernel's main path: the solve
            krylov.reset_launches()
            out = hubbard4x4.solve_sector(pm)
            rec["kron_ell_launches"] = apply_kron.launch_count
        # the f32 bulk stage's applies are its Krylov steps (the RQI
        # polish after it makes none)
        rec["k6_launches"] = k6_launches(
            "hubbard 4x4", out["solver"]["f32_stage_matvecs"])
        rec["applies"] = out["applies"]
        rec["solve_s"], rec["E0"] = out["solve_s"], out["E0"]
        rec["residual"] = out["residual_f64"]
        rec["residual_gate"] = out["residual_gate"]
        n0 = site_occupation(0)
        rec["double_occupancy_site0"], rec["measure_s"] = _timed(
            lambda: pm.measure_product_static(n0, n0))
    rec["solve_info"] = pm.solve_info
    rec["peak_bytes"] = torch.cuda.max_memory_allocated()
    print("product", json.dumps(rec), flush=True)
    if capped:
        print(f"check hubbard 4x4 capped f32 Ritz value {rec['E0']!r} in "
              f"[{E0_HUBBARD_4X4}, {E0_HUBBARD_4X4 + 1e-2}]", flush=True)
        if not -1e-4 <= rec["E0"] - E0_HUBBARD_4X4 <= 1e-2:
            raise AssertionError(f"4x4 capped: Ritz value {rec['E0']!r}")
    else:
        _check("hubbard 4x4 E0", rec["E0"], E0_HUBBARD_4X4, 1e-8)
    # every apply of the solve went through the kernel: two launches each
    if not 0 < rec["kron_ell_launches"] == 2 * rec["applies"]:
        raise AssertionError(f"4x4: {rec['kron_ell_launches']} kron_ell "
                             f"launches for {rec['applies']} applies")
    if not capped:
        if not rec["residual"] < rec["residual_gate"]:
            raise AssertionError(f"4x4: residual {rec['residual']:.3e} over "
                                 f"the gate {rec['residual_gate']:.3e}")
        if not 0.0 < rec["double_occupancy_site0"] < 0.25:
            raise AssertionError("4x4: double occupancy "
                                 f"{rec['double_occupancy_site0']!r}")
    return rec


def _as_wide(side):
    """A side in the wide slot form: its decoded columns and values."""
    from quantum_basis_tpu_torch.ops.apply_kron import decode_slots

    cols, vals = decode_slots(side)
    return cols.to(torch.int32), vals.contiguous(), side[2]


def _ell_csr(side, n_cols):
    """The CSR tensor of a side's slot-major ELL arrays, in either slot
    form (for the library call)."""
    from quantum_basis_tpu_torch.ops.apply_kron import decode_slots

    cols, vals = decode_slots(side)
    W, n = cols.shape
    live = torch.arange(W, device=cols.device)[:, None] < side[2][None, :]
    rows = torch.arange(n, device=cols.device)[None, :].expand(W, n)
    idx = torch.stack([rows[live], cols[live]])
    return torch.sparse_coo_tensor(idx, vals[live], (n, n_cols)) \
        .coalesce().to_sparse_csr()


def _side_bytes(op):
    """Bytes of the engine's factor ELL arrays (a shared side once)."""
    sides = op._Aell + (op._Bell if op._Bell is not op._Aell else ())
    return sum(t.numel() * t.element_size() for t in sides)


def kron_bound(op):
    """Least time of one ELL apply of ``op`` on this card in ms, and which
    bound it is: psi read once, P read once, y written once, the factor ELLs
    and diagonals read once, over the memory rate; against 2 operations per
    live factor entry per column and 6 per output (a + b, s P, the sum,
    the product with psi, the add to y) over the peak rate of the type."""
    item = torch.empty((), dtype=op.dtype).element_size()
    N = op.na * op.nb
    nbytes = (2 * N * item + (0 if op._P is None else op._P.numel()
                              * op._P.element_size())
              + _side_bytes(op) + (op.na + op.nb) * item)
    nnz_a, nnz_b = int(op._Aell[2].sum()), int(op._Bell[2].sum())
    flops = 2 * (nnz_a * op.nb + nnz_b * op.na) + 6 * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[op.dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def kron_floor(op):
    """Least time in ms of the kernel's two passes in device memory: pass 1
    reads psi and writes its sums, pass 2 reads psi, those sums and P and
    writes y; each reads the factor ELLs and the diagonals once. The bound
    (kron_bound) counts a single pass."""
    item = torch.empty((), dtype=op.dtype).element_size()
    N = op.na * op.nb
    nbytes = (5 * N * item + (0 if op._P is None else op._P.numel()
                              * op._P.element_size())
              + 2 * (_side_bytes(op) + (op.na + op.nb) * item))
    return nbytes / HBM_BYTES_PER_S * 1e3


def wide_rows_case(dev, dt, nr=5, nb=30_000, W=6, seed=3):
    """A synthetic ELL apply whose psi rows are too long for one staged
    panel of the kernel (nb = 30,000 > 14,528: pass 2 gathers from device
    memory): A (nr, nr), B (nb, nb) with random live counts and random
    values, more than 65,536 distinct, so that B takes the wide slot form
    by shape in f64 too (A, 5 rows, the compact form in f64); int8
    coupling. The args of kron_ell."""
    from quantum_basis_tpu_torch.ops.apply_kron import is_compact, pack_slots

    rng = np.random.default_rng(seed)

    def side(n, ncols):
        cnt = rng.integers(0, W + 1, n)
        live = np.arange(W)[None, :] < cnt[:, None]
        return pack_slots(torch.as_tensor(rng.integers(0, ncols, (n, W))),
                          torch.as_tensor(rng.standard_normal((n, W)) * live),
                          ncols, dt, dev)

    A, B = side(nr, nr), side(nb, nb)
    if is_compact(B) or is_compact(A) != (dt == torch.float64):
        raise AssertionError("wide rows: B must take the wide slot form, "
                             "A the compact in f64")
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    P = torch.as_tensor(rng.integers(-3, 4, (nr, nb)), dtype=torch.int8,
                        device=dev)
    return (A, B, t(rng.standard_normal(nr)), t(rng.standard_normal(nb)), P,
            1.1, t(rng.standard_normal((nr, nb))))


def kernel_device_ms(fn, tags, reps=5, windows=3, per_call=False):
    """Device ms a call of fn of the kernels whose names hold each of
    ``tags`` (summed over the kernels a tag names, each per launch; with
    ``per_call`` every launch of a call summed) in a torch.profiler window
    of ``reps`` calls of fn (the launches alone, without the host work of
    their wrapper). The profiler's trace of the
    card sometimes comes back without the launches' kernels; a tag that no
    window of ``windows`` saw maps to None ("not measured"): the CUDA-event
    times beside it stand."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    out = {tag: None for tag in tags}
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {tag: None for tag in tags}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CPU:
                continue
            for tag in tags:
                if tag in e.key:
                    out[tag] = (out[tag] or 0.0) \
                        + e.self_device_time_total / 1e3 / (
                            reps if per_call else e.count)
        if all(v is not None for v in out.values()):
            return out
    print(f"torch.profiler saw no device time of {sorted(tags)} in "
          f"{windows} windows: not measured", flush=True)
    return out


def kron_ell_run(dev):
    """Phase 17: the fused ELL kron kernel (csrc/kron_ell.cu) against its
    plain version and the dense layout on Hubbard 4x2 and 4x4 at half
    filling and the 4x4 gap sector (9, 8), f64 (1e-12 of max|y|) and f32
    (5e-6); at 4x4 its time (CUDA events) beside the plain version's, the
    dense layout's, the library's (one torch.sparse.mm CSR product per
    side, used nowhere in the package) and the bound. Returns the kernel
    record's numbers."""
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized, build_factorized_sector)
    from quantum_basis_tpu_torch.ops import apply_kron
    from quantum_basis_tpu_torch.ops.apply_kron import (KronOp, is_compact,
                                                        kron_ell)

    cases = {"hubbard4x2": lambda: build_factorized(4, 2, device=dev)[0],
             "hubbard4x4": lambda: build_factorized(4, 4, device=dev)[0],
             "hubbard4x4_9_8": lambda: build_factorized_sector(
                 4, 4, 9, 8, device=dev)}
    out = {"max_abs_err": 0.0}
    for name, build in cases.items():
        pm = build()
        ell_a, ell_b = pm._factor_ells()
        P = pm._coupling_matrix()
        for dt, tol in ((torch.float64, 1e-12), (torch.float32, 5e-6)):
            tag = f"{name} {str(dt)[6:]}"
            op = KronOp(ell_a, ell_b, coupling=P,
                        coupling_scale=pm.coupling_scale, dtype=dt,
                        layout="ell")
            gen = torch.Generator(device=dev).manual_seed(17)
            psi = torch.randn((pm.na, pm.nb), dtype=dt, device=dev,
                              generator=gen)
            args = (op._Aell, op._Bell, op._adiag, op._bdiag, op._P,
                    op._pscale, psi)
            # the slot form by type and shape: every factor here is
            # compact in f64, wide in f32
            f64 = dt == torch.float64
            if not is_compact(op._Aell) == is_compact(op._Bell) == f64:
                raise AssertionError(f"17 {tag}: not the slot form of {dt}")
            forms = [("compact" if f64 else "wide", args)]
            if f64:   # the same factors in the wide form
                wide_a = _as_wide(op._Aell)
                wide_b = wide_a if op._Bell is op._Aell else _as_wide(
                    op._Bell)
                forms.append(("wide", (wide_a, wide_b) + args[2:]))
            yk = kron_ell(*args)
            for form, a in forms:
                yf = kron_ell(*a)
                yp = apply_kron._kron_ell_plain(*a, psi)
                out["max_abs_err"] = max(out["max_abs_err"],
                                         float((yf - yp).abs().max()))
                _hx_check(f"17 {tag} {form}: kernel vs plain", yf.view(-1),
                          yp.view(-1), tol)
                del yp, yf
            dense = KronOp(ell_a, ell_b, coupling=P,
                           coupling_scale=pm.coupling_scale, dtype=dt,
                           layout="dense")
            _hx_check(f"17 {tag}: kernel vs the dense layout", yk.view(-1),
                      dense(psi.view(-1)), tol)
            rec = {"case": name, "dtype": str(dt)[6:], "dim": pm.dim,
                   "factor_dims": [pm.na, pm.nb],
                   "ell_resident_bytes": op.resident_bytes,
                   "dense_resident_bytes": dense.resident_bytes}
            if name == "hubbard4x4":
                rec["ms"] = cuda_ms(lambda: kron_ell(*args), samples=9,
                                    per_sample=2)
                if f64:
                    wide = forms[1][1]
                    rec["wide_form_ms"] = cuda_ms(lambda: kron_ell(*wide),
                                                  samples=9, per_sample=2)
                    del wide
                rec["passes_ms"] = kernel_device_ms(
                    lambda: kron_ell(*args), ("kron_ell_a", "kron_ell_b"))
                rec["plain_ms"] = cuda_ms(
                    lambda: apply_kron._kron_ell_plain(*args, psi),
                    samples=3, per_sample=1)
                x = psi.view(-1)
                rec["dense_ms"] = cuda_ms(lambda: dense(x), samples=3,
                                          per_sample=1)
                rec["bound_ms"], rec["bound_by"] = kron_bound(op)
                rec["floor_ms"] = kron_floor(op)
                del dense
                torch.cuda.empty_cache()
                Acsr = _ell_csr(op._Aell, pm.na)
                Bcsr = _ell_csr(op._Bell, pm.nb)

                def library():
                    return (torch.sparse.mm(Acsr, psi)
                            + torch.sparse.mm(Bcsr, psi.t()).t())
                d = op._adiag[:, None] + op._bdiag[None, :] \
                    + op._pscale * op._P.to(dt)
                _hx_check(f"17 {tag}: library products + diagonal vs kernel",
                          (library() + d * psi).view(-1), yk.view(-1), tol)
                del d
                rec["library_ms"] = cuda_ms(library, samples=3,
                                            per_sample=1)
                del Acsr, Bcsr
                if dt == torch.float32:   # the main path's apply
                    out.update({k: rec[k] for k in (
                        "ms", "plain_ms", "dense_ms", "bound_ms",
                        "bound_by", "library_ms")})
            print("kron_ell", json.dumps(rec), flush=True)
            del op, psi, yk, args, forms
            torch.cuda.empty_cache()
        del pm, ell_a, ell_b, P
    # the kernel's other branch: pass 2 gathering from device memory, B in
    # the wide form (chosen by shape in f64)
    for dt, tol in ((torch.float64, 1e-12), (torch.float32, 5e-6)):
        args = wide_rows_case(dev, dt)
        yk = kron_ell(*args)
        yp = apply_kron._kron_ell_plain(*args, args[-1])
        out["max_abs_err"] = max(out["max_abs_err"],
                                 float((yk - yp).abs().max()))
        _hx_check(f"17 wide rows {str(dt)[6:]}: kernel vs plain",
                  yk.view(-1), yp.view(-1), tol)
    return out


def _k2_args(mv):
    """apply_rows' arguments of a MatvecFull's whole apply, x left out."""
    b = mv.basis
    return (mv.tables, b.index.tables,
            b.labels_b.view(-1), b.V_b.view(-1, b.space.n_slots), b.fodd,
            mv.diag_b.view(-1)[: b.n])


def _scatter_args(op, src, dst):
    """scatter_rows' arguments of mopr_x_vec(op, src, dst, x), x left out."""
    from quantum_basis_tpu_torch.ops.apply import _device_diag, pack_rows

    d = _device_diag(op, src)
    return (pack_rows(op, src.device), dst.index.tables,
            src.labels_b.view(-1), src.V_b.view(-1, src.space.n_slots),
            src.fodd, None if d is None else d.view(-1)[: src.n])


def _images(tabs, labels, V, fodd, n, block=1 << 21):
    """(row, amp * sign, target label) of every nonzero image of the rows
    0 .. n - 1, block by block (the plain version's helper)."""
    from quantum_basis_tpu_torch.ops.apply import _row_images

    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        amp, tgt = _row_images(tabs, labels[i0:i1], V[i0:i1],
                               None if fodd is None else fodd[i0:i1])
        keep = amp != 0
        rows = torch.arange(i0, i1, device=labels.device)[:, None] \
            .expand_as(tgt)
        yield rows[keep], amp[keep], tgt[keep]


def k2_bound(args, x, n_dst=None):
    """Least time of one apply_rows call (``n_dst`` None) or scatter_rows
    call on this card in ms, and which bound it is. Bytes: each row's state
    read once as its label or its slot values V, whichever is smaller (each
    is decoded from the other), and only where it is used: by an image, or
    by the scatter's diagonal check; Fodd (where fermionic), diagonal and x
    read once, y written once, the packed tables once, and the 32-byte
    sectors of the direct index that this run's nonzero images (and,
    scattering, the diagonal's labels) touch, with the sectors of the
    destination's labels that the scatter's check reads; over the memory
    rate. Operations: 2 per nonzero image and vector component (4 with
    complex amplitudes) and 2 per row, over the float64 peak."""
    tabs, ix, labels, V, fodd, diag = args
    if ix.mode != "direct":
        raise ValueError("the bound counts the direct index's sectors")
    n = labels.numel() if n_dst is not None else diag.numel()
    n = min(n, x.numel())
    comp = 2 if x.is_complex() else 1
    state = tabs.n_cols or (n_dst is not None and diag is not None)
    per_row = (min(8, V.shape[1]) if state else 0) \
        + (8 if fodd is not None and tabs.wmask is not None else 0) \
        + (8 if diag is not None else 0) + 8 * comp
    n_out = n if n_dst is None else n_dst
    per = 32 // ix.t0.element_size()     # position-table entries a sector
    check = n_dst is not None            # the destination's labels read
    pos = torch.zeros(-(-ix.label_space // per), dtype=torch.bool,
                      device=x.device)
    lab = torch.zeros(-(-ix.n // 4), dtype=torch.bool, device=x.device)
    images = 0
    for _, amp, tgt in _images(tabs, labels, V, fodd, n):
        images += tgt.numel()
        t = tgt.clamp(0, ix.label_space - 1)
        pos[t // per] = True
        if check:
            lab[ix.t0[t].long() // 4] = True
    if n_dst is not None and diag is not None:
        pos[labels[:n] // per] = True
        if check:
            lab[ix.t0[labels[:n]].long() // 4] = True
    nbytes = (per_row * n + 8 * comp * n_out + tabs.nbytes
              + 32 * int(pos.sum()) + 32 * int(lab.sum()))
    flops = (4 if tabs.is_complex else 2) * comp * images + 2 * comp * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float64] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _csr(rows, cols, vals, shape):
    return torch.sparse_coo_tensor(torch.stack([rows, cols]), vals, shape) \
        .coalesce().to_sparse_csr()


def k2_library(args, x, n_dst=None):
    """(ms, y) of one ``torch.sparse`` CSR product computing the same
    function as the kernel on the same vector: the sector's H (gather, from
    the plain version's images, conjugated) or O (scatter, the images the
    destination holds), diagonal included; or (None, None) where this
    PyTorch has no such product. Timed only: nothing in the package calls
    it."""
    tabs, ix, labels, V, fodd, diag = args
    n = diag.numel() if n_dst is None else labels.numel()
    n = min(n, x.numel())
    R, C, A = [], [], []
    for rows, amp, tgt in _images(tabs, labels, V, fodd, n):
        j = ix.t0[tgt.clamp(0, ix.label_space - 1)].long() \
            if ix.mode == "direct" else None
        if n_dst is not None:    # the images the destination holds
            ok = ix.labels[j] == tgt
            rows, j, amp = j[ok], rows[ok], amp[ok]
        else:                    # row i of H is the conjugate
            amp = amp.conj()
        R.append(rows)
        C.append(j)
        A.append(amp)
    dt = x.dtype if not tabs.is_complex else torch.complex128
    if diag is not None:
        rows = cols = torch.arange(n, device=x.device)
        d = diag[:n]
        if n_dst is not None:
            j = ix.t0[labels[:n]].long()
            ok = ix.labels[j] == labels[:n]
            rows, cols, d = j[ok], cols[ok], d[ok]
        R.append(rows)
        C.append(cols)
        A.append(d)
    shape = (n if n_dst is None else n_dst, n)
    try:
        M = _csr(torch.cat(R), torch.cat(C), torch.cat([a.to(dt) for a in A]),
                 shape)
        xx = x[:n].to(dt if x.is_complex() or dt.is_complex else x.dtype)
        y = M @ xx
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"library call: {str(e).splitlines()[0]}", flush=True)
        return None, None
    return cuda_ms(lambda: M @ xx, samples=5, per_sample=2), y


def k2_check(tag, got, want, out, key="max_abs_err"):
    """Kernel against plain version, 1e-12 of max|y|; keeps the worst
    absolute error in out[key]."""
    torch.cuda.synchronize()
    out[key] = max(out.get(key, 0.0), float((got - want).abs().max()))
    _hx_check(f"18 {tag}: kernel vs plain", got, want, 1e-12)


def k2_gather_case(tag, mv, out, vecs=("real", "complex"), time_it=False):
    """apply_rows of one MatvecFull against its plain version; with
    ``time_it`` its record (kernel, plain, library, bound), with
    ``time_it="kernel"`` the kernel's time alone."""
    from quantum_basis_tpu_torch.ops import apply
    from quantum_basis_tpu_torch.ops.apply import _apply_rows_plain

    args = _k2_args(mv)
    n = mv.n
    rng = np.random.default_rng(18)
    rec = {"case": tag, "dim": n, "index_mode": args[1].mode,
           "image_columns": mv.tables.n_cols, "bits": mv.tables.bits,
           "tables_bytes": mv.tables.nbytes}
    for vec in vecs:
        x = torch.as_tensor(rng.standard_normal(n), device=mv.device)
        if vec == "complex":
            x = torch.complex(x, torch.as_tensor(rng.standard_normal(n),
                                                 device=mv.device))
        before = apply.launch_count
        y = mv(x)
        if apply.launch_count != before + 1:
            raise AssertionError(f"18 {tag}: MatvecFull made "
                                 f"{apply.launch_count - before} launches")
        yp = _apply_rows_plain(*args, x, 0, n, n)
        k2_check(f"{tag} {vec} apply_rows", y, yp, out)
        if time_it and vec == vecs[0]:
            rec["ms"] = cuda_ms(lambda: mv(x), samples=9, per_sample=3)
            rec["device_ms"] = kernel_device_ms(
                lambda: mv(x), ("apply_rows_kernel",))["apply_rows_kernel"]
        if time_it is True and vec == vecs[0]:
            rec["plain_ms"] = cuda_ms(
                lambda: _apply_rows_plain(*args, x, 0, n, n), samples=3,
                per_sample=1)
            rec["bound_ms"], rec["bound_by"] = k2_bound(args, x)
            rec["library_ms"], yl = k2_library(args, x)
            if yl is not None:
                _hx_check(f"18 {tag}: library CSR product vs kernel", yl, y,
                          1e-12)
            del yl
        del x, y, yp
    print("apply_rows", json.dumps(rec), flush=True)
    return rec


def k2_scatter_case(tag, op, src, dst, out, x, time_it=False):
    """scatter_rows through mopr_x_vec against its plain version."""
    from quantum_basis_tpu_torch.ops import apply
    from quantum_basis_tpu_torch.ops.apply import (_scatter_rows_plain,
                                                   mopr_x_vec, scatter_rows)

    args = _scatter_args(op, src, dst)
    before = apply.scatter_launch_count
    y = mopr_x_vec(op, src, dst, x)
    if apply.scatter_launch_count != before + 1:
        raise AssertionError(f"18 {tag}: mopr_x_vec made "
                             f"{apply.scatter_launch_count - before} "
                             f"launches")
    xx = x.to(y.dtype)
    yp = _scatter_rows_plain(*args, xx, src.n)
    k2_check(f"{tag} scatter_rows", y, yp, out, "scatter_max_abs_err")
    rec = {"case": tag, "src_dim": src.n, "dst_dim": dst.n,
           "image_columns": args[0].n_cols}
    if time_it:
        # the kernel on the packed arguments, as the plain version and the
        # library are timed; mopr_x_vec also packs the tables and evaluates
        # the diagonal at every call
        rec["ms"] = cuda_ms(lambda: scatter_rows(*args, xx, src.n),
                            samples=9, per_sample=3)
        rec["device_ms"] = kernel_device_ms(
            lambda: scatter_rows(*args, xx, src.n),
            ("scatter_rows_kernel",))["scatter_rows_kernel"]
        rec["mopr_x_vec_ms"] = cuda_ms(lambda: mopr_x_vec(op, src, dst, x),
                                       samples=5, per_sample=2)
        rec["plain_ms"] = cuda_ms(
            lambda: _scatter_rows_plain(*args, xx, src.n), samples=3,
            per_sample=1)
        rec["bound_ms"], rec["bound_by"] = k2_bound(args, xx, dst.n)
        rec["library_ms"], yl = k2_library(args, xx, dst.n)
        if yl is not None:
            _hx_check(f"18 {tag}: library CSR product vs kernel", yl, y,
                      1e-12)
        if args[0].diag_only:
            # the row's own add as the plain store that diag_only takes
            # against an atomic add, in turns: store, atomic, atomic, store
            import dataclasses

            a2 = (dataclasses.replace(args[0], diag_only=False),) + args[1:]
            k2_check(f"{tag} scatter_rows, atomic own add",
                     scatter_rows(*a2, xx, src.n), yp, out,
                     "scatter_max_abs_err")

            def store():
                return scatter_rows(*args, xx, src.n)

            def atomic():
                return scatter_rows(*a2, xx, src.n)
            t = [cuda_ms(f, samples=9, per_sample=3)
                 for f in (store, atomic, atomic, store)]
            rec["own_add_turns_ms"] = {"store": [t[0], t[3]],
                                       "atomic": [t[1], t[2]]}
            rec["own_add_device_ms"] = {
                k: kernel_device_ms(f, ("scatter_rows_kernel",))[
                    "scatter_rows_kernel"]
                for k, f in (("store", store), ("atomic", atomic))}
    print("scatter_rows", json.dumps(rec), flush=True)
    return rec


def k2_sharded(dev, model, x, out):
    """MatvecSharded at P = 1 (a 1-rank NCCL group in this process, as in
    phase 12a): one apply_rows launch over the rank's rows against the plain
    version and the sector's own apply."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from quantum_basis_tpu_torch.ops import apply
    from quantum_basis_tpu_torch.ops.apply import _apply_rows_plain
    from quantum_basis_tpu_torch.parallel import (MatvecSharded, basis_mesh,
                                                  init_distributed)

    sec = model.sec_full[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        init_distributed(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        mesh = basis_mesh(device=dev)
        mvs = MatvecSharded(model.compiled_Ham, sec.dbasis, mesh)
        xs = mvs.pad(x)
        before = apply.launch_count
        ys = mvs(xs)
        if apply.launch_count != before + 1:
            raise AssertionError("18 MatvecSharded: not one launch")
        b = sec.dbasis
        yp = _apply_rows_plain(mvs.tables, b.index.tables,
                               b.labels_b.view(-1),
                               b.V_b.view(-1, b.space.n_slots), b.fodd,
                               mvs._diag, mesh.all_gather(xs), mvs._row0,
                               mvs._rows, mvs.n)
        k2_check("chain24 MatvecSharded P=1", ys, yp, out)
        _hx_check("18 chain24 MatvecSharded P=1 vs MatvecFull",
                  mvs.unpad(ys), sec.matvec(x), 1e-12)
        if bool((ys[mvs.n:] != 0).any()):
            raise AssertionError("18 MatvecSharded: padding rows not zero")
        out["sharded_ms"] = cuda_ms(lambda: mvs(xs), samples=5, per_sample=2)
        print("apply_rows", json.dumps({
            "case": "chain24_Sz0 MatvecSharded P=1", "rows": mvs._rows,
            "ms": out["sharded_ms"]}), flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def apply_rows_run(dev):
    """Phase 18: the fused row apply (csrc/apply_rows.cu) against its plain
    versions on the card, 1e-12 of max|y|: apply_rows on chain-24 Sz=0
    (direct, and with lin and bsearch forced), Sz(q) in the gather
    direction (diagonal columns), an all-pairs exchange whose tables exceed
    TABLES_SHARED_MAX, kagome-24 Sz=0, Hubbard 4x3 (6, 6) (two fermions a
    slot), the DM chain L=24 (complex H), the spin-1 chain L=16 (staged
    V), chain-26 Sz=0 and MatvecSharded at P = 1; scatter_rows through
    mopr_x_vec of <Sz0 Sz1> (phase 5's shape), Sz(q) and S^-(q) into Sz=-1
    on chain-24. Times kernel, plain version, library and bound at
    chain-24, kagome-24, spin-1 and chain-26, and for the scatter at the
    first two operators (with the own add stored and added in turns);
    solves chain-26 Sz=0 on the matrix-free route and
    on its ELL (E0 1e-10, residuals under the gate). Returns the kernel
    record's numbers."""
    from quantum_basis_tpu_torch.basis.index import BasisIndex
    from quantum_basis_tpu_torch.basis.lin_table import digit_split
    from quantum_basis_tpu_torch.ops import apply
    from quantum_basis_tpu_torch.ops.apply import DeviceBasis, MatvecFull
    from torch_zoo import (SP_HALF, dm_chain, fermi_hubbard_square,
                           heisenberg_chain, kagome_heisenberg, sz_pair)
    from quantum_basis_tpu_torch import Mopr, Opr

    t18 = time.perf_counter()
    out = {}
    m, ops = heisenberg_chain(24, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    out["apply_rows"] = k2_gather_case("chain24_Sz0", sec.matvec, out,
                                       time_it=True)
    for mode in ("lin", "bsearch"):
        ix = BasisIndex(sec.labels, m.space.label_space, mode=mode,
                        lin_split=digit_split(m.space), device=dev)
        if ix.mode != mode:
            raise AssertionError(f"18 chain24: index mode {ix.mode}")
        db = DeviceBasis(m.space, sec.labels, ix, device=dev)
        r = k2_gather_case(f"chain24_Sz0_{mode}",
                           MatvecFull(m.compiled_Ham, db), out,
                           vecs=("real",),
                           time_it="kernel" if mode == "lin" else False)
        if mode == "lin":
            out["apply_rows"]["lin_ms"] = r["ms"]
        del db, ix
    L = 24
    q = 2 * np.pi * 5 / L
    szq, smq = Mopr(), Mopr()
    for s in range(L):
        ph = np.exp(1j * q * s) / np.sqrt(L)
        szq += ph * Opr(s, 0, False, SP_HALF["Sz"])
        smq += ph * Opr(s, 0, False, SP_HALF["Sm"])
    # the kernel paths the main shapes do not take: a diagonal column with
    # a complex amplitude in the gather direction (Sz(q)'s columns), and
    # tables above TABLES_SHARED_MAX (an all-pairs exchange with complex
    # couplings: 276 columns, 40 KB), read through the read-only cache
    mv_szq = MatvecFull(m.compile_op(szq), sec.dbasis)
    if not bool(mv_szq.tables.diagonal.all()):
        raise AssertionError("18 Sz(q): a column is not diagonal")
    k2_gather_case("chain24_Sz0 Sz(q) gather (diagonal columns)", mv_szq,
                   out, vecs=("complex",))
    rng = np.random.default_rng(24)
    pairs = Mopr()
    for i in range(L):
        for j in range(i + 1, L):
            J = 0.1 * complex(*rng.standard_normal(2))
            pairs += J * (Opr(i, 0, False, SP_HALF["Sp"])
                          * Opr(j, 0, False, SP_HALF["Sm"]))
            pairs += np.conj(J) * (Opr(i, 0, False, SP_HALF["Sm"])
                                   * Opr(j, 0, False, SP_HALF["Sp"]))
    mv_pairs = MatvecFull(m.compile_op(pairs), sec.dbasis)
    if mv_pairs.tables.nbytes <= apply.TABLES_SHARED_MAX:
        raise AssertionError("18 all-pairs: tables fit shared memory")
    k2_gather_case("chain24_Sz0 all-pairs complex (tables via __ldg)",
                   mv_pairs, out, vecs=("complex",), time_it="kernel")
    del mv_szq, mv_pairs
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(sec.dim),
                        device=dev)
    x /= torch.linalg.vector_norm(x)
    out["scatter_rows"] = k2_scatter_case(
        "chain24 <Sz0 Sz1>", m.compile_op(sz_pair(0, 1)), sec.dbasis,
        sec.dbasis, out, x, time_it=True)
    out["scatter_szq"] = k2_scatter_case(
        "chain24 Sz(q)", m.compile_op(szq), sec.dbasis, sec.dbasis, out, x,
        time_it=True)
    m.enumerate_basis_full([ops["Sz"]], [-1.0], sec=1)
    k2_scatter_case("chain24 S-(q) Sz=0 -> Sz=-1", m.compile_op(smq),
                    sec.dbasis, m.sec_full[1].dbasis, out, x)
    k2_sharded(dev, m, x, out)
    del m, sec, x
    torch.cuda.empty_cache()

    m, ops = kagome_heisenberg(2, 4, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    out["kagome24"] = k2_gather_case("kagome24_Sz0", m.sec_full[0].matvec,
                                     out, time_it=True)
    del m
    m, ops = fermi_hubbard_square(4, 3, device=dev)
    m.enumerate_basis_full([ops["Nup"], ops["Ndn"]], [6.0, 6.0])
    if m.sec_full[0].dim != 853776 or m.sec_full[0].dbasis.fodd is None:
        raise AssertionError("18 Hubbard 4x3 (6, 6): dim or fodd")
    k2_gather_case("hubbard4x3_6_6", m.sec_full[0].matvec, out)
    del m
    m, ops = dm_chain(24, 0.3, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    if not m.sec_full[0].matvec.is_complex:
        raise AssertionError("18 DM chain: H not complex")
    k2_gather_case("dm_chain24_Sz0", m.sec_full[0].matvec, out,
                   vecs=("complex",))
    del m
    # slot values staged from V: spin-1 (local dim 3, no bit fields)
    m, ops = heisenberg_chain(16, spin="1", device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    if m.sec_full[0].matvec.tables.bits:
        raise AssertionError("18 spin-1: bit fields where dim 3")
    out["spin1"] = k2_gather_case("spin1_chain16_Sz0 (staged V)",
                                  m.sec_full[0].matvec, out, time_it=True)
    del m
    torch.cuda.empty_cache()

    m, ops = heisenberg_chain(26, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    mv = sec.matvec
    if sec.dbasis.index.mode != "direct" or m._fullspace_op(sec) is not None:
        raise AssertionError("18 chain26: not direct, or not matrix-free")
    out["chain26"] = rec = k2_gather_case("chain26_Sz0", mv, out,
                                          time_it=True)
    n0 = mv.n_applies
    _, rec["solve_free_s"] = _timed(
        lambda: m.locate_E0_lanczos("full", maxit=4000))
    rec["matvecs_free"] = mv.n_applies - n0
    e0_free = m.eigenvals_full[0]
    v = m.eigenvecs_full[0]
    rec["residual_free"] = float(torch.linalg.vector_norm(mv(v) - e0_free * v))
    ell, rec["ell_build_s"] = _timed(
        lambda: m.generate_Ham_sparse_full(check="probe"))
    _, rec["solve_ell_s"] = _timed(
        lambda: m.locate_E0_lanczos("full", maxit=4000))
    e0 = rec["E0_ell"] = m.eigenvals_full[0]
    rec["E0_free"] = e0_free
    v = m.eigenvecs_full[0]
    rec["residual"] = float(torch.linalg.vector_norm(ell(v) - e0 * v))
    rec["ell_ms"] = cuda_ms(lambda: ell(v), samples=5, per_sample=2)
    gate = max(1e3 * 2e-12 * abs(e0), 5e-10)
    print("apply_rows", json.dumps(rec), flush=True)
    _check("18 chain26 E0, matrix-free vs ELL", e0_free, e0, 1e-10)
    for key in ("residual_free", "residual"):
        if not rec[key] < gate:
            raise AssertionError(f"18 chain26: {key} {rec[key]:.3e} over "
                                 f"the gate {gate:.3e}")
    del m, sec, mv, ell, v
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 19: the thick-restart Krylov step and compaction (K6)
# --------------------------------------------------------------------------

K6_KEEP = 3        # Ritz vectors a restart keeps at nev = 1


def k6_bound(nbytes, flops, dt):
    """(ms, "bytes" | "operations"): the larger of the bytes over the
    memory rate and the operations over the peak rate of dt's real type."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = flops / PEAK_FLOPS[torch.empty(0, dtype=dt).real.dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def _k6_basis(dt, rows, n, dev, seed):
    """rows random unit vectors of length n (orthonormal enough for the
    timings and the kernel-vs-plain checks, whose results do not depend on
    it)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    real = torch.empty(0, dtype=dt).real.dtype
    V = torch.empty((rows, n), dtype=dt, device=dev)
    Vr = torch.view_as_real(V) if dt.is_complex else V
    for i in range(rows):   # a row at a time: no second basis-sized temp
        Vr[i].normal_(generator=g)
        V[i] /= torch.linalg.vector_norm(V[i])
    return V


def _plain_step(V, r, w, dst, wp, h_out, beta_out):
    from quantum_basis_tpu_torch.ops import krylov

    krylov._project_plain(V, 0, r, w, wp.h1)
    krylov._subtract_project_plain(V, r, wp.h1, w, wp.work, wp.h2)
    krylov._subtract_norm_plain(V, r, wp.h2, wp.work, V[dst], wp.nrm)
    krylov._scale_plain(V[dst], wp.nrm, beta_out, True, (wp.h1, wp.h2),
                        h_out, r)


def _library_step(V, r, w, dst, h_out, beta_out):
    """The torch CGS2 step the kernels replaced (solvers/restarted.py up to
    PR 14: four cuBLAS GEMVs and the elementwise ops around them)."""
    Vj = V[:r]
    h1 = Vj.conj() @ w
    w = w - h1 @ Vj
    h2 = Vj.conj() @ w
    w = w - h2 @ Vj
    b = torch.linalg.vector_norm(w)
    inv = torch.where(b > 1e-13, 1.0 / torch.clamp(b, min=1e-13), 0.0)
    V[dst] = w * inv
    h_out.copy_(h1 + h2)
    beta_out.copy_(b)


def _k6_err(name, got, want, tol, errs, scale=None):
    """Kernel vs plain: max |got - want| <= tol * scale (default max|want|;
    an inner product of unit vectors takes 1, the scale of its rounding)."""
    diff = float((got - want).abs().max())
    if scale is None:
        scale = float(want.abs().max())
    errs[name] = max(errs.get(name, 0.0), diff)
    if not diff <= tol * max(scale, 1e-300):
        raise AssertionError(f"19 {name}: kernel vs plain {diff:.3e} "
                             f"(max {scale:.3e}, tol {tol})")


def k6_case(tag, dt, n, dev, rs, main_r, errs, ncv=12):
    """Phase 19 at one shape: a basis of ncv + 2 rows (so that r = ncv + 1
    has a row to write) of random unit vectors; for each r of ``rs`` one
    step (rows 0..r-1 read, row r written) by the kernels, the plain
    versions and the torch CGS2, checked against the plain versions and
    timed (CUDA events); at ``main_r`` each pass alone (events and the
    launch's torch.profiler device time); one compaction (m = ncv, keep
    K6_KEEP) likewise. Bounds from this run's shapes."""
    from quantum_basis_tpu_torch.ops import krylov

    tol = 1e-12 if torch.empty(0, dtype=dt).real.dtype == torch.float64 \
        else 1e-5
    rows = ncv + 2
    s = torch.empty(0, dtype=dt).element_size()
    cf = 8 if dt.is_complex else 2        # flops of one multiply-add
    V = _k6_basis(dt, rows, n, dev, 19)
    w = _k6_basis(dt, 1, n, dev, 20)[0]
    ws = krylov.Workspace(rows, n, dt, dev)
    wp = krylov.Workspace(rows, n, dt, dev)    # for the plain versions
    real = V.real.dtype
    H = torch.zeros((rows, rows), dtype=dt, device=dev)
    Hp = torch.zeros_like(H)
    b, bp = (torch.zeros(rows, dtype=real, device=dev) for _ in range(2))
    rec = {"case": tag, "dtype": str(dt)[6:], "n": n, "rows": rows,
           "steps": {}}

    for r in rs:
        # the step writes row r, which a later r reads: put it back after
        row_r = V[r].clone()

        def kern():
            krylov.cgs2(V, r, w, r, ws, H[:r, r - 1], b[r - 1: r])

        def plain():
            _plain_step(V, r, w, r, wp, Hp[:r, r - 1], bp[r - 1: r])

        def library():
            _library_step(V, r, w, r, Hp[:r, r - 1], bp[r - 1: r])

        kern()
        got = V[r].clone()
        plain()
        _k6_err("step", got, V[r], tol, errs)
        _k6_err("step h", H[:r, r - 1], Hp[:r, r - 1], tol, errs, 1.0)
        _k6_err("step beta", b[r - 1], bp[r - 1], tol, errs)
        del got
        bound, by = k6_bound((3 * r + 7) * n * s, 4 * cf * r * n + 3 * n,
                             dt)
        st = {"ms": cuda_ms(kern, samples=5, per_sample=2),
              "plain_ms": cuda_ms(plain, samples=3, per_sample=1),
              "library_ms": cuda_ms(library, samples=3, per_sample=1),
              "bound_ms": bound, "bound_by": by}
        dev_ms = kernel_device_ms(kern, krylov.KERNELS[:4], reps=3)
        st["device_ms"] = (None if None in dev_ms.values()
                           else sum(dev_ms.values()))
        rec["steps"][str(r)] = st
        print(f"19 {tag} step r={r}: {json.dumps(st)}", flush=True)
        V[r] = row_r
        del row_r

    # each pass alone at main_r, from the same inputs for the kernel and
    # its plain version (w has norm 1, the rows too)
    r = main_r
    Vc = V.clone()                  # the compactions' input, kept apart
    krylov.krylov_project(V, 0, r, w, ws.h1)
    krylov._project_plain(V, 0, r, w, wp.h1)
    _k6_err("krylov_project", ws.h1[:r].sum(1), wp.h1[:r].sum(1), tol,
            errs, 1.0)
    krylov.krylov_subtract_project(V, r, ws.h1, w, ws.work, ws.h2)
    krylov._subtract_project_plain(V, r, ws.h1, w, wp.work, wp.h2)
    _k6_err("krylov_subtract_project", ws.work, wp.work, tol, errs)
    _k6_err("krylov_subtract_project", ws.h2[:r].sum(1), wp.h2[:r].sum(1),
            tol, errs, 1.0)
    krylov.krylov_subtract_norm(V, r, ws.h2, ws.work, V[r], ws.nrm)
    w2 = V[r].clone()
    krylov._subtract_norm_plain(V, r, ws.h2, ws.work, V[r], wp.nrm)
    _k6_err("krylov_subtract_norm", w2, V[r], tol, errs)
    _k6_err("krylov_subtract_norm", ws.nrm.sum(), wp.nrm.sum(), tol, errs)
    V[r] = w2
    krylov.krylov_scale(V[r], ws.nrm, ws.beta, True)
    got = V[r].clone()
    V[r] = w2
    krylov._scale_plain(V[r], ws.nrm, wp.beta, True, None, None, r)
    _k6_err("krylov_scale", got, V[r], tol, errs)
    _k6_err("krylov_scale", ws.beta, wp.beta, tol, errs)
    del got, w2
    passes = {
        "krylov_project": (
            lambda: krylov.krylov_project(V, 0, r, w, ws.h1),
            lambda: krylov._project_plain(V, 0, r, w, wp.h1),
            lambda: V[:r].conj() @ w,
            (r + 1) * n * s, cf * r * n),
        "krylov_subtract_project": (
            lambda: krylov.krylov_subtract_project(V, r, ws.h1, w, ws.work,
                                                   ws.h2),
            lambda: krylov._subtract_project_plain(V, r, wp.h1, w, wp.work,
                                                   wp.h2),
            None, (r + 2) * n * s, 2 * cf * r * n + n),
        "krylov_subtract_norm": (
            lambda: krylov.krylov_subtract_norm(V, r, ws.h2, ws.work, V[r],
                                                ws.nrm),
            lambda: krylov._subtract_norm_plain(V, r, wp.h2, wp.work, V[r],
                                                wp.nrm),
            None, (r + 2) * n * s, cf * r * n + 3 * n),
        "krylov_scale": (
            lambda: krylov.krylov_scale(V[r], ws.nrm, ws.beta, True),
            lambda: krylov._scale_plain(V[r], wp.nrm, wp.beta, True, None,
                                        None, r),
            None, 2 * n * s, n),
    }
    rec["passes"] = {}
    for name, (kern, plain, lib, nbytes, flops) in passes.items():
        bound, by = k6_bound(nbytes, flops, dt)
        p = {"ms": cuda_ms(kern, samples=5, per_sample=3),
             "device_ms": kernel_device_ms(kern, (name,), reps=3)[name],
             "plain_ms": cuda_ms(plain, samples=3, per_sample=1),
             "library_ms": (cuda_ms(lib, samples=3, per_sample=1)
                            if lib is not None else None),
             "bound_ms": bound, "bound_by": by, "r": r}
        rec["passes"][name] = p
        print(f"19 {tag} {name} r={r}: {json.dumps(p)}", flush=True)

    # krylov_project alone at each r of the steps, beside one GEMV
    rec["project_by_r"] = {}
    for rr in rs:
        krylov.krylov_project(V, 0, rr, w, ws.h1)
        krylov._project_plain(V, 0, rr, w, wp.h1)
        _k6_err("krylov_project", ws.h1[:rr].sum(1), wp.h1[:rr].sum(1), tol,
                errs, 1.0)
        bound, by = k6_bound((rr + 1) * n * s, cf * rr * n, dt)
        rec["project_by_r"][str(rr)] = p = {
            "ms": cuda_ms(lambda: krylov.krylov_project(V, 0, rr, w, ws.h1),
                          samples=5, per_sample=3),
            "library_ms": cuda_ms(lambda: V[:rr].conj() @ w, samples=5,
                                  per_sample=3),
            "bound_ms": bound, "bound_by": by}
        print(f"19 {tag} krylov_project r={rr}: {json.dumps(p)}", flush=True)

    # the compaction of a basis of m + 1 rows (a restart at ncv = m) to
    # K6_KEEP, at m = ncv (the main path's) and at the steps' r, on copies
    # of the basis (the timed passes above left row r scaled many times
    # over), each checked and timed beside the GEMM S^T V alone
    del V
    rec["compact_by_m"] = {}
    for m in sorted({ncv, *rs}):
        q, _ = np.linalg.qr(np.random.default_rng(29 + m).standard_normal(
            (m, K6_KEEP)))
        S = torch.as_tensor(q, device=dev).to(dt).contiguous()
        Vk, Vp = Vc[: m + 1].clone(), Vc[: m + 1].clone()
        krylov.krylov_compact(Vk, S, m)
        krylov._compact_plain(Vp, S, m)
        _k6_err("krylov_compact", Vk, Vp, tol, errs)
        if Vk[K6_KEEP + 1:].any():
            raise AssertionError("19 compact: rows past keep + 1 not zero")
        del Vp
        bound, by = k6_bound(2 * (m + 1) * n * s, cf * K6_KEEP * m * n, dt)
        Sw = S.T.contiguous()

        def compact_kern():
            krylov.krylov_compact(Vk, S, m)

        p = {"ms": cuda_ms(compact_kern, samples=5, per_sample=2),
             # one GEMM, S^T V, the compaction's product alone
             "library_ms": cuda_ms(lambda: Sw @ Vk[:m], samples=3,
                                   per_sample=1),
             "bound_ms": bound, "bound_by": by, "m": m, "keep": K6_KEEP}
        if m == ncv:
            p["device_ms"] = kernel_device_ms(
                compact_kern, ("krylov_compact",), reps=3)["krylov_compact"]
            p["plain_ms"] = cuda_ms(lambda: krylov._compact_plain(Vk, S, m),
                                    samples=3, per_sample=1)
            # a copy_ of the bytes the compaction must move ((m + 1) rows
            # read, as many written): what a plain stream reaches here
            Vd = torch.empty_like(Vk)
            p["copy_ms"] = cuda_ms(lambda: Vd.copy_(Vk), samples=3,
                                   per_sample=2)
            del Vd
            rec["passes"]["krylov_compact"] = p
        rec["compact_by_m"][str(m)] = p
        print(f"19 {tag} krylov_compact m={m}: {json.dumps(p)}", flush=True)
        del Vk, S, Sw
    del Vc, w, ws, wp
    torch.cuda.empty_cache()
    return rec


def k6_wide_compact(dev, errs, rows=120):
    """Phase 19: the compaction of rows = 120 (past the 113 the first
    kernel staged) on chain-24's dim in float64 and complex128 (2.6 / 5.2 GB
    of basis), to keep 3 (the main path's form), m // 2 = 59 (one chunk of
    sums, 16 threads a column) and 99 (two chunks, the first kept in the
    stash), against the plain version on the card (1e-12), the rows past
    keep + 1 zero; timed beside the GEMM."""
    from quantum_basis_tpu_torch.ops import krylov

    out = {}
    m = rows - 1
    for dt in (torch.float64, torch.complex128):
        s = torch.empty(0, dtype=dt).element_size()
        cf = 8 if dt.is_complex else 2
        V = _k6_basis(dt, rows, DIM_24, dev, 31)
        for keep in (K6_KEEP, m // 2, 99):
            rng = np.random.default_rng(37 + keep)
            q = rng.standard_normal((m, keep))
            if dt.is_complex:
                q = q + 1j * rng.standard_normal((m, keep))
            q, _ = np.linalg.qr(q)
            S = torch.as_tensor(q, device=dev).to(dt).contiguous()
            Vk, Vp = V.clone(), V.clone()
            krylov.krylov_compact(Vk, S, m)
            krylov._compact_plain(Vp, S, m)
            _k6_err("krylov_compact", Vk, Vp, 1e-12, errs)
            if Vk[keep + 1:].any():
                raise AssertionError("19 wide compact: rows past keep + 1 "
                                     "not zero")
            del Vp
            bound, by = k6_bound(2 * rows * DIM_24 * s,
                                 cf * keep * m * DIM_24, dt)
            Sw = S.T.contiguous()
            p = {"ms": cuda_ms(lambda: krylov.krylov_compact(Vk, S, m),
                               samples=3, per_sample=1),
                 "library_ms": cuda_ms(lambda: Sw @ Vk[:m], samples=3,
                                       per_sample=1),
                 "bound_ms": bound, "bound_by": by}
            out[f"{str(dt)[6:]}_keep{keep}"] = p
            print(f"19 chain24 {str(dt)[6:]} krylov_compact rows={rows} "
                  f"keep={keep}: {json.dumps(p)}", flush=True)
            del Vk, S, Sw
        del V
        torch.cuda.empty_cache()
    return out


def k6_orthogonality(tag, op, n, complex_vec, tol, ncv=12):
    """One full expand (ncv steps from a random start) on ``op`` through
    the kernels, then ||V^H V - I|| of its ncv + 1 rows (the Gram matrix in
    float64 over column blocks)."""
    from quantum_basis_tpu_torch.solvers import restarted

    kry = restarted._Krylov(op, n, ncv, complex_vec)
    x = restarted._random_start(op, n, 1, complex_vec, kry.V.device)
    kry.V[0] = restarted._projected(op, x, getattr(op, "mask", None)).to(
        kry.dtype)
    del x
    _, bs = kry.expand(0, ncv)
    G = torch.zeros((ncv + 1, ncv + 1), dtype=torch.complex128
                    if complex_vec else torch.float64, device=kry.V.device)
    for c0 in range(0, n, 1 << 24):
        blk = kry.V[:, c0: c0 + (1 << 24)].to(G.dtype)
        G += blk.conj() @ blk.T
    err = float((G - torch.eye(ncv + 1, dtype=G.dtype,
                               device=G.device)).abs().max())
    print(f"check 19 {tag}: ||V^H V - I|| after {ncv} steps {err:.3e} "
          f"(tol {tol}; betas {bs[:ncv].min():.3e}..{bs[:ncv].max():.3e})",
          flush=True)
    if not err <= tol:
        raise AssertionError(f"19 {tag}: basis not orthonormal, {err:.3e}")
    del kry, G
    torch.cuda.empty_cache()
    return err


def krylov_run(dev):
    """Phase 19: the K6 kernels (csrc/krylov.cu) against their plain
    versions on the card at the main path's two shapes, the Hubbard 4x4 f32
    basis (n = 165,636,900, ncv 12: 662.5 MB a vector) and chain-24 Sz=0 in
    f64 (n = 2,704,156): a step at r = 4, 8 and 13 (kernels, plain
    versions, the torch CGS2 they replaced, bound), each pass alone at r =
    8, krylov_project at each r beside a GEMV and the compaction at m = 4,
    8, 12, 13 beside a GEMM; the compaction of 120 rows on chain-24's dim;
    then ||V^H V - I|| after one full expand on each sector's operator (f32
    1e-5, f64 1e-12). Returns the record."""
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized)
    from torch_zoo import heisenberg_chain

    t19 = time.perf_counter()
    errs = {}
    out = {"card": card_line()}
    out["hubbard4x4"] = k6_case("hubbard4x4 f32", torch.float32,
                                HUBBARD4X4_DIMS[1], dev, (4, 8, 13), 8, errs)
    out["chain24"] = k6_case("chain24 f64", torch.float64, DIM_24, dev,
                             (4, 8, 13), 8, errs)
    out["chain24"]["compact_wide"] = k6_wide_compact(dev, errs)
    pm, _ = build_factorized(4, 4, device=dev)
    op = pm.op(torch.float32)
    out["hubbard4x4"]["orthogonality"] = k6_orthogonality(
        "hubbard4x4 f32 KronOp", op, op.N, False, 1e-5)
    del pm, op
    torch.cuda.empty_cache()
    m, ops = heisenberg_chain(24, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    mv = m.sec_full[0].matvec
    out["chain24"]["orthogonality"] = k6_orthogonality(
        "chain24 f64 MatvecFull", mv, mv.n, False, 1e-12)
    del m, mv
    torch.cuda.empty_cache()
    out["max_abs_err"] = errs
    out["s"] = time.perf_counter() - t19
    print("krylov", json.dumps(out), flush=True)
    print(f"phase 19: {out['s']:.1f} s", flush=True)
    return out


def k6_launches(tag, steps):
    """The K6 launches of a solve of ``steps`` Krylov steps (set to 0 just
    before it): the four step kernels once a step (r <= 16 at ncv 12; the
    solve made no restart vector), the compaction at least once."""
    from quantum_basis_tpu_torch.ops import krylov

    got = dict(krylov.launches)
    print(f"check {tag} K6 launches {got} for {steps} steps", flush=True)
    step_kernels = [got[k] for k in krylov.KERNELS[:4]]
    if step_kernels != [steps] * 4 or not 0 < got["krylov_compact"] <= steps:
        raise AssertionError(f"{tag}: K6 launches {got} for {steps} Krylov "
                             "steps")
    return got


def _spy(module, name, seen, tag):
    """Wrap module.name so that each call appends ``tag(*args, **kw)`` to
    ``seen``; returns the original for the caller to put back."""
    real = getattr(module, name)

    def spy(*a, **kw):
        seen.append(tag(*a, **kw))
        return real(*a, **kw)
    setattr(module, name, staticmethod(spy) if isinstance(
        module.__dict__.get(name), staticmethod) else spy)
    return real


# --------------------------------------------------------------------------
# Phase 20: the momentum-sector row apply (K9)
# --------------------------------------------------------------------------

# (name, model, the value of its conserved quantity, two momenta):
# kagome-24 and chain-24 Sz=0, the honeycomb spinless fermions 4x3 at half
# filling (2^24 labels, G = 12)
K9_MODELS = (("kagome24", "kagome", 0.0, ((0, 0), (0, 2))),
             ("chain24", "chain", 0.0, ((0,), (5,))),
             ("honeycomb4x3", "honeycomb", 12.0, ((0, 0), (1, 0))))


def _k9_model(kind, dev):
    from torch_zoo import (heisenberg_chain, kagome_heisenberg,
                           spinless_fermion_honeycomb)

    if kind == "kagome":
        m, ops = kagome_heisenberg(2, 4, device=dev)
        return m, ops["Sz"]
    if kind == "chain":
        m, ops = heisenberg_chain(24, device=dev)
        return m, ops["Sz"]
    m, ops = spinless_fermion_honeycomb(4, 3, device=dev)
    return m, ops["N"]


def _k9_wave(m, kind, q):
    """The diagonal wave sum_x e^{-i q.x} O_x / sqrt(N) (O = Sz, or the
    density of the spinless fermions): every column diagonal."""
    from quantum_basis_tpu_torch import Mopr, Opr
    from torch_zoo import SP_HALF

    lat = m.lattice
    d = SP_HALF["Sz"] if kind != "honeycomb" else np.array([0.0, 1.0])
    A = Mopr()
    for s in range(lat.n_sites):
        ph = np.exp(-2j * np.pi * float(lat.k_dot_R(
            list(q), lat.site2coor(s)[0])[0])) / np.sqrt(lat.n_sites)
        A += complex(ph) * Opr(s, 0, False, d)
    return A


def k9_coo(args, n_src, scatter, block=1 << 15):
    """(rows, cols, vals, looked) of the operator a repr kernel applies,
    from its plain routine block by block: H (gather; diagonal included) or
    A (scatter, the destination's rows); ``looked`` marks the entries whose
    row or column came from an index lookup."""
    from quantum_basis_tpu_torch.basis.index import lookup_tables
    from quantum_basis_tpu_torch.ops.apply_repr import _translate_plain

    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = args
    ph = torch.complex(phase[:, 0], phase[:, 1])
    R, C, V, L = [], [], [], []

    def put(r, c, v, looked):
        R.append(r)
        C.append(c)
        V.append(v)
        L.append(torch.full(r.shape, looked, device=r.device))
    for i0 in range(0, n_src, block):
        i1 = min(i0 + block, n_src)
        rows = torch.arange(i0, i1, device=labels.device)
        own = torch.zeros(i1 - i0, dtype=torch.complex128,
                          device=labels.device)
        if diag is not None:
            own = own + diag[i0:i1]
        if tabs.n_cols:
            out = _translate_plain(rt, tabs, ix, labels, fodd, i0, i1,
                                   translate=not tabs.diag_only)
            own = own + torch.where(out[1], out[0], 0).sum(1)
            if not tabs.diag_only:
                amp, _, valid, j, sig, gs = out
                ii = rows[:, None].expand_as(j)
                if scatter:
                    c = sqrt_nu[j] * sig * amp * ph[gs] * isn[ii]
                    put(j[valid], ii[valid], c[valid], True)
                else:
                    c = sqrt_nu[j] * isn[ii] * sig * amp.conj() * ph[gs]
                    put(ii[valid], j[valid], c[valid], True)
        if scatter:
            j0 = lookup_tables(ix, labels[i0:i1])
            ok = (ix.labels[j0] == labels[i0:i1]) & (own != 0)
            put(j0[ok], rows[ok], (sqrt_nu[j0] * own * isn[i0:i1])[ok], True)
        else:
            put(rows, rows, own.conj(), False)
    return torch.cat(R), torch.cat(C), torch.cat(V), torch.cat(L)


def k9_bound(args, n_src, n_dst, kind):
    """Least time of one repr_rows or repr_scatter call on this card in ms,
    and which bound it is. Bytes: each source row's label, 1/sqrt(nu), Fodd
    (where fermionic), diagonal (where there is one) and x read once; y
    written once (16 bytes a destination row); the tables;
    and the 32-byte sectors that this run's looked-up images touch in the
    destination's direct position table, its labels (the check) and
    sqrt(nu); over the memory rate. Operations: 8 a kept image (the
    complex multiply-add and its coefficient), 8 a row, over the float64
    peak (the translation's integer work not counted)."""
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = args
    if ix.mode != "direct":
        raise ValueError("the bound counts the direct index's sectors")
    dev = labels.device
    per = 32 // ix.t0.element_size()
    pos = torch.zeros(-(-ix.label_space // per), dtype=torch.bool,
                      device=dev)
    lab = torch.zeros(-(-ix.n // 4), dtype=torch.bool, device=dev)
    rows, cols, _, looked = k9_coo(args, n_src, kind == "repr_scatter")
    tgt = (rows if kind == "repr_scatter" else cols)[looked]
    pos[ix.labels[tgt] // per] = True
    lab[tgt // 4] = True
    per_row = 32 + (8 if fodd is not None else 0) \
        + (8 if diag is not None else 0)
    nbytes = (per_row * n_src + 16 * n_dst + tabs.nbytes + rt.nbytes
              + 32 * int(pos.sum()) + 2 * 32 * int(lab.sum()))
    flops = 8 * tgt.numel() + 8 * n_src
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float64] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k9_library(args, n_src, n_dst, x, scatter):
    """(ms, y) of one torch.sparse CSR complex128 product of the same
    operator on the same vector (timed only: nothing in the package calls
    it), or (None, None) where this PyTorch has no such product."""
    rows, cols, vals, _ = k9_coo(args, n_src, scatter)
    try:
        M = _csr(rows, cols, vals, (n_dst, n_src))
        y = M @ x[:n_src]
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        print(f"library call: {str(e).splitlines()[0]}", flush=True)
        return None, None
    return cuda_ms(lambda: M @ x[:n_src], samples=5, per_sample=2), y


def k9_check(tag, got, want, out, name, spread=0.0):
    """Kernel against plain version: 1e-12 of max|y|, or the atomics'
    measured spread where wider (stated); the worst absolute error kept in
    out["max_abs_err"][name]."""
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    out["max_abs_err"][name] = max(out["max_abs_err"][name], err)
    scale = float(want.abs().max())
    tol = max(1e-12 * scale, 4.0 * spread)
    print(f"check 20 {tag}: {err:.3e} (max|y| {scale:.3e}, tol "
          f"{tol:.3e} = max(1e-12 max|y|, 4 x the spread of two kernel "
          f"runs {spread:.3e}))", flush=True)
    if not err <= tol:
        raise AssertionError(f"20 {tag}: kernel vs plain {err:.3e} > {tol:.3e}")


def k9_host_split(mv, x):
    """Host ms of one MatvecRepr call and of its parts (each the mean of
    200 calls that only enqueue): the whole call, the launch record's call,
    x's checks, y's allocation, the stream handle, the C launch alone (the
    struct's x and y written, then qbt_repr_rows)."""
    from quantum_basis_tpu_torch.ops import apply_repr as ar

    rec = mv.record()
    y = torch.empty_like(x)
    rec.p.x, rec.p.y = x.data_ptr(), y.data_ptr()
    rec._launch()
    dev = x.device.index
    return {
        "matvec_call": host_ms(lambda: mv(x)),
        "record_call": host_ms(lambda: rec(x)),
        "check_x": host_ms(lambda: ar._check_x(x, rec.device, rec.rows)),
        "alloc_y": host_ms(lambda: torch.empty(
            rec.n_out, dtype=torch.complex128, device=rec.device)),
        "stream": host_ms(lambda: torch._C._cuda_getCurrentRawStream(dev)),
        "launch_c": host_ms(lambda: rec._fn(
            rec._pp, torch._C._cuda_getCurrentRawStream(dev)))}


def k9_sector(tag, m, sec, out, time_it, dev):
    """repr_rows, repr_images and repr_scatter (H from the sector into
    itself) of one momentum sector against their plain versions; with
    ``time_it`` the record's times, bounds and library calls."""
    from quantum_basis_tpu_torch.ops import apply_repr as ar
    from quantum_basis_tpu_torch.ops.apply_repr import (
        ReprLaunch, _repr_ell_plain, _repr_rows_plain, _repr_scatter_plain,
        phase_table)
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    s = m.sec_repr[sec]
    mv = s.matvec
    rb = s.dbasis
    n = mv.n
    args = mv.args()
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, phase = args
    rec = {"case": tag, "dim": n, "G": rt.G, "index_mode": ix.mode,
           "image_columns": tabs.n_cols, "bits": rt.bits,
           "fermionic": rt.qmask is not None,
           "tables_bytes": tabs.nbytes + rt.nbytes,
           "path": "entry" if mv.record().entry is not None else "general",
           "G_bucket": mv.record().p.gb}
    g = torch.Generator(device=dev).manual_seed(20)
    x = torch.randn(n, dtype=torch.complex128, device=dev, generator=g)
    before = ar.launches["repr_rows"]
    y = mv(x)
    if ar.launches["repr_rows"] != before + 1:
        raise AssertionError(f"20 {tag}: MatvecRepr made no one launch")
    yp = _repr_rows_plain(*args, x)
    k9_check(f"{tag} repr_rows", y, yp, out, "repr_rows")
    # the general path (int64, per slot) on the same sector
    emax, ar.ENTRY_TABLES_MAX = ar.ENTRY_TABLES_MAX, 0
    try:
        gen = ReprLaunch("repr_rows", *args, n)
    finally:
        ar.ENTRY_TABLES_MAX = emax
    if gen.entry is not None:
        raise AssertionError(f"20 {tag}: the general path was not taken")
    k9_check(f"{tag} repr_rows (general path)", gen(x), yp, out,
             "repr_rows")
    # the ELL build's finished rows, against the plain build
    ell_check(f"20 {tag} repr_images", mv.record("repr_images").images(0, n),
              _repr_ell_plain(*args[:7], phase, 0, n, rb.block_rows), out,
              "repr_images")
    # H scattered from the sector into itself: the atomics' path
    ph = phase_table(rb.tset, rb.momentum, +1)
    sargs = (rt, tabs, ix, labels, fodd, isn, sqrt_nu, diag, ph)
    srec = ReprLaunch("repr_scatter", *sargs, n, rrec=rb.row_records())
    z = srec(x)
    z2 = srec(x)
    torch.cuda.synchronize()
    spread = float((z - z2).abs().max())
    rec["scatter_spread"] = spread
    zp = _repr_scatter_plain(*sargs, x, n)
    k9_check(f"{tag} repr_scatter (H, atomics)", z, zp, out, "repr_scatter",
             spread)
    if time_it:
        rec["ms"] = cuda_ms(lambda: mv(x), samples=9, per_sample=3)
        rec["device_ms"] = kernel_device_ms(
            lambda: mv(x), ("repr_rows_kernel",))["repr_rows_kernel"]
        rec["host_ms"] = host_ms(lambda: mv(x))
        rec["host_split_ms"] = k9_host_split(mv, x)
        # the launch's two kernels: the walk and its pre-pass
        rec["passes_device_ms"] = kernel_device_ms(
            lambda: mv(x), ("repr_rows_kernel<", "repr_rows_kernel_pack"))
        rec["general_ms"] = cuda_ms(lambda: gen(x), samples=9, per_sample=3)
        rec["general_device_ms"] = kernel_device_ms(
            lambda: gen(x), ("repr_rows_kernel",))["repr_rows_kernel"]
        rec["plain_ms"] = cuda_ms(lambda: _repr_rows_plain(*args, x),
                                  samples=3, per_sample=1)
        rec["bound_ms"], rec["bound_by"] = k9_bound(args, n, n, "repr_rows")
        rec["library_ms"], yl = k9_library(args, n, n, x, False)
        if yl is not None:
            _hx_check(f"20 {tag}: library CSR product vs kernel", yl, y,
                      1e-12)
        del yl
        ell, rec["ell_build_s"] = _timed(lambda: build_sparse_repr(mv))
        _hx_check(f"20 {tag}: ELL from repr_images vs repr_rows", ell(x), y,
                  1e-12)
        rec["ell_ms"] = cuda_ms(lambda: ell(x), samples=9, per_sample=3)
        rec["ell_width"] = ell.width
        del ell
        sc = {"operator": "H, k -> k (atomics)"}
        sc["ms"] = cuda_ms(lambda: srec(x), samples=9, per_sample=3)
        sc["device_ms"] = kernel_device_ms(
            lambda: srec(x), ("repr_scatter_kernel",))["repr_scatter_kernel"]
        sc["host_ms"] = host_ms(lambda: srec(x))
        sc["plain_ms"] = cuda_ms(lambda: _repr_scatter_plain(*sargs, x, n),
                                 samples=3, per_sample=1)
        sc["bound_ms"], sc["bound_by"] = k9_bound(sargs, n, n,
                                                  "repr_scatter")
        sc["library_ms"], _ = k9_library(sargs, n, n, x, True)
        rec["scatter_h"] = sc
    rec["label_buffer_bytes"] = ar.LabelBuffer.held_bytes()
    print("apply_repr", json.dumps(rec), flush=True)
    del x, y, yp, z, z2, zp, gen, srec
    return rec


def k9_wave_scatter(tag, m, kind, out, time_it, dev):
    """repr_scatter of the diagonal wave from sector 0 into sector 1 (q =
    k0 - k1; every column diagonal: the S(q, omega) injection's path, no
    translation, plain stores) through mopr_x_vec_repr, against its plain
    version."""
    from quantum_basis_tpu_torch.ops import apply_repr as ar
    from quantum_basis_tpu_torch.ops.apply_repr import (
        _repr_scatter_plain, mopr_x_vec_repr, scatter_args, scatter_launch)

    src, dst = m.sec_repr[0].dbasis, m.sec_repr[1].dbasis
    q = [a - b for a, b in zip(src.momentum, dst.momentum)]
    op = m.compile_op(_k9_wave(m, kind, q))
    args = scatter_args(op, src, dst)
    if not args[1].diag_only:
        raise AssertionError(f"20 {tag}: the wave has off-diagonal columns")
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(src.n, dtype=torch.complex128, device=dev, generator=g)
    before = ar.launches["repr_scatter"]
    y = mopr_x_vec_repr(op, src, dst, x)
    if ar.launches["repr_scatter"] != before + 1:
        raise AssertionError(f"20 {tag}: mopr_x_vec_repr made no one launch")
    yp = _repr_scatter_plain(*args, x, src.n)
    k9_check(f"{tag} repr_scatter (wave q={q}, stores)", y, yp, out,
             "repr_scatter")
    srec = scatter_launch(op, src, dst)
    k9_check(f"{tag} repr_scatter (wave q={q}, launch record)", srec(x), yp,
             out, "repr_scatter")
    rec = {"case": tag, "q": q, "src_dim": src.n, "dst_dim": dst.n,
           "path": "entry" if srec.entry is not None else "general"}
    if time_it:
        rec["ms"] = cuda_ms(lambda: srec(x), samples=9, per_sample=3)
        rec["device_ms"] = kernel_device_ms(
            lambda: srec(x), ("repr_scatter_kernel",))["repr_scatter_kernel"]
        rec["host_ms"] = host_ms(lambda: srec(x))
        rec["mopr_x_vec_repr_ms"] = cuda_ms(
            lambda: mopr_x_vec_repr(op, src, dst, x), samples=5,
            per_sample=2)
        rec["plain_ms"] = cuda_ms(
            lambda: _repr_scatter_plain(*args, x, src.n), samples=3,
            per_sample=1)
        rec["bound_ms"], rec["bound_by"] = k9_bound(args, src.n, dst.n,
                                                    "repr_scatter")
        rec["library_ms"], yl = k9_library(args, src.n, dst.n, x, True)
        if yl is not None:
            _hx_check(f"20 {tag}: library CSR product vs kernel", yl, y,
                      1e-12)
    print("apply_repr", json.dumps(rec), flush=True)
    return rec


def apply_repr_run(dev):
    """Phase 20: the momentum-sector kernels (csrc/apply_repr.cu, K9)
    against their plain versions on the card: on kagome-24 Sz=0 at k =
    (0,0) and (0,2), chain-24 Sz=0 at k = 0 and 5 (complex), and the
    honeycomb spinless fermions 4x3 at half filling at k = (0,0) and (1,0)
    (2^24 labels, G = 12, signs), repr_rows (MatvecRepr), repr_images (the
    ELL build's blocks; columns exactly) and repr_scatter of H from each
    sector into itself (f64 atomics) to 1e-12 of max|y| (or the measured
    spread of two kernel runs, where wider); repr_scatter of the diagonal
    wave Sz(q) (density, for the fermions) from one sector into the other
    through mopr_x_vec_repr (no translation, plain stores). Times, on
    kagome-24 k=(0,2) (the explicit route's sector of phase 8) and
    chain-24 k=0, each kernel (CUDA events and torch.profiler) beside its
    plain version, its bound and one torch.sparse CSR complex128 product of
    the same matrix, with the sector's ELL apply beside it. Returns the
    kernel record's numbers."""
    t20 = time.perf_counter()
    from quantum_basis_tpu_torch.ops import apply_repr as ar

    out = {"max_abs_err": dict.fromkeys(ar.KERNELS, 0.0)}
    for name, kind, val, ks in K9_MODELS:
        m, op = _k9_model(kind, dev)
        for sec, k in enumerate(ks):
            m.enumerate_basis_repr(list(k), [op], [val], sec=sec)
        for sec, k in enumerate(ks):
            tag = f"{name}_k{''.join(map(str, k))}"
            time_it = tag in ("kagome24_k02", "chain24_k0")
            out[tag] = k9_sector(tag, m, sec, out, time_it, dev)
        out[f"{name}_wave"] = k9_wave_scatter(
            f"{name} wave", m, kind, out, name == "kagome24", dev)
        del m
        torch.cuda.empty_cache()
    print(f"phase 20: {time.perf_counter() - t20:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 21: the explicit ELL builds (repr_images, ell_rows)
# --------------------------------------------------------------------------

# (tag, model, the value of its conserved quantity, momentum): the momentum
# sectors of phase 21 (K9's models), then its full sectors
ELL_REPR = (("kagome24_k02", "kagome", 0.0, (0, 2)),
            ("chain24_k0", "chain", 0.0, (0,)),
            ("honeycomb4x3_k00", "honeycomb", 12.0, (0, 0)))
ELL_FULL = ("chain24_Sz0", "kagome24_Sz0", "chain26_Sz0", "tJ12_N8_Sz0")


def ell_check(tag, got, want, out, name):
    """A kernel build's (cols, vals) against its plain version's: columns
    and W exactly, values to 1e-14 of max|v|; the worst absolute error kept
    in out["max_abs_err"][name]."""
    (c, v), (c2, v2) = got, want
    torch.cuda.synchronize()
    if c.shape != c2.shape or not torch.equal(c, c2):
        raise AssertionError(f"{tag}: columns differ (W {c.shape[1]} vs "
                             f"{c2.shape[1]})")
    err = float((v - v2).abs().max()) if v.numel() else 0.0
    scale = float(v2.abs().max()) if v.numel() else 0.0
    out["max_abs_err"][name] = max(out["max_abs_err"][name], err)
    print(f"check {tag}: W {c.shape[1]}, columns equal, values {err:.3e} "
          f"(max|v| {scale:.3e}, tol 1e-14 max|v|)", flush=True)
    if not err <= 1e-14 * scale:
        raise AssertionError(f"{tag}: values differ by {err:.3e}")


def ell_bound(ell, ix, per_row, tables, records):
    """Least time of one ELL build on this card in ms, and which bound it
    is. Bytes: each row's label (and Fodd, 1/sqrt(nu) where the kernel
    reads them: ``per_row`` bytes a row) and the tables read once; the
    32-byte sectors of the direct position table at the labels of the
    finished entries' columns (the lookups that this run's data needs,
    merged ones once); with ``records`` (the momentum build) the sectors
    of the destination's 16-byte (label, sqrt(nu)) records there; the
    finished (n, W) columns and values written once (and, without
    ``records``, the full build's int32 row lengths); over 3.35 TB/s.
    Operations: one add an entry, over the float64 peak."""
    if ix.mode != "direct":
        raise ValueError("the bound counts the direct index's sectors")
    j = ell.cols[ell.vals != 0]
    per = 32 // ix.t0.element_size()
    pos = torch.zeros(-(-ix.label_space // per), dtype=torch.bool,
                      device=j.device)
    pos[ix.labels[j] // per] = True
    nbytes = (per_row * ell.n + tables + 32 * int(pos.sum())
              + ell.cols.numel() * ell.cols.element_size()
              + ell.vals.numel() * ell.vals.element_size())
    if records:
        rec = torch.zeros(-(-ix.n // 2), dtype=torch.bool, device=j.device)
        rec[j // 2] = True
        nbytes += 32 * int(rec.sum())
    else:
        nbytes += 4 * ell.n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = j.numel() / PEAK_FLOPS[torch.float64] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _peak_timed(fn):
    """(result, seconds, peak bytes above what was held before) of fn()."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out, t = _timed(fn)
    return out, t, torch.cuda.max_memory_allocated() - base


def ell_case(tag, kind, n, E, kernel, plain, mv, x, counter, tag_kernel,
             bound, out, name):
    """One sector's two builds, in turns plain, kernel, kernel, plain: the
    whole build's seconds and peak bytes each, the kernel's against the
    plain version's (ell_check), the ELL's H x against the matrix-free
    engine's (1e-12 of max|y|), the kernel's launches a build, its CUDA
    events ms and device ms a build (both passes), its bound."""
    from quantum_basis_tpu_torch.ops.sparse import EllMatrix

    rec = {"case": tag, "kind": kind, "dim": n, "image_columns": E,
           "card": card_line()}
    (pc, pv), t_p1, rec["plain_peak_bytes"] = _peak_timed(plain)
    before = counter()
    ell, t_k1, rec["kernel_peak_bytes"] = _peak_timed(kernel)
    rec["launches_per_build"] = counter() - before
    if rec["launches_per_build"] != (2 if ell.width else 1):
        raise AssertionError(f"21 {tag}: {rec['launches_per_build']} "
                             f"launches for one build")
    ell_check(f"21 {tag}", (ell.cols, ell.vals), (pc, pv), out, name)
    rec["W"] = ell.width
    del pc, pv
    y = mv(x)
    _hx_check(f"21 {tag}: the built ELL vs the matrix-free engine", ell(x),
              y, 1e-12)
    rec["ell_bytes"] = (ell.cols.numel() * ell.cols.element_size()
                        + ell.vals.numel() * ell.vals.element_size())
    rec["bound_ms"], rec["bound_by"] = bound(ell)
    del ell
    _, t_k2 = _timed(kernel)
    res, t_p2 = _timed(plain)
    del res
    rec["plain_s"], rec["kernel_s"] = [t_p1, t_p2], [t_k1, t_k2]
    rec["ms"] = cuda_ms(kernel, samples=5, per_sample=1)
    rec["device_ms"] = kernel_device_ms(kernel, (tag_kernel,),
                                        per_call=True)[tag_kernel]
    rec["plain_ms"] = 1e3 * min(t_p1, t_p2)
    rec["library_ms"] = None
    print("ell_build", json.dumps(rec), flush=True)
    if rec["kernel_peak_bytes"] > rec["plain_peak_bytes"]:
        raise AssertionError(f"21 {tag}: the kernel build's peak "
                             f"{rec['kernel_peak_bytes']} B over the plain "
                             f"build's {rec['plain_peak_bytes']}")
    torch.cuda.empty_cache()
    return rec


def ell_repr_case(tag, kind, val, k, out, dev):
    """Phase 21, a momentum sector: build_sparse_repr (repr_images) against
    the plain build (_repr_images_plain and compact_rows a block)."""
    from quantum_basis_tpu_torch.ops import apply_repr as ar
    from quantum_basis_tpu_torch.ops.apply_repr import _repr_ell_plain
    from quantum_basis_tpu_torch.ops.sparse import build_sparse_repr

    m, op = _k9_model(kind, dev)
    m.enumerate_basis_repr(list(k), [op], [val])
    mv = m.sec_repr[0].matvec
    rb = mv.basis
    args = mv.args()
    rt, tabs, ix, labels, fodd, isn, sqrt_nu, _, phase = args
    x = torch.randn(mv.n, dtype=torch.complex128, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(21))
    per_row = 16 + (8 if fodd is not None else 0)
    return ell_case(
        tag, "momentum", mv.n, tabs.n_cols, lambda: build_sparse_repr(mv),
        lambda: _repr_ell_plain(*args[:7], phase, 0, mv.n, rb.block_rows),
        mv, x, lambda: ar.launches["repr_images"], "repr_images_kernel",
        lambda ell: ell_bound(ell, ix, per_row, tabs.nbytes + rt.nbytes,
                              True), out, "repr_images")


def ell_registers():
    """{(pass, mode, amp_c, path code): registers} of every ell_rows
    instance in the built library, read by cuobjdump -res-usage; {} where
    cuobjdump is missing or fails (not measured)."""
    from quantum_basis_tpu_torch.ops import cuda_build, ell_build

    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    try:
        res = subprocess.run(
            [tool, "-res-usage", str(cuda_build.library_path(
                ell_build._SRC))], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return {}
    found = re.findall(r"ell_rows_kernel_(count|write)ILi(\d)ELb(\d)ELi(\d)E"
                       r"\S*\s*REG:(\d+)", res.stdout)
    return {(w, int(m), int(c), int(pth)): int(reg)
            for w, m, c, pth, reg in found}


def ell_split(build, samples=7):
    """ell_rows' build split by CUDA events (ell_build.trace), the median
    of ``samples`` builds after one: ms of the host work before the count
    pass (``pre_ms``), the count pass, the host gap between the passes,
    the write pass and the host work after it; the host ms of the gap's
    sync and allocations; the row stage taken."""
    from quantum_basis_tpu_torch.ops import ell_build

    build()
    ell_build.trace = []
    try:
        for _ in range(samples):
            build()
            torch.cuda.synchronize()
        recs = ell_build.trace
    finally:
        ell_build.trace = None
    keys = ("pre_ms", "count_ms", "host_gap_ms", "write_ms", "post_ms")
    out = {}
    for i, key in enumerate(keys):
        out[key] = float(np.median([r["events"][i].elapsed_time(
            r["events"][i + 1]) for r in recs]))
    out["sync_ms"] = 1e3 * float(np.median([r["sync_s"] for r in recs]))
    out["alloc_ms"] = 1e3 * float(np.median([r["alloc_s"] for r in recs]))
    out["path"] = recs[-1]["path"]
    return out


def ell_full_case(tag, out, dev):
    """Phase 21, a full sector: build_sparse_full (ell_rows) against the
    plain build (_row_images, the lookup and compact_rows a block); the
    rows' lengths the build wrote against row_lengths, its row stage, its
    instances' registers and its split (ell_split)."""
    from quantum_basis_tpu_torch.ops import ell_build
    from quantum_basis_tpu_torch.ops.apply import MatvecFull
    from quantum_basis_tpu_torch.ops.sparse import (build_sparse_full,
                                                    row_lengths)
    from torch_zoo import heisenberg_chain, kagome_heisenberg, tj_chain

    if tag == "kagome24_Sz0":
        m, ops = kagome_heisenberg(2, 4, device=dev)
    elif tag == "tJ12_N8_Sz0":
        m, ops = tj_chain(12, device=dev)
    else:
        m, ops = heisenberg_chain(26 if tag == "chain26_Sz0" else 24,
                                  device=dev)
    if tag == "tJ12_N8_Sz0":
        m.enumerate_basis_full([ops["Sz"], ops["N"]], [0.0, 8.0])
    else:
        m.enumerate_basis_full([ops["Sz"]], [0.0])
    sec = m.sec_full[0]
    mv = sec.matvec if isinstance(sec.matvec, MatvecFull) else MatvecFull(
        m.compiled_Ham, sec.dbasis)
    db, tabs = mv.basis, mv.tables
    args = (tabs, db.index.tables, db.labels_b.view(-1),
            db.V_b.view(-1, db.space.n_slots), db.fodd, db.n)
    x = torch.as_tensor(np.random.default_rng(21).standard_normal(db.n),
                        device=dev)
    per_row = 8 + (8 if db.fodd is not None else 0)

    def bound(ell):
        if not torch.equal(ell.rowlen, row_lengths(ell.vals)):
            raise AssertionError(f"21 {tag}: the build's row lengths "
                                 f"differ from row_lengths")
        return ell_bound(ell, db.index.tables, per_row, tabs.nbytes, False)
    rec = ell_case(
        tag, "full", db.n, tabs.n_cols, lambda: build_sparse_full(mv),
        lambda: ell_build._ell_rows_plain(*args, db.block_rows)[:2], mv, x,
        lambda: ell_build.launch_count, "ell_rows_kernel", bound, out,
        "ell_rows")
    rec.update(ell_split(lambda: build_sparse_full(mv)))
    passes = kernel_device_ms(lambda: build_sparse_full(mv),
                              ("ell_rows_kernel_count",
                               "ell_rows_kernel_write"), per_call=True)
    rec["count_device_ms"] = passes["ell_rows_kernel_count"]
    rec["write_device_ms"] = passes["ell_rows_kernel_write"]
    code = ell_build.PATHS.index(rec["path"])
    rec["rows_a_warp"] = 2 if code == 1 else 1
    regs = ell_registers()
    rec["registers"] = {w: regs.get((w, 0, int(tabs.is_complex), code))
                        for w in ("count", "write")}
    print("ell_split", json.dumps({k: rec[k] for k in (
        "case", "path", "rows_a_warp", "registers", "pre_ms", "count_ms",
        "host_gap_ms", "sync_ms", "alloc_ms", "write_ms", "post_ms", "ms",
        "device_ms", "count_device_ms", "write_device_ms", "bound_ms")}),
          flush=True)
    return rec


def ell_build_run(dev):
    """Phase 21: the ELL builds through both kernels at full width, each
    against its plain version on the card (columns and W exactly, values
    to 1e-14 of max|v|, the ELL's H x against MatvecRepr's / MatvecFull's
    to 1e-12 of max|y|) and timed beside it: the momentum sectors
    kagome-24 Sz=0 k=(0,2), chain-24 Sz=0 k=0 and the honeycomb spinless
    fermions 4x3 at k=(0,0) (repr_images), the full sectors chain-24 and
    kagome-24 Sz=0 (dim 2,704,156), chain-26 Sz=0 (10,400,600) and t-J-12
    N=8 Sz=0 (fermions; ell_rows). Returns the records by tag and the worst
    errors."""
    t21 = time.perf_counter()
    out = {"max_abs_err": {"repr_images": 0.0, "ell_rows": 0.0}}
    for tag, kind, val, k in ELL_REPR:
        out[tag] = ell_repr_case(tag, kind, val, k, out, dev)
    for tag in ELL_FULL:
        out[tag] = ell_full_case(tag, out, dev)
    print(f"phase 21: {time.perf_counter() - t21:.1f} s", flush=True)
    return out


# --------------------------------------------------------------------------
# Phase 22: the ELL apply (ell_spmv)
# --------------------------------------------------------------------------


def ell_apply_bound(ell, x, live=True):
    """Least time of one ELL apply y = diag x + A x on this card in ms, and
    which bound it is. Bytes, with ``live``: each row's live slots (below
    its row length, ops/sparse.py::row_lengths: an int32 column and a value
    each), the row lengths (int32), the diagonal and x read once, y written
    once; without: the stored (n, W) columns and values as they are stored,
    the diagonal and x, and y; over 3.35 TB/s. Operations: 2 a slot (live
    or stored) for real values and a real x, 4 against a complex x, 8 for
    complex values, and the diagonal's 2 or 4 a row, over the float64
    peak."""
    n = ell.n
    cplx = ell.is_complex or x.is_complex()
    vb = 16 if cplx else 8
    if live:
        slots = int(ell.rowlen.sum())
        nbytes = slots * (4 + ell.vals.element_size()) + 4 * n
    else:
        slots = n * ell.width
        nbytes = (ell.cols.numel() * ell.cols.element_size()
                  + ell.vals.numel() * ell.vals.element_size())
    nbytes += 8 * n + 2 * vb * n
    per = 8 if ell.is_complex else (4 if cplx else 2)
    flops = per * slots + (4 if cplx else 2) * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[torch.float64] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_ell_ms(ell, x):
    """Time of one ``torch.sparse`` CSR product of the same matrix (the
    live slots and the diagonal, in x's type) with x, and its y; or (None,
    None, the error's first line). Timed only: nothing in the package
    calls it."""
    dev = ell.diag.device
    n = ell.n
    try:
        rows = torch.arange(n, device=dev).repeat_interleave(ell.width)
        live = ell.vals.reshape(-1) != 0
        diag = torch.arange(n, device=dev)
        idx = torch.stack([torch.cat([rows[live], diag]),
                           torch.cat([ell.cols.reshape(-1)[live].long(),
                                      diag])])
        vals = torch.cat([ell.vals.reshape(-1)[live].to(x.dtype),
                          ell.diag.to(x.dtype)])
        del rows, live
        A = torch.sparse_coo_tensor(idx, vals, (n, n)).coalesce() \
            .to_sparse_csr()
        del idx, vals
        y = A @ x
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, None, str(e).splitlines()[0]
    return cuda_ms(lambda: A @ x, samples=10, per_sample=3), y, None


def ell_apply_case(tag, ell, x, out):
    """One matrix and vector: the kernel through the matrix's launch record
    (``ell(x)``, the main path's call, int32 columns; one launch) and
    through the functional wrapper on the same matrix with int64 columns,
    each against the plain version on the same CUDA tensors to 1e-12 of
    max|y|; then the record's call, the int64 instance, the plain version
    and the CSR product timed with CUDA events (the kernel also by
    torch.profiler, and the record's call by the host clock over 200
    calls), beside the live and the stored bytes' bounds."""
    from quantum_basis_tpu_torch.ops import sparse
    from quantum_basis_tpu_torch.ops.sparse import (EllLaunch,
                                                    _ell_spmv_plain,
                                                    ell_spmv)

    cdt = (torch.complex128 if ell.is_complex or x.is_complex()
           else torch.float64)
    x = x.to(cdt)
    if ell.cols.dtype != torch.int32:
        raise AssertionError(f"22 {tag}: {ell.cols.dtype} columns")
    want = _ell_spmv_plain(ell.cols, ell.vals, ell.diag, x, x)
    cols64 = ell.cols.long()
    scale = float(want.abs().max())
    errs = {}
    for name, call in (("int32", lambda: ell(x)),
                       ("int64", lambda: ell_spmv(cols64, ell.vals,
                                                  ell.diag, x))):
        before = sparse.launch_count
        y = call()
        if sparse.launch_count != before + 1:
            raise AssertionError(f"22 {tag} {name}: "
                                 f"{sparse.launch_count - before} launches "
                                 f"for one apply")
        torch.cuda.synchronize()
        errs[name] = float((y - want).abs().max())
        print(f"check 22 {tag} {name} columns: kernel vs plain "
              f"{errs[name]:.3e} (max|y| {scale:.3e}, tol 1e-12 max|y|)",
              flush=True)
        if not errs[name] <= 1e-12 * scale:
            raise AssertionError(f"22 {tag} {name}: the kernel differs from "
                                 f"its plain version by {errs[name]:.3e}")
    del want
    rec64 = EllLaunch(cols64, ell.vals, ell.diag, ell.rowlen)
    err = max(errs.values())
    out["max_abs_err"] = max(out["max_abs_err"], err)
    rec = {"case": tag, "dim": ell.n, "W": ell.width,
           "values": "complex" if ell.is_complex else "real",
           "x": "complex" if x.is_complex() else "real",
           "group": ell._launch.group,
           "live_slots_mean": float(ell.rowlen.sum()) / max(ell.n, 1),
           "ell_bytes": (ell.cols.numel() * ell.cols.element_size()
                         + ell.vals.numel() * ell.vals.element_size()),
           "card": card_line(), "max_abs_err": err,
           "max_abs_err_int64": errs["int64"], "max_abs_y": scale}
    rec["live_bound_ms"], rec["bound_by"] = ell_apply_bound(ell, x)
    rec["bound_ms"] = rec["live_bound_ms"]
    rec["stored_bound_ms"] = ell_apply_bound(ell, x, live=False)[0]
    rec["ms"] = cuda_ms(lambda: ell(x))
    rec["device_ms"] = kernel_device_ms(lambda: ell(x),
                                        ("ell_spmv_kernel",))[
        "ell_spmv_kernel"]
    rec["host_ms"] = host_ms(lambda: ell(x))
    rec["ms_int64"] = cuda_ms(lambda: rec64(x))
    del rec64, cols64
    rec["plain_ms"] = cuda_ms(
        lambda: _ell_spmv_plain(ell.cols, ell.vals, ell.diag, x, x),
        samples=10, per_sample=3)
    rec["library_ms"], y_lib, rec["library_error"] = library_ell_ms(ell, x)
    if y_lib is not None:
        rec["library_rel_diff"] = float((y_lib - ell(x)).abs().max()) / scale
    del y_lib
    rec["share_of_bound"] = rec["live_bound_ms"] / rec["ms"]
    rec["share_of_stored_bound"] = rec["stored_bound_ms"] / rec["ms"]
    print("ell_apply", json.dumps(rec), flush=True)
    torch.cuda.empty_cache()
    return rec


def ell_apply_run(dev):
    """Phase 22: ell_spmv at the main path's shapes, each against its plain
    version on the card (1e-12 of max|y|) and timed beside it, the CSR
    product and the bound: the explicit momentum sectors kagome-24 Sz=0
    k=(0,2) and chain-24 Sz=0 k=0 (complex), the full sectors chain-24 and
    kagome-24 Sz=0 (dim 2,704,156, real; a real and a complex x), the
    Holstein chain's MatvecVrnl at depth 14, k = 1/4 (phase 11's) and a
    diagonal-only matrix. Returns the records by tag and the worst error."""
    from quantum_basis_tpu_torch.ops.apply import MatvecFull
    from quantum_basis_tpu_torch.ops.apply_vrnl import MatvecVrnl
    from quantum_basis_tpu_torch.ops.sparse import (EllMatrix,
                                                    build_sparse_full,
                                                    build_sparse_repr)
    from torch_zoo import holstein_chain

    t22 = time.perf_counter()
    out = {"max_abs_err": 0.0}
    gen = torch.Generator(device=dev).manual_seed(22)

    def vec(n, cplx):
        return torch.randn(n, dtype=torch.complex128 if cplx
                           else torch.float64, device=dev, generator=gen)
    for tag, kind, k in (("kagome24_k02", "kagome", (0, 2)),
                         ("chain24_k0", "chain", (0,))):
        m, op = _k9_model(kind, dev)
        m.enumerate_basis_repr(list(k), [op], [0.0])
        ell = build_sparse_repr(m.sec_repr[0].matvec)
        del m
        out[tag] = ell_apply_case(tag, ell, vec(ell.n, True), out)
        del ell
    for tag, kind in (("chain24_Sz0", "chain"), ("kagome24_Sz0", "kagome")):
        m, op = _k9_model(kind, dev)
        m.enumerate_basis_full([op], [0.0])
        sec = m.sec_full[0]
        mv = sec.matvec if isinstance(sec.matvec, MatvecFull) else \
            MatvecFull(m.compiled_Ham, sec.dbasis)
        ell = build_sparse_full(mv)
        del m, sec, mv
        out[tag] = ell_apply_case(tag, ell, vec(ell.n, False), out)
        out[tag + "_cx"] = ell_apply_case(tag + "_cx", ell,
                                          vec(ell.n, True), out)
        if kind == "chain":
            diag = EllMatrix(torch.zeros((ell.n, 0), dtype=torch.int64,
                                         device=dev),
                             torch.zeros((ell.n, 0), dtype=torch.float64,
                                         device=dev), ell.diag)
            out["diagonal_only"] = ell_apply_case(
                "diagonal_only", diag, vec(ell.n, False), out)
            del diag
        del ell
    model, ops = holstein_chain(HOLSTEIN_L, 3, device=dev)
    seed = int(model.space.strides[model.space.slot(HOLSTEIN_L // 2, 0)])
    model.build_basis_vrnl([seed], 0, [0.0], [0.0], 14, [ops["N_e"]], [1.0])
    model.generate_Ham_sparse_vrnl(0)
    vr = MatvecVrnl(model.sec_vrnl[0].vmat, [0.25])
    out["vrnl_holstein16_k1/4"] = ell_apply_case(
        "vrnl_holstein16_k1/4", vr, vec(vr.n, True), out)
    del model, vr
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t22:.1f} s", flush=True)
    return out


def memory_run(dev, prod, ckpt_dir):
    """Phase 16: each size of config.MEMORY["cuda"] read by a model on the
    card, at full width, beside the golden of the sector it solves; the
    Hubbard 4x4 completion record of phase 7 resumed with no apply."""
    import math

    from quantum_basis_tpu_torch import CkptStore, config
    from quantum_basis_tpu_torch.examples import engine_of
    from quantum_basis_tpu_torch.examples.square_fermi_hubbard import (
        build_factorized)
    from quantum_basis_tpu_torch.models import model as model_mod
    from quantum_basis_tpu_torch.models import product as product_mod
    from torch_zoo import heisenberg_chain, hubbard_factorized

    mem = config.MEMORY["cuda"]
    rec = {"memory": dict(mem), "card": card_line()}
    t16 = time.perf_counter()

    # apply_block_budget: chain-24 Sz=-4 (blowup 22.8), on the card's route
    m, ops = heisenberg_chain(24, device=dev)
    dim = m.enumerate_basis_full([ops["Sz"]], [-4.0])
    db = m.sec_full[0].dbasis
    work = max(m.compiled_Ham.nnz_per_row, 1) * m.space.n_slots
    want = min(1 << int(math.log2(max(
        1024, mem["apply_block_budget"] // work))), dim)
    print(f"check chain-24 Sz=-4 block rows {db.block_rows} == {want}",
          flush=True)
    if db.block_rows != want:
        raise AssertionError("chain-24 Sz=-4: the block rows do not follow "
                             "the cuda apply_block_budget")
    _, rec["chain24_up8_s"] = _timed(lambda: m.locate_E0_lanczos("full"))
    rec["chain24_up8_engine"] = engine_of(m, "full")
    e_table = m.eigenvals_full[0]
    m.generate_Ham_sparse_full(check=False)
    m.locate_E0_lanczos("full")
    _check("chain-24 Sz=-4 E0, the table's route vs the ELL", e_table,
           m.eigenvals_full[0], 1e-10)

    # repr_block_budget: chain-24 k=0 Sz=0
    m.enumerate_basis_repr([0], [ops["Sz"]], [0.0])
    rb = m.sec_repr[0].dbasis
    want = min(1 << int(math.log2(max(
        256, mem["repr_block_budget"]
        // (max(m.compiled_Ham.nnz_per_row, 1) * rb.tset.G)))), rb.n)
    print(f"check chain-24 k=0 repr block rows {rb.block_rows} == {want}",
          flush=True)
    if rb.block_rows != want:
        raise AssertionError("chain-24 k=0: the block rows do not follow "
                             "the cuda repr_block_budget")
    _, rec["chain24_k0_s"] = _timed(lambda: m.locate_E0_lanczos("repr"))
    _check("chain-24 k=0 E0", m.eigenvals_repr[0], E0_CHAIN24, 1e-9)
    # repr_label_buffer_max: chain-24 k=0's repr_rows by label (2^24
    # labels, 256 MiB) where the table's bound holds them
    by_label = 16 * m.space.label_space <= mem["repr_label_buffer_max"]
    rec["chain24_k0_by_label"] = m.sec_repr[0].matvec.record().by_label
    print(f"check chain-24 k=0 repr_rows by label "
          f"{rec['chain24_k0_by_label']} (repr_label_buffer_max "
          f"{mem['repr_label_buffer_max']})", flush=True)
    if rec["chain24_k0_by_label"] != by_label:
        raise AssertionError("chain-24 k=0: repr_rows' path does not follow "
                             "the cuda repr_label_buffer_max")

    # polish_n: the mixed full-sector solve of chain-24 Sz=0 at N = 2^24 on
    # ContractOp (pinned), its warm f64 stage by the table
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    seen = []
    real = _spy(model_mod, "rqi_polish", seen, lambda *a, **kw: "rqi")
    try:
        with config.pinned(mixed_precision=True,
                           fullspace_mixed_max_blowup=64.0):
            _, rec["chain24_mixed_s"] = _timed(
                lambda: m.locate_E0_lanczos("full"))
    finally:
        model_mod.rqi_polish = real
    rqi = m.space.label_space > mem["polish_n"]
    rec["polish"] = "rqi" if seen else "thick_restart"
    print(f"check chain-24 N = 2^24 polish branch {rec['polish']} "
          f"(polish_n {mem['polish_n']})", flush=True)
    if bool(seen) != rqi:
        raise AssertionError("chain-24: the polish branch does not follow "
                             "the cuda polish_n")
    _check("chain-24 Sz=0 mixed E0", m.eigenvals_full[0], E0_CHAIN24, 1e-9)
    del m, db, rb
    torch.cuda.empty_cache()

    # direct_lookup_max: chain-26 Sz=0 (label space 2^26)
    m, ops = heisenberg_chain(26, device=dev)
    dim, rec["chain26_enumerate_s"] = _timed(
        lambda: m.enumerate_basis_full([ops["Sz"]], [0.0]))
    idx = m.sec_full[0].dbasis.index
    rec["chain26_lookup"] = idx.mode
    direct = m.space.label_space <= mem["direct_lookup_max"]
    print(f"check chain-26 lookup mode {idx.mode} (direct_lookup_max "
          f"{mem['direct_lookup_max']})", flush=True)
    if (idx.mode == "direct") != direct:
        raise AssertionError("chain-26: the lookup mode does not follow the "
                             "cuda direct_lookup_max")
    pick = torch.as_tensor(np.random.default_rng(3).choice(
        dim, min(dim, 1 << 20), replace=False), device=dev)
    labels = torch.as_tensor(m.sec_full[0].labels, device=dev)[pick]
    if not torch.equal(idx.lookup(labels), pick):
        raise AssertionError("chain-26: lookup of sector labels")
    del m, idx, labels, pick
    torch.cuda.empty_cache()

    # product_mixed_above, product_ncv: Hubbard 4x2 with the defaults
    pm, _ = hubbard_factorized(4, 2, device=dev)
    seen = []
    reals = (_spy(product_mod, "eigs_smallest", seen,
                  lambda *a, **kw: ("f64", kw["ncv"])),
             _spy(product_mod.Model, "_f32_stage_cached", seen,
                  lambda fs, nev, ncv, *a: ("mixed", ncv)))
    try:
        e0 = pm.locate_E0_lanczos()
    finally:
        product_mod.eigs_smallest = reals[0]
        product_mod.Model._f32_stage_cached = staticmethod(reals[1])
    mixed = pm.dim > mem["product_mixed_above"]
    ncv = mem["product_ncv"] if mixed else max(mem["product_ncv"], 6)
    rec["hubbard4x2_pipeline"] = seen
    print(f"check hubbard 4x2 pipeline {seen} == "
          f"{[('mixed' if mixed else 'f64', ncv)]}", flush=True)
    if seen != [("mixed" if mixed else "f64", ncv)]:
        raise AssertionError("hubbard 4x2: the pipeline or ncv does not "
                             "follow the cuda table")
    _check("hubbard 4x2 E0 (the table's pipeline)", e0, E0_HUBBARD_4X2, 1e-8)

    # ckpt_max_bytes: phase 7's completion record of Hubbard 4x4, resumed
    pm, _ = build_factorized(4, 4, device=dev)
    key = f"prodE0_{pm.na}x{pm.nb}_nev1_h{pm._fingerprint():08x}"
    store = CkptStore(ckpt_dir)
    if prod.get("capped"):
        # phase 7 did not solve: a record of the same size, from the golden
        # and a unit vector, written through the same method
        v = torch.randn(pm.dim, dtype=torch.float64, device=dev)
        v /= torch.linalg.vector_norm(v)
        with config.pinned(enable_ckpt=True, ckpt_dir=ckpt_dir):
            pm._stage_save(key, [E0_HUBBARD_4X4], [v], resid=0.0)
        del v
        want_e0 = E0_HUBBARD_4X4
    else:
        want_e0 = prod["E0"]
    path = store._path(key)
    rec["hubbard4x4_record"] = {"synthetic": bool(prod.get("capped")),
                                "bytes": os.path.getsize(path)}
    if not pm.dim * 8 <= mem["ckpt_max_bytes"]:
        raise AssertionError("the 4x4 eigenvector is over the cuda "
                             "ckpt_max_bytes")
    with config.pinned(enable_ckpt=True, ckpt_dir=ckpt_dir):
        e0, rec["hubbard4x4_resume_s"] = _timed(pm.locate_E0_lanczos)
    rec["hubbard4x4_resume_applies"] = sum(
        op.n_applies for op in pm._ops.values())
    print(f"check hubbard 4x4 resumed with "
          f"{rec['hubbard4x4_resume_applies']} applies", flush=True)
    if rec["hubbard4x4_resume_applies"] != 0 or pm._ops:
        raise AssertionError("hubbard 4x4: the completion record did not "
                             "short-circuit the solve")
    _check("hubbard 4x4 E0 from the completion record", e0, want_e0, 0.0)
    del pm
    torch.cuda.empty_cache()
    rec["s"] = time.perf_counter() - t16
    print("memory", json.dumps(rec), flush=True)
    return rec


def device_busy(tag, fn):
    """Trace fn() with torch.profiler: wall ms (tracing included, so above
    the untraced time), device-busy ms (the sum of every kernel's and copy's
    device time) and the idle share of the traced window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: a host op's entry repeats its kernels' time
    dev_events = [e for e in prof.key_averages()
                  if e.device_type != DeviceType.CPU]
    busy_us = sum(e.self_device_time_total for e in dev_events)
    if busy_us <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:3]
    rec = {"window": tag, "wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
           "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
           "device_ops": sum(e.count for e in dev_events),
           "top_ops": [(e.key[:48], e.count,
                        round(e.self_device_time_total / 1e3, 3))
                       for e in top]}
    print("profile", json.dumps(rec), flush=True)
    return rec


def profile_kpm(dev):
    """--profile: the KPM path of phase 10a, one q of the tilted cluster's
    S(q, w) (192 moments and their bounds on the BSR kernel) from the
    ground-state sector phase 4b finds, on phase 10a's pinned bounds."""
    with jax_bounds("bsr_blowup_max", "bsr_stored_max_bytes",
                    "bsr_auto_max_dim"):
        _profile_kpm(dev)


def _profile_kpm(dev):
    from torch_zoo import tilted_heisenberg, tilted_momenta

    mt, opt = tilted_heisenberg(TILTED_A, device=dev)
    mt.enumerate_basis_repr(list(TILTED_K_GS), [opt["Sz"]], [0.0])
    mt.locate_E0_lanczos(which="repr")
    lat = mt.lattice
    q = tilted_momenta(TILTED_A)[1]
    A = _sz_q(np.exp(-2j * np.pi * lat.k_dot_R(
        q, [lat.site2coor(s)[0] for s in range(lat.n_sites)])))
    mt.enumerate_basis_repr((np.asarray(TILTED_K_GS) - q).tolist(),
                            [opt["Sz"]], [0.0], sec=1)
    if mt._repr_bsr32(mt.sec_repr[1]) is None:
        raise AssertionError("tilted-20 KPM: the sector is not on the BSR")
    device_busy("tilted-20 S(q,w), one q: 192 KPM moments on the BSR kernel",
                lambda: mt.measure_repr_dynamic_kpm(A, 0, 1, KPM_MOMENTS))


def profile_vrnl(dev):
    """The variational sector of phase 11 at depth 14: one k's regrowth,
    skeleton build and solve, and 20 MatvecVrnl applies."""
    from torch_zoo import holstein_chain

    m, ops = holstein_chain(HOLSTEIN_L, 3, device=dev)
    seed = int(m.space.strides[m.space.slot(HOLSTEIN_L // 2, 0)])

    def grow():
        m.build_basis_vrnl([seed], 0, [0.0], [0.25], 14, [ops["N_e"]], [1.0])

    def skeleton():
        m._vrnl_skel = None
        m.generate_Ham_sparse_vrnl(0)

    device_busy("holstein16 vrnl growth to depth 14 (dim 28,956)", grow)
    device_busy("holstein16 vrnl skeleton (nnz 66,903)", skeleton)
    device_busy("holstein16 vrnl solve k=1/4",
                lambda: m.locate_E0_lanczos(which="vrnl"))
    mv = m.sec_vrnl[0].matvec
    x = torch.randn(mv.n, dtype=torch.complex128, device=dev)
    device_busy("holstein16 MatvecVrnl apply x20",
                lambda: [mv(x) for _ in range(20)])
    del m, mv, x


def profile_pkh(dev, m, ops):
    """--profile: P_k, P_k H applies and a P_k H solve at N = 2^24 on the
    kagome cluster ``m`` (k=(0,2)) and chain-24 (k=0)."""
    from torch_zoo import heisenberg_chain

    for tag, mk, opk, k in (
            ("kagome24 k=(0,2)", m, ops, [0, 2]),
            ("chain24 k=0", *heisenberg_chain(24, device=dev), [0])):
        mk.enumerate_basis_repr(k, [opk["Sz"]], [0.0])
        pk = mk._fullspace_repr_op(mk.sec_repr[0])
        if pk is None:
            raise AssertionError(f"{tag}: no P_k H engine")
        g = torch.Generator(device=dev).manual_seed(3)
        xk = pk.project(torch.randn(pk.N, dtype=torch.complex128, device=dev,
                                    generator=g))
        device_busy(f"{tag} P_k apply (N 2^24)",
                    lambda: pk.projector.apply(xk))
        device_busy(f"{tag} P_k H f64 apply (N 2^24)", lambda: pk(xk))
        if len(k) == 1:
            # host share of a whole projected solve (Lehmer start vectors
            # made on the host over all labels, projected on the device)
            device_busy(f"{tag} P_k H f64 solve",
                        lambda: mk.locate_E0_lanczos(which="repr"))
        del mk, pk, xk
        torch.cuda.empty_cache()


def profile_windows(dev):
    """--profile: where the device waits for the host on the full route."""
    from torch_zoo import heisenberg_chain

    m, _ = heisenberg_chain(16, device=dev)
    m.enumerate_basis_full([], [])
    device_busy("chain16 matrix-free solve (dim 65,536)",
                lambda: m.locate_E0_lanczos("full"))
    m, ops = heisenberg_chain(24, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    mv = m.sec_full[0].matvec
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(mv.n),
                        device=dev)
    device_busy("chain24 matrix-free apply (dim 2,704,156)", lambda: mv(x))
    fs = m._fullspace_op(m.sec_full[0])
    xf = fs.to_full(x)
    device_busy("chain24 ContractOp f64 apply (N 2^24)", lambda: fs(xf))
    device_busy("chain24 ContractOp f64 solve", lambda: m.locate_E0_lanczos())
    del fs, xf
    m.sec_full[0]._fs_cache.clear()
    ell = m.generate_Ham_sparse_full(check=False)
    device_busy("chain24 ELL apply x20",
                lambda: [ell(x) for _ in range(20)])
    device_busy("chain24 ELL solve", lambda: m.locate_E0_lanczos("full"))
    del m, mv, ell

    from torch_zoo import hubbard_factorized, kagome_heisenberg

    m, ops = kagome_heisenberg(2, 4, device=dev)
    m.enumerate_basis_full([ops["Sz"]], [0.0])
    fs = m._fullspace_op(m.sec_full[0])
    xf = fs.to_full(x)
    device_busy("kagome24 ContractOp f64 apply (N 2^24)", lambda: fs(xf))
    del fs, xf
    m.sec_full.clear()
    torch.cuda.empty_cache()

    # P_k H at N = 2^24: kagome k=(0,2), then chain-24 k=0, on phase 8's
    # pinned bound
    with jax_bounds("fullspace_repr_max_blowup"):
        profile_pkh(dev, m, ops)
    del m
    profile_kpm(dev)
    profile_vrnl(dev)

    pm, _ = hubbard_factorized(4, 4, device=dev)
    psi = torch.randn(pm.dim, dtype=torch.float32, device=dev)
    # one apply and several in a row: a window of one apply has read 50%
    # idle with one of its two matrix products missing from the trace
    for layout, reps in (("ell", 5), ("dense", 1), ("dense", 3)):
        fs32 = pm.op(torch.float32, layout=layout)
        device_busy(f"hubbard 4x4 KronOp {layout} f32 apply x{reps} (dim "
                    "165,636,900)", lambda: [fs32(psi) for _ in range(reps)])
        del fs32
        pm._ops.clear()
        torch.cuda.empty_cache()
    del psi
    # the whole solve on the card's route (the ELL layout): run twice, the
    # first untraced
    device_busy("hubbard 4x4 solve (ProductModel defaults)",
                lambda: pm.locate_E0_lanczos(log=lambda *a: None))
    del pm
    torch.cuda.empty_cache()



def main() -> int:
    """Phases 1-13, 16-22 and 15 on one card; or one mode: ``--profile``,
    ``--hubbard4x4`` (phase 7), ``--kron-ell`` (phase 17), ``--apply-rows``
    (phase 18), ``--krylov`` (phase 19), ``--apply-repr`` (phase 20),
    ``--ell-build`` (phase 21), ``--ell-apply`` (phase 22), ``--gaps``,
    ``--bsr-bench``, ``--mesh``
    (phase 12), ``--ranks N`` (phase 14: the route on N cards over NCCL,
    then the scaling drivers); ``--mesh-rank`` / ``--ranks-worker`` are the
    rank processes those phases start."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the model builders live beside the tests (tests/torch_zoo.py)
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    if sys.argv[1:2] == ["--mesh-rank"]:
        return mesh_rank(sys.argv[2:])
    if sys.argv[1:2] == ["--ranks-worker"]:
        return ranks_worker(sys.argv[2:])
    card = card_line()
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda,
          "python", sys.version.split()[0], flush=True)

    t_start = time.perf_counter()
    if "--ranks" in sys.argv[1:]:
        n = int(sys.argv[sys.argv.index("--ranks") + 1])
        ranks_run(n, t_start)
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n}}))
        return 0
    if "--profile" in sys.argv[1:]:
        with jax_bounds("fullspace_max_blowup",
                        "fullspace_mixed_max_blowup"):
            profile_windows("cuda")
        return 0
    if "--hubbard4x4" in sys.argv[1:]:
        product_run("cuda", t_start, force_full=True)
        return 0
    if "--kron-ell" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import apply_kron

        apply_kron.build_library(verbose=True)
        kron_ell_run("cuda")
        return 0
    if "--apply-rows" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import apply

        apply.build_library(verbose=True)
        apply_rows_run("cuda")
        return 0
    if "--krylov" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import krylov

        krylov.build_library(verbose=True)
        krylov_run("cuda")
        return 0
    if "--apply-repr" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import apply_repr

        apply_repr.build_library(verbose=True)
        apply_repr_run("cuda")
        return 0
    if "--ell-build" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import (apply, apply_repr,
                                                 cuda_build, ell_build)

        cuda_build.build([apply._SRC, apply_repr._SRC, ell_build._SRC],
                         verbose=True)
        ell_build_run("cuda")
        return 0
    if "--ell-apply" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import (apply, apply_repr,
                                                 cuda_build, ell_build,
                                                 sparse)

        cuda_build.build([apply._SRC, apply_repr._SRC, ell_build._SRC,
                          sparse._SRC], verbose=True)
        ell_apply_run("cuda")
        return 0
    if "--gaps" in sys.argv[1:]:
        gaps_run("cuda")
        return 0
    if "--bsr-bench" in sys.argv[1:]:
        from quantum_basis_tpu_torch.ops import bsr as bsr_mod

        bsr_mod.build_library(verbose=True)
        bsr_bench_run("cuda")
        return 0
    if "--mesh" in sys.argv[1:]:
        from torch_zoo import heisenberg_chain

        m, ops = heisenberg_chain(24, device="cuda")
        m.enumerate_basis_full([ops["Sz"]], [0.0])
        m.generate_Ham_sparse_full(check="probe")
        m.locate_E0_lanczos("full", maxit=4000)
        print(f"chain24 ELL E0 {m.eigenvals_full[0]!r}", flush=True)
        mesh_run("cuda", m.sec_full[0].labels, m.eigenvals_full[0])
        return 0
    from quantum_basis_tpu_torch.ops import (apply, apply_kron, apply_repr,
                                             cuda_build, ell_build, krylov,
                                             sparse)
    from quantum_basis_tpu_torch.ops import bsr as bsr_mod

    # every kernel of the path, one nvcc each, all started together
    t0 = time.perf_counter()
    cuda_build.build([bsr_mod._SRC, apply_kron._SRC, apply._SRC,
                      krylov._SRC, apply_repr._SRC, ell_build._SRC,
                      sparse._SRC], verbose=True)
    bsr_mod.build_library()
    apply_kron.build_library()
    apply.build_library()
    krylov.build_library()
    apply_repr.build_library()
    ell_build.build_library()
    sparse.build_library()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s", flush=True)

    # K9's main path: phases 4, 8 and 10, each with the counts set to 0
    # just before it and read just after
    launches_k9 = dict.fromkeys(apply_repr.KERNELS, 0)

    def k9_window(fn):
        apply_repr.reset_launches()
        result = fn()
        for k in launches_k9:
            launches_k9[k] += apply_repr.launches[k]
        return result

    dev = "cuda"
    rows = kernel_checks(bsr_mod, dev)
    with jax_bounds("fullspace_repr_max_blowup", "bsr_blowup_max",
                    "bsr_stored_max_bytes"):
        launches, e0_chain20, tilted = k9_window(
            lambda: slice_run(bsr_mod, dev))
    # ell_rows' main path: every ELL build of the run before phase 21's
    # comparisons, phase 5's full sectors first
    ell_build.launch_count = 0
    launches5, wide, launches_k2, launches_k6 = full_sector_run(
        bsr_mod, dev, e0_chain20)
    launches_ell = {"phase 5": ell_build.launch_count}
    print(f"ell_rows launches in phase 5: {launches_ell['phase 5']}",
          flush=True)
    if not launches_ell["phase 5"]:
        raise AssertionError("ell_rows was not launched on its main path")
    launches += launches5
    with jax_bounds("fullspace_max_blowup", "fullspace_mixed_max_blowup"):
        engines_run(dev, wide)
    print(f"phases 1-6: {time.perf_counter() - t_start:.1f} s", flush=True)
    with jax_bounds("fullspace_repr_max_blowup"):
        gs_sector = k9_window(
            lambda: momentum_run(bsr_mod, dev, wide, t_start))
    print(f"phases 1-6, 8: {time.perf_counter() - t_start:.1f} s", flush=True)
    resume_run(dev, wide[0])
    print(f"phases 1-6, 8, 9: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    launches10, art = k9_window(
        lambda: dynamics_run(bsr_mod, dev, tilted, wide, gs_sector))
    print("K9 launches in phases 4, 8 and 10:", json.dumps(launches_k9),
          flush=True)
    if not all(launches_k9.values()):
        raise AssertionError(f"a K9 kernel was not launched on its main "
                             f"path: {launches_k9}")
    launches += launches10
    # phase 12 holds the sharded route against phase 5's chain-24 sector
    chain_labels, chain_e0 = wide[0][1].sec_full[0].labels, wide[0][3]["E0_ell"]
    del wide, tilted, gs_sector
    torch.cuda.empty_cache()
    print(f"phases 1-6, 8-10: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    vrnl_run(bsr_mod, dev)
    torch.cuda.empty_cache()
    print(f"phases 1-6, 8-11: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    before = bsr_mod.launch_count
    mesh_run(dev, chain_labels, chain_e0)
    if bsr_mod.launch_count != before:
        raise AssertionError("the mesh route launched the BSR kernel")
    del chain_labels
    print(f"phases 1-6, 8-12: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    launches13, _ = drivers_run(bsr_mod, dev, art)
    launches += launches13
    launches_ell["phases 6-13"] = (ell_build.launch_count
                                   - sum(launches_ell.values()))
    torch.cuda.empty_cache()
    print(f"phases 1-6, 8-13: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=here)
    try:
        prod = product_run(dev, t_start, force_full=False, ckpt_dir=ckpt_dir)
        print(f"phases 1-13: {time.perf_counter() - t_start:.1f} s",
              flush=True)
        memory_run(dev, prod, ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"phases 1-13, 16: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    launches_ell["phases 7, 16"] = (ell_build.launch_count
                                    - sum(launches_ell.values()))
    torch.cuda.empty_cache()
    kron = kron_ell_run(dev)
    print(f"phases 1-13, 16, 17: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    k2 = apply_rows_run(dev)
    print(f"phases 1-13, 16-18: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    k6 = krylov_run(dev)
    print(f"phases 1-13, 16-19: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    k9 = apply_repr_run(dev)
    print(f"phases 1-13, 16-20: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    launches_ell["phases 17-20"] = (ell_build.launch_count
                                    - sum(launches_ell.values()))
    print("ell_rows launches by window:", json.dumps(launches_ell),
          flush=True)
    ell21 = ell_build_run(dev)
    print(f"phases 1-13, 16-21: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    torch.cuda.empty_cache()
    ell22 = ell_apply_run(dev)
    print(f"phases 1-13, 16-22: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print("ell_spmv launches in the ELL solves of phases 5 and 8:",
          json.dumps(ELL_SPMV_LAUNCHES), flush=True)

    main_row = next(r for r in rows if r["case"] == "tilted20_k00"
                    and r["vector"] == "complex")
    record = {"kernels": [{
        "name": "bsr_spmv",
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/bsr_spmv.cu",
        "replaces": "quantum_basis_tpu/ops/pallas_bsr.py:289",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
    }, {
        "name": "kron_ell",
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/kron_ell.cu",
        "replaces": "quantum_basis_tpu/ops/apply_kron.py:138",
        "launches": prod["kron_ell_launches"],
        "max_abs_err": kron["max_abs_err"],
        "ms": kron["ms"],
        "plain_ms": kron["plain_ms"],
        "bound_ms": kron["bound_ms"],
        "bound_by": kron["bound_by"],
        "dense_ms": kron["dense_ms"],
        "library_ms": kron["library_ms"],
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/apply_rows.cu",
        "replaces": f"quantum_basis_tpu/ops/apply.py:{line}",
        "launches": launches_k2[name],
        "max_abs_err": k2[err],
        "ms": k2[name]["ms"],
        "plain_ms": k2[name]["plain_ms"],
        "bound_ms": k2[name]["bound_ms"],
        "bound_by": k2[name]["bound_by"],
        "library_ms": k2[name]["library_ms"],
        "device_ms": k2[name]["device_ms"],
        # the other timed shapes of phase 18
        "shapes": {k2[key]["case"]: {f: k2[key][f] for f in (
            "ms", "device_ms", "plain_ms", "bound_ms", "library_ms")}
            for key in keys},
    } for name, line, err, keys in (
        ("apply_rows", 117, "max_abs_err", ("kagome24", "chain26")),
        ("scatter_rows", 242, "scatter_max_abs_err", ("scatter_szq",)))]}
    # K6: launches in phase 5's chain-24 solve and phase 7's 4x4 solve (none
    # when phase 7 was capped: one Lanczos cycle); times at the 4x4 f32
    # basis, a step's passes at r = 8 and the compaction at m = 12
    k6_main = k6["hubbard4x4"]["passes"]
    record["kernels"] += [{
        "name": name,
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/krylov.cu",
        "replaces": "quantum_basis_tpu/solvers/restarted.py:"
                    + ("153" if name == "krylov_compact" else "118"),
        "launches": launches_k6[name] + prod["k6_launches"].get(name, 0),
        "max_abs_err": k6["max_abs_err"][name],
        "ms": k6_main[name]["ms"],
        "plain_ms": k6_main[name]["plain_ms"],
        "bound_ms": k6_main[name]["bound_ms"],
        "bound_by": k6_main[name]["bound_by"],
        "library_ms": k6_main[name]["library_ms"],
        "device_ms": k6_main[name]["device_ms"],
        # chain-24 f64, the same pass
        "shapes": {"chain24_f64": {f: k6["chain24"]["passes"][name][f]
                                   for f in ("ms", "device_ms", "plain_ms",
                                             "bound_ms", "library_ms")}},
    } for name in krylov.KERNELS]
    # the two kernels that a library call also computes, at each r (m)
    for rec in record["kernels"][-5:]:
        key = {"krylov_project": "project_by_r",
               "krylov_compact": "compact_by_m"}.get(rec["name"])
        if key:
            rec["by_size"] = {case: k6[case][key]
                              for case in ("hubbard4x4", "chain24")}
    record["kernels"][-1]["by_size"]["chain24_wide"] = \
        k6["chain24"]["compact_wide"]
    # K9: launches in phases 4, 8 and 10; times at kagome-24 k=(0,2) (the
    # explicit route's sector of phase 8), the scatter's at the diagonal
    # wave from k=(0,0) into (0,2) (the S(q, w) injection's path), the
    # images' (a whole build: both passes) in phase 21
    k9["max_abs_err"]["repr_images"] = max(
        k9["max_abs_err"]["repr_images"], ell21["max_abs_err"]["repr_images"])
    k9_main = {"repr_rows": k9["kagome24_k02"],
               "repr_images": ell21["kagome24_k02"],
               "repr_scatter": k9["kagome24_wave"]}
    k9_other = {"repr_rows": {"chain24_k0": k9["chain24_k0"]},
                "repr_images": {t: ell21[t] for t in ("chain24_k0",
                                                      "honeycomb4x3_k00")},
                "repr_scatter": {
                    "kagome24_k02 H (atomics)": k9["kagome24_k02"]["scatter_h"],
                    "chain24_k0 H (atomics)": k9["chain24_k0"]["scatter_h"]}}
    record["kernels"] += [{
        "name": name,
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/apply_repr.cu",
        "replaces": replaces,
        "launches": launches_k9[name],
        "max_abs_err": k9["max_abs_err"][name],
        "ms": k9_main[name]["ms"],
        "plain_ms": k9_main[name]["plain_ms"],
        "bound_ms": k9_main[name]["bound_ms"],
        "bound_by": k9_main[name]["bound_by"],
        "library_ms": k9_main[name]["library_ms"],
        "device_ms": k9_main[name]["device_ms"],
        "host_ms": k9_main[name].get("host_ms"),
        "shapes": {case: {f: r.get(f) for f in (
            "ms", "device_ms", "host_ms", "plain_ms", "bound_ms",
            "library_ms")}
            for case, r in k9_other[name].items()},
    } for name, replaces in (
        ("repr_rows", "quantum_basis_tpu/ops/apply_repr.py:155"),
        ("repr_scatter", "quantum_basis_tpu/ops/apply_repr.py:229"),
        ("repr_images", "quantum_basis_tpu/ops/sparse.py:208"))]
    record["kernels"][-3]["ell_ms"] = k9["kagome24_k02"]["ell_ms"]
    # repr_rows counts calls: on the entry path a call is two launches, the
    # pre-pass and the walk (and a clear of the label buffer where another
    # basis held it); device_ms sums both (its tag names both),
    # passes_device_ms gives each
    record["kernels"][-3]["launches_count"] = (
        "calls; a call on the entry path launches repr_rows_kernel_pack "
        "and repr_rows_kernel")
    record["kernels"][-3]["passes_device_ms"] = \
        k9["kagome24_k02"].get("passes_device_ms")
    record["kernels"][-1]["launches_count"] = (
        "launches: a build is two, the count pass and the rows")
    # the full-sector ELL build: launches in every build before phase 21,
    # times in phase 21
    build_fields = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "device_ms", "count_ms", "host_gap_ms", "write_ms",
                    "path", "rows_a_warp", "registers")
    record["kernels"].append({
        "name": "ell_rows",
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/ell_build.cu",
        "replaces": "quantum_basis_tpu/ops/sparse.py:156",
        "launches": sum(launches_ell.values()),
        "max_abs_err": ell21["max_abs_err"]["ell_rows"],
        **{f: ell21["chain24_Sz0"][f] for f in build_fields},
        "launches_count": "launches: a build is two, the count pass and "
                          "the rows",
        "launches_by_window": launches_ell,
        "shapes": {t: {f: ell21[t][f] for f in build_fields}
                   for t in ("kagome24_Sz0", "chain26_Sz0", "tJ12_N8_Sz0")}})
    # the ELL apply: launches in the ELL solves of phases 5 and 8, times in
    # phase 22 at the explicit momentum route's sector (phase 8's); bound_ms
    # is the live slots' bound, stored_bound_ms the stored arrays'
    ell_fields = ("ms", "device_ms", "host_ms", "ms_int64", "plain_ms",
                  "bound_ms", "stored_bound_ms", "library_ms",
                  "live_slots_mean", "group")
    record["kernels"].append({
        "name": "ell_spmv",
        "route": "cuda",
        "source": "quantum_basis_tpu_torch/csrc/ell_spmv.cu",
        "replaces": "quantum_basis_tpu/ops/sparse.py:96",
        "launches": sum(ELL_SPMV_LAUNCHES.values()),
        "max_abs_err": ell22["max_abs_err"],
        **{f: ell22["kagome24_k02"][f] for f in ell_fields + ("bound_by",)},
        "launches_by_solve": ELL_SPMV_LAUNCHES,
        "shapes": {t: {f: r[f] for f in ell_fields}
                   for t, r in ell22.items() if t not in ("max_abs_err",
                                                          "kagome24_k02")}})
    print(json.dumps(record))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
