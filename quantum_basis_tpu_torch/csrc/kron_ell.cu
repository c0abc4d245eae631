// Fused ELL apply of a tensor-factorized sector Hamiltonian for Hopper (sm_90a).
//
// For every output entry (r, c) of the caller's rows of the state matrix psi
// (row-major, nrows x nb), with A's and B's ELL rows written Ac[r,k] etc.:
//
//   y[r, c] = sum_k Av[r,k] * psi_full[Ac[r,k], c]                (A side)
//           + sum_k Bv[c,k] * psi[r, Bc[c,k]]                     (B side)
//           + (adiag[r] + bdiag[c] + s * P[r,c]) * psi[r, c]      (diagonal)
//
// Replaces the XLA program of the JAX package's ELL layout,
// quantum_basis_tpu/ops/apply_kron.py::KronOp.apply (layout="ell", :138-146,
// the slot loop :186-191), which applies each ELL slot as a gather over the
// whole frame plus an FMA. psi_full is the matrix the A side gathers rows
// from: psi itself on one device, the all-gathered state on a group of ranks
// (A's rows are then the rank's, its columns global). P (optional) is int8
// or float32.
//
// Slots. A and B are the factors' off-diagonal parts in ELL form, slot-major
// (W, m) with a count of live slots per row (the build packs them left), in
// one of two forms, chosen by type and shape in
// ops/apply_kron.py::pack_slots:
//   compact: one 32-bit word a slot, the column in the low 16 bits and an
//            index into the factor's table of distinct values in the high 16
//            (float64 factors of dim up to 65,535 with up to 65,536 values;
//            the Hubbard 4x4 factor's table holds -1, 0, 1): 4 bytes a slot
//            against 12 took the f64 apply at 4x4 from 7.9 to 6.6 ms;
//   wide:    int32 columns beside the values (every float32 factor, where
//            the compact form was no faster at 4x4, 3.96 against 3.92 ms,
//            and any other float64 factor).
// pack_slots also reorders each row's live slots so that the 8 rows of a
// quarter-warp gather from distinct shared-memory bank groups where they can
// (source row j's 16 bytes lie in bank group j % 8).
//
// Bound: device-memory bytes. One apply must read psi (and psi_full) once,
// P once and write y once: 0.446 ms in f32 at Hubbard 4x4 (12870 x 12870,
// 3.35 TB/s), 0.842 ms in f64. The two sides gather along different axes of
// psi, so no one order of the grid keeps both on chip, and the apply is two
// passes; their floor in device memory is pass 1 reading psi_full and writing
// its sums, pass 2 reading psi, those sums and P and writing y: 3.48 GB,
// 1.04 ms in f32 (6.8 GB, 2.0 ms in f64).
//
// What held the first version back (7.0 ms f32, 11.8 ms f64 at 4x4, 3.36 and
// 3.60 ms a pass in f32): its pass 1 gave each output entry a thread that
// gathered ~17 whole psi rows from L2 (~11.3 GB of L2 reads an f32 apply; no
// row order helps: reverse Cuthill-McKee still leaves 5-16 distinct
// neighbour rows per output row at blocks of 4-512 rows); its pass 2 staged
// 4 psi rows per 1024-thread CTA with a plain copy and a barrier and re-read
// B's 8-byte slots once per 4 rows (~5.7 GB from L2), gathering with scalar
// 4-byte shared loads. A single pass with B in registers ran 9.7-10.5 ms.
//
// This design: one gather engine serves both passes. A CTA stages a panel of
// the gather source in shared memory as [j][C], C = 16 bytes / sizeof(T)
// (4 f32, 2 f64), so that one 16-byte shared load brings all C values of
// source row j; each thread then owns output rows, walks their slots and
// accumulates C outputs:
//   kron_ell_a (pass 1): the panel is C columns of psi_full over all its
//     rows (206 KB at 4x4), outputs are psi's rows; writes z = A psi_full
//     into scratch of psi's size laid out as [row / B][column][row % B], B
//     = 32 bytes / sizeof(T), so that a warp writes whole 32-byte sectors.
//   kron_ell_b (pass 2): the panel is C rows of psi, transposed while it is
//     staged, outputs are psi's columns; y = z + the B side + the diagonal
//     and the coupling, with z's C values of an output one aligned 16-byte
//     load, issued with P's and the diagonals' before the output's slots so
//     that their latency hides behind the gathers; y is written once.
// Pass 1 reads psi_full about once instead of ~17 times; both passes issue C
// times fewer gather instructions, as 16-byte shared loads; the slots, the
// only thing re-read from L2 (once per panel), are 4 bytes a slot. The
// staging is cp.async, 16 bytes a source row in pass 1 where its rows are
// 16-byte aligned. CTAs are persistent (one per SM where the panel needs
// most of the shared memory), walk panels p, p + grid, ..., and each starts
// its walk over rows at its own offset (a multiple of 32); each panel is
// staged after the last one's gathers end (one panel of 206 KB fills a
// CTA's shared memory at 4x4). A gather axis too long for one panel (above
// 14,528) gathers straight from device memory (the "global" branch; the
// wide-rows case of chip_smoke.py's phase 17).
//
// What each measure did (at 4x4 on an NVIDIA H100 80GB HBM3, 700 W, timed
// with CUDA events in turns against variants of this source; PERF.md
// section 6): this design with pass 1 writing y directly, 4 bytes a
// store at a row stride, and pass 2 reading y after its slots ran 7.5 ms
// f32 (11.3 f64); 8- and 16-byte stores with pass 2's loads issued before
// its slots 5.7 (9.1); z in the transposed layout (nb, nrows) 4.6 (8.9); z
// in sector blocks, with each CTA's start row a multiple of 32, 3.9 (8.1);
// 16-byte staging copies 3.9 (6.6). Rotating each CTA's start row took
// pass 2 from 3.4 to 2.8 ms in the first cut (CTAs in step read the same
// slot lines at once); the bank-aware slot order takes 0.35 ms off in f32
// and 0.2 in f64. Tried and dropped: 8-byte panel rows (C = 2 f32, two
// panels double-buffered or one), 512 threads a CTA, 8 slots in flight,
// slot words loaded a group ahead, slot loads that skip L1, the value
// table in registers (1.5 ms slower), pass 1 staged through registers with
// loads that skip L1 (0.5 ms slower), no start-row offset for the staging
// (slower in f32): none was faster. Two 16-byte panels double-buffered fit
// only gather axes up to 7,264 (factor dims 70 and 924, whose applies are
// launch-bound); no shape of the 4x4, the gap sectors or KronSharded fits
// them, so there is one panel, and overlapping its staging with the
// gathers on the main shape is open (ROADMAP).
// What bounds it now (f32): the gathers' wavefronts in the L1 / shared-
// memory data stage: without pass 1's stores and pass 2's epilogue it takes
// 91% of its time, without also the slot loads and with conflict-free
// gathers 59%; pass 1's staging at a row stride (0.5 ms of its 1.85); the
// warps' spread of slot counts (the longest row of a warp sets its trip
// count, 1.33 x the mean at 4x4: with every count set to 17 the apply
// takes 3.4 ms, not 3.9); and each panel's barriers.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 1024;       // threads of a CTA
constexpr int kPanelBytes = 16;      // bytes of one staged source row
constexpr int kSectorBytes = 32;     // device memory's unit of access
constexpr int kSmemMax = 232448;     // shared memory a CTA may opt in to (sm_90)

template <typename T>
struct Side {
    const int* slots;   // (W, m): compact words or int32 columns
    const T* vals;      // compact: the table of values; wide: (W, m) values
    const int* cnt;     // (m,) live slots per row
};

template <typename T>
struct Args {
    Side<T> A, B;
    const T* __restrict__ adiag;
    const T* __restrict__ bdiag;
    const void* __restrict__ P;
    int p_kind;         // 0 none, 1 int8, 2 float32
    T ps;
    const T* __restrict__ psi;
    const T* __restrict__ psi_full;
    T* __restrict__ y;
    T* __restrict__ z;  // pass 1's A psi_full, in sector blocks (see apply)
    int nrows, nfull, nb;
};

// C values of one source row, one 16-byte shared load
template <typename T, int C>
struct alignas(C * sizeof(T)) Vec {
    T v[C];
};

// Slot o of a side: its column and value (a compact side's from its
// table, which a warp reads as one line of L1).
template <typename T, bool COMPACT>
__device__ __forceinline__ void slot(const Side<T>& s, int o, int& col,
                                     T& val) {
    if constexpr (COMPACT) {
        const unsigned w = __ldg(reinterpret_cast<const unsigned*>(s.slots)
                                 + o);
        col = static_cast<int>(w & 0xffffu);
        val = __ldg(s.vals + (w >> 16));
    } else {
        col = __ldg(s.slots + o);
        val = __ldg(s.vals + o);
    }
}

// Side 0 (pass 1): outputs are psi's rows, the source psi_full's rows at C
// columns from c0. Side 1 (pass 2): outputs are psi's columns, the source
// psi's columns at C rows from c0 (psi transposed).
template <typename T, int C, int SIDE>
__device__ __forceinline__ Vec<T, C> load_global(const Args<T>& a, int j,
                                                 int c0) {
    Vec<T, C> g;
#pragma unroll
    for (int q = 0; q < C; ++q) {
        if constexpr (SIDE == 0)
            g.v[q] = c0 + q < a.nb
                ? __ldg(a.psi_full + static_cast<int64_t>(j) * a.nb + c0 + q)
                : T(0);
        else
            g.v[q] = c0 + q < a.nrows
                ? __ldg(a.psi + static_cast<int64_t>(c0 + q) * a.nb + j)
                : T(0);
    }
    return g;
}

// Stage panel c0 of the source into slab[0, n) with cp.async, the CTA
// starting at row j0 (see gather_panels). Pass 1 copies each source row's
// C values as one 16-byte piece where psi_full's rows are 16-byte aligned
// and the panel is whole; else thread e of the CTA copies value e % C of
// row e / C, so that a warp writes 128 contiguous bytes of shared memory.
template <typename T, int C, int SIDE>
__device__ __forceinline__ void stage(const Args<T>& a, Vec<T, C>* slab,
                                      int n, int c0, int j0) {
    if constexpr (SIDE == 0) {
        if (c0 + C <= a.nb && a.nb % C == 0
                && reinterpret_cast<uintptr_t>(a.psi_full) % sizeof(Vec<T, C>)
                   == 0) {
            for (int j1 = threadIdx.x; j1 < n; j1 += kThreads) {
                const int j = j1 + j0 < n ? j1 + j0 : j1 + j0 - n;
                __pipeline_memcpy_async(
                    slab + j, a.psi_full + static_cast<int64_t>(j) * a.nb + c0,
                    sizeof(Vec<T, C>));
            }
            return;
        }
    }
    T* dst = reinterpret_cast<T*>(slab);
    for (int e0 = threadIdx.x; e0 < n * C; e0 += kThreads) {
        int e = e0 + j0 * C;
        if (e >= n * C) e -= n * C;
        const int j = e / C, q = e % C;
        const T* src;
        bool ok;
        if constexpr (SIDE == 0) {
            ok = c0 + q < a.nb;
            src = a.psi_full + static_cast<int64_t>(j) * a.nb + c0 + q;
        } else {
            ok = c0 + q < a.nrows;
            src = a.psi + static_cast<int64_t>(c0 + q) * a.nb + j;
        }
        if (ok)
            __pipeline_memcpy_async(dst + e, src, sizeof(T));
        else
            dst[e] = T(0);
    }
}

// The gather engine of both passes. The CTA walks panels blockIdx.x,
// blockIdx.x + gridDim.x, ...; for each it stages the source panel
// (STAGED), then every thread walks the slots of its output rows i and
// accumulates C outputs.
// Each CTA starts its walks over rows (and the staging over source rows) at
// its own offset: CTAs that walk in step read the same slot lines of L2 at
// the same moment.
template <typename T, int SIDE, bool COMPACT, bool STAGED>
__device__ __forceinline__ void gather_panels(const Args<T>& a) {
    constexpr int C = kPanelBytes / sizeof(T);
    // z holds A psi_full as [row / B][column][row % B]: pass 1's warp writes
    // B rows of a column as one sector, pass 2 reads C rows as 16 bytes
    constexpr int B = kSectorBytes / sizeof(T);
    using V = Vec<T, C>;
    extern __shared__ __align__(16) unsigned char smem[];
    V* slab = reinterpret_cast<V*>(smem);
    const Side<T>& s = SIDE == 0 ? a.A : a.B;
    const int m = SIDE == 0 ? a.nrows : a.nb;      // outputs
    const int n = SIDE == 0 ? a.nfull : a.nb;      // the gather axis
    const int width = SIDE == 0 ? a.nb : a.nrows;  // the axis panels cut
    const int npanel = (width + C - 1) / C;
    const int stride = gridDim.x;

    // multiples of 32: a warp's rows stay in whole blocks of z, and its
    // copies in whole segments
    const int i0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * m
                                    / gridDim.x) / 32 * 32;
    const int j0 = static_cast<int>(static_cast<int64_t>(blockIdx.x) * n
                                    / gridDim.x) / 32 * 32;
    if constexpr (STAGED) {
        if (blockIdx.x < npanel)
            stage<T, C, SIDE>(a, slab, n, blockIdx.x * C, j0);
        __pipeline_commit();
    }
    for (int p = blockIdx.x; p < npanel; p += stride) {
        const int c0 = p * C;
        if constexpr (STAGED) {
            __pipeline_wait_prior(0);
            __syncthreads();
        }
        for (int t = threadIdx.x; t < m; t += kThreads) {
            const int i = t + i0 < m ? t + i0 : t + i0 - m;
            const int cnt = __ldg(s.cnt + i);
            T acc[C];
#pragma unroll
            for (int q = 0; q < C; ++q) acc[q] = T(0);
            // pass 2: y + (a + b + s P) psi at (r, i), r = c0 + q, loaded
            // before the slots, so that their latency hides behind them
            T pre[C];
            if constexpr (SIDE == 1) {
                const V self = STAGED ? slab[i]
                                      : load_global<T, C, SIDE>(a, i, c0);
                const T bd = __ldg(a.bdiag + i);
#pragma unroll
                for (int q = 0; q < C; ++q) {
                    const int r = c0 + q < a.nrows ? c0 + q : a.nrows - 1;
                    const int64_t idx = static_cast<int64_t>(r) * a.nb + i;
                    T d = __ldg(a.adiag + r) + bd;
                    if (a.p_kind == 1)
                        d += a.ps * static_cast<T>(__ldg(
                            static_cast<const int8_t*>(a.P) + idx));
                    else if (a.p_kind == 2)
                        d += a.ps * static_cast<T>(__ldg(
                            static_cast<const float*>(a.P) + idx));
                    pre[q] = d * self.v[q];
                }
                // pass 1's sums at (r, i), one aligned vector of z
                const V za = *reinterpret_cast<const V*>(
                    a.z + (static_cast<int64_t>(c0 / B) * a.nb + i) * B
                    + c0 % B);
#pragma unroll
                for (int q = 0; q < C; ++q) pre[q] += za.v[q];
            }
            // four slots, then four gathers in flight per thread; the last
            // group predicated
            for (int k = 0; k < cnt; k += 4) {
                int col[4];
                T val[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    col[u] = 0;
                    val[u] = T(0);
                    if (k + u < cnt)
                        slot<T, COMPACT>(s, (k + u) * m + i, col[u], val[u]);
                }
                V g[4];
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    g[u] = STAGED ? slab[col[u]]
                                  : load_global<T, C, SIDE>(a, col[u], c0);
#pragma unroll
                for (int u = 0; u < 4; ++u)
                    if (k + u < cnt)
#pragma unroll
                        for (int q = 0; q < C; ++q)
                            acc[q] += val[u] * g[u].v[q];
            }
            if constexpr (SIDE == 0) {
                // the A side at (i, c0 + q): a warp writes whole sectors
                T* out = a.z + (static_cast<int64_t>(i / B) * a.nb + c0) * B
                         + i % B;
#pragma unroll
                for (int q = 0; q < C; ++q)
                    if (c0 + q < a.nb) out[q * B] = acc[q];
            } else {
                // y[r, i] = the A side + the B side + (a + b + s P) psi
#pragma unroll
                for (int q = 0; q < C; ++q)
                    if (c0 + q < a.nrows)
                        a.y[static_cast<int64_t>(c0 + q) * a.nb + i] =
                            pre[q] + acc[q];
            }
        }
        if constexpr (STAGED) {
            __syncthreads();   // every gather from this panel is done
            if (p + stride < npanel)
                stage<T, C, SIDE>(a, slab, n, (p + stride) * C, j0);
            __pipeline_commit();
        }
    }
}

// Pass 1: y = A psi_full.
template <typename T, bool COMPACT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
kron_ell_a(const Args<T> a) {
    gather_panels<T, 0, COMPACT, STAGED>(a);
}

// Pass 2: y += psi B^T + (a (+) b + s P) o psi.
template <typename T, bool COMPACT, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
kron_ell_b(const Args<T> a) {
    gather_panels<T, 1, COMPACT, STAGED>(a);
}

template <typename T, int SIDE, bool COMPACT, bool STAGED>
int launch(const Args<T>& a, int smem, cudaStream_t stream) {
    void (*kern)(const Args<T>) = SIDE == 0
        ? kron_ell_a<T, COMPACT, STAGED>
        : kron_ell_b<T, COMPACT, STAGED>;
    cudaError_t e = cudaSuccess;
    if (smem > 48 * 1024)
        e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int dev = 0, sms = 0, per_sm = 0;
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                          kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    constexpr int C = kPanelBytes / sizeof(T);
    const int width = SIDE == 0 ? a.nb : a.nrows;
    const int npanel = (width + C - 1) / C;
    const int grid = npanel < per_sm * sms ? npanel : per_sm * sms;
    kern<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
}

// One pass, its branch chosen by the length of its gather axis: a staged
// panel ("staged"), or gathers from device memory ("global"); and by the
// side's slot form: compact (float64 only, see the C interface) or wide.
template <typename T, int SIDE>
int pass(const Args<T>& a, int compact, cudaStream_t stream) {
    const int64_t n = SIDE == 0 ? a.nfull : a.nb;
    const int64_t panel = n * kPanelBytes;
    const bool staged = panel <= kSmemMax;
    const int smem = staged ? static_cast<int>(panel) : 0;
    if constexpr (sizeof(T) == sizeof(double)) {
        if (compact)
            return staged ? launch<T, SIDE, true, true>(a, smem, stream)
                          : launch<T, SIDE, true, false>(a, smem, stream);
    } else if (compact) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return staged ? launch<T, SIDE, false, true>(a, smem, stream)
                  : launch<T, SIDE, false, false>(a, smem, stream);
}

template <typename T>
int apply(const int* as, const T* av, const int* acnt, int a_compact,
          const int* bs, const T* bv, const int* bcnt, int b_compact,
          const T* adiag, const T* bdiag, const void* P, int p_kind,
          double ps, const T* psi, const T* psi_full, T* y, T* z,
          int nrows, int nfull, int nb, cudaStream_t stream) {
    if (nrows < 0 || nfull < 0 || nb < 0 || p_kind < 0 || p_kind > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nrows == 0 || nb == 0) return 0;
    const Args<T> a{{as, av, acnt}, {bs, bv, bcnt}, adiag, bdiag, P, p_kind,
                    static_cast<T>(ps), psi, psi_full, y, z, nrows, nfull,
                    nb};
    const int err = pass<T, 0>(a, a_compact, stream);
    if (err != 0) return err;
    return pass<T, 1>(a, b_compact, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns a cudaError_t value; 0 is
// success. Each side is (slots, values, counts, compact): slots (W, m)
// int32, slot-major; compact != 0 (float64 only; float32 returns
// cudaErrorInvalidValue): slots are words (column | value index << 16) and
// values the table; else slots are columns and values (W, m). A's m
// is nrows and its columns index psi_full's nfull rows; B's m is nb. p_kind:
// 0 no coupling (P may be NULL), 1 int8 P, 2 float32 P. psi and y are the
// caller's (nrows, nb) rows, psi_full (nfull, nb); z is scratch of nb * nrows
// values, nrows rounded up to a multiple of B = 32 / sizeof(T); y and z
// alias nothing. Two kernels launch on the stream: kron_ell_a (writes z),
// then kron_ell_b (reads z, writes y).
extern "C" int qbt_kron_ell_f32(const int* as, const float* av,
                                const int* acnt, int a_compact,
                                const int* bs, const float* bv,
                                const int* bcnt, int b_compact,
                                const float* adiag, const float* bdiag,
                                const void* P, int p_kind, double ps,
                                const float* psi, const float* psi_full,
                                float* y, float* z, int nrows, int nfull,
                                int nb, void* stream) {
    return apply<float>(as, av, acnt, a_compact, bs, bv, bcnt, b_compact,
                        adiag, bdiag, P, p_kind, ps, psi, psi_full, y, z,
                        nrows, nfull, nb, static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_kron_ell_f64(const int* as, const double* av,
                                const int* acnt, int a_compact,
                                const int* bs, const double* bv,
                                const int* bcnt, int b_compact,
                                const double* adiag, const double* bdiag,
                                const void* P, int p_kind, double ps,
                                const double* psi, const double* psi_full,
                                double* y, double* z, int nrows,
                                int nfull, int nb, void* stream) {
    return apply<double>(as, av, acnt, a_compact, bs, bv, bcnt, b_compact,
                         adiag, bdiag, P, p_kind, ps, psi, psi_full, y, z,
                         nrows, nfull, nb, static_cast<cudaStream_t>(stream));
}
