// The thick-restart Krylov basis work for Hopper (sm_90a): the CGS2 step and
// the restart compaction of eigs_smallest (solvers/restarted.py::_Krylov).
//
// Replaces the XLA programs of the JAX package's
// quantum_basis_tpu/solvers/restarted.py::_DeviceOps (:31): `step` (:118,
// with `proj` :81 and `subtract` :97, run by `expand` :184 and, without the
// apply, by `insert_random` :169) and `compact` (:153).
//
// The basis V is (rows, ld) row-major; a step orthogonalizes w = H V[j]
// against its rows 0..r-1 (r = j + 1) twice (classical Gram-Schmidt, CGS2)
// and writes the normalized result into row j + 1:
//
//   h1 = V^H w,  w' = w - V^T h1,  h2 = V^H w',  w'' = w' - V^T h2,
//   beta = ||w''||,  V[j+1] = w'' / beta  (zeroed at beta <= 1e-13),
//
// returning h = h1 + h2 and beta on the device. (V^H conjugates V; V^T h is
// sum_i h_i V_i.) Four kernels, each a pass over the columns:
//   krylov_project          A: partial sums of h1 (reads r rows and w);
//   krylov_subtract_project B: w' = w - V^T h1 and the partial sums of h2,
//                              from one read of the rows and of w;
//   krylov_subtract_norm    C: w'' = w' - V^T h2 into row j + 1 and the
//                              partial sums of ||w''||^2;
//   krylov_scale              row j + 1 scaled in place by 1 / beta, h and
//                              beta written by block 0.
// Each pass ends in a reduction across blocks. Block b writes its partial
// sum of row i to parts[i * P + b] (no atomics), and every block of the next
// pass sums parts[i * P + 0..P-1] itself, in one fixed order (lane-strided,
// then a warp's butterfly), so every block uses the same bits and a run is
// repeatable. On a group of ranks the wrapper all-reduces the partial sums
// (P equal on every rank) between two passes: the same kernels serve one
// device and a group.
//
// Bound: device-memory bytes. The step must read the r rows and w and write
// row j + 1; through three reductions the least is (3r + 7) vectors: r + 1
// (A), r + 2 (B: w read, w' written), r + 2 (C), 2 (the scale). At the
// Hubbard 4x4 f32 basis (n = 165,636,900, 662.5 MB a vector) and r = 8 that
// is 20.5 GB, 6.1 ms at 3.35 TB/s; the torch CGS2 before it (four cuBLAS
// GEMVs and a dozen elementwise ops) moved about (4r + 15) vectors.
//
// Design of passes B, C and the scale: one thread per column, a grid-stride
// loop over columns, 256 threads a block. Pass B holds the first GROUP = 16
// rows of its column in registers between the subtraction and the
// projection, so V is read once; rows past 16 are read once for the
// subtraction and once more by a krylov_project launch that the wrapper adds
// (every solve of the port has r <= 13 at its default ncv). Passes A and C
// take any r (A re-reads w once per group of 16 rows).
//
// Pass A (krylov_project) and the compaction (krylov_compact) stream rows
// through shared memory with Hopper's bulk copies (cp.async.bulk, 1-D TMA)
// where every row is 16-byte aligned: a block is one producer warp, whose
// lane 0 keeps 4 slots in flight (pass A: a run of 256 packs of 16 bytes of
// one row; the compaction: 16 KB, a run of one row or the same run of
// several), each completed on an mbarrier, and 8 consumer warps that read a
// slot, fence, release it and reduce, while the next slots land. Pass A
// gives block b a contiguous range of columns (one of P equal shares) on
// long rows, so each row is one long run per block, and on short rows (below
// 2^22 packs) interleaves the blocks' tiles as passes B and C do; it writes
// the block's sums to parts[i * P + b] as before (the same P, so the step's
// other passes and a mesh's all-reduce are as they were). Without that
// alignment (one entry a load) the consumers load the rows themselves and
// the producer idles.
//
// The compaction (krylov_compact) replaces rows 0..keep in place with
// [S^T V ; V[m]] and zeroes the rows after: a persistent block takes a
// contiguous share of the columns in tiles (the wrapper's plan,
// compact_plan in ops/krylov.py), streams each tile's rows 0..m through the
// ring and adds each into up to 64 running sums in registers (kCompactRegs
// a thread, G threads a column, kWide packs a thread); past 64 sums it
// streams the tile again for each further chunk of 64, keeping the earlier
// chunks in a stash in device memory. Only then does it write rows
// 0..keep-1 (the sums) and row keep (the old V[m], kept in registers); once
// its whole share is read it zeroes the rows past keep in long runs. No
// block writes a column another block reads, and a tile's rows have all
// landed before the tile is written, so V is rewritten in place with no
// hazard. Bytes (m + 1) + rows vectors (and the chunks' re-reads); S's rows
// from m on must be zero (the wrapper checks), so no row past m is read.
// Any m and keep: the staged bytes are the ring's 64 KB.
//
// Measured on the H100 (PERF.md §6, chip_smoke.py phase 19): pass A at
// 90-91% of its byte bound at the Hubbard 4x4 f32 basis, the compaction at
// 82-83%; a plain copy of the compaction's bytes reaches 90%.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;            // rows held in registers by pass B
constexpr int kProjectStages = 4;     // row tiles in flight: pass A's ring
constexpr int kCompactStages = 4;     // and the compaction's (8, 16 no faster)
constexpr int kCompactRegs = 4;       // sums a compaction thread keeps a chunk
constexpr int kBatch = 8;             // loads a thread has in flight, no ring
constexpr int kWide = 4;              // packs a thread takes of a tile's row
constexpr int kSlotPacks = kWide * kThreads;  // a compaction slot: 16 KB
constexpr int kChunk = 64;            // sums a compaction chunk at most
constexpr int kSlotRows = kChunk / kCompactRegs;  // rows a slot at most
// pass A interleaves its blocks' tiles below this many packs a row (the
// order of passes B and C) and gives each block a contiguous share above:
// measured on the H100 (PERF.md §6), interleaved tiles are the faster at
// chain-24's 1.35M packs, a contiguous share at the Hubbard 4x4's 41.4M;
// the crossover between them is not measured
constexpr int64_t kProjectInterleaveBelow = int64_t(1) << 22;
constexpr double kBreakdown = 1e-13;

template <typename R>
struct alignas(2 * sizeof(R)) cplx {
    R re, im;
};

// ---------------------------------------------------------------- arithmetic
__device__ __forceinline__ float fmad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmad(double a, double b, double c) { return fma(a, b, c); }
__device__ __forceinline__ float root(float a) { return sqrtf(a); }
__device__ __forceinline__ double root(double a) { return sqrt(a); }
__device__ __forceinline__ float larger(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double larger(double a, double b) { return fmax(a, b); }

template <typename T> struct Real { using type = T; };
template <typename R> struct Real<cplx<R>> { using type = R; };

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ cplx<float> zero<cplx<float>>() { return {0.f, 0.f}; }
template <> __device__ __forceinline__ cplx<double> zero<cplx<double>>() { return {0.0, 0.0}; }

__device__ __forceinline__ float ld(const float* p) { return __ldg(p); }
__device__ __forceinline__ double ld(const double* p) { return __ldg(p); }
__device__ __forceinline__ cplx<float> ld(const cplx<float>* p) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    return {t.x, t.y};
}
__device__ __forceinline__ cplx<double> ld(const cplx<double>* p) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    return {t.x, t.y};
}

template <typename R>
__device__ __forceinline__ R add(R a, R b) { return a + b; }
template <typename R>
__device__ __forceinline__ cplx<R> add(cplx<R> a, cplx<R> b) {
    return {a.re + b.re, a.im + b.im};
}

template <typename R>
__device__ __forceinline__ R sub(R a, R b) { return a - b; }
template <typename R>
__device__ __forceinline__ cplx<R> sub(cplx<R> a, cplx<R> b) {
    return {a.re - b.re, a.im - b.im};
}

// acc + a * b
template <typename R>
__device__ __forceinline__ R mul_add(R acc, R a, R b) { return fmad(a, b, acc); }
template <typename R>
__device__ __forceinline__ cplx<R> mul_add(cplx<R> acc, cplx<R> a, cplx<R> b) {
    return {fmad(a.re, b.re, fmad(-a.im, b.im, acc.re)),
            fmad(a.re, b.im, fmad(a.im, b.re, acc.im))};
}

// acc + conj(a) * b
template <typename R>
__device__ __forceinline__ R conj_mul_add(R acc, R a, R b) { return fmad(a, b, acc); }
template <typename R>
__device__ __forceinline__ cplx<R> conj_mul_add(cplx<R> acc, cplx<R> a,
                                                cplx<R> b) {
    return {fmad(a.re, b.re, fmad(a.im, b.im, acc.re)),
            fmad(a.re, b.im, fmad(-a.im, b.re, acc.im))};
}

template <typename R>
__device__ __forceinline__ R abs2(R a) { return a * a; }
template <typename R>
__device__ __forceinline__ R abs2(cplx<R> a) { return fmad(a.re, a.re, a.im * a.im); }

template <typename R>
__device__ __forceinline__ R scale(R a, R s) { return a * s; }
template <typename R>
__device__ __forceinline__ cplx<R> scale(cplx<R> a, R s) {
    return {a.re * s, a.im * s};
}

template <typename R>
__device__ __forceinline__ R shfl_xor(R v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}
template <typename R>
__device__ __forceinline__ cplx<R> shfl_xor(cplx<R> v, int m) {
    return {__shfl_xor_sync(0xffffffffu, v.re, m),
            __shfl_xor_sync(0xffffffffu, v.im, m)};
}

// The warp's sum, the same bits in every lane (a butterfly).
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v = add(v, shfl_xor(v, m));
    return v;
}

// ---------------------------------------------------------------- reductions
// coef[i] = sum_p parts[i * P + p] for i < r, into shared memory, in one
// fixed order: every block of a pass gets the same bits.
template <typename T>
__device__ void sum_parts(const T* parts, int P, int r, T* coef) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int i = warp; i < r; i += kWarps) {
        T s = zero<T>();
        for (int p = lane; p < P; p += 32)
            s = add(s, parts[static_cast<int64_t>(i) * P + p]);
        s = warp_sum(s);
        if (lane == 0) coef[i] = s;
    }
    __syncthreads();
}

// A barrier of the kThreads threads that compute: the whole block, or, in a
// kernel whose warp 0 is a producer (kProducer), the named barrier 1 of
// threads 32 .. 32 + kThreads - 1.
template <bool kProducer>
__device__ __forceinline__ void compute_sync() {
    if constexpr (kProducer)
        asm volatile("bar.sync 1, %0;" :: "n"(kThreads) : "memory");
    else
        __syncthreads();
}

// parts[(row0 + q) * P + blockIdx.x] = the block's sum of acc[q], q < cnt.
template <bool kProducer, typename T>
__device__ void store_block_sums(const T (&acc)[kGroup], int cnt, int row0,
                                 T* parts, int P) {
    __shared__ T red[kGroup][kWarps];
    const int tid = kProducer ? static_cast<int>(threadIdx.x) - 32
                              : static_cast<int>(threadIdx.x);
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
        if (q < cnt) {
            const T s = warp_sum(acc[q]);
            if (lane == 0) red[q][warp] = s;
        }
    }
    compute_sync<kProducer>();
    if (tid < cnt) {
        T s = zero<T>();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s = add(s, red[tid][w]);
        parts[static_cast<int64_t>(row0 + tid) * P + blockIdx.x] = s;
    }
    compute_sync<kProducer>();
}

// ---------------------------------------------------------------- packs
// U consecutive entries of a row, moved as one load or store of U *
// sizeof(T) bytes: 16 where the rows allow it (the wrapper's choice), else
// one entry.
template <typename T, int U>
struct alignas(sizeof(T) * U) Pack {
    T v[U];
};

// a compaction thread's kCompactRegs S entries of a row, read at once
template <typename T>
struct alignas(16) SRow {
    T v[kCompactRegs];
};

template <int B> struct Word;
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

// a read-only pack (the rows read by a pass, w): the non-coherent path
template <typename T, int U>
__device__ __forceinline__ Pack<T, U> ldg_pack(const T* p) {
    using W = typename Word<sizeof(T) * U>::type;
    const W t = __ldg(reinterpret_cast<const W*>(p));
    Pack<T, U> x;
    memcpy(&x, &t, sizeof(W));
    return x;
}

// a pack the kernel also writes
template <typename T, int U>
__device__ __forceinline__ Pack<T, U> ld_pack(const T* p) {
    using W = typename Word<sizeof(T) * U>::type;
    const W t = *reinterpret_cast<const W*>(p);
    Pack<T, U> x;
    memcpy(&x, &t, sizeof(W));
    return x;
}

template <typename T, int U>
__device__ __forceinline__ void st_pack(T* p, const Pack<T, U>& x) {
    using W = typename Word<sizeof(T) * U>::type;
    W t;
    memcpy(&t, &x, sizeof(W));
    *reinterpret_cast<W*>(p) = t;
}

// ---------------------------------------------------------------- the ring
// Row tiles (a run of packs of one row, or the same run of several rows)
// land in a ring of kS slots in shared memory by cp.async.bulk (1-D TMA),
// issued by the producer warp; each slot's `full` mbarrier completes when
// its bytes have landed, and its `empty` mbarrier when each consumer warp
// has read the slot (a proxy fence, then one arrival a warp), after which
// the producer refills it.
// The seq-th tile of a block takes slot seq % kS in its phase seq / kS.
template <int kS>
struct Ring {
    static constexpr int stages = kS;
    uint64_t full[kS];
    uint64_t empty[kS];
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
    return a < b ? a : b;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <class R>
__device__ __forceinline__ void ring_init(R& rg) {
    if (threadIdx.x == 0) {
        for (int s = 0; s < R::stages; ++s) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                         :: "r"(smem_u32(&rg.full[s])) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                         :: "r"(smem_u32(&rg.empty[s])), "n"(kWarps)
                         : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
}

// wait for the completion of the barrier's phase of parity `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    } while (!done);
}

// producer: the seq-th slot, `bytes` (a multiple of 16) from src (16-byte
// aligned), once the slot's last use is read
template <class R>
__device__ __forceinline__ void ring_load(R& rg, void* ring,
                                          uint32_t slot_bytes, uint32_t seq,
                                          const void* src, uint32_t bytes) {
    constexpr uint32_t kS = R::stages;
    const uint32_t s = seq % kS;
    if (seq >= kS) mbar_wait(&rg.empty[s], (seq / kS - 1) & 1);
    const uint32_t bar = smem_u32(&rg.full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(static_cast<char*>(ring) + s * slot_bytes)),
           "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// producer warp: the seq-th slot, `nrows` runs of `bytes` from src, src +
// src_stride, ... to the slot's offsets 0, dst_stride, ..., one run a lane
// (lane 0 waits for the slot and sets the bytes it expects first)
template <class R>
__device__ __forceinline__ void ring_load_warp(R& rg, void* ring,
                                               uint32_t slot_bytes,
                                               uint32_t seq, const void* src,
                                               uint32_t bytes, int nrows,
                                               int64_t src_stride,
                                               uint32_t dst_stride) {
    constexpr uint32_t kS = R::stages;
    const uint32_t s = seq % kS;
    const int lane = threadIdx.x & 31;
    const uint32_t bar = smem_u32(&rg.full[s]);
    if (lane == 0) {
        if (seq >= kS) mbar_wait(&rg.empty[s], (seq / kS - 1) & 1);
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                     :: "r"(bar), "r"(bytes * nrows) : "memory");
    }
    __syncwarp();
    char* dst = static_cast<char*>(ring) + s * slot_bytes;
    for (int q = lane; q < nrows; q += 32)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];"
            :: "r"(smem_u32(dst + q * dst_stride)),
               "l"(static_cast<const char*>(src) + q * src_stride),
               "r"(bytes), "r"(bar) : "memory");
}

// consumer: wait until the seq-th slot has landed; returns the slot
template <class R>
__device__ __forceinline__ uint32_t ring_wait(R& rg, uint32_t seq) {
    const uint32_t s = seq % R::stages;
    mbar_wait(&rg.full[s], (seq / R::stages) & 1);
    return s;
}

// consumer: release slot s once the warp has read what it takes of it
template <class R>
__device__ __forceinline__ void ring_release(R& rg, uint32_t s) {
    // the slot's next bytes come through the async proxy (the bulk copy):
    // order these generic reads before them, or the copy may overwrite the
    // slot before a read has taken its pack (seen on the card without it)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncwarp();
    if ((threadIdx.x & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(smem_u32(&rg.empty[s])) : "memory");
}

// A consumer's pack j of the seq-th row tile (tw packs a slot): from the
// ring (kBulk), else loaded from src itself (kRO: through the read-only
// path); zero where !live (src is then not read).
template <bool kBulk, bool kRO, class R, typename T, int U>
__device__ __forceinline__ Pack<T, U> fetch(R& rg, const Pack<T, U>* ring,
                                            int tw, uint32_t seq, int j,
                                            bool live, const T* src) {
    Pack<T, U> x;
#pragma unroll
    for (int u = 0; u < U; ++u) x.v[u] = zero<T>();
    if constexpr (kBulk) {
        const uint32_t s = ring_wait(rg, seq);
        if (live) x = ring[s * tw + j];
        ring_release(rg, s);
    } else {
        if (live) x = kRO ? ldg_pack<T, U>(src) : ld_pack<T, U>(src);
    }
    return x;
}

// ---------------------------------------------------------------- pass A
// parts[i * P + b] = block b's sum of conj(V[i, k]) w[k], r0 <= i < r1, over
// its tiles of kThreads packs (of U columns; nv a row): the contiguous
// share [nv b / P, nv (b + 1) / P), or, where `interleave`, the tiles that
// start at b kThreads, (b + P) kThreads, ... (the order passes B and C walk);
// each tile w's then rows r0.. r1-1's in groups of kGroup (w once a group),
// through the ring where kBulk.
template <typename T, int U, bool kBulk>
__global__ void __launch_bounds__(kThreads + 32)
krylov_project(const T* __restrict__ V, int64_t ld_v, int r0, int r1,
               const T* __restrict__ w, int64_t nv, T* __restrict__ parts,
               int P, int interleave) {
    using Pk = Pack<T, U>;
    __shared__ Ring<kProjectStages> rg;
    extern __shared__ __align__(128) unsigned char ring_raw[];
    Pk* ring = reinterpret_cast<Pk*>(ring_raw);
    const int64_t k0 = interleave ? static_cast<int64_t>(blockIdx.x) * kThreads
                                  : nv * blockIdx.x / P;
    const int64_t k1 = interleave ? nv : nv * (blockIdx.x + 1) / P;
    const int64_t step = interleave ? static_cast<int64_t>(P) * kThreads
                                    : kThreads;
    if constexpr (kBulk) ring_init(rg);
    if (threadIdx.x < 32) {                  // the producer warp
        if (kBulk && threadIdx.x == 0) {
            uint32_t seq = 0;
            for (int g0 = r0; g0 < r1; g0 += kGroup) {
                const int cnt = min(kGroup, r1 - g0);
                for (int64_t k = k0; k < k1; k += step) {
                    const uint32_t bytes = static_cast<uint32_t>(
                        lmin(kThreads, k1 - k) * sizeof(Pk));
                    ring_load(rg, ring, kThreads * sizeof(Pk), seq++,
                              w + k * U, bytes);
                    for (int q = 0; q < cnt; ++q)
                        ring_load(rg, ring, kThreads * sizeof(Pk), seq++,
                                  V + (g0 + q) * ld_v + k * U, bytes);
                }
            }
        }
        return;
    }
    const int tid = threadIdx.x - 32;
    uint32_t seq = 0;
    for (int g0 = r0; g0 < r1; g0 += kGroup) {
        const int cnt = min(kGroup, r1 - g0);
        const T* Vg = V + static_cast<int64_t>(g0) * ld_v;
        T acc[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) acc[q] = zero<T>();
        for (int64_t k = k0; k < k1; k += step) {
            const int64_t kv = k + tid;
            const bool live = kv < lmin(k + kThreads, k1);
            const Pk x = fetch<kBulk, true>(rg, ring, kThreads, seq++, tid,
                                            live, w + kv * U);
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                if (q < cnt) {
                    const Pk v = fetch<kBulk, true>(rg, ring, kThreads, seq++,
                                                    tid, live,
                                                    Vg + q * ld_v + kv * U);
#pragma unroll
                    for (int u = 0; u < U; ++u)
                        acc[q] = conj_mul_add(acc[q], v.v[u], x.v[u]);
                }
            }
        }
        store_block_sums<true>(acc, cnt, g0, parts, P);
    }
}

// s[u] = sum_i coef[i] V[i, kv * U + u] over i < r, the first
// min(r, kGroup) rows' packs kept in v.
template <typename T, int U>
__device__ __forceinline__ void combination(const T* __restrict__ V,
                                            int64_t ld_v, int r, int64_t kv,
                                            const T* coef,
                                            Pack<T, U> (&v)[kGroup],
                                            T (&s)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) s[u] = zero<T>();
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
        if (q < r) {
            v[q] = ldg_pack<T, U>(V + q * ld_v + kv * U);
#pragma unroll
            for (int u = 0; u < U; ++u) s[u] = mul_add(s[u], coef[q], v[q].v[u]);
        }
    }
    for (int i = kGroup; i < r; ++i) {
        const Pack<T, U> t = ldg_pack<T, U>(V + i * ld_v + kv * U);
#pragma unroll
        for (int u = 0; u < U; ++u) s[u] = mul_add(s[u], coef[i], t.v[u]);
    }
}

// ---------------------------------------------------------------- pass B
// w_out = w - sum_i h1_i V_i (h1 from parts_in), and block b's sums of
// conj(V[i, k]) w_out[k] for i < min(r, kGroup) into parts_out.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
krylov_subtract_project(const T* __restrict__ V, int64_t ld_v, int r,
                        const T* __restrict__ parts_in, int P_in,
                        const T* w, T* w_out, int64_t nv,
                        T* __restrict__ parts_out, int P_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* coef = reinterpret_cast<T*>(smem_raw);
    sum_parts(parts_in, P_in, r, coef);
    const int cnt = min(r, kGroup);
    T acc[kGroup];
#pragma unroll
    for (int q = 0; q < kGroup; ++q) acc[q] = zero<T>();
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t kv = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x; kv < nv; kv += stride) {
        Pack<T, U> v[kGroup];
        T s[U];
        Pack<T, U> x = ldg_pack<T, U>(w + kv * U);
        combination<T, U>(V, ld_v, r, kv, coef, v, s);
#pragma unroll
        for (int u = 0; u < U; ++u) x.v[u] = sub(x.v[u], s[u]);
        st_pack<T, U>(w_out + kv * U, x);
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
            if (q < cnt) {
#pragma unroll
                for (int u = 0; u < U; ++u)
                    acc[q] = conj_mul_add(acc[q], v[q].v[u], x.v[u]);
            }
        }
    }
    store_block_sums<false>(acc, cnt, 0, parts_out, P_out);
}

// ---------------------------------------------------------------- pass C
// out = w - sum_i h2_i V_i (h2 from parts_in), and block b's sum of
// |out[k]|^2 into norm_parts[b].
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
krylov_subtract_norm(const T* __restrict__ V, int64_t ld_v, int r,
                     const T* __restrict__ parts_in, int P_in,
                     const T* __restrict__ w, T* __restrict__ out,
                     int64_t nv,
                     typename Real<T>::type* __restrict__ norm_parts) {
    using R = typename Real<T>::type;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* coef = reinterpret_cast<T*>(smem_raw);
    sum_parts(parts_in, P_in, r, coef);
    R acc = R(0);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t kv = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x; kv < nv; kv += stride) {
        Pack<T, U> v[kGroup];
        T s[U];
        Pack<T, U> x = ldg_pack<T, U>(w + kv * U);
        combination<T, U>(V, ld_v, r, kv, coef, v, s);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            x.v[u] = sub(x.v[u], s[u]);
            acc += abs2(x.v[u]);
        }
        st_pack<T, U>(out + kv * U, x);
    }
    __shared__ R red[kWarps];
    acc = warp_sum(acc);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
        R s = R(0);
#pragma unroll
        for (int i = 0; i < kWarps; ++i) s += red[i];
        norm_parts[blockIdx.x] = s;
    }
}

// ---------------------------------------------------------------- the scale
// beta = sqrt(sum of norm_parts); row *= inv with inv = 1 / beta, or 0 at a
// breakdown (beta <= 1e-13) when zero_breakdown, else 1 / max(beta, 1e-13).
// Block 0 writes beta and, when h_out is given, h_out[i * h_stride] = h1_i +
// h2_i for i < r.
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
krylov_scale(T* __restrict__ row, int64_t nv,
             const typename Real<T>::type* __restrict__ norm_parts, int P,
             const T* __restrict__ h1_parts, const T* __restrict__ h2_parts,
             int P_h, int r, T* __restrict__ h_out, int64_t h_stride,
             typename Real<T>::type* __restrict__ beta_out,
             int zero_breakdown) {
    using R = typename Real<T>::type;
    __shared__ R beta_s;
    if (threadIdx.x < 32) {
        R s = R(0);
        for (int p = threadIdx.x; p < P; p += 32) s += norm_parts[p];
        s = warp_sum(s);
        if (threadIdx.x == 0) beta_s = root(s);
    }
    __syncthreads();
    const R beta = beta_s;
    const R bd = static_cast<R>(kBreakdown);
    const R inv = (zero_breakdown && !(beta > bd)) ? R(0)
                                                   : R(1) / larger(beta, bd);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t kv = static_cast<int64_t>(blockIdx.x) * kThreads
                      + threadIdx.x; kv < nv; kv += stride) {
        Pack<T, U> x = ld_pack<T, U>(row + kv * U);
#pragma unroll
        for (int u = 0; u < U; ++u) x.v[u] = scale(x.v[u], inv);
        st_pack<T, U>(row + kv * U, x);
    }
    if (blockIdx.x != 0) return;
    if (threadIdx.x == 0) *beta_out = beta;
    if (h_out == nullptr) return;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* c1 = reinterpret_cast<T*>(smem_raw);
    T* c2 = c1 + r;
    sum_parts(h1_parts, P_h, r, c1);
    sum_parts(h2_parts, P_h, r, c2);
    for (int i = threadIdx.x; i < r; i += kThreads)
        h_out[static_cast<int64_t>(i) * h_stride] = add(c1[i], c2[i]);
}

// ---------------------------------------------------------------- compaction
// In place: V[c] = sum_{i<m} S[i, c] V[i] for c < keep, V[keep] = the old
// V[m], V[keep+1 .. rows-1] = 0. S is (>= m, keep) row-major. Block b takes
// the packs [nv b / grid, nv (b + 1) / grid) in tiles of tw packs (the last
// one short), so that the blocks end together. G = kThreads / tw1 threads
// share a column (tw1 = tw / kWide): a thread takes the kWide packs j, j +
// tw1, ... of a tile's row (j = tid % tw1) and, of each chunk of C = G
// kCompactRegs sums from k0 on, the kCompactRegs sums from k0 + g
// kCompactRegs on (g = tid / tw1), in registers. A ring slot holds G rows
// of a tile (kSlotPacks packs, 16 KB, whatever G), so the bytes in flight
// do not shrink as keep grows; beside it a step's S entries (its rows'
// sums of the chunk) are staged in shared memory, loaded a step ahead. Past
// C sums the tile's rows 0..m are streamed once a chunk (the later times
// mostly from L2) and each chunk but the last is kept in `stash` (global
// memory, (chunks - 1) C tw packs a block, each pack written and read back
// by one thread). Every row of a tile is read, in every chunk, before any
// row of it is written; the rows past keep are zeroed once the whole share
// is read, as long runs of writes (a row's zeros after each tile cost 4-5%
// more at both main-path shapes).
template <typename T, int U, bool kBulk>
__global__ void __launch_bounds__(kThreads + 32)
krylov_compact(T* V, int64_t ld_v, int64_t nv, int rows, int m,
               const T* __restrict__ S, int keep, int tw, T* stash) {
    using Pk = Pack<T, U>;
    constexpr int W = kWide;
    constexpr int kSE = kSlotRows * kChunk / kThreads;   // S entries a thread
    __shared__ Ring<kCompactStages> rg;
    extern __shared__ __align__(128) unsigned char ring_raw[];
    Pk* ring = reinterpret_cast<Pk*>(ring_raw);
    // a slot's S entries (its rows' sums of the chunk), two buffers
    T* sbuf = reinterpret_cast<T*>(
        ring_raw + (kBulk ? kCompactStages * kSlotPacks * sizeof(Pk) : 0));
    const int tw1 = tw / W;
    const int G = kThreads / tw1;                    // and rows a slot
    const int C = G * kCompactRegs;                  // sums a chunk
    const int chunks = keep > C ? (keep + C - 1) / C : 1;
    const int rs = kBulk ? G : kBatch / W;           // rows a step
    const int64_t b0 = nv * blockIdx.x / gridDim.x;
    const int64_t b1 = nv * (blockIdx.x + 1) / gridDim.x;
    if constexpr (kBulk) ring_init(rg);
    if (threadIdx.x < 32) {                  // the producer warp
        if constexpr (kBulk) {
            uint32_t seq = 0;
            for (int64_t c0 = b0; c0 < b1; c0 += tw) {
                const uint32_t bytes = static_cast<uint32_t>(
                    lmin(tw, b1 - c0) * sizeof(Pk));
                for (int k = 0; k < chunks; ++k)
                    for (int i0 = 0; i0 <= m; i0 += G)
                        ring_load_warp(rg, ring, kSlotPacks * sizeof(Pk),
                                       seq++, V + i0 * ld_v + c0 * U, bytes,
                                       min(G, m + 1 - i0), ld_v * sizeof(T),
                                       tw * sizeof(Pk));
            }
        }
        return;
    }
    const int tid = threadIdx.x - 32;
    const int j = tid % tw1, g = tid / tw1;
    Pk* const st = reinterpret_cast<Pk*>(stash)
                   + static_cast<int64_t>(blockIdx.x) * (chunks - 1) * C * tw;
    // the S entries of the step at rows i0.. of the chunk at k0, this
    // thread's share (entry e = row * C + sum), 0 past row m - 1 or keep
    T sreg[kSE];
    auto load_s = [&](int k0, int i0) {
#pragma unroll
        for (int t = 0; t < kSE; ++t) {
            const int e = tid + t * kThreads;
            const int i = i0 + e / C, c = k0 + e % C;
            sreg[t] = (e < rs * C && i < m && c < keep)
                ? ld(S + static_cast<int64_t>(i) * keep + c) : zero<T>();
        }
    };
    uint32_t seq = 0, step = 0;
    load_s(0, 0);
    for (int64_t c0 = b0; c0 < b1; c0 += tw) {
        bool live[W];
        T* Vk[W];
#pragma unroll
        for (int p = 0; p < W; ++p) {
            live[p] = c0 + j + p * tw1 < b1;
            Vk[p] = V + (c0 + j + p * tw1) * U;
        }
        Pk vm[W];
#pragma unroll
        for (int p = 0; p < W; ++p)
#pragma unroll
            for (int u = 0; u < U; ++u) vm[p].v[u] = zero<T>();
        for (int k0 = 0; k0 == 0 || k0 < keep; k0 += C) {
            T acc[kCompactRegs][W][U];
#pragma unroll
            for (int q = 0; q < kCompactRegs; ++q)
#pragma unroll
                for (int p = 0; p < W; ++p)
#pragma unroll
                    for (int u = 0; u < U; ++u) acc[q][p][u] = zero<T>();
            // the step's q-th row, packs x, into the chunk's sums (the
            // thread's kCompactRegs S entries of it contiguous in sb)
            auto take = [&](const T* sb, int q, const Pk (&x)[W]) {
                const SRow<T> sc = *reinterpret_cast<const SRow<T>*>(
                    sb + q * C + g * kCompactRegs);
#pragma unroll
                for (int r = 0; r < kCompactRegs; ++r)
#pragma unroll
                    for (int p = 0; p < W; ++p)
#pragma unroll
                        for (int u = 0; u < U; ++u)
                            acc[r][p][u] = mul_add(acc[r][p][u], sc.v[r],
                                                   x[p].v[u]);
            };
            for (int i0 = 0; i0 <= m; i0 += rs, ++step) {
                const int nr = min(rs, m + 1 - i0);
                const int ns = min(nr, m - i0);      // rows before row m
                // this step's S entries into its buffer, then the next
                // step's loads in flight while this one computes (the
                // barrier also ends every read of the buffer two steps ago)
                T* sb = sbuf + (step & 1) * kSlotRows * kChunk;
#pragma unroll
                for (int t = 0; t < kSE; ++t)
                    if (tid + t * kThreads < rs * C)
                        sb[tid + t * kThreads] = sreg[t];
                compute_sync<true>();
                if (i0 + rs <= m)
                    load_s(k0, i0 + rs);
                else
                    load_s(k0 + C < keep ? k0 + C : 0, 0);
                if constexpr (kBulk) {
                    const uint32_t s = ring_wait(rg, seq++);
                    // past the tile's end the slot holds stale packs: their
                    // sums are never written
                    const Pk* slot = ring + s * kSlotPacks + j;
#pragma unroll 2
                    for (int q = 0; q < ns; ++q) {
                        Pk x[W];
#pragma unroll
                        for (int p = 0; p < W; ++p)
                            x[p] = slot[q * tw + p * tw1];
                        take(sb, q, x);
                    }
                    if (ns < nr)                        // row m
#pragma unroll
                        for (int p = 0; p < W; ++p)
                            vm[p] = slot[ns * tw + p * tw1];
                    ring_release(rg, s);
                } else {
                    // kBatch loads (kBatch / W rows) in flight before
                    // their sums
                    constexpr int B = kBatch / W;
                    Pk xs[B][W];
#pragma unroll
                    for (int q = 0; q < B; ++q)
#pragma unroll
                        for (int p = 0; p < W; ++p)
                            if (q < nr)
                                xs[q][p] = fetch<false, false>(
                                    rg, ring, tw, 0, j, live[p],
                                    Vk[p] + (i0 + q) * ld_v);
#pragma unroll
                    for (int q = 0; q < B; ++q) {
                        if (q < ns) {
                            take(sb, q, xs[q]);
                        } else if (q < nr) {            // row m
#pragma unroll
                            for (int p = 0; p < W; ++p) vm[p] = xs[q][p];
                        }
                    }
                }
            }
            const bool last = k0 + C >= keep;
            // loaded by the threads themselves: all of the tile's loads
            // before its first write
            if constexpr (!kBulk)
                if (last) compute_sync<true>();
#pragma unroll
            for (int p = 0; p < W; ++p) {
                if (!live[p]) continue;
#pragma unroll
                for (int q = 0; q < kCompactRegs; ++q) {
                    const int c = k0 + g * kCompactRegs + q;
                    if (c < keep) {
                        Pk y;
#pragma unroll
                        for (int u = 0; u < U; ++u) y.v[u] = acc[q][p][u];
                        if (last)
                            st_pack<T, U>(Vk[p] + c * ld_v, y);
                        else
                            st[static_cast<int64_t>(c) * tw + j + p * tw1] = y;
                    }
                }
                if (last) {
                    // the earlier chunks' sums this thread kept
                    for (int k = 0; k < k0; k += C)
#pragma unroll
                        for (int q = 0; q < kCompactRegs; ++q) {
                            const int c = k + g * kCompactRegs + q;
                            st_pack<T, U>(Vk[p] + c * ld_v,
                                          st[static_cast<int64_t>(c) * tw + j
                                             + p * tw1]);
                        }
                    if (g == 0) st_pack<T, U>(Vk[p] + keep * ld_v, vm[p]);
                }
            }
        }
    }
    // every row of the share has been read (every one of its loads waited
    // for): the rows past keep, zeroed in long runs
    Pk z;
#pragma unroll
    for (int u = 0; u < U; ++u) z.v[u] = zero<T>();
    for (int i = keep + 1; i < rows; ++i)
        for (int64_t k = b0 + tid; k < b1; k += kThreads)
            st_pack<T, U>(V + i * ld_v + k * U, z);
}

// ---------------------------------------------------------------- launches
int grid_for(int64_t n, int threads, int cap) {
    const int64_t g = (n + threads - 1) / threads;
    return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

// n entries a row in packs of U (the wrapper makes n, the row stride and
// every pointer a multiple of U entries where U > 1); kBulk where the packs
// are 16 bytes (every row 16-byte aligned)
template <typename T, int U, bool kBulk>
int project(const void* V, int64_t ld_v, int r0, int r1, const void* w,
            int64_t n, void* parts, int P, cudaStream_t s) {
    static_assert(kProjectStages * kThreads * 16 <= 48 * 1024,
                  "pass A's ring within the default shared memory");
    const size_t smem =
        kBulk ? kProjectStages * kThreads * sizeof(Pack<T, U>) : 0;
    krylov_project<T, U, kBulk><<<P, kThreads + 32, smem, s>>>(
        static_cast<const T*>(V), ld_v, r0, r1, static_cast<const T*>(w),
        n / U, static_cast<T*>(parts), P,
        n / U < kProjectInterleaveBelow ? 1 : 0);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
int subtract_project(const void* V, int64_t ld_v, int r, const void* parts_in,
                     int P_in, const void* w, void* w_out, int64_t n,
                     void* parts_out, int P, cudaStream_t s) {
    krylov_subtract_project<T, U><<<P, kThreads, r * sizeof(T), s>>>(
        static_cast<const T*>(V), ld_v, r, static_cast<const T*>(parts_in),
        P_in, static_cast<const T*>(w), static_cast<T*>(w_out), n / U,
        static_cast<T*>(parts_out), P);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
int subtract_norm(const void* V, int64_t ld_v, int r, const void* parts_in,
                  int P_in, const void* w, void* out, int64_t n,
                  void* norm_parts, int P, cudaStream_t s) {
    using R = typename Real<T>::type;
    krylov_subtract_norm<T, U><<<P, kThreads, r * sizeof(T), s>>>(
        static_cast<const T*>(V), ld_v, r, static_cast<const T*>(parts_in),
        P_in, static_cast<const T*>(w), static_cast<T*>(out), n / U,
        static_cast<R*>(norm_parts));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int U>
int scale_row(void* row, int64_t n, const void* norm_parts, int P,
              const void* h1_parts, const void* h2_parts, int P_h, int r,
              void* h_out, int64_t h_stride, void* beta_out,
              int zero_breakdown, cudaStream_t s) {
    using R = typename Real<T>::type;
    const int grid = grid_for(n / U, kThreads, 4 * 132);
    const size_t smem = h_out ? 2 * r * sizeof(T) : 0;
    krylov_scale<T, U><<<grid, kThreads, smem, s>>>(
        static_cast<T*>(row), n / U, static_cast<const R*>(norm_parts), P,
        static_cast<const T*>(h1_parts), static_cast<const T*>(h2_parts),
        P_h, r, static_cast<T*>(h_out), h_stride, static_cast<R*>(beta_out),
        zero_breakdown);
    return static_cast<int>(cudaGetLastError());
}

// The compaction's grid for nv packs in tiles of tw: as many persistent
// blocks as the current device holds at once (its shared-memory attribute
// set and its occupancy asked at the first call on that device, and kept,
// one entry a host thread and instantiation), at most one a tile.
template <typename T, int U, bool kBulk>
int compact_grid(int64_t nv, int tw, int* grid, size_t* smem) {
    const auto kern = krylov_compact<T, U, kBulk>;
    *smem = (kBulk ? kCompactStages * kSlotPacks * sizeof(Pack<T, U>) : 0)
            + 2 * kSlotRows * kChunk * sizeof(T);
    thread_local int cached_dev = -1;
    thread_local int64_t resident = 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev != cached_dev) {
        if (*smem > 48 * 1024
            && (e = cudaFuncSetAttribute(
                    kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                    static_cast<int>(*smem))) != cudaSuccess)
            return static_cast<int>(e);
        int sms = 0, per_sm = 0;
        if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                        dev)) != cudaSuccess
            || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kern, kThreads + 32, *smem)) != cudaSuccess)
            return static_cast<int>(e);
        resident = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
        cached_dev = dev;
    }
    const int64_t ntiles = (nv + tw - 1) / tw;
    *grid = static_cast<int>(ntiles < resident ? (ntiles > 0 ? ntiles : 1)
                                               : resident);
    return 0;
}

// the plan (ops/krylov.py::compact_plan): tiles of tw packs, a thread's
// kWide packs of a row at tw / kWide threads a row; stash holds the
// grid's earlier chunks where keep passes a chunk
template <typename T, int U, bool kBulk>
int compact(void* V, int64_t ld_v, int64_t n, int rows, int m,
            const void* S, int keep, int tw, void* stash, cudaStream_t s) {
    if (tw < kWide || tw % kWide != 0 || kThreads % (tw / kWide) != 0
        || kWide * kThreads % tw != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int grid = 0;
    size_t smem = 0;
    const int e = compact_grid<T, U, kBulk>(n / U, tw, &grid, &smem);
    if (e != 0) return e;
    krylov_compact<T, U, kBulk><<<grid, kThreads + 32, smem, s>>>(
        static_cast<T*>(V), ld_v, n / U, rows, m, static_cast<const T*>(S),
        keep, tw, static_cast<T*>(stash));
    return static_cast<int>(cudaGetLastError());
}

template <typename T, int U, bool kBulk>
int compact_blocks(int64_t n, int tw) {
    int grid = 0;
    size_t smem = 0;
    const int e = compact_grid<T, U, kBulk>(n / U, tw, &grid, &smem);
    return e != 0 ? -e : grid;
}

// dtype: 0 float32, 1 float64, 2 complex64, 3 complex128; vec: packs of
// 16 bytes (4, 2, 2, 1 entries) where the wrapper found the rows aligned,
// else one entry
#define QBT_DISPATCH(dtype, vec, fn, ...)                                   \
    switch (dtype) {                                                        \
        case 0: return vec ? fn<float, 4>(__VA_ARGS__)                      \
                           : fn<float, 1>(__VA_ARGS__);                     \
        case 1: return vec ? fn<double, 2>(__VA_ARGS__)                     \
                           : fn<double, 1>(__VA_ARGS__);                    \
        case 2: return vec ? fn<cplx<float>, 2>(__VA_ARGS__)                \
                           : fn<cplx<float>, 1>(__VA_ARGS__);               \
        case 3: return fn<cplx<double>, 1>(__VA_ARGS__);                    \
        default: return static_cast<int>(cudaErrorInvalidValue);           \
    }

// the same, for the kernels that stream rows by bulk copies where vec
#define QBT_DISPATCH_BULK(dtype, vec, fn, ...)                              \
    switch (dtype) {                                                        \
        case 0: return vec ? fn<float, 4, true>(__VA_ARGS__)                \
                           : fn<float, 1, false>(__VA_ARGS__);              \
        case 1: return vec ? fn<double, 2, true>(__VA_ARGS__)               \
                           : fn<double, 1, false>(__VA_ARGS__);             \
        case 2: return vec ? fn<cplx<float>, 2, true>(__VA_ARGS__)          \
                           : fn<cplx<float>, 1, false>(__VA_ARGS__);        \
        case 3: return vec ? fn<cplx<double>, 1, true>(__VA_ARGS__)         \
                           : fn<cplx<double>, 1, false>(__VA_ARGS__);       \
        default: return static_cast<int>(cudaErrorInvalidValue);           \
    }

}  // namespace

extern "C" int qbt_krylov_project(int dtype, int vec, const void* V,
                                  int64_t ld_v,
                                  int r0, int r1, const void* w, int64_t n,
                                  void* parts, int P, void* stream) {
    QBT_DISPATCH_BULK(dtype, vec, project, V, ld_v, r0, r1, w, n, parts, P,
                 static_cast<cudaStream_t>(stream))
}

extern "C" int qbt_krylov_subtract_project(int dtype, int vec,
                                           const void* V,
                                           int64_t ld_v, int r,
                                           const void* parts_in, int P_in,
                                           const void* w, void* w_out,
                                           int64_t n, void* parts_out, int P,
                                           void* stream) {
    QBT_DISPATCH(dtype, vec, subtract_project, V, ld_v, r, parts_in, P_in, w,
                 w_out, n, parts_out, P, static_cast<cudaStream_t>(stream))
}

extern "C" int qbt_krylov_subtract_norm(int dtype, int vec, const void* V,
                                        int64_t ld_v, int r,
                                        const void* parts_in, int P_in,
                                        const void* w, void* out, int64_t n,
                                        void* norm_parts, int P,
                                        void* stream) {
    QBT_DISPATCH(dtype, vec, subtract_norm, V, ld_v, r, parts_in, P_in, w, out, n,
                 norm_parts, P, static_cast<cudaStream_t>(stream))
}

extern "C" int qbt_krylov_scale(int dtype, int vec, void* row, int64_t n,
                                const void* norm_parts, int P,
                                const void* h1_parts, const void* h2_parts,
                                int P_h, int r, void* h_out, int64_t h_stride,
                                void* beta_out, int zero_breakdown,
                                void* stream) {
    QBT_DISPATCH(dtype, vec, scale_row, row, n, norm_parts, P, h1_parts, h2_parts,
                 P_h, r, h_out, h_stride, beta_out, zero_breakdown,
                 static_cast<cudaStream_t>(stream))
}

extern "C" int qbt_krylov_compact(int dtype, int vec, void* V,
                                  int64_t ld_v,
                                  int64_t n, int rows, int m, const void* S,
                                  int keep, int tw, void* stash,
                                  void* stream) {
    QBT_DISPATCH_BULK(dtype, vec, compact, V, ld_v, n, rows, m, S, keep, tw,
                      stash, static_cast<cudaStream_t>(stream))
}

// the compaction's grid on the current device (blocks; negative: a CUDA
// error), for the wrapper to size the stash
extern "C" int qbt_krylov_compact_blocks(int dtype, int vec, int64_t n,
                                         int tw) {
    QBT_DISPATCH_BULK(dtype, vec, compact_blocks, n, tw)
}
