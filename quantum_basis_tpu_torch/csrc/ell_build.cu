// The explicit (ELL) build of a full or quantum-number sector for Hopper
// (sm_90a): ell_rows, each row's finished ELL entries in one pass over the
// row's images, no (rows, E) intermediate in device memory.
//
// Replaces the XLA program of the JAX package's build,
// quantum_basis_tpu/ops/sparse.py::build_sparse_full (:156; its images from
// _block_images and the index lookup, a block at a time) and the host
// compaction after it (_extract_blocks :120, _compact_rows_np :30). The
// port's plain version, ops/ell_build.py::_ell_rows_plain, repeats that
// with torch ops: (rows, E, arity) slot gathers, the lookup, then
// compact_rows' sorts and E - 1 passes over the block.
//
// Row i (label l) of H: for every image column e = (group, term, image k)
// of the operator's packed tables (ops/apply.py::pack_rows), decoded as
// csrc/apply_rows.cu decodes it: the joint column c of l's values on the
// term's slots (from the label's bit fields, or from the row's V), entry
// off[e] + c = (amplitude A, displacement d), A = 0 padding; the
// Jordan-Wigner sign (-1) ** popcount(Fodd_i & wmask[e]) folds into A; the
// column j is the row of l + d in the basis index (direct int32 position
// table, lin or a binary search, clamped as basis/index.py::lookup_tables
// clamps: an image always lands in the sector), the value conj(A), float64
// where every amplitude is real, else complex128. Then the row stage of
// csrc/ell_rows.cuh drops, sorts, merges and stores the row.
//
// Design: a warp a row, a lane an image column (e = lane, lane + 32, ...),
// so the lookups of a row's images are in flight together and the row's
// entries are stored as contiguous segments; a persistent grid of as many
// blocks as are resident walks the rows; each block stages the columns'
// records and entries in shared memory where they fit
// ops/apply.py::TABLES_SHARED_MAX, else reads them through the cache. A
// block has 8 warps, fewer where the rows' scratch (about 12-24 bytes an
// image column, ell_rows::scratch_bytes) is too wide for 8 to fit in its
// shared memory; where not one warp's fits (E past some 9,000 columns)
// the scratch lives in a device buffer the wrapper allocates
// (ell_rows::plan, qbt_ell_rows_scratch), so a row of any E builds. A
// build is two launches (ops/ell_build.py::two_pass): a count pass that
// stores each warp's widest row (one atomicMax a warp), from which the
// wrapper takes the sector's width W (its one host sync), then the pass
// that writes (n, W) columns and values.
//
// Bound: device-memory bytes. A build must read each row's label (and Fodd
// where fermionic) once, the index entries its images touch, and write the
// finished ELL once, 16 or 24 bytes an entry of (n, W); chip_smoke.py
// computes it from each run's data. What the kernel adds to that: the V
// row where the local dims are not powers of two, and the count pass's
// second reading.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;          // a block's shared memory, sm_90

// word 0 of a column record (ops/apply.py::pack_rows): the offset of its
// entries (bits 0-27), arity > 2 (bit 31); words 2, 3: wmask
constexpr unsigned kOffset = (1u << 28) - 1;
constexpr unsigned kGeneric = 1u << 31;

enum { kDirect = 0, kLin = 1, kBsearch = 2 };

// Mirrored field by field by ops/ell_build.py::_Params (ctypes); the
// wrapper checks qbt_ell_params_size() against its own size.
struct Params {
    const int4* rec;            // (E,) column records
    const long long* ad;        // (M, 2) or (M, 4): amplitude bits and dlt
    const int* gsel;            // (E, A) slot selectors (arity > 2) or null
    const int* gstr;            // (E, A) joint strides (arity > 2) or null
    const void* t0;             // position table (int32), Ja, or the
                                // sorted labels (int64)
    const long long* t1;        // Jb (lin) or null
    const long long* labels;    // (>= rows,) the rows' labels
    const signed char* V;       // (>= rows, S) their slot values
    const long long* fodd;      // (>= rows,) or null
    int* cols;                  // (rows, W) the finished rows
    double* vals;               // (rows, W) or (rows, W, 2)
    int* width;                 // the count pass: the widest row
    unsigned char* row_scratch; // the rows' scratch where it is not in
                                // shared memory (ell_rows::plan), or null
    long long M, sa, label_space, n, rows;
    long long row_blocks;       // the blocks row_scratch holds
    long long row_shared;       // a block's shared memory the build takes
    int E, A, S, amp_c, bits, tabs_shared, mode, absent, W, write, sa_shift;
};

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Bytes of the staged tables (records, then entries), where staged.
__host__ __device__ inline long long tables_bytes(const Params& p) {
    return p.tabs_shared
               ? ell_rows::a16(16ll * p.E)
                     + ell_rows::a16(8ll * (p.amp_c ? 4 : 2) * p.M)
               : 0;
}

__host__ __device__ inline long long warp_bytes(const Params& p) {
    return ell_rows::scratch_bytes(p.E, p.amp_c ? 16 : 8);
}

inline ell_rows::Plan row_plan(const Params& p) {
    return ell_rows::plan(tables_bytes(p), warp_bytes(p), kWarps,
                          p.row_shared < kMaxShared ? p.row_shared
                                                    : kMaxShared);
}

// The row of label t (basis/index.py::lookup_tables).
template <int MODE>
__device__ __forceinline__ long long find_row(const Params& p, long long t) {
    if constexpr (MODE == kDirect) {
        const long long j = __ldg(static_cast<const int*>(p.t0)
                                  + clampll(t, 0, p.label_space - 1));
        return p.absent ? min(j, p.n - 1) : j;
    } else if constexpr (MODE == kLin) {
        const long long v = clampll(t, 0, p.label_space - 1);
        long long a, b;
        if (p.sa_shift >= 0) {
            b = v >> p.sa_shift;
            a = v & (p.sa - 1);
        } else {
            b = v / p.sa;
            a = v - b * p.sa;
        }
        return clampll(__ldg(static_cast<const long long*>(p.t0) + a)
                           + __ldg(p.t1 + b),
                       0, p.n - 1);
    } else {                            // lower bound over the labels
        const long long* sorted = static_cast<const long long*>(p.t0);
        long long base = 0, len = p.n;
        while (len > 1) {
            const long long half = len >> 1;
            if (__ldg(sorted + base + half) < t) base += half;
            len -= half;
        }
        return min(base + (__ldg(sorted + base) < t ? 1 : 0), p.n - 1);
    }
}

template <class T>
__device__ __forceinline__ T conj_value(double re, double im);
template <>
__device__ __forceinline__ double conj_value<double>(double re, double) {
    return re;
}
template <>
__device__ __forceinline__ double2 conj_value<double2>(double re, double im) {
    return make_double2(re, -im);
}

// Image column e of a row with label l (slot values vrow where the dims
// are not powers of two, odd-count slots fo): (j, conj(A) sign) into
// (col, v); v left 0 where the image is padding.
template <int MODE, bool AMP_C, class T>
__device__ __forceinline__ void image(const Params& p, const int4* rec,
                                      const long long* ad, long long l,
                                      const signed char* vrow,
                                      unsigned long long fo, int e,
                                      long long& col, T& v) {
    const int4 rc = rec[e];
    const unsigned w0 = static_cast<unsigned>(rc.x);
    const unsigned w = static_cast<unsigned>(rc.y);
    const unsigned long long lu = static_cast<unsigned long long>(l);
    int c;
    if (w0 & kGeneric) {                // arity > 2: a loop over its slots
        c = 0;
        for (int a = 0; a < p.A; ++a) {
            const int sel = __ldg(p.gsel + e * p.A + a);
            const int val = p.bits
                                ? static_cast<int>(lu >> (sel & 63)) & (sel >> 8)
                                : static_cast<int>(vrow[sel]);
            c += val * __ldg(p.gstr + e * p.A + a);
        }
    } else if (p.bits) {
        const unsigned m0 = (w >> 16) & 255u;
        const unsigned v0 = static_cast<unsigned>(lu >> (w & 63u)) & m0;
        const unsigned v1 =
            static_cast<unsigned>(lu >> ((w >> 8) & 63u)) & (w >> 24);
        c = static_cast<int>(v0 + v1 * (m0 + 1));
    } else {
        c = static_cast<int>(vrow[w & 255u])
            + static_cast<int>(vrow[(w >> 8) & 255u])
                  * static_cast<int>((w >> 16) & 255u);
    }
    const long long* q =
        ad + (AMP_C ? 4ll : 2ll) * (static_cast<long long>(w0 & kOffset) + c);
    double re = __longlong_as_double(q[0]);
    double im = AMP_C ? __longlong_as_double(q[1]) : 0.0;
    if (re == 0.0 && im == 0.0) return;
    const unsigned long long wm =
        static_cast<unsigned long long>(static_cast<unsigned>(rc.z))
        | (static_cast<unsigned long long>(static_cast<unsigned>(rc.w)) << 32);
    if (__popcll(fo & wm) & 1) {
        re = -re;
        im = -im;
    }
    col = find_row<MODE>(p, l + q[AMP_C ? 2 : 1]);
    v = conj_value<T>(re, im);
}

// The rows of the block's warps (the grid's share), their scratch in the
// device buffer (DEV) or in shared memory after the staged tables.
template <int MODE, bool AMP_C, bool DEV>
__device__ __forceinline__ void rows(const Params& p, unsigned char* raw,
                                     const int4* rec, const long long* ad) {
    using T = std::conditional_t<AMP_C, double2, double>;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const ell_rows::Scratch<T> s = ell_rows::scratch<T>(
        ell_rows::region<DEV>(raw + tables_bytes(p), p.row_scratch,
                              warp_bytes(p)),
        p.E);
    const int E32 = (p.E + 31) & ~31;          // whole chunks of 32 images
    int wmax = 0;
    for (long long k = static_cast<long long>(blockIdx.x) * warps + warp;
         k < p.rows; k += static_cast<long long>(gridDim.x) * warps) {
        const long long l = __ldg(p.labels + k);
        const unsigned long long fo =
            p.fodd != nullptr
                ? static_cast<unsigned long long>(__ldg(p.fodd + k))
                : 0ull;
        const signed char* vrow = p.bits ? nullptr : p.V + k * p.S;
        int kept = 0;
        for (int e = lane; e < E32; e += 32) {
            long long col = 0;
            T v = ell_rows::zero<T>();
            if (e < p.E)
                image<MODE, AMP_C, T>(p, rec, ad, l, vrow, fo, e, col, v);
            ell_rows::put(s, kept, e < p.E, col, v);
        }
        __syncwarp();
        const long long at = k * p.W;
        const int cnt = ell_rows::finish(
            s, kept, p.write ? p.cols + at : nullptr,
            p.write ? reinterpret_cast<T*>(p.vals) + at : nullptr, p.W,
            p.write != 0);
        wmax = max(wmax, cnt);
        __syncwarp();                   // the scratch is free for the next row
    }
    if (!p.write && lane == 0) atomicMax(p.width, wmax);
}

template <int MODE, bool AMP_C>
__global__ void __launch_bounds__(kThreads) ell_rows_kernel(const Params p) {
    extern __shared__ int4 smem[];
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
    const int4* rec = p.rec;
    const long long* ad = p.ad;
    if (p.tabs_shared) {
        int4* srec = reinterpret_cast<int4*>(raw);
        for (int k = threadIdx.x; k < p.E; k += blockDim.x)
            srec[k] = __ldg(p.rec + k);
        int4* sad = reinterpret_cast<int4*>(raw + ell_rows::a16(16ll * p.E));
        const int4* src = reinterpret_cast<const int4*>(p.ad);
        for (long long k = threadIdx.x; k < p.M * (AMP_C ? 2 : 1);
             k += blockDim.x)
            sad[k] = __ldg(src + k);
        rec = srec;
        ad = reinterpret_cast<const long long*>(sad);
    }
    __syncthreads();
    if (p.row_scratch != nullptr)
        rows<MODE, AMP_C, true>(p, raw, rec, ad);
    else
        rows<MODE, AMP_C, false>(p, raw, rec, ad);
}

template <int MODE, bool AMP_C>
int launch(const Params& p, cudaStream_t stream) {
    auto kern = ell_rows_kernel<MODE, AMP_C>;
    const ell_rows::Plan pl = row_plan(p);
    const long long smem = pl.smem;
    const int threads = 32 * pl.warps;
    if (smem > kMaxShared
        || (pl.device && (p.row_scratch == nullptr || p.row_blocks < 1)))
        return static_cast<int>(cudaErrorInvalidValue);
    // the resident grid of this instance at this block size and shared
    // memory size, worked out at its first launch on a device and kept
    thread_local int cached_dev = -1, cached_threads = 0;
    thread_local long long cached_smem = -1, resident = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev != cached_dev || smem != cached_smem
        || threads != cached_threads) {
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
            || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kern, threads, static_cast<size_t>(smem)))
                   != cudaSuccess)
            return static_cast<int>(err);
        resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
        cached_dev = dev;
        cached_smem = smem;
        cached_threads = threads;
    }
    const long long tiles = (p.rows + pl.warps - 1) / pl.warps;
    long long grid = tiles < resident ? tiles : resident;
    if (pl.device && grid > p.row_blocks) grid = p.row_blocks;
    kern<<<static_cast<unsigned>(grid), threads, static_cast<size_t>(smem),
           stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <bool AMP_C>
int pick_mode(const Params& p, cudaStream_t stream) {
    switch (p.mode) {
        case kDirect:
            return launch<kDirect, AMP_C>(p, stream);
        case kLin:
            return launch<kLin, AMP_C>(p, stream);
        default:
            return launch<kBsearch, AMP_C>(p, stream);
    }
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/ell_build.py::build_library).
// Takes a pointer to a Params and the stream; returns a cudaError_t value,
// 0 on success. Instances: index mode (3) x complex amplitudes (2).
extern "C" long long qbt_ell_params_size() { return sizeof(Params); }

// The bytes a block of the build's rows' scratch takes in device memory
// (the wrapper allocates row_blocks of them), or 0 where it fits in
// shared memory.
extern "C" long long qbt_ell_rows_scratch(const void* pp) {
    const Params& p = *static_cast<const Params*>(pp);
    if (p.E < 1) return 0;
    const ell_rows::Plan pl = row_plan(p);
    return pl.device ? pl.warps * warp_bytes(p) : 0;
}

extern "C" int qbt_ell_rows(const void* pp, void* stream) {
    Params p = *static_cast<const Params*>(pp);
    if (p.rows <= 0 || p.n <= 0 || p.n >= INT_MAX || p.E < 1 || p.A < 1
        || p.mode < kDirect || p.mode > kBsearch
        || (p.mode == kLin && (p.sa < 1 || p.t1 == nullptr))
        || (!p.bits && (p.V == nullptr || p.S < 1))
        || (p.A > 2 && (p.gsel == nullptr || p.gstr == nullptr))
        || p.W < 0
        || (p.write ? p.cols == nullptr || p.vals == nullptr
                    : p.width == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.mode == kLin)
        p.sa_shift = (p.sa & (p.sa - 1)) == 0 ? __builtin_ctzll(p.sa) : -1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    return p.amp_c ? pick_mode<true>(p, st) : pick_mode<false>(p, st);
}
