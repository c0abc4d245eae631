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
// where every amplitude is real, else complex128. Then the row stage drops,
// sorts, merges and stores the row under the contract of csrc/ell_rows.cuh
// (drop at 1e-14, the stable (column, slot) order, runs summed in slot
// order, dropped again at 1e-14, the survivors left, (0, 0) to W).
//
// Design. Rows of E <= 64 image columns in sectors of fewer than 2^26 - 1
// rows (every sector chip_smoke.py builds: E = 13-48, n up to 10,400,600)
// keep the whole row in registers: a segment of SEG lanes a row (16 where
// E <= 16, two rows a warp; else 32), R images a lane (2 where E > 32),
// image e at lane e % SEG, register e / SEG. An image carries the 32-bit
// key (j << 6 | e), the largest key where it is dropped; a bitonic
// network of __shfl_xor_sync exchanges sorts the segment's keys, which is
// the (column, slot) order, since a column's images differ only in e; each
// sorted place fetches its value once from the lane its slot names; the
// head of a run of equal columns (a ballot of the heads gives every run's
// end) adds the run's later values in place order, that is slot order, as
// the shared row stage does, so the values are bit-equal to it; a ballot
// of the heads that pass 1e-14 gives each entry its place, and the row is
// stored as one int32 segment and one value segment, padded to W, its count
// as the row's length (int32 rowlen, the ELL's row_lengths rule, since the
// kept entries are nonzero and left). Each lane's exchange directions are
// worked out once a launch (a bit a step), so that an exchange is a
// shuffle, a compare and a select. A row of two images a lane whose kept
// images fit 32 is first compacted into one register in slot order
// (through the warp's 32 words of shared memory), and sorts 32 keys, not
// 64. The count pass does not sort a row in one register:
// __match_any_sync gives each kept image the lanes of its column, the
// lowest one heads the run and sums it in lane (slot) order, so its count
// is the write pass's. No scratch: shared memory holds the staged tables
// and the compaction's words.
// Wider rows (bosons with dense three-site terms: 640-2240 columns), and
// the rows of sectors whose columns do not fit a key, go through
// csrc/ell_rows.cuh's row stage: a warp a row, its images in a
// scratch in shared memory, or in a device buffer the wrapper allocates
// where not one warp's fits (ell_rows::plan, qbt_ell_rows_scratch).
//
// A persistent grid of as many blocks as are resident walks the rows; each
// block stages the columns' records and entries in shared memory where
// they fit ops/apply.py::TABLES_SHARED_MAX, else reads them through the
// cache. A build is two launches (ops/ell_build.py::two_pass): the count
// pass, ell_rows_kernel_count, counts each row without a store and raises
// the sector's width W to its warp's widest row (one atomicMax a warp),
// from which the wrapper allocates (n, W) (its one host sync); then
// ell_rows_kernel_write stores the rows and their lengths.
//
// Bound: device-memory bytes. A build must read each row's label (and Fodd
// where fermionic) once, the index entries its images touch, and write the
// finished ELL once, 16 or 24 bytes an entry of (n, W), and the rows'
// lengths, 4 bytes a row; chip_smoke.py computes it from each run's data.
// What the kernel adds to that: the V row where the local dims are not
// powers of two, and the count pass's second reading.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxShared = 232448;          // a block's shared memory, sm_90
constexpr unsigned kFull = 0xffffffffu;

// word 0 of a column record (ops/apply.py::pack_rows): the offset of its
// entries (bits 0-27), arity > 2 (bit 31); words 2, 3: wmask
constexpr unsigned kOffset = (1u << 28) - 1;
constexpr unsigned kGeneric = 1u << 31;

enum { kDirect = 0, kLin = 1, kBsearch = 2 };

// The row stages (qbt_ell_rows_path; ops/ell_build.py::PATHS): in
// registers, two rows a warp of 16 lanes each (E <= 16), a row a warp of
// one image a lane (E <= 32) or two (E <= 64); else csrc/ell_rows.cuh's
// stage, its scratch in shared memory or in the device buffer.
enum { kShared = 0, kPair = 1, kOne = 2, kTwo = 3, kDevice = 4 };
constexpr int kRegisterMaxE = 64;

// The register stage's sort keys (j << 6 | e): 32 bits, so that the stage
// takes sectors of fewer than kKeyRows rows (the largest key, 2^32 - 1,
// marks a dropped image).
using Key = unsigned;
constexpr long long kKeyRows = (1ll << 26) - 1;
constexpr Key kNoKey = ~Key(0);

// A row of two images a lane whose kept images fit one register is
// compacted into it (a sort of 32 keys, not 64), and the count pass counts
// a row in one register by __match_any_sync, not by the sort.
constexpr bool kCompact = true;
constexpr bool kCountByMatch = true;

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
    int* rowlen;                // (rows,) their lengths (the write pass)
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

inline int row_path(const Params& p) {
    if (p.E > kRegisterMaxE || p.n >= kKeyRows)
        return row_plan(p).device ? kDevice : kShared;
    if (p.E <= 16) return kPair;
    return p.E <= 32 ? kOne : kTwo;
}

// The row of label t (basis/index.py::lookup_tables), as an int (every
// row is below 2^31 - 1).
template <int MODE>
__device__ __forceinline__ int find_row(const Params& p, long long t) {
    if constexpr (MODE == kDirect) {
        const int j = __ldg(static_cast<const int*>(p.t0)
                            + clampll(t, 0, p.label_space - 1));
        return p.absent ? static_cast<int>(min(static_cast<long long>(j),
                                               p.n - 1))
                        : j;
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
        return static_cast<int>(
            clampll(__ldg(static_cast<const long long*>(p.t0) + a)
                        + __ldg(p.t1 + b),
                    0, p.n - 1));
    } else {                            // lower bound over the labels
        const long long* sorted = static_cast<const long long*>(p.t0);
        long long base = 0, len = p.n;
        while (len > 1) {
            const long long half = len >> 1;
            if (__ldg(sorted + base + half) < t) base += half;
            len -= half;
        }
        return static_cast<int>(
            min(base + (__ldg(sorted + base) < t ? 1 : 0), p.n - 1));
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
// (col, v); both left as they were where the image is padding.
template <int MODE, bool AMP_C, class T>
__device__ __forceinline__ void image(const Params& p, const int4* rec,
                                      const long long* ad, long long l,
                                      const signed char* vrow,
                                      unsigned long long fo, int e,
                                      int& col, T& v) {
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

// --------------------------------------------------------------------------
// The row stage in registers (E <= 64)
// --------------------------------------------------------------------------

__device__ __forceinline__ double shfl(double v, int src, int width) {
    return __shfl_sync(kFull, v, src, width);
}
__device__ __forceinline__ double2 shfl(double2 v, int src, int width) {
    return make_double2(__shfl_sync(kFull, v.x, src, width),
                        __shfl_sync(kFull, v.y, src, width));
}

// A row's images in a segment: lane sl holds images sl + SEG * r.
template <int R, class T>
struct Images {
    int col[R];         // j
    T v[R];             // conj(A) sign, 0 where the image is padding
};

// The images of row k (none where k is past the rows).
template <int MODE, bool AMP_C, int SEG, int R, class T>
__device__ __forceinline__ void load_row(const Params& p, const int4* rec,
                                         const long long* ad, long long k,
                                         int sl, Images<R, T>& im) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        im.col[r] = 0;
        im.v[r] = ell_rows::zero<T>();
    }
    if (k >= p.rows) return;
    const long long l = __ldg(p.labels + k);
    const unsigned long long fo =
        p.fodd != nullptr ? static_cast<unsigned long long>(__ldg(p.fodd + k))
                          : 0ull;
    const signed char* vrow = p.bits ? nullptr : p.V + k * p.S;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = sl + SEG * r;
        if (e < p.E)
            image<MODE, AMP_C, T>(p, rec, ad, l, vrow, fo, e, im.col[r],
                                  im.v[r]);
    }
}

// The lane's exchanges of the bitonic network over a segment's N = SEG *
// RS places sl + SEG * r, step by step: the distance j, the size of the
// sequences being merged, and, for a step between lanes, whether this
// lane keeps the smaller key (bit s of dir[r] for the s-th such step,
// worked out once a launch by directions()).
template <int SEG, int RS>
__device__ __forceinline__ void directions(int sl, unsigned (&dir)[RS]) {
#pragma unroll
    for (int r = 0; r < RS; ++r) dir[r] = 0;
    int s = 0;
#pragma unroll
    for (int size = 2; size <= SEG * RS; size <<= 1) {
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
            if (j == SEG) continue;     // in the lane: a min and a max
#pragma unroll
            for (int r = 0; r < RS; ++r) {
                const int pos = sl + SEG * r;
                if (((pos & j) == 0) == ((pos & size) == 0))
                    dir[r] |= 1u << s;
            }
            ++s;
        }
    }
}

// Sorts the segment's keys ascending over its places: each exchange
// between lanes a __shfl_xor_sync, a compare and a select; at distance SEG
// (RS == 2) a lane orders its two registers.
template <int SEG, int RS>
__device__ __forceinline__ void bitonic(Key (&key)[RS],
                                        const unsigned (&dir)[RS]) {
    int s = 0;
#pragma unroll
    for (int size = 2; size <= SEG * RS; size <<= 1) {
#pragma unroll
        for (int j = size >> 1; j > 0; j >>= 1) {
            if (j == SEG) {             // RS == 2, size == N: ascending
                const Key a = key[0], b = key[RS - 1];
                key[0] = a < b ? a : b;
                key[RS - 1] = a < b ? b : a;
                continue;
            }
#pragma unroll
            for (int r = 0; r < RS; ++r) {
                const Key o = __shfl_xor_sync(kFull, key[r], j, SEG);
                const bool keep_min = (dir[r] >> s) & 1u;
                key[r] = (o < key[r]) == keep_min ? o : key[r];
            }
            ++s;
        }
    }
}

// This segment's bits of a warp ballot.
template <int SEG>
__device__ __forceinline__ unsigned long long seg_bits(unsigned b,
                                                       int half) {
    return SEG == 32 ? b : (b >> (16 * half)) & 0xffffu;
}

// The value of image slot (its lane slot % SEG, register slot / SEG).
template <int SEG, int R, class T>
__device__ __forceinline__ T by_slot(const T (&v)[R], int slot) {
    const T a = shfl(v[0], slot & (SEG - 1), SEG);
    if constexpr (R == 2) {
        const T b = shfl(v[1], slot & (SEG - 1), SEG);
        return slot >= SEG ? b : a;
    } else {
        return a;
    }
}

// Row k's key for each image: (j << 6 | e) where it is kept, kNoKey
// where it is dropped (at or below kTol, padding, or past the rows).
template <int MODE, int SEG, int R, class T>
__device__ __forceinline__ void row_keys(const Params& p,
                                         const Images<R, T>& im, bool live,
                                         int sl, Key (&key)[R]) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int e = sl + SEG * r;
        const bool keep =
            live && e < p.E && ell_rows::mag(im.v[r]) > ell_rows::kTol;
        key[r] = keep ? (static_cast<Key>(im.col[r]) << 6)
                            | static_cast<Key>(e)
                      : kNoKey;
    }
}

// A row's kept keys of two registers moved, in slot order, into one (the
// caller knows there are at most 32), through the warp's 32 words of
// shared memory.
__device__ __forceinline__ Key compact(const Key (&key)[2], unsigned* words,
                                       int lane) {
    const unsigned a0 = __ballot_sync(kFull, key[0] != kNoKey);
    const unsigned a1 = __ballot_sync(kFull, key[1] != kNoKey);
    const unsigned below = (1u << lane) - 1u;
    if (key[0] != kNoKey) words[__popc(a0 & below)] = key[0];
    if (key[1] != kNoKey) words[__popc(a0) + __popc(a1 & below)] = key[1];
    __syncwarp();
    const Key k = lane < __popc(a0) + __popc(a1) ? words[lane] : kNoKey;
    __syncwarp();                       // the words are free for the next row
    return k;
}

// The count of a row whose kept keys are in one register, in slot order
// over the segment's lanes, without a sort: __match_any_sync gives each
// kept image the lanes of its column; the lowest is the run's head, which
// adds the run's later values in lane order, that is slot order, as the
// sorted stage does, so the count is the write pass's.
template <int SEG, int R, class T>
__device__ __forceinline__ int match_count(Key key, const T (&v)[R],
                                           int half) {
    const int lane = threadIdx.x & 31;
    const bool alive = key != kNoKey;
    // a kept image's column (below 2^26) tagged with its segment; a
    // dropped one's value is its lane's own
    const unsigned tag = alive ? static_cast<unsigned>(key >> 6)
                                     | (static_cast<unsigned>(half) << 30)
                               : (1u << 31) | static_cast<unsigned>(lane);
    const unsigned peers = __match_any_sync(kFull, tag);
    const bool head = alive && __ffs(peers) - 1 == lane;
    const T s = R == 1 ? v[0] : by_slot<SEG, R, T>(v, static_cast<int>(
                                                          key & 63u));
    T sum = s;
    unsigned rest = head ? peers & (peers - 1u) : 0u;
    const int most = static_cast<int>(
        __reduce_max_sync(kFull, static_cast<unsigned>(__popc(rest))));
    for (int d = 0; d < most; ++d) {
        const int src = rest ? __ffs(rest) - 1 : lane;
        const T o = shfl(s, src & (SEG - 1), SEG);
        if (rest) {
            sum = ell_rows::plus(sum, o);
            rest &= rest - 1u;
        }
    }
    const bool keep = head && ell_rows::mag(sum) > ell_rows::kTol;
    return __popcll(seg_bits<SEG>(__ballot_sync(kFull, keep), half));
}

// Row k (live where k < rows) from its kept keys in RS registers (places
// sl + SEG * r, in slot order or not) and its images' values in R: sorts
// the keys; with WRITE stores its entries, padding and length; returns
// its count (0 where not live).
template <bool WRITE, int SEG, int R, int RS, class T>
__device__ __forceinline__ int sorted_row(const Params& p, Key (&key)[RS],
                                          const T (&v)[R],
                                          const unsigned (&dir)[RS],
                                          long long k, int sl, int half) {
    constexpr int N = SEG * RS;
    const bool live = k < p.rows;
    bitonic<SEG, RS>(key, dir);
    T s[RS];                            // each place's value, by its slot
#pragma unroll
    for (int r = 0; r < RS; ++r)
        s[r] = by_slot<SEG, R, T>(v, static_cast<int>(key[r] & 63u));
    // the kept places (the first K) and the runs' heads
    Key prev[RS];
    prev[0] = __shfl_up_sync(kFull, key[0], 1, SEG);
    if constexpr (RS == 2) {
        const Key up1 = __shfl_up_sync(kFull, key[1], 1, SEG);
        const Key last0 = __shfl_sync(kFull, key[0], SEG - 1, SEG);
        prev[1] = sl == 0 ? last0 : up1;
    }
    bool head[RS];
    unsigned long long A = 0, H = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
        const int pos = sl + SEG * r;
        const bool alive = key[r] != kNoKey;
        head[r] = alive && (pos == 0 || (prev[r] >> 6) != (key[r] >> 6));
        A |= seg_bits<SEG>(__ballot_sync(kFull, alive), half) << (SEG * r);
        H |= seg_bits<SEG>(__ballot_sync(kFull, head[r]), half) << (SEG * r);
    }
    const int K = __popcll(A);
    // a head's run ends at the next head or at K
    int len[RS], most = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
        const int pos = sl + SEG * r;
        len[r] = 0;
        if (head[r]) {
            const unsigned long long above =
                pos + 1 < 64 ? H >> (pos + 1) : 0ull;
            const int next = above ? pos + __ffsll(above) : N;
            len[r] = (next < K ? next : K) - pos;
        }
        most = len[r] > most ? len[r] : most;
    }
    most = static_cast<int>(__reduce_max_sync(kFull,
                                              static_cast<unsigned>(most)));
    T sum[RS];
#pragma unroll
    for (int r = 0; r < RS; ++r) sum[r] = s[r];
    for (int d = 1; d < most; ++d) {    // the run's next place, in order
        const int src = (sl + d) & (SEG - 1);
        const T a = shfl(s[0], src, SEG);
        if constexpr (RS == 2) {
            const T b = shfl(s[1], src, SEG);
            if (d < len[0])
                sum[0] = ell_rows::plus(sum[0], sl + d < SEG ? a : b);
            if (d < len[1]) sum[1] = ell_rows::plus(sum[1], b);
        } else {
            if (d < len[0]) sum[0] = ell_rows::plus(sum[0], a);
        }
    }
    bool keep[RS];
    unsigned long long S = 0;
#pragma unroll
    for (int r = 0; r < RS; ++r) {
        keep[r] = head[r] && ell_rows::mag(sum[r]) > ell_rows::kTol;
        S |= seg_bits<SEG>(__ballot_sync(kFull, keep[r]), half) << (SEG * r);
    }
    const int count = __popcll(S);
    if constexpr (WRITE) {
        if (live) {
            int* cols = p.cols + k * p.W;
            T* vals = reinterpret_cast<T*>(p.vals) + k * p.W;
#pragma unroll
            for (int r = 0; r < RS; ++r) {
                const int pos = sl + SEG * r;
                const int at = __popcll(S & ((1ull << pos) - 1ull));
                if (keep[r] && at < p.W) {  // W bounds the count pass's
                    cols[at] = static_cast<int>(key[r] >> 6);
                    vals[at] = sum[r];
                }
            }
            for (int at = count + sl; at < p.W; at += SEG) {
                cols[at] = 0;
                vals[at] = ell_rows::zero<T>();
            }
            if (sl == 0) p.rowlen[k] = count < p.W ? count : p.W;
        }
    }
    return count;
}

// The rows of the block's warps (the grid's share) through the register
// stage: 32 / SEG rows a warp at a time. A row of two registers whose kept
// images fit one (K <= 32) is compacted into it first; the count pass
// counts a row in one register by __match_any_sync, the write pass sorts.
template <bool WRITE, int MODE, bool AMP_C, int SEG, int R>
__device__ __forceinline__ void reg_rows(const Params& p, const int4* rec,
                                         const long long* ad,
                                         unsigned* words) {
    using T = std::conditional_t<AMP_C, double2, double>;
    constexpr int kRows = 32 / SEG;
    const int lane = threadIdx.x & 31, sl = lane & (SEG - 1);
    const int half = lane / SEG;
    const int warps = blockDim.x >> 5;
    const long long step =
        static_cast<long long>(gridDim.x) * warps * kRows;
    const long long first =
        (static_cast<long long>(blockIdx.x) * warps + (threadIdx.x >> 5))
        * kRows;
    unsigned dir1[1], dir2[2] = {0u, 0u};
    directions<SEG, 1>(sl, dir1);
    if constexpr (R == 2) directions<SEG, 2>(sl, dir2);
    int wmax = 0;
    for (long long k0 = first; k0 < p.rows; k0 += step) {
        const long long k = k0 + half;
        Images<R, T> im;
        load_row<MODE, AMP_C, SEG, R>(p, rec, ad, k, sl, im);
        Key key[R];
        row_keys<MODE, SEG, R>(p, im, k < p.rows, sl, key);
        Key one[1] = {key[0]};
        bool in_one = true;
        int cnt = 0;
        if constexpr (R == 2) {
            const int K = __popc(__ballot_sync(kFull, key[0] != kNoKey))
                          + __popc(__ballot_sync(kFull, key[1] != kNoKey));
            in_one = kCompact && K <= 32;
            if (in_one)
                one[0] = compact(key, words, lane);
            else
                cnt = sorted_row<WRITE, SEG, R, 2, T>(p, key, im.v, dir2, k,
                                                      sl, half);
        }
        if (in_one)
            cnt = !WRITE && kCountByMatch
                      ? match_count<SEG, R, T>(one[0], im.v, half)
                      : sorted_row<WRITE, SEG, R, 1, T>(p, one, im.v, dir1,
                                                        k, sl, half);
        wmax = cnt > wmax ? cnt : wmax;
    }
    if constexpr (!WRITE) {
        wmax = static_cast<int>(
            __reduce_max_sync(kFull, static_cast<unsigned>(wmax)));
        if (lane == 0) atomicMax(p.width, wmax);
    }
}

// --------------------------------------------------------------------------
// The shared row stage (E > 64, or rows past the keys): csrc/ell_rows.cuh
// --------------------------------------------------------------------------

// The rows of the block's warps (the grid's share), their scratch in the
// device buffer (DEV) or in shared memory after the staged tables.
template <bool WRITE, int MODE, bool AMP_C, bool DEV>
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
            int col = 0;
            T v = ell_rows::zero<T>();
            if (e < p.E)
                image<MODE, AMP_C, T>(p, rec, ad, l, vrow, fo, e, col, v);
            ell_rows::put(s, kept, e < p.E, col, v);
        }
        __syncwarp();
        const long long at = k * p.W;
        const int cnt = ell_rows::finish(
            s, kept, WRITE ? p.cols + at : nullptr,
            WRITE ? reinterpret_cast<T*>(p.vals) + at : nullptr, p.W,
            WRITE);
        if (WRITE && lane == 0) p.rowlen[k] = cnt;
        wmax = max(wmax, cnt);
        __syncwarp();                   // the scratch is free for the next row
    }
    if (!WRITE && lane == 0) atomicMax(p.width, wmax);
}

// Stages the tables where they fit, then runs the block's rows by PATH.
template <bool WRITE, int MODE, bool AMP_C, int PATH>
__device__ __forceinline__ void build(const Params& p) {
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
    // the warp's 32 words for the compaction, after the tables
    unsigned* words = reinterpret_cast<unsigned*>(raw + tables_bytes(p))
                      + 32 * (threadIdx.x >> 5);
    if constexpr (PATH == kPair)
        reg_rows<WRITE, MODE, AMP_C, 16, 1>(p, rec, ad, words);
    else if constexpr (PATH == kOne)
        reg_rows<WRITE, MODE, AMP_C, 32, 1>(p, rec, ad, words);
    else if constexpr (PATH == kTwo)
        reg_rows<WRITE, MODE, AMP_C, 32, 2>(p, rec, ad, words);
    else
        rows<WRITE, MODE, AMP_C, PATH == kDevice>(p, raw, rec, ad);
}

// Two names, so that a profile tells the passes apart.
template <int MODE, bool AMP_C, int PATH>
__global__ void __launch_bounds__(kThreads)
    ell_rows_kernel_count(const Params p) {
    build<false, MODE, AMP_C, PATH>(p);
}

template <int MODE, bool AMP_C, int PATH>
__global__ void __launch_bounds__(kThreads)
    ell_rows_kernel_write(const Params p) {
    build<true, MODE, AMP_C, PATH>(p);
}

template <int MODE, bool AMP_C, int PATH, bool WRITE>
int launch(const Params& p, cudaStream_t stream) {
    auto kern = ell_rows_kernel_count<MODE, AMP_C, PATH>;
    if constexpr (WRITE) kern = ell_rows_kernel_write<MODE, AMP_C, PATH>;
    int threads = kThreads;
    long long smem = tables_bytes(p) + (PATH == kTwo ? 4 * kThreads : 0);
    bool device = false;
    if constexpr (PATH == kShared || PATH == kDevice) {
        const ell_rows::Plan pl = row_plan(p);
        threads = 32 * pl.warps;
        smem = pl.smem;
        device = pl.device;
    }
    if (smem > kMaxShared
        || (device && (p.row_scratch == nullptr || p.row_blocks < 1)))
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
    const long long rows_a_block =
        static_cast<long long>(threads / 32) * (PATH == kPair ? 2 : 1);
    const long long tiles = (p.rows + rows_a_block - 1) / rows_a_block;
    long long grid = tiles < resident ? tiles : resident;
    if (device && grid > p.row_blocks) grid = p.row_blocks;
    kern<<<static_cast<unsigned>(grid), threads, static_cast<size_t>(smem),
           stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool AMP_C, bool WRITE>
int pick_path(const Params& p, cudaStream_t stream) {
    switch (row_path(p)) {
        case kPair:
            return launch<MODE, AMP_C, kPair, WRITE>(p, stream);
        case kOne:
            return launch<MODE, AMP_C, kOne, WRITE>(p, stream);
        case kTwo:
            return launch<MODE, AMP_C, kTwo, WRITE>(p, stream);
        case kDevice:
            return launch<MODE, AMP_C, kDevice, WRITE>(p, stream);
        default:
            return launch<MODE, AMP_C, kShared, WRITE>(p, stream);
    }
}

template <bool AMP_C, bool WRITE>
int pick_mode(const Params& p, cudaStream_t stream) {
    switch (p.mode) {
        case kDirect:
            return pick_path<kDirect, AMP_C, WRITE>(p, stream);
        case kLin:
            return pick_path<kLin, AMP_C, WRITE>(p, stream);
        default:
            return pick_path<kBsearch, AMP_C, WRITE>(p, stream);
    }
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/ell_build.py::build_library).
// Takes a pointer to a Params and the stream; returns a cudaError_t value,
// 0 on success. Instances: index mode (3) x complex amplitudes (2) x row
// stage (5) x pass (2).
extern "C" long long qbt_ell_params_size() { return sizeof(Params); }

// The row stage a build takes (kShared .. kDevice above).
extern "C" int qbt_ell_rows_path(const void* pp) {
    return row_path(*static_cast<const Params*>(pp));
}

// The bytes a block of the build's rows' scratch takes in device memory
// (the wrapper allocates row_blocks of them), or 0 where it fits in
// shared memory or the row stage keeps no scratch.
extern "C" long long qbt_ell_rows_scratch(const void* pp) {
    const Params& p = *static_cast<const Params*>(pp);
    if (p.E < 1 || row_path(p) != kDevice) return 0;
    return row_plan(p).warps * warp_bytes(p);
}

// The count pass (write 0: *width, zero before it, raised to the widest
// row) or the write pass (the rows into cols and vals, their lengths into
// rowlen).
extern "C" int qbt_ell_rows(const void* pp, void* stream) {
    Params p = *static_cast<const Params*>(pp);
    if (p.rows <= 0 || p.n <= 0 || p.n >= INT_MAX || p.E < 1 || p.A < 1
        || p.mode < kDirect || p.mode > kBsearch
        || (p.mode == kLin && (p.sa < 1 || p.t1 == nullptr))
        || (!p.bits && (p.V == nullptr || p.S < 1))
        || (p.A > 2 && (p.gsel == nullptr || p.gstr == nullptr))
        || p.W < 0
        || (p.write ? p.cols == nullptr || p.vals == nullptr
                          || p.rowlen == nullptr
                    : p.width == nullptr))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.mode == kLin)
        p.sa_shift = (p.sa & (p.sa - 1)) == 0 ? __builtin_ctzll(p.sa) : -1;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (p.write)
        return p.amp_c ? pick_mode<true, true>(p, st)
                       : pick_mode<false, true>(p, st);
    return p.amp_c ? pick_mode<true, false>(p, st)
                   : pick_mode<false, false>(p, st);
}
