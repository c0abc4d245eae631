// Matrix-free row apply of a compiled operator for Hopper (sm_90a): the
// Hermitian row gather y = H x and the scatter y = O x, one launch each.
//
// Replaces the XLA program of the JAX package's matrix-free apply,
// quantum_basis_tpu/ops/apply.py::apply_block_rows (:117) with
// _block_images (:102), run per row block under lax.map by MatvecFull
// (:182-201) and by parallel/apply_sharded.py, and its scatter direction
// mopr_x_vec (:242). Per block that program materialises (rows, terms,
// images) tensors in device memory: target labels, amplitudes, index
// lookups, x gathers and their products. Here nothing of that size is
// written: every image lives in registers.
//
// For row i with label l and every image column e = (group, term, image k)
// of the packed tables (ops/apply.py::pack_rows):
//   c      = v0 + v1 * st1[e]        (the term's joint column; v0, v1 the
//            values of its one or two slots; arity > 2 sums over its slots)
//   (a, d) = entry[off[e] + c]       (amplitude and label displacement,
//            interleaved; a = 0 is padding, skipped)
//   sign   = (-1) ** popcount(Fodd[i] & wmask[e])     ((F @ W^T) mod 2)
//   target = l + d, its row j through the basis index: direct (one gather
//            of the position table, int32 rows), lin (Ja[t % sa] + Jb[t / sa]) or bsearch (a lower bound over
//            the sorted labels), clamped as basis/index.py::lookup_tables
//            clamps;
//   apply_rows:   y[i]  = diag[i] x[i] + sum_e conj(a) sign x[j]
//   scatter_rows: y[j] += a sign x[i], for targets with labels[j] == target
//                 (the destination index; a row's consecutive adds to one
//                 target are summed first).
// A diagonal column (every entry's d = 0, flagged by the packing) targets
// the row itself: apply_rows adds conj(a) sign x[i] with no lookup, and
// scatter_rows sums a row's diagonal columns and its real diagonal in
// registers into one add to the row's own target: row i itself where the
// destination's label there is l (one coalesced read), else one lookup and
// one labels[j] == l check. Where every column is diagonal (or there is
// none), no two rows add to one target, and that add is a plain store.
// Vectors are float64 or complex128 (read and written as double2),
// amplitudes float64 or complex128; sums in f64 registers. apply_rows
// writes each row once and writes rows at or past n_valid as zero (the
// padding of MatvecSharded); scatter_rows adds with f64 atomics (two for
// complex), so its order of summation changes from run to run, as
// index_add_'s does on the card.
//
// What a column reads. Its record (the slots or the label bit fields' shifts
// and masks, st1, off, the flags, wmask) is one 16-byte load and its entry
// one 16-byte load (32 with a complex amplitude), both from shared memory,
// where each block stages the tables once (above
// ops/apply.py::TABLES_SHARED_MAX bytes of them, an instance reads them
// through __ldg instead); the record's load is uniform across the warp. The
// slot values come from the row's label in a register where every local
// dim is a power of two (v = (l >> shift) & mask); otherwise the block
// stages its rows' V (int8) once per tile with coalesced 16-byte loads into
// shared memory, at a pitch that keeps the per-column byte reads free of
// bank conflicts. What is left in device memory a column is the two random
// gathers that the matrix-free form needs: the index lookup and x[j] (the
// scatter: the lookup, the labels[j] check and the atomic add). In lin mode
// a block stages Ja and Jb (as int32, where they fit kLinShared bytes and
// their values int32) and the lookup leaves device memory too.
//
// Bound: device-memory bytes. One apply must read each row's state once,
// as its label or its V, whichever is smaller (each decodes to the other;
// this kernel reads the label, and V as well where it is staged), Fodd
// where a term carries a Jordan-Wigner string, x and the diagonal once, and
// write y once (32 bytes a row for a spin chain), plus the index entries
// that the nonzero images touch (32-byte sectors of the int32 position
// table; about 0.04 GB at chain-24 Sz=0), plus the tables (1.9 KB at
// chain-24): about 0.13 GB, about 0.038 ms at 3.35 TB/s at dim 2,704,156
// (chip_smoke.py computes it from each run's data). What limits the kernels
// on the card is not bytes but the issue of each column's integer work
// (record decode, bit fields, tests; about 25 instructions a column): the
// gathers of a warp's column overlap the next columns' work.
//
// Design: one thread a row; a persistent grid of as many blocks as fit the
// card walks the rows in tiles of kThreads, so each block stages its
// tables once. The image columns are walked in chunks of kUnroll. A chunk
// of arity <= 2 columns runs without a branch: it loads its records, then
// its entries, all together, and makes its tests with selects and integer
// bit operations on the amplitudes (the sign flips their sign bits), so a
// warp overlaps its columns' latencies; then it issues all its index
// lookups, then all its x gathers, so each thread keeps up to kUnroll
// independent random loads in flight. The last chunk and columns of arity >
// 2 (flagged; generic, a loop over the slots' selectors) take a guarded
// path. Without Jordan-Wigner strings a row's walk makes no popcount. The
// binary search runs its kUnroll searches in lockstep. The kernels are
// templated on the index mode, the amplitude and vector types, where the
// tables live and where the slot values come from.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;               // resident blocks an SM, <= 85 regs
constexpr int kMaxShared = 232448;          // a block's shared memory, sm_90
constexpr long long kLinShared = 64 * 1024; // Ja and Jb staged up to this

// A column record (ops/apply.py::pack_rows), four words: (0) the offset of
// its entries (bits 0-27), the diagonal flag (bit 30), arity > 2 (bit 31);
// (1) for arity <= 2 the slots' label shifts (bits 0-7, 8-15) and masks
// (16-23, 24-31) where the values come from bit fields, else the slots
// (0-7, 8-15) and the joint stride of slot 1 (16-23; 0 at arity 1); (2, 3)
// the Jordan-Wigner mask.
constexpr unsigned kOffset = (1u << 28) - 1;
constexpr unsigned kDiag = 1u << 30;
constexpr unsigned kGeneric = 1u << 31;

enum { kDirect = 0, kLin = 1, kBsearch = 2 };

// Columns a chunk: its lookups and x gathers are in flight together; a
// complex vector's chunk is half as long, as its registers are twice.
template <bool X_C>
constexpr int kUnroll = X_C ? 4 : 8;

struct Params {
    const int4* rec;            // (E,) column records
    const long long* ad;        // (M, W) amplitude bits and dlt, W = 2 or 4
    const int* gsel;            // (E, A) slot selectors (arity > 2) or null
    const int* gstr;            // (E, A) joint strides (arity > 2) or null
    int E, A;
    int E_simple;               // leading columns of arity <= 2
    long long M;
    const void* t0;             // position table (int32), Ja, or the
                                // sorted labels (int64)
    const long long* t1;        // Jb (lin) or null
    long long sa, sb, label_space, n;
    int sa_shift;               // log2(sa) where sa is a power of two, or -1
    int lin_shared;             // Ja and Jb fit kLinShared
    const long long* index_labels;  // sorted labels of the index
    const long long* labels;    // (R,) rows' labels
    const signed char* V;       // (R, S) rows' slot values
    int S, pitch;               // V's row length, its staged row pitch
    const long long* fodd;      // (R,) or null
    int diag_only;              // every column diagonal: one add a target
    const double* diag;
    const double* x;
    double* y;
    long long row0, n_out, n_valid;
};

__host__ __device__ inline long long align16(long long b) {
    return (b + 15) & ~15ll;
}

// Byte offsets of the regions of a block's dynamic shared memory.
struct Layout {
    long long ad, lin, v, total;
};

__host__ __device__ inline Layout layout(const Params& p, bool tabs, int W,
                                         bool lin, bool staged) {
    Layout l;
    l.ad = tabs ? align16(16ll * p.E) : 0;
    l.lin = l.ad + (tabs ? align16(8ll * W * p.M) : 0);
    l.v = l.lin + (lin ? align16(4 * (p.sa + p.sb)) : 0);
    l.total = l.v + (staged ? static_cast<long long>(kThreads) * p.pitch : 0);
    return l;
}

struct Shared {
    const int4* rec;
    const long long* ad;
    int* lin;                   // Ja (sa), then Jb (sb)
    unsigned char* v;           // (kThreads, pitch)
};

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Stages the tables (TABS) and, in lin mode, Ja and Jb; returns whether the
// lin lookups read shared memory (every value fits int32).
template <bool TABS, int MODE, int W>
__device__ bool stage_tables(const Params& p, unsigned char* raw,
                             const Layout& l) {
    if constexpr (TABS) {
        int4* rec = reinterpret_cast<int4*>(raw);
        for (int k = threadIdx.x; k < p.E; k += kThreads)
            rec[k] = __ldg(p.rec + k);
        const int4* src = reinterpret_cast<const int4*>(p.ad);
        int4* dst = reinterpret_cast<int4*>(raw + l.ad);
        for (long long k = threadIdx.x; k < p.M * W / 2; k += kThreads)
            dst[k] = __ldg(src + k);
    }
    bool lin = false;
    if constexpr (MODE == kLin) {
        if (p.lin_shared) {
            int* s = reinterpret_cast<int*>(raw + l.lin);
            const long long* ja = static_cast<const long long*>(p.t0);
            int bad = 0;
            for (long long k = threadIdx.x; k < p.sa + p.sb; k += kThreads) {
                const long long v = k < p.sa ? __ldg(ja + k)
                                             : __ldg(p.t1 + (k - p.sa));
                bad |= v < INT_MIN || v > INT_MAX;
                s[k] = static_cast<int>(v);
            }
            lin = !__syncthreads_or(bad);
        }
    }
    __syncthreads();
    return lin;
}

// Copies V's rows g0 .. g1 - 1 into shared memory at the staged pitch:
// 16-byte loads over the aligned middle, bytes at the two ends.
__device__ void stage_rows(const Params& p, unsigned char* sv, long long g0,
                           long long g1) {
    __syncthreads();            // the previous tile's reads are done
    if (g1 > g0) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(p.V) + g0 * p.S;
        const int nbytes = static_cast<int>((g1 - g0) * p.S);
        int head = static_cast<int>(
            (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15);
        head = min(head, nbytes);
        const int n16 = (nbytes - head) >> 4;
        auto put = [&](int b, unsigned char v) {
            const int r = b / p.S;
            sv[r * p.pitch + (b - r * p.S)] = v;
        };
        for (int b = threadIdx.x; b < head; b += kThreads) put(b, src[b]);
        const uint4* s16 = reinterpret_cast<const uint4*>(src + head);
        for (int k = threadIdx.x; k < n16; k += kThreads) {
            const uint4 w = __ldg(s16 + k);
            const unsigned words[4] = {w.x, w.y, w.z, w.w};
            int b = head + 16 * k;
            int r = b / p.S;
            int col = b - r * p.S;
#pragma unroll
            for (int q = 0; q < 16; ++q) {
                sv[r * p.pitch + col] =
                    static_cast<unsigned char>(words[q >> 2] >> (8 * (q & 3)));
                if (++col == p.S) {
                    col = 0;
                    ++r;
                }
            }
        }
        for (int b = head + 16 * n16 + threadIdx.x; b < nbytes; b += kThreads)
            put(b, src[b]);
    }
    __syncthreads();
}

template <bool TABS>
__device__ __forceinline__ int4 load_rec(const Params& p, const Shared& s,
                                         int e) {
    if constexpr (TABS) return s.rec[e];
    else return __ldg(p.rec + e);
}

// Amplitude (re, im) and label displacement of entry idx (a complex
// entry's displacement only where ``need_dlt``: a diagonal column's is 0).
template <bool TABS, bool AMP_C>
__device__ __forceinline__ void load_entry(const Params& p, const Shared& s,
                                           int idx, bool need_dlt, double& re,
                                           double& im, long long& dlt) {
    if constexpr (AMP_C) {
        const long long* q = (TABS ? s.ad : p.ad) + 4ll * idx;
        double2 a;
        if constexpr (TABS) a = *reinterpret_cast<const double2*>(q);
        else a = __ldg(reinterpret_cast<const double2*>(q));
        re = a.x;
        im = a.y;
        dlt = 0;
        if (need_dlt) dlt = TABS ? q[2] : __ldg(q + 2);
    } else {
        const long long* q = (TABS ? s.ad : p.ad) + 2ll * idx;
        longlong2 v;
        if constexpr (TABS) v = *reinterpret_cast<const longlong2*>(q);
        else v = __ldg(reinterpret_cast<const longlong2*>(q));
        re = __longlong_as_double(v.x);
        im = 0.0;
        dlt = v.y;
    }
}

// The joint column of an arity <= 2 record word w for a row with label l
// (BITS) or staged slot values vrow.
template <bool BITS>
__device__ __forceinline__ int joint2(unsigned w, unsigned long long l,
                                      const unsigned char* vrow) {
    if constexpr (BITS) {
        const unsigned m0 = (w >> 16) & 255u;
        const unsigned v0 = static_cast<unsigned>(l >> (w & 63u)) & m0;
        const unsigned v1 =
            static_cast<unsigned>(l >> ((w >> 8) & 63u)) & (w >> 24);
        return static_cast<int>(v0 + v1 * (m0 + 1));
    } else {
        return vrow[w & 255u] + vrow[(w >> 8) & 255u] * ((w >> 16) & 255u);
    }
}

// The joint column of a column of arity > 2: the loop over its slots (its
// selectors and strides through __ldg).
template <bool BITS>
__device__ __forceinline__ int joint_any(const Params& p, int e,
                                         unsigned long long l,
                                         const unsigned char* vrow) {
    int c = 0;
    for (int a = 0; a < p.A; ++a) {
        const int sel = __ldg(p.gsel + e * p.A + a);
        const int v = BITS ? static_cast<int>(l >> (sel & 63)) & (sel >> 8)
                           : vrow[sel];
        c += v * __ldg(p.gstr + e * p.A + a);
    }
    return c;
}

// The chunk's images of a row: target labels and amp * sign (re, im) of
// the off-diagonal columns with a nonzero amplitude (bit u of ok); the
// diagonal columns' amp * sign summed into (own_r, own_i). FULL: all U
// columns exist and have arity <= 2, and the chunk runs without a branch
// (its U records, then its U entries, are loaded together, the tests are
// selects on bits), so a warp overlaps the columns' load latencies;
// otherwise each column is guarded and may take the loop over a higher
// arity's slots. JW: some term carries a Jordan-Wigner string (fodd is
// read and the sign computed; else no popcount).
template <int U, bool FULL, bool JW, bool TABS, bool AMP_C, bool BITS>
__device__ __forceinline__ void chunk_images(
        const Params& p, const Shared& s, int e0, long long label,
        unsigned long long fodd, const unsigned char* vrow,
        long long (&tgt)[U], double (&ar)[U], double (&ai)[U], unsigned& ok,
        double& own_r, double& own_i) {
    int4 r[U];
    int c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        r[u] = make_int4(0, 0, 0, 0);
        if (FULL || e0 + u < p.E) r[u] = load_rec<TABS>(p, s, e0 + u);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const unsigned l = static_cast<unsigned>(r[u].x);
        if (!FULL && (l & kGeneric))
            c[u] = joint_any<BITS>(p, e0 + u,
                                   static_cast<unsigned long long>(label),
                                   vrow);
        else
            c[u] = joint2<BITS>(static_cast<unsigned>(r[u].y),
                                static_cast<unsigned long long>(label), vrow);
    }
    double re[U], im[U];
    long long dlt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const unsigned l = static_cast<unsigned>(r[u].x);
        re[u] = 0.0;
        im[u] = 0.0;
        dlt[u] = 0;
        if (FULL || e0 + u < p.E)
            load_entry<TABS, AMP_C>(p, s, static_cast<int>(l & kOffset) + c[u],
                                    !(l & kDiag), re[u], im[u], dlt[u]);
    }
    ok = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const unsigned l = static_cast<unsigned>(r[u].x);
        unsigned long long rb =
            static_cast<unsigned long long>(__double_as_longlong(re[u]));
        unsigned long long ib =
            static_cast<unsigned long long>(__double_as_longlong(im[u]));
        const bool live = ((rb | ib) << 1) != 0;
        if constexpr (JW) {
            // the sign flips the sign bits
            const unsigned long long wm =
                static_cast<unsigned long long>(static_cast<unsigned>(r[u].z))
                | (static_cast<unsigned long long>(
                       static_cast<unsigned>(r[u].w)) << 32);
            const unsigned long long flip =
                static_cast<unsigned long long>(__popcll(fodd & wm) & 1)
                << 63;
            rb ^= flip;
            ib ^= flip;
        }
        const bool dg = (l & kDiag) != 0;
        ar[u] = __longlong_as_double(static_cast<long long>(rb));
        ai[u] = AMP_C ? __longlong_as_double(static_cast<long long>(ib)) : 0.0;
        own_r += dg ? ar[u] : 0.0;
        if constexpr (AMP_C) own_i += dg ? ai[u] : 0.0;
        tgt[u] = label + dlt[u];
        ok |= (live && !dg) ? 1u << u : 0u;
    }
}

// Rows of the targets in ok (basis/index.py::lookup_tables); with CHECK,
// bit u of ``in`` set where target u is a basis label (labels[j] ==
// target).
template <int U, int MODE, bool CHECK>
__device__ __forceinline__ void lookup(const Params& p, const Shared& s,
                                       bool lin_s, const long long (&tgt)[U],
                                       unsigned ok, long long (&j)[U],
                                       unsigned& in) {
    if constexpr (MODE == kDirect) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            j[u] = 0;
            if (ok >> u & 1) {
                const long long t = clampll(tgt[u], 0, p.label_space - 1);
                j[u] = __ldg(static_cast<const int*>(p.t0) + t);
            }
        }
    } else if constexpr (MODE == kLin) {
        const long long* ja = static_cast<const long long*>(p.t0);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            j[u] = 0;
            if (ok >> u & 1) {
                const long long t = clampll(tgt[u], 0, p.label_space - 1);
                long long a, b;
                if (p.sa_shift >= 0) {
                    b = t >> p.sa_shift;
                    a = t & (p.sa - 1);
                } else {
                    b = t / p.sa;
                    a = t - b * p.sa;
                }
                const long long v =
                    lin_s ? static_cast<long long>(s.lin[a]) + s.lin[p.sa + b]
                          : __ldg(ja + a) + __ldg(p.t1 + b);
                j[u] = clampll(v, 0, p.n - 1);
            }
        }
    } else {                            // bsearch: lower bound, in lockstep
        const long long* sorted = static_cast<const long long*>(p.t0);
        long long base[U];
#pragma unroll
        for (int u = 0; u < U; ++u) base[u] = 0;
        long long len = p.n;
        while (len > 1) {
            const long long half = len >> 1;
#pragma unroll
            for (int u = 0; u < U; ++u)
                if ((ok >> u & 1) && __ldg(sorted + base[u] + half) < tgt[u])
                    base[u] += half;
            len -= half;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            j[u] = 0;
            if (ok >> u & 1)
                j[u] = min(base[u] + (__ldg(sorted + base[u]) < tgt[u] ? 1 : 0),
                           p.n - 1);
        }
    }
    in = 0;
    if constexpr (CHECK) {
#pragma unroll
        for (int u = 0; u < U; ++u)
            if ((ok >> u & 1) && __ldg(p.index_labels + j[u]) == tgt[u])
                in |= 1u << u;
    }
}

template <bool X_C>
__device__ __forceinline__ void load_x(const double* x, long long j,
                                       double& re, double& im) {
    if constexpr (X_C) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(x) + j);
        re = v.x;
        im = v.y;
    } else {
        re = __ldg(x + j);
        im = 0.0;
    }
}

template <bool X_C>
__device__ __forceinline__ void store_y(double* y, long long i, double re,
                                        double im) {
    if constexpr (X_C) reinterpret_cast<double2*>(y)[i] = make_double2(re, im);
    else y[i] = re;
}

// y[j] += (re, im), f64 atomics.
template <bool X_C>
__device__ __forceinline__ void add_to(double* y, long long j, double re,
                                       double im) {
    constexpr int C = X_C ? 2 : 1;
    atomicAdd(y + j * C, re);
    if constexpr (X_C) atomicAdd(y + j * C + 1, im);
}

// One block's set-up, shared by both kernels: the regions of its shared
// memory, the staged tables; returns whether lin lookups read them.
template <bool TABS, int MODE, bool AMP_C, bool BITS>
__device__ __forceinline__ bool set_up(const Params& p, unsigned char* raw,
                                       Shared& s) {
    constexpr int W = AMP_C ? 4 : 2;
    const Layout l = layout(p, TABS, W, MODE == kLin && p.lin_shared, !BITS);
    s.rec = reinterpret_cast<const int4*>(raw);
    s.ad = reinterpret_cast<const long long*>(raw + l.ad);
    s.lin = reinterpret_cast<int*>(raw + l.lin);
    s.v = raw + l.v;
    return stage_tables<TABS, MODE, W>(p, raw, l);
}

// The column walk of one row of apply_rows: y += sum_e conj(a) sign x[j]
// over its off-diagonal columns, and the diagonal columns' amp * sign
// summed into own.
template <bool JW, int MODE, bool AMP_C, bool X_C, bool TABS, bool BITS>
__device__ __forceinline__ void gather_row(
        const Params& p, const Shared& s, bool lin_s, long long g,
        long long label, const unsigned char* vrow, double& yr, double& yi,
        double& own_r, double& own_i) {
    constexpr int U = kUnroll<X_C>;
    const unsigned long long fodd =
        JW ? static_cast<unsigned long long>(__ldg(p.fodd + g)) : 0ull;
    const int full = p.E_simple / U * U;
    for (int e0 = 0; e0 < p.E; e0 += U) {
        long long tgt[U], j[U];
        double ar[U], ai[U];
        unsigned ok, in;
        if (e0 < full)
            chunk_images<U, true, JW, TABS, AMP_C, BITS>(
                p, s, e0, label, fodd, vrow, tgt, ar, ai, ok, own_r, own_i);
        else
            chunk_images<U, false, JW, TABS, AMP_C, BITS>(
                p, s, e0, label, fodd, vrow, tgt, ar, ai, ok, own_r, own_i);
        if (ok == 0) continue;
        lookup<U, MODE, false>(p, s, lin_s, tgt, ok, j, in);
        double gr[U], gi[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            gr[u] = 0.0;
            gi[u] = 0.0;
            if (ok >> u & 1) load_x<X_C>(p.x, j[u], gr[u], gi[u]);
        }
        // y[i] += conj(a) * sign * x[j]   (sign folded into a)
#pragma unroll
        for (int u = 0; u < U; ++u) {
            yr += ar[u] * gr[u] + ai[u] * gi[u];
            if constexpr (X_C) yi += ar[u] * gi[u] - ai[u] * gr[u];
        }
    }
}

template <int MODE, bool AMP_C, bool X_C, bool TABS, bool BITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
apply_rows_kernel(const Params p) {
    extern __shared__ int4 smem[];
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
    Shared s;
    const bool lin_s = set_up<TABS, MODE, AMP_C, BITS>(p, raw, s);
    const long long tiles = (p.n_out + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long i = tile * kThreads + threadIdx.x;
        const long long g = p.row0 + i;
        const unsigned char* vrow = nullptr;
        if constexpr (!BITS) {
            const long long g0 = p.row0 + tile * kThreads;
            stage_rows(p, s.v, g0, min(g0 + kThreads, p.n_valid));
            vrow = s.v + threadIdx.x * p.pitch;
        }
        if (i >= p.n_out) continue;
        if (g >= p.n_valid) {
            store_y<X_C>(p.y, i, 0.0, 0.0);
            continue;
        }
        const long long label = __ldg(p.labels + g);
        double xr, xi;
        load_x<X_C>(p.x, g, xr, xi);
        const double d = p.diag != nullptr ? __ldg(p.diag + i) : 0.0;
        double yr = d * xr, yi = d * xi;
        double own_r = 0.0, own_i = 0.0;
        if (p.fodd != nullptr)
            gather_row<true, MODE, AMP_C, X_C, TABS, BITS>(
                p, s, lin_s, g, label, vrow, yr, yi, own_r, own_i);
        else
            gather_row<false, MODE, AMP_C, X_C, TABS, BITS>(
                p, s, lin_s, g, label, vrow, yr, yi, own_r, own_i);
        // the diagonal columns: conj(own) * x[i]
        yr += own_r * xr + own_i * xi;
        if constexpr (X_C) yi += own_r * xi - own_i * xr;
        store_y<X_C>(p.y, i, yr, yi);
    }
}

// The column walk of one row of scatter_rows: y[j] += a sign x[i] over its
// off-diagonal columns whose target is a basis label, a row's consecutive
// adds to one target summed first (pj, the target of the pending sum (pr,
// pi)); the diagonal columns' amp * sign summed into own.
template <bool JW, int MODE, bool AMP_C, bool X_C, bool TABS, bool BITS>
__device__ __forceinline__ void scatter_row(
        const Params& p, const Shared& s, bool lin_s, long long i,
        long long label, const unsigned char* vrow, double xr, double xi,
        double& own_r, double& own_i, long long& pj, double& pr,
        double& pi) {
    constexpr int U = kUnroll<X_C>;
    const unsigned long long fodd =
        JW ? static_cast<unsigned long long>(__ldg(p.fodd + i)) : 0ull;
    const int full = p.E_simple / U * U;
    for (int e0 = 0; e0 < p.E; e0 += U) {
        long long tgt[U], j[U];
        double ar[U], ai[U];
        unsigned ok, in;
        if (e0 < full)
            chunk_images<U, true, JW, TABS, AMP_C, BITS>(
                p, s, e0, label, fodd, vrow, tgt, ar, ai, ok, own_r, own_i);
        else
            chunk_images<U, false, JW, TABS, AMP_C, BITS>(
                p, s, e0, label, fodd, vrow, tgt, ar, ai, ok, own_r, own_i);
        if (ok == 0) continue;
        lookup<U, MODE, true>(p, s, lin_s, tgt, ok, j, in);
        // y[j] += a * sign * x[i]   (no conjugate: forward direction)
#pragma unroll
        for (int u = 0; u < U; ++u) {
            if (!(in >> u & 1)) continue;
            const double cr = ar[u] * xr - ai[u] * xi;
            const double ci = ar[u] * xi + ai[u] * xr;
            if (j[u] == pj) {
                pr += cr;
                pi += ci;
                continue;
            }
            if (pj >= 0) add_to<X_C>(p.y, pj, pr, pi);
            pj = j[u];
            pr = cr;
            pi = ci;
        }
    }
}

template <int MODE, bool AMP_C, bool X_C, bool TABS, bool BITS>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
scatter_rows_kernel(const Params p) {
    extern __shared__ int4 smem[];
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
    Shared s;
    const bool lin_s = set_up<TABS, MODE, AMP_C, BITS>(p, raw, s);
    const long long tiles = (p.n_out + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long i = tile * kThreads + threadIdx.x;
        const unsigned char* vrow = nullptr;
        if constexpr (!BITS) {
            const long long g0 = tile * kThreads;
            stage_rows(p, s.v, g0, min(g0 + kThreads, p.n_out));
            vrow = s.v + threadIdx.x * p.pitch;
        }
        if (i >= p.n_out) continue;
        double xr, xi;
        load_x<X_C>(p.x, i, xr, xi);
        if (xr == 0.0 && xi == 0.0) continue;      // adds nothing
        const long long label = __ldg(p.labels + i);
        // the row's own target: the diagonal and the diagonal columns
        double own_r = p.diag != nullptr ? __ldg(p.diag + i) : 0.0;
        double own_i = 0.0;
        long long pj = -1;
        double pr = 0.0, pi = 0.0;
        if (p.fodd != nullptr)
            scatter_row<true, MODE, AMP_C, X_C, TABS, BITS>(
                p, s, lin_s, i, label, vrow, xr, xi, own_r, own_i, pj, pr,
                pi);
        else
            scatter_row<false, MODE, AMP_C, X_C, TABS, BITS>(
                p, s, lin_s, i, label, vrow, xr, xi, own_r, own_i, pj, pr,
                pi);
        if (own_r != 0.0 || own_i != 0.0) {
            // the row's own label: at row i where the destination is the
            // source's sector (one coalesced read), else looked up
            long long t[1] = {label}, j[1] = {i};
            unsigned in = i < p.n && __ldg(p.index_labels + i) == label;
            if (!in) lookup<1, MODE, true>(p, s, lin_s, t, 1u, j, in);
            if (in) {
                const double cr = own_r * xr - own_i * xi;
                const double ci = own_r * xi + own_i * xr;
                if (p.diag_only) {
                    // no other row adds to the row of this one's label
                    store_y<X_C>(p.y, j[0], cr, ci);
                } else if (j[0] == pj) {
                    pr += cr;
                    pi += ci;
                } else {
                    add_to<X_C>(p.y, j[0], cr, ci);
                }
            }
        }
        if (pj >= 0) add_to<X_C>(p.y, pj, pr, pi);
    }
}

template <bool SCATTER, int MODE, bool AMP_C, bool X_C, bool TABS, bool BITS>
int launch(const Params& p, cudaStream_t stream) {
    auto kern = SCATTER ? scatter_rows_kernel<MODE, AMP_C, X_C, TABS, BITS>
                        : apply_rows_kernel<MODE, AMP_C, X_C, TABS, BITS>;
    const long long smem =
        layout(p, TABS, AMP_C ? 4 : 2, MODE == kLin && p.lin_shared, !BITS)
            .total;
    if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    // The resident grid of this instance on this device at this shared
    // memory size, worked out at its first launch there and kept (one
    // entry a thread: the shared memory follows the operator, so a solve's
    // launches all hit it).
    thread_local int cached_dev = -1;
    thread_local long long cached_smem = -1, resident = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev != cached_dev || smem != cached_smem) {
        if (smem > 48 * 1024) {
            err = cudaFuncSetAttribute(
                kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxShared);
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
            || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kern, kThreads, static_cast<size_t>(smem)))
                   != cudaSuccess)
            return static_cast<int>(err);
        resident = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sms;
        cached_dev = dev;
        cached_smem = smem;
    }
    const long long tiles = (p.n_out + kThreads - 1) / kThreads;
    const long long grid = tiles < resident ? tiles : resident;
    kern<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
           stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <bool SCATTER, int MODE, bool AMP_C, bool X_C>
int pick_place(const Params& p, int tabs, int bits, cudaStream_t st) {
    if (tabs)
        return bits ? launch<SCATTER, MODE, AMP_C, X_C, true, true>(p, st)
                    : launch<SCATTER, MODE, AMP_C, X_C, true, false>(p, st);
    return bits ? launch<SCATTER, MODE, AMP_C, X_C, false, true>(p, st)
                : launch<SCATTER, MODE, AMP_C, X_C, false, false>(p, st);
}

template <bool SCATTER, int MODE>
int pick_types(const Params& p, int amp_c, int x_c, int tabs, int bits,
               cudaStream_t st) {
    if (!amp_c && !x_c)
        return pick_place<SCATTER, MODE, false, false>(p, tabs, bits, st);
    if (!amp_c)
        return pick_place<SCATTER, MODE, false, true>(p, tabs, bits, st);
    if (x_c)
        return pick_place<SCATTER, MODE, true, true>(p, tabs, bits, st);
    return static_cast<int>(cudaErrorInvalidValue);  // complex a, real x
}

// One of the 36 instances of each kernel: (index mode: direct, lin,
// bsearch) x (complex amplitudes, complex vector) x (tables in shared
// memory) x (slot values from label bit fields).
template <bool SCATTER>
int dispatch(Params p, int mode, int amp_c, int x_c, int tabs, int bits,
             cudaStream_t st) {
    if (mode < 0 || mode > 2 || p.n_out <= 0 || p.n <= 0 || p.E < 0 || (p.E > 0 && p.A < 1)
        || (p.A > 2 && (p.gsel == nullptr || p.gstr == nullptr))
        || p.E_simple < 0 || p.E_simple > p.E
        || p.S < 1 || p.S > 255 || (mode == kLin && p.sa < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    // the staged pitch: a multiple of 4 bytes that is an odd number of
    // 4-byte words, so 32 rows' bytes of one slot lie in 32 banks
    p.pitch = (p.S + 3) & ~3;
    if (!((p.pitch >> 2) & 1)) p.pitch += 4;
    if (mode == kLin) {
        p.sb = (p.label_space + p.sa - 1) / p.sa;
        p.sa_shift = (p.sa & (p.sa - 1)) == 0 ? __builtin_ctzll(p.sa) : -1;
        p.lin_shared = 4 * (p.sa + p.sb) <= kLinShared;
    }
    switch (mode) {
        case kDirect:
            return pick_types<SCATTER, kDirect>(p, amp_c, x_c, tabs, bits, st);
        case kLin:
            return pick_types<SCATTER, kLin>(p, amp_c, x_c, tabs, bits, st);
        default:
            return pick_types<SCATTER, kBsearch>(p, amp_c, x_c, tabs, bits,
                                                 st);
    }
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/apply.py::build_library). Each
// returns a cudaError_t value, 0 on success. gsel and gstr (unless some
// column has arity > 2), t1 (unless lin), fodd and diag may be NULL.
// tables_shared picks the instance that stages rec and ad in shared memory
// (the wrapper decides by their size), bits the one that reads slot values
// from label bit fields (the packing decides: every local dim a power of
// two). A direct index's position table t0 holds int32 rows, the other
// modes' tables int64.
#define QBT_ARGS                                                              \
    const int *rec, const long long *ad, const int *gsel, const int *gstr,   \
        int n_cols, int n_simple, int arity, long long n_entries,            \
        int amp_complex,                                                     \
        int bits, int tables_shared, int diag_only, int mode,                \
        const void *t0,                                                      \
        const long long *t1, long long sa, long long label_space,            \
        long long n_index, const long long *index_labels,                    \
        const long long *labels, const signed char *V, int n_slots,          \
        const long long *fodd, const double *diag, const double *x,          \
        int x_complex, double *y

#define QBT_PARAMS                                                            \
    Params p{};                                                               \
    p.rec = reinterpret_cast<const int4*>(rec);                               \
    p.ad = ad;                                                                \
    p.gsel = gsel;                                                            \
    p.gstr = gstr;                                                            \
    p.E = n_cols;                                                             \
    p.E_simple = n_simple;                                                    \
    p.A = arity;                                                              \
    p.M = n_entries;                                                          \
    p.t0 = t0;                                                                \
    p.diag_only = diag_only;                                                  \
    p.t1 = t1;                                                                \
    p.sa = sa;                                                                \
    p.sa_shift = -1;                                                          \
    p.label_space = label_space;                                              \
    p.n = n_index;                                                            \
    p.index_labels = index_labels;                                            \
    p.labels = labels;                                                        \
    p.V = V;                                                                  \
    p.S = n_slots;                                                            \
    p.fodd = fodd;                                                            \
    p.diag = diag;                                                            \
    p.x = x;                                                                  \
    p.y = y;

extern "C" int qbt_apply_rows(QBT_ARGS, long long row0, long long n_out,
                              long long n_valid, void* stream) {
    QBT_PARAMS
    p.row0 = row0;
    p.n_out = n_out;
    p.n_valid = n_valid;
    return dispatch<false>(p, mode, amp_complex, x_complex, tables_shared,
                           bits, static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_scatter_rows(QBT_ARGS, long long n_src, void* stream) {
    QBT_PARAMS
    p.row0 = 0;
    p.n_out = n_src;
    p.n_valid = n_src;
    return dispatch<true>(p, mode, amp_complex, x_complex, tables_shared,
                          bits, static_cast<cudaStream_t>(stream));
}
