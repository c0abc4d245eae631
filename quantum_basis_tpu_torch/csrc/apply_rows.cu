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
// For row i with label l, slot values V[i, :] (int8) and Fodd[i] (bit s set
// where slot s holds an odd fermion count), and every image column e =
// (group, term, image k) of the packed tables (ops/apply.py::pack_rows):
//   c      = sum_a V[i, slots[e, a]] * strides[e, a]     (the joint column)
//   idx    = off[e] + c * kstr[e]
//   a      = amp[idx]                                     (0: padding, skipped)
//   sign   = (-1) ** popcount(Fodd[i] & wmask[e])         ((F @ W^T) mod 2)
//   target = l + dlt[idx], its row j through the basis index: direct (one
//            gather of the position table), lin (Ja[t % sa] + Jb[t / sa]) or
//            bsearch (a lower bound over the sorted labels), clamped as
//            basis/index.py::lookup_tables clamps;
//   apply_rows:   y[i]  = diag[i] x[i] + sum_e conj(a) sign x[j]
//   scatter_rows: y[j] += a sign x[i], for targets with labels[j] == target
//                 (the destination index; its diagonal through the same check;
//                 a row's consecutive adds to one target are summed first).
// Vectors are float64 or complex128 (interleaved), amplitudes float64 or
// complex128; sums in f64 registers. apply_rows writes each row once and
// writes rows at or past n_valid as zero (the padding of MatvecSharded);
// scatter_rows adds with f64 atomics (two for complex), so its order of
// summation changes from run to run, as index_add_'s does on the card.
//
// Bound: device-memory bytes. One apply must read each row's state once, as
// its label or its V, whichever is smaller (each decodes to the other), Fodd
// where a term carries a Jordan-Wigner string, x and the diagonal once, and
// write y once (32 bytes a row for a spin chain), plus the index entries that
// the nonzero images touch (32-byte sectors of the position table; about
// 0.06 GB at chain-24 Sz=0), plus the tables (1.5 KB at chain-24): about
// 0.15 GB, about 0.045 ms at 3.35 TB/s at dim 2,704,156 (chip_smoke.py
// computes it from each run's data). This kernel reads both label and V.
//
// Design (simple and correct first): one thread per row; the image columns
// are walked in chunks of kUnroll. A chunk first computes all its targets
// (table reads, uniform across the warp, through the read-only path, where
// the few KB of tables stay in L1), then issues all its index lookups, then
// all its x gathers, so each thread keeps up to kUnroll independent random
// loads in flight per step instead of one dependent chain per image: the
// work is random gathers into an index table larger than L2 (2^24 int64 =
// 134 MB at chain-24; x, 21.6 MB, fits). The binary search runs its kUnroll
// searches in lockstep (the same step count for every target). Images with
// a zero amplitude issue no load. A thread per row needs no reduction across
// lanes; a few lanes per row would add warp shuffles without adding loads in
// flight, which the unrolled chunk already gives.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

struct Tables {
    const int* slots;           // (E, A)
    const int* strides;         // (E, A)
    const int* off;             // (E,)
    const int* kstr;            // (E,)
    const long long* wmask;     // (E,) or null
    const long long* dlt;       // (M,)
    const double* amp;          // (M,) or (M, 2)
    int E, A;
};

struct Index {
    const long long* t0;        // position table, Ja, or the sorted labels
    const long long* t1;        // Jb (lin) or null
    long long sa, label_space, n;
    const long long* labels;    // sorted basis labels (checked lookups)
};

struct Rows {
    const long long* labels;    // (R,)
    const signed char* V;       // (R, S)
    int S;
    const long long* fodd;      // (R,) or null
};

template <typename T>
__device__ __forceinline__ T ld(const T* p) { return __ldg(p); }

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// The chunk's images of row g: target labels and amp * sign (re, im);
// ok[u] false for columns past E and zero amplitudes.
template <bool AMP_C>
__device__ __forceinline__ void chunk_images(
        const Tables& tb, const signed char* v, unsigned long long fodd,
        long long label, int e0, long long (&tgt)[kUnroll],
        double (&ar)[kUnroll], double (&ai)[kUnroll], bool (&ok)[kUnroll]) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const int e = e0 + u;
        ok[u] = false;
        ar[u] = 0.0;
        ai[u] = 0.0;
        tgt[u] = 0;
        if (e < tb.E) {
            int c = 0;
            for (int a = 0; a < tb.A; ++a)
                c += static_cast<int>(ld(v + ld(tb.slots + e * tb.A + a)))
                     * ld(tb.strides + e * tb.A + a);
            const int idx = ld(tb.off + e) + c * ld(tb.kstr + e);
            double re, im = 0.0;
            if constexpr (AMP_C) {
                const double2 z = ld(reinterpret_cast<const double2*>(tb.amp)
                                     + idx);
                re = z.x;
                im = z.y;
            } else {
                re = ld(tb.amp + idx);
            }
            if (re != 0.0 || im != 0.0) {
                if (tb.wmask != nullptr
                    && (__popcll(fodd & static_cast<unsigned long long>(
                            ld(tb.wmask + e))) & 1)) {
                    re = -re;
                    im = -im;
                }
                ok[u] = true;
                ar[u] = re;
                ai[u] = im;
                tgt[u] = label + ld(tb.dlt + idx);
            }
        }
    }
}

// Rows of the targets the chunk keeps (basis/index.py::lookup_tables).
template <int MODE>
__device__ __forceinline__ void lookup(const Index& ix,
                                       const long long (&tgt)[kUnroll],
                                       const bool (&ok)[kUnroll],
                                       long long (&j)[kUnroll]) {
    if constexpr (MODE == 0) {          // direct
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            j[u] = ok[u] ? ld(ix.t0 + clampll(tgt[u], 0, ix.label_space - 1))
                         : 0;
    } else if constexpr (MODE == 1) {   // lin
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            j[u] = 0;
            if (ok[u]) {
                const long long t = clampll(tgt[u], 0, ix.label_space - 1);
                j[u] = clampll(ld(ix.t0 + t % ix.sa) + ld(ix.t1 + t / ix.sa),
                               0, ix.n - 1);
            }
        }
    } else {                            // bsearch: lower bound, in lockstep
        long long base[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) base[u] = 0;
        long long len = ix.n;
        while (len > 1) {
            const long long half = len >> 1;
#pragma unroll
            for (int u = 0; u < kUnroll; ++u)
                if (ok[u] && ld(ix.t0 + base[u] + half) < tgt[u])
                    base[u] += half;
            len -= half;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            j[u] = 0;
            if (ok[u])
                j[u] = min(base[u] + (ld(ix.t0 + base[u]) < tgt[u] ? 1 : 0),
                           ix.n - 1);
        }
    }
}

template <int MODE, bool AMP_C, bool X_C>
__global__ void __launch_bounds__(kThreads)
apply_rows_kernel(Tables tb, Index ix, Rows rw, const double* __restrict__ diag,
                  const double* __restrict__ x, double* __restrict__ y,
                  long long row0, long long n_out, long long n_valid) {
    constexpr int C = X_C ? 2 : 1;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
    if (i >= n_out) return;
    const long long g = row0 + i;
    if (g >= n_valid) {
        y[i * C] = 0.0;
        if constexpr (X_C) y[i * C + 1] = 0.0;
        return;
    }
    const long long label = ld(rw.labels + g);
    const signed char* v = rw.V + g * rw.S;
    const unsigned long long fodd =
        rw.fodd != nullptr ? static_cast<unsigned long long>(ld(rw.fodd + g))
                           : 0ull;
    const double d = diag != nullptr ? ld(diag + i) : 0.0;
    double yr = d * ld(x + g * C);
    double yi = X_C ? d * ld(x + g * C + 1) : 0.0;

    for (int e0 = 0; e0 < tb.E; e0 += kUnroll) {
        long long tgt[kUnroll], j[kUnroll];
        double ar[kUnroll], ai[kUnroll];
        bool ok[kUnroll];
        chunk_images<AMP_C>(tb, v, fodd, label, e0, tgt, ar, ai, ok);
        lookup<MODE>(ix, tgt, ok, j);
        double xr[kUnroll], xi[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            xr[u] = ok[u] ? ld(x + j[u] * C) : 0.0;
            xi[u] = (X_C && ok[u]) ? ld(x + j[u] * C + 1) : 0.0;
        }
        // y[i] += conj(a) * sign * x[j]   (sign folded into a)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            yr += ar[u] * xr[u] + ai[u] * xi[u];
            if constexpr (X_C) yi += ar[u] * xi[u] - ai[u] * xr[u];
        }
    }
    y[i * C] = yr;
    if constexpr (X_C) y[i * C + 1] = yi;
}

// y[j] += (re, im), C values a row.
template <bool X_C>
__device__ __forceinline__ void add_to(double* y, long long j, double re,
                                       double im) {
    constexpr int C = X_C ? 2 : 1;
    atomicAdd(y + j * C, re);
    if constexpr (X_C) atomicAdd(y + j * C + 1, im);
}

template <int MODE, bool AMP_C, bool X_C>
__global__ void __launch_bounds__(kThreads)
scatter_rows_kernel(Tables tb, Index ix, Rows rw,
                    const double* __restrict__ diag,
                    const double* __restrict__ x, double* __restrict__ y,
                    long long n_src) {
    constexpr int C = X_C ? 2 : 1;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads
                        + threadIdx.x;
    if (i >= n_src) return;
    const double xr0 = ld(x + i * C);
    const double xi0 = X_C ? ld(x + i * C + 1) : 0.0;
    if (xr0 == 0.0 && xi0 == 0.0) return;     // adds nothing
    const long long label = ld(rw.labels + i);
    // a row's adds to one target (the diagonal and images with dlt = 0, as
    // in a diagonal with a complex coefficient) are summed in registers and
    // land in one atomic add: pj is the target of the pending sum (pr, pi)
    long long pj = -1;
    double pr = 0.0, pi = 0.0;
    if (diag != nullptr) {
        const double d = ld(diag + i);
        long long t[kUnroll], j[kUnroll];
        bool ok[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            t[u] = label;
            ok[u] = u == 0 && d != 0.0;
        }
        lookup<MODE>(ix, t, ok, j);
        if (ok[0] && ld(ix.labels + j[0]) == label) {
            pj = j[0];
            pr = d * xr0;
            pi = d * xi0;
        }
    }
    const signed char* v = rw.V + i * rw.S;
    const unsigned long long fodd =
        rw.fodd != nullptr ? static_cast<unsigned long long>(ld(rw.fodd + i))
                           : 0ull;
    for (int e0 = 0; e0 < tb.E; e0 += kUnroll) {
        long long tgt[kUnroll], j[kUnroll];
        double ar[kUnroll], ai[kUnroll];
        bool ok[kUnroll];
        chunk_images<AMP_C>(tb, v, fodd, label, e0, tgt, ar, ai, ok);
        lookup<MODE>(ix, tgt, ok, j);
        bool in[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            in[u] = ok[u] && ld(ix.labels + j[u]) == tgt[u];
        // y[j] += a * sign * x[i]   (no conjugate: forward direction)
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            if (!in[u]) continue;
            const double cr = ar[u] * xr0 - ai[u] * xi0;
            const double ci = ar[u] * xi0 + ai[u] * xr0;
            if (j[u] == pj) {
                pr += cr;
                pi += ci;
                continue;
            }
            if (pj >= 0) add_to<X_C>(y, pj, pr, pi);
            pj = j[u];
            pr = cr;
            pi = ci;
        }
    }
    if (pj >= 0) add_to<X_C>(y, pj, pr, pi);
}

template <int MODE, bool AMP_C, bool X_C>
int launch_apply(const Tables& tb, const Index& ix, const Rows& rw,
                 const double* diag, const double* x, double* y,
                 long long row0, long long n_out, long long n_valid,
                 cudaStream_t stream) {
    const long long grid = (n_out + kThreads - 1) / kThreads;
    apply_rows_kernel<MODE, AMP_C, X_C>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            tb, ix, rw, diag, x, y, row0, n_out, n_valid);
    return static_cast<int>(cudaGetLastError());
}

template <int MODE, bool AMP_C, bool X_C>
int launch_scatter(const Tables& tb, const Index& ix, const Rows& rw,
                   const double* diag, const double* x, double* y,
                   long long n_src, cudaStream_t stream) {
    const long long grid = (n_src + kThreads - 1) / kThreads;
    scatter_rows_kernel<MODE, AMP_C, X_C>
        <<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
            tb, ix, rw, diag, x, y, n_src);
    return static_cast<int>(cudaGetLastError());
}

// One of the nine (index mode, complex amplitudes, complex vector)
// instances; a complex amplitude needs a complex vector.
template <bool SCATTER>
int dispatch(const Tables& tb, const Index& ix, const Rows& rw,
             const double* diag, const double* x, double* y, int mode,
             int amp_c, int x_c, long long row0, long long n_out,
             long long n_valid, cudaStream_t stream) {
    if (amp_c && !x_c) return static_cast<int>(cudaErrorInvalidValue);
    if (mode < 0 || mode > 2 || n_out <= 0 || ix.n <= 0 || tb.E < 0
        || (tb.E > 0 && tb.A < 1)
        || n_out > (static_cast<long long>(kThreads) << 31) - kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
#define QBT_CASE(M, AC, XC)                                                   \
    if (mode == M && amp_c == AC && x_c == XC)                                \
        return SCATTER ? launch_scatter<M, AC, XC>(tb, ix, rw, diag, x, y,    \
                                                   n_out, stream)             \
                       : launch_apply<M, AC, XC>(tb, ix, rw, diag, x, y,      \
                                                 row0, n_out, n_valid,        \
                                                 stream);
    QBT_CASE(0, 0, 0) QBT_CASE(0, 0, 1) QBT_CASE(0, 1, 1)
    QBT_CASE(1, 0, 0) QBT_CASE(1, 0, 1) QBT_CASE(1, 1, 1)
    QBT_CASE(2, 0, 0) QBT_CASE(2, 0, 1) QBT_CASE(2, 1, 1)
#undef QBT_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/apply.py::build_library). Each
// returns a cudaError_t value, 0 on success. wmask, t1 (unless lin), fodd and
// diag may be NULL.
#define QBT_TABLE_ARGS                                                        \
    const int *slots, const int *strides, const int *off, const int *kstr,   \
        const long long *wmask, const long long *dlt, const double *amp,     \
        int n_cols, int arity, int amp_complex, int mode,                    \
        const long long *t0, const long long *t1, long long sa,              \
        long long label_space, long long n_index,                            \
        const long long *index_labels, const long long *labels,              \
        const signed char *V, int n_slots, const long long *fodd,            \
        const double *diag, const double *x, int x_complex, double *y

extern "C" int qbt_apply_rows(QBT_TABLE_ARGS, long long row0, long long n_out,
                              long long n_valid, void* stream) {
    const Tables tb{slots, strides, off, kstr, wmask, dlt, amp, n_cols, arity};
    const Index ix{t0, t1, sa, label_space, n_index, index_labels};
    const Rows rw{labels, V, n_slots, fodd};
    return dispatch<false>(tb, ix, rw, diag, x, y, mode, amp_complex,
                           x_complex, row0, n_out, n_valid,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_scatter_rows(QBT_TABLE_ARGS, long long n_src,
                                void* stream) {
    const Tables tb{slots, strides, off, kstr, wmask, dlt, amp, n_cols, arity};
    const Index ix{t0, t1, sa, label_space, n_index, index_labels};
    const Rows rw{labels, V, n_slots, fodd};
    return dispatch<true>(tb, ix, rw, diag, x, y, mode, amp_complex,
                          x_complex, 0, n_src, n_src,
                          static_cast<cudaStream_t>(stream));
}
