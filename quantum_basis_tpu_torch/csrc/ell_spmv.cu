// The explicit (ELL) SpMV for Hopper (sm_90a): ell_spmv,
//   y[i] = diag[i] xd[i] + sum_{k < rowlen[i]} vals[i, k] xs[cols[i, k]],
// over a row-major (n, W) ELL: int32 columns (the port's layout, as the JAX
// package stores them; an int64 instance serves the functional wrapper's
// callers), float64 or complex128 values, a float64 diagonal, and each
// row's length rowlen[i] (int32): 1 + the row's last slot of nonzero value,
// 0 for a row of padding. Slots past it are padding (column 0, value 0) and
// add nothing.
//
// Replaces the XLA program of the JAX package's apply,
// quantum_basis_tpu/ops/sparse.py::EllMatrix.apply (:96, the gather x[cols]
// and a row sum over all W slots), and the per-rank row reduction of its
// halo engine, quantum_basis_tpu/parallel/halo_sharded.py::_run (:221),
// where xs is the buffer [x_local | halo] and xd the local slice. The port's
// plain version, ops/sparse.py::_ell_spmv_plain, writes and reads back two
// (n, W) intermediates (the gather and the product) before its row sum.
//
// Three value / x instances: real values and a real x, real values and a
// complex x, complex values and a complex x (y complex128 in the last two).
//
// Bound: device-memory bytes, those of the live slots. An apply must read
// each row's live slots once (4 bytes a column and 8 or 16 a value), its
// length, the diagonal, x, and write y; the x gathers hit the 50 MB L2 (x
// is at most 21.6 MB at dim 2.7M in complex128). A full sector's rows are
// padded up to the widest (about half the slots at chain-24 Sz=0, a fifth
// at kagome-24 Sz=0), which a kernel that reads every stored slot pays for.
// Design: a group of G lanes a row, G a template argument that the wrapper
// chooses from the live lengths (the power of two at or above half their
// mean, at most 32: about two slots a lane), not from W; 32 / G rows a
// warp, two such steps in flight over real values, one over complex values
// (a matrix of no slots, W = 0, reads no row length).
// The group reads only slots k < rowlen[i]: lane g takes g, g + G, ... (a
// row longer than G loops), so its columns and values come as coalesced
// segments of the live part alone, with evict-first loads (__ldcs) that
// leave L2 to x, and the 32-byte sectors past a row's live part are never
// fetched. Lane g sums its slots in registers, the group reduces by
// shuffles and its first lane writes y: no intermediate goes to device
// memory and no atomics, so y is the same on every run.

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

struct Cplx {
    double re, im;
};

// Row steps a warp has in flight: two over real values, one over complex
// values, whose 16-byte loads already keep as many bytes in flight
// (benchmarks/ell_variants.py times the other choice of each on an H100)
template <typename V>
constexpr int kSteps = std::is_same<V, Cplx>::value ? 1 : 2;

// Over real values a row's first lane loads its diagonal term before the
// row loop, its latency hidden under the loop's; over complex values after
// it, where the registers go to the 16-byte values
template <typename V>
constexpr bool kEarlyDiag = !std::is_same<V, Cplx>::value;

__device__ __forceinline__ double load_val(const double* p) {
    return __ldcs(p);
}

__device__ __forceinline__ Cplx load_val(const Cplx* p) {
    const double2 t = __ldcs(reinterpret_cast<const double2*>(p));
    return {t.x, t.y};
}

__device__ __forceinline__ double load_x(const double* p) { return __ldg(p); }

__device__ __forceinline__ Cplx load_x(const Cplx* p) {
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    return {t.x, t.y};
}

__device__ __forceinline__ void zero(double& a) { a = 0.0; }
__device__ __forceinline__ void zero(Cplx& a) { a = {0.0, 0.0}; }

// acc += v x for the three instances
__device__ __forceinline__ void fma_acc(double& acc, double v, double x) {
    acc = fma(v, x, acc);
}
__device__ __forceinline__ void fma_acc(Cplx& acc, double v, Cplx x) {
    acc.re = fma(v, x.re, acc.re);
    acc.im = fma(v, x.im, acc.im);
}
__device__ __forceinline__ void fma_acc(Cplx& acc, Cplx v, Cplx x) {
    acc.re = fma(v.re, x.re, acc.re);
    acc.re = fma(-v.im, x.im, acc.re);
    acc.im = fma(v.re, x.im, acc.im);
    acc.im = fma(v.im, x.re, acc.im);
}

template <int G>
__device__ __forceinline__ void group_sum(double& a) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
        a += __shfl_xor_sync(0xffffffffu, a, off);
}
template <int G>
__device__ __forceinline__ void group_sum(Cplx& a) {
    group_sum<G>(a.re);
    group_sum<G>(a.im);
}

__device__ __forceinline__ double diag_term(double d, double x) {
    return d * x;
}
__device__ __forceinline__ Cplx diag_term(double d, Cplx x) {
    return {d * x.re, d * x.im};
}
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ Cplx add(Cplx a, Cplx b) {
    return {a.re + b.re, a.im + b.im};
}

// C: the columns' type (int or long long), V: the values' (double or
// Cplx), X: x's and y's
template <int G, typename C, typename V, typename X>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const C* __restrict__ cols, const V* __restrict__ vals,
                const int* __restrict__ rowlen,
                const double* __restrict__ diag, const X* __restrict__ xd,
                const X* __restrict__ xs, X* __restrict__ y, long long n,
                int W) {
    constexpr int kUnroll = kSteps<V>;
    constexpr int kRowsPerStep = 32 / G;
    constexpr int kRowsPerWarp = kRowsPerStep * kUnroll;
    const int lane = threadIdx.x % 32;
    const int g = lane % G;                  // lane within its row's group
    const long long warp =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const long long r0 = warp * kRowsPerWarp + lane / G;

    X acc[kUnroll], dx[kUnroll];             // the slots' sum, diag x
    int len[kUnroll];                        // 0 past n: nothing is read
    int top = 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        const long long row = r0 + u * kRowsPerStep;
        len[u] = (W && row < n) ? __ldg(rowlen + row) : 0;
        top = max(top, len[u]);
        zero(acc[u]);
        zero(dx[u]);
        if constexpr (kEarlyDiag<V>)
            if (g == 0 && row < n)
                dx[u] = diag_term(diag[row], load_x(xd + row));
    }
    // only the live slots k < rowlen[row] are read; every lane of the warp
    // leaves the loop and takes part in the shuffles below
    for (int k = g; k < top; k += G) {
        C c[kUnroll];
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            c[u] = 0;
            zero(v[u]);
            if (k < len[u]) {
                const long long off =
                    (r0 + u * kRowsPerStep) * static_cast<long long>(W) + k;
                c[u] = __ldcs(cols + off);
                v[u] = load_val(vals + off);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (k < len[u]) fma_acc(acc[u], v[u], load_x(xs + c[u]));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        group_sum<G>(acc[u]);
        const long long row = r0 + u * kRowsPerStep;
        if (g == 0 && row < n) {
            if constexpr (!kEarlyDiag<V>)
                dx[u] = diag_term(diag[row], load_x(xd + row));
            y[row] = add(dx[u], acc[u]);
        }
    }
}

template <int G, typename C, typename V, typename X>
int launch(const void* cols, const void* vals, const int* rowlen,
           const double* diag, const void* xd, const void* xs, void* y,
           long long n, int W, cudaStream_t stream) {
    constexpr long long kRowsPerBlock =
        (kThreads / 32) * (32 / G) * kSteps<V>;
    const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ell_spmv_kernel<G, C, V, X><<<static_cast<unsigned>(blocks), kThreads, 0,
                                  stream>>>(
        static_cast<const C*>(cols), static_cast<const V*>(vals), rowlen,
        diag, static_cast<const X*>(xd), static_cast<const X*>(xs),
        static_cast<X*>(y), n, W);
    return static_cast<int>(cudaGetLastError());
}

template <typename C, typename V, typename X>
int by_group(const void* cols, const void* vals, const int* rowlen,
             const double* diag, const void* xd, const void* xs, void* y,
             long long n, int W, int G, cudaStream_t s) {
    switch (G) {
        case 1:
            return launch<1, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                      W, s);
        case 2:
            return launch<2, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                      W, s);
        case 4:
            return launch<4, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                      W, s);
        case 8:
            return launch<8, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                      W, s);
        case 16:
            return launch<16, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                       W, s);
        case 32:
            return launch<32, C, V, X>(cols, vals, rowlen, diag, xd, xs, y, n,
                                       W, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}

template <typename C>
int by_type(const void* cols, const void* vals, const int* rowlen,
            const double* diag, const void* xd, const void* xs, void* y,
            long long n, int W, int G, int vals_complex, int x_complex,
            cudaStream_t s) {
    if (vals_complex)
        return by_group<C, Cplx, Cplx>(cols, vals, rowlen, diag, xd, xs, y, n,
                                       W, G, s);
    if (x_complex)
        return by_group<C, double, Cplx>(cols, vals, rowlen, diag, xd, xs, y,
                                         n, W, G, s);
    return by_group<C, double, double>(cols, vals, rowlen, diag, xd, xs, y,
                                       n, W, G, s);
}

}  // namespace

// One launch's arguments, filled by the wrapper's launch record
// (ops/sparse.py::_Args, field by field): the matrix's once, x, y and the
// x instance a call.
struct Args {
    const void* cols;       // (n, W) int32, or int64 where cols64
    const void* vals;       // (n, W) float64 or complex128
    const int* rowlen;      // (n,) 0 <= rowlen[i] <= W
    const double* diag;     // (n,)
    const void* xd;         // (n,) x's type
    const void* xs;         // the vector the columns index, x's type
    void* y;                // (n,) x's type
    long long n;            // > 0
    int W;                  // >= 0
    int G;                  // 1, 2, 4, 8, 16 or 32
    int cols64, vals_complex, x_complex;    // complex values: complex x
};

// Plain C interface (loaded with ctypes). Returns a cudaError_t value; 0
// is success.
extern "C" long long qbt_ell_args_size() { return sizeof(Args); }

extern "C" int qbt_ell_spmv(const Args* a, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a->n <= 0 || a->W < 0 || (a->vals_complex && !a->x_complex))
        return static_cast<int>(cudaErrorInvalidValue);
    if (a->cols64)
        return by_type<long long>(a->cols, a->vals, a->rowlen, a->diag,
                                  a->xd, a->xs, a->y, a->n, a->W, a->G,
                                  a->vals_complex, a->x_complex, s);
    return by_type<int>(a->cols, a->vals, a->rowlen, a->diag, a->xd, a->xs,
                        a->y, a->n, a->W, a->G, a->vals_complex,
                        a->x_complex, s);
}
