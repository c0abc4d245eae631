// The explicit (ELL) SpMV for Hopper (sm_90a): ell_spmv,
//   y[i] = diag[i] xd[i] + sum_k vals[i, k] xs[cols[i, k]],
// over a row-major (n, W) ELL: int64 columns, float64 or complex128 values,
// a float64 diagonal, padded slots (column 0, value 0).
//
// Replaces the XLA program of the JAX package's apply,
// quantum_basis_tpu/ops/sparse.py::EllMatrix.apply (:96, the gather x[cols]
// and a row sum), and the per-rank row reduction of its halo engine,
// quantum_basis_tpu/parallel/halo_sharded.py::_run (:221), where xs is the
// buffer [x_local | halo] and xd the local slice. The port's plain version,
// ops/sparse.py::_ell_spmv_plain, writes and reads back two (n, W)
// intermediates (the gather and the product) before its row sum.
//
// Three instances: real values and a real x, real values and a complex x,
// complex values and a complex x (y complex128 in the last two).
//
// Bound: device-memory bytes. An apply must read the stored ELL once (8
// bytes a column and 8 or 16 a value, (n, W) of each), the diagonal, x and
// write y; the x gathers hit the 50 MB L2 (x is at most 21.6 MB at dim
// 2.7M in complex128). Design: a group of G lanes a row (G the power of
// two at or above W, at most 32; 32 / G rows a warp, two such steps in
// flight), so the group reads its row's columns and values as one
// coalesced segment each, with evict-first loads (__ldcs) that leave L2 to
// x; lane g sums the slots g, g + G, ... in registers, the group reduces
// by shuffles and its first lane writes y: no intermediate goes to device
// memory and no atomics, so y is the same on every run.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;                   // row steps a warp has in flight

struct Cplx {
    double re, im;
};

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

// V: the values' type (double or Cplx), X: x's and y's
template <int G, typename V, typename X>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const long long* __restrict__ cols, const V* __restrict__ vals,
                const double* __restrict__ diag, const X* __restrict__ xd,
                const X* __restrict__ xs, X* __restrict__ y, long long n,
                int W) {
    constexpr int kRowsPerStep = 32 / G;
    constexpr int kRowsPerWarp = kRowsPerStep * kUnroll;
    const int lane = threadIdx.x % 32;
    const int g = lane % G;                  // lane within its row's group
    const long long warp =
        (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / 32;
    const long long r0 = warp * kRowsPerWarp + lane / G;

    X acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) zero(acc[u]);
    // lanes past n (and slots past W) read nothing, but every lane of the
    // warp takes part in the shuffles below
    for (int k = g; k < W; k += G) {
        long long c[kUnroll];
        V v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const long long row = r0 + u * kRowsPerStep;
            c[u] = 0;
            zero(v[u]);
            if (row < n) {
                const long long off = row * W + k;
                c[u] = __ldcs(cols + off);
                v[u] = load_val(vals + off);
            }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (r0 + u * kRowsPerStep < n)
                fma_acc(acc[u], v[u], load_x(xs + c[u]));
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
        group_sum<G>(acc[u]);
        const long long row = r0 + u * kRowsPerStep;
        if (g == 0 && row < n)
            y[row] = add(diag_term(diag[row], load_x(xd + row)), acc[u]);
    }
}

template <int G, typename V, typename X>
int launch(const long long* cols, const void* vals, const double* diag,
           const void* xd, const void* xs, void* y, long long n, int W,
           cudaStream_t stream) {
    constexpr long long kRowsPerBlock =
        (kThreads / 32) * (32 / G) * kUnroll;
    const long long blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    ell_spmv_kernel<G, V, X><<<static_cast<unsigned>(blocks), kThreads, 0,
                               stream>>>(
        cols, static_cast<const V*>(vals), diag, static_cast<const X*>(xd),
        static_cast<const X*>(xs), static_cast<X*>(y), n, W);
    return static_cast<int>(cudaGetLastError());
}

template <typename V, typename X>
int by_width(const long long* cols, const void* vals, const double* diag,
             const void* xd, const void* xs, void* y, long long n, int W,
             cudaStream_t stream) {
    if (W <= 1)
        return launch<1, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
    if (W <= 2)
        return launch<2, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
    if (W <= 4)
        return launch<4, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
    if (W <= 8)
        return launch<8, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
    if (W <= 16)
        return launch<16, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
    return launch<32, V, X>(cols, vals, diag, xd, xs, y, n, W, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). vals_complex / x_complex select
// the instance (complex values need a complex x); n > 0, W >= 0. Returns a
// cudaError_t value; 0 is success.
extern "C" int qbt_ell_spmv(const long long* cols, const void* vals,
                            const double* diag, const void* xd,
                            const void* xs, void* y, long long n, int W,
                            int vals_complex, int x_complex, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n <= 0 || W < 0 || (vals_complex && !x_complex))
        return static_cast<int>(cudaErrorInvalidValue);
    if (vals_complex)
        return by_width<Cplx, Cplx>(cols, vals, diag, xd, xs, y, n, W, s);
    if (x_complex)
        return by_width<double, Cplx>(cols, vals, diag, xd, xs, y, n, W, s);
    return by_width<double, double>(cols, vals, diag, xd, xs, y, n, W, s);
}
