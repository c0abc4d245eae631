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
// Design: one thread per column, a grid-stride loop over columns, 256
// threads a block. Pass B holds the first GROUP = 16 rows of its column in
// registers between the subtraction and the projection, so V is read once;
// rows past 16 are read once for the subtraction and once more by a
// krylov_project launch that the wrapper adds (every solve of the port has
// r <= 13 at its default ncv). Passes A and C keep no per-row values and
// take any r (A re-reads w once per group of 16 rows).
//
// The compaction (krylov_compact) replaces rows 0..keep in place with
// [S^T V ; V[m]] and zeroes the rows after: one thread a column stages the
// column's rows 0..m in shared memory (thread-private slots, no barrier),
// then writes each output row once; bytes (m + 1) + rows vectors. S's rows
// from m on must be zero (the wrapper checks), so no row past m is read.
// The staged column takes (m + 1) * 128 * sizeof(T) bytes of shared memory,
// which bounds m + 1 by the type (113 rows in complex128).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;            // rows held in registers by pass B
constexpr int kCompactThreads = 128;
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

// parts[(row0 + q) * P + blockIdx.x] = the block's sum of acc[q], q < cnt.
template <typename T>
__device__ void store_block_sums(const T (&acc)[kGroup], int cnt, int row0,
                                 T* parts, int P) {
    __shared__ T red[kGroup][kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int q = 0; q < kGroup; ++q) {
        if (q < cnt) {
            const T s = warp_sum(acc[q]);
            if (lane == 0) red[q][warp] = s;
        }
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < cnt) {
        T s = zero<T>();
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s = add(s, red[threadIdx.x][w]);
        parts[static_cast<int64_t>(row0 + threadIdx.x) * P + blockIdx.x] = s;
    }
    __syncthreads();
}

// ---------------------------------------------------------------- packs
// U consecutive entries of a row, moved as one load or store of U *
// sizeof(T) bytes: 16 where the rows allow it (the wrapper's choice), else
// one entry.
template <typename T, int U>
struct alignas(sizeof(T) * U) Pack {
    T v[U];
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

// ---------------------------------------------------------------- pass A
// parts[i * P + b] = block b's sum of conj(V[i, k]) w[k], r0 <= i < r1; the
// columns in packs of U (nv packs a row).
template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
krylov_project(const T* __restrict__ V, int64_t ld_v, int r0, int r1,
               const T* __restrict__ w, int64_t nv, T* __restrict__ parts,
               int P) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int g0 = r0; g0 < r1; g0 += kGroup) {
        const int cnt = min(kGroup, r1 - g0);
        const T* Vg = V + static_cast<int64_t>(g0) * ld_v;
        T acc[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) acc[q] = zero<T>();
        for (int64_t kv = static_cast<int64_t>(blockIdx.x) * kThreads
                          + threadIdx.x; kv < nv; kv += stride) {
            const Pack<T, U> x = ldg_pack<T, U>(w + kv * U);
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
                if (q < cnt) {
                    const Pack<T, U> v = ldg_pack<T, U>(Vg + q * ld_v + kv * U);
#pragma unroll
                    for (int u = 0; u < U; ++u)
                        acc[q] = conj_mul_add(acc[q], v.v[u], x.v[u]);
                }
            }
        }
        store_block_sums(acc, cnt, g0, parts, P);
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
    store_block_sums(acc, cnt, 0, parts_out, P_out);
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
// In place, column by column: V[c] = sum_{i<m} S[i, c] V[i] for c < keep,
// V[keep] = the old V[m], V[keep+1 .. rows-1] = 0. S is (>= m, keep)
// row-major. A thread takes a pack of U columns; its rows 0..m are staged in
// shared memory (its own slots, stride kCompactThreads).
template <typename T, int U>
__global__ void __launch_bounds__(kCompactThreads)
krylov_compact(T* V, int64_t ld_v, int64_t nv, int rows, int m,
               const T* __restrict__ S, int keep) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Pack<T, U>* col = reinterpret_cast<Pack<T, U>*>(smem_raw) + threadIdx.x;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kCompactThreads;
    for (int64_t kv = static_cast<int64_t>(blockIdx.x) * kCompactThreads
                      + threadIdx.x; kv < nv; kv += stride) {
        T* Vk = V + kv * U;
#pragma unroll 8
        for (int i = 0; i <= m; ++i)
            col[i * kCompactThreads] = ld_pack<T, U>(Vk + i * ld_v);
        for (int c = 0; c < keep; ++c) {
            T s[U];
#pragma unroll
            for (int u = 0; u < U; ++u) s[u] = zero<T>();
#pragma unroll 4
            for (int i = 0; i < m; ++i) {
                const T sc = ld(S + i * keep + c);
                const Pack<T, U> x = col[i * kCompactThreads];
#pragma unroll
                for (int u = 0; u < U; ++u) s[u] = mul_add(s[u], sc, x.v[u]);
            }
            Pack<T, U> y;
#pragma unroll
            for (int u = 0; u < U; ++u) y.v[u] = s[u];
            st_pack<T, U>(Vk + c * ld_v, y);
        }
        st_pack<T, U>(Vk + keep * ld_v, col[m * kCompactThreads]);
        Pack<T, U> z;
#pragma unroll
        for (int u = 0; u < U; ++u) z.v[u] = zero<T>();
        for (int i = keep + 1; i < rows; ++i) st_pack<T, U>(Vk + i * ld_v, z);
    }
}

// ---------------------------------------------------------------- launches
int grid_for(int64_t n, int threads, int cap) {
    const int64_t g = (n + threads - 1) / threads;
    return static_cast<int>(g < 1 ? 1 : (g > cap ? cap : g));
}

// n entries a row in packs of U (the wrapper makes n, the row stride and
// every pointer a multiple of U entries where U > 1)
template <typename T, int U>
int project(const void* V, int64_t ld_v, int r0, int r1, const void* w,
            int64_t n, void* parts, int P, cudaStream_t s) {
    krylov_project<T, U><<<P, kThreads, 0, s>>>(
        static_cast<const T*>(V), ld_v, r0, r1, static_cast<const T*>(w),
        n / U, static_cast<T*>(parts), P);
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

template <typename T, int U>
int compact(void* V, int64_t ld_v, int64_t n, int rows, int m,
            const void* S, int keep, cudaStream_t s) {
    const size_t smem = static_cast<size_t>(m + 1) * kCompactThreads
                        * sizeof(T) * U;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            krylov_compact<T, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const int grid = grid_for(n / U, kCompactThreads, 16 * 132);
    krylov_compact<T, U><<<grid, kCompactThreads, smem, s>>>(
        static_cast<T*>(V), ld_v, n / U, rows, m, static_cast<const T*>(S),
        keep);
    return static_cast<int>(cudaGetLastError());
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

}  // namespace

extern "C" int qbt_krylov_project(int dtype, int vec, const void* V,
                                  int64_t ld_v,
                                  int r0, int r1, const void* w, int64_t n,
                                  void* parts, int P, void* stream) {
    QBT_DISPATCH(dtype, vec, project, V, ld_v, r0, r1, w, n, parts, P,
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
                                  int keep, void* stream) {
    QBT_DISPATCH(dtype, vec, compact, V, ld_v, n, rows, m, S, keep,
                 static_cast<cudaStream_t>(stream))
}
