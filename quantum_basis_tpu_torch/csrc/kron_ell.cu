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
// quantum_basis_tpu/ops/apply_kron.py::KronOp.apply (layout="ell", :138-146),
// which applies each ELL slot as a gather over the whole frame plus an FMA.
// A and B are the two factor Hamiltonians' off-diagonal parts in ELL form,
// stored slot-major (W, n): int32 columns, values, and a per-row count of
// live slots (the build packs live slots to the left, so a row stops at its
// real entries, not at the padded width). psi_full is the matrix the A side
// gathers rows from: psi itself on one device, the all-gathered state on a
// group of ranks (A's rows are then the rank's, its columns global). P
// (optional) is int8 or float32.
//
// Bound: device-memory bytes. One apply must read psi (and psi_full) once,
// P once and write y once; the arithmetic is ~2 flops per stored factor
// entry per column, far below the card's rate. The two sides gather along
// different axes of psi: A reads whole rows Ac[r,k] of psi at the output's
// columns, B reads scattered entries of the output's own row. No one order
// of the grid keeps both on chip: a column tile of all rows (13 MB of psi in
// f32 at 12870 x 256) serves A from L2, but B would then re-read each psi row
// once per column tile. So the apply is one call in two passes, each ordered
// for its side and each reading psi from device memory about once:
//   1. kron_ell_a: one thread per (r, c), a CTA per (4 rows, column tile),
//      row blocks fastest in the grid, so the CTAs that run together share
//      one column tile of psi_full (256 columns in f32, 128 in f64: 13 MB at
//      4x4) and the ~17 coalesced row gathers per output hit L2; A's entries
//      of a row are the same for the whole CTA (broadcast loads); writes
//      y = the A-side sum.
//   2. kron_ell_b: a CTA per block of R consecutive rows stages those rows
//      of psi in shared memory (R = 4 in f32, 2 in f64 at nb = 12870; the
//      opt-in above 48 KB), then walks all columns: B's slot k of column c
//      is one coalesced load, reused for the R rows, and the scattered
//      gathers psi[r, Bc[c,k]] hit shared memory instead of L1 (a warp's 32
//      scattered 4-byte loads cost ~32 L1 wavefronts but ~4 bank cycles);
//      adds the diagonal, the coupling and the B-side sum to y. Rows too
//      long for shared memory are read from global memory one at a time.
// Both passes are bound by L2 traffic, not device memory: pass 1 reads ~17
// frames of psi from L2, pass 2 reads B's slots once per row block. Fewer L2
// bytes (a basis order whose neighbouring rows share neighbours, a single
// pass), TMA and the like are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRowsA = 4;          // rows of a pass-1 CTA
constexpr int kThreadsB = 1024;    // threads of a pass-2 CTA
constexpr int kMaxRowsB = 4;       // rows a pass-2 CTA stages at most
constexpr int kSmemMax = 232448;   // shared memory a CTA may opt in to (sm_90)

// Pass 1: y[r, c] = sum_k Av[k, r] psi_full[Ac[k, r], c].
template <typename T, int TILE>
__global__ void __launch_bounds__(TILE)
kron_ell_a(const int* __restrict__ ac, const T* __restrict__ av,
           const int* __restrict__ acnt, const T* __restrict__ psi_full,
           T* __restrict__ y, int nrows, int nb) {
    const int c = blockIdx.y * TILE + threadIdx.x;
    if (c >= nb) return;
    const T* base = psi_full + c;
    for (int i = 0; i < kRowsA; ++i) {
        const int r = blockIdx.x * kRowsA + i;
        if (r >= nrows) return;
        const int n = acnt[r];
        const int* cols = ac + r;      // slot k at cols[k * nrows]
        const T* vals = av + r;
        T acc0 = T(0), acc1 = T(0);
        int k = 0;
        // four independent gathers in flight per thread
        for (; k + 4 <= n; k += 4) {
            const int64_t o = static_cast<int64_t>(k) * nrows;
            const T p0 = __ldg(base + static_cast<int64_t>(cols[o]) * nb);
            const T p1 = __ldg(base
                               + static_cast<int64_t>(cols[o + nrows]) * nb);
            const T p2 = __ldg(
                base + static_cast<int64_t>(cols[o + 2 * nrows]) * nb);
            const T p3 = __ldg(
                base + static_cast<int64_t>(cols[o + 3 * nrows]) * nb);
            acc0 += vals[o] * p0 + vals[o + 2 * nrows] * p2;
            acc1 += vals[o + nrows] * p1 + vals[o + 3 * nrows] * p3;
        }
        for (; k < n; ++k) {
            const int64_t o = static_cast<int64_t>(k) * nrows;
            acc0 += vals[o] * __ldg(base + static_cast<int64_t>(cols[o]) * nb);
        }
        y[static_cast<int64_t>(r) * nb + c] = acc0 + acc1;
    }
}

// Pass 2: y[r, c] += (adiag[r] + bdiag[c] + s P[r,c]) psi[r,c]
//                    + sum_k Bv[k, c] psi[r, Bc[k, c]]
// for the R rows of this CTA, staged in shared memory when STAGE.
template <typename T, int R, bool STAGE>
__global__ void __launch_bounds__(kThreadsB)
kron_ell_b(const int* __restrict__ bc, const T* __restrict__ bv,
           const int* __restrict__ bcnt, const T* __restrict__ adiag,
           const T* __restrict__ bdiag, const void* __restrict__ P,
           int p_kind, T ps, const T* __restrict__ psi, T* __restrict__ y,
           int nrows, int nb) {
    extern __shared__ unsigned char smem[];
    const int r0 = blockIdx.x * R;
    const int nr = min(R, nrows - r0);
    const T* src = psi + static_cast<int64_t>(r0) * nb;
    const T* rows = src;
    if constexpr (STAGE) {
        T* staged = reinterpret_cast<T*>(smem);
        for (int i = threadIdx.x; i < nr * nb; i += kThreadsB)
            staged[i] = src[i];
        __syncthreads();
        rows = staged;
    }
    for (int c = threadIdx.x; c < nb; c += kThreadsB) {
        const int n = bcnt[c];
        T acc[R];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i] = T(0);
        for (int k = 0; k < n; ++k) {
            const int64_t o = static_cast<int64_t>(k) * nb + c;
            const int j = bc[o];
            const T v = bv[o];
#pragma unroll
            for (int i = 0; i < R; ++i) acc[i] += v * rows[i * nb + j];
        }
        const T bd = bdiag[c];
#pragma unroll
        for (int i = 0; i < R; ++i) {
            if (i >= nr) break;
            const int64_t idx = static_cast<int64_t>(r0 + i) * nb + c;
            T d = adiag[r0 + i] + bd;
            if (p_kind == 1)
                d += ps * static_cast<T>(static_cast<const int8_t*>(P)[idx]);
            else if (p_kind == 2)
                d += ps * static_cast<T>(static_cast<const float*>(P)[idx]);
            y[idx] += acc[i] + d * rows[i * nb + c];
        }
    }
}

template <typename T, int R, bool STAGE>
int launch_b(const int* bc, const T* bv, const int* bcnt, const T* adiag,
             const T* bdiag, const void* P, int p_kind, T ps, const T* psi,
             T* y, int nrows, int nb, cudaStream_t stream) {
    const int smem = STAGE ? R * nb * static_cast<int>(sizeof(T)) : 0;
    if (STAGE) {
        const cudaError_t e = cudaFuncSetAttribute(
            kron_ell_b<T, R, STAGE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    kron_ell_b<T, R, STAGE><<<(nrows + R - 1) / R, kThreadsB, smem,
                              stream>>>(bc, bv, bcnt, adiag, bdiag, P,
                                        p_kind, ps, psi, y, nrows, nb);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(const int* ac, const T* av, const int* acnt, const int* bc,
          const T* bv, const int* bcnt, const T* adiag, const T* bdiag,
          const void* P, int p_kind, double ps, const T* psi,
          const T* psi_full, T* y, int nrows, int nb, cudaStream_t stream) {
    if (nrows < 0 || nb < 0 || p_kind < 0 || p_kind > 2)
        return static_cast<int>(cudaErrorInvalidValue);
    if (nrows == 0 || nb == 0) return 0;
    // f32: 256 columns of 4 bytes, f64: 128 of 8, a column tile of psi per
    // KB of its rows
    constexpr int kTileA = 1024 / static_cast<int>(sizeof(T));
    const int tiles = (nb + kTileA - 1) / kTileA;
    if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
    kron_ell_a<T, kTileA>
        <<<dim3((nrows + kRowsA - 1) / kRowsA, tiles), kTileA, 0, stream>>>(
            ac, av, acnt, psi_full, y, nrows, nb);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const T s = static_cast<T>(ps);
    const int64_t row_bytes = static_cast<int64_t>(nb) * sizeof(T);
    const int64_t fit = kSmemMax / row_bytes;
    if (fit >= kMaxRowsB && nrows >= kMaxRowsB)
        return launch_b<T, kMaxRowsB, true>(bc, bv, bcnt, adiag, bdiag, P,
                                            p_kind, s, psi, y, nrows, nb,
                                            stream);
    if (fit >= 2 && nrows >= 2)
        return launch_b<T, 2, true>(bc, bv, bcnt, adiag, bdiag, P, p_kind, s,
                                    psi, y, nrows, nb, stream);
    if (fit >= 1)
        return launch_b<T, 1, true>(bc, bv, bcnt, adiag, bdiag, P, p_kind, s,
                                    psi, y, nrows, nb, stream);
    return launch_b<T, 1, false>(bc, bv, bcnt, adiag, bdiag, P, p_kind, s,
                                 psi, y, nrows, nb, stream);
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns a cudaError_t value; 0 is
// success. A's arrays are (W_A, nrows) and B's (W_B, nb), slot-major; p_kind:
// 0 no coupling (P may be NULL), 1 int8 P, 2 float32 P. psi and y are the
// caller's (nrows, nb) rows, psi_full the (any rows, nb) matrix A's columns
// index; y must not alias either.
extern "C" int qbt_kron_ell_f32(const int* ac, const float* av,
                                const int* acnt, const int* bc,
                                const float* bv, const int* bcnt,
                                const float* adiag, const float* bdiag,
                                const void* P, int p_kind, double ps,
                                const float* psi, const float* psi_full,
                                float* y, int nrows, int nb, void* stream) {
    return apply<float>(ac, av, acnt, bc, bv, bcnt, adiag, bdiag, P, p_kind,
                        ps, psi, psi_full, y, nrows, nb,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_kron_ell_f64(const int* ac, const double* av,
                                const int* acnt, const int* bc,
                                const double* bv, const int* bcnt,
                                const double* adiag, const double* bdiag,
                                const void* P, int p_kind, double ps,
                                const double* psi, const double* psi_full,
                                double* y, int nrows, int nb, void* stream) {
    return apply<double>(ac, av, acnt, bc, bv, bcnt, adiag, bdiag, P, p_kind,
                         ps, psi, psi_full, y, nrows, nb,
                         static_cast<cudaStream_t>(stream));
}
