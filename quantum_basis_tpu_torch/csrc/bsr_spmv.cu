// Block-sparse-row (BSR) SpMV for Hopper (sm_90a): y = A x, diagonal excluded.
//
// Replaces the Pallas TPU kernel quantum_basis_tpu/ops/pallas_bsr.py::_bsr_matvec
// (pallas_call at pallas_bsr.py:289). A holds dense 128 x 128 blocks sorted by
// (row tile bi, column tile bj); row_ptr[t]..row_ptr[t+1] are the stored blocks
// of row tile t (built on the host from the sorted bi), in place of the TPU
// kernel's sequential grid with per-block "first" flags.
//
// Design (simple and correct first):
//   * one warp owns 8 rows of one 128-row output tile and writes them exactly
//     once, so no atomics, no shared memory and no ordering or barriers
//     between warps are needed; rows of a tile with no stored block are
//     written with zeros;
//   * lane l always handles columns 4l..4l+3: for each stored block of the
//     tile it loads its 4 entries of the x tile, then streams its 8 block
//     rows with one 16-byte load per row (float4, or two double2), so a warp
//     reads a 512-byte (f32) row with consecutive lanes on consecutive
//     addresses;
//   * partial sums stay in registers across all blocks of the tile and are
//     reduced across the warp with shuffles once at the end;
//   * 16 warps per tile (4 per thread block) keep enough loads in flight to
//     spread even a sector of ~70 row tiles over all SMs.
//
// x and y are (n_pad, C) row-major: C = 1 for a real vector, C = 2 for a
// complex vector (interleaved re/im, torch.view_as_real). A complex matrix
// passes its imaginary blocks as blocks_im (needs C = 2), so one launch reads
// every stored block once: y = (A_re + i A_im)(x_re + i x_im).
//
// Bound: device-memory bandwidth. Each apply streams all stored block values
// (4 * nb * 16384 bytes in f32, twice that with blocks_im) while doing 2
// flops per value per vector component; x and y traffic is ~1/128 of that.
// The design keeps the block stream coalesced and read once per apply; more
// bytes in flight per SM (TMA, wider row tiles) is later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;                     // block edge (rows = columns)
constexpr int kRowsPerWarp = 8;
constexpr int kWarpsPerTile = kTile / kRowsPerWarp;   // 16
constexpr int kWarpsPerCta = 4;
constexpr int kThreads = 32 * kWarpsPerCta;
constexpr int kCtasPerTile = kWarpsPerTile / kWarpsPerCta;
constexpr int kColsPerLane = kTile / 32;       // 4

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p + 2));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T, int C, bool HAS_IM>
__global__ void __launch_bounds__(kThreads)
bsr_spmv_kernel(const T* __restrict__ blocks_re,
                const T* __restrict__ blocks_im,
                const int* __restrict__ row_ptr,
                const int* __restrict__ bj,
                const T* __restrict__ x,
                T* __restrict__ y) {
    static_assert(!HAS_IM || C == 2, "complex blocks need a complex vector");
    const int wid = blockIdx.x * kWarpsPerCta + threadIdx.x / 32;
    const int tile = wid / kWarpsPerTile;
    const int r0 = (wid % kWarpsPerTile) * kRowsPerWarp;
    const int lane = threadIdx.x % 32;
    const int c0 = lane * kColsPerLane;

    T acc[kRowsPerWarp][C];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[r][c] = T(0);

    const int b_end = row_ptr[tile + 1];
    for (int b = row_ptr[tile]; b < b_end; ++b) {
        // this lane's 4 x entries (x row-major (n_pad, C): 4*C values)
        T xv[kColsPerLane * C];
        const T* xp = x + (static_cast<int64_t>(bj[b]) * kTile + c0) * C;
#pragma unroll
        for (int q = 0; q < C; ++q) {
            T t[4];
            load4(xp + 4 * q, t);
#pragma unroll
            for (int i = 0; i < 4; ++i) xv[4 * q + i] = t[i];
        }
        const int64_t boff = static_cast<int64_t>(b) * kTile * kTile
                             + static_cast<int64_t>(r0) * kTile + c0;
        // fully unrolled: acc[r] must index registers at compile time
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
            T a[kColsPerLane];
            load4(blocks_re + boff + r * kTile, a);
            if constexpr (HAS_IM) {
                T ai[kColsPerLane];
                load4(blocks_im + boff + r * kTile, ai);
#pragma unroll
                for (int k = 0; k < kColsPerLane; ++k) {
                    acc[r][0] += a[k] * xv[2 * k] - ai[k] * xv[2 * k + 1];
                    acc[r][1] += a[k] * xv[2 * k + 1] + ai[k] * xv[2 * k];
                }
            } else {
#pragma unroll
                for (int k = 0; k < kColsPerLane; ++k)
#pragma unroll
                    for (int c = 0; c < C; ++c)
                        acc[r][c] += a[k] * xv[k * C + c];
            }
        }
    }

    const int64_t yrow = static_cast<int64_t>(tile) * kTile + r0;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
        for (int c = 0; c < C; ++c) {
            T v = acc[r][c];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0) y[(yrow + r) * C + c] = v;
        }
    }
}

template <typename T, int C, bool HAS_IM>
int launch(const T* blocks_re, const T* blocks_im, const int* row_ptr,
           const int* bj, const T* x, T* y, int n_row_tiles,
           cudaStream_t stream) {
    bsr_spmv_kernel<T, C, HAS_IM><<<n_row_tiles * kCtasPerTile, kThreads, 0,
                                      stream>>>(
        blocks_re, blocks_im, row_ptr, bj, x, y);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* blocks_re, const T* blocks_im, const int* row_ptr,
             const int* bj, const T* x, T* y, int n_row_tiles, int ncomp,
             cudaStream_t stream) {
    if (n_row_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
    if (blocks_im != nullptr) {
        if (ncomp != 2) return static_cast<int>(cudaErrorInvalidValue);
        return launch<T, 2, true>(blocks_re, blocks_im, row_ptr, bj, x, y,
                                  n_row_tiles, stream);
    }
    if (ncomp == 1)
        return launch<T, 1, false>(blocks_re, nullptr, row_ptr, bj, x, y,
                                   n_row_tiles, stream);
    if (ncomp == 2)
        return launch<T, 2, false>(blocks_re, nullptr, row_ptr, bj, x, y,
                                   n_row_tiles, stream);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C interface (loaded with ctypes). Returns a cudaError_t value; 0 is
// success. blocks_im may be NULL (real matrix).
extern "C" int qbt_bsr_spmv_f32(const float* blocks_re, const float* blocks_im,
                                const int* row_ptr, const int* bj,
                                const float* x, float* y, int n_row_tiles,
                                int ncomp, void* stream) {
    return dispatch<float>(blocks_re, blocks_im, row_ptr, bj, x, y,
                           n_row_tiles, ncomp,
                           static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_bsr_spmv_f64(const double* blocks_re,
                                const double* blocks_im, const int* row_ptr,
                                const int* bj, const double* x, double* y,
                                int n_row_tiles, int ncomp, void* stream) {
    return dispatch<double>(blocks_re, blocks_im, row_ptr, bj, x, y,
                            n_row_tiles, ncomp,
                            static_cast<cudaStream_t>(stream));
}
