// The row stage of the two explicit (ELL) builds for Hopper (sm_90a): one
// warp takes a row's images to the row's finished entries. Included by
// csrc/apply_repr.cu (repr_images, momentum sectors) and csrc/ell_build.cu
// (ell_rows, full sectors); each supplies the image stage, this header the
// rest. It replaces the compaction of the JAX package's builds,
// quantum_basis_tpu/ops/sparse.py::_extract_blocks (:120) through
// native.compact_rows / _compact_rows_np (:30), which the port's plain
// version ops/ell_build.py::compact_rows repeats with torch ops over a
// (rows, E) block in device memory.
//
// The contract (compact_rows'): an image whose |re| + |im| is at or below
// kTol is dropped before the merge; a row's kept images are sorted by
// column, stably in image-slot order; each run of equal columns folds into
// one entry, summed in slot order; an entry at or below kTol after the fold
// is dropped too; the survivors go left in column order and the slots past
// them up to the width W hold (0, 0).
//
// How a warp does it. The image stage puts the row's images 32 at a time
// (a lane an image, in slot order); those above kTol go into the warp's
// scratch (in shared memory, or in device memory where a row is too wide
// for one warp's scratch to fit beside the block's tables: ``plan``)
// packed by a ballot, so the K kept images keep
// their slot order: the column as int32 (every column is a row below 2^31
// - 1) and the value. A kept image's place in (column, slot) order is its
// rank: the kept images of lower column, and those of its column at a
// lower slot, counted over the K columns read four at a time (the warp
// reads the same words: broadcasts). The rank sort takes any E; its work
// is K^2 / 32 compares a lane, and K, not E, because the kept images are
// packed first (K is about half of E at kagome-24). Then the warp
// walks the sorted positions 32 at a time: the head of
// a run (its column differs from the position before) sums the run's
// values in order; a ballot over the heads that survive gives each its
// place (popc of the lanes below), so a row's columns and values are
// stored as two contiguous segments, then padded to W. The count pass of a
// build (write = false) stores nothing and returns the row's count, from
// which the build takes W (ops/ell_build.py::two_pass).

#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace ell_rows {

constexpr double kTol = 1e-14;      // ops/ell_build.py::_VAL_TOL
constexpr int kDrop = INT_MAX;      // past the kept images' columns

__device__ __forceinline__ double mag(double v) { return fabs(v); }
__device__ __forceinline__ double mag(double2 v) {
    return fabs(v.x) + fabs(v.y);
}
__device__ __forceinline__ double plus(double a, double b) { return a + b; }
__device__ __forceinline__ double2 plus(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}
template <class T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ double zero<double>() {
    return 0.0;
}
template <>
__device__ __forceinline__ double2 zero<double2>() {
    return make_double2(0.0, 0.0);
}

__host__ __device__ inline long long a16(long long b) {
    return (b + 15) & ~15ll;
}

// E rounded up to whole int4 words of columns.
__host__ __device__ inline int padded(int E) { return (E + 3) & ~3; }

// Bytes of one warp's scratch for rows of E images, values of vbytes.
__host__ __device__ inline long long scratch_bytes(int E, int vbytes) {
    return 2 * a16(4ll * padded(E)) + a16(static_cast<long long>(vbytes) * E);
}

// Where a block's warps keep their rows' scratch, per_warp bytes a warp
// (a multiple of 16): in shared memory after the block's own base bytes,
// as many warps as fit within ``shared`` bytes a block (at most
// ``warps``), or, where not one fits, in a device buffer that the wrapper
// allocates, ``warps`` a block. A row's scratch grows with E, so a wide
// row costs warps a block, and past a block's shared memory a trip to the
// cache, but never the build.
struct Plan {
    int warps;          // a block's warps
    long long smem;     // its dynamic shared memory
    bool device;        // the scratch in the device buffer
};

inline Plan plan(long long base, long long per_warp, int warps,
                 long long shared) {
    const long long fit = shared > base ? (shared - base) / per_warp : 0;
    if (fit < 1) return {warps, base, true};
    const int w = fit < warps ? static_cast<int>(fit) : warps;
    return {w, base + w * per_warp, false};
}

// This warp's scratch: its part of the device buffer ``device`` (DEV;
// blocks of blockDim.x / 32 warps), else of the block's shared memory from
// ``shared_base``. A kernel takes DEV as a template argument, not a
// runtime choice: a pointer that may be either is read and written with
// generic instructions, which cost the shared-memory rows 10-20% of their
// device time on an H100.
template <bool DEV>
__device__ __forceinline__ unsigned char* region(unsigned char* shared_base,
                                                 unsigned char* device,
                                                 long long per_warp) {
    const long long warp = threadIdx.x >> 5;
    if constexpr (DEV)
        return device
               + (static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                  + warp) * per_warp;
    else
        return shared_base + warp * per_warp;
}

template <class T>
struct Scratch {
    int* col;       // (padded(E),) the kept images' columns, in slot order,
                    // then kDrop to a whole int4
    int* ord;       // (E,) their places in col, in (column, slot) order
    T* val;         // (E,) their values
};

// The warp's scratch at raw (16-byte aligned).
template <class T>
__device__ __forceinline__ Scratch<T> scratch(unsigned char* raw, int E) {
    Scratch<T> s;
    s.col = reinterpret_cast<int*>(raw);
    s.ord = reinterpret_cast<int*>(raw + a16(4ll * padded(E)));
    s.val = reinterpret_cast<T*>(raw + 2 * a16(4ll * padded(E)));
    return s;
}

// Puts one image a lane (the lanes' images in slot order; live false for
// a lane past the row's images): kept where |re| + |im| passes kTol, at
// the next place of the warp's ``kept`` images (the same on every lane).
// Every lane of the warp calls it.
template <class T>
__device__ __forceinline__ void put(const Scratch<T>& s, int& kept,
                                    bool live, long long col, T v) {
    const bool keep = live && mag(v) > kTol;
    const unsigned b = __ballot_sync(0xffffffffu, keep);
    if (keep) {
        const int at = kept + __popc(b & ((1u << (threadIdx.x & 31)) - 1u));
        s.col[at] = static_cast<int>(col);
        s.val[at] = v;
    }
    kept += __popc(b);
}

// The row from the ``kept`` images the warp put: with write, its entries
// at cols[0 .. W) and vals[0 .. W); returns its count (the same on every
// lane). Every lane of the warp calls it.
template <class T>
__device__ int finish(const Scratch<T>& s, int kept, long long* cols,
                      T* vals, int W, bool write) {
    const int lane = threadIdx.x & 31;
    const int K4 = padded(kept);
    if (kept + lane < K4) s.col[kept + lane] = kDrop;
    __syncwarp();
    const int4* c4 = reinterpret_cast<const int4*>(s.col);
    for (int e = lane; e < kept; e += 32) {     // its rank in (column, slot)
        const int c = s.col[e];
        int r = 0;
        for (int f = 0; f < K4; f += 4) {
            const int4 q = c4[f >> 2];
            r += (q.x < c) | ((q.x == c) & (f < e));
            r += (q.y < c) | ((q.y == c) & (f + 1 < e));
            r += (q.z < c) | ((q.z == c) & (f + 2 < e));
            r += (q.w < c) | ((q.w == c) & (f + 3 < e));
        }
        s.ord[r] = e;
    }
    __syncwarp();
    int out = 0;
    for (int p0 = 0; p0 < kept; p0 += 32) {
        const int q = p0 + lane;
        bool keep = false;
        int c = 0;
        T sum = zero<T>();
        if (q < kept) {
            const int e = s.ord[q];
            c = s.col[e];
            if (q == 0 || s.col[s.ord[q - 1]] != c) {   // a run's head
                sum = s.val[e];
                for (int u = q + 1; u < kept; ++u) {
                    const int f = s.ord[u];
                    if (s.col[f] != c) break;
                    sum = plus(sum, s.val[f]);
                }
                keep = mag(sum) > kTol;
            }
        }
        const unsigned b = __ballot_sync(0xffffffffu, keep);
        if (write && keep) {
            const int at = out + __popc(b & ((1u << lane) - 1u));
            cols[at] = c;
            vals[at] = sum;
        }
        out += __popc(b);
    }
    if (write) {
        for (int at = out + lane; at < W; at += 32) {
            cols[at] = 0;
            vals[at] = zero<T>();
        }
    }
    return out;
}

}  // namespace ell_rows
