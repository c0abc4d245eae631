// Matrix-free apply in momentum (translation) sectors for Hopper (sm_90a):
// the Hermitian row gather y = H x (repr_rows), the scatter y = A x from
// sector k to sector k' = k - q (repr_scatter), and the explicit rows of H
// for the ELL build (repr_images), one launch each.
//
// Replaces the XLA programs of the JAX package's momentum-sector apply,
// quantum_basis_tpu/ops/apply_repr.py::MatvecRepr (block_fn :155 under
// apply :210), mopr_x_vec_repr (:229, scatter_images :275) and
// quantum_basis_tpu/ops/sparse.py::build_sparse_repr (:208). Per row block
// those programs materialise (rows, terms, images) target labels, their
// decoded (rows, terms, images, slots) values and (rows, terms, images, G)
// translated labels and signs in device memory, then a min over G, a
// gather, a checked lookup and the phase. Here every image lives in
// registers.
//
// For basis row i (a representative r = labels[i], the minimum of its
// orbit, with norm nu_i) and every image column e = (group, term, image)
// of the operator's packed tables (ops/apply.py::pack_rows), in order:
//   1. the column's record and entry: joint column c = sum_a V_s(r) *
//      cstr[e, a] over the slots s = cslot[e, a] the term acts on, entry
//      ad[off + c] = (amplitude A, displacement d); A = 0 is padding; the
//      Jordan-Wigner sign (-1) ** popcount(Fodd_i & wmask[e]) folds into A;
//      the image label m = r + d;
//   2. its G translated labels T_g(m) = sum_s V_s(m) SP[s, g]. The
//      translation is linear in the slot values, so with the row's own
//      T_g(r) computed once a row, T_g(m) = T_g(r) + sum_a (V_s(m) -
//      V_s(r)) SP[s, g] over the term's slots: G * arity integer products
//      an image (int64, exact; TranslationSet refuses label spaces above
//      2^53). The minimum r_j and the FIRST g* that reaches it (ties to
//      the lowest g, as torch.min(dim=) and jnp.argmin take them);
//   3. the fermionic sign sigma = (-1) ** (F^T Q_g* F) of the translation
//      at g*: mod 2 it depends on the slots with an odd fermion count
//      only, so with Fodd_m (Fodd_i with the term's slots re-read from m)
//      and one 64-bit mask a (g, slot) holding the row of Q_g, the parity
//      is the xor over the odd slots s of popcount(Fodd_m & Q[g*, s]);
//   4. r_j's row j in the destination's index (direct int32 position
//      table, lin, or a binary search), the image dropped unless
//      labels[j] == r_j (a representative of zero norm, or one outside the
//      sector);
//   5. the phase of g*: phase[g*] = (cos, sin) as the wrapper passes it.
// Then
//   repr_rows:    y_i = diag_i x_i + sum sqrt(nu_j) / sqrt(nu_i) sigma
//                 conj(A) e^{-i k.R_g*} x_j
//   repr_scatter: y_j += x_i / sqrt(nu_i) sqrt(nu'_j) sigma A
//                 e^{+i k'.R_g*}   (f64 atomics on the (re, im) halves, so
//                 the order of summation changes from run to run, as
//                 index_add_'s does on the card)
//   repr_images:  row i's column e: (j, its coefficient in repr_rows), or
//                 (-1, 0) where the image is padding or dropped.
// A diagonal column (every displacement 0, flagged by the packing) maps r
// to itself: the first g with T_g(r) = r is in r's stabilizer, where
// sigma_g e^{i k.R_g} = 1 for any sector in which r has a nonzero norm,
// so its coefficient is A (conj(A) gathering) with no translation: summed
// into the row's own term, and in the scatter sent to r's row of the
// destination. Where every column is diagonal (Sz(q), the S(q, omega)
// injections) the scatter computes no translation at all, and no two rows
// add to one target, so its add is a plain store.
//
// Bound: device-memory bytes. One apply reads each row's label, Fodd where
// fermionic, 1/sqrt(nu_i), the diagonal and x once, writes y once, and
// gathers, for each image kept, the index entry of r_j, labels[j] (the
// check), sqrt(nu_j) and x_j; chip_smoke.py counts the 32-byte sectors
// this run's images touch (k9_bound). What limits this first version
// is the integer work a row: T_g(r) (S * G products), then G compares and
// G * arity products an image.
//
// Design, simple first: one thread a row, 128 rows a block, a grid of as
// many blocks as are resident, each block walking row tiles. The tables
// (the columns' records and entries, their slots and strides, the slots'
// strides and dims, SP, the Q masks and the phases) are staged in shared
// memory once a block up to ops/apply_repr.py::TABLES_SHARED_MAX bytes,
// else read from device memory through the cache. A row's T_g(r) is held
// in shared memory at [g][thread] (no bank conflicts) while 8 * G * 128
// bytes fit TR_SHARED_MAX, above that in a device scratch the wrapper
// allocates ([block][g][thread]); so any G the lattice has is taken. The
// index mode and the tables' placement are uniform branches, not
// instances: one instance a kernel.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxShared = 232448;          // a block's shared memory, sm_90

// word 0 of a column record (ops/apply.py::pack_rows): the offset of its
// entries (bits 0-27) and the diagonal flag (bit 30); words 2, 3: wmask
constexpr unsigned kOffset = (1u << 28) - 1;
constexpr unsigned kDiag = 1u << 30;

enum { kDirect = 0, kLin = 1, kBsearch = 2 };
enum { kRows = 0, kScatter = 1, kImages = 2 };

// Mirrored field by field by ops/apply_repr.py::_Params (ctypes); the
// wrapper checks qbt_repr_params_size() against its own size.
struct Params {
    // the operator's image columns
    const int4* rec;                // (E,) column records
    const long long* ad;            // (M, W) amplitude bits and dlt
    const int* cslot;               // (E, A) slots the term acts on, -1 past
    const int* cstr;                // (E, A) their joint strides
    // the slots and the translations
    const long long* sstride;       // (S,) label strides
    const long long* sdim;          // (S,) local dims
    const long long* oddmask;       // (S,) bit v: F[s, v] odd; null: bosons
    const long long* sp;            // (S, G) SP[s, g]
    const long long* qmask;         // (G, S) bit t of [g, s]: Q_g[s, t]
    const double* phase;            // (G, 2) the phase of g, (re, im)
    // the source rows
    const long long* labels;        // (R,)
    const long long* fodd;          // (R,) or null
    const double* isn;              // (R,) 1 / sqrt(nu_i)
    const double* diag;             // (R,) or null
    // the destination's index and norms
    const void* t0;                 // int32 position table, Ja, or labels
    const long long* t1;            // Jb (lin) or null
    const long long* index_labels;  // (n,) sorted labels
    const double* sqrt_nu;          // (>= n,) sqrt(nu_j)
    // vectors and outputs (complex128 as (re, im) pairs)
    const double* x;
    double* y;
    long long* cols;                // (rows, E) repr_images
    double* vals;                   // (rows, E, 2) repr_images
    long long* tr_scratch;          // null: T_g(r) in shared memory
    long long M, row0, rows, sa, sb, label_space, n, scratch_blocks;
    int E, A, amp_c, S, G, bits, diag_only, mode, sa_shift, tabs_shared,
        threads, pad;
};

__host__ __device__ inline long long align16(long long b) {
    return (b + 15) & ~15ll;
}

// Byte offsets of the regions of a block's dynamic shared memory: the
// tables (where staged), then T_g(r) of the block's rows (where held).
struct Layout {
    long long ad, cslot, cstr, sstride, sdim, odd, sp, q, phase, tr, total;
};

__host__ __device__ inline Layout layout(const Params& p) {
    Layout l{};
    long long o = 0;
    if (p.tabs_shared) {
        o = align16(16ll * p.E);
        l.ad = o;
        o += align16(8ll * (p.amp_c ? 4 : 2) * p.M);
        l.cslot = o;
        o += align16(4ll * p.E * p.A);
        l.cstr = o;
        o += align16(4ll * p.E * p.A);
        l.sstride = o;
        o += align16(8ll * p.S);
        l.sdim = o;
        o += align16(8ll * p.S);
        l.odd = o;
        o += p.oddmask ? align16(8ll * p.S) : 0;
        l.sp = o;
        o += align16(8ll * p.S * p.G);
        l.q = o;
        o += p.qmask ? align16(8ll * p.G * p.S) : 0;
        l.phase = o;
        o += align16(16ll * p.G);
    }
    l.tr = o;
    if (p.tr_scratch == nullptr) o += 8ll * p.G * kThreads;
    l.total = o;
    return l;
}

// Where a block reads the tables: shared memory or device memory.
struct Tabs {
    const int4* rec;
    const long long* ad;
    const int* cslot;
    const int* cstr;
    const long long* sstride;
    const long long* sdim;
    const long long* oddmask;
    const long long* sp;
    const long long* qmask;
    const double2* phase;
};

template <class T>
__device__ const T* stage(const T* src, long long count, unsigned char* raw,
                          long long off, bool shared) {
    if (!shared || src == nullptr) return src;
    T* dst = reinterpret_cast<T*>(raw + off);
    for (long long k = threadIdx.x; k < count; k += kThreads) dst[k] = src[k];
    return dst;
}

__device__ Tabs stage_tables(const Params& p, unsigned char* raw,
                             const Layout& l) {
    const bool sh = p.tabs_shared != 0;
    const int W = p.amp_c ? 4 : 2;
    Tabs t;
    t.rec = stage(p.rec, p.E, raw, 0, sh);
    t.ad = reinterpret_cast<const long long*>(
        stage(reinterpret_cast<const int4*>(p.ad), p.M * W / 2, raw, l.ad,
              sh));
    t.cslot = stage(p.cslot, 1ll * p.E * p.A, raw, l.cslot, sh);
    t.cstr = stage(p.cstr, 1ll * p.E * p.A, raw, l.cstr, sh);
    t.sstride = stage(p.sstride, p.S, raw, l.sstride, sh);
    t.sdim = stage(p.sdim, p.S, raw, l.sdim, sh);
    t.oddmask = stage(p.oddmask, p.S, raw, l.odd, sh);
    t.sp = stage(p.sp, 1ll * p.S * p.G, raw, l.sp, sh);
    t.qmask = stage(p.qmask, 1ll * p.G * p.S, raw, l.q, sh);
    t.phase = stage(reinterpret_cast<const double2*>(p.phase), p.G, raw,
                    l.phase, sh);
    __syncthreads();
    return t;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// V_s(x): the value of slot s in label x (a bit field where every local
// dim is a power of two).
__device__ __forceinline__ long long slot_value(const Params& p,
                                                const Tabs& t, long long x,
                                                int s) {
    const long long st = t.sstride[s];
    if (p.bits) return (x >> (__ffsll(st) - 1)) & (t.sdim[s] - 1);
    return (x / st) % t.sdim[s];
}

// The row of label u in the destination's index (basis/index.py::
// lookup_tables), and whether it holds u (labels[j] == u).
__device__ __forceinline__ long long find(const Params& p, long long u,
                                          bool& in) {
    long long j;
    if (p.mode == kDirect) {
        j = __ldg(static_cast<const int*>(p.t0)
                  + clampll(u, 0, p.label_space - 1));
    } else if (p.mode == kLin) {
        const long long v = clampll(u, 0, p.label_space - 1);
        long long a, b;
        if (p.sa_shift >= 0) {
            b = v >> p.sa_shift;
            a = v & (p.sa - 1);
        } else {
            b = v / p.sa;
            a = v - b * p.sa;
        }
        j = clampll(__ldg(static_cast<const long long*>(p.t0) + a)
                        + __ldg(p.t1 + b),
                    0, p.n - 1);
    } else {                            // lower bound over the labels
        const long long* sorted = static_cast<const long long*>(p.t0);
        long long base = 0, len = p.n;
        while (len > 1) {
            const long long half = len >> 1;
            if (__ldg(sorted + base + half) < u) base += half;
            len -= half;
        }
        j = min(base + (__ldg(sorted + base) < u ? 1 : 0), p.n - 1);
    }
    in = __ldg(p.index_labels + j) == u;
    return j;
}

// The walk of one row's image columns (steps 1-5 above). Calls, per
// column, f.dead(e) (padding), f.own(e, re, im) (a diagonal column:
// amplitude with its Jordan-Wigner sign) or f.image(e, in, j, sigma, re,
// im, g*). ``tr`` points at the row's T_g(r), g at stride kThreads.
template <class F>
__device__ __forceinline__ void walk_row(const Params& p, const Tabs& t,
                                         long long i, long long* tr, F& f) {
    const long long r = __ldg(p.labels + i);
    const unsigned long long fo =
        p.fodd != nullptr ? static_cast<unsigned long long>(__ldg(p.fodd + i))
                          : 0ull;
    if (!p.diag_only) {                 // T_g(r), once a row
        for (int g = 0; g < p.G; ++g) tr[static_cast<long long>(g) * kThreads] = 0;
        for (int s = 0; s < p.S; ++s) {
            const long long v = slot_value(p, t, r, s);
            if (v == 0) continue;
            const long long* row = t.sp + static_cast<long long>(s) * p.G;
            for (int g = 0; g < p.G; ++g)
                tr[static_cast<long long>(g) * kThreads] += v * row[g];
        }
    }
    const int W = p.amp_c ? 4 : 2;
    for (int e = 0; e < p.E; ++e) {
        const int4 rc = t.rec[e];
        const unsigned w0 = static_cast<unsigned>(rc.x);
        const int* cs = t.cslot + static_cast<long long>(e) * p.A;
        const int* cj = t.cstr + static_cast<long long>(e) * p.A;
        long long c = 0;
        int na = 0;
        for (; na < p.A; ++na) {
            const int s = cs[na];
            if (s < 0) break;
            c += slot_value(p, t, r, s) * cj[na];
        }
        const long long* q =
            t.ad + static_cast<long long>(W) * ((w0 & kOffset) + c);
        double re = __longlong_as_double(q[0]);
        double im = p.amp_c ? __longlong_as_double(q[1]) : 0.0;
        if (re == 0.0 && im == 0.0) {
            f.dead(e);
            continue;
        }
        const unsigned long long wm =
            static_cast<unsigned long long>(static_cast<unsigned>(rc.z))
            | (static_cast<unsigned long long>(static_cast<unsigned>(rc.w))
               << 32);
        if (__popcll(fo & wm) & 1) {
            re = -re;
            im = -im;
        }
        if (w0 & kDiag) {
            f.own(e, re, im);
            continue;
        }
        const long long m = r + q[p.amp_c ? 2 : 1];
        // the minimum over g of T_g(m) and the first g that reaches it
        long long best = LLONG_MAX;
        int gs = 0;
        if (na <= 2) {
            int s0 = 0, s1 = 0;
            long long d0 = 0, d1 = 0;
            if (na > 0) {
                s0 = cs[0];
                d0 = slot_value(p, t, m, s0) - slot_value(p, t, r, s0);
            }
            if (na > 1) {
                s1 = cs[1];
                d1 = slot_value(p, t, m, s1) - slot_value(p, t, r, s1);
            }
            const long long* sp0 = t.sp + static_cast<long long>(s0) * p.G;
            const long long* sp1 = t.sp + static_cast<long long>(s1) * p.G;
            for (int g = 0; g < p.G; ++g) {
                const long long v = tr[static_cast<long long>(g) * kThreads]
                                    + d0 * sp0[g] + d1 * sp1[g];
                if (v < best) {
                    best = v;
                    gs = g;
                }
            }
        } else {                        // arity > 2: the slots in a loop
            for (int g = 0; g < p.G; ++g) {
                long long v = tr[static_cast<long long>(g) * kThreads];
                for (int a = 0; a < na; ++a) {
                    const int s = cs[a];
                    v += (slot_value(p, t, m, s) - slot_value(p, t, r, s))
                         * t.sp[static_cast<long long>(s) * p.G + g];
                }
                if (v < best) {
                    best = v;
                    gs = g;
                }
            }
        }
        double sig = 1.0;
        if (p.qmask != nullptr) {       // sigma of g* from Fodd_m
            unsigned long long fm = fo;
            for (int a = 0; a < na; ++a) {
                const int s = cs[a];
                const unsigned long long b =
                    (static_cast<unsigned long long>(t.oddmask[s])
                     >> slot_value(p, t, m, s)) & 1ull;
                fm = (fm & ~(1ull << s)) | (b << s);
            }
            const long long* qg = t.qmask + static_cast<long long>(gs) * p.S;
            int par = 0;
            for (unsigned long long f2 = fm; f2 != 0; f2 &= f2 - 1)
                par ^= __popcll(fm & static_cast<unsigned long long>(
                                         qg[__ffsll(static_cast<long long>(f2)) - 1]));
            if (par & 1) sig = -1.0;
        }
        bool in;
        const long long j = find(p, best, in);
        f.image(e, in, j, sig, re, im, gs);
    }
}

// Row i of y = H x, gathering: sum sqrt(nu_j) / sqrt(nu_i) sigma conj(A)
// phase x_j; the diagonal columns' conj(A) x_i.
struct RowsVisit {
    const Params& p;
    const Tabs& t;
    double isn, yr, yi, own_r, own_i;
    __device__ void dead(int) {}
    __device__ void own(int, double re, double im) {
        own_r += re;
        own_i += im;
    }
    __device__ void image(int, bool in, long long j, double sig, double re,
                          double im, int gs) {
        if (!in) return;
        const double w = __ldg(p.sqrt_nu + j) * isn * sig;
        const double2 ph = t.phase[gs];
        const double cr = w * (re * ph.x + im * ph.y);
        const double ci = w * (re * ph.y - im * ph.x);
        const double2 xv = __ldg(reinterpret_cast<const double2*>(p.x) + j);
        yr += cr * xv.x - ci * xv.y;
        yi += cr * xv.y + ci * xv.x;
    }
};

__device__ __forceinline__ void add_to(double* y, long long j, double re,
                                       double im) {
    atomicAdd(y + 2 * j, re);
    atomicAdd(y + 2 * j + 1, im);
}

// Source row i of y = A x, scattering x_i / sqrt(nu_i) (w): y_j +=
// sqrt(nu'_j) sigma A phase w; the diagonal columns' A summed into own.
struct ScatterVisit {
    const Params& p;
    const Tabs& t;
    double wr, wi, own_r, own_i;
    __device__ void dead(int) {}
    __device__ void own(int, double re, double im) {
        own_r += re;
        own_i += im;
    }
    __device__ void image(int, bool in, long long j, double sig, double re,
                          double im, int gs) {
        if (!in) return;
        const double s = __ldg(p.sqrt_nu + j) * sig;
        const double2 ph = t.phase[gs];
        const double cr = s * (re * ph.x - im * ph.y);
        const double ci = s * (re * ph.y + im * ph.x);
        add_to(p.y, j, cr * wr - ci * wi, cr * wi + ci * wr);
    }
};

// Row i's entries of H, one a column, at out (E of them).
struct ImagesVisit {
    const Params& p;
    const Tabs& t;
    double isn;
    long long i;
    long long* cols;
    double2* vals;
    __device__ void dead(int e) {
        cols[e] = -1;
        vals[e] = make_double2(0.0, 0.0);
    }
    __device__ void own(int e, double re, double im) {
        cols[e] = i;
        vals[e] = make_double2(re, -im);
    }
    __device__ void image(int e, bool in, long long j, double sig, double re,
                          double im, int gs) {
        if (!in) {
            dead(e);
            return;
        }
        const double w = __ldg(p.sqrt_nu + j) * isn * sig;
        const double2 ph = t.phase[gs];
        cols[e] = j;
        vals[e] = make_double2(w * (re * ph.x + im * ph.y),
                               w * (re * ph.y - im * ph.x));
    }
};

// A block's set-up: its tables and where its rows' T_g(r) live.
__device__ __forceinline__ Tabs set_up(const Params& p, unsigned char* raw,
                                       long long*& tr) {
    const Layout l = layout(p);
    const Tabs t = stage_tables(p, raw, l);
    tr = (p.tr_scratch != nullptr
              ? p.tr_scratch + static_cast<long long>(blockIdx.x) * p.G * kThreads
              : reinterpret_cast<long long*>(raw + l.tr))
         + threadIdx.x;
    return t;
}

__global__ void __launch_bounds__(kThreads) repr_rows_kernel(const Params p) {
    extern __shared__ int4 smem[];
    long long* tr;
    const Tabs t = set_up(p, reinterpret_cast<unsigned char*>(smem), tr);
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long k = tile * kThreads + threadIdx.x;
        if (k >= p.rows) continue;
        const long long i = p.row0 + k;
        const double2 xi = __ldg(reinterpret_cast<const double2*>(p.x) + i);
        const double d = p.diag != nullptr ? __ldg(p.diag + i) : 0.0;
        RowsVisit f{p, t, __ldg(p.isn + i), d * xi.x, d * xi.y, 0.0, 0.0};
        walk_row(p, t, i, tr, f);
        // the diagonal columns: conj(own) x_i
        const double yr = f.yr + f.own_r * xi.x + f.own_i * xi.y;
        const double yi = f.yi + f.own_r * xi.y - f.own_i * xi.x;
        reinterpret_cast<double2*>(p.y)[k] = make_double2(yr, yi);
    }
}

__global__ void __launch_bounds__(kThreads)
repr_scatter_kernel(const Params p) {
    extern __shared__ int4 smem[];
    long long* tr;
    const Tabs t = set_up(p, reinterpret_cast<unsigned char*>(smem), tr);
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long k = tile * kThreads + threadIdx.x;
        if (k >= p.rows) continue;
        const long long i = p.row0 + k;
        const double2 xi = __ldg(reinterpret_cast<const double2*>(p.x) + i);
        if (xi.x == 0.0 && xi.y == 0.0) continue;      // adds nothing
        const double isn = __ldg(p.isn + i);
        ScatterVisit f{p, t, xi.x * isn, xi.y * isn,
                       p.diag != nullptr ? __ldg(p.diag + i) : 0.0, 0.0};
        walk_row(p, t, i, tr, f);
        if (f.own_r == 0.0 && f.own_i == 0.0) continue;
        // the row's own label in the destination
        bool in;
        const long long j = find(p, __ldg(p.labels + i), in);
        if (!in) continue;
        const double s = __ldg(p.sqrt_nu + j);
        const double cr = s * (f.own_r * f.wr - f.own_i * f.wi);
        const double ci = s * (f.own_r * f.wi + f.own_i * f.wr);
        if (p.diag_only)    // no other row adds to the row of this label
            reinterpret_cast<double2*>(p.y)[j] = make_double2(cr, ci);
        else
            add_to(p.y, j, cr, ci);
    }
}

__global__ void __launch_bounds__(kThreads)
repr_images_kernel(const Params p) {
    extern __shared__ int4 smem[];
    long long* tr;
    const Tabs t = set_up(p, reinterpret_cast<unsigned char*>(smem), tr);
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long k = tile * kThreads + threadIdx.x;
        if (k >= p.rows) continue;
        const long long i = p.row0 + k;
        ImagesVisit f{p, t, __ldg(p.isn + i), i, p.cols + k * p.E,
                      reinterpret_cast<double2*>(p.vals) + k * p.E};
        walk_row(p, t, i, tr, f);
    }
}

template <int KIND>
int launch(Params p, cudaStream_t stream) {
    if (p.threads != kThreads || p.rows <= 0 || p.n <= 0 || p.E < 0
        || (p.E > 0 && p.A < 1) || p.S < 1 || p.S > 63 || p.G < 1
        || p.mode < kDirect || p.mode > kBsearch
        || (p.mode == kLin && p.sa < 1)
        || (p.qmask != nullptr && p.oddmask == nullptr)
        || (p.tr_scratch != nullptr && p.scratch_blocks < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.mode == kLin) {
        p.sb = (p.label_space + p.sa - 1) / p.sa;
        p.sa_shift = (p.sa & (p.sa - 1)) == 0 ? __builtin_ctzll(p.sa) : -1;
    }
    auto kern = KIND == kRows      ? repr_rows_kernel
                : KIND == kScatter ? repr_scatter_kernel
                                   : repr_images_kernel;
    const long long smem = layout(p).total;
    if (smem > kMaxShared) return static_cast<int>(cudaErrorInvalidValue);
    // the resident grid at this shared memory size, worked out at the
    // first launch on a device and kept
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
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    long long grid = tiles < resident ? tiles : resident;
    if (p.tr_scratch != nullptr && grid > p.scratch_blocks)
        grid = p.scratch_blocks;
    kern<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
           stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/apply_repr.py::build_library).
// Each launch takes a pointer to a Params (void: a type of this file's
// unnamed namespace in the signature would make the symbol local) and
// returns a cudaError_t value, 0 on success.
extern "C" long long qbt_repr_params_size() { return sizeof(Params); }

extern "C" int qbt_repr_rows(const void* p, void* stream) {
    return launch<kRows>(*static_cast<const Params*>(p),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_repr_scatter(const void* p, void* stream) {
    return launch<kScatter>(*static_cast<const Params*>(p),
                            static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_repr_images(const void* p, void* stream) {
    return launch<kImages>(*static_cast<const Params*>(p),
                           static_cast<cudaStream_t>(stream));
}
