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
//   1. the column's record and entry: joint column c of r's values on the
//      term's slots, entry off[e] + c = (amplitude A, displacement d); A = 0
//      is padding; the Jordan-Wigner sign (-1) ** popcount(Fodd_i &
//      wmask[e]) folds into A; the image label m = r + d;
//   2. its G translated labels T_g(m) = sum_s V_s(m) SP[s, g], their
//      minimum r_j and the FIRST g* that reaches it (ties to the lowest g,
//      as torch.min(dim=) and jnp.argmin take them);
//   3. the fermionic sign sigma = (-1) ** (F^T Q_g* F) of the translation
//      at g*: mod 2 it depends on the slots with an odd fermion count only,
//      so with Fodd_m and one 64-bit mask a (g, slot) holding the row of
//      Q_g, the parity is the xor over the odd slots s of popcount(Fodd_m &
//      Q[g*, s]);
//   4. r_j's row j in the destination's index (direct int32 position
//      table, lin, or a binary search), the image dropped unless the
//      destination's label there is r_j (a representative of zero norm, or
//      one outside the sector);
//   5. the phase of g*: phase[g*] = (cos, sin) as the wrapper passes it.
// Then
//   repr_rows:    y_i = diag_i x_i + sum sqrt(nu_j) / sqrt(nu_i) sigma
//                 conj(A) e^{-i k.R_g*} x_j
//   repr_scatter: y_j += x_i / sqrt(nu_i) sqrt(nu'_j) sigma A
//                 e^{+i k'.R_g*}   (f64 atomics on the (re, im) halves, so
//                 the order of summation changes from run to run, as
//                 index_add_'s does on the card; the launch zeroes y first)
//   repr_images:  row i of the explicit (ELL) matrix: each image's (j, its
//                 coefficient in repr_rows), merged and compacted by the
//                 row stage of csrc/ell_rows.cuh (a warp a row, below).
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
// gathers, for each image kept, the index entry of r_j, the destination's
// label (the check) and sqrt(nu_j), and x_j; chip_smoke.py counts the
// 32-byte sectors this run's images touch (k9_bound).
//
// Two paths, chosen by the wrapper (ops/apply_repr.py::entry_plan):
//
// The entry path (G <= 32, label space below 2^27-2^29, the staged tables
// within ENTRY_TABLES_MAX). An entry off[e] + c fixes the term's slot values
// before the image (c) and after it (d), so the change of every translated
// label, Delta[entry][g] = sum_a (V_sa(m) - V_sa(r)) SP[sa, g], is a
// constant of the entry, and so is the change of Fodd (an xor mask). The
// wrapper packs them once per (operator, translation set): an entry row of
// int32 words, (re, im) of A as four words, then Delta_g << SH for the G
// bucket GB = 8, 16 or 32 (SH = 3, 4, 5; 0 past G), at a pitch of GB + 4
// words (an odd number of 16-byte units: the rows a warp reads lie in
// distinct banks). A row computes its keys K_g = T_g(r) << SH | g once, in
// 32-bit registers (GB of them), over its nonzero slots; an image's key is
// then K_g + row[g], and one unsigned min over g gives r_j (key >> SH) and
// the first g* at it (key & (GB - 1)) at once: no slot of m decoded, no
// multiply, two integer instructions a g. Keys past G hold 0xFFFFFFFF. The
// image columns are walked in chunks of kChunk = 4: a chunk's minima first,
// then all its index lookups, then each kept image's destination record,
// so a thread keeps 4 independent random loads in flight; an image holds
// its entry's index, not its amplitude (read again from shared memory),
// which keeps a thread under 128 registers. What
// bounds the walk on the card is the number of uncoalesced gathers an
// image issues (each costs the L1 one pass a distinct line). repr_rows
// reaches a row by its label: the wrapper passes its device's label buffer
// (label space x 16 bytes, zero but at the labels of the basis that last
// used it), a pre-pass (repr_rows_kernel_pack) writes sqrt(nu_j) x_j at
// label j, and an image gathers that one 16-byte value at r_j, with no
// lookup and no check (an absent label holds 0); a launch is the pre-pass
// and the walk. Where the buffer would pass its bound the wrapper takes
// the general path. (Summing the scatter by label the same way, with a
// pass that reads the destination's labels back, was slower on the card
// than its lookups.) The scatter and the images look r_j up in the index
// (a momentum basis' direct table holds n for a label it does not hold)
// and gather (label, sqrt(nu_j)) for the check. A block stages every
// table it reads (records, entry rows, Fodd masks, SP rows, the slots'
// (shift, mask) or (stride, dim), phases, Q masks) from one contiguous
// blob the wrapper packs, with 16-byte loads. Instances: GB x fermionic,
// times the index mode for the scatter and the images.
//
// The general path (everything else: G > 32, as a chain of 40 sites, or
// labels past 2^27): int64 arithmetic. A row's T_g(r) (S * G products) is
// held in shared memory at [g][thread] while 8 * G * 128 bytes fit
// TR_SHARED_MAX, above that in a device scratch the wrapper allocates; an
// image's T_g(m) = T_g(r) + sum over the term's slots of (V_s(m) - V_s(r))
// SP[s, g]; the tables in shared memory up to TABLES_SHARED_MAX bytes, else
// read through the cache. One instance a kernel; the index mode and the
// tables' placement are uniform branches.
//
// repr_rows and repr_scatter: one thread a row, 128 rows a block, a grid of
// as many blocks as are resident, each block walking row tiles.
//
// repr_images (redesigned for the ELL build: the rows come out finished):
// one warp a row, a lane an image column (e = lane, lane + 32, ...). On the
// entry path the warp's lanes compute the row's G keys first (lane g, over
// the nonzero slots) into the warp's shared memory, and an image reads them
// back as broadcasts; on the general path they compute T_g(r) so. Each
// image (steps 1-5, its lookup and destination record a lane) goes into the
// warp's scratch, and ell_rows::finish sorts, merges and stores the row
// (coalesced: a row's entries are two contiguous segments; no (rows, E)
// block reaches device memory). A block has 4 warps, fewer where a warp's
// keys and scratch (about 24 bytes an image column) are too wide for 4 to
// fit beside the staged tables, and where not one fits (the general path
// only: the entry tables never hold that many columns) the warps' regions
// live in a device buffer the wrapper allocates (ell_rows::plan,
// qbt_repr_images_scratch): a row of any E builds. A build is two launches:
// a count pass that stores only each warp's widest row (one atomicMax a
// warp), from which the wrapper takes the sector's width W (its one host
// sync), and the pass that writes the (rows, W) rows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ell_rows.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;               // entry path: <= 128 registers
// The general path at <= 80 registers: left to itself the compiler took 112
// and the walk ran 24% slower than at 72 (0.56 against 0.45 ms at
// kagome-24); at 6 blocks an SM, 0.47.
constexpr int kMinBlocksGeneral = 6;
constexpr int kMaxShared = 232448;          // a block's shared memory, sm_90

// word 0 of a column record (ops/apply.py::pack_rows): the offset of its
// entries (bits 0-27), the diagonal flag (bit 30), arity > 2 (bit 31);
// words 2, 3: wmask
constexpr unsigned kOffset = (1u << 28) - 1;
constexpr unsigned kDiag = 1u << 30;
constexpr unsigned kGeneric = 1u << 31;

enum { kDirect = 0, kLin = 1, kBsearch = 2 };
enum { kRows = 0, kScatter = 1, kImages = 2 };

// Mirrored field by field by ops/apply_repr.py::_Params (ctypes); the
// wrapper checks qbt_repr_params_size() against its own size.
struct Params {
    // the operator's image columns (the general path)
    const int4* rec;                // (E,) column records
    const long long* ad;            // (M, W) amplitude bits and dlt
    const int* cslot;               // (E, A) slots the term acts on, -1 past
    const int* cstr;                // (E, A) their joint strides
    // the slots and the translations (the general path)
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
    int* cols;                      // (rows, W) repr_images
    double* vals;                   // (rows, W, 2) repr_images
    long long* tr_scratch;          // null: T_g(r) in shared memory
    // the entry path
    const int4* blob;               // its staged tables, blob_bytes
    const int* gsel;                // (E, A) slot selectors (arity > 2)
    const int* gstr;                // (E, A) joint strides (arity > 2)
    const longlong2* rrec;          // (n,) destination (label, sqrt(nu)):
                                    // the scatter and the images
    double* xlab;                   // (>= label_space, 2): repr_rows'
                                    // sqrt(nu_j) x_j at label j, else 0
    int* width;                     // repr_images' count pass: its widest
                                    // row (atomicMax)
    unsigned char* row_scratch;     // repr_images: the warps' regions where
                                    // not in shared memory, or null
    long long M, row0, rows, sa, sb, label_space, n, scratch_blocks,
        blob_bytes;
    long long row_blocks;           // the blocks row_scratch holds
    long long row_shared;           // repr_images: a block's shared memory
                                    // it takes
    int E, A, amp_c, S, G, bits, diag_only, mode, sa_shift, tabs_shared,
        threads, gb;
    int absent;                     // a direct table holds n where absent
    // byte offsets in the blob (-1: absent)
    int o_erow, o_fx, o_sp, o_slot, o_phase, o_q;
    int W, write;                   // repr_images: the rows' width; 0: the
                                    // count pass
};

__host__ __device__ inline long long align16(long long b) {
    return (b + 15) & ~15ll;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void add_to(double* y, long long j, double re,
                                       double im) {
    atomicAdd(y + 2 * j, re);
    atomicAdd(y + 2 * j + 1, im);
}

// ---------------------------------------------------------------------------
// The entry path
// ---------------------------------------------------------------------------

// Images a chunk: their lookups and gathers in flight together (more a
// chunk holds more registers a thread).
constexpr int kChunk = 4;

// A G bucket's key shift: log2(GB).
template <int GB>
constexpr int kShift = GB == 8 ? 3 : GB == 16 ? 4 : 5;

// A block's staged tables (shared memory).
struct Staged {
    const int4* rec;
    const int* erow;                    // (M, GB + 4)
    const unsigned long long* fx;       // (M,) or null
    const int* sp;                      // (S, GB + 4)
    const int2* slot;                   // (S,) (shift, mask) or (stride, dim)
    const double2* phase;               // (G,)
    const unsigned long long* q;        // (G, S) or null
};

__device__ Staged stage_blob(const Params& p, unsigned char* raw) {
    int4* dst = reinterpret_cast<int4*>(raw);
    for (long long k = threadIdx.x; k < p.blob_bytes / 16; k += blockDim.x)
        dst[k] = __ldg(p.blob + k);
    __syncthreads();
    Staged t;
    t.rec = reinterpret_cast<const int4*>(raw);
    t.erow = reinterpret_cast<const int*>(raw + p.o_erow);
    t.fx = p.o_fx >= 0
               ? reinterpret_cast<const unsigned long long*>(raw + p.o_fx)
               : nullptr;
    t.sp = reinterpret_cast<const int*>(raw + p.o_sp);
    t.slot = reinterpret_cast<const int2*>(raw + p.o_slot);
    t.phase = reinterpret_cast<const double2*>(raw + p.o_phase);
    t.q = p.o_q >= 0 ? reinterpret_cast<const unsigned long long*>(raw + p.o_q)
                     : nullptr;
    return t;
}

// V_s(l) of a label below 2^32: (shift, mask) with bit fields, else
// (stride, dim).
__device__ __forceinline__ unsigned vslot(bool bits, int2 sl, unsigned l) {
    return bits ? (l >> sl.x) & static_cast<unsigned>(sl.y)
                : (l / static_cast<unsigned>(sl.x)) % static_cast<unsigned>(sl.y);
}

// The joint column of column e (record rc) for a row with label l: from
// the record's word 1 at arity <= 2 (the bit fields' shifts and masks, or
// the slots and slot 1's joint stride), else a loop over its selectors.
__device__ __forceinline__ int joint(const Params& p, const Staged& t, int e,
                                     int4 rc, unsigned l) {
    const unsigned w = static_cast<unsigned>(rc.y);
    if (!(static_cast<unsigned>(rc.x) & kGeneric)) {
        if (p.bits) {
            const unsigned m0 = (w >> 16) & 255u;
            return static_cast<int>(((l >> (w & 255u)) & m0)
                                    + ((l >> ((w >> 8) & 255u)) & (w >> 24))
                                          * (m0 + 1));
        }
        return static_cast<int>(vslot(false, t.slot[w & 255u], l)
                                + vslot(false, t.slot[(w >> 8) & 255u], l)
                                      * ((w >> 16) & 255u));
    }
    int c = 0;
    for (int a = 0; a < p.A; ++a) {
        const int sel = __ldg(p.gsel + e * p.A + a);
        const unsigned v =
            p.bits ? (l >> (sel & 63)) & static_cast<unsigned>(sel >> 8)
                   : vslot(false, t.slot[sel], l);
        c += static_cast<int>(v) * __ldg(p.gstr + e * p.A + a);
    }
    return c;
}

// (-1) ** parity of the translation whose Q rows are qg on a state with
// odd-count slots fm.
__device__ __forceinline__ unsigned parity(unsigned long long fm,
                                           const unsigned long long* qg) {
    int par = 0;
    for (unsigned long long f2 = fm; f2 != 0; f2 &= f2 - 1)
        par ^= __popcll(fm & qg[__ffsll(static_cast<long long>(f2)) - 1]);
    return static_cast<unsigned>(par & 1);
}

// Rows j of the U labels t (those in ``live``) in the destination's index,
// every lookup of the chunk in flight together (the binary searches in
// lockstep).
template <int U, int MODE>
__device__ __forceinline__ void find_rows(const Params& p,
                                          const unsigned (&t)[U],
                                          unsigned live, int (&j)[U]) {
    if constexpr (MODE == kDirect) {
#pragma unroll
        for (int u = 0; u < U; ++u)
            j[u] = (live >> u & 1)
                       ? __ldg(static_cast<const int*>(p.t0) + t[u])
                       : 0;
    } else if constexpr (MODE == kLin) {
        const long long* ja = static_cast<const long long*>(p.t0);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            j[u] = 0;
            if (!(live >> u & 1)) continue;
            const long long v = t[u];
            long long a, b;
            if (p.sa_shift >= 0) {
                b = v >> p.sa_shift;
                a = v & (p.sa - 1);
            } else {
                b = v / p.sa;
                a = v - b * p.sa;
            }
            j[u] = static_cast<int>(
                clampll(__ldg(ja + a) + __ldg(p.t1 + b), 0, p.n - 1));
        }
    } else {                            // lower bound over the labels
        const long long* sorted = static_cast<const long long*>(p.t0);
        int base[U];
#pragma unroll
        for (int u = 0; u < U; ++u) base[u] = 0;
        int len = static_cast<int>(p.n);
        while (len > 1) {
            const int half = len >> 1;
#pragma unroll
            for (int u = 0; u < U; ++u)
                if ((live >> u & 1)
                    && __ldg(sorted + base[u] + half)
                           < static_cast<long long>(t[u]))
                    base[u] += half;
            len -= half;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            j[u] = 0;
            if (live >> u & 1)
                j[u] = min(base[u] + (__ldg(sorted + base[u])
                                              < static_cast<long long>(t[u])
                                          ? 1
                                          : 0),
                           static_cast<int>(p.n) - 1);
        }
    }
}

// One row (k of the launch, basis row i = row0 + k) on the entry path.
template <int KIND, int MODE, int GB, bool FERM>
__device__ __forceinline__ void entry_row(const Params& p, const Staged& t,
                                          long long k) {
    constexpr int SH = kShift<GB>, U = kChunk, PITCH = GB + 4;
    const long long i = p.row0 + k;
    const unsigned l = static_cast<unsigned>(__ldg(p.labels + i));
    const unsigned long long fo =
        FERM ? static_cast<unsigned long long>(__ldg(p.fodd + i)) : 0ull;
    double wr = 0.0, wi = 0.0;          // scatter: x_i / sqrt(nu_i)
    double own_r = 0.0, own_i = 0.0;    // the diagonal columns' sum
    double accr = 0.0, acci = 0.0;      // rows: the images' sum
    const double isn = __ldg(p.isn + i);
    if constexpr (KIND == kScatter) {
        const double2 xv = __ldg(reinterpret_cast<const double2*>(p.x) + i);
        if (xv.x == 0.0 && xv.y == 0.0) return;         // adds nothing
        wr = xv.x * isn;
        wi = xv.y * isn;
        if (p.diag != nullptr) own_r = __ldg(p.diag + i);
    }
    // the row's keys K_g = T_g(r) << SH | g, over its nonzero slots
    unsigned key[GB];
    if (!p.diag_only) {
#pragma unroll
        for (int g = 0; g < GB; ++g) key[g] = 0u;
        for (int s = 0; s < p.S; ++s) {
            const unsigned v = vslot(p.bits != 0, t.slot[s], l);
            if (v == 0) continue;
            const int4* row = reinterpret_cast<const int4*>(t.sp + s * PITCH);
#pragma unroll
            for (int q = 0; q < GB / 4; ++q) {
                const int4 w = row[q];
                key[4 * q] += v * static_cast<unsigned>(w.x);
                key[4 * q + 1] += v * static_cast<unsigned>(w.y);
                key[4 * q + 2] += v * static_cast<unsigned>(w.z);
                key[4 * q + 3] += v * static_cast<unsigned>(w.w);
            }
        }
#pragma unroll
        for (int g = 0; g < GB; ++g)
            key[g] = g < p.G ? (key[g] << SH) | static_cast<unsigned>(g)
                             : 0xFFFFFFFFu;
    }
    long long pj = -1;                  // scatter: the pending add's row
    double pr = 0.0, pim = 0.0;
    for (int e0 = 0; e0 < p.E; e0 += U) {
        // per image: its key minimum, its entry (the amplitude is read
        // again from shared memory, not held), its sign (Jordan-Wigner
        // times sigma) as a bit of neg
        unsigned tk[U], live = 0u, neg = 0u;
        int ex[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            tk[u] = 0u;
            ex[u] = 0;
            const int e = e0 + u;
            if (e >= p.E) continue;
            const int4 rc = t.rec[e];
            const unsigned w0 = static_cast<unsigned>(rc.x);
            const int idx = static_cast<int>(w0 & kOffset) + joint(p, t, e, rc, l);
            const int* er = t.erow + idx * PITCH;
            const int4 a = *reinterpret_cast<const int4*>(er);
            double re = __hiloint2double(a.y, a.x);
            double im = __hiloint2double(a.w, a.z);
            if (re == 0.0 && im == 0.0) continue;
            unsigned jw = 0u;
            if constexpr (FERM) {
                const unsigned long long wm =
                    static_cast<unsigned long long>(static_cast<unsigned>(rc.z))
                    | (static_cast<unsigned long long>(
                           static_cast<unsigned>(rc.w)) << 32);
                jw = static_cast<unsigned>(__popcll(fo & wm) & 1);
                if (jw) {
                    re = -re;
                    im = -im;
                }
            }
            if (w0 & kDiag) {
                own_r += re;
                own_i += im;
                continue;
            }
            // the minimum of K_g + Delta_g over g: r_j and the first g*
            const int4* dr = reinterpret_cast<const int4*>(er + 4);
            unsigned m = 0xFFFFFFFFu;
#pragma unroll
            for (int q = 0; q < GB / 4; ++q) {
                const int4 d = dr[q];
                m = min(m, key[4 * q] + static_cast<unsigned>(d.x));
                m = min(m, key[4 * q + 1] + static_cast<unsigned>(d.y));
                m = min(m, key[4 * q + 2] + static_cast<unsigned>(d.z));
                m = min(m, key[4 * q + 3] + static_cast<unsigned>(d.w));
            }
            tk[u] = m;
            ex[u] = idx;
            live |= 1u << u;
            if constexpr (FERM) {
                unsigned sg = jw;
                if (t.q != nullptr)     // sigma of g* from Fodd_m
                    sg ^= parity(fo ^ t.fx[idx], t.q + (m & (GB - 1)) * p.S);
                neg |= sg << u;
            }
        }
        if (live == 0u) continue;
        unsigned rj[U];
#pragma unroll
        for (int u = 0; u < U; ++u) rj[u] = tk[u] >> SH;
        if constexpr (KIND == kRows) {
            // by label: sqrt(nu_j) x_j where the sector holds r_j, else 0;
            // one gather an image, no lookup
            double2 xv[U];
#pragma unroll
            for (int u = 0; u < U; ++u)
                xv[u] = (live >> u & 1)
                            ? __ldg(reinterpret_cast<const double2*>(p.xlab)
                                    + rj[u])
                            : make_double2(0.0, 0.0);
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (!(live >> u & 1)) continue;
                const double2 ph = t.phase[tk[u] & (GB - 1)];
                const int4 a =
                    *reinterpret_cast<const int4*>(t.erow + ex[u] * PITCH);
                const double are = __hiloint2double(a.y, a.x);
                const double aim = __hiloint2double(a.w, a.z);
                const double w = (neg >> u & 1) ? -isn : isn;
                const double cr = w * (are * ph.x + aim * ph.y);
                const double ci = w * (are * ph.y - aim * ph.x);
                accr += cr * xv[u].x - ci * xv[u].y;
                acci += cr * xv[u].y + ci * xv[u].x;
            }
        } else {
            int j[U];
            find_rows<U, MODE>(p, rj, live, j);
            // a direct table marks an absent label with row n: no check there
            unsigned have = live;
            if constexpr (MODE == kDirect) {
#pragma unroll
                for (int u = 0; u < U; ++u)
                    if (j[u] >= p.n) have &= ~(1u << u);
            }
            // the destinations' records (label, sqrt(nu_j))
            long long lab[U];
            double snu[U];
#pragma unroll
            for (int u = 0; u < U; ++u) {
                lab[u] = -1;
                snu[u] = 0.0;
                if (!(have >> u & 1)) continue;
                const longlong2 r = __ldg(p.rrec + j[u]);
                lab[u] = r.x;
                snu[u] = __longlong_as_double(r.y);
            }
#pragma unroll
            for (int u = 0; u < U; ++u) {
                if (!(live >> u & 1)) continue;
                if (lab[u] != static_cast<long long>(rj[u])) continue;
                const double2 ph = t.phase[tk[u] & (GB - 1)];
                const int4 a = *reinterpret_cast<const int4*>(t.erow + ex[u] * PITCH);
                const double are = __hiloint2double(a.y, a.x);
                const double aim = __hiloint2double(a.w, a.z);
                const double sg = (neg >> u & 1) ? -1.0 : 1.0;
                const double s = sg * snu[u];
                const double cr = s * (are * ph.x - aim * ph.y);
                const double ci = s * (are * ph.y + aim * ph.x);
                const double vr = cr * wr - ci * wi, vi = cr * wi + ci * wr;
                if (j[u] == pj) {
                    pr += vr;
                    pim += vi;
                } else {
                    if (pj >= 0) add_to(p.y, pj, pr, pim);
                    pj = j[u];
                    pr = vr;
                    pim = vi;
                }
            }
        }
    }
    if constexpr (KIND == kRows) {
        const double2 xi = __ldg(reinterpret_cast<const double2*>(p.x) + i);
        const double d = p.diag != nullptr ? __ldg(p.diag + i) : 0.0;
        // conj(own) x_i
        const double yr = accr + (d + own_r) * xi.x + own_i * xi.y;
        const double yi = acci + (d + own_r) * xi.y - own_i * xi.x;
        reinterpret_cast<double2*>(p.y)[k] = make_double2(yr, yi);
    } else if constexpr (KIND == kScatter) {
        if (own_r != 0.0 || own_i != 0.0) {
            // the row's own label: at row i where the destination holds it
            // there (the sector into itself), else looked up
            long long jo = -1;
            longlong2 r0 = make_longlong2(-1, 0);
            if (i < p.n) r0 = __ldg(p.rrec + i);
            if (r0.x == static_cast<long long>(l)) {
                jo = i;
            } else {
                unsigned tl[1] = {l};
                int jj[1];
                find_rows<1, MODE>(p, tl, 1u, jj);
                if (jj[0] < p.n) {
                    r0 = __ldg(p.rrec + jj[0]);
                    if (r0.x == static_cast<long long>(l)) jo = jj[0];
                }
            }
            if (jo >= 0) {
                const double s = __longlong_as_double(r0.y);
                const double cr = s * (own_r * wr - own_i * wi);
                const double ci = s * (own_r * wi + own_i * wr);
                if (p.diag_only) {
                    // no other row adds to the row of this label
                    reinterpret_cast<double2*>(p.y)[jo] = make_double2(cr, ci);
                } else if (jo == pj) {
                    pr += cr;
                    pim += ci;
                } else {
                    add_to(p.y, jo, cr, ci);
                }
            }
        }
        if (pj >= 0) add_to(p.y, pj, pr, pim);
    }
}

// repr_rows' pre-pass on the entry path: sqrt(nu_j) x_j into the label
// buffer at label j (the others hold 0).
__global__ void __launch_bounds__(256) repr_rows_kernel_pack(const Params p) {
    for (long long j = blockIdx.x * 256ll + threadIdx.x; j < p.n;
         j += 256ll * gridDim.x) {
        const double s = __ldg(p.sqrt_nu + j);
        const double2 v = __ldg(reinterpret_cast<const double2*>(p.x) + j);
        reinterpret_cast<double2*>(p.xlab)[__ldg(p.index_labels + j)] =
            make_double2(s * v.x, s * v.y);
    }
}

// Zeroes the label buffer at n labels: those of the basis that used it
// last, before another basis' pre-pass writes its own.
__global__ void __launch_bounds__(256) repr_label_clear_kernel(
    double2* xlab, const long long* labels, long long n) {
    for (long long j = blockIdx.x * 256ll + threadIdx.x; j < n;
         j += 256ll * gridDim.x)
        xlab[__ldg(labels + j)] = make_double2(0.0, 0.0);
}

unsigned pass_grid(long long n) {
    return static_cast<unsigned>(n / 256 + 1 < 1024 ? n / 256 + 1 : 1024);
}

template <int KIND, int MODE, int GB, bool FERM>
__device__ __forceinline__ void entry_kernel(const Params& p,
                                             unsigned char* raw) {
    const Staged t = stage_blob(p, raw);
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long k = tile * kThreads + threadIdx.x;
        if (k < p.rows) entry_row<KIND, MODE, GB, FERM>(p, t, k);
    }
}

// ---------------------------------------------------------------------------
// The general path
// ---------------------------------------------------------------------------

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
    for (long long k = threadIdx.x; k < count; k += blockDim.x)
        dst[k] = src[k];
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
    if (p.mode == kDirect) {            // n where absent: in range below
        j = min(static_cast<long long>(__ldg(static_cast<const int*>(p.t0)
                                             + clampll(u, 0, p.label_space - 1))),
                p.n - 1);
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

// T_g(r) of a row with label r into tr[g * stride] for the G group
// elements from g0 on at a step of gs (a thread alone: 0, 1; the lanes of a
// warp: lane, 32).
__device__ __forceinline__ void translate_row(const Params& p, const Tabs& t,
                                              long long r, long long* tr,
                                              int stride, int g0, int gs) {
    for (int g = g0; g < p.G; g += gs) tr[static_cast<long long>(g) * stride] = 0;
    for (int s = 0; s < p.S; ++s) {
        const long long v = slot_value(p, t, r, s);
        if (v == 0) continue;
        const long long* row = t.sp + static_cast<long long>(s) * p.G;
        for (int g = g0; g < p.G; g += gs)
            tr[static_cast<long long>(g) * stride] += v * row[g];
    }
}

// Image column e of a row with label r and odd-count slots fo (steps 1-5
// above), given the row's T_g(r) at tr[g * stride]. Calls f.dead(e)
// (padding), f.own(e, re, im) (a diagonal column: amplitude with its
// Jordan-Wigner sign) or f.image(e, in, j, sigma, re, im, g*).
template <class F>
__device__ __forceinline__ void walk_column(const Params& p, const Tabs& t,
                                            long long r,
                                            unsigned long long fo,
                                            const long long* tr, int stride,
                                            int e, F& f) {
    const int W = p.amp_c ? 4 : 2;
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
        return;
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
        return;
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
            const long long v = tr[static_cast<long long>(g) * stride]
                                + d0 * sp0[g] + d1 * sp1[g];
            if (v < best) {
                best = v;
                gs = g;
            }
        }
    } else {                            // arity > 2: the slots in a loop
        for (int g = 0; g < p.G; ++g) {
            long long v = tr[static_cast<long long>(g) * stride];
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
    if (p.qmask != nullptr) {           // sigma of g* from Fodd_m
        unsigned long long fm = fo;
        for (int a = 0; a < na; ++a) {
            const int s = cs[a];
            const unsigned long long b =
                (static_cast<unsigned long long>(t.oddmask[s])
                 >> slot_value(p, t, m, s)) & 1ull;
            fm = (fm & ~(1ull << s)) | (b << s);
        }
        if (parity(fm, reinterpret_cast<const unsigned long long*>(
                           t.qmask + static_cast<long long>(gs) * p.S)))
            sig = -1.0;
    }
    bool in;
    const long long j = find(p, best, in);
    f.image(e, in, j, sig, re, im, gs);
}

// The walk of one row's image columns, a thread alone; ``tr`` points at the
// row's T_g(r), g at stride kThreads.
template <class F>
__device__ __forceinline__ void walk_row(const Params& p, const Tabs& t,
                                         long long i, long long* tr, F& f) {
    const long long r = __ldg(p.labels + i);
    const unsigned long long fo =
        p.fodd != nullptr ? static_cast<unsigned long long>(__ldg(p.fodd + i))
                          : 0ull;
    if (!p.diag_only) translate_row(p, t, r, tr, kThreads, 0, 1);
    for (int e = 0; e < p.E; ++e) walk_column(p, t, r, fo, tr, kThreads, e, f);
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

// One image column of row i of H: (j, H[i, j]); col stays -1 (a dropped
// image) where the image is padding or outside the sector.
struct ImagesVisit {
    const Params& p;
    const Tabs& t;
    double isn;
    long long i;
    long long col;
    double2 v;
    __device__ void dead(int) {}
    __device__ void own(int, double re, double im) {
        col = i;
        v = make_double2(re, -im);
    }
    __device__ void image(int, bool in, long long j, double sig, double re,
                          double im, int gs) {
        if (!in) return;
        const double w = __ldg(p.sqrt_nu + j) * isn * sig;
        const double2 ph = t.phase[gs];
        col = j;
        v = make_double2(w * (re * ph.x + im * ph.y),
                         w * (re * ph.y - im * ph.x));
    }
};

template <int KIND>
__device__ __forceinline__ void general_kernel(const Params& p,
                                               unsigned char* raw) {
    const Layout l = layout(p);
    const Tabs t = stage_tables(p, raw, l);
    long long* tr =
        (p.tr_scratch != nullptr
             ? p.tr_scratch + static_cast<long long>(blockIdx.x) * p.G * kThreads
             : reinterpret_cast<long long*>(raw + l.tr))
        + threadIdx.x;
    const long long tiles = (p.rows + kThreads - 1) / kThreads;
    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const long long k = tile * kThreads + threadIdx.x;
        if (k >= p.rows) continue;
        const long long i = p.row0 + k;
        if constexpr (KIND == kRows) {
            const double2 xi = __ldg(reinterpret_cast<const double2*>(p.x) + i);
            const double d = p.diag != nullptr ? __ldg(p.diag + i) : 0.0;
            RowsVisit f{p, t, __ldg(p.isn + i), d * xi.x, d * xi.y, 0.0, 0.0};
            walk_row(p, t, i, tr, f);
            // the diagonal columns: conj(own) x_i
            const double yr = f.yr + f.own_r * xi.x + f.own_i * xi.y;
            const double yi = f.yi + f.own_r * xi.y - f.own_i * xi.x;
            reinterpret_cast<double2*>(p.y)[k] = make_double2(yr, yi);
        } else {
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
}

// ---------------------------------------------------------------------------
// repr_images: a warp a row, a lane an image, rows finished by ell_rows
// ---------------------------------------------------------------------------

constexpr int kWarps = kThreads / 32;

// Bytes of a warp's region of repr_images' shared memory: the row's keys
// (entry path: GB of them, 32-bit) or T_g(r) (general path: G, 64-bit),
// then the row stage's scratch (complex128 values).
__host__ __device__ inline long long images_warp_bytes(const Params& p) {
    return align16(p.gb != 0 ? 4ll * p.gb : 8ll * p.G)
           + ell_rows::scratch_bytes(p.E, 16);
}

// Where the warps' regions start: after the staged blob or tables.
__host__ __device__ inline long long images_base(const Params& p) {
    return p.gb != 0 ? align16(p.blob_bytes) : layout(p).tr;
}

inline ell_rows::Plan images_plan(const Params& p) {
    return ell_rows::plan(images_base(p), images_warp_bytes(p), kWarps,
                          p.row_shared < kMaxShared ? p.row_shared
                                                    : kMaxShared);
}

// The row's keys K_g = T_g(r) << SH | g (0xFFFFFFFF past G), lane g
// computing key g over the row's nonzero slots.
template <int GB>
__device__ __forceinline__ void entry_keys(const Params& p, const Staged& t,
                                           unsigned l, unsigned* keys) {
    constexpr int SH = kShift<GB>, PITCH = GB + 4;
    const int g = threadIdx.x & 31;
    if (g >= GB) return;
    unsigned key = 0u;
    for (int s = 0; s < p.S; ++s) {
        const unsigned v = vslot(p.bits != 0, t.slot[s], l);
        if (v != 0) key += v * static_cast<unsigned>(t.sp[s * PITCH + g]);
    }
    keys[g] = g < p.G ? (key << SH) | static_cast<unsigned>(g) : 0xFFFFFFFFu;
}

// Image column e of row i (label l, odd-count slots fo, 1 / sqrt(nu_i)
// isn) on the entry path, given the row's keys: (j, H[i, j]) in (col, v),
// col left -1 where the image is padding or outside the sector.
template <int MODE, int GB, bool FERM>
__device__ __forceinline__ void entry_image(const Params& p, const Staged& t,
                                            long long i, unsigned l,
                                            unsigned long long fo, double isn,
                                            const unsigned* keys, int e,
                                            long long& col, double2& v) {
    constexpr int SH = kShift<GB>, PITCH = GB + 4;
    const int4 rc = t.rec[e];
    const unsigned w0 = static_cast<unsigned>(rc.x);
    const int idx = static_cast<int>(w0 & kOffset) + joint(p, t, e, rc, l);
    const int* er = t.erow + idx * PITCH;
    const int4 a = *reinterpret_cast<const int4*>(er);
    double re = __hiloint2double(a.y, a.x);
    double im = __hiloint2double(a.w, a.z);
    if (re == 0.0 && im == 0.0) return;
    if constexpr (FERM) {
        const unsigned long long wm =
            static_cast<unsigned long long>(static_cast<unsigned>(rc.z))
            | (static_cast<unsigned long long>(static_cast<unsigned>(rc.w))
               << 32);
        if (__popcll(fo & wm) & 1) {
            re = -re;
            im = -im;
        }
    }
    if (w0 & kDiag) {
        col = i;
        v = make_double2(re, -im);
        return;
    }
    // the minimum of K_g + Delta_g over g: r_j and the first g*
    const uint4* kq = reinterpret_cast<const uint4*>(keys);
    const int4* dr = reinterpret_cast<const int4*>(er + 4);
    unsigned m = 0xFFFFFFFFu;
#pragma unroll
    for (int q = 0; q < GB / 4; ++q) {
        const uint4 k = kq[q];
        const int4 d = dr[q];
        m = min(m, k.x + static_cast<unsigned>(d.x));
        m = min(m, k.y + static_cast<unsigned>(d.y));
        m = min(m, k.z + static_cast<unsigned>(d.z));
        m = min(m, k.w + static_cast<unsigned>(d.w));
    }
    double sg = 1.0;
    if constexpr (FERM) {
        if (t.q != nullptr
            && parity(fo ^ t.fx[idx], t.q + (m & (GB - 1)) * p.S))
            sg = -1.0;
    }
    const unsigned rj[1] = {m >> SH};
    int j[1];
    find_rows<1, MODE>(p, rj, 1u, j);
    // a direct table marks an absent label with row n: no check there
    if (MODE == kDirect && j[0] >= p.n) return;
    const longlong2 r = __ldg(p.rrec + j[0]);
    if (r.x != static_cast<long long>(rj[0])) return;
    const double2 ph = t.phase[m & (GB - 1)];
    const double w = sg * __longlong_as_double(r.y) * isn;
    col = j[0];
    v = make_double2(w * (re * ph.x + im * ph.y), w * (re * ph.y - im * ph.x));
}

// The row stage of a warp's row k: after its kept images are put, the
// finished row (write) or its count; the warp's widest row so far in wmax.
__device__ __forceinline__ void images_finish(
        const Params& p, const ell_rows::Scratch<double2>& s, int kept,
        long long k, int& wmax) {
    __syncwarp();
    const long long at = k * p.W;
    const int cnt = ell_rows::finish(
        s, kept, p.write ? p.cols + at : nullptr,
        p.write ? reinterpret_cast<double2*>(p.vals) + at : nullptr, p.W,
        p.write != 0);
    wmax = max(wmax, cnt);
    __syncwarp();                       // the scratch is free for the next row
}

// The count pass: the block's warps' widest rows into p.width.
__device__ __forceinline__ void images_width(const Params& p, int wmax) {
    if (!p.write && (threadIdx.x & 31) == 0) atomicMax(p.width, wmax);
}

template <int MODE, int GB, bool FERM>
__device__ __forceinline__ void entry_images(const Params& p,
                                             unsigned char* raw) {
    const Staged t = stage_blob(p, raw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    unsigned char* own = ell_rows::region<false>(
        raw + images_base(p), p.row_scratch, images_warp_bytes(p));
    unsigned* keys = reinterpret_cast<unsigned*>(own);
    const ell_rows::Scratch<double2> s = ell_rows::scratch<double2>(
        own + align16(4ll * GB), p.E);
    const int E32 = (p.E + 31) & ~31;      // whole chunks of 32 images
    int wmax = 0;
    for (long long k = static_cast<long long>(blockIdx.x) * warps + warp;
         k < p.rows; k += static_cast<long long>(gridDim.x) * warps) {
        const long long i = p.row0 + k;
        const unsigned l = static_cast<unsigned>(__ldg(p.labels + i));
        const unsigned long long fo =
            FERM ? static_cast<unsigned long long>(__ldg(p.fodd + i)) : 0ull;
        const double isn = __ldg(p.isn + i);
        if (!p.diag_only) entry_keys<GB>(p, t, l, keys);
        __syncwarp();
        int kept = 0;
        for (int e = lane; e < E32; e += 32) {
            long long col = -1;
            double2 v = make_double2(0.0, 0.0);
            if (e < p.E)
                entry_image<MODE, GB, FERM>(p, t, i, l, fo, isn, keys, e, col,
                                            v);
            ell_rows::put(s, kept, col >= 0, col, v);
        }
        images_finish(p, s, kept, k, wmax);
    }
    images_width(p, wmax);
}

// The warps' regions in the device buffer (DEV) or in shared memory.
template <bool DEV>
__device__ __forceinline__ void general_images(const Params& p,
                                               unsigned char* raw) {
    const Tabs t = stage_tables(p, raw, layout(p));
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    unsigned char* own = ell_rows::region<DEV>(
        raw + images_base(p), p.row_scratch, images_warp_bytes(p));
    long long* tr = reinterpret_cast<long long*>(own);
    const ell_rows::Scratch<double2> s = ell_rows::scratch<double2>(
        own + align16(8ll * p.G), p.E);
    const int E32 = (p.E + 31) & ~31;      // whole chunks of 32 images
    int wmax = 0;
    for (long long k = static_cast<long long>(blockIdx.x) * warps + warp;
         k < p.rows; k += static_cast<long long>(gridDim.x) * warps) {
        const long long i = p.row0 + k;
        const long long r = __ldg(p.labels + i);
        const unsigned long long fo =
            p.fodd != nullptr
                ? static_cast<unsigned long long>(__ldg(p.fodd + i))
                : 0ull;
        if (!p.diag_only) translate_row(p, t, r, tr, 1, lane, 32);
        __syncwarp();
        int kept = 0;
        for (int e = lane; e < E32; e += 32) {
            ImagesVisit f{p, t, __ldg(p.isn + i), i, -1,
                          make_double2(0.0, 0.0)};
            if (e < p.E) walk_column(p, t, r, fo, tr, 1, e, f);
            ell_rows::put(s, kept, f.col >= 0, f.col, f.v);
        }
        images_finish(p, s, kept, k, wmax);
    }
    images_width(p, wmax);
}

// ---------------------------------------------------------------------------
// The kernels (GB = 0: the general path) and their launch
// ---------------------------------------------------------------------------

template <int KIND, int MODE, int GB, bool FERM>
__device__ __forceinline__ void run(const Params& p) {
    extern __shared__ int4 smem[];
    unsigned char* raw = reinterpret_cast<unsigned char*>(smem);
    if constexpr (KIND == kImages) {
        if constexpr (GB != 0)
            entry_images<MODE, GB, FERM>(p, raw);
        else if (p.row_scratch != nullptr)
            general_images<true>(p, raw);
        else
            general_images<false>(p, raw);
    } else if constexpr (GB == 0) {
        general_kernel<KIND>(p, raw);
    } else {
        entry_kernel<KIND, MODE, GB, FERM>(p, raw);
    }
}

template <int MODE, int GB, bool FERM>
__global__ void __launch_bounds__(kThreads,
                                  GB == 0 ? kMinBlocksGeneral : kMinBlocks)
repr_rows_kernel(const Params p) {
    run<kRows, MODE, GB, FERM>(p);
}

template <int MODE, int GB, bool FERM>
__global__ void __launch_bounds__(kThreads,
                                  GB == 0 ? kMinBlocksGeneral : kMinBlocks)
repr_scatter_kernel(const Params p) {
    run<kScatter, MODE, GB, FERM>(p);
}

template <int MODE, int GB, bool FERM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
repr_images_kernel(const Params p) {
    run<kImages, MODE, GB, FERM>(p);
}

template <int KIND, int MODE, int GB, bool FERM>
int launch(const Params& p, cudaStream_t stream) {
    auto kern = KIND == kRows      ? repr_rows_kernel<MODE, GB, FERM>
                : KIND == kScatter ? repr_scatter_kernel<MODE, GB, FERM>
                                   : repr_images_kernel<MODE, GB, FERM>;
    // repr_images: a warp a row, as many warps a block as images_plan fits
    const ell_rows::Plan pl = KIND == kImages
                                  ? images_plan(p)
                                  : ell_rows::Plan{kWarps, 0, false};
    const long long smem = KIND == kImages ? pl.smem
                           : GB == 0       ? layout(p).total
                                           : p.blob_bytes;
    const int threads = KIND == kImages ? 32 * pl.warps : kThreads;
    // the entry path's regions are always in shared memory: its tables
    // (ENTRY_TABLES_MAX) hold a few hundred image columns at most
    if (smem > kMaxShared
        || (pl.device
            && (GB != 0 || p.row_scratch == nullptr || p.row_blocks < 1)))
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
    // a tile: kThreads rows (a thread a row), or a block's warps (a warp a
    // row)
    const long long per = KIND == kImages ? pl.warps : kThreads;
    const long long tiles = (p.rows + per - 1) / per;
    long long grid = tiles < resident ? tiles : resident;
    if (KIND != kImages && GB == 0 && p.tr_scratch != nullptr
        && grid > p.scratch_blocks)
        grid = p.scratch_blocks;
    if (pl.device && grid > p.row_blocks) grid = p.row_blocks;
    kern<<<static_cast<unsigned>(grid), threads, static_cast<size_t>(smem),
           stream>>>(p);
    return static_cast<int>(cudaGetLastError());
}

template <int KIND, int MODE>
int pick_bucket(const Params& p, cudaStream_t st) {
    const bool ferm = p.fodd != nullptr;
    switch (p.gb) {
        case 8:
            return ferm ? launch<KIND, MODE, 8, true>(p, st)
                        : launch<KIND, MODE, 8, false>(p, st);
        case 16:
            return ferm ? launch<KIND, MODE, 16, true>(p, st)
                        : launch<KIND, MODE, 16, false>(p, st);
        default:
            return ferm ? launch<KIND, MODE, 32, true>(p, st)
                        : launch<KIND, MODE, 32, false>(p, st);
    }
}

// One of the instances of each kernel: the general path, or the entry
// path's (G bucket: 8, 16, 32) x (fermionic rows), and for the scatter and
// the images x (index mode: direct, lin, bsearch): 7, 19 and 19.
template <int KIND>
int dispatch(Params p, cudaStream_t stream) {
    if (p.threads != kThreads || p.rows <= 0 || p.n <= 0 || p.E < 0
        || (p.E > 0 && p.A < 1) || p.S < 1 || p.S > 63 || p.G < 1
        || p.mode < kDirect || p.mode > kBsearch
        || (p.mode == kLin && p.sa < 1)
        || (p.qmask != nullptr && p.oddmask == nullptr)
        || (p.tr_scratch != nullptr && p.scratch_blocks < 1))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.gb == 0 && p.xlab != nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
    if (KIND == kImages
        && (p.n >= INT_MAX || p.W < 0
            || (p.write ? p.cols == nullptr || p.vals == nullptr
                        : p.width == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (p.gb != 0) {
        const int sh = p.gb == 8 ? 3 : p.gb == 16 ? 4 : p.gb == 32 ? 5 : -1;
        if (sh < 0 || p.G > p.gb || p.blob == nullptr
            || p.blob_bytes % 16 != 0 || p.n >= (1ll << 31)
            || (p.label_space << sh) > 0xFFFFFFFFll
            || (p.A > 2 && (p.gsel == nullptr || p.gstr == nullptr))
            || p.o_erow < 0 || p.o_sp < 0 || p.o_slot < 0 || p.o_phase < 0
            || (p.o_q >= 0 && (p.fodd == nullptr || p.o_fx < 0))
            || (p.mode == kDirect && !p.absent)
            || (KIND == kRows) != (p.xlab != nullptr)
            || (KIND != kRows && p.rrec == nullptr))
            return static_cast<int>(cudaErrorInvalidValue);
    }
    if (p.mode == kLin) {
        p.sb = (p.label_space + p.sa - 1) / p.sa;
        p.sa_shift = (p.sa & (p.sa - 1)) == 0 ? __builtin_ctzll(p.sa) : -1;
    }
    if (KIND == kScatter) {             // the adds start at 0
        const cudaError_t err =
            cudaMemsetAsync(p.y, 0, static_cast<size_t>(16 * p.n), stream);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (p.gb == 0) return launch<KIND, 0, 0, false>(p, stream);
    if constexpr (KIND == kRows) {      // by label: no index mode
        repr_rows_kernel_pack<<<pass_grid(p.n), 256, 0, stream>>>(p);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
        return pick_bucket<kRows, kDirect>(p, stream);
    } else {
        switch (p.mode) {
            case kDirect:
                return pick_bucket<KIND, kDirect>(p, stream);
            case kLin:
                return pick_bucket<KIND, kLin>(p, stream);
            default:
                return pick_bucket<KIND, kBsearch>(p, stream);
        }
    }
}

}  // namespace

// Plain C interface (loaded with ctypes; ops/apply_repr.py::build_library).
// Each launch takes a pointer to a Params (void: a type of this file's
// unnamed namespace in the signature would make the symbol local) and
// returns a cudaError_t value, 0 on success. gb = 0 takes the general
// path, 8, 16 or 32 the entry path at that G bucket.
extern "C" long long qbt_repr_params_size() { return sizeof(Params); }

// The bytes a block of repr_images' warp regions takes in device memory
// (the wrapper allocates row_blocks of them), or 0 where they fit in
// shared memory.
extern "C" long long qbt_repr_images_scratch(const void* pp) {
    const Params& p = *static_cast<const Params*>(pp);
    const ell_rows::Plan pl = images_plan(p);
    return pl.device ? pl.warps * images_warp_bytes(p) : 0;
}

extern "C" int qbt_repr_rows(const void* p, void* stream) {
    return dispatch<kRows>(*static_cast<const Params*>(p),
                           static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_repr_scatter(const void* p, void* stream) {
    return dispatch<kScatter>(*static_cast<const Params*>(p),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int qbt_repr_images(const void* p, void* stream) {
    return dispatch<kImages>(*static_cast<const Params*>(p),
                             static_cast<cudaStream_t>(stream));
}

// Zeroes the label buffer xlab at the n labels: those of the basis whose
// values it holds, before repr_rows runs on another basis.
extern "C" int qbt_repr_label_clear(void* xlab, const void* labels,
                                    long long n, void* stream) {
    if (n <= 0) return 0;
    repr_label_clear_kernel<<<pass_grid(n), 256, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<double2*>(xlab), static_cast<const long long*>(labels), n);
    return static_cast<int>(cudaGetLastError());
}
