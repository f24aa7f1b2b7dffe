// K16: the sorted-segment fold, y[s] = identity (+) every vals[i] with
// seg[i] == s, in a fixed order, for Hopper, instantiated per value type
// (values.cuh: float32, bfloat16, float16; and int32, int64) and per fold
// of the built-in rings (a sum, a min, a max). Plain C launcher for
// ctypes; see kernels/fold.py (segment_fold) for the wrapper, its launch
// counter and the scratch it allocates, and ops/semiring.py
// (_segment_reduce_plain) for its plain PyTorch version.
// tests/k16_model.py writes the order below in NumPy.
//
// Replaces the reference's spmv_tpu/ops/semiring.py:130
// segment_reduce_sorted (jax.ops.segment_sum / segment_min / segment_max
// with indices_are_sorted=True), which XLA compiles into the same jit as
// the Pallas kernel before it: Phase C of kernels/ell.py:_ell_spmv_device
// (after K11), of parallel/dist_spmv.py:_local_ell_matvec (after K11') and
// of kernels/spmm.py:_spmm_window_pass (after K13, whose products it reads
// through `perm`); alone in `xla`, `spmm_xla`, `spmv_values` and the
// split-row fixup. On the TPU those give the same y on every call. K16
// uses no atomics on values and nothing whose order depends on which
// block finishes first, so its y is a fixed function of (vals, seg) too.
//
// Arithmetic, as the plain version's: plus-times and the or-and counting
// ring add floating values in float64 and round once to the value type
// (float64 to float32, then to the 2-byte type, as Tensor.to rounds on the
// CPU); min-plus folds by torch.minimum's rule, max-times and or-and by
// torch.maximum's (NaN propagates; of two equal operands, +0 and -0, the
// earlier), as scatter_reduce's amin and amax do in a 1-D fold on the CPU,
// in float32, which is exact. Integer values sum in their own width with
// wrap-around, as index_add_ and the reference's int32 segment_sum do
// (two's-complement addition is associative, so any order gives the same
// bits), and take min and max exactly. The identity is folded in once,
// before a segment's first element; a segment no element names gets the
// identity.
//
// What bounds it: bytes. vals, seg (and perm) read once, y written once:
// bench's `xla` fold, 3.3M float32 products, int32 row ids and 1M rows,
// is about 31 MB, 9 us at 3.35 TB/s.
//
// y first takes the identity in every row (fill_identity: one memset
// node, or fold_fill_kernel where no memset writes the identity's bits);
// the fold then writes the rows its segments name. Writing the identity
// into the runs of empty rows from inside the fold (bench's y is 97% such
// rows) cost more than the whole fill on the card.
//
// B = 1 (fold_rows_kernel), one launch after the fill, whose one memset
// also resets the look-back records (kernels/fold.py allocates them right
// after y; a separate memset zeroes them where it does not, or where
// fold_fill_kernel fills y):
//  - Tiles of FOLD_TILE consecutive elements. A grid of at most the
//    resident blocks takes tiles in increasing order from a ticket, so a
//    tile's predecessors are running or done when it waits on them.
//  - Each thread loads its FOLD_ITEMS consecutive values and ids into
//    registers by 16-byte loads (ids keep their width in memory; a thread
//    holds them as 32-bit offsets from its first id) and folds them in
//    one pass: a run from each in-tile boundary (a segment start, or the
//    tile's first element) is its own fold, and a segment that starts and
//    ends in the thread is written at once. A segmented scan gives each
//    thread the partial that runs into it: a warp scan of the threads'
//    last runs by shuffles (d = 1, 2, ..., 16), then each warp scans the
//    warps' totals the same way (d = 1, 2, 4). The thread's first run, if
//    it ends in the thread, is that partial reduced with the run's fold.
//  - Each tile publishes at once the partial of its last segment (from the
//    last segment start in it, or its whole fold) and whether a segment
//    starts in it, one 16-byte record (no fence). Tile 32g + 31, at its
//    end, publishes group g's aggregate, the same warp scan over the 32
//    tiles' records.
//  - The tile in which a segment that began in an earlier tile ends folds
//    the published partials back to the segment's first tile, one warp:
//    its predecessor's record (where most such segments start), then the
//    tiles of that record's group before it, then whole groups, 32 group
//    aggregates a step, until a record says the segment starts there;
//    each step is the same shuffle scan, and the steps combine
//    earlier-first. Only partials are read, never another
//    tile's running prefix, so the order depends on the tile index alone,
//    not on the grid, the residency or which block finishes first; a hub
//    row is folded by all its tiles at once and then a walk of about
//    tiles / 1024 + 2 steps.
//  - A segment's value is written once, where it ends.
//
// B > 1 (fold_cols_kernel; within two thirds of its bound, so its levels
// stay): a block of up to FOLD_COLS threads takes
// FOLD_ROWS consecutive rows of up to FOLD_COLS columns, one column a
// thread, each column's rows in order, FOLD_BATCH loads in flight; row i
// of vals is perm[i] where perm is given. The chunk's first and last
// segments' partials go to a carry array, two items a chunk (the second a
// neutral item when the chunk holds one segment), which the next level
// folds by the same body until one chunk holds them all: ceil(log_C(n))
// launches after the fill.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

#include "ring.cuh"
#include "values.cuh"

#define FOLD_THREADS 256
#define FOLD_ITEMS 8
#define FOLD_MIN_BLOCKS 3  // resident blocks an SM at least (B = 1)
#define FOLD_TILE (FOLD_THREADS * FOLD_ITEMS)  // elements a tile holds (B = 1)
#define FOLD_WARPS (FOLD_THREADS / 32)
#define FOLD_GROUP 32                          // tiles a group aggregate folds
#define FOLD_COLS 128                          // columns a block takes (B > 1)
#define FOLD_ROWS 256                          // rows a block folds (B > 1)
#define FOLD_BATCH 8                           // rows a column thread loads at once

#define FOLD_NONE ((long long)0x8000000000000000ull)  // no element there

// The storage of a value type: a floating type's bits, or the integer
template <typename T>
struct Store {
  using S = Bits<T>;
};
template <>
struct Store<int32_t> {
  using S = int32_t;
};
template <>
struct Store<long long> {
  using S = long long;
};

// A built-in ring's fold: plus-times and the or-and counting ring sum,
// min-plus takes the min, max-times and or-and the max (-1: no such ring)
enum { FOLD_SUM, FOLD_MIN, FOLD_MAX };
static inline int fold_kind(int ring) {
  switch (ring) {
    case SPMV_RING_PLUS_TIMES:
    case SPMV_RING_OR_AND_COUNT: return FOLD_SUM;
    case SPMV_RING_MIN_PLUS: return FOLD_MIN;
    case SPMV_RING_MAX_TIMES:
    case SPMV_RING_OR_AND: return FOLD_MAX;
    default: return -1;
  }
}

// A fold on a value type: its accumulator, its reduce (earlier
// operand first), a neutral item (reduce(a, n) == reduce(n, a) == a bit for
// bit), the element widened to the accumulator, the identity as passed, and
// the accumulator written back to storage
template <typename T, int KIND>
struct FoldF;  // floating

template <typename T>
struct FoldF<T, FOLD_SUM> {
  using Acc = double;
  static __device__ __forceinline__ double reduce(double e, double l) {
    return __dadd_rn(e, l);
  }
  static __device__ __forceinline__ double null() { return -0.0; }
  static __device__ __forceinline__ double load(Bits<T> b) { return Num<T>::widen(b); }
  static __device__ __forceinline__ double ident(double f, long long) { return f; }
  static __device__ __forceinline__ Bits<T> out(double a) {
    return Num<T>::round((float)a);  // float64 -> float32 -> T, each to nearest even
  }
};

template <typename T, class M>
struct FoldFMinMax {
  using Acc = float;
  static __device__ __forceinline__ float reduce(float e, float l) { return M::op(e, l); }
  static __device__ __forceinline__ float null() { return __int_as_float(M::NULL_BITS); }
  static __device__ __forceinline__ float load(Bits<T> b) { return Num<T>::widen(b); }
  static __device__ __forceinline__ float ident(double f, long long) { return (float)f; }
  static __device__ __forceinline__ Bits<T> out(float a) { return Num<T>::round(a); }
};
struct TMin {
  static constexpr int NULL_BITS = 0x7f800000;
  static __device__ __forceinline__ float op(float e, float l) { return spmv_tmin(e, l); }
};
struct TMax {
  static constexpr int NULL_BITS = (int)0xff800000u;
  static __device__ __forceinline__ float op(float e, float l) { return spmv_tmax(e, l); }
};
template <typename T>
struct FoldF<T, FOLD_MIN> : FoldFMinMax<T, TMin> {};
template <typename T>
struct FoldF<T, FOLD_MAX> : FoldFMinMax<T, TMax> {};

// Integers: sums wrap in the value's width (unsigned arithmetic), min and
// max exact
template <typename I, typename U, int KIND>
struct FoldI {
  using Acc = typename std::conditional<KIND == FOLD_SUM, U, I>::type;
  static __device__ __forceinline__ Acc reduce(Acc e, Acc l) {
    if constexpr (KIND == FOLD_SUM)
      return e + l;
    else if constexpr (KIND == FOLD_MIN)
      return l < e ? l : e;
    else
      return l > e ? l : e;
  }
  static __device__ __forceinline__ Acc null() {
    if constexpr (KIND == FOLD_SUM)
      return 0;
    else if constexpr (KIND == FOLD_MIN)
      return (I)(~(U)0 >> 1);
    else
      return (I)((~(U)0 >> 1) + 1);
  }
  static __device__ __forceinline__ Acc load(I b) { return (Acc)b; }
  static __device__ __forceinline__ Acc ident(double, long long i) { return (Acc)(I)i; }
  static __device__ __forceinline__ I out(Acc a) { return (I)a; }
};

template <typename T, int KIND>
struct FoldOf {
  using type = FoldF<T, KIND>;
};
template <int KIND>
struct FoldOf<int32_t, KIND> {
  using type = FoldI<int32_t, uint32_t, KIND>;
};
template <int KIND>
struct FoldOf<long long, KIND> {
  using type = FoldI<long long, unsigned long long, KIND>;
};
template <typename T, int KIND>
using Fold = typename FoldOf<T, KIND>::type;

// (partial, a segment begins in it) of the segmented scan
template <typename Acc>
struct Part {
  Acc v;
  bool f;
};

// The segmented scan's operator, earlier operand first
template <class F, typename Acc>
__device__ __forceinline__ Part<Acc> join(Part<Acc> e, Part<Acc> l) {
  return l.f ? l : Part<Acc>{F::reduce(e.v, l.v), e.f};
}

// Inclusive segmented scan across the warp's lanes 0..W-1 by shuffles
// d = 1, 2, ..., W/2 (lanes at and past W take part but do not reach below)
template <class F, int W, typename Acc>
__device__ __forceinline__ Part<Acc> warp_scan(Part<Acc> p, int lane) {
#pragma unroll
  for (int d = 1; d < W; d <<= 1) {
    const Acc ov = __shfl_up_sync(0xffffffffu, p.v, d);
    const bool of = __shfl_up_sync(0xffffffffu, (int)p.f, d) != 0;
    if (lane >= d) p = join<F>(Part<Acc>{ov, of}, p);
  }
  return p;
}

__device__ __forceinline__ long long ld_index(const void* p, int is64, int64_t i) {
  return is64 ? __ldg(static_cast<const long long*>(p) + i)
              : (long long)__ldg(static_cast<const int32_t*>(p) + i);
}

// FOLD_ITEMS consecutive elements at p (16-byte aligned) in 16-byte loads,
// evict-first: each is read once
template <typename S>
__device__ __forceinline__ void load_items(S (&v)[FOLD_ITEMS], const S* p) {
  constexpr int NV = FOLD_ITEMS * (int)sizeof(S) / 16;
  static_assert(NV * 16 == FOLD_ITEMS * (int)sizeof(S), "items fill whole 16-byte loads");
  union {
    uint4 q[NV];
    S s[FOLD_ITEMS];
  } u;
#pragma unroll
  for (int i = 0; i < NV; ++i) u.q[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
#pragma unroll
  for (int i = 0; i < FOLD_ITEMS; ++i) v[i] = u.s[i];
}

// A thread's FOLD_ITEMS ids from c (the first at `first`) as offsets
// from its first id, which 32 bits hold: ids are sorted and lie in
// [0, n_seg), n_seg < 2^31. Items past m (of the tile) are not read.
__device__ __forceinline__ long long load_ids(int32_t (&rid)[FOLD_ITEMS], const void* seg,
                                              int seg64, int vec, int64_t first, int valid) {
  long long base = 0;
  if (vec && valid == FOLD_ITEMS) {
    if (seg64) {
      longlong2 q[FOLD_ITEMS / 2];
#pragma unroll
      for (int i = 0; i < FOLD_ITEMS / 2; ++i)
        q[i] = __ldcs(reinterpret_cast<const longlong2*>(static_cast<const long long*>(seg) +
                                                         first) + i);
      base = q[0].x;
#pragma unroll
      for (int i = 0; i < FOLD_ITEMS / 2; ++i) {
        rid[2 * i] = (int32_t)(q[i].x - base);
        rid[2 * i + 1] = (int32_t)(q[i].y - base);
      }
    } else {
      int32_t i32[FOLD_ITEMS];
      load_items(i32, static_cast<const int32_t*>(seg) + first);
      base = i32[0];
#pragma unroll
      for (int i = 0; i < FOLD_ITEMS; ++i) rid[i] = i32[i] - (int32_t)base;
    }
    return base;
  }
  base = valid > 0 ? ld_index(seg, seg64, first) : 0;
#pragma unroll
  for (int i = 0; i < FOLD_ITEMS; ++i)
    rid[i] = i < valid ? (int32_t)(ld_index(seg, seg64, first + i) - base) : 0;
  return base;
}

// A published record: 16 bytes, the partial's bits and a status word,
// written and read as one 16-byte access in L2, so no fence orders the
// two. The launcher's memset leaves `fresh` in every word (the ticket's
// too); a published status differs from it in bit 0, and in bit 1 where a
// segment starts in the record.
struct __align__(16) FoldRec {
  unsigned long long v, s;
};

template <typename Acc>
__device__ __forceinline__ Part<Acc> read_record(unsigned long long fresh, const FoldRec* rec,
                                                 long long j) {
  unsigned long long v, st;
  for (;;) {
    asm volatile("ld.global.cg.v2.u64 {%0, %1}, [%2];"
                 : "=l"(v), "=l"(st)
                 : "l"(rec + j)
                 : "memory");
    if (st != fresh) break;
    __nanosleep(32);
  }
  union {
    unsigned long long u;
    Acc a;
  } x{v};
  return Part<Acc>{x.a, ((st ^ fresh) & 2u) != 0};
}

template <typename Acc>
__device__ __forceinline__ void publish(FoldRec* rec, long long j, Part<Acc> p,
                                        unsigned long long fresh) {
  union {
    unsigned long long u;
    Acc a;
  } x{0};
  x.a = p.v;
  const unsigned long long st = fresh ^ (1u | (p.f ? 2u : 0u));
  asm volatile("st.global.cg.v2.u64 [%0], {%1, %2};" ::"l"(rec + j), "l"(x.u), "l"(st) : "memory");
}

template <typename T, int KIND>
__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MIN_BLOCKS)
    fold_rows_kernel(const typename Store<T>::S* __restrict__ vals,
                     const void* __restrict__ seg, int seg64, int vec, int64_t n,
                     int64_t n_seg, double identf, long long identi,
                     typename Store<T>::S* __restrict__ y, unsigned long long* __restrict__ ticket,
                     FoldRec* recs, unsigned long long fresh) {
  using F = Fold<T, KIND>;
  using Acc = typename F::Acc;
  using S = typename Store<T>::S;
  using P = Part<Acc>;
  __shared__ P s_tot[FOLD_WARPS];  // the warps' totals
  __shared__ Acc s_facc;           // the continuing first segment's in-tile fold
  __shared__ long long s_ticket, s_s0, s_after;  // the tile's first id, the next one
  __shared__ int s_head0;                        // its first element starts a segment
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long n_tiles = (n + FOLD_TILE - 1) / FOLD_TILE;
  FoldRec* const tile_rec = recs;
  FoldRec* const group_rec = recs + n_tiles;
  const Acc ident = F::ident(identf, identi);

  for (;;) {
    if (tid == 0) s_ticket = (long long)(atomicAdd(ticket, 1ull) - fresh);
    __syncthreads();
    const long long t = s_ticket;
    if (t >= n_tiles) return;
    const int64_t c0 = t * FOLD_TILE;
    const int m = (int)min((int64_t)FOLD_TILE, n - c0);
    const int j0 = tid * FOLD_ITEMS;
    const int valid = max(0, min(FOLD_ITEMS, m - j0));
    S raw[FOLD_ITEMS];
    int32_t rid[FOLD_ITEMS];
    if (vec && valid == FOLD_ITEMS) {
      load_items(raw, vals + c0 + j0);
    } else {
#pragma unroll
      for (int i = 0; i < FOLD_ITEMS; ++i) raw[i] = i < valid ? vals[c0 + j0 + i] : S{};
    }
    const long long base = load_ids(rid, seg, seg64, vec, c0 + j0, valid);
    int32_t last_rid = 0;
#pragma unroll
    for (int i = 0; i < FOLD_ITEMS; ++i)
      if (i == valid - 1) last_rid = rid[i];
    // the ids around the thread's items: before its first, after its last
    // (lanes 0 and 31 read them, the rest take their neighbours')
    const long long up = __shfl_up_sync(0xffffffffu, valid ? base + last_rid : FOLD_NONE, 1);
    const long long down = __shfl_down_sync(0xffffffffu, valid ? base : FOLD_NONE, 1);
    const int64_t before = c0 + j0 - 1, after = c0 + j0 + FOLD_ITEMS;
    const long long pid0 =
        lane ? up : valid && before >= 0 ? ld_index(seg, seg64, before) : FOLD_NONE;
    const long long nidl =
        lane < 31 ? down : valid == FOLD_ITEMS && after < n ? ld_index(seg, seg64, after)
                                                           : FOLD_NONE;
    if (tid == 0) {
      s_s0 = base;
      s_head0 = base != pid0;
    }
    if (tid == FOLD_THREADS - 1) s_after = m == FOLD_TILE ? nidl : FOLD_NONE;
    // item i starts a segment / ends one, as bits
    unsigned heads = 0, ends = 0;
#pragma unroll
    for (int i = 0; i < FOLD_ITEMS; ++i) {
      if (i < valid) {
        if (i ? rid[i] != rid[i - 1] : base != pid0) heads |= 1u << i;
        if (i + 1 < valid ? rid[i + 1] != rid[i] : base + rid[i] != nidl) ends |= 1u << i;
      }
    }

    // one pass over the items: `cur` folds the run since the last in-tile
    // boundary (a segment start, or the tile's first element), or since
    // the thread's first item; a segment that starts and ends here is
    // written at once; the thread's first run, if it ends here, waits for
    // the partial that runs into the thread (`first`). A segment's first
    // element takes the identity before it.
    Acc cur = F::null(), first = F::null();
    bool bnds = false, started = false, first_ends = false;
#pragma unroll
    for (int i = 0; i < FOLD_ITEMS; ++i) {
      if (i < valid) {
        const bool head = (heads >> i) & 1u, bnd = head || j0 + i == 0;
        Acc v = F::load(raw[i]);
        if (head) v = F::reduce(ident, v);
        cur = bnd ? v : F::reduce(cur, v);
        bnds |= bnd;
        started |= head;
        if ((ends >> i) & 1u) {
          const long long id = base + rid[i];
          if (!started) {
            first = cur;
            first_ends = true;
          } else if (id >= 0 && id < n_seg) {
            y[id] = F::out(cur);
          }
        }
      }
    }
    // the partial that runs into the thread's first element: the warp's
    // inclusive scan of the threads' runs, then each warp scans the warps'
    // totals
    const P inc = warp_scan<F, 32>(P{cur, bnds}, lane);
    if (lane == 31) s_tot[warp] = inc;
    const Acc ev = __shfl_up_sync(0xffffffffu, inc.v, 1);
    const bool ef = __shfl_up_sync(0xffffffffu, (int)inc.f, 1) != 0;
    // a segment starts past the tile's first element; then the first
    // segment ends in the tile, as it does where the next element's id
    // differs
    const bool inner = (heads & ~(j0 == 0 ? 1u : 0u)) != 0;
    const bool any_inner = __syncthreads_or(inner) != 0;
    const long long s0 = s_s0;
    const bool head0 = s_head0 != 0;
    const bool s0_ends = any_inner || s_after != s0;
    P w = lane < FOLD_WARPS ? s_tot[lane] : P{F::null(), false};
    w = warp_scan<F, FOLD_WARPS>(w, lane);
    const int from = warp ? warp - 1 : 0;
    P pre{__shfl_sync(0xffffffffu, w.v, from), __shfl_sync(0xffffffffu, (int)w.f, from) != 0};
    if (warp == 0) {
      pre = P{F::null(), false};
      // the tile's record: the partial of its last segment, and whether a
      // segment starts in it
      if (lane == FOLD_WARPS - 1) publish(tile_rec, t, P{w.v, head0 || any_inner}, fresh);
    }
    // the thread's first run, if it ends here: that partial, then the run
    // (the tile's first segment, if it began in an earlier tile, after the
    // look-back)
    if (first_ends) {
      if (lane > 0) pre = join<F>(pre, P{ev, ef});
      const Acc val = F::reduce(pre.v, first);
      if (!head0 && base == s0)
        s_facc = val;
      else if (base >= 0 && base < n_seg)
        y[base] = F::out(val);
    }
    __syncthreads();  // s_facc
    if (warp == 0 && !head0 && s0_ends) {
      // the look-back: the predecessor's record (where most segments that
      // span tiles start), then the tiles of its group before it, then
      // whole groups earlier, 32 records a step, until one holds the
      // segment's start
      P c = read_record<Acc>(fresh, tile_rec, t - 1);
      const long long gb = (t - 1) - (t - 1) % FOLD_GROUP;
      if (!c.f && t - 1 > gb) {
        const long long j = gb + lane;
        P r = j < t - 1 ? read_record<Acc>(fresh, tile_rec, j) : P{F::null(), false};
        r = warp_scan<F, 32>(r, lane);
        c = join<F>(P{__shfl_sync(0xffffffffu, r.v, 31),
                      __shfl_sync(0xffffffffu, (int)r.f, 31) != 0},
                    c);
      }
      for (long long g = (t - 1) / FOLD_GROUP - 1; !c.f && g >= 0; g -= 32) {
        const long long k = g - 31 + lane;
        P r = k >= 0 ? read_record<Acc>(fresh, group_rec, k) : P{F::null(), false};
        r = warp_scan<F, 32>(r, lane);
        const P wv{__shfl_sync(0xffffffffu, r.v, 31),
                   __shfl_sync(0xffffffffu, (int)r.f, 31) != 0};
        c = join<F>(wv, c);
      }
      if (lane == 0 && s0 >= 0 && s0 < n_seg) y[s0] = F::out(F::reduce(c.v, s_facc));
    }
    if (warp == 0 && t % FOLD_GROUP == FOLD_GROUP - 1) {
      // the group's aggregate, once this tile's own work is done
      const P g = warp_scan<F, 32>(read_record<Acc>(fresh, tile_rec, t - 31 + lane), lane);
      if (lane == 31) publish(group_rec, t / FOLD_GROUP, g, fresh);
    }
  }
}

// The identity into every element of y where no memset writes its bits
// (an int64 min or max)
template <typename S>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_fill_kernel(S* __restrict__ y, int64_t count, S id) {
  for (int64_t i = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * FOLD_THREADS)
    y[i] = id;
}

// --- B > 1: chunks of rows, then carry levels

// Where a segment's value goes when its last element in the chunk is
// folded: y, or the chunk's carry pair (slot 0 its first segment, slot 1
// its last)
template <class F, typename S>
__device__ __forceinline__ void close_segment(long long s, typename F::Acc acc,
                                              long long first_id, long long last_id,
                                              bool final_level, int64_t n_seg, S* y,
                                              typename F::Acc* cval, int64_t* cseg, int64_t c,
                                              int64_t B, int64_t col) {
  if (final_level || (s != first_id && s != last_id)) {
    if (s >= 0 && s < n_seg) y[s * B + col] = F::out(acc);
    return;
  }
  const int64_t slot = 2 * c + (s == first_id ? 0 : 1);
  cval[slot * B + col] = acc;
  if (col == 0) cseg[slot] = s;
  if (s == first_id && s == last_id) {  // one segment: slot 1 neutral
    cval[(slot + 1) * B + col] = F::null();
    if (col == 0) cseg[slot + 1] = s;
  }
}

template <typename T, int KIND, bool FIRST>
__global__ void __launch_bounds__(FOLD_COLS)
    fold_cols_kernel(const void* __restrict__ vals, int64_t ld, const void* __restrict__ perm,
                     int perm64, const void* __restrict__ seg, int seg64, int64_t n,
                     int64_t B, int64_t n_seg, double identf, long long identi,
                     typename Store<T>::S* __restrict__ y,
                     typename Fold<T, KIND>::Acc* __restrict__ cval, int64_t* __restrict__ cseg,
                     int final_level) {
  using F = Fold<T, KIND>;
  using Acc = typename F::Acc;
  using S = typename Store<T>::S;
  __shared__ long long s_seg[FOLD_ROWS];
  __shared__ long long s_row[FOLD_ROWS];
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x, r0 = c * FOLD_ROWS;
  const int m = (int)min((int64_t)FOLD_ROWS, n - r0);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + tid;
  const Acc ident = F::ident(identf, identi);
  for (int k = tid; k < m; k += blockDim.x) {
    s_seg[k] = ld_index(seg, seg64, r0 + k);
    s_row[k] = perm ? ld_index(perm, perm64, r0 + k) : r0 + k;
  }
  const long long prev = FIRST && r0 > 0 ? ld_index(seg, seg64, r0 - 1) : -1;
  __syncthreads();
  if (col >= B) return;
  const long long first_id = s_seg[0], last_id = s_seg[m - 1];
  // int64 values hold twice the registers a load: half the batch
  constexpr int BATCH = std::is_same<T, long long>::value ? FOLD_BATCH / 2 : FOLD_BATCH;
  Acc acc = F::null();
  for (int k0 = 0; k0 < m; k0 += BATCH) {
    Acc v[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u)
      if (k0 + u < m) {
        const int64_t i = s_row[k0 + u] * ld + col;
        if constexpr (FIRST)
          v[u] = F::load(__ldg(static_cast<const S*>(vals) + i));
        else
          v[u] = __ldg(static_cast<const Acc*>(vals) + i);
      }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int k = k0 + u;
      if (k < m) {
        const long long s = s_seg[k];
        const bool bnd = k == 0 || s != s_seg[k - 1];
        Acc x = v[u];
        if (FIRST && bnd && (k > 0 || prev != s)) x = F::reduce(ident, x);
        acc = bnd ? x : F::reduce(acc, x);
        if (k == m - 1 || s_seg[k + 1] != s)
          close_segment<F>(s, acc, first_id, last_id, final_level != 0, n_seg, y, cval, cseg,
                           c, B, col);
      }
    }
  }
}

static inline int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
static inline int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }
static inline bool fold_sum_ring(int ring) {
  return ring == SPMV_RING_PLUS_TIMES || ring == SPMV_RING_OR_AND_COUNT;
}

// B = 1's scratch, all set by the launcher's memset: the tile ticket,
// then a record a tile and a group
static int64_t rows_scratch(int64_t n) {
  const int64_t tiles = ceil_div(n, FOLD_TILE), groups = ceil_div(tiles, FOLD_GROUP);
  return 16 + 16 * (tiles + groups);
}

// B > 1's carry levels' scratch: for each level but the last, its carry
// items (2 a chunk), B accumulators and one int64 segment id each
static int64_t cols_scratch(int64_t n, int64_t B, int ring, int is64) {
  const int64_t acc = fold_sum_ring(ring) || is64 ? 8 : 4;
  int64_t bytes = 0;
  for (int64_t m = n; ceil_div(m, FOLD_ROWS) > 1;) {
    m = 2 * ceil_div(m, FOLD_ROWS);
    bytes += align16(m * B * acc) + align16(m * 8);
  }
  return bytes;
}

static int64_t fold_scratch(int64_t n, int64_t B, int ring, int dtype) {
  return B == 1 ? rows_scratch(n) : cols_scratch(n, B, ring, dtype == SPMV_I64);
}

// cuMemsetD16Async or cuMemsetD32Async (2 or 4 bytes) from libcuda,
// or null
typedef int (*CuMemset)(unsigned long long, unsigned, size_t, cudaStream_t);
static CuMemset cu_memset(int bytes) {
  auto entry = [](const char* name) -> CuMemset {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion(name, &fn, 12000, cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<CuMemset>(fn);
  };
  static const CuMemset d16 = entry("cuMemsetD16Async"), d32 = entry("cuMemsetD32Async");
  return bytes == 2 ? d16 : d32;
}

// A memset that writes the identity's bits: its element (1, 2 or 4
// bytes; 0 where none does, an int64 min's or max's) and its pattern
struct Fill {
  int size;
  unsigned long long pat;
};

// The identity's bits (`bits`, the low sizeof(S) bytes) as the shortest
// pattern that repeats them
template <typename S>
static Fill fill_of(long long bits) {
  int size = (int)sizeof(S);
  unsigned long long pat = size == 8 ? (unsigned long long)bits
                                     : (unsigned long long)bits & ((1ull << (8 * size)) - 1);
  while (size > 1) {  // halve the pattern while its halves agree
    const int h = 4 * size;
    if ((pat >> h) != (pat & ((1ull << h) - 1))) break;
    pat &= (1ull << h) - 1;
    size /= 2;
  }
  if (size == 8 || (size > 1 && !cu_memset(size))) size = 0;
  return Fill{size, pat};
}

// The pattern repeated over 8 bytes: what a record's words hold after
// the memset
static unsigned long long fill_word(Fill f) {
  unsigned long long w = f.pat;
  for (int b = f.size; b < 8; b *= 2) w |= w << (8 * b);
  return w;
}

// `bytes` (a multiple of f.size) at p take f's pattern: one memset node
static int fill_bytes(void* p, int64_t bytes, Fill f, cudaStream_t st) {
  if (f.size == 1) return (int)cudaMemsetAsync(p, (int)f.pat, (size_t)bytes, st);
  return cu_memset(f.size)((unsigned long long)(uintptr_t)p, (unsigned)f.pat,
                               (size_t)(bytes / f.size), st);
}

// The identity's bits into the count elements of y: one memset node, or
// fold_fill_kernel where no memset writes them
template <typename S>
static int fill_identity(S* y, int64_t count, long long bits, cudaStream_t st) {
  const Fill f = fill_of<S>(bits);
  if (f.size) return fill_bytes(y, count * (int64_t)sizeof(S), f, st);
  S id;
  std::memcpy(&id, &bits, sizeof(S));  // the low bytes
  fold_fill_kernel<S><<<(unsigned)std::min(ceil_div(count, FOLD_THREADS), (int64_t)4096),
                        FOLD_THREADS, 0, st>>>(y, count, id);
  return (int)cudaGetLastError();
}

// The blocks of fold_rows_kernel<T, KIND> resident on the current card at
// once (cached per card)
template <typename T, int KIND>
static int64_t resident_blocks() {
  static int cached[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cached[dev]) return cached[dev];
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fold_rows_kernel<T, KIND>,
                                                FOLD_THREADS, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int r = per_sm * sms > 0 ? per_sm * sms : 1;
  if (dev < 64) cached[dev] = r;
  return r;
}

template <typename T, int KIND>
int launch_rows(const void* vals, const void* seg, int seg64, int64_t n, int64_t n_seg,
                double identf, long long identi, void* y, char* scratch, cudaStream_t st) {
  using S = typename Store<T>::S;
  const Fill f = fill_of<S>(identi);
  const int64_t y_bytes = align16(n_seg * (int64_t)sizeof(S));
  unsigned long long fresh = 0;
  int rc;
  if (f.size && scratch == static_cast<char*>(y) + y_bytes) {
    // the scratch follows y (kernels/fold.py allocates them so): one
    // memset writes the identity into y and its pattern into the records
    rc = fill_bytes(y, y_bytes + rows_scratch(n), f, st);
    fresh = fill_word(f);
  } else {
    rc = (int)cudaMemsetAsync(scratch, 0, rows_scratch(n), st);
    if (!rc) rc = fill_identity(static_cast<S*>(y), n_seg, identi, st);
  }
  if (rc) return rc;
  const int64_t grid = std::min(ceil_div(n, FOLD_TILE), resident_blocks<T, KIND>());
  const int vec = (uintptr_t)vals % 16 == 0 && (uintptr_t)seg % 16 == 0;
  fold_rows_kernel<T, KIND><<<(unsigned)grid, FOLD_THREADS, 0, st>>>(
      static_cast<const S*>(vals), seg, seg64, vec, n, n_seg, identf, identi,
      static_cast<S*>(y), reinterpret_cast<unsigned long long*>(scratch),
      reinterpret_cast<FoldRec*>(scratch + 16), fresh);
  return (int)cudaGetLastError();
}

template <typename T, int KIND>
int launch_cols(const void* vals, int64_t ld, const void* perm, int perm64, const void* seg,
                int seg64, int64_t n, int64_t B, int64_t n_seg, double identf,
                long long identi, void* y, char* scratch, cudaStream_t st) {
  using F = Fold<T, KIND>;
  using Acc = typename F::Acc;
  using S = typename Store<T>::S;
  const int cols = (int)(B < FOLD_COLS ? (B + 31) / 32 * 32 : FOLD_COLS);
  auto* yt = static_cast<S*>(y);
  const int rc = fill_identity(yt, n_seg * B, identi, st);
  if (rc) return rc;
  for (int64_t m = n, level = 0;; ++level) {
    const int64_t chunks = ceil_div(m, FOLD_ROWS);
    const int fin = chunks == 1;
    Acc* cv = nullptr;
    int64_t* cs = nullptr;
    if (!fin) {
      cv = reinterpret_cast<Acc*>(scratch);
      scratch += align16(2 * chunks * B * (int64_t)sizeof(Acc));
      cs = reinterpret_cast<int64_t*>(scratch);
      scratch += align16(2 * chunks * 8);
    }
    const dim3 grid((unsigned)chunks, (unsigned)((B + cols - 1) / cols));
    if (level == 0)
      fold_cols_kernel<T, KIND, true><<<grid, cols, 0, st>>>(
          vals, ld, perm, perm64, seg, seg64, m, B, n_seg, identf, identi, yt, cv, cs, fin);
    else
      fold_cols_kernel<T, KIND, false><<<grid, cols, 0, st>>>(
          vals, ld, perm, perm64, seg, seg64, m, B, n_seg, identf, identi, yt, cv, cs, fin);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || fin) return (int)e;
    vals = cv;
    seg = cs;
    seg64 = 1;
    perm = nullptr;
    ld = B;
    m = 2 * chunks;
  }
}

template <typename T, int KIND>
int launch_fold(const void* vals, int64_t ld, const void* perm, int perm64, const void* seg,
                int seg64, int64_t n, int64_t B, int64_t n_seg, double identf,
                long long identi, void* y, char* scratch, cudaStream_t st) {
  // instantiated per fold (sum, min, max), which is all a ring's fold is
  if (B == 1)
    return launch_rows<T, KIND>(vals, seg, seg64, n, n_seg, identf, identi, y, scratch, st);
  return launch_cols<T, KIND>(vals, ld, perm, perm64, seg, seg64, n, B, n_seg, identf, identi,
                              y, scratch, st);
}

extern "C" {

int64_t spmv_fold_scratch_bytes(int64_t n, int64_t B, int32_t ring, int32_t dtype) {
  return fold_scratch(n, B, ring, dtype);
}

// vals: n rows (B = 1: n values) of B values, row stride ld, or rows
// perm[i] of such a table where perm is not null; seg: n sorted segment
// ids (int64 where seg64, else int32); y: (n_seg, B) contiguous; the
// identity as a double (floating values) and as the value type stores it
// (identi: an integer's value, a floating type's bits); scratch:
// spmv_fold_scratch_bytes(n, B, ring, dtype) bytes, 16-byte aligned
int spmv_segment_fold(const void* vals, int64_t ld, const void* perm, int32_t perm64,
                      const void* seg, int32_t seg64, int64_t n, int64_t B, int64_t n_seg,
                      double identf, int64_t identi, void* y, void* scratch,
                      int64_t scratch_bytes, int32_t dtype, int32_t ring, void* stream) {
  if (n < 1 || B < 1 || n_seg < 1 || B > (int64_t)FOLD_COLS * 65535 ||
      ceil_div(n, B == 1 ? FOLD_TILE : FOLD_ROWS) > 0x7fffffff || (B == 1 && perm) ||
      (B == 1 && n_seg > 0x7fffffff) ||
      scratch_bytes < fold_scratch(n, B, ring, dtype) || (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
  const int kind = fold_kind(ring);
#define SPMV_LAUNCH_K16(T, K)                                                          \
  return launch_fold<T, K>(vals, ld, perm, perm64, seg, seg64, n, B, n_seg, identf,    \
                           (long long)identi, y, static_cast<char*>(scratch),          \
                           (cudaStream_t)stream)
#define SPMV_LAUNCH_T(T)                                         \
  {                                                              \
    if (kind == FOLD_SUM) SPMV_LAUNCH_K16(T, FOLD_SUM);          \
    if (kind == FOLD_MIN) SPMV_LAUNCH_K16(T, FOLD_MIN);          \
    if (kind == FOLD_MAX) SPMV_LAUNCH_K16(T, FOLD_MAX);          \
    return (int)cudaErrorInvalidValue;                           \
  }
  switch (dtype) {
    case SPMV_I32: SPMV_LAUNCH_T(int32_t) break;
    case SPMV_I64: SPMV_LAUNCH_T(long long) break;
    default: SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
  }
#undef SPMV_LAUNCH_T
#undef SPMV_LAUNCH_K16
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
