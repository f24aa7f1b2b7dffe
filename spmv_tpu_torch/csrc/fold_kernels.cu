// K16: the sorted-segment fold, y[s] = identity (+) every vals[i] with
// seg[i] == s, in a fixed order, for Hopper, instantiated per value type
// (values.cuh: float32, bfloat16, float16) and built-in ring. Plain C
// launcher for ctypes; see kernels/fold.py (segment_fold) for the
// wrapper, its launch counter and the scratch it allocates, and
// ops/semiring.py (_segment_reduce_plain) for its plain PyTorch version.
//
// Replaces the reference's spmv_tpu/ops/semiring.py:130
// segment_reduce_sorted (jax.ops.segment_sum / segment_min / segment_max
// with indices_are_sorted=True), which XLA compiles into the same jit as
// the Pallas kernel before it: Phase C of kernels/ell.py:_ell_spmv_device
// (after K11), of parallel/dist_spmv.py:_local_ell_matvec (after K11') and
// of kernels/spmm.py:_spmm_window_pass (after K13, whose products it reads
// through `perm`); alone in `xla`, `spmm_xla`, `spmv_values` and the
// split-row fixup. On the TPU those give the same y on every call. K16
// uses no atomics and nothing whose order depends on which block
// finishes first, so its y is a fixed function of its inputs too.
//
// Arithmetic, as the plain version's: plus-times and the or-and counting
// ring add in float64 and round once to the value type (float64 to
// float32, then to the 2-byte type, as Tensor.to rounds on the CPU);
// min-plus folds by torch.minimum's rule, max-times and or-and by
// torch.maximum's (NaN propagates; of two equal operands, +0 and -0, the
// earlier), as scatter_reduce's amin and amax do in a 1-D fold on the CPU,
// in float32, which is exact. The identity is folded in once, before a segment's first
// element; a segment no element names gets the identity.
//
// What bounds it: bytes. vals, seg (and perm) read once, y written once:
// bench's `xla` fold, 3.3M float32 products, int32 row ids and 1M rows,
// is about 31 MB, 9 us at 3.35 TB/s. The design reads them once and
// writes y twice (the identity fill, then the folded rows) plus two
// carry items a chunk.
//
// The design, one level over the elements and then carry levels:
//  - B = 1 (fold_rows_kernel): a block of FOLD_THREADS takes FOLD_CHUNK
//    consecutive elements, staged in shared memory by coalesced loads;
//    each thread folds its FOLD_ITEMS consecutive elements in order; an
//    inclusive segmented scan of the threads' partials (a warp scan by
//    shuffles, d = 1, 2, ..., 16, then the warps' totals in warp order)
//    gives each thread the partial that runs into its first element; a
//    segment that is neither the chunk's first nor its last is complete
//    and is written at once.
//  - B > 1 (fold_cols_kernel): a block of up to FOLD_COLS threads takes
//    FOLD_ROWS consecutive rows of up to FOLD_COLS columns, one column a
//    thread, so that neighbouring threads read neighbouring addresses;
//    each thread folds its column's rows in order, FOLD_BATCH loads in
//    flight. Row i of vals is perm[i] where perm is given.
//  - The chunk's first and last segments' partials, in the accumulator
//    type, go to a carry array, two items a chunk (the second a neutral
//    item when the chunk holds one segment). The next level folds the
//    carry items by the same body, until one chunk holds them all and
//    writes every segment: ceil(log_C(n)) launches, each of every chunk
//    at once, so a hub row that spans many chunks is folded by many
//    blocks and then a few carry items, never walked by one thread.
//  - Rows no element names keep the identity, which fold_fill_kernel
//    writes into every row of y before the first level (one more write of
//    y, so that a run of empty rows, such as a shard's rows with no halo
//    column, costs no thread a serial walk).

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "values.cuh"

#define FOLD_THREADS 256
#define FOLD_ITEMS 8
#define FOLD_CHUNK (FOLD_THREADS * FOLD_ITEMS)  // elements a block folds (B = 1)
#define FOLD_COLS 128                          // columns a block takes (B > 1)
#define FOLD_ROWS 256                          // rows a block folds (B > 1)
#define FOLD_BATCH 8                           // rows a column thread loads at once

// A built-in ring's fold: its accumulator, its reduce (earlier operand
// first) and a neutral item, n with reduce(a, n) == reduce(n, a) == a bit
// for bit, which pads a carry pair
struct FoldSum {
  using Acc = double;
  static __device__ __forceinline__ double reduce(double e, double l) {
    return __dadd_rn(e, l);
  }
  static __device__ __forceinline__ double null() { return -0.0; }
};

struct FoldMin {
  using Acc = float;
  static __device__ __forceinline__ float reduce(float e, float l) {
    return spmv_tmin(e, l);
  }
  static __device__ __forceinline__ float null() { return __int_as_float(0x7f800000); }
};

struct FoldMax {
  using Acc = float;
  static __device__ __forceinline__ float reduce(float e, float l) {
    return spmv_tmax(e, l);
  }
  static __device__ __forceinline__ float null() { return __int_as_float(0xff800000); }
};

template <int RING>
struct Fold;
template <>
struct Fold<SPMV_RING_PLUS_TIMES> : FoldSum {};
template <>
struct Fold<SPMV_RING_OR_AND_COUNT> : FoldSum {};
template <>
struct Fold<SPMV_RING_MIN_PLUS> : FoldMin {};
template <>
struct Fold<SPMV_RING_MAX_TIMES> : FoldMax {};
template <>
struct Fold<SPMV_RING_OR_AND> : FoldMax {};

// (partial, a segment begins in it) of the segmented scan
template <class F>
struct Part {
  typename F::Acc v;
  bool f;
};

// The segmented scan's operator, earlier operand first
template <class F>
__device__ __forceinline__ Part<F> join(Part<F> e, Part<F> l) {
  return l.f ? l : Part<F>{F::reduce(e.v, l.v), e.f};
}

__device__ __forceinline__ long long ld_index(const void* p, int is64, int64_t i) {
  return is64 ? __ldg(static_cast<const long long*>(p) + i)
              : (long long)__ldg(static_cast<const int32_t*>(p) + i);
}

// Element i of vals: at the first level T's bits, widened (exactly); at
// a carry level an accumulator
template <typename T, typename Acc, bool FIRST>
__device__ __forceinline__ Acc ld_val(const void* v, int64_t i) {
  if constexpr (FIRST)
    return (Acc)Num<T>::widen(__ldg(static_cast<const Bits<T>*>(v) + i));
  else
    return __ldg(static_cast<const Acc*>(v) + i);
}

template <typename T, typename Acc>
__device__ __forceinline__ Bits<T> out_val(Acc a) {
  return Num<T>::round((float)a);  // float64 -> float32 -> T, each to nearest even
}

// Shared-memory index of a chunk's element k: one pad word every 32, so
// that a warp reading FOLD_ITEMS consecutive elements a thread spreads
// over the banks
__device__ __forceinline__ int pad(int k) { return k + (k >> 5); }

// The identity into every element of y, before the first level
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_fill_kernel(Bits<T>* __restrict__ y, int64_t count, double identity) {
  const Bits<T> id = out_val<T>(identity);
  for (int64_t i = (int64_t)blockIdx.x * FOLD_THREADS + threadIdx.x; i < count;
       i += (int64_t)gridDim.x * FOLD_THREADS)
    y[i] = id;
}

// Where a segment's value goes when its last element in the chunk is
// folded: y, or the chunk's carry pair (slot 0 its first segment, slot 1
// its last)
template <typename T, class F>
__device__ __forceinline__ void close_segment(long long s, typename F::Acc acc,
                                              long long first_id, long long last_id,
                                              bool final_level, int64_t n_seg,
                                              Bits<T>* y, typename F::Acc* cval,
                                              int64_t* cseg, int64_t c, int64_t B,
                                              int64_t col) {
  if (final_level || (s != first_id && s != last_id)) {
    if (s >= 0 && s < n_seg) y[s * B + col] = out_val<T>(acc);
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

template <typename T, int RING, bool FIRST>
__global__ void __launch_bounds__(FOLD_THREADS)
    fold_rows_kernel(const void* __restrict__ vals, const void* __restrict__ seg,
                     int seg64, int64_t n, int64_t n_seg, double identity,
                     Bits<T>* __restrict__ y, typename Fold<RING>::Acc* __restrict__ cval,
                     int64_t* __restrict__ cseg, int final_level) {
  using F = Fold<RING>;
  using Acc = typename F::Acc;
  __shared__ Acc s_val[FOLD_CHUNK + FOLD_CHUNK / 32];
  __shared__ long long s_seg[FOLD_CHUNK + FOLD_CHUNK / 32];
  __shared__ Part<F> s_warp[FOLD_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c = blockIdx.x, c0 = c * FOLD_CHUNK;
  const int m = (int)min((int64_t)FOLD_CHUNK, n - c0);
  const Acc ident = (Acc)identity;
  for (int k = tid; k < m; k += FOLD_THREADS) {
    s_seg[pad(k)] = ld_index(seg, seg64, c0 + k);
    s_val[pad(k)] = ld_val<T, Acc, FIRST>(vals, c0 + k);
  }
  const long long prev = FIRST && c0 > 0 ? ld_index(seg, seg64, c0 - 1) : -1;
  __syncthreads();
  const long long first_id = s_seg[0], last_id = s_seg[pad(m - 1)];
  const int j0 = tid * FOLD_ITEMS;

  // the thread's partial: from its last segment start (or its first
  // element) to its end; at the first level a segment's first element
  // takes the identity before it
  Part<F> agg{F::null(), false};
#pragma unroll
  for (int i = 0; i < FOLD_ITEMS; ++i) {
    const int k = j0 + i;
    if (k < m) {
      const long long s = s_seg[pad(k)];
      const bool bnd = k == 0 || s != s_seg[pad(k - 1)];
      Acc v = s_val[pad(k)];
      if (FIRST && bnd && (k > 0 || prev != s)) v = F::reduce(ident, v);
      agg = bnd ? Part<F>{v, true} : Part<F>{F::reduce(agg.v, v), agg.f};
    }
  }
  // the partial that runs into the thread's first element: an inclusive
  // scan in the warp (d = 1, 2, ..., 16), then the warps' totals in order
  Part<F> inc = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const Acc ov = __shfl_up_sync(0xffffffffu, inc.v, d);
    const bool of = __shfl_up_sync(0xffffffffu, (int)inc.f, d) != 0;
    if (lane >= d) inc = join<F>(Part<F>{ov, of}, inc);
  }
  if (lane == 31) s_warp[warp] = inc;
  const Acc ev = __shfl_up_sync(0xffffffffu, inc.v, 1);
  const bool ef = __shfl_up_sync(0xffffffffu, (int)inc.f, 1) != 0;
  __syncthreads();
  Part<F> pre{F::null(), false};
  for (int w = 0; w < warp; ++w) pre = join<F>(pre, s_warp[w]);
  if (lane > 0) pre = join<F>(pre, Part<F>{ev, ef});

  // the thread's elements again, from that partial: each segment that
  // ends here is written or carried
  Acc acc = pre.v;
#pragma unroll
  for (int i = 0; i < FOLD_ITEMS; ++i) {
    const int k = j0 + i;
    if (k < m) {
      const long long s = s_seg[pad(k)];
      const bool bnd = k == 0 || s != s_seg[pad(k - 1)];
      Acc v = s_val[pad(k)];
      if (FIRST && bnd && (k > 0 || prev != s)) v = F::reduce(ident, v);
      acc = bnd ? v : F::reduce(acc, v);
      if (k == m - 1 || s_seg[pad(k + 1)] != s)
        close_segment<T, F>(s, acc, first_id, last_id, final_level != 0, n_seg, y, cval,
                            cseg, c, 1, 0);
    }
  }
}

template <typename T, int RING, bool FIRST>
__global__ void __launch_bounds__(FOLD_COLS)
    fold_cols_kernel(const void* __restrict__ vals, int64_t ld, const void* __restrict__ perm,
                     int perm64, const void* __restrict__ seg, int seg64, int64_t n,
                     int64_t B, int64_t n_seg, double identity, Bits<T>* __restrict__ y,
                     typename Fold<RING>::Acc* __restrict__ cval, int64_t* __restrict__ cseg,
                     int final_level) {
  using F = Fold<RING>;
  using Acc = typename F::Acc;
  __shared__ long long s_seg[FOLD_ROWS];
  __shared__ long long s_row[FOLD_ROWS];
  const int tid = threadIdx.x;
  const int64_t c = blockIdx.x, r0 = c * FOLD_ROWS;
  const int m = (int)min((int64_t)FOLD_ROWS, n - r0);
  const int64_t col = (int64_t)blockIdx.y * blockDim.x + tid;
  const Acc ident = (Acc)identity;
  for (int k = tid; k < m; k += blockDim.x) {
    s_seg[k] = ld_index(seg, seg64, r0 + k);
    s_row[k] = perm ? ld_index(perm, perm64, r0 + k) : r0 + k;
  }
  const long long prev = FIRST && r0 > 0 ? ld_index(seg, seg64, r0 - 1) : -1;
  __syncthreads();
  if (col >= B) return;
  const long long first_id = s_seg[0], last_id = s_seg[m - 1];
  Acc acc = F::null();
  for (int k0 = 0; k0 < m; k0 += FOLD_BATCH) {
    Acc v[FOLD_BATCH];
#pragma unroll
    for (int u = 0; u < FOLD_BATCH; ++u)
      if (k0 + u < m) v[u] = ld_val<T, Acc, FIRST>(vals, s_row[k0 + u] * ld + col);
#pragma unroll
    for (int u = 0; u < FOLD_BATCH; ++u) {
      const int k = k0 + u;
      if (k < m) {
        const long long s = s_seg[k];
        const bool bnd = k == 0 || s != s_seg[k - 1];
        Acc x = v[u];
        if (FIRST && bnd && (k > 0 || prev != s)) x = F::reduce(ident, x);
        acc = bnd ? x : F::reduce(acc, x);
        if (k == m - 1 || s_seg[k + 1] != s)
          close_segment<T, F>(s, acc, first_id, last_id, final_level != 0, n_seg, y,
                              cval, cseg, c, B, col);
      }
    }
  }
}

static inline int64_t fold_chunks(int64_t m, int64_t C) { return (m + C - 1) / C; }
static inline int64_t align16(int64_t b) { return (b + 15) & ~(int64_t)15; }
static inline bool fold_sum_ring(int ring) {
  return ring == SPMV_RING_PLUS_TIMES || ring == SPMV_RING_OR_AND_COUNT;
}

// The carry levels' scratch, bytes: for each level but the last, its
// carry items (2 a chunk), B accumulators and one int64 segment id each
static int64_t fold_scratch(int64_t n, int64_t B, int ring) {
  const int64_t C = B == 1 ? FOLD_CHUNK : FOLD_ROWS;
  const int64_t acc = fold_sum_ring(ring) ? 8 : 4;
  int64_t bytes = 0;
  for (int64_t m = n; fold_chunks(m, C) > 1;) {
    m = 2 * fold_chunks(m, C);
    bytes += align16(m * B * acc) + align16(m * 8);
  }
  return bytes;
}

template <typename T, int RING>
int launch_fold(const void* vals, int64_t ld, const void* perm, int perm64,
                const void* seg, int seg64, int64_t n, int64_t B, int64_t n_seg,
                double identity, void* y, char* scratch, cudaStream_t st) {
  using Acc = typename Fold<RING>::Acc;
  const int64_t C = B == 1 ? FOLD_CHUNK : FOLD_ROWS;
  const int cols = (int)(B < FOLD_COLS ? (B + 31) / 32 * 32 : FOLD_COLS);
  auto* yt = static_cast<Bits<T>*>(y);
  const int64_t count = n_seg * B;
  fold_fill_kernel<T><<<(unsigned)min((count + FOLD_THREADS - 1) / FOLD_THREADS,
                                      (int64_t)4096), FOLD_THREADS, 0, st>>>(yt, count,
                                                                           identity);
  for (int64_t m = n, level = 0;; ++level) {
    const int64_t chunks = fold_chunks(m, C);
    const int fin = chunks == 1;
    Acc* cv = nullptr;
    int64_t* cs = nullptr;
    if (!fin) {
      cv = reinterpret_cast<Acc*>(scratch);
      scratch += align16(2 * chunks * B * (int64_t)sizeof(Acc));
      cs = reinterpret_cast<int64_t*>(scratch);
      scratch += align16(2 * chunks * 8);
    }
    if (B == 1) {
      if (level == 0)
        fold_rows_kernel<T, RING, true><<<(unsigned)chunks, FOLD_THREADS, 0, st>>>(
            vals, seg, seg64, m, n_seg, identity, yt, cv, cs, fin);
      else
        fold_rows_kernel<T, RING, false><<<(unsigned)chunks, FOLD_THREADS, 0, st>>>(
            vals, seg, seg64, m, n_seg, identity, yt, cv, cs, fin);
    } else {
      const dim3 grid((unsigned)chunks, (unsigned)((B + cols - 1) / cols));
      if (level == 0)
        fold_cols_kernel<T, RING, true><<<grid, cols, 0, st>>>(
            vals, ld, perm, perm64, seg, seg64, m, B, n_seg, identity, yt, cv, cs, fin);
      else
        fold_cols_kernel<T, RING, false><<<grid, cols, 0, st>>>(
            vals, ld, perm, perm64, seg, seg64, m, B, n_seg, identity, yt, cv, cs, fin);
    }
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

extern "C" {

int64_t spmv_fold_scratch_bytes(int64_t n, int64_t B, int32_t ring) {
  return fold_scratch(n, B, ring);
}

// vals: n rows (B = 1: n values) of B values, row stride ld, or rows
// perm[i] of such a table where perm is not null; seg: n sorted segment
// ids (int64 where seg64, else int32); y: (n_seg, B) contiguous; scratch:
// spmv_fold_scratch_bytes(n, B, ring) bytes, 16-byte aligned
int spmv_segment_fold(const void* vals, int64_t ld, const void* perm, int32_t perm64,
                      const void* seg, int32_t seg64, int64_t n, int64_t B, int64_t n_seg,
                      double identity, void* y, void* scratch, int64_t scratch_bytes,
                      int32_t dtype, int32_t ring, void* stream) {
  if (n < 1 || B < 1 || n_seg < 1 || B > (int64_t)FOLD_COLS * 65535 ||
      fold_chunks(n, B == 1 ? FOLD_CHUNK : FOLD_ROWS) > 0x7fffffff ||
      (B == 1 && perm) || scratch_bytes < fold_scratch(n, B, ring) ||
      (uintptr_t)scratch % 16)
    return (int)cudaErrorInvalidValue;
#define SPMV_LAUNCH_K16(R)                                                        \
  return launch_fold<T_, R>(vals, ld, perm, perm64, seg, seg64, n, B, n_seg,     \
                            identity, y, static_cast<char*>(scratch),             \
                            (cudaStream_t)stream);
#define SPMV_LAUNCH_T(T)                \
  {                                     \
    using T_ = T;                       \
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K16) \
  }
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
#undef SPMV_LAUNCH_K16
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
