// K10, the kernel of `merge_tiled`, for Hopper, instantiated per value
// type (values.cuh: float32, bfloat16, float16) and per ring. Plain C
// launcher for ctypes; see kernels/merge.py for the wrapper `_merge_group_pass`, its
// plain PyTorch version and the launch counter.
//
// Replaces spmv_tpu/kernels/merge.py:438 _merge_spmv_device (pallas_call
// at :478), body _merge_group_kernel (:359), carry chain :394-423.
//
// A group is sbt = 128/S tiles of EN = S*128 products: a (128, 128)
// block of products and of row ids (`rel`, non-decreasing within a
// tile). Per group, the TPU kernel runs one segmented scan of the block,
// routes each tile's row-end values into the tile's y window, and then
// walks the carry chain tile by tile in an SMEM register, which works
// there because its grid runs in order on one core. Blocks on Hopper run
// in no order, so the work is split in two launches, and neither walks
// anything one tile or one element at a time.
//
// What bounds it on this card: bytes. Pass 1 reads the products, the row
// ids and the three route stages and writes the y windows once: 64.1 MB
// on the bench matrix's tuned plan, 19.1 us at 3.35 TB/s (products and y
// windows take half the bytes in bfloat16 and float16). Pass 2 touches
// a few bytes per tile; what it costs is latency, so it must take a
// number of steps that grows with log T, not with T.
//
// Both passes scan and carry in float64 and round to the value type once,
// where a value leaves the kernel (the y windows): to float32, then to
// bfloat16 or float16, as torch converts a float64 tensor. A tile that
// takes a carry gets its first window element from pass 2 alone, from
// the unrounded value pass 1 keeps for it (`raw`), so that element too is
// rounded once. A float32 sum over a hub
// row drifts with its order: bench's tuned plan has 1372 tiles inside
// one row, whose partial sums (the windows of its tiles) cross zero, and
// near zero two float32 orders differ by more than rtol 2e-4 / atol
// 1e-5. In float64 a reordered sum stays well within that of the plain
// version, which sums in float64 too. Min, max and or give float32's
// bits either way.
//
// Pass 1, merge_group_kernel: one CTA of 1024 threads per group, one CTA
// per SM (160.5 KB of shared memory).
//   - s1 and s2 of the group's route go to shared memory by cp.async as
//     the CTA starts (s2's rows padded from 128 to 132 bytes: the route
//     reads a column of s2, which unpadded rows put in one bank), so the
//     route's two dependent byte reads hit shared memory.
//   - The segmented scan is work-efficient. Warp w owns rows 4w .. 4w+3
//     of the block; in each row lane l loads lanes 4l .. 4l+3 as one
//     4-value access of products (a float4, or a uint2 of 2-byte values,
//     widened) and one int4 of ids (coalesced, streamed with __ldcs). Ids are offset by tile * RW, so runs never link across
//     tiles. The lane scans its four in registers, the warp scans the
//     lanes' (value, last id) by shuffles and carries the row's total to
//     its next row; then one warp scans the 32 warp totals, and each warp
//     folds its prefix into the elements of its first run. Ids never
//     decrease along the block, so a span continues the run before it
//     exactly when its last id equals that run's id: (value, last id) is
//     all the scan carries. The ids never go to shared memory; only the
//     scanned values do (128 KB in float64), for the route.
//   - The planned 3-stage route (route3.cuh's composition; liveness in
//     bit 7 of pr3) writes the group's sbt*P rows of y windows, 4 a
//     thread, the identity where not live.
//   - Each tile's last-row value (the scan at cnt-1; the reference's
//     masked reduction, reduce(identity, .), where the route has no spare
//     row for it) goes to a (2T,) float64 scratch array `raw`, and the
//     unrounded value routed to its first window element to raw[T + t].
//   Shared memory holds the scanned block in float64 whatever the value
//   type (products are not staged), so K10_SMEM is the same for all three.
// Pass 2, merge_carry_kernel: one CTA of 1024 threads, 4 tiles a thread,
//   chunks of 4096 tiles with the state carried across chunks. The walk
//   of merge.py:394-423 depends on the values only through raw, so it is
//   two block scans:
//   - the last non-empty tile before each tile, a max-scan of (index,
//     lrow); tile t folds the carry when that lrow equals r_start[t];
//   - the carry into each tile, an exclusive segmented scan of raw over
//     the non-empty tiles in tile order (empty tiles pass it on), seeded
//     with the identity: a non-empty tile starts a new run unless it
//     folds and is one row (lrow == r_start).
//   Then every folding tile merges its carry into the unrounded value of
//   its first window element and writes it, rounded. The order of a sum (a tree here, left to right in the plain
//   version) moves it by float64 rounding only: within rtol 2e-4 / atol
//   1e-5 of the plain version, and bit for bit on integer-valued data.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"
#include "values.cuh"

#define K10_FULL 0xffffffffu
#define K10_THREADS 1024
#define K10_WARPS (K10_THREADS / 32)
#define K10_WARP_ROWS (SPMV_LANES / K10_WARPS)  // 4 rows of the block a warp
#define K10_BATCH 2                              // rows loaded at once
#define K10_SMEM (SPMV_TILE * (int)sizeof(double) + SPMV_TILE + SPMV_S2_STAGED)
#define K10C_THREADS 1024
#define K10C_ITEMS 4
#define K10C_CHUNK (K10C_THREADS * K10C_ITEMS)

// The ring's reduce in float64, in which K10 scans and carries. Sums
// round once, to float32, where they leave the kernel; min, max and or
// give float32's bits either way. A user-defined ring reduces in float32,
// as its plain version does: its operands and results are float32 values,
// which float64 holds exactly.
template <int RING>
__device__ __forceinline__ double k10_reduce(double e, double l) {
  if (RING == SPMV_RING_PLUS_TIMES || RING == SPMV_RING_OR_AND_COUNT) return __dadd_rn(e, l);
  if (RING == SPMV_RING_MIN_PLUS) return (e != e || e < l) ? e : l;
  if (RING == SPMV_RING_MAX_TIMES || RING == SPMV_RING_OR_AND)
    return (e != e || e > l) ? e : l;  // max-times and or-and reduce by max
  return (double)Ring<RING>::reduce((float)e, (float)l);
}

// --- pass 1: the scan element is (running value, id of its run)
struct SegVal {
  double v;
  int id;
};

template <int RING>
__device__ __forceinline__ SegVal seg_join(SegVal e, SegVal l) {
  if (l.id == e.id) l.v = k10_reduce<RING>(e.v, l.v);
  return l;
}

__device__ __forceinline__ SegVal shfl_up(SegVal s, int d) {
  return {__shfl_up_sync(K10_FULL, s.v, d), __shfl_up_sync(K10_FULL, s.id, d)};
}

template <int RING>
__device__ __forceinline__ SegVal warp_scan(SegVal s, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const SegVal n = shfl_up(s, d);
    if (lane >= d) s = seg_join<RING>(n, s);
  }
  return s;
}

// a float64 value rounded to the value type: to float32, then to T, as
// torch converts a float64 tensor
template <typename T>
__device__ __forceinline__ Bits<T> k10_round(double v) {
  return Num<T>::round(__double2float_rn(v));
}

// the unrounded value pr3 byte b routes to a position of row r: the
// scanned value of its source, or the identity where the route is not live
template <int RING>
__device__ __forceinline__ double k10_routed(const double* sv, const uint8_t* st1,
                                             const uint8_t* st2, int b, int r) {
  if (!(b & 0x80)) return Ring<RING>::identity();
  return sv[route_src_staged(st1, st2, b & 0x7f, r)];
}

template <typename T, int RING>
__global__ void __launch_bounds__(K10_THREADS, 1)
    merge_group_kernel(const typename Num<T>::Pack4* __restrict__ prod,
                       const int32_t* __restrict__ rel,
                       const uint8_t* __restrict__ p1,
                       const uint8_t* __restrict__ p2,
                       const uint8_t* __restrict__ p3,
                       const int32_t* __restrict__ cnt,
                       double* __restrict__ raw, double* __restrict__ head,
                       Bits<T>* __restrict__ y, int S, int P) {
  using P4 = typename Num<T>::Pack4;
  const double ident = Ring<RING>::identity();
  extern __shared__ __align__(16) unsigned char k10_smem[];
  double* sv = reinterpret_cast<double*>(k10_smem);  // the scanned block
  uint8_t* st1 = k10_smem + SPMV_TILE * sizeof(double);
  uint8_t* st2 = st1 + SPMV_TILE;
  __shared__ SegVal wtot[K10_WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RW = P * SPMV_LANES, sbt = SPMV_LANES / S;
  const int64_t base = (int64_t)blockIdx.x * SPMV_TILE;

  // (a) the route's first two stages, in flight while the block scans
  route_stage_async(st1, st2, p1, p2, base, tid, K10_THREADS);
  asm volatile("cp.async.commit_group;\n" ::);

  // (b) the segmented scan, row by row within the warp
  const P4* prod4 = prod + base / 4;
  const int4* rel4 = reinterpret_cast<const int4*>(rel + base);
  SegVal carry = {ident, INT_MIN};  // the warp's rows so far
  int first_id = 0;   // id of the warp's first element
  unsigned lead = 0;  // bit 4j+e: element e of this lane in row j is in that run
#pragma unroll
  for (int j0 = 0; j0 < K10_WARP_ROWS; j0 += K10_BATCH) {
    P4 a[K10_BATCH];
    int4 b[K10_BATCH];
#pragma unroll
    for (int j = 0; j < K10_BATCH; ++j) {
      const int row = warp * K10_WARP_ROWS + j0 + j;
      a[j] = __ldcs(prod4 + row * 32 + lane);
      b[j] = __ldcs(rel4 + row * 32 + lane);
    }
#pragma unroll
    for (int j = 0; j < K10_BATCH; ++j) {
      const int row = warp * K10_WARP_ROWS + j0 + j;
      const int off = (row / S) * RW;  // a row lies in one tile
      const float4 af = Num<T>::widen4(a[j]);
      double v[4] = {af.x, af.y, af.z, af.w};
      const int id[4] = {b[j].x + off, b[j].y + off, b[j].z + off, b[j].w + off};
#pragma unroll
      for (int e = 1; e < 4; ++e)
        if (id[e] == id[e - 1]) v[e] = k10_reduce<RING>(v[e - 1], v[e]);
      const SegVal inc = warp_scan<RING>({v[3], id[3]}, lane);
      SegVal pre = shfl_up(inc, 1);
      pre = lane == 0 ? carry : seg_join<RING>(carry, pre);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (id[e] == pre.id) v[e] = k10_reduce<RING>(pre.v, v[e]);
      if (j0 + j == 0) first_id = __shfl_sync(K10_FULL, id[0], 0);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (id[e] == first_id) lead |= 1u << (4 * (j0 + j) + e);
      carry = {__shfl_sync(K10_FULL, v[3], 31), __shfl_sync(K10_FULL, id[3], 31)};
      double2* o = reinterpret_cast<double2*>(sv + row * SPMV_LANES + 4 * lane);
      o[0] = make_double2(v[0], v[1]);
      o[1] = make_double2(v[2], v[3]);
    }
  }
  // (c) the warp totals, scanned by warp 0; each warp's prefix folds into
  // the elements of its first run
  if (lane == 0) wtot[warp] = carry;
  __syncthreads();
  if (warp == 0) {
    const SegVal ex = shfl_up(warp_scan<RING>(wtot[lane], lane), 1);
    wtot[lane] = lane == 0 ? SegVal{ident, INT_MIN} : ex;
  }
  __syncthreads();
  const SegVal pw = wtot[warp];
  if (pw.id == first_id) {
    for (unsigned m = lead; m; m &= m - 1) {
      const int bit = __ffs(m) - 1;
      const int i = (warp * K10_WARP_ROWS + (bit >> 2)) * SPMV_LANES + 4 * lane + (bit & 3);
      sv[i] = k10_reduce<RING>(pw.v, sv[i]);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // (d) the route into the y windows, 4 positions of one row a thread
  const uchar4* q3 = reinterpret_cast<const uchar4*>(p3 + base);
  P4* yg = reinterpret_cast<P4*>(y + (int64_t)blockIdx.x * sbt * RW);
  const int n_out4 = sbt * P * SPMV_LANES / 4;
  for (int q = tid; q < n_out4; q += K10_THREADS) {
    const uchar4 b = __ldcs(q3 + q);
    const int r = q >> 5;
    yg[q] = Num<T>::pack4(k10_round<T>(k10_routed<RING>(sv, st1, st2, b.x, r)),
                          k10_round<T>(k10_routed<RING>(sv, st1, st2, b.y, r)),
                          k10_round<T>(k10_routed<RING>(sv, st1, st2, b.z, r)),
                          k10_round<T>(k10_routed<RING>(sv, st1, st2, b.w, r)));
  }
  // (e) each tile's last-row value, the source of the carry chain, and the
  // unrounded value of its first window element (row tid * P, lane 0)
  if (tid < sbt) {
    const int t = blockIdx.x * sbt + tid;
    const int c = min(cnt[t], S * SPMV_LANES);
    double rv = ident;
    if (c > 0) {
      rv = sv[tid * S * SPMV_LANES + c - 1];
      if (sbt * P + sbt > SPMV_LANES) rv = k10_reduce<RING>(ident, rv);
    }
    raw[t] = rv;
    head[t] = k10_routed<RING>(sv, st1, st2, __ldg(p3 + base + tid * P * SPMV_LANES),
                               tid * P);
  }
}

// --- pass 2: block scans over the tiles
#define K10C_NONE LLONG_MIN

// element of the carry scan: f bit 0 starts a new run, bit 1 marks an
// empty tile, which passes the carry on unchanged
struct Carry {
  double v;
  int f;
};

template <int RING>
struct CarryJoin {
  __device__ __forceinline__ Carry operator()(Carry e, Carry l) const {
    if (l.f & 2) return e;
    if (e.f & 2) return l;
    if (!(l.f & 1)) l.v = k10_reduce<RING>(e.v, l.v);
    l.f |= e.f & 1;
    return l;
  }
};

struct MaxJoin {
  __device__ __forceinline__ long long operator()(long long e, long long l) const {
    return e > l ? e : l;
  }
};

__device__ __forceinline__ long long shfl_up(long long v, int d) {
  return __shfl_up_sync(K10_FULL, v, d);
}

__device__ __forceinline__ Carry shfl_up(Carry c, int d) {
  return {__shfl_up_sync(K10_FULL, c.v, d), __shfl_up_sync(K10_FULL, c.f, d)};
}

// Exclusive scan of one element a thread, in thread order, of a CTA of
// K10C_THREADS threads, seeded with `seed`; `total` gets seed joined with
// every element. sm holds 33 elements.
template <class T, class Join>
__device__ __forceinline__ T k10_block_scan(T x, T seed, T* sm, T& total) {
  const Join join{};
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T n = shfl_up(inc, d);
    if (lane >= d) inc = join(n, inc);
  }
  if (lane == 31) sm[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = sm[lane];  // K10C_THREADS / 32 == 32 warp totals
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const T n = shfl_up(w, d);
      if (lane >= d) w = join(n, w);
    }
    const T ex = shfl_up(w, 1);
    sm[lane] = lane == 0 ? seed : join(seed, ex);
    if (lane == 31) sm[32] = join(seed, w);
  }
  __syncthreads();
  const T ex = shfl_up(inc, 1);
  const T out = lane == 0 ? sm[warp] : join(sm[warp], ex);
  total = sm[32];
  __syncthreads();  // sm is reused by the next scan
  return out;
}

template <typename T, int RING>
__global__ void __launch_bounds__(K10C_THREADS)
    merge_carry_kernel(const int32_t* __restrict__ r_start,
                       const int32_t* __restrict__ lrow,
                       const int32_t* __restrict__ cnt,
                       const double* __restrict__ raw,
                       const double* __restrict__ head, Bits<T>* __restrict__ y,
                       int n_tiles, int RW) {
  const double ident = Ring<RING>::identity();
  __shared__ long long s_last[33];
  __shared__ Carry s_carry[33];
  // the chain's state before the chunk: the last non-empty tile as
  // (index << 32 | lrow), and the carry, the identity before tile 0
  long long last = K10C_NONE;
  Carry carry = {ident, 1};
  for (int t0 = 0; t0 < n_tiles; t0 += K10C_CHUNK) {
    const int tb = t0 + threadIdx.x * K10C_ITEMS;
    int rs[K10C_ITEMS], lr[K10C_ITEMS], c[K10C_ITEMS];
    double rv[K10C_ITEMS];
#pragma unroll
    for (int i = 0; i < K10C_ITEMS; ++i) {
      const bool in = tb + i < n_tiles;
      rs[i] = in ? r_start[tb + i] : 0;
      lr[i] = in ? lrow[tb + i] : 0;
      c[i] = in ? cnt[tb + i] : 0;
      rv[i] = in ? raw[tb + i] : ident;
    }
    // the last non-empty tile before each tile
    long long agg = K10C_NONE;
#pragma unroll
    for (int i = 0; i < K10C_ITEMS; ++i)
      if (c[i] > 0) agg = ((long long)(tb + i) << 32) | (unsigned)lr[i];
    long long prev = k10_block_scan<long long, MaxJoin>(agg, last, s_last, last);
    // fold flags, and each tile's element of the carry scan
    bool fold[K10C_ITEMS];
    Carry e[K10C_ITEMS];
#pragma unroll
    for (int i = 0; i < K10C_ITEMS; ++i) {
      const int carry_row = prev == K10C_NONE ? -1 : (int)(unsigned)prev;
      fold[i] = tb + i < n_tiles && carry_row == rs[i];
      e[i] = c[i] > 0 ? Carry{rv[i], (fold[i] && lr[i] == rs[i]) ? 0 : 1}
                      : Carry{ident, 2};
      if (c[i] > 0) prev = ((long long)(tb + i) << 32) | (unsigned)lr[i];
    }
    // the carry into each tile
    const CarryJoin<RING> join{};
    Carry a = e[0];
#pragma unroll
    for (int i = 1; i < K10C_ITEMS; ++i) a = join(a, e[i]);
    Carry cin = k10_block_scan<Carry, CarryJoin<RING>>(a, carry, s_carry, carry);
#pragma unroll
    for (int i = 0; i < K10C_ITEMS; ++i) {
      if (fold[i])
        y[(int64_t)(tb + i) * RW] = k10_round<T>(k10_reduce<RING>(cin.v, head[tb + i]));
      cin = join(cin, e[i]);
    }
  }
}

template <typename T>
int launch_merge_group(const void* prod, const int32_t* rel, const uint8_t* p1,
                       const uint8_t* p2, const uint8_t* p3, const int32_t* r_start,
                       const int32_t* lrow, const int32_t* cnt, double* raw, void* y,
                       int n_tiles, int S, int P, int ring, cudaStream_t st) {
  // 4-value loads and stores of prod and y (16 bytes, or 8 of 2-byte
  // values), int4 loads of rel, 16-byte cp.async from s1
  const uintptr_t a4 = 4 * sizeof(Bits<T>);
  if ((uintptr_t)prod % a4 || (uintptr_t)y % a4 ||
      ((uintptr_t)rel | (uintptr_t)p1 | (uintptr_t)p2 | (uintptr_t)p3) % 16)
    return (int)cudaErrorMisalignedAddress;
  if (n_tiles == 0) return 0;
  const int groups = n_tiles / (SPMV_LANES / S);
  const auto* pr = static_cast<const typename Num<T>::Pack4*>(prod);
  auto* yt = static_cast<Bits<T>*>(y);
#define SPMV_LAUNCH_K10(R)                                                    \
  {                                                                           \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        merge_group_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
        K10_SMEM);                                                            \
    if (e != cudaSuccess) return (int)e;                                      \
    merge_group_kernel<T, R><<<groups, K10_THREADS, K10_SMEM, st>>>(          \
        pr, rel, p1, p2, p3, cnt, raw, raw + n_tiles, yt, S, P);              \
    merge_carry_kernel<T, R><<<1, K10C_THREADS, 0, st>>>(                     \
        r_start, lrow, cnt, raw, raw + n_tiles, yt, n_tiles, P * SPMV_LANES); \
  }
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K10)
#undef SPMV_LAUNCH_K10
  return (int)cudaGetLastError();
}

extern "C" {

// raw: a (2T,) float64 scratch array
int spmv_merge_group(const void* prod, const int32_t* rel, const uint8_t* p1,
                     const uint8_t* p2, const uint8_t* p3,
                     const int32_t* r_start, const int32_t* lrow,
                     const int32_t* cnt, double* raw, void* y, int32_t T,
                     int32_t S, int32_t P, int32_t dtype, int32_t ring,
                     void* stream) {
  if (S < 1 || S > SPMV_LANES || SPMV_LANES % S || P < 1 ||
      (SPMV_LANES / S) * P > SPMV_LANES || T < 0 || T % (SPMV_LANES / S))
    return (int)cudaErrorInvalidValue;
#define SPMV_LAUNCH_T(T_)                                                     \
  return launch_merge_group<T_>(prod, rel, p1, p2, p3, r_start, lrow, cnt,    \
                                raw, y, T, S, P, ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

}  // extern "C"
