// Stream-SpMV kernels K1 (x prep), K2 (gather + early row reduction,
// plus-times body) and K6 (final-tile scan, prefix differences) for
// Hopper. Plain C launchers for ctypes; see kernels/stream.py for the
// wrappers, their plain PyTorch versions and the launch counters.
//
// All three move bytes and do next to no arithmetic, so bytes bound
// them on the card. On the bench plan (power_law_csr(1<<20, 1<<20,
// 3.3M, seed 42)), each input read once and each output written once
// come to 12.5 MB for K1, 31.1 MB for K2 (which needs only c2's first Qp
// columns and c3's first Qp rows) and 23.6 MB for K6 per call. K1 and
// K2 run split_tile.cuh's staged body; K6 stages its tile and its three
// routes' first two stages the same way. Each follows its routes in
// shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "route3.cuh"
#include "split_tile.cuh"

// ---------------------------------------------------------------------------
// K1: replaces spmv_tpu/kernels/stream.py:1348 _xprep_pass (pallas_call
// at :1377). For each x window w: the 128 natural x rows starting at row
// g0[w], routed by (xr1, xr2, xr3)[w] into the lane-remapped, transposed
// x table.
//
// What bounds it: bytes, 12.5 MB on bench (the x windows read once, the
// route's three stages, the table written). The first design, one CTA per
// window and a thread per output element following the route through
// device memory, waited on four dependent L2 trips per element (s3, s2,
// s1, x), each fetching a 32-byte sector for 1 or 4 useful bytes, and
// filled 72 of the 132 SMs with bench's 72 windows.
//
// The design: K1 is split_tile.cuh's body in its whole-tile mode (sbt =
// K = 1, Q = 128, starts 0, pos[w] = w) with SplitWindowLoad, which copies
// the window's 64 KB of x by 16-byte cp.async. s1 and s2 are staged
// beside it, the route is followed in shared memory, each window row is
// written as float4s, and a launch with fewer windows than SMs splits
// each window's rows over several CTAs (bench: 4 per window, 288 CTAs).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
    xprep_kernel(const float* __restrict__ xnat, const int32_t* __restrict__ g0,
                 const uint8_t* __restrict__ r1, const uint8_t* __restrict__ r2,
                 const uint8_t* __restrict__ r3, float* __restrict__ out,
                 int rows_per_cta) {
  split_tile(SplitGeom{r1, r2, r3, nullptr, 0, nullptr, out, 1, 1, SPMV_LANES,
                       0, rows_per_cta},
             SplitWindowLoad{xnat, g0});
}

// ---------------------------------------------------------------------------
// K2: replaces spmv_tpu/kernels/stream.py:1309 _reduce_pass (pallas_call
// at :1337), plus-times body of _reduce_kernel (:1277-1300), for
// plus-times and the or-and counting ring. Per gather tile t:
//   1. products combine(Ax, x2d[xb[t]*128 + s, q]), 0 where q < 0;
//   2. an inclusive prefix C along each 128-lane row;
//   3. route (c1, c2, c3 & 127) of the prefixes;
//   4. part[i] = C[i] - (c3[i] bit 7 ? 0 : C[i-1]) in flat order. Flat
//      index 0 has no predecessor in the tile and takes 0: in a tile
//      that holds nnz it is always a sublane-first run (bit 7 set);
//   5. rows [t*Qp, (t+1)*Qp) of the output get the first Qp rows.
//
// What bounds it: bytes, 31.1 MB on bench (Ax, q, c1, c2's first Qp
// columns, c3's first Qp rows and the x windows read once, the parts
// written). The first design, one CTA of 256 threads per tile, scanned
// each row with one thread walking its 128 lanes in shared memory, and
// followed the route through device memory twice per output (the slot's
// and its predecessor's, four dependent L2 trips each, 32-byte sectors
// for 1-byte stages).
//
// The design: split_tile.cuh's body in its whole-tile mode (sbt = K = 1,
// Q = Qp, output row t*Qp + r; c2's first Qp columns staged) with two
// policies:
//   - ProductLoad<RING, RowScan<RING>> forms the products a warp per
//     128-lane row (a float4 of Ax and a char4 of q a lane) and scans the
//     row in registers (the lane's 4 values in order, a warp scan of the
//     lane totals, the lane's exclusive prefix added) before the float4
//     store;
//   - RunDiff routes the row's 4 columns a lane from the staged stages
//     and subtracts each slot's flat predecessor: the lane's previous
//     column, lane - 1's fourth by one shuffle, and for lane 0 of row
//     r >= 1 row r - 1's column 127, whose c3 byte lane 0 loads itself
//     and routes through the same staged stages.
// So no route is followed through device memory, and a CTA needs no
// other CTA's rows when split_grid splits a tile's Qp rows over several
// CTAs (a launch of fewer tiles than SMs, as a 4-shard
// distribute_stream shard's 80). 96.5 KB of shared memory, two CTAs of
// 512 threads per SM.
// ---------------------------------------------------------------------------

// K2's post-product step: a lane's 4 products become their row's
// inclusive prefix, in the ring's reduce (__fadd_rn: no contraction)
template <int RING>
struct RowScan {
  static constexpr bool kFlags = false;
  __device__ __forceinline__ void operator()(float4& v, int lane) const {
    v.y = Ring<RING>::reduce(v.x, v.y);
    v.z = Ring<RING>::reduce(v.y, v.z);
    v.w = Ring<RING>::reduce(v.z, v.w);
    float t = v.w;  // a warp inclusive scan of the lane totals
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float n = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t = Ring<RING>::reduce(n, t);
    }
    const float e = __shfl_up_sync(0xffffffffu, t, 1);  // lanes 0 .. lane-1
    if (lane > 0) {
      v.x = Ring<RING>::reduce(e, v.x);
      v.y = Ring<RING>::reduce(e, v.y);
      v.z = Ring<RING>::reduce(e, v.z);
      v.w = Ring<RING>::reduce(e, v.w);
    }
  }
};

// K2's epilogue: the routed prefixes C of window row R less their flat
// predecessors, each slot whose c3 byte has bit 7 set keeping its C
struct RunDiff {
  __device__ __forceinline__ float4 operator()(const float* C, const uint8_t* st1,
                                               const uint8_t* st2, const uint8_t* s3t,
                                               uchar4 b, int R, int lane) const {
    // lane 0's predecessor is row R - 1's last slot
    const int pre = (lane == 0 && R > 0) ? (int)__ldg(s3t + R * SPMV_LANES - 1) : -1;
    const float c0 = C[route_src_staged(st1, st2, b.x & 127, R)];
    const float c1 = C[route_src_staged(st1, st2, b.y & 127, R)];
    const float c2 = C[route_src_staged(st1, st2, b.z & 127, R)];
    const float c3 = C[route_src_staged(st1, st2, b.w & 127, R)];
    float p = __shfl_up_sync(0xffffffffu, c3, 1);  // lane - 1's last column
    if (lane == 0) p = pre < 0 ? 0.f : C[route_src_staged(st1, st2, pre & 127, R - 1)];
    return make_float4((b.x & 128) ? c0 : c0 - p, (b.y & 128) ? c1 : c1 - c0,
                       (b.z & 128) ? c2 : c2 - c1, (b.w & 128) ? c3 : c3 - c2);
  }
};

template <int RING>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
    reduce_kernel(const float* __restrict__ x2d, const float* __restrict__ ax,
                  const int8_t* __restrict__ q, const int32_t* __restrict__ xb,
                  const uint8_t* __restrict__ c1, const uint8_t* __restrict__ c2,
                  const uint8_t* __restrict__ c3, float* __restrict__ out, int Qp,
                  int rows_per_cta) {
  split_tile(SplitGeom{c1, c2, c3, nullptr, 0, nullptr, out, 1, 1, Qp, 0,
                       rows_per_cta},
             ProductLoad<RING, RowScan<RING>>{x2d, ax, q, xb}, RunDiff{});
}

// ---------------------------------------------------------------------------
// K6: replaces spmv_tpu/kernels/stream.py:1598 _scan_pass (pallas_call at
// :1633), body _scan_kernel_diff (:1467). Per final tile f:
//   1. route the products by (pm1, pm2, pm3) into exact rank order;
//   2. keep positions 1..counts[f] (position 0 is the zero prefix);
//   3. an inclusive scan P of the tile's 16384 values in flat order;
//   4. route P by (r2s*) for each row's END and by (q2s*) for its PREV
//      prefix;
//   5. write END - PREV, rounded once to float32, where valid2, else 0.
// The scan accumulates in double: a row's total is the difference of
// two prefixes of up to 16K values, and in float the rounding of those
// large prefixes swamps small rows. With a float scan, 24 rows of the
// bench matrix and 82 of the wide-row matrix (single nonzeros near 5e-3,
// off by 1%) fall outside the oracle's rtol 2e-4 / atol 1e-5 on an H100
// 80GB HBM3 at 700 W; with double, none do.
//
// What bounds it: bytes, 23.6 MB on bench (products, nine route stages,
// valid2 and counts read once, the y windows written). The first design
// followed the exact-rank route through device memory for each of a
// thread's 16 positions and the END and PREV routes for each output:
// dependent L2 trips of 32-byte sectors for 1-byte stages.
//
// The design, one CTA of K6_THREADS per tile, one per SM (209 KB of
// shared memory):
//   (a) pm1 and pm2 (route_stage_async, s2's rows padded to 132 bytes)
//       and the tile's 16384 products (64 KB, 16-byte cp.async, inside
//       P's region) go to shared memory, then, as a second cp.async
//       group, the PREV route's q2s1 and q2s2; each thread loads the pm3
//       bytes of its 16 consecutive positions as one 16-byte vector;
//   (b) once the first group has landed, each thread follows the
//       exact-rank route in shared memory and scans its positions in
//       double in registers; warp shuffles scan the thread totals, warp 0
//       the warp totals;
//   (c) the block sync that ends (b) frees the products and pm1/pm2: the
//       END route's r2s1 and r2s2 go into the pm buffers while the block
//       scan ends, and P is written over the products. P keeps two
//       doubles after each thread's 16, so the 16-byte stores of 8 lanes
//       that start 144 bytes apart fall in distinct banks;
//   (d) a warp takes one output row at a time, each lane 4 consecutive
//       columns: r2s3 and q2s3 as uchar4 and valid2 as char4, all 4 rows'
//       loaded before the staging wait, one float4 written.
// Bench's 80 tiles take 80 of the 132 SMs.
// ---------------------------------------------------------------------------
#define K6_THREADS 1024
#define K6_WARPS (K6_THREADS / 32)
#define K6_PER_THREAD (SPMV_TILE / K6_THREADS)  // 16, an eighth of a row
#define K6_PAD(p) ((p) + (((p) >> 4) << 1))     // P's index of position p
#define K6_S1_OFF (K6_PAD(SPMV_TILE) * (int)sizeof(double))
#define K6_S2_OFF (K6_S1_OFF + SPMV_TILE)
#define K6_Q1_OFF (K6_S2_OFF + SPMV_S2_STAGED)
#define K6_Q2_OFF (K6_Q1_OFF + SPMV_TILE)
#define K6_SMEM (K6_Q2_OFF + SPMV_S2_STAGED)
#define K6_ROWS (SPMV_LANES / K6_WARPS)  // output rows per warp

// One output slot of row r: END - PREV of the staged routes, or 0
__device__ __forceinline__ float k6_diff(const double* P, const uint8_t* st1,
                                         const uint8_t* st2, const uint8_t* qt1,
                                         const uint8_t* qt2, int ke, int kq, int ok,
                                         int r) {
  if (ok <= 0) return 0.f;
  return (float)(P[K6_PAD(route_src_staged(st1, st2, ke, r))] -
                 P[K6_PAD(route_src_staged(qt1, qt2, kq, r))]);
}

__global__ void __launch_bounds__(K6_THREADS, 1)
scan_diff_kernel(const float* __restrict__ prod,
                 const uint8_t* __restrict__ pm1,
                 const uint8_t* __restrict__ pm2,
                 const uint8_t* __restrict__ pm3,
                 const uint8_t* __restrict__ r2s1,
                 const uint8_t* __restrict__ r2s2,
                 const uint8_t* __restrict__ r2s3,
                 const uint8_t* __restrict__ q2s1,
                 const uint8_t* __restrict__ q2s2,
                 const uint8_t* __restrict__ q2s3,
                 const int8_t* __restrict__ valid2,
                 const int32_t* __restrict__ counts,
                 float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char k6_smem[];
  double* P = reinterpret_cast<double*>(k6_smem);
  const float* vals = reinterpret_cast<const float*>(k6_smem);  // until P is written
  uint8_t* st1 = k6_smem + K6_S1_OFF;  // pm1, then r2s1
  uint8_t* st2 = k6_smem + K6_S2_OFF;  // pm2, then r2s2
  uint8_t* qt1 = k6_smem + K6_Q1_OFF;
  uint8_t* qt2 = k6_smem + K6_Q2_OFF;
  __shared__ double warp_tot[K6_WARPS];
  const int64_t tb = (int64_t)blockIdx.x * SPMV_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * K6_PER_THREAD;
  const int row = p0 >> 7;  // the row that holds all of the thread's positions

  // (a) two cp.async groups: pm1, pm2 and the products; q2s1 and q2s2
  route_stage_async(st1, st2, pm1, pm2, tb, tid, K6_THREADS);
  tile_copy_async(reinterpret_cast<float*>(k6_smem), prod + tb, tid, K6_THREADS);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  route_stage_async(qt1, qt2, q2s1, q2s2, tb, tid, K6_THREADS);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  const uint4 k4 = __ldg(reinterpret_cast<const uint4*>(pm3 + tb + p0));
  const uint32_t kw[4] = {k4.x, k4.y, k4.z, k4.w};
  const int m = __ldg(counts + blockIdx.x);
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  __syncthreads();

  // (b) the thread's positions in exact rank order, scanned in double
  double loc[K6_PER_THREAD];
  double acc = 0.0;
#pragma unroll
  for (int e = 0; e < K6_PER_THREAD; ++e) {
    const int p = p0 + e;
    const int k = (kw[e >> 2] >> (8 * (e & 3))) & 0xff;
    if (p >= 1 && p <= m) acc += (double)vals[route_src_staged(st1, st2, k, row)];
    loc[e] = acc;
  }
  double incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();  // every product and pm1/pm2 byte has been read
  // (c) the END route's first two stages into the freed buffers
  route_stage_async(st1, st2, r2s1, r2s2, tb, tid, K6_THREADS);
  if (warp == 0) {
    double w = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const double n = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += n;
    }
    warp_tot[lane] = w;
  }
  __syncthreads();
  const double ex = __shfl_up_sync(0xffffffffu, incl, 1);  // lanes 0 .. lane-1
  const double off = (lane > 0 ? ex : 0.0) + (warp > 0 ? warp_tot[warp - 1] : 0.0);
  double2* pt = reinterpret_cast<double2*>(P + K6_PAD(p0));
#pragma unroll
  for (int i = 0; i < K6_PER_THREAD / 2; ++i)
    pt[i] = make_double2(loc[2 * i] + off, loc[2 * i + 1] + off);

  // (d) END - PREV, rows warp + u * K6_WARPS
  uchar4 be[K6_ROWS], bq[K6_ROWS];
  char4 ok[K6_ROWS];
#pragma unroll
  for (int u = 0; u < K6_ROWS; ++u) {
    const int64_t o = tb + (int64_t)(warp + u * K6_WARPS) * SPMV_LANES;
    be[u] = __ldcs(reinterpret_cast<const uchar4*>(r2s3 + o) + lane);
    bq[u] = __ldcs(reinterpret_cast<const uchar4*>(q2s3 + o) + lane);
    ok[u] = __ldcs(reinterpret_cast<const char4*>(valid2 + o) + lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // P and both routes' stages are in place
#pragma unroll
  for (int u = 0; u < K6_ROWS; ++u) {
    const int r = warp + u * K6_WARPS;
    const float4 o = make_float4(
        k6_diff(P, st1, st2, qt1, qt2, be[u].x, bq[u].x, ok[u].x, r),
        k6_diff(P, st1, st2, qt1, qt2, be[u].y, bq[u].y, ok[u].y, r),
        k6_diff(P, st1, st2, qt1, qt2, be[u].z, bq[u].z, ok[u].z, r),
        k6_diff(P, st1, st2, qt1, qt2, be[u].w, bq[u].w, ok[u].w, r));
    reinterpret_cast<float4*>(out + tb + (int64_t)r * SPMV_LANES)[lane] = o;
  }
}

// ---------------------------------------------------------------------------
// C launchers: launch on the caller's stream, return cudaGetLastError().
// ---------------------------------------------------------------------------
extern "C" {

const char* spmv_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int spmv_xprep(const float* xnat, const int32_t* g0, const uint8_t* r1,
               const uint8_t* r2, const uint8_t* r3, float* out, int32_t n_w,
               void* stream) {
  dim3 grid;
  int rows_per_cta = 0;
  cudaError_t e = split_grid(n_w, 1, 1, SPMV_LANES, &grid, &rows_per_cta);
  if (e != cudaSuccess) return (int)e;
  if (!split_aligned(xnat, r1, r2, r3, out)) return (int)cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(xprep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SPLIT_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (n_w > 0) {
    xprep_kernel<<<grid, SPLIT_THREADS, SPLIT_SMEM, (cudaStream_t)stream>>>(
        xnat, g0, r1, r2, r3, out, rows_per_cta);
  }
  return (int)cudaGetLastError();
}

int spmv_reduce(const float* x2d, const float* ax, const int8_t* q,
                const int32_t* xb, const uint8_t* c1, const uint8_t* c2,
                const uint8_t* c3, float* out, int32_t n_tiles, int32_t Qp,
                int32_t or_and, void* stream) {
  dim3 grid;
  int rows_per_cta = 0;
  cudaError_t e = split_grid(n_tiles, 1, 1, Qp, &grid, &rows_per_cta);
  if (e != cudaSuccess) return (int)e;
  if (!split_aligned(ax, q, c1, c2, c3) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
#define SPMV_LAUNCH_K2(R)                                                       \
  e = cudaFuncSetAttribute(reduce_kernel<R>,                                    \
                           cudaFuncAttributeMaxDynamicSharedMemorySize, SPLIT_SMEM); \
  if (e != cudaSuccess) return (int)e;                                          \
  if (n_tiles > 0)                                                              \
    reduce_kernel<R><<<grid, SPLIT_THREADS, SPLIT_SMEM, (cudaStream_t)stream>>>( \
        x2d, ax, q, xb, c1, c2, c3, out, Qp, rows_per_cta)
  if (or_and) {
    SPMV_LAUNCH_K2(SPMV_RING_OR_AND_COUNT);
  } else {
    SPMV_LAUNCH_K2(SPMV_RING_PLUS_TIMES);
  }
#undef SPMV_LAUNCH_K2
  return (int)cudaGetLastError();
}

int spmv_scan_diff(const float* prod, const uint8_t* pm1, const uint8_t* pm2,
                   const uint8_t* pm3, const uint8_t* r2s1,
                   const uint8_t* r2s2, const uint8_t* r2s3,
                   const uint8_t* q2s1, const uint8_t* q2s2,
                   const uint8_t* q2s3, const int8_t* valid2,
                   const int32_t* counts, float* out, int32_t F_pad,
                   void* stream) {
  // the 16-byte vector reads and writes, and the cp.async copies
  if ((((uintptr_t)prod | (uintptr_t)pm1 | (uintptr_t)pm2 | (uintptr_t)pm3 |
        (uintptr_t)r2s1 | (uintptr_t)r2s2 | (uintptr_t)r2s3 | (uintptr_t)q2s1 |
        (uintptr_t)q2s2 | (uintptr_t)q2s3 | (uintptr_t)valid2 | (uintptr_t)out) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      scan_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K6_SMEM);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(scan_diff_kernel,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  if (F_pad > 0) {
    scan_diff_kernel<<<F_pad, K6_THREADS, K6_SMEM, (cudaStream_t)stream>>>(
        prod, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2, q2s3, valid2,
        counts, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
