// Generic-ring bodies of the stream pipeline, for Hopper: K7 (gather +
// early row reduction by a segmented lane scan) and K8 (final-tile scan
// by a segmented scan keyed by row). No inverse is assumed, so min, max
// and or rings run here; plus-times takes them only on request
// (scan_strategy "roll"). Each is instantiated per built-in ring
// (ring.cuh). Plain C launchers for ctypes; see kernels/stream.py for the
// wrappers, their plain PyTorch versions and the launch counters.
//
// Both move bytes: K7 reads what K2 reads plus one run-start byte per
// slot, K8 what K6 reads less the PREV route plus a 2-byte row id per
// position. This first version is simple and right: the scan runs in
// registers and warp shuffles, its result goes through shared memory
// once, and every route byte and value is read from global memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"

// ---------------------------------------------------------------------------
// K7: replaces spmv_tpu/kernels/stream.py:1309 _reduce_pass (pallas_call
// at :1337), generic body of _reduce_kernel (:1260-1276), picked at
// :1318. One block per gather tile t, one warp per 128-lane row at a
// time, each lane owning 4 consecutive lanes of the row:
//   1. products, or the ring's identity where q < 0;
//   2. an inclusive segmented scan along the row, restarting at lanes
//      whose run-start flag rs is set (runs never cross rows): the
//      lane's 4 values in order, then a warp scan of (value, flag)
//      pairs, then the lane's exclusive prefix folded into its values
//      before its first run start; reduce(earlier, later) throughout;
//   3. the C route (c1, c2, c3 & 127) of the scan: each routed run end
//      is the run's total;
//   4. rows [t*Qp, (t+1)*Qp) of the output get the first Qp C rows
//      (the wrapper fills rows past n_tiles*Qp with the identity).
// ---------------------------------------------------------------------------
#define K7_THREADS 512
#define K7_SMEM (SPMV_TILE * sizeof(float))

template <int RING>
__global__ void __launch_bounds__(K7_THREADS)
reduce_roll_kernel(const float* __restrict__ x2d,
                   const float* __restrict__ ax,
                   const int8_t* __restrict__ q,
                   const int32_t* __restrict__ xb,
                   const uint8_t* __restrict__ c1,
                   const uint8_t* __restrict__ c2,
                   const uint8_t* __restrict__ c3,
                   const int8_t* __restrict__ rs,
                   float* __restrict__ out, int Qp) {
  extern __shared__ float S[];  // the tile's scan, 128 x 128
  const int64_t t = blockIdx.x;
  const int64_t tb = t * SPMV_TILE;
  const float* xw = x2d + (int64_t)xb[t] * SPMV_TILE;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l0 = lane * 4;
  for (int row = warp; row < SPMV_LANES; row += K7_THREADS / 32) {
    const int64_t rb = tb + row * SPMV_LANES + l0;
    float v[4];
    bool head[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qv = q[rb + e];
      v[e] = qv < 0 ? Ring<RING>::identity()
                    : Ring<RING>::combine(ax[rb + e], xw[row * SPMV_LANES + qv]);
      head[e] = rs[rb + e] != 0;
    }
    // the lane's own segmented scan; (acc, any) is its aggregate
    float acc = v[0];
    bool any = head[0];
#pragma unroll
    for (int e = 1; e < 4; ++e) {
      acc = head[e] ? v[e] : Ring<RING>::reduce(acc, v[e]);
      any = any || head[e];
      v[e] = acc;
    }
    float sv = acc;
    bool sf = any;
    warp_seg_scan<RING>(sv, sf, lane);
    const float pv = __shfl_up_sync(0xffffffffu, sv, 1);  // lanes 0..lane-1
    if (lane > 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (head[e]) break;
        v[e] = Ring<RING>::reduce(pv, v[e]);
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) S[row * SPMV_LANES + l0 + e] = v[e];
  }
  __syncthreads();
  const uint8_t* a1 = c1 + tb;
  const uint8_t* a2 = c2 + tb;
  const uint8_t* a3 = c3 + tb;
  float* o = out + t * Qp * SPMV_LANES;
  for (int i = threadIdx.x; i < Qp * SPMV_LANES; i += K7_THREADS) {
    o[i] = S[route_src(a1, a2, a3, i >> 7, i & 127, 127)];
  }
}

// ---------------------------------------------------------------------------
// K8: replaces spmv_tpu/kernels/stream.py:1598 _scan_pass (pallas_call at
// :1633), body _scan_kernel_roll (:1503), picked at :1610-1611. One block
// of 1024 threads per final tile f, as K6:
//   1. route the products by (pm1, pm2, pm3) into exact rank order;
//   2. the ring's identity where relid >= 16384 (position 0 and the
//      tail are junk);
//   3. an inclusive segmented scan of the tile's 16384 values in
//      row-major order keyed by relid & 16383: a segment starts where
//      the key differs from the previous position's. Each thread scans
//      16 consecutive positions in registers, warp shuffles scan the
//      threads' (value, flag) aggregates, shared memory carries the
//      warps' aggregates, and each thread folds its exclusive prefix
//      into its values before its first segment start. The reference
//      offsets keys per tile only so that its batched scan never links
//      two tiles; one block per tile needs no offset;
//   4. the END route (r2s1-3) of the scan, and the identity where
//      valid2 == 0.
// For plus-times ("roll") the sums are float32, as the reference's; the
// segments restart per row, so no long prefix is differenced.
// ---------------------------------------------------------------------------
#define K8_THREADS 1024
#define K8_PER_THREAD (SPMV_TILE / K8_THREADS)
#define K8_SMEM (SPMV_TILE * sizeof(float))

template <int RING>
__global__ void __launch_bounds__(K8_THREADS)
scan_roll_kernel(const float* __restrict__ prod,
                 const int16_t* __restrict__ relid,
                 const uint8_t* __restrict__ pm1,
                 const uint8_t* __restrict__ pm2,
                 const uint8_t* __restrict__ pm3,
                 const uint8_t* __restrict__ r2s1,
                 const uint8_t* __restrict__ r2s2,
                 const uint8_t* __restrict__ r2s3,
                 const int8_t* __restrict__ valid2,
                 float* __restrict__ out) {
  extern __shared__ float P[];  // the tile's scan, SPMV_TILE values
  __shared__ float warp_v[K8_THREADS / 32];
  __shared__ int warp_f[K8_THREADS / 32];
  const int64_t tb = (int64_t)blockIdx.x * SPMV_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * K8_PER_THREAD;

  float loc[K8_PER_THREAD];
  int first_head = K8_PER_THREAD;  // index of the thread's first segment start
  int prev_key = p0 > 0 ? (relid[tb + p0 - 1] & (SPMV_TILE - 1)) : -1;
  float acc = Ring<RING>::identity();
#pragma unroll
  for (int e = 0; e < K8_PER_THREAD; ++e) {
    const int p = p0 + e;
    const int r = relid[tb + p];
    const int key = r & (SPMV_TILE - 1);
    const float v = r < SPMV_TILE
        ? prod[tb + route_src(pm1 + tb, pm2 + tb, pm3 + tb, p >> 7, p & 127)]
        : Ring<RING>::identity();
    const bool head = key != prev_key;
    prev_key = key;
    if (head && first_head == K8_PER_THREAD) first_head = e;
    acc = (e == 0 || head) ? v : Ring<RING>::reduce(acc, v);
    loc[e] = acc;
  }
  // (acc, first_head < K8_PER_THREAD) is the thread's aggregate
  float sv = acc;
  bool sf = first_head < K8_PER_THREAD;
  warp_seg_scan<RING>(sv, sf, lane);
  if (lane == 31) {
    warp_v[warp] = sv;
    warp_f[warp] = sf;
  }
  __syncthreads();
  if (warp == 0) {
    float wv = warp_v[lane];
    bool wf = warp_f[lane] != 0;
    warp_seg_scan<RING>(wv, wf, lane);
    warp_v[lane] = wv;
    warp_f[lane] = wf;
  }
  __syncthreads();
  // exclusive prefix of the thread: the warp's lanes before it, joined
  // to the warps before it while no segment start lies between
  const float ev = __shfl_up_sync(0xffffffffu, sv, 1);
  const bool ef = __shfl_up_sync(0xffffffffu, (int)sf, 1) != 0;
  bool has_prefix = false;
  float prefix = Ring<RING>::identity();
  if (lane > 0) {
    has_prefix = true;
    prefix = (ef || warp == 0) ? ev : Ring<RING>::reduce(warp_v[warp - 1], ev);
  } else if (warp > 0) {
    has_prefix = true;
    prefix = warp_v[warp - 1];
  }
  if (has_prefix) {
#pragma unroll
    for (int e = 0; e < K8_PER_THREAD; ++e) {
      if (e < first_head) loc[e] = Ring<RING>::reduce(prefix, loc[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < K8_PER_THREAD; ++e) P[p0 + e] = loc[e];
  __syncthreads();

  for (int i = tid; i < SPMV_TILE; i += K8_THREADS) {
    float o = Ring<RING>::identity();
    if (valid2[tb + i] > 0) {
      o = P[route_src(r2s1 + tb, r2s2 + tb, r2s3 + tb, i >> 7, i & 127)];
    }
    out[tb + i] = o;
  }
}

extern "C" {

int spmv_reduce_roll(const float* x2d, const float* ax, const int8_t* q,
                     const int32_t* xb, const uint8_t* c1, const uint8_t* c2,
                     const uint8_t* c3, const int8_t* rs, float* out,
                     int32_t n_tiles, int32_t Qp, int32_t ring,
                     void* stream) {
  cudaError_t e = cudaSuccess;
#define SPMV_LAUNCH_K7(R)                                                  \
  e = cudaFuncSetAttribute(reduce_roll_kernel<R>,                          \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           (int)K7_SMEM);                                  \
  if (e != cudaSuccess) return (int)e;                                     \
  if (n_tiles > 0)                                                         \
    reduce_roll_kernel<R><<<n_tiles, K7_THREADS, K7_SMEM,                  \
                            (cudaStream_t)stream>>>(x2d, ax, q, xb, c1, c2, \
                                                    c3, rs, out, Qp)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K7)
#undef SPMV_LAUNCH_K7
  return (int)cudaGetLastError();
}

int spmv_scan_roll(const float* prod, const int16_t* relid,
                   const uint8_t* pm1, const uint8_t* pm2, const uint8_t* pm3,
                   const uint8_t* r2s1, const uint8_t* r2s2,
                   const uint8_t* r2s3, const int8_t* valid2, float* out,
                   int32_t F_pad, int32_t ring, void* stream) {
  cudaError_t e = cudaSuccess;
#define SPMV_LAUNCH_K8(R)                                                  \
  e = cudaFuncSetAttribute(scan_roll_kernel<R>,                            \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           (int)K8_SMEM);                                  \
  if (e != cudaSuccess) return (int)e;                                     \
  if (F_pad > 0)                                                           \
    scan_roll_kernel<R><<<F_pad, K8_THREADS, K8_SMEM,                      \
                          (cudaStream_t)stream>>>(                         \
        prod, relid, pm1, pm2, pm3, r2s1, r2s2, r2s3, valid2, out)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K8)
#undef SPMV_LAUNCH_K8
  return (int)cudaGetLastError();
}

}  // extern "C"
