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
// position. K7 is the first version, simple and right: its scan runs in
// registers and warp shuffles, its result goes through shared memory
// once, and every route byte and value is read from global memory. K8
// stages its tile and routes in shared memory (below).

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
// :1633), body _scan_kernel_roll (:1503), picked at :1610-1611. Per final
// tile f:
//   1. route the products by (pm1, pm2, pm3) into exact rank order;
//   2. the ring's identity where relid >= 16384 (position 0 and the
//      tail are junk);
//   3. an inclusive segmented scan of the tile's 16384 values in
//      row-major order keyed by relid & 16383: a segment starts where
//      the key differs from the previous position's. The reference
//      offsets keys per tile only so that its batched scan never links
//      two tiles; one block per tile needs no offset;
//   4. the END route (r2s1-3) of the scan, and the identity where
//      valid2 == 0.
// For plus-times ("roll") the sums are float32, as the reference's; the
// segments restart per row, so no long prefix is differenced.
//
// What bounds it: bytes, 98 MB on the sssp graph's 352 tiles (products,
// relid, six route stages and valid2 read once, the y windows written).
// The first design, 1024 threads of 16 positions, one CTA per SM, followed
// both routes through device memory: four dependent L2 trips per position
// (pm3, pm2, pm1, the product) and three more per output, with relid and
// pm3 read one strided element at a time, and no second CTA to hide one
// tile's loads behind another's.
//
// The design, one CTA of K8_THREADS per tile, two per SM (104.5 KB of
// shared memory each):
//   (a) pm1 and pm2 (route_stage_async, s2's rows padded to 132 bytes) and
//       the tile's 16384 products (64 KB, 16-byte cp.async) go to shared
//       memory; meanwhile each thread loads the relid and pm3 of its 32
//       consecutive positions, a quarter of one row, as 16-byte vectors,
//       the only device reads of the phase;
//   (b) each thread follows the exact-rank route in shared memory and
//       scans its positions in registers; warp_seg_scan scans the
//       threads' (value, flag) aggregates, warp 0 the warps', and each
//       thread folds its exclusive prefix into its values before its
//       first segment start;
//   (c) once every product is in registers the 64 KB buffer takes the
//       scan P, and the END route's r2s1/r2s2 copies start into the
//       pm1/pm2 buffers as the block scan runs. P keeps 16 bytes after
//       each thread's 32 values, so the float4 stores of 8 lanes that
//       start 144 bytes apart fall in distinct banks;
//   (d) a warp takes one output row at a time, each lane 4 consecutive
//       columns: r2s3 as a uchar4 and valid2 as a char4, all 8 rows'
//       loaded before the staging wait, one float4 written.
// Nothing fills bench's 80-tile launch: 80 CTAs run on 80 of the 132 SMs.
// Splitting one tile's scan over two CTAs would carry the scan across
// them (a second pass, or a cluster's shared memory).
// ---------------------------------------------------------------------------
#define K8_THREADS 512
#define K8_WARPS (K8_THREADS / 32)
#define K8_PER_THREAD (SPMV_TILE / K8_THREADS)  // 32, a quarter of a row
#define K8_PAD(p) ((p) + (((p) >> 5) << 2))      // P's index of position p
#define K8_S1_OFF (K8_PAD(SPMV_TILE) * (int)sizeof(float))
#define K8_S2_OFF (K8_S1_OFF + SPMV_TILE)
#define K8_SMEM (K8_S2_OFF + SPMV_S2_STAGED)
#define K8_ROWS (SPMV_LANES / K8_WARPS)  // output rows per warp

template <int RING>
__global__ void __launch_bounds__(K8_THREADS, 2)
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
  extern __shared__ __align__(16) unsigned char k8_smem[];
  float* buf = reinterpret_cast<float*>(k8_smem);  // products, then P
  uint8_t* st1 = k8_smem + K8_S1_OFF;
  uint8_t* st2 = k8_smem + K8_S2_OFF;
  __shared__ float warp_v[K8_WARPS];
  __shared__ int warp_f[K8_WARPS];
  const int64_t tb = (int64_t)blockIdx.x * SPMV_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * K8_PER_THREAD;
  const int row = p0 >> 7;  // the row that holds all of the thread's positions
  const float ident = Ring<RING>::identity();

  // (a) pm1, pm2 and the products staged; relid (16 words of two ids)
  // and pm3 (8 words of four bytes) of the thread's positions loaded
  route_stage_async(st1, st2, pm1, pm2, tb, tid, K8_THREADS);
  tile_copy_async(buf, prod + tb, tid, K8_THREADS);
  uint32_t rw[K8_PER_THREAD / 2], kw[K8_PER_THREAD / 4];
#pragma unroll
  for (int i = 0; i < K8_PER_THREAD / 8; ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(relid + tb + p0) + i);
    rw[4 * i] = u.x, rw[4 * i + 1] = u.y, rw[4 * i + 2] = u.z, rw[4 * i + 3] = u.w;
  }
#pragma unroll
  for (int i = 0; i < K8_PER_THREAD / 16; ++i) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(pm3 + tb + p0) + i);
    kw[4 * i] = u.x, kw[4 * i + 1] = u.y, kw[4 * i + 2] = u.z, kw[4 * i + 3] = u.w;
  }
  int prev_key = p0 > 0 ? (__ldg(relid + tb + p0 - 1) & (SPMV_TILE - 1)) : -1;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // (b) the thread's own segmented scan; (acc, first_head < K8_PER_THREAD)
  // is its aggregate
  float loc[K8_PER_THREAD];
  int first_head = K8_PER_THREAD;  // index of the thread's first segment start
  float acc = ident;
#pragma unroll
  for (int e = 0; e < K8_PER_THREAD; ++e) {
    const int r = (rw[e >> 1] >> (16 * (e & 1))) & 0xffff;
    const int k = (kw[e >> 2] >> (8 * (e & 3))) & 0xff;
    const int key = r & (SPMV_TILE - 1);
    const float v = r < SPMV_TILE ? buf[route_src_staged(st1, st2, k, row)] : ident;
    const bool head = key != prev_key;
    prev_key = key;
    if (head && first_head == K8_PER_THREAD) first_head = e;
    acc = (e == 0 || head) ? v : Ring<RING>::reduce(acc, v);
    loc[e] = acc;
  }
  float sv = acc;
  bool sf = first_head < K8_PER_THREAD;
  warp_seg_scan<RING>(sv, sf, lane);
  if (lane == 31) {
    warp_v[warp] = sv;
    warp_f[warp] = sf;
  }
  __syncthreads();  // every product and pm1/pm2 byte has been read
  // (c) the END route's first two stages into the freed buffers
  route_stage_async(st1, st2, r2s1, r2s2, tb, tid, K8_THREADS);
  if (warp == 0) {
    float wv = lane < K8_WARPS ? warp_v[lane] : ident;
    bool wf = lane < K8_WARPS && warp_f[lane] != 0;
    warp_seg_scan<RING>(wv, wf, lane);
    if (lane < K8_WARPS) {
      warp_v[lane] = wv;
      warp_f[lane] = wf;
    }
  }
  __syncthreads();
  // exclusive prefix of the thread: the warp's lanes before it, joined
  // to the warps before it while no segment start lies between
  const float ev = __shfl_up_sync(0xffffffffu, sv, 1);
  const bool ef = __shfl_up_sync(0xffffffffu, (int)sf, 1) != 0;
  bool has_prefix = false;
  float prefix = ident;
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
  float4* pt = reinterpret_cast<float4*>(buf + K8_PAD(p0));
#pragma unroll
  for (int i = 0; i < K8_PER_THREAD / 4; ++i)
    pt[i] = make_float4(loc[4 * i], loc[4 * i + 1], loc[4 * i + 2], loc[4 * i + 3]);

  // (d) the END route of the scan, rows warp + u * K8_WARPS
  uchar4 b[K8_ROWS];
  char4 ok[K8_ROWS];
#pragma unroll
  for (int u = 0; u < K8_ROWS; ++u) {
    const int64_t o = tb + (int64_t)(warp + u * K8_WARPS) * SPMV_LANES;
    b[u] = __ldcs(reinterpret_cast<const uchar4*>(r2s3 + o) + lane);
    ok[u] = __ldcs(reinterpret_cast<const char4*>(valid2 + o) + lane);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // P and the END route's stages are in place
#pragma unroll
  for (int u = 0; u < K8_ROWS; ++u) {
    const int r = warp + u * K8_WARPS;
    const float4 o = make_float4(
        ok[u].x > 0 ? buf[K8_PAD(route_src_staged(st1, st2, b[u].x, r))] : ident,
        ok[u].y > 0 ? buf[K8_PAD(route_src_staged(st1, st2, b[u].y, r))] : ident,
        ok[u].z > 0 ? buf[K8_PAD(route_src_staged(st1, st2, b[u].z, r))] : ident,
        ok[u].w > 0 ? buf[K8_PAD(route_src_staged(st1, st2, b[u].w, r))] : ident);
    reinterpret_cast<float4*>(out + tb + (int64_t)r * SPMV_LANES)[lane] = o;
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
  // the 16-byte vector reads and writes, and the 16-byte cp.async copies
  if ((((uintptr_t)prod | (uintptr_t)relid | (uintptr_t)pm1 | (uintptr_t)pm3 |
        (uintptr_t)r2s1 | (uintptr_t)r2s3 | (uintptr_t)valid2 | (uintptr_t)out) &
       15) != 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define SPMV_LAUNCH_K8(R)                                                  \
  e = cudaFuncSetAttribute(scan_roll_kernel<R>,                            \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,    \
                           (int)K8_SMEM);                                  \
  if (e != cudaSuccess) return (int)e;                                     \
  e = cudaFuncSetAttribute(scan_roll_kernel<R>,                            \
                           cudaFuncAttributePreferredSharedMemoryCarveout, \
                           (int)cudaSharedmemCarveoutMaxShared);           \
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
