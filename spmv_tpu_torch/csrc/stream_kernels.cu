// Stream-SpMV kernels K1 (x prep), K2 (gather + early row reduction,
// plus-times body) and K6 (final-tile scan, prefix differences) for
// Hopper. Plain C launchers for ctypes; see kernels/stream.py for the
// wrappers, their plain PyTorch versions and the launch counters.
//
// All three move bytes and do next to no arithmetic, so bytes bound
// them on the card. On the bench plan (power_law_csr(1<<20, 1<<20,
// 3.3M, seed 42)), audit_plan counts 13 MB for K1, 35 MB for K2 and
// 23.6 MB for K6 per call. This first version is simple and right:
// route stages and values are read straight from global memory (each
// block's working set is one tile's stages, which stay in L1/L2), and
// only what a block must share (K2's row prefixes, K6's tile prefix)
// goes through shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "route3.cuh"

// ---------------------------------------------------------------------------
// K1: replaces spmv_tpu/kernels/stream.py:1348 _xprep_pass (pallas_call
// at :1377). For each x window w: the 128 natural x rows starting at row
// g0[w], routed by (xr1, xr2, xr3)[w] into the lane-remapped, transposed
// x table. One block per window, one thread per output element (strided);
// reads of x hit L2 (the natural x of the bench matrix is 4 MB).
// ---------------------------------------------------------------------------
__global__ void xprep_kernel(const float* __restrict__ xnat,
                             const int32_t* __restrict__ g0,
                             const uint8_t* __restrict__ r1,
                             const uint8_t* __restrict__ r2,
                             const uint8_t* __restrict__ r3,
                             float* __restrict__ out) {
  const int64_t w = blockIdx.x;
  const int64_t tb = w * SPMV_TILE;
  const float* xw = xnat + (int64_t)g0[w] * SPMV_LANES;
  for (int i = threadIdx.x; i < SPMV_TILE; i += blockDim.x) {
    const int src = route_src(r1 + tb, r2 + tb, r3 + tb, i >> 7, i & 127);
    out[tb + i] = xw[src];
  }
}

// ---------------------------------------------------------------------------
// K2: replaces spmv_tpu/kernels/stream.py:1309 _reduce_pass (pallas_call
// at :1337), plus-times body of _reduce_kernel (:1277-1300). One block
// per gather tile t:
//   1. products Ax * x2d[xb[t]*128 + s, q] (0 where q < 0; q is clamped
//      before it indexes), or the or-and counting combine;
//   2. an inclusive scan along each 128-lane row (one thread per row,
//      in order, in shared memory);
//   3. route (c1, c2, c3 & 127) of the prefixes into the C half;
//   4. part[i] = C[i] - (c3[i] bit 7 ? 0 : C[i-1]) in flat order. Flat
//      index 0 has no predecessor in the tile and takes 0: in a tile
//      that holds nnz it is always a sublane-first run (bit 7 set);
//   5. rows [t*Qp, (t+1)*Qp) of the output get the first Qp rows.
// The x window is read from global memory: the whole x table of the
// bench plan is 4.7 MB against the card's 50 MB of L2.
// ---------------------------------------------------------------------------
#define K2_PITCH (SPMV_LANES + 1)  // padded row: conflict-free row scans
#define K2_SMEM (SPMV_LANES * K2_PITCH * sizeof(float))

__global__ void reduce_kernel(const float* __restrict__ x2d,
                              const float* __restrict__ ax,
                              const int8_t* __restrict__ q,
                              const int32_t* __restrict__ xb,
                              const uint8_t* __restrict__ c1,
                              const uint8_t* __restrict__ c2,
                              const uint8_t* __restrict__ c3,
                              float* __restrict__ out, int Qp,
                              int or_and) {
  extern __shared__ float S[];  // 128 rows x K2_PITCH
  const int64_t t = blockIdx.x;
  const int64_t tb = t * SPMV_TILE;
  const float* xw = x2d + (int64_t)xb[t] * SPMV_TILE;
  for (int i = threadIdx.x; i < SPMV_TILE; i += blockDim.x) {
    const int qv = q[tb + i];
    const int s = i >> 7;
    const float xv = xw[s * SPMV_LANES + (qv < 0 ? 0 : qv)];
    const float a = ax[tb + i];
    float p = or_and ? ((a != 0.f && xv != 0.f) ? 1.f : 0.f) : a * xv;
    S[s * K2_PITCH + (i & 127)] = qv >= 0 ? p : 0.f;
  }
  __syncthreads();
  if (threadIdx.x < SPMV_LANES) {
    float* row = S + threadIdx.x * K2_PITCH;
    float acc = 0.f;
    for (int l = 0; l < SPMV_LANES; ++l) {
      acc += row[l];
      row[l] = acc;
    }
  }
  __syncthreads();
  const uint8_t* a1 = c1 + tb;
  const uint8_t* a2 = c2 + tb;
  const uint8_t* a3 = c3 + tb;
  float* o = out + t * Qp * SPMV_LANES;
  for (int i = threadIdx.x; i < Qp * SPMV_LANES; i += blockDim.x) {
    const int src = route_src(a1, a2, a3, i >> 7, i & 127, 127);
    const float C = S[(src >> 7) * K2_PITCH + (src & 127)];
    float prev = 0.f;
    if (!(a3[i] >> 7) && i > 0) {
      const int ps = route_src(a1, a2, a3, (i - 1) >> 7, (i - 1) & 127, 127);
      prev = S[(ps >> 7) * K2_PITCH + (ps & 127)];
    }
    o[i] = C - prev;
  }
}

// ---------------------------------------------------------------------------
// K6: replaces spmv_tpu/kernels/stream.py:1598 _scan_pass (pallas_call at
// :1633), body _scan_kernel_diff (:1467). One block of 1024 threads per
// final tile f:
//   1. route the products by (pm1, pm2, pm3) into exact rank order;
//   2. keep positions 1..counts[f] (position 0 is the zero prefix);
//   3. a block-wide inclusive scan of the 16384 values: each thread
//      scans 16 consecutive positions in registers, warp shuffles scan
//      the thread totals, shared memory carries the warp totals;
//   4. route the scan by (r2s*) for each row's END and by (q2s*) for
//      its PREV prefix;
//   5. write ends - prevs where valid2, else 0.
// The scan accumulates in double: a row's total is the difference of
// two prefixes of up to 16K values, and in float the rounding of those
// large prefixes swamps small rows. With a float scan, 24 rows of the
// bench matrix and 82 of the wide-row matrix (single nonzeros near 5e-3,
// off by 1%) fall outside the oracle's rtol 2e-4 / atol 1e-5 on an H100
// 80GB HBM3 at 700 W; with double, none do. The 16384 prefixes (128 KB
// of doubles) live in dynamic shared memory: one block per SM.
// ---------------------------------------------------------------------------
#define K6_THREADS 1024
#define K6_PER_THREAD (SPMV_TILE / K6_THREADS)
#define K6_SMEM (SPMV_TILE * sizeof(double))

__global__ void __launch_bounds__(K6_THREADS)
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
  extern __shared__ double P[];  // SPMV_TILE inclusive prefixes
  __shared__ double warp_tot[K6_THREADS / 32];
  const int64_t tb = (int64_t)blockIdx.x * SPMV_TILE;
  const int m = counts[blockIdx.x];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = tid * K6_PER_THREAD;

  double loc[K6_PER_THREAD];
  double acc = 0.0;
#pragma unroll
  for (int e = 0; e < K6_PER_THREAD; ++e) {
    const int p = p0 + e;
    double v = 0.0;
    if (p >= 1 && p <= m) {
      v = prod[tb + route_src(pm1 + tb, pm2 + tb, pm3 + tb, p >> 7, p & 127)];
    }
    acc += v;
    loc[e] = acc;
  }
  double incl = acc;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += n;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
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
  const double off = (incl - acc) + (warp > 0 ? warp_tot[warp - 1] : 0.0);
#pragma unroll
  for (int e = 0; e < K6_PER_THREAD; ++e) P[p0 + e] = loc[e] + off;
  __syncthreads();

  for (int i = tid; i < SPMV_TILE; i += K6_THREADS) {
    float o = 0.f;
    if (valid2[tb + i] > 0) {
      const int r = i >> 7, c = i & 127;
      const int e = route_src(r2s1 + tb, r2s2 + tb, r2s3 + tb, r, c);
      const int pv = route_src(q2s1 + tb, q2s2 + tb, q2s3 + tb, r, c);
      o = (float)(P[e] - P[pv]);
    }
    out[tb + i] = o;
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
  if (n_w > 0) {
    xprep_kernel<<<n_w, 256, 0, (cudaStream_t)stream>>>(xnat, g0, r1, r2, r3,
                                                        out);
  }
  return (int)cudaGetLastError();
}

int spmv_reduce(const float* x2d, const float* ax, const int8_t* q,
                const int32_t* xb, const uint8_t* c1, const uint8_t* c2,
                const uint8_t* c3, float* out, int32_t n_tiles, int32_t Qp,
                int32_t or_and, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K2_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (n_tiles > 0) {
    reduce_kernel<<<n_tiles, 256, K2_SMEM, (cudaStream_t)stream>>>(
        x2d, ax, q, xb, c1, c2, c3, out, Qp, or_and);
  }
  return (int)cudaGetLastError();
}

int spmv_scan_diff(const float* prod, const uint8_t* pm1, const uint8_t* pm2,
                   const uint8_t* pm3, const uint8_t* r2s1,
                   const uint8_t* r2s2, const uint8_t* r2s3,
                   const uint8_t* q2s1, const uint8_t* q2s2,
                   const uint8_t* q2s3, const int8_t* valid2,
                   const int32_t* counts, float* out, int32_t F_pad,
                   void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      scan_diff_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)K6_SMEM);
  if (e != cudaSuccess) return (int)e;
  if (F_pad > 0) {
    scan_diff_kernel<<<F_pad, K6_THREADS, K6_SMEM, (cudaStream_t)stream>>>(
        prod, pm1, pm2, pm3, r2s1, r2s2, r2s3, q2s1, q2s2, q2s3, valid2,
        counts, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
