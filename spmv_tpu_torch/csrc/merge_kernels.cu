// K10, the kernel of `merge_tiled`, for Hopper. Plain C launcher for
// ctypes; see kernels/merge.py for the wrapper `_merge_group_pass`, its
// plain PyTorch version and the launch counter.
//
// Replaces spmv_tpu/kernels/merge.py:438 _merge_spmv_device (pallas_call
// at :478), body _merge_group_kernel (:359).
//
// A group is sbt = 128/S tiles of EN = S*128 products: a (128, 128)
// block of products and of row ids (`rel`, non-decreasing within a
// tile). Per group, the TPU kernel runs one segmented scan of the block,
// routes each tile's row-end values into the tile's y window, and then
// walks the carry chain tile by tile in an SMEM register, which works
// there because its grid runs in order on one core. Blocks on Hopper run
// in no order, so the work is split in two launches:
//
// Pass 1, merge_group_kernel, one block of 1024 threads per group:
//   - the group's products and row ids (offset by tile*RW, so that runs
//     never link across tiles) are staged in 128 KB of dynamic shared
//     memory;
//   - the inclusive segmented scan takes the Hillis-Steele steps of the
//     plain version (kernels/tile_ops.py segmented_scan_tile), element i
//     taking reduce(v[i], v[i-d]) where its id equals that of i-d; steps
//     d >= EN link nothing, so they are skipped. Same steps, same
//     operands: plus-times gives the plain version's bits;
//   - the planned 3-stage route (route3.cuh, liveness in bit 7 of pr3)
//     writes the group's sbt*P rows of y windows, the identity where not
//     live;
//   - each tile's last-row value (the scan at cnt-1; the reference's
//     masked reduction, reduce(identity, .), where the route has no spare
//     row for it) goes to a (T,) scratch array.
// Pass 2, merge_carry_kernel, one block: the chain is staged in shared
//   memory chunk by chunk, one thread walks it in tile order exactly as
//   merge.py:394-423 (fold where carry_row == r_start, a tile of one row
//   continuing the carry merges its value, empty tiles pass it on), and
//   the block then folds each carry into its tile's first window element.
//   The reference's order is kept, so plus-times stays exact.
//
// Bound: bytes. Pass 1 reads the products, the row ids and the three
// route stages and writes the y windows once (64 MB on the bench
// matrix's tuned plan); its scan is log2(EN) shared-memory steps per
// element. Pass 2 is a serial walk of T tiles: a few shared-memory loads
// and selects per tile, latency-bound, on one SM.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"

#define K10_THREADS 1024
#define K10_PER_THREAD (SPMV_TILE / K10_THREADS)
#define K10_CHAIN_CHUNK 2048

template <int RING>
__global__ void __launch_bounds__(K10_THREADS)
    merge_group_kernel(const float* __restrict__ prod,
                       const int32_t* __restrict__ rel,
                       const uint8_t* __restrict__ p1,
                       const uint8_t* __restrict__ p2,
                       const uint8_t* __restrict__ p3,
                       const int32_t* __restrict__ cnt,
                       float* __restrict__ raw, float* __restrict__ y, int S,
                       int P) {
  extern __shared__ float smem[];
  float* sv = smem;                                      // scan values
  int32_t* ss = reinterpret_cast<int32_t*>(smem + SPMV_TILE);  // segment ids
  const int tid = threadIdx.x;
  const int EN = S * SPMV_LANES, RW = P * SPMV_LANES, sbt = SPMV_LANES / S;
  const int64_t base = (int64_t)blockIdx.x * SPMV_TILE;
  float v[K10_PER_THREAD];
#pragma unroll
  for (int k = 0; k < K10_PER_THREAD; ++k) {
    const int i = k * K10_THREADS + tid;
    v[k] = prod[base + i];
    sv[i] = v[k];
    ss[i] = rel[base + i] + (i / EN) * RW;
  }
  __syncthreads();
  for (int d = 1; d < EN; d <<= 1) {
#pragma unroll
    for (int k = 0; k < K10_PER_THREAD; ++k) {
      const int i = k * K10_THREADS + tid;
      if (i >= d && ss[i - d] == ss[i]) v[k] = Ring<RING>::reduce(v[k], sv[i - d]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < K10_PER_THREAD; ++k) sv[k * K10_THREADS + tid] = v[k];
    __syncthreads();
  }

  const uint8_t* q1 = p1 + base;
  const uint8_t* q2 = p2 + base;
  const uint8_t* q3 = p3 + base;
  const int n_out = sbt * P * SPMV_LANES;
  float* yg = y + (int64_t)blockIdx.x * n_out;
  for (int o = tid; o < n_out; o += K10_THREADS) {
    float val = Ring<RING>::identity();
    if (q3[o] & 0x80) val = sv[route_src(q1, q2, q3, o >> 7, o & 127, 0x7f)];
    yg[o] = val;
  }
  if (tid < sbt) {
    const int t = blockIdx.x * sbt + tid;
    const int c = cnt[t];
    float rv = Ring<RING>::identity();
    if (c > 0) {
      rv = sv[tid * EN + c - 1];
      if (sbt * P + sbt > SPMV_LANES) rv = Ring<RING>::reduce(Ring<RING>::identity(), rv);
    }
    raw[t] = rv;
  }
}

template <int RING>
__global__ void __launch_bounds__(K10_THREADS)
    merge_carry_kernel(const int32_t* __restrict__ r_start,
                       const int32_t* __restrict__ lrow,
                       const int32_t* __restrict__ cnt,
                       const float* __restrict__ raw, float* __restrict__ y,
                       int T, int RW) {
  __shared__ int32_t s_rs[K10_CHAIN_CHUNK];
  __shared__ int32_t s_lr[K10_CHAIN_CHUNK];
  __shared__ int32_t s_cnt[K10_CHAIN_CHUNK];  // then: fold flag
  __shared__ float s_raw[K10_CHAIN_CHUNK];    // then: carry in
  int carry_row = -1;  // thread 0's chain state, across chunks
  float carry_val = Ring<RING>::identity();
  for (int t0 = 0; t0 < T; t0 += K10_CHAIN_CHUNK) {
    const int n = min(K10_CHAIN_CHUNK, T - t0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      s_rs[i] = r_start[t0 + i];
      s_lr[i] = lrow[t0 + i];
      s_cnt[i] = cnt[t0 + i];
      s_raw[i] = raw[t0 + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int r0 = s_rs[i], lr = s_lr[i], c = s_cnt[i];
        const float rv = s_raw[i];
        const bool fold = carry_row == r0;
        s_cnt[i] = fold;
        s_raw[i] = carry_val;
        if (c > 0) {
          carry_val = (fold && lr == r0) ? Ring<RING>::reduce(carry_val, rv) : rv;
          carry_row = lr;
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (s_cnt[i]) {
        float* f = y + (int64_t)(t0 + i) * RW;
        *f = Ring<RING>::reduce(s_raw[i], *f);
      }
    }
    __syncthreads();
  }
}

extern "C" {

int spmv_merge_group(const float* prod, const int32_t* rel, const uint8_t* p1,
                     const uint8_t* p2, const uint8_t* p3,
                     const int32_t* r_start, const int32_t* lrow,
                     const int32_t* cnt, float* raw, float* y, int32_t T,
                     int32_t S, int32_t P, int32_t ring, void* stream) {
  if (S < 1 || S > SPMV_LANES || SPMV_LANES % S || P < 1 ||
      (SPMV_LANES / S) * P > SPMV_LANES || T < 0 || T % (SPMV_LANES / S))
    return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const int groups = T / (SPMV_LANES / S);
  const int smem = 2 * SPMV_TILE * (int)sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
#define SPMV_LAUNCH_K10(R)                                                    \
  {                                                                           \
    cudaError_t e = cudaFuncSetAttribute(                                     \
        merge_group_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
        smem);                                                                \
    if (e != cudaSuccess) return (int)e;                                      \
    merge_group_kernel<R><<<groups, K10_THREADS, smem, st>>>(                 \
        prod, rel, p1, p2, p3, cnt, raw, y, S, P);                            \
    merge_carry_kernel<R><<<1, K10_THREADS, 0, st>>>(r_start, lrow, cnt, raw, \
                                                     y, T, P * SPMV_LANES);   \
  }
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K10)
#undef SPMV_LAUNCH_K10
  return (int)cudaGetLastError();
}

}  // extern "C"
