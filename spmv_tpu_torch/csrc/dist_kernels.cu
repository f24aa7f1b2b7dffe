// K11': the per-shard ELL product and group reduce of the multi-device
// layer, for Hopper. Plain C launcher for ctypes; see
// parallel/dist_spmv.py (_local_ell_pass) for the wrapper, its plain
// PyTorch version and the launch counter.
//
// Replaces spmv_tpu/parallel/dist_spmv.py:179 _local_ell_matvec
// (pallas_call at :194), whose body is the ELL `tree` group reduce of
// spmv_tpu/kernels/ell.py:_group_reduce_kernel.
//
// The reference gathers x[aj] in XLA, combines, masks with `valid` and
// only then calls its kernel, because a TPU core cannot gather from
// arbitrary addresses. Here one kernel does all of it. One block per
// (8, 128) tile of one shard's stacked block (tile b of the launch is
// tile b % Tv of shard b / Tv), one thread per slot:
//   v = valid ? combine(ax, xsrc[shard * x_stride + aj]) : identity;
// then each W-lane group of a 128-lane row is reduced into its leader
// in the reference's `tree` order (d = W/2, ..., 1: lane j < d takes
// reduce(v[j], v[j+d]), as direct_kernels.cu's K11), and the leader is
// written compactly: out[shard, (t*8 + row)*(128/W) + lane/W], the order
// of the reference's reduced[:, ::W].reshape(-1). combine and reduce are
// the round-to-nearest intrinsics of ring.cuh, so nvcc contracts no
// product into a fused multiply-add and the kernel gives the plain
// version's bits in every built-in ring.
//
// Bytes bound it: per slot aj (4 B), ax (4 B), valid (1 B) and, where
// valid, one x value (4 B, from L2 for the tables the layer builds);
// 4/W B written. The tree steps stage the tile in shared memory, one
// barrier per step (at most seven).

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"  // SPMV_LANES

template <int RING>
__global__ void local_ell_kernel(const int32_t* __restrict__ aj,
                                 const float* __restrict__ ax,
                                 const uint8_t* __restrict__ valid,
                                 const float* __restrict__ xsrc,
                                 int64_t x_stride, float* __restrict__ out,
                                 int Tv, int W) {
  __shared__ float s[8 * SPMV_LANES];
  const int i = threadIdx.y * SPMV_LANES + threadIdx.x;
  const int64_t b = blockIdx.x;
  const int64_t shard = b / Tv;
  const int64_t at = b * (8 * SPMV_LANES) + i;
  float v = Ring<RING>::identity();
  if (valid[at]) v = Ring<RING>::combine(ax[at], xsrc[shard * x_stride + aj[at]]);
  s[i] = v;
  __syncthreads();
  const int g = threadIdx.x & (W - 1);  // lane within its group
  for (int d = W >> 1; d >= 1; d >>= 1) {
    if (g < d) {
      v = Ring<RING>::reduce(v, s[i + d]);
      s[i] = v;
    }
    __syncthreads();
  }
  if (g == 0) {
    const int per_row = SPMV_LANES / W;
    const int64_t t = b - shard * Tv;
    out[shard * ((int64_t)Tv * 8 * per_row) + (t * 8 + threadIdx.y) * per_row +
        threadIdx.x / W] = v;
  }
}

extern "C" {

int spmv_local_ell(const int32_t* aj, const float* ax, const uint8_t* valid,
                   const float* xsrc, int64_t x_stride, float* out,
                   int32_t n_local, int32_t Tv, int32_t W, int32_t ring,
                   void* stream) {
  if (W < 1 || W > SPMV_LANES || (W & (W - 1)) || n_local < 0 || Tv < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n_tiles = (int64_t)n_local * Tv;
  if (n_tiles > 0) {
#define SPMV_LAUNCH_K11P(R)                                                   \
  local_ell_kernel<R><<<(unsigned)n_tiles, dim3(SPMV_LANES, 8), 0,            \
                        (cudaStream_t)stream>>>(aj, ax, valid, xsrc, x_stride, \
                                                out, Tv, W)
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K11P)
#undef SPMV_LAUNCH_K11P
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
