// Direct-tier kernels of the ELL kinds, for Hopper: K9 (planned paged
// gather of x) and K11 (ELL group reduce). Plain C launchers for ctypes;
// see kernels/pgather.py and kernels/ell.py for the wrappers, their plain
// PyTorch versions and the launch counters.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"

// ---------------------------------------------------------------------------
// K9: replaces spmv_tpu/kernels/pgather.py:243 _pgather_pass (pallas_call
// at :258), body _pgather_kernel (:190).
//
// Output position (c, r, col) of chunk c: for each round rr whose route
// marks it live (bit 7 of s3), the route (s3 & 0x7f) names its slot
// (s, l) of tile c*R + rr, and the value is x[qhi*16384 + qlo*128 + s]
// (0 where qhi < 0, an empty slot). Rounds own disjoint positions; a
// position live in no round gets 0.
//
// The TPU kernel sweeps every window of the transposed x table per chunk,
// because a TPU core cannot gather from arbitrary addresses. Here each
// thread reads its one x value straight from natural x, which stays in
// the card's 50 MB L2 for the plans' x sizes, so the window sweep and its
// schedule (pages, pmask) are not needed. Bytes bound it: per position,
// one s3 byte per round, then for the live round two route bytes, the
// slot's qhi (4 B) and qlo (1 B), one x value and one output write; one
// thread per output position, consecutive threads on consecutive
// positions.
// ---------------------------------------------------------------------------
__global__ void pgather_kernel(const float* __restrict__ x, int64_t n_x,
                               const uint8_t* __restrict__ qlo,
                               const int32_t* __restrict__ qhi,
                               const uint8_t* __restrict__ s1,
                               const uint8_t* __restrict__ s2,
                               const uint8_t* __restrict__ s3,
                               float* __restrict__ out, int64_t n_out, int R) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int64_t c = i >> 14;
  const int r = (int)((i >> 7) & 127), col = (int)(i & 127);
  float v = 0.f;
  for (int rr = 0; rr < R; ++rr) {
    const int64_t tb = (c * R + rr) * SPMV_TILE;
    if (s3[tb + r * SPMV_LANES + col] & 0x80) {
      const int src = route_src(s1 + tb, s2 + tb, s3 + tb, r, col, 0x7f);
      const int hi = qhi[tb + src];
      const int64_t e = (int64_t)hi * SPMV_TILE +
                        (int64_t)qlo[tb + src] * SPMV_LANES + (src >> 7);
      v = (hi >= 0 && e < n_x) ? x[e] : 0.f;
    }
  }
  out[i] = v;
}

// ---------------------------------------------------------------------------
// K11: replaces spmv_tpu/kernels/ell.py:184 _ell_spmv_device (pallas_call
// at :205), body _group_reduce_kernel (:138).
//
// One block per (8, 128) tile, one thread per lane. Each 128-lane row
// holds 128/W groups of W lanes; each group is reduced into its first
// lane (the leader) in the reference's order:
//   linear    acc = v[0]; acc = reduce(acc, v[d]) for d = 1 .. W-1;
//   tree      for d = W/2, ..., 1: lane j < d of the group takes
//             reduce(v[j], v[j+d]);
//   broadcast tree, then every lane of the group takes the leader.
// Lanes that take no part keep their value, so every lane equals the
// plain version's. A group of W >= 64 spans warps: the tile is staged in
// shared memory and each tree step ends at a barrier. In a tree step,
// lane j (j < d) reads lane j + d, which no lane writes in that step, so
// one barrier per step is enough. At W = 1 the output is the input.
// Bytes bound it (one read and one write of the product stream); the
// barriers are at most seven per tile.
// ---------------------------------------------------------------------------
#define SPMV_GR_LINEAR 0
#define SPMV_GR_TREE 1
#define SPMV_GR_BROADCAST 2

template <int RING>
__global__ void group_reduce_kernel(const float* __restrict__ prod,
                                    float* __restrict__ out, int W,
                                    int strategy) {
  __shared__ float s[8 * SPMV_LANES];
  const int i = threadIdx.y * SPMV_LANES + threadIdx.x;
  const int64_t at = (int64_t)blockIdx.x * (8 * SPMV_LANES) + i;
  const int g = threadIdx.x & (W - 1);  // lane within its group
  float v = prod[at];
  s[i] = v;
  __syncthreads();
  if (strategy == SPMV_GR_LINEAR) {
    if (g == 0) {
      for (int d = 1; d < W; ++d) v = Ring<RING>::reduce(v, s[i + d]);
    }
  } else {
    for (int d = W >> 1; d >= 1; d >>= 1) {
      if (g < d) {
        v = Ring<RING>::reduce(v, s[i + d]);
        s[i] = v;
      }
      __syncthreads();
    }
    if (strategy == SPMV_GR_BROADCAST) v = s[i - g];
  }
  out[at] = v;
}

extern "C" {

int spmv_pgather(const float* x, int64_t n_x, const uint8_t* qlo,
                 const int32_t* qhi, const uint8_t* s1, const uint8_t* s2,
                 const uint8_t* s3, float* out, int32_t C, int32_t R,
                 void* stream) {
  const int64_t n = (int64_t)C * SPMV_TILE;
  const int threads = 256;
  if (n > 0) {
    pgather_kernel<<<(unsigned)((n + threads - 1) / threads), threads, 0,
                     (cudaStream_t)stream>>>(x, n_x, qlo, qhi, s1, s2, s3,
                                             out, n, R);
  }
  return (int)cudaGetLastError();
}

int spmv_group_reduce(const float* prod, float* out, int32_t n_tiles,
                      int32_t W, int32_t strategy, int32_t ring,
                      void* stream) {
  if (W < 1 || W > SPMV_LANES || (W & (W - 1)) || strategy < 0 ||
      strategy > SPMV_GR_BROADCAST)
    return (int)cudaErrorInvalidValue;
  if (n_tiles > 0) {
#define SPMV_LAUNCH_K11(R)                                                 \
  group_reduce_kernel<R><<<n_tiles, dim3(SPMV_LANES, 8), 0,               \
                           (cudaStream_t)stream>>>(prod, out, W, strategy)
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K11)
#undef SPMV_LAUNCH_K11
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
