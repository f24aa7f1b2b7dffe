// Gather kernels of the stream pipeline's no-reduction branch, for
// Hopper: K4 (gather + products in gather order) and K3 (the same
// products routed straight into shuffle pass 1's quota windows). Each
// is instantiated per built-in ring (ring.cuh). Plain C launchers for
// ctypes; see kernels/stream.py for the wrappers, their plain PyTorch
// versions and the launch counters.
//
// Both move bytes and do one combine per slot, so bytes bound them. A
// gather slot reads its value (4 B), its lane index q (1 B) and one x
// value; K3 also reads three route bytes per output element. This first
// version is simple and right: one thread per output element, every
// read from global memory (x tables of the planner's sizes stay in the
// card's 50 MB of L2), no shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"

// The product of gather slot i (flat over the (n_tiles*128, 128) gather
// stream): combine(Ax, x2d[xb[t]*128 + s, q]) with t = i / 16384 and s
// its sublane, or the ring's identity where q < 0 (a junk slot).
template <int RING>
__device__ __forceinline__ float gather_product(const float* __restrict__ x2d,
                                                const float* __restrict__ ax,
                                                const int8_t* __restrict__ q,
                                                const int32_t* __restrict__ xb,
                                                int64_t i) {
  const int qv = q[i];
  if (qv < 0) return Ring<RING>::identity();
  const int64_t t = i >> 14;
  const int s = (int)((i >> 7) & 127);
  return Ring<RING>::combine(
      ax[i], x2d[(int64_t)xb[t] * SPMV_TILE + s * SPMV_LANES + qv]);
}

// ---------------------------------------------------------------------------
// K4: replaces spmv_tpu/kernels/stream.py:1572 _gather_pass (pallas_call
// at :1586), body _gather_kernel (:1137). One thread per gather slot.
// The reference reads its x window from a VMEM-resident table or by a
// per-tile DMA; here the one global read hits L2.
// ---------------------------------------------------------------------------
template <int RING>
__global__ void gather_kernel(const float* __restrict__ x2d,
                              const float* __restrict__ ax,
                              const int8_t* __restrict__ q,
                              const int32_t* __restrict__ xb,
                              float* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = gather_product<RING>(x2d, ax, q, xb, i);
}

// ---------------------------------------------------------------------------
// K3: replaces spmv_tpu/kernels/stream.py:1195 _gather_split_pass
// (pallas_call at :1218), body _gather_split_kernel (:1156): the gather
// fused with shuffle pass 1. K5's structure (shuffle_kernels.cu), one
// block per (step t, tile j): output element (k, r, c) of the tile's
// window for group k finds its row R = j*128 + starts[t, j*K + k] + r of
// the step's stacked routed block (the starts row of step t, as the
// reference's (t // 8, 0) block at row t % 8), its gather slot through
// the pass-1 route, and forms that slot's product there. Neither the
// products nor the routed tiles are written out. The window lands at
// rows pos[t]*sbt*Q + j*Q ... of group k (the reference's (K, sbt*Q,
// 128) output block pos[t]). Rows no window covers are filled with the
// ring's identity by the wrapper.
// ---------------------------------------------------------------------------
template <int RING>
__global__ void gather_split_kernel(const float* __restrict__ x2d,
                                    const float* __restrict__ ax,
                                    const int8_t* __restrict__ q,
                                    const int32_t* __restrict__ xb,
                                    const uint8_t* __restrict__ s1,
                                    const uint8_t* __restrict__ s2,
                                    const uint8_t* __restrict__ s3,
                                    const int32_t* __restrict__ starts,
                                    int starts_w,
                                    const int32_t* __restrict__ pos,
                                    float* __restrict__ out, int sbt, int K,
                                    int Q, int64_t rows_per_g) {
  const int t = blockIdx.x, j = blockIdx.y;
  const int64_t tile0 = (int64_t)t * sbt;
  const int64_t out_row0 = (int64_t)pos[t] * sbt * Q + (int64_t)j * Q;
  const int per_group = Q * SPMV_LANES;
  for (int i = threadIdx.x; i < K * per_group; i += blockDim.x) {
    const int k = i / per_group;
    const int rem = i - k * per_group;
    const int r = rem >> 7, c = rem & 127;
    const int R = j * SPMV_LANES + starts[(int64_t)t * starts_w + j * K + k] + r;
    const int64_t tb = (tile0 + (R >> 7)) * SPMV_TILE;
    const int src = route_src(s1 + tb, s2 + tb, s3 + tb, R & 127, c);
    out[((int64_t)k * rows_per_g + out_row0 + r) * SPMV_LANES + c] =
        gather_product<RING>(x2d, ax, q, xb, tb + src);
  }
}

extern "C" {

int spmv_gather(const float* x2d, const float* ax, const int8_t* q,
                const int32_t* xb, float* out, int32_t n_tiles, int32_t ring,
                void* stream) {
  const int64_t n = (int64_t)n_tiles * SPMV_TILE;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (n > 0) {
#define SPMV_LAUNCH_K4(R)                                                    \
  gather_kernel<R><<<blocks, threads, 0, (cudaStream_t)stream>>>(x2d, ax, q, \
                                                                 xb, out, n)
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K4)
#undef SPMV_LAUNCH_K4
  }
  return (int)cudaGetLastError();
}

int spmv_gather_split(const float* x2d, const float* ax, const int8_t* q,
                      const int32_t* xb, const uint8_t* s1, const uint8_t* s2,
                      const uint8_t* s3, const int32_t* starts,
                      int32_t starts_w, const int32_t* pos, float* out,
                      int32_t n_steps, int32_t sbt, int32_t K, int32_t Q,
                      int64_t rows_per_g, int32_t ring, void* stream) {
  if (n_steps > 0) {
#define SPMV_LAUNCH_K3(R)                                                   \
  gather_split_kernel<R><<<dim3(n_steps, sbt), 256, 0,                      \
                           (cudaStream_t)stream>>>(                         \
      x2d, ax, q, xb, s1, s2, s3, starts, starts_w, pos, out, sbt, K, Q,   \
      rows_per_g)
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K3)
#undef SPMV_LAUNCH_K3
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
