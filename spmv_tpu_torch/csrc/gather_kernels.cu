// Gather kernels of the stream pipeline's no-reduction branch, for
// Hopper: K4 (gather + products in gather order) and K3 (the same
// products routed straight into shuffle pass 1's quota windows). Each
// is instantiated per value type (values.cuh: float32, bfloat16, float16)
// and per ring (ring.cuh). Plain C launchers for ctypes; see
// kernels/stream.py for the wrappers, their plain PyTorch versions and
// the launch counters.
//
// Both move bytes and do one combine per slot, so bytes bound them. A
// gather slot reads its value (4 B, or 2 B in bfloat16 and float16), its
// lane index q (1 B) and one x value; K3 also reads three route bytes per
// output element. Products are formed in float32 and rounded to the
// value type where they are written. K4 is one
// thread per output element, every read from global memory (x tables of
// the planner's sizes stay in the card's 50 MB of L2); it is the check on
// K3 and no plan takes it.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "split_tile.cuh"
#include "values.cuh"

// The product of gather slot i (flat over the (n_tiles*128, 128) gather
// stream): combine(Ax, x2d[xb[t]*128 + s, q]) in float32 with t = i / 16384
// and s its sublane, or the ring's identity where q < 0 (a junk slot).
template <typename T, int RING>
__device__ __forceinline__ float gather_product(const Bits<T>* __restrict__ x2d,
                                                const Bits<T>* __restrict__ ax,
                                                const int8_t* __restrict__ q,
                                                const int32_t* __restrict__ xb,
                                                int64_t i) {
  const int qv = q[i];
  if (qv < 0) return Ring<RING>::identity();
  const int64_t t = i >> 14;
  const int s = (int)((i >> 7) & 127);
  return Ring<RING>::combine(
      Num<T>::widen(ax[i]),
      Num<T>::widen(x2d[(int64_t)xb[t] * SPMV_TILE + s * SPMV_LANES + qv]));
}

// ---------------------------------------------------------------------------
// K4: replaces spmv_tpu/kernels/stream.py:1572 _gather_pass (pallas_call
// at :1586), body _gather_kernel (:1137). One thread per gather slot.
// The reference reads its x window from a VMEM-resident table or by a
// per-tile DMA; here the one global read hits L2.
// ---------------------------------------------------------------------------
template <typename T, int RING>
__global__ void gather_kernel(const Bits<T>* __restrict__ x2d,
                              const Bits<T>* __restrict__ ax,
                              const int8_t* __restrict__ q,
                              const int32_t* __restrict__ xb,
                              Bits<T>* __restrict__ out, int64_t n) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = Num<T>::round(gather_product<T, RING>(x2d, ax, q, xb, i));
}

// ---------------------------------------------------------------------------
// K3: replaces spmv_tpu/kernels/stream.py:1195 _gather_split_pass
// (pallas_call at :1218), body _gather_split_kernel (:1156): the gather
// fused with shuffle pass 1. K5's body (split_tile.cuh) with a load
// policy that forms the tile's 16384 products in shared memory instead
// of copying a data tile (split_tile.cuh's ProductLoad): each thread
// takes 4 consecutive slots of one sublane s, their Ax as one vector and
// their q as a char4 (both streamed with __ldcs), and their x values
// x2d[xb[tile]*16384 + s*128 + q] from one row of the x window (L2); the
// ring's identity where q < 0, as gather_product gives it.
// Neither the products nor the routed tiles are written out. The windows
// land at rows pos[t]*sbt*Q + j*Q ... of group k (the reference's (K,
// sbt*Q, 128) output block pos[t]); rows no window covers are filled with
// the ring's identity by the wrapper.
// ---------------------------------------------------------------------------
template <typename T, int RING>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
    gather_split_kernel(const Bits<T>* __restrict__ x2d, const Bits<T>* __restrict__ ax,
                        const int8_t* __restrict__ q, const int32_t* __restrict__ xb,
                        const uint8_t* __restrict__ s1, const uint8_t* __restrict__ s2,
                        const uint8_t* __restrict__ s3,
                        const int32_t* __restrict__ starts, int starts_w,
                        const int32_t* __restrict__ pos, void* __restrict__ out,
                        int sbt, int K, int Q, int64_t rows_per_g, int rows_per_cta) {
  split_tile<T>(SplitGeom{s1, s2, s3, starts, starts_w, pos, out, sbt, K, Q,
                          rows_per_g, rows_per_cta},
                ProductLoad<T, RING>{x2d, ax, q, xb});
}

template <typename T>
int launch_gather(const void* x2d, const void* ax, const int8_t* q,
                  const int32_t* xb, void* out, int64_t n, int ring,
                  cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
#define SPMV_LAUNCH_K4(R)                                                    \
  gather_kernel<T, R><<<blocks, threads, 0, stream>>>(                       \
      static_cast<const Bits<T>*>(x2d), static_cast<const Bits<T>*>(ax), q,  \
      xb, static_cast<Bits<T>*>(out), n)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K4)
#undef SPMV_LAUNCH_K4
  return (int)cudaGetLastError();
}

template <typename T>
int launch_gather_split(const void* x2d, const void* ax, const int8_t* q,
                        const int32_t* xb, const uint8_t* s1, const uint8_t* s2,
                        const uint8_t* s3, const int32_t* starts, int starts_w,
                        const int32_t* pos, void* out, int n_steps, int sbt,
                        int K, int Q, int64_t rows_per_g, dim3 grid,
                        int rows_per_cta, int ring, cudaStream_t stream) {
  cudaError_t e = cudaSuccess;
#define SPMV_LAUNCH_K3(R)                                                      \
  e = cudaFuncSetAttribute(gather_split_kernel<T, R>,                          \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,        \
                           split_smem<T>());                                   \
  if (e != cudaSuccess) return (int)e;                                         \
  if (n_steps > 0)                                                             \
    gather_split_kernel<T, R><<<grid, SPLIT_THREADS, split_smem<T>(), stream>>>( \
        static_cast<const Bits<T>*>(x2d), static_cast<const Bits<T>*>(ax), q,  \
        xb, s1, s2, s3, starts, starts_w, pos, out, sbt, K, Q, rows_per_g,     \
        rows_per_cta)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K3)
#undef SPMV_LAUNCH_K3
  return (int)cudaGetLastError();
}

extern "C" {

int spmv_gather(const void* x2d, const void* ax, const int8_t* q,
                const int32_t* xb, void* out, int32_t n_tiles, int32_t dtype,
                int32_t ring, void* stream) {
  const int64_t n = (int64_t)n_tiles * SPMV_TILE;
  if (n <= 0) return (int)cudaGetLastError();
#define SPMV_LAUNCH_T(T) \
  return launch_gather<T>(x2d, ax, q, xb, out, n, ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

int spmv_gather_split(const void* x2d, const void* ax, const int8_t* q,
                      const int32_t* xb, const uint8_t* s1, const uint8_t* s2,
                      const uint8_t* s3, const int32_t* starts,
                      int32_t starts_w, const int32_t* pos, void* out,
                      int32_t n_steps, int32_t sbt, int32_t K, int32_t Q,
                      int64_t rows_per_g, int32_t dtype, int32_t ring,
                      void* stream) {
  dim3 grid;
  int rows_per_cta = 0;
  cudaError_t e = split_grid(n_steps, sbt, K, Q, &grid, &rows_per_cta);
  if (e != cudaSuccess) return (int)e;
  if (!split_aligned(ax, q, s1, s2, s3) || ((uintptr_t)out & 15))
    return (int)cudaErrorInvalidValue;
#define SPMV_LAUNCH_T(T)                                                      \
  return launch_gather_split<T>(x2d, ax, q, xb, s1, s2, s3, starts, starts_w, \
                                pos, out, n_steps, sbt, K, Q, rows_per_g,     \
                                grid, rows_per_cta, ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

}  // extern "C"
