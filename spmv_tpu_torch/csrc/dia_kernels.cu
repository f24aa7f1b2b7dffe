// DIA fold K12 for Hopper. Plain C launcher for ctypes; see
// kernels/dia.py for the wrapper, its plain PyTorch version and the
// launch counter.
//
// Replaces spmv_tpu/kernels/dia.py:129 _dia_matvec_pallas (pallas_call at
// :174), body _dia_kernel (:97), and the XLA pass _dia_matvec_xla (:75)
// that the reference takes past its halo: both compute
//   y[r] = reduce_i (valid[i, r] ? combine(vals[i, r], x[r + d_i]) : id)
// folded from the identity in the plan's (sorted) diagonal order.
//
// The TPU kernel stages a three-block x window per (64, 128) y block and
// shifts it by a row slice and a lane roll, which bounds |d| by its
// halo. Here one thread per row reads x[r + d] directly, only where
// valid is set (no halo, no out-of-range read), so any offset works. It
// moves bytes: per row, D values (4 B) and D valid flags (1 B), read
// with consecutive threads on consecutive rows, up to D x reads (the
// five diagonals of a 2-D Poisson stencil hit in L1/L2) and one y
// write: about 26 MB of vals and valid for poisson2d(1024). The fold
// uses ring.cuh's round-to-nearest intrinsics, so no FMA contracts
// y + v * x and the result equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"

template <int RING>
__global__ void dia_kernel(const float* __restrict__ vals,
                           const int8_t* __restrict__ valid,
                           const float* __restrict__ x,
                           const int32_t* __restrict__ offsets,
                           float* __restrict__ y, int D, int64_t n) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  float acc = Ring<RING>::identity();
  for (int i = 0; i < D; ++i) {
    const int64_t k = (int64_t)i * n + r;
    float t = Ring<RING>::identity();
    if (valid[k]) t = Ring<RING>::combine(vals[k], x[r + offsets[i]]);
    acc = Ring<RING>::reduce(acc, t);
  }
  y[r] = acc;
}

extern "C" int spmv_dia(const float* vals, const int8_t* valid,
                        const float* x, const int32_t* offsets, float* y,
                        int32_t D, int64_t n, int32_t ring, void* stream) {
  const int threads = 256;
  if (n > 0) {
    const unsigned blocks = (unsigned)((n + threads - 1) / threads);
#define SPMV_LAUNCH_K12(R)                                                 \
  dia_kernel<R><<<blocks, threads, 0, (cudaStream_t)stream>>>(vals, valid, \
                                                              x, offsets, y, \
                                                              D, n)
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K12)
#undef SPMV_LAUNCH_K12
  }
  return (int)cudaGetLastError();
}
