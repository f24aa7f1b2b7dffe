// Shuffle split pass K5 for Hopper. Plain C launcher for ctypes; see
// kernels/shuffle.py for the wrapper, its plain PyTorch version and the
// launch counter.
//
// Replaces spmv_tpu/kernels/shuffle.py:607 _run_split (pallas_call at
// :630), body _split_kernel (:586). One split pass of the planned
// permutation: for each step t, route its sbt input tiles, then copy,
// for each group k < K and tile j < sbt, the Q rows that start at row
// starts[t, j*K + k] of tile j's routed block into rows
// pos[t]*sbt*Q + j*Q ... of group k's output.
//
// It moves bytes: audit_plan counts 11.5 MB per pass on the bench plan
// (power_law_csr(1<<20, 1<<20, 3.3M, seed 42); 2 passes per call). The
// body is split_tile.cuh's: the data tile and the route's first two
// stages staged in shared memory, the route followed there, each window
// row written as 4 values a lane; bench's 64-tile passes take several
// CTAs per tile. It is instantiated per value type (values.cuh): a move,
// so it gives the input's bits in float32, bfloat16 and float16, and the
// 2-byte types halve its value bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "split_tile.cuh"
#include "values.cuh"

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS, 2)
    split_kernel(const Bits<T>* __restrict__ data, const uint8_t* __restrict__ s1,
                 const uint8_t* __restrict__ s2, const uint8_t* __restrict__ s3,
                 const int32_t* __restrict__ starts, int starts_w,
                 const int32_t* __restrict__ pos, void* __restrict__ out,
                 int sbt, int K, int Q, int64_t rows_per_g, int rows_per_cta) {
  split_tile<T>(SplitGeom{s1, s2, s3, starts, starts_w, pos, out, sbt, K, Q,
                          rows_per_g, rows_per_cta},
                SplitDataLoad<T>{data});
}

extern "C" int spmv_split(const void* data, const uint8_t* s1,
                          const uint8_t* s2, const uint8_t* s3,
                          const int32_t* starts, int32_t starts_w,
                          const int32_t* pos, void* out, int32_t n_steps,
                          int32_t sbt, int32_t K, int32_t Q,
                          int64_t rows_per_g, int32_t dtype, void* stream) {
  dim3 grid;
  int rows_per_cta = 0;
  cudaError_t e = split_grid(n_steps, sbt, K, Q, &grid, &rows_per_cta);
  if (e != cudaSuccess) return (int)e;
  if (!split_aligned(data, s1, s2, s3, out)) return (int)cudaErrorInvalidValue;
#define SPMV_LAUNCH_K5(T)                                                       \
  e = cudaFuncSetAttribute(split_kernel<T>,                                     \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,         \
                           split_smem<T>());                                    \
  if (e != cudaSuccess) return (int)e;                                          \
  if (n_steps > 0)                                                              \
    split_kernel<T><<<grid, SPLIT_THREADS, split_smem<T>(), (cudaStream_t)stream>>>( \
        static_cast<const Bits<T>*>(data), s1, s2, s3, starts, starts_w, pos,   \
        out, sbt, K, Q, rows_per_g, rows_per_cta)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_K5)
#undef SPMV_LAUNCH_K5
  return (int)cudaGetLastError();
}
