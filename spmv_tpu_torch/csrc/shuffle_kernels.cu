// Shuffle split pass K5 for Hopper. Plain C launcher for ctypes; see
// kernels/shuffle.py for the wrapper, its plain PyTorch version and the
// launch counter.
//
// Replaces spmv_tpu/kernels/shuffle.py:607 _run_split (pallas_call at
// :630), body _split_kernel (:586). One split pass of the planned
// permutation: for each step t, route its sbt input tiles, then copy,
// for each group k < K and tile j < sbt, the Q rows that start at row
// starts[t, j*K + k] of the step's routed block (the sbt routed tiles
// stacked, indexed as one block, as the reference's scratch is) into
// rows pos[t]*sbt*Q + j*Q ... of group k's output.
//
// It moves bytes: audit_plan counts 11.5 MB per pass on the bench plan
// (power_law_csr(1<<20, 1<<20, 3.3M, seed 42); 2 passes per call). One
// block per (step, tile j); each thread evaluates the route for its own
// output element and reads the source value from global memory, so the
// routed tiles are never materialised, and the output rows are written
// with consecutive threads on consecutive addresses.

#include <cuda_runtime.h>

#include <cstdint>

#include "route3.cuh"

__global__ void split_kernel(const float* __restrict__ data,
                             const uint8_t* __restrict__ s1,
                             const uint8_t* __restrict__ s2,
                             const uint8_t* __restrict__ s3,
                             const int32_t* __restrict__ starts,
                             int starts_w, const int32_t* __restrict__ pos,
                             float* __restrict__ out, int sbt, int K, int Q,
                             int64_t rows_per_g) {
  const int t = blockIdx.x, j = blockIdx.y;
  const int64_t tile0 = (int64_t)t * sbt;
  const int64_t out_row0 = (int64_t)pos[t] * sbt * Q + (int64_t)j * Q;
  const int per_group = Q * SPMV_LANES;
  for (int i = threadIdx.x; i < K * per_group; i += blockDim.x) {
    const int k = i / per_group;
    const int rem = i - k * per_group;
    const int r = rem >> 7, c = rem & 127;
    // row of the step's stacked routed block, then its tile and row
    const int R = j * SPMV_LANES + starts[(int64_t)t * starts_w + j * K + k] + r;
    const int64_t tb = (tile0 + (R >> 7)) * SPMV_TILE;
    const int src = route_src(s1 + tb, s2 + tb, s3 + tb, R & 127, c);
    out[((int64_t)k * rows_per_g + out_row0 + r) * SPMV_LANES + c] =
        data[tb + src];
  }
}

extern "C" int spmv_split(const float* data, const uint8_t* s1,
                          const uint8_t* s2, const uint8_t* s3,
                          const int32_t* starts, int32_t starts_w,
                          const int32_t* pos, float* out, int32_t n_steps,
                          int32_t sbt, int32_t K, int32_t Q,
                          int64_t rows_per_g, void* stream) {
  if (n_steps > 0) {
    split_kernel<<<dim3(n_steps, sbt), 256, 0, (cudaStream_t)stream>>>(
        data, s1, s2, s3, starts, starts_w, pos, out, sbt, K, Q, rows_per_g);
  }
  return (int)cudaGetLastError();
}
