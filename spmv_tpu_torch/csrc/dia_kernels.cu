// DIA fold K12 for Hopper, instantiated per value type (values.cuh:
// float32, bfloat16, float16) and per ring. Plain C launcher for ctypes;
// see kernels/dia.py for the wrapper, its plain PyTorch version and the
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
// halo. Here x is read directly at r + d, so any offset works.
//
// What bounds it on this card: bytes. The plan, D (n,) rows of vals
// (4 B, or 2 B in bfloat16 and float16) and valid (1 B), is read once; x is read about once (the
// diagonals of a stencil hit the same lines in L1/L2) and y written
// once: 34.6 MB for poisson2d(1024), 10.3 us at 3.35 TB/s. Inside CG
// the vector updates evict the plan from L2 between matvecs, so the
// plan comes from device memory every time.
//
// What the design does about it: keep the memory system full. A thread
// per row that loads vals and x only inside `if (valid)` waits on two
// dependent trips to memory per diagonal. Here
//   - a thread owns K12_ROWS = 4 consecutive rows: per diagonal one
//     4-value access of vals (a float4, or a uint2 of 2-byte values) and
//     one 32-bit word of 4 valid bytes (scalar loads where n % 4 != 0,
//     when the rows of the (D, n) arrays are not aligned to 4 values, and
//     for the last rows);
//   - the diagonals go in unrolled chunks of K12_CHUNK = 8: every plan
//     load and every x load of a chunk is issued before any result is
//     used. x is read at its index clamped to [0, n), which needs no
//     valid byte, and the identity is selected where valid is 0 (as it
//     is in every plan wherever r + d falls outside [0, n)); so a chunk
//     waits once for memory;
//   - the plan is read with the streaming, evict-first policy (__ldcs),
//     read once, so that x stays in L2; x goes through __ldg;
//   - the offsets are staged in shared memory once per CTA.
// The fold uses ring.cuh's round-to-nearest intrinsics in float32 in the
// plan's order, so no FMA contracts y + v * x, and y, rounded to the value
// type once where it is written, equals the plain version's bit for bit
// in every ring. There is nothing to multiply in bulk, so no
// tensor-core path; a TMA or cp.async bulk stream of the plan was not
// tried. On an H100, inside CG on poisson2d(1024), it runs at about 73%
// of its bound; 8 rows a thread, chunks of 4 diagonals and 128-thread
// CTAs ran within 0.6 us of this design there, and 3 CTAs per SM (80
// registers) ran slower.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "values.cuh"

#define K12_THREADS 256
#define K12_ROWS 4
#define K12_CHUNK 8
#define K12_MAX_DIAGS 64  // kernels/dia.py MAX_DIAGS

template <typename T, int RING, bool VEC>
__global__ void __launch_bounds__(K12_THREADS)
    dia_kernel(const Bits<T>* __restrict__ vals, const int8_t* __restrict__ valid,
               const Bits<T>* __restrict__ x, const int32_t* __restrict__ offsets,
               Bits<T>* __restrict__ y, int D, int64_t n) {
  using Rg = Ring<RING>;
  using P4 = typename Num<T>::Pack4;
  __shared__ int32_t s_off[K12_MAX_DIAGS];
  for (int i = threadIdx.x; i < D; i += K12_THREADS) s_off[i] = offsets[i];
  __syncthreads();
  const int64_t r0 = ((int64_t)blockIdx.x * K12_THREADS + threadIdx.x) * K12_ROWS;
  if (r0 >= n) return;
  const bool whole = r0 + K12_ROWS <= n;  // the same for all but the last thread
  float acc[K12_ROWS];
#pragma unroll
  for (int c = 0; c < K12_ROWS; ++c) acc[c] = Rg::identity();
  for (int i0 = 0; i0 < D; i0 += K12_CHUNK) {
    float v[K12_CHUNK][K12_ROWS], xv[K12_CHUNK][K12_ROWS];
    uint32_t m[K12_CHUNK];  // valid byte of row r0 + c in byte c
#pragma unroll
    for (int j = 0; j < K12_CHUNK; ++j) {
      if (i0 + j >= D) continue;
      const int64_t k = (int64_t)(i0 + j) * n + r0;
      if (VEC && whole) {
        const float4 a = Num<T>::widen4(__ldcs(reinterpret_cast<const P4*>(vals + k)));
        v[j][0] = a.x;
        v[j][1] = a.y;
        v[j][2] = a.z;
        v[j][3] = a.w;
        m[j] = __ldcs(reinterpret_cast<const unsigned int*>(valid + k));
      } else {
        m[j] = 0;
#pragma unroll
        for (int c = 0; c < K12_ROWS; ++c) {
          const bool in = r0 + c < n;
          v[j][c] = in ? Num<T>::widen(__ldcs(vals + k + c)) : 0.f;
          m[j] |= in ? (uint32_t)__ldcs(reinterpret_cast<const unsigned char*>(
                           valid + k + c)) << (8 * c)
                     : 0u;
        }
      }
      const int64_t d = s_off[i0 + j];
#pragma unroll
      for (int c = 0; c < K12_ROWS; ++c) {
        const int64_t col = r0 + c + d;
        xv[j][c] = Num<T>::widen(__ldg(x + (col < 0 ? 0 : col >= n ? n - 1 : col)));
      }
    }
#pragma unroll
    for (int j = 0; j < K12_CHUNK; ++j) {
      if (i0 + j >= D) continue;
#pragma unroll
      for (int c = 0; c < K12_ROWS; ++c) {
        const bool live = (int8_t)(m[j] >> (8 * c)) > 0;  // the plain version's valid > 0
        acc[c] = Rg::reduce(acc[c], live ? Rg::combine(v[j][c], xv[j][c]) : Rg::identity());
      }
    }
  }
  if (VEC && whole) {
    *reinterpret_cast<P4*>(y + r0) =
        Num<T>::round4(make_float4(acc[0], acc[1], acc[2], acc[3]));
  } else {
#pragma unroll
    for (int c = 0; c < K12_ROWS; ++c)
      if (r0 + c < n) y[r0 + c] = Num<T>::round(acc[c]);
  }
}

template <typename T>
int launch_dia(const void* vals_, const int8_t* valid, const void* x_,
               const int32_t* offsets, void* y_, int D, int64_t n, int ring,
               cudaStream_t st) {
  const auto* vals = static_cast<const Bits<T>*>(vals_);
  const auto* x = static_cast<const Bits<T>*>(x_);
  auto* y = static_cast<Bits<T>*>(y_);
  // 4-value and 32-bit plan loads need every diagonal's row aligned to 4
  // values (16 bytes, or 8 of 2-byte values)
  const uintptr_t a4 = 4 * sizeof(Bits<T>);
  const bool vec = n % K12_ROWS == 0 && (uintptr_t)vals % a4 == 0 &&
                   (uintptr_t)valid % 4 == 0 && (uintptr_t)y % a4 == 0;
  const int64_t threads = (n + K12_ROWS - 1) / K12_ROWS;
  const unsigned blocks = (unsigned)((threads + K12_THREADS - 1) / K12_THREADS);
#define SPMV_LAUNCH_K12(R)                                                     \
  if (vec)                                                                     \
    dia_kernel<T, R, true><<<blocks, K12_THREADS, 0, st>>>(vals, valid, x,     \
                                                           offsets, y, D, n);  \
  else                                                                         \
    dia_kernel<T, R, false><<<blocks, K12_THREADS, 0, st>>>(vals, valid, x,    \
                                                            offsets, y, D, n);
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K12)
#undef SPMV_LAUNCH_K12
  return (int)cudaGetLastError();
}

extern "C" int spmv_dia(const void* vals, const int8_t* valid, const void* x,
                        const int32_t* offsets, void* y, int32_t D, int64_t n,
                        int32_t dtype, int32_t ring, void* stream) {
  if (D < 1 || D > K12_MAX_DIAGS || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
#define SPMV_LAUNCH_T(T) \
  return launch_dia<T>(vals, valid, x, offsets, y, D, n, ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}
