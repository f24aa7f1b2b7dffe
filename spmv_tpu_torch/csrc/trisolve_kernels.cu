// Level-scheduled triangular solve K14 for Hopper, instantiated per value
// type (values.cuh: float32, bfloat16, float16). Plain C launcher for
// ctypes; see kernels/trisolve.py for the wrapper (`_sptrsv_pass`), its
// plain PyTorch version and the launch counter.
//
// Replaces no pallas_call: it is the counterpart of the reference's
// compiled device loop, the `lax.scan` over the levels in
// spmv_tpu/kernels/trisolve.py:151 (step :141-149). The solve plan packs
// the rows of each wavefront level into one (n_levels, PL, W) envelope;
// level by level, in order, each row slot s of level l computes
//   acc = sum_w vals[l, s, w] * x[cols[l, s, w]]   (w = 0, 1, ..., in order)
//   x[row] = (b[row] - acc) / diag[l, s]
// where a padding row (rows == -1) reads b[0] and writes slot n of the
// (n + 1)-slot x, and padding slots (cols 0, vals 0) still multiply
// 0 * x[0], so that NaN and +-inf spread as in the reference.
//
// What bounds it on this card: the chain of levels. The bytes (plan, b
// and x, about 58 MB for a poisson2d(1024) triangle, 17 us at 3.35 TB/s)
// are small against n_levels dependent steps, each at least one trip to
// L2 for the x values the level reads, plus a barrier (2047 steps per
// poisson2d(1024) triangle).
//
// What the design does about it, kept simple: one CTA of 1024 threads
// runs every level, so a level hands its x values to the next through
// the block's L1 and L2 and one __syncthreads(), which makes the level's
// global writes visible to the whole block; no grid-wide barrier and no
// launch per level. The threads stride over the level's PL slots. A slot
// issues its W plan loads and then its W x loads (4 at a time), sums in
// float32 in slot order with round-to-nearest intrinsics (no FMA
// contracts acc + v * x) and divides with __fdiv_rn, so the result equals
// the plain version's bit for bit; 2-byte values are widened on load and
// x is rounded once where it is written. Within a level no slot reads a
// row the level writes, except padding slots reading x[0]: the level that
// writes row 0 (l0, found on the host) writes it only after the level's
// barrier, behind one more barrier, so those reads see x[0] as it was
// before the level, as the reference's scan step does. A level that holds
// more than 1024 slots is walked by each thread in turn within the one
// CTA; a grid-wide design for wide levels is later work.

#include <cuda_runtime.h>

#include <cstdint>

#include "values.cuh"

#define K14_THREADS 1024

template <typename T>
__global__ void __launch_bounds__(K14_THREADS)
    sptrsv_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                  const Bits<T>* __restrict__ vals, const Bits<T>* __restrict__ diag,
                  const Bits<T>* __restrict__ b, Bits<T>* x, int n_levels, int PL, int W,
                  int64_t n, int l0) {
  // x[0] is read by padding slots before row 0 is written; every other
  // slot of x below n is written before any level reads it
  if (threadIdx.x == 0) x[0] = Bits<T>(0);
  __syncthreads();
  for (int l = 0; l < n_levels; ++l) {
    bool has0 = false;
    float x0 = 0.f;
    for (int s = threadIdx.x; s < PL; s += K14_THREADS) {
      const int64_t ls = (int64_t)l * PL + s;
      const int32_t row = rows[ls];
      const int32_t* c = cols + ls * W;
      const Bits<T>* v = vals + ls * W;
      const float bv = Num<T>::widen(b[row >= 0 ? row : 0]);
      const float dv = Num<T>::widen(diag[ls]);
      float acc = 0.f;
      int w = 0;
      for (; w + 4 <= W; w += 4) {
        int32_t cc[4];
        float vv[4], xx[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cc[j] = c[w + j];
          vv[j] = Num<T>::widen(v[w + j]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) xx[j] = Num<T>::widen(x[cc[j]]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc = __fadd_rn(acc, __fmul_rn(vv[j], xx[j]));
      }
      for (; w < W; ++w) acc = __fadd_rn(acc, __fmul_rn(Num<T>::widen(v[w]), Num<T>::widen(x[c[w]])));
      const float xi = __fdiv_rn(__fsub_rn(bv, acc), dv);
      if (row == 0) {
        has0 = true;
        x0 = xi;
      } else {
        x[row >= 0 ? row : n] = Num<T>::round(xi);
      }
    }
    if (l == l0) {  // the same for every thread of the block
      __syncthreads();
      if (has0) x[0] = Num<T>::round(x0);
    }
    __syncthreads();
  }
}

extern "C" int spmv_sptrsv(const int32_t* rows, const int32_t* cols, const void* vals,
                           const void* diag, const void* b, void* x, int32_t n_levels,
                           int32_t PL, int32_t W, int64_t n, int32_t l0, int32_t dtype,
                           void* stream) {
  if (n_levels < 0 || PL < 1 || W < 1 || n < 0 || n >= INT32_MAX)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || n_levels == 0) return 0;
#define SPMV_LAUNCH_T(T)                                                           \
  sptrsv_kernel<T><<<1, K14_THREADS, 0, (cudaStream_t)stream>>>(                   \
      rows, cols, static_cast<const Bits<T>*>(vals), static_cast<const Bits<T>*>(diag), \
      static_cast<const Bits<T>*>(b), static_cast<Bits<T>*>(x), n_levels, PL, W, n, l0); \
  break;
  switch (dtype) {
    case SPMV_F32: SPMV_LAUNCH_T(float)
    case SPMV_BF16: SPMV_LAUNCH_T(__nv_bfloat16)
    case SPMV_F16: SPMV_LAUNCH_T(__half)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPMV_LAUNCH_T
  return (int)cudaGetLastError();
}
