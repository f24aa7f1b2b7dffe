// K13, the window product of `spmm`, for Hopper, instantiated per value
// type (values.cuh: float32, bfloat16, float16; int32 and int64 for the
// built-in rings) and per ring. Plain C
// launcher for ctypes; see kernels/spmm.py for the wrapper
// `_spmm_window_pass`, its plain PyTorch version and the launch counter.
//
// Replaces spmv_tpu/kernels/spmm.py:190 _spmm_window_pass (pallas_call at
// :210), body _spmm_window_kernel (:148).
//
// The plan sorts the nonzeros by column and cuts them into tiles of 128,
// each inside one 128-row window xb[t] of X. For tile t, slot s:
//
//   P[t*128 + s, c] = combine(ax[t, s], X[xb[t]*128 + q[t, s], c]),  c < 128.
//
// The TPU kernel reads X through a one-hot matrix product on its matrix
// unit, because its core cannot gather rows. Here each slot's X row is
// read directly: one coalesced row per warp (512 bytes, or 256 of 2-byte
// values), 4 values a lane in one access, through the read-only path
// (the window's rows repeat across the tiles of a window and stay in L2),
// and its P row is written once,
// coalesced, with an evict-first store so the stream of P does not push
// X out of L2. A direct read has no 0 * inf terms: X holding +-inf
// gives the semiring oracle's values, where the one-hot product gives
// NaN (ROADMAP section 3).
//
// X is one 128-column block of a row-major (rows, ld) matrix: the
// launcher takes its row stride `ld` (a multiple of 4, and a base aligned
// to 4 values: 16 bytes, or 8 of 2-byte values), so the wrapper passes a
// column block without copying it. The product is formed in float32 and
// rounded to the value type once, where P is written.
//
// Integer values (int32, as the reference's window pass computes integer
// A and x, and int64): the ring's combine in the value's width with
// wrap-around, as torch's integer products and sums are, or-and as 0 or
// 1; each lane reads and writes its 4 values one by one.
//
// Bound: bytes. P (T*128*128 values of 4 or 2 bytes) is written once and
// dominates; q, ax and the X rows the tiles touch are read once.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "ring.cuh"
#include "route3.cuh"
#include "values.cuh"

#define K13_THREADS 256

template <typename T, int RING>
__global__ void __launch_bounds__(K13_THREADS)
    spmm_window_kernel(const Bits<T>* __restrict__ X, int64_t ld, int64_t n_xrows,
                       const Bits<T>* __restrict__ ax,
                       const int32_t* __restrict__ q,
                       const int32_t* __restrict__ xb, Bits<T>* __restrict__ P) {
  using P4 = typename Num<T>::Pack4;
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)xb[t] * SPMV_LANES;
  for (int s = warp; s < SPMV_LANES; s += K13_THREADS / 32) {
    const int64_t slot = (int64_t)t * SPMV_LANES + s;
    const float a = Num<T>::widen(ax[slot]);
    const int64_t xr = row0 + q[slot];
    float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (xr >= 0 && xr < n_xrows)
      xv = Num<T>::widen4(__ldg(reinterpret_cast<const P4*>(X + xr * ld) + lane));
    float4 o;
    o.x = Ring<RING>::combine(a, xv.x);
    o.y = Ring<RING>::combine(a, xv.y);
    o.z = Ring<RING>::combine(a, xv.z);
    o.w = Ring<RING>::combine(a, xv.w);
    __stcs(reinterpret_cast<P4*>(P + slot * SPMV_LANES) + lane, Num<T>::round4(o));
  }
}

#ifndef SPMV_RING_USER
template <typename I, int RING>
__device__ __forceinline__ I int_combine(I a, I x) {
  using U = typename std::make_unsigned<I>::type;
  if constexpr (RING == SPMV_RING_MIN_PLUS)
    return (I)((U)a + (U)x);
  else if constexpr (RING == SPMV_RING_OR_AND || RING == SPMV_RING_OR_AND_COUNT)
    return a != 0 && x != 0;
  else
    return (I)((U)a * (U)x);
}

template <typename I, int RING>
__global__ void __launch_bounds__(K13_THREADS)
    spmm_window_int_kernel(const I* __restrict__ X, int64_t ld, int64_t n_xrows,
                           const I* __restrict__ ax, const int32_t* __restrict__ q,
                           const int32_t* __restrict__ xb, I* __restrict__ P) {
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row0 = (int64_t)xb[t] * SPMV_LANES;
  for (int s = warp; s < SPMV_LANES; s += K13_THREADS / 32) {
    const int64_t slot = (int64_t)t * SPMV_LANES + s;
    const I a = ax[slot];
    const int64_t xr = row0 + q[slot];
    const bool in = xr >= 0 && xr < n_xrows;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const I x = in ? __ldg(X + xr * ld + 4 * lane + j) : (I)0;
      P[slot * SPMV_LANES + 4 * lane + j] = int_combine<I, RING>(a, x);
    }
  }
}

template <typename I>
int launch_spmm_window_int(const void* X, int64_t ld, int64_t n_xrows, const void* ax,
                           const int32_t* q, const int32_t* xb, void* P, int n_tiles,
                           int ring, cudaStream_t stream) {
  if (n_tiles > 0) {
#define SPMV_LAUNCH_K13I(R)                                                         \
  spmm_window_int_kernel<I, R><<<n_tiles, K13_THREADS, 0, stream>>>(                \
      static_cast<const I*>(X), ld, n_xrows, static_cast<const I*>(ax), q, xb,      \
      static_cast<I*>(P))
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K13I)
#undef SPMV_LAUNCH_K13I
  }
  return (int)cudaGetLastError();
}
#endif

template <typename T>
int launch_spmm_window(const void* X, int64_t ld, int64_t n_xrows, const void* ax,
                       const int32_t* q, const int32_t* xb, void* P, int n_tiles,
                       int ring, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(X) % (4 * sizeof(Bits<T>)) ||
      reinterpret_cast<uintptr_t>(P) % (4 * sizeof(Bits<T>)))
    return (int)cudaErrorMisalignedAddress;
  if (n_tiles > 0) {
#define SPMV_LAUNCH_K13(R)                                                   \
  spmm_window_kernel<T, R><<<n_tiles, K13_THREADS, 0, stream>>>(             \
      static_cast<const Bits<T>*>(X), ld, n_xrows,                          \
      static_cast<const Bits<T>*>(ax), q, xb, static_cast<Bits<T>*>(P))
    SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K13)
#undef SPMV_LAUNCH_K13
  }
  return (int)cudaGetLastError();
}

extern "C" {

int spmv_spmm_window(const void* X, int64_t ld, int64_t n_xrows,
                     const void* ax, const int32_t* q, const int32_t* xb,
                     void* P, int32_t n_tiles, int32_t dtype, int32_t ring,
                     void* stream) {
  if (ld < SPMV_LANES || ld % 4 || n_tiles < 0) return (int)cudaErrorInvalidValue;
#ifndef SPMV_RING_USER
  if (dtype == SPMV_I32)
    return launch_spmm_window_int<int32_t>(X, ld, n_xrows, ax, q, xb, P, n_tiles, ring,
                                           (cudaStream_t)stream);
  if (dtype == SPMV_I64)
    return launch_spmm_window_int<long long>(X, ld, n_xrows, ax, q, xb, P, n_tiles, ring,
                                             (cudaStream_t)stream);
#endif
#define SPMV_LAUNCH_T(T)                                                  \
  return launch_spmm_window<T>(X, ld, n_xrows, ax, q, xb, P, n_tiles,     \
                               ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

}  // extern "C"
