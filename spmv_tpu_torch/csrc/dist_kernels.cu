// K11': the per-shard ELL product and group reduce of the multi-device
// layer, for Hopper, instantiated per value type (values.cuh: float32,
// bfloat16, float16), ring and W. Plain C launcher for ctypes; see
// parallel/dist_spmv.py (_local_ell_pass) for the wrapper, its plain
// PyTorch version and the launch counter.
//
// Replaces spmv_tpu/parallel/dist_spmv.py:179 _local_ell_matvec
// (pallas_call at :194), whose body is the ELL `tree` group reduce of
// spmv_tpu/kernels/ell.py:_group_reduce_kernel.
//
// The reference gathers x[aj] in XLA, combines, masks with `valid` and
// only then calls its kernel, because a TPU core cannot gather from
// arbitrary addresses. Here one kernel does all of it. The launch's
// L*Tv*8 rows of 128 lanes (row r belongs to shard r / (Tv*8)) are
// taken one warp a row, each thread 4 consecutive lanes:
//   v[i] = valid ? combine(ax, xsrc[shard * x_stride + aj]) : identity;
// then each W-lane group is reduced into its leader in the reference's
// `tree` order (d = W/2, ..., 1: lane j < d takes reduce(v[j], v[j+d])),
// and the leaders are written compactly: out[r * (128/W) + lane / W],
// the order of the reference's reduced[:, ::W].reshape(-1). Values are
// widened to float on load; combine and reduce are the round-to-nearest
// intrinsics of ring.cuh in float32, so nvcc contracts no product into a
// fused multiply-add; each leader is rounded to the value type once,
// where it is written; so the kernel gives the plain version's bits in
// every built-in ring.
//
// Bytes bound it: per slot aj (4 B), ax (4 B, or 2 B in bfloat16 and
// float16), valid (1 B) and, where valid, one x value (4 B or 2 B); 4/W
// (or 2/W) B written. A matvec meets it with a
// cold L2, so the design keeps many bytes in flight:
// - a thread loads its lanes' aj as one int4, ax as one 4-value access
//   (a float4, or a uint2 of 2-byte values) and valid
//   as one 32-bit word, all three at once (no load waits on `valid`),
//   with the streaming hint (ld.global.cs) so the plan, read once, does
//   not push the x table out of L2; then its (up to) four x values
//   through the read-only path, independent loads, skipped for invalid
//   lanes: two dependent trips to memory a row, not three;
// - no shared memory and no barrier: the steps d >= 4 are warp shuffles
//   by d/4 threads, one for each of the thread's four values; d = 2 and
//   d = 1 run inside the thread, (v0 (+) v2) (+) (v1 (+) v3): the tree's
//   own order for every W. W = 1 writes 4 leaders a thread, W = 2 two,
//   W >= 4 one from the group's first thread;
// - CTAs of 4 warps (4 rows) at up to 16 CTAs an SM, 32 registers a
//   thread: 64 warps an SM, each with 1152 B of plan in flight, about
//   73 KB an SM against the ~25 KB that 3.35 TB/s at ~1 us of latency
//   needs. The grid is not persistent: a row needs one trip for its
//   plan and one for x, and full occupancy keeps both in flight. A
//   small launch still spreads: an 80-tile block is 160 CTAs.
// Measured cold (PERF.md), what remains is the x reads: each a random
// 4-byte read of its own 32-byte sector, more sector traffic than the
// plan, whether x is in L2 or not; the plan layout (the port's seam)
// gives them no locality to share.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"  // SPMV_LANES
#include "values.cuh"

#define K11P_WARPS 4  // rows (warps) per CTA

template <typename T, int RING>
__device__ __forceinline__ float k11p_slot(uint32_t ok, float a, const Bits<T>* x, int j) {
  return ok ? Ring<RING>::combine(a, Num<T>::widen(__ldg(x + j))) : Ring<RING>::identity();
}

template <typename T, int RING, int W>
__global__ void __launch_bounds__(32 * K11P_WARPS, 64 / K11P_WARPS)
local_ell_kernel(const int4* __restrict__ aj, const typename Num<T>::Pack4* __restrict__ ax,
                 const uint32_t* __restrict__ valid, const Bits<T>* __restrict__ xsrc,
                 int64_t x_stride, Bits<T>* __restrict__ out, int64_t n_rows,
                 int64_t rows_per_shard) {
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * K11P_WARPS + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // the whole warp: r is one warp's row
  const int64_t at = r * 32 + lane;  // the thread's 4-lane chunk
  const int4 j = __ldcs(aj + at);
  const float4 a = Num<T>::widen4(__ldcs(ax + at));
  const uint32_t m = __ldcs(valid + at);  // 4 bool bytes, lane i in byte i
  const Bits<T>* x = xsrc + (r / rows_per_shard) * x_stride;
  float v0 = k11p_slot<T, RING>(m & 0xffu, a.x, x, j.x);
  float v1 = k11p_slot<T, RING>(m & 0xff00u, a.y, x, j.y);
  float v2 = k11p_slot<T, RING>(m & 0xff0000u, a.z, x, j.z);
  float v3 = k11p_slot<T, RING>(m & 0xff000000u, a.w, x, j.w);
  // lane 4k+i's partner at distance d >= 4 is lane 4(k + d/4)+i
#pragma unroll
  for (int d = W / 2; d >= 4; d >>= 1) {
    v0 = Ring<RING>::reduce(v0, __shfl_down_sync(0xffffffffu, v0, d / 4));
    v1 = Ring<RING>::reduce(v1, __shfl_down_sync(0xffffffffu, v1, d / 4));
    v2 = Ring<RING>::reduce(v2, __shfl_down_sync(0xffffffffu, v2, d / 4));
    v3 = Ring<RING>::reduce(v3, __shfl_down_sync(0xffffffffu, v3, d / 4));
  }
  if (W == 1) {
    reinterpret_cast<typename Num<T>::Pack4*>(out)[at] =
        Num<T>::round4(make_float4(v0, v1, v2, v3));
  } else if (W == 2) {
    reinterpret_cast<typename Num<T>::Pack2*>(out)[at] =
        Num<T>::round2(Ring<RING>::reduce(v0, v1), Ring<RING>::reduce(v2, v3));
  } else if ((lane & (W / 4 - 1)) == 0) {
    out[r * (SPMV_LANES / W) + lane / (W / 4)] = Num<T>::round(
        Ring<RING>::reduce(Ring<RING>::reduce(v0, v2), Ring<RING>::reduce(v1, v3)));
  }
}

template <typename T, int RING>
static void launch_local_ell(const int32_t* aj, const void* ax, const uint8_t* valid,
                             const void* xsrc, int64_t x_stride, void* out,
                             int64_t n_rows, int64_t rows_per_shard, int W,
                             cudaStream_t stream) {
  const unsigned grid = (unsigned)((n_rows + K11P_WARPS - 1) / K11P_WARPS);
  const auto* aj4 = reinterpret_cast<const int4*>(aj);
  const auto* ax4 = static_cast<const typename Num<T>::Pack4*>(ax);
  const auto* v4 = reinterpret_cast<const uint32_t*>(valid);
  const auto* xs = static_cast<const Bits<T>*>(xsrc);
  auto* o = static_cast<Bits<T>*>(out);
#define SPMV_K11P_W(WW)                                                      \
  case WW:                                                                   \
    local_ell_kernel<T, RING, WW><<<grid, 32 * K11P_WARPS, 0, stream>>>(     \
        aj4, ax4, v4, xs, x_stride, o, n_rows, rows_per_shard);              \
    break;
  switch (W) {
    SPMV_K11P_W(1) SPMV_K11P_W(2) SPMV_K11P_W(4) SPMV_K11P_W(8)
    SPMV_K11P_W(16) SPMV_K11P_W(32) SPMV_K11P_W(64) SPMV_K11P_W(128)
  }
#undef SPMV_K11P_W
}

template <typename T>
static int launch_local_ell_t(const int32_t* aj, const void* ax, const uint8_t* valid,
                              const void* xsrc, int64_t x_stride, void* out,
                              int64_t n_rows, int64_t rows_per_shard, int W, int ring,
                              cudaStream_t stream) {
#define SPMV_LAUNCH_K11P(R)                                                    \
  launch_local_ell<T, R>(aj, ax, valid, xsrc, x_stride, out, n_rows,           \
                         rows_per_shard, W, stream)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K11P)
#undef SPMV_LAUNCH_K11P
  return (int)cudaGetLastError();
}

extern "C" {

// aj, ax, valid: (n_local, Tv, 8, 128), 16-byte aligned (the wrapper
// checks); xsrc: (n_local, x_stride); out: (n_local, Tv*8*128/W); ax,
// xsrc and out of the value type `dtype`.
int spmv_local_ell(const int32_t* aj, const void* ax, const uint8_t* valid,
                   const void* xsrc, int64_t x_stride, void* out,
                   int32_t n_local, int32_t Tv, int32_t W, int32_t dtype,
                   int32_t ring, void* stream) {
  if (W < 1 || W > SPMV_LANES || (W & (W - 1)) || n_local < 0 || Tv < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t rows_per_shard = (int64_t)Tv * 8;
  const int64_t n_rows = (int64_t)n_local * rows_per_shard;
  if (n_rows <= 0) return (int)cudaGetLastError();
#define SPMV_LAUNCH_T(T)                                                          \
  return launch_local_ell_t<T>(aj, ax, valid, xsrc, x_stride, out, n_rows,        \
                               rows_per_shard, W, ring, (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

}  // extern "C"
