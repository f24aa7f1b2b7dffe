// The body shared by the split passes K5 (shuffle_kernels.cu) and K3
// (gather_kernels.cu), the x prep K1 and the early row reductions K2
// (stream_kernels.cu) and K7 (roll_kernels.cu): stage one input tile in
// shared memory, follow the route there, write the tile's quota windows.
//
// For step t, tile j < sbt, group k < K and window row r < Q, output row
// pos[t]*sbt*Q + j*Q + r of group k is row st + r of the routed tile
// (route3.cuh), with st = starts[t, j*K + k]. Both planners clamp
// st <= 128 - Q (shuffle.py's `min(b // LANES, LANES - Q)`, host.cpp's
// `if (st > L - Q)`), and `shuffle_device_arrays` refuses a plan that
// breaks it, so every window lies in its own tile and a CTA needs only
// that tile. K1 runs the body in its whole-tile mode: a null `starts`
// reads as all zeros and a null `pos` as pos[t] = t, so with sbt = K = 1
// and Q = 128 window row r of step t is row r of routed tile t, written
// to output row t*128 + r (K2 and K7: Q = Qp, output row t*Qp + r).
//
// What bounds it: bytes. Each element of the tile's values and route is
// read once and each output written once. The first design, a thread per
// output element following the route through device memory, waited on
// four dependent L2 trips per element (s3, s2, s1, the value; six in K3),
// each fetching a 32-byte sector for 1 or 4 useful bytes.
//
// The design, one CTA of SPLIT_THREADS per (tile, share of its window
// rows), two CTAs per SM:
//   (a) s1 (16 KB) and s2 go to shared memory by cp.async, s2's rows
//       padded from 128 to 132 bytes: a warp reads one column R of s2
//       across rows k = s3 bytes, which unpadded rows put in one bank;
//   (b) the tile's 16384 values go to shared memory (64 KB) by the load
//       policy: K5 copies the data tile with 16-byte cp.async, K1 the
//       tile's x window the same way, K3 forms the gather products in a
//       coalesced sweep (ProductLoad), and K2 and K7 scan each row of
//       them in registers before they store them (ProductLoad's `Post`:
//       K7's a segmented scan on the run-start flags it loads beside q);
//   (c) a warp takes one window row at a time, each lane 4 consecutive
//       columns: the s3 bytes as one uchar4 (streamed, the only device
//       read of the phase), s2, s1 and the value from shared memory, one
//       float4 written. The next rows' s3 loads start before the
//       current rows are routed, the first batch before the staging wait.
//       The epilogue policy makes the float4 from the routed row: K1, K3
//       and K5 copy it (SplitCopy), K7 too with the s3 bytes' flag bit
//       masked off (SplitCopy<127>), K2 subtracts each slot's flat
//       predecessor (RunDiff in stream_kernels.cu).
// A launch with fewer tiles than SMs splits each tile's K*Q window rows
// over several CTAs (split_grid), each staging the whole tile again from
// L2, so that the card is filled; K7 launches one CTA per tile instead
// (roll_kernels.cu).
//
// The body is generic in the value type T (values.cuh): the staged tile
// holds T's bits (64 KB for float32, 32 KB for bfloat16 and float16), a
// 16-byte cp.async moves 4 or 8 values, and a route still indexes
// elements. ProductLoad widens Ax and x to float, forms and scans the
// products in float32 registers and rounds them to T at the store to
// shared memory, which is where the Pallas kernel writes them (K3's
// windows are moved products; K7's partial stream is the routed scan).
// Each window row is written as 4 values a lane: a float4 or a uint2.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"
#include "values.cuh"

#define SPLIT_THREADS 512
#define SPLIT_WARPS (SPLIT_THREADS / 32)
#define SPLIT_BATCH 4  // window rows a warp loads before it routes them

// Shared memory of a CTA: the staged tile of T, then s1 and s2
template <typename T>
__host__ __device__ constexpr int split_s1_off() { return SPMV_TILE * (int)sizeof(Bits<T>); }
template <typename T>
__host__ __device__ constexpr int split_smem() { return split_s1_off<T>() + SPMV_TILE + SPMV_S2_STAGED; }

// The plan arrays of one pass and the launch's rows per CTA
struct SplitGeom {
  const uint8_t* s1;
  const uint8_t* s2;
  const uint8_t* s3;
  const int32_t* starts;
  int starts_w;
  const int32_t* pos;
  void* out;  // of the epilogue's 4-value type
  int sbt, K, Q;
  int64_t rows_per_g;
  int rows_per_cta;
};

// K5's load policy: the data tile, copied as it is
template <typename T>
struct SplitDataLoad {
  const Bits<T>* data;
  __device__ __forceinline__ void operator()(Bits<T>* vals, int64_t tile,
                                             int tid) const {
    bytes_copy_async(vals, data + tile * SPMV_TILE, SPMV_TILE * (int)sizeof(Bits<T>),
                     tid, SPLIT_THREADS);
  }
};

// K1's load policy: tile w is the x window of rows [g0[w], g0[w] + 128) of
// the natural x table, contiguous and 16-byte aligned (g0[w] * 128 values)
template <typename T>
struct SplitWindowLoad {
  const Bits<T>* xnat;
  const int32_t* g0;
  __device__ __forceinline__ void operator()(Bits<T>* vals, int64_t tile,
                                             int tid) const {
    bytes_copy_async(vals, xnat + (int64_t)__ldg(g0 + tile) * SPMV_LANES,
                     SPMV_TILE * (int)sizeof(Bits<T>), tid, SPLIT_THREADS);
  }
};

// The gather products of K3, K2 and K7: combine(Ax, x2d[xb[tile]*16384 +
// s*128 + q]) for each slot of sublane s, in float32, the ring's identity
// where q < 0.
template <typename T, int RING>
__device__ __forceinline__ float slot_product(float a, int qv, const Bits<T>* xr) {
  return qv < 0 ? Ring<RING>::identity()
                : Ring<RING>::combine(a, Num<T>::widen(__ldg(xr + qv)));
}

// ProductLoad's default `Post`: the products stored as they are (K3).
// A `Post` whose kFlags is true is also given the lane's 4 run-start
// flags (K7).
struct NoPost {
  static constexpr bool kFlags = false;
  __device__ __forceinline__ void operator()(float4&, int) const {}
};

// The load policy of K3, K2 and K7: each thread takes 4 consecutive slots
// of one sublane s, their Ax as one vector (a float4, or a uint2 of four
// 2-byte values) and their q as a char4 (both streamed with __ldcs), and
// their x values from one row of the x window (L2), so a warp forms one
// whole 128-lane row. The products are rounded to T at the store. `Post` turns a
// lane's 4 products into what is stored, given the lane (K2: RowScan in
// stream_kernels.cu, the row's inclusive prefix) and, where Post::kFlags,
// the slots' run-start flags `rs` as a char4, streamed beside q (K7:
// RowSegScan in roll_kernels.cu); K3 and K2 leave `rs` null and never
// read it.
template <typename T, int RING, class Post = NoPost>
struct ProductLoad {
  using P4 = typename Num<T>::Pack4;
  const Bits<T>* x2d;
  const Bits<T>* ax;
  const int8_t* q;
  const int32_t* xb;
  const int8_t* rs = nullptr;
  __device__ __forceinline__ void operator()(Bits<T>* vals, int64_t tile,
                                             int tid) const {
    constexpr int PER = SPMV_TILE / 4 / SPLIT_THREADS;  // quads per thread
    constexpr int HALF = PER / 2;  // quads loaded before any is formed
    const int64_t tb = tile * SPMV_TILE;
    const Bits<T>* xw = x2d + (int64_t)__ldg(xb + tile) * SPMV_TILE;
    const P4* a4 = reinterpret_cast<const P4*>(ax + tb);
    const char4* q4 = reinterpret_cast<const char4*>(q + tb);
    const char4* f4 = reinterpret_cast<const char4*>(rs + tb);
#pragma unroll
    for (int h = 0; h < PER; h += HALF) {
      P4 a[HALF];
      char4 c[HALF];
      char4 f[HALF];
#pragma unroll
      for (int u = 0; u < HALF; ++u) {
        a[u] = __ldcs(a4 + (h + u) * SPLIT_THREADS + tid);
        c[u] = __ldcs(q4 + (h + u) * SPLIT_THREADS + tid);
        if constexpr (Post::kFlags) f[u] = __ldcs(f4 + (h + u) * SPLIT_THREADS + tid);
      }
#pragma unroll
      for (int u = 0; u < HALF; ++u) {
        const int g = (h + u) * SPLIT_THREADS + tid;  // slots 4g .. 4g+3
        const Bits<T>* xr = xw + (g >> 5) * SPMV_LANES;  // their sublane's row
        const float4 av = Num<T>::widen4(a[u]);
        float4 v = make_float4(
            slot_product<T, RING>(av.x, c[u].x, xr), slot_product<T, RING>(av.y, c[u].y, xr),
            slot_product<T, RING>(av.z, c[u].z, xr), slot_product<T, RING>(av.w, c[u].w, xr));
        if constexpr (Post::kFlags)
          Post{}(v, f[u], tid & 31);
        else
          Post{}(v, tid & 31);
        reinterpret_cast<P4*>(vals)[g] = Num<T>::round4(v);
      }
    }
  }
};

// The default epilogue policy: window row R of the routed tile as it is
// (T's bits), from the row's s3 bytes b, each masked by MASK (K7's c3
// keeps a flag in bit 7: SplitCopy<T, 127>). The epilogue is also given
// the tile's s3, s3t, for any other byte it needs.
template <typename T, int MASK = 0xff>
struct SplitCopy {
  __device__ __forceinline__ typename Num<T>::Pack4 operator()(
      const Bits<T>* vals, const uint8_t* st1, const uint8_t* st2, const uint8_t*,
      uchar4 b, int R, int) const {
    return Num<T>::pack4(vals[route_src_staged(st1, st2, b.x & MASK, R)],
                         vals[route_src_staged(st1, st2, b.y & MASK, R)],
                         vals[route_src_staged(st1, st2, b.z & MASK, R)],
                         vals[route_src_staged(st1, st2, b.w & MASK, R)]);
  }
};

// Window rows w0 + u * SPLIT_WARPS (u < SPLIT_BATCH) of one warp: their
// routed-tile rows and s3 bytes
struct SplitBatch {
  int R[SPLIT_BATCH];
  uchar4 b[SPLIT_BATCH];
};

__device__ __forceinline__ SplitBatch split_fetch(const SplitGeom& g,
                                                  const int32_t* st_row,
                                                  const uint8_t* s3t, int w0,
                                                  int w1, int lane) {
  SplitBatch f{};
#pragma unroll
  for (int u = 0; u < SPLIT_BATCH; ++u) {
    const int w = w0 + u * SPLIT_WARPS;
    if (w < w1) {
      const int k = w / g.Q;
      f.R[u] = (st_row ? __ldg(st_row + k) : 0) + w - k * g.Q;
      f.b[u] = __ldcs(reinterpret_cast<const uchar4*>(s3t + f.R[u] * SPMV_LANES) + lane);
    }
  }
  return f;
}

template <typename T, class Load, class Epi = SplitCopy<T>>
__device__ __forceinline__ void split_tile(const SplitGeom& g, const Load& load,
                                           const Epi& epi = Epi{}) {
  extern __shared__ __align__(16) unsigned char split_smem_buf[];
  const Bits<T>* vals = reinterpret_cast<const Bits<T>*>(split_smem_buf);
  uint8_t* st1 = split_smem_buf + split_s1_off<T>();
  uint8_t* st2 = st1 + SPMV_TILE;
  const int t = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t tile = (int64_t)t * g.sbt + j;
  const int64_t tb = tile * SPMV_TILE;

  // (a) the route's first two stages (in whole-tile mode only s2's first
  // Q columns: the routed rows are [0, Q)), (b) the tile's values
  route_stage_async(st1, st2, g.s1, g.s2, tb, tid, SPLIT_THREADS,
                    g.starts ? SPMV_LANES / 4 : (g.Q + 3) / 4);
  load(reinterpret_cast<Bits<T>*>(split_smem_buf), tile, tid);

  // (c) this CTA's window rows [w0, w1), one per warp at a time
  const int w0 = blockIdx.z * g.rows_per_cta;
  const int w1 = min(g.K * g.Q, w0 + g.rows_per_cta);
  const int32_t* st_row =
      g.starts ? g.starts + (int64_t)t * g.starts_w + j * g.K : nullptr;
  const uint8_t* s3t = g.s3 + tb;
  const int64_t out0 =
      (int64_t)(g.pos ? __ldg(g.pos + t) : t) * g.sbt * g.Q + (int64_t)j * g.Q;
  const int stride = SPLIT_WARPS * SPLIT_BATCH;
  SplitBatch cur = split_fetch(g, st_row, s3t, w0 + warp, w1, lane);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();  // both stages and every value are in place
  for (int base = w0 + warp; base < w1; base += stride) {
    const SplitBatch nxt = split_fetch(g, st_row, s3t, base + stride, w1, lane);
#pragma unroll
    for (int u = 0; u < SPLIT_BATCH; ++u) {
      const int w = base + u * SPLIT_WARPS;
      if (w >= w1) break;  // w is the same across the warp
      const int k = w / g.Q, R = cur.R[u];
      auto o = epi(vals, st1, st2, s3t, cur.b[u], R, lane);
      using O = decltype(o);  // 4 values
      reinterpret_cast<O*>(g.out)[((int64_t)k * g.rows_per_g + out0 + (w - k * g.Q)) *
                                      (SPMV_LANES / 4) + lane] = o;
    }
    cur = nxt;
  }
}

// The launch of a pass: grid (n_steps, sbt, CTAs per tile) and the window
// rows each CTA takes (a multiple of SPLIT_WARPS). A pass with fewer tiles
// than SMs splits each tile's rows over enough CTAs for two per SM;
// larger passes take one CTA per tile. Returns cudaErrorInvalidValue on a
// geometry the kernels do not take.
inline cudaError_t split_grid(int n_steps, int sbt, int K, int Q, dim3* grid,
                              int* rows_per_cta) {
  if (n_steps < 0 || sbt < 1 || sbt > 65535 || K < 1 || Q < 1 || Q > SPMV_LANES)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t tiles = (int64_t)n_steps * sbt;
  const int groups = (K * Q + SPLIT_WARPS - 1) / SPLIT_WARPS;
  int64_t split = 1;
  if (tiles > 0 && tiles < sms) split = (2 * sms + tiles - 1) / tiles;
  if (split > groups) split = groups;
  const int per = (int)((groups + split - 1) / split);
  *rows_per_cta = per * SPLIT_WARPS;
  *grid = dim3((unsigned)n_steps, (unsigned)sbt, (unsigned)((groups + per - 1) / per));
  return cudaSuccess;
}

// 16-byte alignment of the pointers the kernels read or write as vectors
inline bool split_aligned(const void* a, const void* b, const void* c,
                          const void* d, const void* e) {
  return (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c | (uintptr_t)d |
           (uintptr_t)e) & 15) == 0;
}
