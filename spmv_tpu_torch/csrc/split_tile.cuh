// The body shared by the split passes K5 (shuffle_kernels.cu) and K3
// (gather_kernels.cu), and by the x prep K1 and the early row reduction
// K2 (stream_kernels.cu): stage one input tile in shared memory, follow
// the route there, write the tile's quota windows.
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
// to output row t*128 + r (K2: Q = Qp, output row t*Qp + r).
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
//       coalesced sweep (ProductLoad), and K2 scans each row of them in
//       registers before it stores them (ProductLoad's `Post`);
//   (c) a warp takes one window row at a time, each lane 4 consecutive
//       columns: the s3 bytes as one uchar4 (streamed, the only device
//       read of the phase), s2, s1 and the value from shared memory, one
//       float4 written. The next rows' s3 loads start before the
//       current rows are routed, the first batch before the staging wait.
//       The epilogue policy makes the float4 from the routed row: K1, K3
//       and K5 copy it (SplitCopy), K2 subtracts each slot's flat
//       predecessor (RunDiff in stream_kernels.cu).
// A launch with fewer tiles than SMs splits each tile's K*Q window rows
// over several CTAs (split_grid), each staging the whole tile again from
// L2, so that the card is filled.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"

#define SPLIT_THREADS 512
#define SPLIT_WARPS (SPLIT_THREADS / 32)
#define SPLIT_BATCH 4  // window rows a warp loads before it routes them
#define SPLIT_S1_OFF (SPMV_TILE * (int)sizeof(float))
#define SPLIT_S2_OFF (SPLIT_S1_OFF + SPMV_TILE)
#define SPLIT_SMEM (SPLIT_S2_OFF + SPMV_S2_STAGED)

// The plan arrays of one pass and the launch's rows per CTA
struct SplitGeom {
  const uint8_t* s1;
  const uint8_t* s2;
  const uint8_t* s3;
  const int32_t* starts;
  int starts_w;
  const int32_t* pos;
  float* out;
  int sbt, K, Q;
  int64_t rows_per_g;
  int rows_per_cta;
};

// K5's load policy: the data tile, copied as it is
struct SplitDataLoad {
  const float* data;
  __device__ __forceinline__ void operator()(float* vals, int64_t tile,
                                             int tid) const {
    tile_copy_async(vals, data + tile * SPMV_TILE, tid, SPLIT_THREADS);
  }
};

// K1's load policy: tile w is the x window of rows [g0[w], g0[w] + 128) of
// the natural x table, contiguous and 16-byte aligned (g0[w] * 512 bytes)
struct SplitWindowLoad {
  const float* xnat;
  const int32_t* g0;
  __device__ __forceinline__ void operator()(float* vals, int64_t tile,
                                             int tid) const {
    tile_copy_async(vals, xnat + (int64_t)__ldg(g0 + tile) * SPMV_LANES, tid,
                    SPLIT_THREADS);
  }
};

// The gather products of K3 and K2: combine(Ax, x2d[xb[tile]*16384 +
// s*128 + q]) for each slot of sublane s, the ring's identity where q < 0.
template <int RING>
__device__ __forceinline__ float slot_product(float a, int qv, const float* xr) {
  return qv < 0 ? Ring<RING>::identity() : Ring<RING>::combine(a, __ldg(xr + qv));
}

// ProductLoad's default `Post`: the products stored as they are (K3)
struct NoPost {
  __device__ __forceinline__ void operator()(float4&, int) const {}
};

// The load policy of K3 and K2: each thread takes 4 consecutive slots of
// one sublane s, their Ax as a float4 and their q as a char4 (both
// streamed with __ldcs), and their x values from one 512-byte row of the
// x window (L2), so a warp forms one whole 128-lane row. `Post` turns a
// lane's 4 products into what is stored, given the lane (K2: RowScan in
// stream_kernels.cu, the row's inclusive prefix).
template <int RING, class Post = NoPost>
struct ProductLoad {
  const float* x2d;
  const float* ax;
  const int8_t* q;
  const int32_t* xb;
  __device__ __forceinline__ void operator()(float* vals, int64_t tile,
                                             int tid) const {
    constexpr int PER = SPMV_TILE / 4 / SPLIT_THREADS;  // quads per thread
    constexpr int HALF = PER / 2;  // quads loaded before any is formed
    const int64_t tb = tile * SPMV_TILE;
    const float* xw = x2d + (int64_t)__ldg(xb + tile) * SPMV_TILE;
    const float4* a4 = reinterpret_cast<const float4*>(ax + tb);
    const char4* q4 = reinterpret_cast<const char4*>(q + tb);
#pragma unroll
    for (int h = 0; h < PER; h += HALF) {
      float4 a[HALF];
      char4 c[HALF];
#pragma unroll
      for (int u = 0; u < HALF; ++u) {
        a[u] = __ldcs(a4 + (h + u) * SPLIT_THREADS + tid);
        c[u] = __ldcs(q4 + (h + u) * SPLIT_THREADS + tid);
      }
#pragma unroll
      for (int u = 0; u < HALF; ++u) {
        const int g = (h + u) * SPLIT_THREADS + tid;  // slots 4g .. 4g+3
        const float* xr = xw + (g >> 5) * SPMV_LANES;  // their sublane's row
        float4 v = make_float4(
            slot_product<RING>(a[u].x, c[u].x, xr), slot_product<RING>(a[u].y, c[u].y, xr),
            slot_product<RING>(a[u].z, c[u].z, xr), slot_product<RING>(a[u].w, c[u].w, xr));
        Post{}(v, tid & 31);
        reinterpret_cast<float4*>(vals)[g] = v;
      }
    }
  }
};

// The default epilogue policy: window row R of the routed tile as it is,
// from the row's s3 bytes b (the epilogue is also given the tile's s3,
// s3t, for any other byte it needs)
struct SplitCopy {
  __device__ __forceinline__ float4 operator()(const float* vals, const uint8_t* st1,
                                               const uint8_t* st2, const uint8_t*,
                                               uchar4 b, int R, int) const {
    return make_float4(vals[route_src_staged(st1, st2, b.x, R)],
                       vals[route_src_staged(st1, st2, b.y, R)],
                       vals[route_src_staged(st1, st2, b.z, R)],
                       vals[route_src_staged(st1, st2, b.w, R)]);
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

template <class Load, class Epi = SplitCopy>
__device__ __forceinline__ void split_tile(const SplitGeom& g, const Load& load,
                                           const Epi& epi = Epi{}) {
  extern __shared__ __align__(16) unsigned char split_smem[];
  const float* vals = reinterpret_cast<const float*>(split_smem);
  uint8_t* st1 = split_smem + SPLIT_S1_OFF;
  uint8_t* st2 = split_smem + SPLIT_S2_OFF;
  const int t = blockIdx.x, j = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int64_t tile = (int64_t)t * g.sbt + j;
  const int64_t tb = tile * SPMV_TILE;

  // (a) the route's first two stages (in whole-tile mode only s2's first
  // Q columns: the routed rows are [0, Q)), (b) the tile's values
  route_stage_async(st1, st2, g.s1, g.s2, tb, tid, SPLIT_THREADS,
                    g.starts ? SPMV_LANES / 4 : (g.Q + 3) / 4);
  load(reinterpret_cast<float*>(split_smem), tile, tid);

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
      const float4 o = epi(vals, st1, st2, s3t, cur.b[u], R, lane);
      reinterpret_cast<float4*>(
          g.out + ((int64_t)k * g.rows_per_g + out0 + (w - k * g.Q)) * SPMV_LANES)[lane] = o;
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
