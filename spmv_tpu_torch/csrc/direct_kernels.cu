// Direct-tier kernels of the ELL kinds, for Hopper: K9 (planned paged
// gather of x) and K11 (ELL group reduce), each instantiated per value
// type (values.cuh: float32, bfloat16, float16), K11 also per ring. Plain
// C launchers for ctypes; see kernels/pgather.py and kernels/ell.py for
// the wrappers, their plain PyTorch versions and the launch counters.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "route3.cuh"
#include "values.cuh"

// ---------------------------------------------------------------------------
// K9: replaces spmv_tpu/kernels/pgather.py:243 _pgather_pass (pallas_call
// at :258), body _pgather_kernel (:190).
//
// Output position (c, r, col) of chunk c: for each round rr whose route
// marks it live (bit 7 of s3), the route (s3 & 0x7f) names its slot
// (s, l) of tile c*R + rr, and the value is x[qhi*16384 + qlo*128 + s]
// (0 where qhi < 0, an empty slot). Rounds own disjoint positions; a
// position live in no round gets 0.
//
// The TPU kernel sweeps every window of the transposed x table per chunk,
// because a TPU core cannot gather from arbitrary addresses. Here x is
// read in natural order, and stays in the card's 50 MB L2 for the plans'
// x sizes, so the window sweep and its schedule (pages, pmask) are not
// needed.
//
// What bounds it: bytes. Per slot and round the plan holds 8 bytes (qhi
// 4, qlo, s1, s2, s3 1 each); per position one x value is read and one
// output written (4 bytes each in float32, 2 in bfloat16 and float16: a
// 2-byte gather moves 12 of the float32 one's 16 bytes a position). A
// thread per output position that follows the route through device
// memory (the first design) makes five dependent reads at
// scattered addresses (s2, s1, qhi, qlo, x), each fetching a 32-byte
// sector for 1-4 useful bytes: about five times the bytes the bound
// counts move from L2 to the SMs.
//
// The design moves every plan byte once, coalesced, and keeps the
// route's dependent reads on chip. One CTA of 1024 threads owns one
// chunk; for each round (a) each thread loads its four quads of qhi
// (int4), qlo and s3 (uchar4) and 16 bytes each of the s1 and s2 stages,
// all at once; (b) the slot pass, in slot order, reads each live slot's
// x value (the only scattered read, one per slot) into a 64 KB shared
// array (32 KB of 2-byte values), and the stages go to shared memory;
// after a barrier (c) the position pass takes each live position's value
// through the route from shared memory. Values move as their bits
// (Num<T>::Bits), never widened. Round 0 writes every position of the
// chunk with 4-value stores (a float4, or a uint2 of 2-byte values; 0
// where not live); later rounds write their live positions
// only, from the same threads, so program order leaves the live round's
// value. Plan bytes and the output are read and written with the
// streaming (.cs) policy, evicted first from L2, which leaves x there.
//
// Shared memory: the slot values 64 KB (32 KB of 2-byte values), s1 16 KB, s2 16.5 KB (rows of
// 128 route bytes padded to 132: a warp's 32 lanes read one column r of
// s2 across rows k, which an unpadded 128-byte row would put in one
// bank). What keeps it above its bound is the x reads' latency, waited
// out once per round in each CTA. Staging the plan with cp.async, two
// CTAs of 512 per SM, or a persistent CTA that double-buffers the next
// tile all ran slower on the card.
// ---------------------------------------------------------------------------
#define K9_THREADS 1024
#define K9_QUADS (SPMV_TILE / 4)  // 4096 groups of 4 slots or positions
#define K9_PER_THREAD (K9_QUADS / K9_THREADS)
#define K9_S1_BYTES SPMV_TILE
static_assert(K9_THREADS * 16 == SPMV_TILE,
              "each thread stages one 16-byte piece of s1 and of s2");

template <typename T>
constexpr int k9_smem() {
  return SPMV_TILE * (int)sizeof(Bits<T>) + K9_S1_BYTES + SPMV_S2_STAGED;
}

// the bits of the x value of slot (s, l) with window hi and in-window
// lane lo; 0 (the bits of +0 in every value type) on an empty slot
template <typename T>
__device__ __forceinline__ Bits<T> k9_slot(const Bits<T>* __restrict__ x,
                                           int64_t n_x, int hi, int lo, int s) {
  const int64_t e = (int64_t)hi * SPMV_TILE + (int64_t)lo * SPMV_LANES + s;
  return (hi >= 0 && e < n_x) ? __ldg(x + e) : Bits<T>(0);
}

template <typename T>
__global__ void __launch_bounds__(K9_THREADS, 1)
    pgather_kernel(const Bits<T>* __restrict__ x, int64_t n_x,
                   const uint8_t* __restrict__ qlo,
                   const int32_t* __restrict__ qhi,
                   const uint8_t* __restrict__ s1,
                   const uint8_t* __restrict__ s2,
                   const uint8_t* __restrict__ s3, Bits<T>* __restrict__ out,
                   int R) {
  using P4 = typename Num<T>::Pack4;
  using B = Bits<T>;
  extern __shared__ __align__(16) unsigned char k9_smem_buf[];
  P4* vals = reinterpret_cast<P4*>(k9_smem_buf);
  uint8_t* st1 = k9_smem_buf + SPMV_TILE * sizeof(B);
  uint8_t* st2 = st1 + K9_S1_BYTES;
  const int t = threadIdx.x;
  const int64_t c = blockIdx.x;
  P4* out4 = reinterpret_cast<P4*>(out + c * SPMV_TILE);
  for (int rr = 0; rr < R; ++rr) {
    const int64_t tb = (c * R + rr) * SPMV_TILE;
    // (a) every plan read of the tile in flight at once; the quads of
    // thread t are g = j * K9_THREADS + t, its stage bytes 16t .. 16t+15
    int4 h[K9_PER_THREAD];
    uchar4 lo[K9_PER_THREAD], b[K9_PER_THREAD];
    const int4* qh4 = reinterpret_cast<const int4*>(qhi + tb);
    const uchar4* ql4 = reinterpret_cast<const uchar4*>(qlo + tb);
    const uchar4* b4 = reinterpret_cast<const uchar4*>(s3 + tb);
#pragma unroll
    for (int j = 0; j < K9_PER_THREAD; ++j) {
      h[j] = __ldcs(qh4 + j * K9_THREADS + t);
      lo[j] = __ldcs(ql4 + j * K9_THREADS + t);
      b[j] = __ldcs(b4 + j * K9_THREADS + t);
    }
    const uint4 w1 = __ldcs(reinterpret_cast<const uint4*>(s1 + tb) + t);
    const uint4 w2 = __ldcs(reinterpret_cast<const uint4*>(s2 + tb) + t);
    // (b) the slot pass: slots 4g .. 4g+3 all lie in sublane s = g / 32
#pragma unroll
    for (int j = 0; j < K9_PER_THREAD; ++j) {
      const int g = j * K9_THREADS + t;
      const int s = g >> 5;
      vals[g] = Num<T>::pack4(k9_slot<T>(x, n_x, h[j].x, lo[j].x, s),
                              k9_slot<T>(x, n_x, h[j].y, lo[j].y, s),
                              k9_slot<T>(x, n_x, h[j].z, lo[j].z, s),
                              k9_slot<T>(x, n_x, h[j].w, lo[j].w, s));
    }
    reinterpret_cast<uint4*>(st1)[t] = w1;
    uint32_t* d2 = reinterpret_cast<uint32_t*>(st2 + (t >> 3) * SPMV_S2_PITCH +
                                               16 * (t & 7));
    d2[0] = w2.x;
    d2[1] = w2.y;
    d2[2] = w2.z;
    d2[3] = w2.w;
    __syncthreads();  // every slot value and both stages are in place
    // (c) the position pass: positions 4g .. 4g+3 all lie in row r = g / 32
    const B* v = reinterpret_cast<const B*>(vals);
#pragma unroll
    for (int j = 0; j < K9_PER_THREAD; ++j) {
      const int g = j * K9_THREADS + t;
      const int r = g >> 5;
      const uchar4 q = b[j];
      const B vx = (q.x & 0x80) ? v[route_src_staged(st1, st2, q.x & 0x7f, r)] : B(0);
      const B vy = (q.y & 0x80) ? v[route_src_staged(st1, st2, q.y & 0x7f, r)] : B(0);
      const B vz = (q.z & 0x80) ? v[route_src_staged(st1, st2, q.z & 0x7f, r)] : B(0);
      const B vw = (q.w & 0x80) ? v[route_src_staged(st1, st2, q.w & 0x7f, r)] : B(0);
      if (rr == 0) {
        __stcs(out4 + g, Num<T>::pack4(vx, vy, vz, vw));
      } else {
        B* o = reinterpret_cast<B*>(out4 + g);
        if (q.x & 0x80) __stcs(o, vx);
        if (q.y & 0x80) __stcs(o + 1, vy);
        if (q.z & 0x80) __stcs(o + 2, vz);
        if (q.w & 0x80) __stcs(o + 3, vw);
      }
    }
    __syncthreads();  // the next round rewrites the stages and the values
  }
}

// ---------------------------------------------------------------------------
// K11: replaces spmv_tpu/kernels/ell.py:184 _ell_spmv_device (pallas_call
// at :205), body _group_reduce_kernel (:138).
//
// Each 128-lane row of the (rows, 128) product stream holds 128/W groups
// of W lanes; each group is reduced to one value, its leader, in the
// reference's order:
//   linear    acc = v[0]; acc = reduce(acc, v[d]) for d = 1 .. W-1;
//   tree      for d = W/2, ..., 1: lane j < d of the group takes
//             reduce(v[j], v[j+d]), and the leader is lane 0;
//   broadcast the tree's leader (the reference then copies it to every
//             lane of the group, which nothing reads).
// The output holds the leaders only, (rows, 128/W), in the order of the
// reference's reduced[:, ::W].
//
// What bounds it: bytes (the product stream read once, the leaders
// written once). The design: each thread loads 4 consecutive lanes in one
// access (a float4, or a uint2 of 2-byte values widened to float), so a
// warp holds one row, and each warp loads its K11_ROWS rows
// before it reduces any. A group never leaves its warp (W <= 128), so no
// shared memory and no barrier is needed. Lanes 4t .. 4t+3 of a thread
// fold in the thread; across the W/4 threads of a group:
//   linear  the group's first thread folds its own four values in order,
//           then takes the next threads' float4s by __shfl_down_sync, in
//           order;
//   tree    each step d >= 4 is a __shfl_down_sync by d/4 threads,
//           component-wise (threads of the group below d/4 keep the
//           result); steps d = 2 and d = 1 run in the thread, as
//           (x + z, y + w) and then their sum.
// Both are the plain version's order with ring.cuh's round-to-nearest
// operations in float32, so every ring gives its bits. Each leader is
// rounded to the value type once, where it is written: 4 values a thread
// at W = 1, 2 at W = 2, else one from each group's first thread.
// ---------------------------------------------------------------------------
#define SPMV_GR_LINEAR 0
#define SPMV_GR_TREE 1
#define SPMV_GR_BROADCAST 2
#define K11_THREADS 256
#define K11_ROWS 4  // rows per warp

__device__ __forceinline__ float4 k11_shfl_down(float4 v, int d) {
  v.x = __shfl_down_sync(0xffffffffu, v.x, d);
  v.y = __shfl_down_sync(0xffffffffu, v.y, d);
  v.z = __shfl_down_sync(0xffffffffu, v.z, d);
  v.w = __shfl_down_sync(0xffffffffu, v.w, d);
  return v;
}

template <int RING>
__device__ __forceinline__ float k11_leader(float4 v, int tg, int strategy) {
  using Rg = Ring<RING>;
  if (strategy == SPMV_GR_LINEAR) {
    float acc = Rg::reduce(Rg::reduce(Rg::reduce(v.x, v.y), v.z), v.w);
    for (int d = 1; d < tg; ++d) {
      const float4 n = k11_shfl_down(v, d);
      acc = Rg::reduce(Rg::reduce(Rg::reduce(Rg::reduce(acc, n.x), n.y), n.z), n.w);
    }
    return acc;
  }
  for (int d = tg >> 1; d >= 1; d >>= 1) {
    const float4 n = k11_shfl_down(v, d);
    v = make_float4(Rg::reduce(v.x, n.x), Rg::reduce(v.y, n.y),
                    Rg::reduce(v.z, n.z), Rg::reduce(v.w, n.w));
  }
  return Rg::reduce(Rg::reduce(v.x, v.z), Rg::reduce(v.y, v.w));
}

template <typename T, int RING>
__global__ void __launch_bounds__(K11_THREADS)
    group_reduce_kernel(const typename Num<T>::Pack4* __restrict__ prod,
                        Bits<T>* __restrict__ out, int64_t n_rows, int W,
                        int strategy) {
  using Rg = Ring<RING>;
  const int lane = threadIdx.x & 31;
  const int64_t row0 =
      (((int64_t)blockIdx.x * K11_THREADS + threadIdx.x) >> 5) * K11_ROWS;
  float4 v[K11_ROWS];
#pragma unroll
  for (int i = 0; i < K11_ROWS; ++i)
    if (row0 + i < n_rows) v[i] = Num<T>::widen4(__ldg(prod + (row0 + i) * 32 + lane));
  const int tg = W >> 2;  // threads per group, W >= 4
#pragma unroll
  for (int i = 0; i < K11_ROWS; ++i) {
    const int64_t row = row0 + i;
    if (row >= n_rows) break;  // the same for the whole warp
    if (W == 1) {
      reinterpret_cast<typename Num<T>::Pack4*>(out)[row * 32 + lane] = Num<T>::round4(v[i]);
    } else if (W == 2) {
      reinterpret_cast<typename Num<T>::Pack2*>(out)[row * 32 + lane] =
          Num<T>::round2(Rg::reduce(v[i].x, v[i].y), Rg::reduce(v[i].z, v[i].w));
    } else {
      const float acc = k11_leader<RING>(v[i], tg, strategy);
      if ((lane & (tg - 1)) == 0)
        out[row * (SPMV_LANES / W) + lane / tg] = Num<T>::round(acc);
    }
  }
}

template <typename T>
int launch_pgather(const void* x, int64_t n_x, const uint8_t* qlo,
                   const int32_t* qhi, const uint8_t* s1, const uint8_t* s2,
                   const uint8_t* s3, void* out, int C, int R,
                   cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      pgather_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, k9_smem<T>());
  if (e != cudaSuccess) return (int)e;
  if (C > 0) {
    pgather_kernel<T><<<C, K9_THREADS, k9_smem<T>(), stream>>>(
        static_cast<const Bits<T>*>(x), n_x, qlo, qhi, s1, s2, s3,
        static_cast<Bits<T>*>(out), R);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_group_reduce(const void* prod, void* out, int64_t n_rows, int W,
                        int strategy, int ring, cudaStream_t stream) {
  const int64_t rows_per_block = (K11_THREADS / 32) * K11_ROWS;
  const unsigned blocks = (unsigned)((n_rows + rows_per_block - 1) / rows_per_block);
#define SPMV_LAUNCH_K11(R)                                                \
  group_reduce_kernel<T, R><<<blocks, K11_THREADS, 0, stream>>>(          \
      static_cast<const typename Num<T>::Pack4*>(prod),                   \
      static_cast<Bits<T>*>(out), n_rows, W, strategy)
  SPMV_RING_SWITCH(ring, SPMV_LAUNCH_K11)
#undef SPMV_LAUNCH_K11
  return (int)cudaGetLastError();
}

extern "C" {

int spmv_pgather(const void* x, int64_t n_x, const uint8_t* qlo,
                 const int32_t* qhi, const uint8_t* s1, const uint8_t* s2,
                 const uint8_t* s3, void* out, int32_t C, int32_t R,
                 int32_t dtype, void* stream) {
  if (C < 0 || R < 1) return (int)cudaErrorInvalidValue;
  // 16-byte plan loads and stage stores, 4-value output stores
  if (((uintptr_t)qlo | (uintptr_t)qhi | (uintptr_t)s1 | (uintptr_t)s2 |
       (uintptr_t)s3 | (uintptr_t)out) % 16)
    return (int)cudaErrorMisalignedAddress;
#define SPMV_LAUNCH_T(T)                                                  \
  return launch_pgather<T>(x, n_x, qlo, qhi, s1, s2, s3, out, C, R,       \
                           (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

int spmv_group_reduce(const void* prod, void* out, int32_t n_tiles,
                      int32_t W, int32_t strategy, int32_t dtype,
                      int32_t ring, void* stream) {
  if (W < 1 || W > SPMV_LANES || (W & (W - 1)) || strategy < 0 ||
      strategy > SPMV_GR_BROADCAST || n_tiles < 0)
    return (int)cudaErrorInvalidValue;
  // one 4-value load a thread (16 bytes, or 8 of 2-byte values)
  if ((uintptr_t)prod % 16 || (uintptr_t)out % 16) return (int)cudaErrorMisalignedAddress;
  const int64_t n_rows = (int64_t)n_tiles * 8;
  if (n_rows <= 0) return (int)cudaGetLastError();
#define SPMV_LAUNCH_T(T)                                                   \
  return launch_group_reduce<T>(prod, out, n_rows, W, strategy, ring,      \
                                (cudaStream_t)stream)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_T)
#undef SPMV_LAUNCH_T
}

}  // extern "C"
