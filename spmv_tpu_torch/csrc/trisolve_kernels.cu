// Level-scheduled triangular solve K14 for Hopper, instantiated per value
// type (values.cuh: float32, bfloat16, float16) and for one CTA or a
// thread-block cluster. Plain C launcher for ctypes; see kernels/trisolve.py
// for the wrapper (`_sptrsv_pass`), its plain PyTorch version, the host's
// schedule (`_k14_schedule`) and the launch counter.
//
// Replaces no pallas_call: it is the counterpart of the reference's
// compiled device loop, the `lax.scan` over the levels in
// spmv_tpu/kernels/trisolve.py:151 (step :141-149). The solve plan packs
// the rows of each wavefront level into one (n_levels, PL, W) envelope;
// level by level, in order, each row slot s of level l computes
//   acc = sum_w vals[l, s, w] * x[cols[l, s, w]]   (w = 0, 1, ..., in order)
//   x[row] = (b[row] - acc) / diag[l, s]
// where padding slots (cols 0, vals 0) still multiply 0 * x[0], so that NaN
// and +-inf spread as in the reference. A padding row (rows == -1) would
// write only slot n of the (n + 1)-slot x, which nothing reads.
//
// What bounds it on this card: the chain of levels. The bytes (the
// triangle's own 29.3 MB for poisson2d(1024)'s L, 8.8 us at 3.35 TB/s) are
// small against n_levels dependent steps (2047 for that L), each at least a
// barrier and one trip to L2 for the x values the level reads
// (`k14_chain_probe` times that chain alone); on one SM, a wide level's
// scattered x, b and x-store accesses, each its own L1 line.
//
// What the design does about it:
// - The host walks the plan once (`_k14_schedule`) into steps: each level's
//   live slots (up to its last row >= 0), cut into chunks of C * S slots
//   for a cluster of C CTAs that each take S slots a step, one slot a
//   thread, and each slot's W entries into chunks of at most K14_WREG.
//   Padding rows past a level's live width are never walked. A level
//   wider than the cluster is walked chunk by chunk.
// - The plan never depends on x, so each thread loads its slot's plan for
//   step i + 1 (cols, vals, diag) and its row for step i + 2 into registers
//   at the top of step i, beside step i's x loads, and b[row] for step i + 1
//   as soon as that row is in. Only a level's last step ends in a barrier;
//   when it does, the next level's plan is already in flight or in, so a
//   level waits for one round trip, its x values. The plan's loads and b's
//   pass the L1 by (ld.global.cg), which keeps the x values the last level
//   wrote (a level of poisson2d(1024)'s L writes 1024 lines of them).
//   Staging the plan in shared memory by bulk copies (cp.async.bulk) from
//   producer threads, or by 16-byte cp.async from every thread, was tried
//   first: on the H100 issuing the copies took longer than a narrow
//   level's step (PERF.md, §6).
// - One CTA (C = 1) keeps the levels apart by __syncthreads(); a cluster by
//   barrier.cluster.arrive.release / wait.acquire, reading x with
//   ld.global.cg so that no CTA reads a stale line of its own L1.
// - Each row is summed by one thread in slot order from w = 0 in float32
//   with round-to-nearest intrinsics (no FMA contracts acc + v * x) and
//   divided with __fdiv_rn, so the result equals the plain version's bit
//   for bit; 2-byte values are widened on load and x is rounded once where
//   it is written. Within a level no slot reads a row the level writes,
//   except W-padding entries reading x[0]: the level that writes row 0 (l0,
//   found on the host) writes it only after the level's last step, behind
//   one more barrier across the CTA or cluster, so those reads see x[0] as
//   it was before the level, as the reference's scan step does.

#include <cuda_runtime.h>

#include <cstdint>

#include "values.cuh"

#define K14_MAX_THREADS 1024
#define K14_MAX_CLUSTER 8
#define K14_WREG 4       // a slot's entries a step, held in registers
#define K14_STEP_INTS 8  // a step: level, s0, s1, w0, w1, last of its level, 0, 0

__device__ __forceinline__ uint32_t k14_cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

template <bool kCluster>
__device__ __forceinline__ void k14_sync() {
  if constexpr (kCluster) {
    __syncwarp();
    asm volatile(
        "barrier.cluster.arrive.release.aligned;\n\t"
        "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    __syncthreads();
  }
}

template <bool kCluster, typename V>
__device__ __forceinline__ V k14_load_x(const V* p) {
  if constexpr (kCluster) {
    return __ldcg(p);
  } else {
    return *p;
  }
}

// A step's record as a thread sees it: the level, this CTA's first slot,
// the entries w0 .. w1 - 1, whether it ends its level, and whether this
// thread has a slot in it
struct K14Step {
  int lvl, a, w0, w1, last;
  bool mine;
};

// A thread's slot of a step: its entries' columns and values, and where the
// step finishes the row, the diagonal, the row and b[row]
struct K14Slot {
  int c[K14_WREG];
  float v[K14_WREG];
  float d, b;
  int row;
};

template <typename T, bool kCluster>
__global__ void __launch_bounds__(K14_MAX_THREADS)
    sptrsv_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
                  const Bits<T>* __restrict__ vals, const Bits<T>* __restrict__ diag,
                  const Bits<T>* __restrict__ b, Bits<T>* x, const int32_t* __restrict__ steps,
                  int n_steps, int PL, int W, int64_t n, int l0, int S) {
  using V = Bits<T>;
  const int tid = threadIdx.x;
  const int rank = kCluster ? (int)k14_cta_rank() : 0;
  auto record = [&](int i) {
    K14Step s;
    const int4 r0 = __ldg(reinterpret_cast<const int4*>(steps + (int64_t)i * K14_STEP_INTS));
    const int2 r1 = __ldg(reinterpret_cast<const int2*>(steps + (int64_t)i * K14_STEP_INTS + 4));
    s.lvl = r0.x;
    s.a = r0.y + rank * S;
    s.w0 = r0.w;
    s.w1 = r1.x;
    s.last = r1.y;
    s.mine = tid < min(r0.z - s.a, S);
    // keep the records a few steps on in the L1
    if (i + 8 < n_steps)
      asm volatile("prefetch.global.L1 [%0];\n" ::"l"(steps + (int64_t)(i + 8) * K14_STEP_INTS));
    return s;
  };
  auto slot_of = [&](const K14Step& s) { return (int64_t)s.lvl * PL + s.a + tid; };
  // this thread's plan of step s: its entries and, where s finishes the
  // row, the diagonal (the row and b come apart, earlier)
  auto load_plan = [&](const K14Step& s, K14Slot& p) {
    if (!s.mine) return;
    const int64_t slot = slot_of(s), ent = slot * W + s.w0;
    const int m = s.w1 - s.w0;
#pragma unroll
    for (int k = 0; k < K14_WREG; ++k)
      if (k < m) {
        p.c[k] = __ldcg(cols + ent + k);
        p.v[k] = Num<T>::widen(__ldcg(vals + ent + k));
      }
    if (s.w1 == W) p.d = Num<T>::widen(__ldcg(diag + slot));
  };
  auto load_row = [&](const K14Step& s) {
    return s.mine && s.w1 == W ? __ldcg(rows + slot_of(s)) : 0;
  };
  auto load_b = [&](const K14Step& s, int row) {
    return s.mine && s.w1 == W ? Num<T>::widen(__ldcg(b + (row >= 0 ? row : 0))) : 0.f;
  };

  // x[0] is read by W-padding entries before row 0 is written; every other
  // slot of x below n is written before any level reads it
  if (rank == 0 && tid == 0) x[0] = V(0);
  // step 0's plan, row and b, and step 1's row, before the first step
  K14Step s_cur = record(0);
  K14Step s_nxt = n_steps > 1 ? record(1) : s_cur;
  K14Slot p_cur, p_nxt;
  load_plan(s_cur, p_cur);
  p_cur.row = load_row(s_cur);
  p_cur.b = load_b(s_cur, p_cur.row);
  int row_nxt = n_steps > 1 ? load_row(s_nxt) : 0;
  k14_sync<kCluster>();

  float acc = 0.f, x0 = 0.f;
  bool has0 = false;
  for (int i = 0; i < n_steps; ++i) {
    // step i + 1's plan and b[row], and step i + 2's row, in flight
    // beside step i's x loads
    K14Step s_far = s_nxt;
    int row_far = 0;
    if (i + 1 < n_steps) {
      load_plan(s_nxt, p_nxt);
      p_nxt.row = row_nxt;
      p_nxt.b = load_b(s_nxt, row_nxt);
      if (i + 2 < n_steps) {
        s_far = record(i + 2);
        row_far = load_row(s_far);
      }
    }
    if (s_cur.mine) {
      if (s_cur.w0 == 0) acc = 0.f;
      const int m = s_cur.w1 - s_cur.w0;
      float xx[K14_WREG];
#pragma unroll
      for (int k = 0; k < K14_WREG; ++k)
        if (k < m) xx[k] = Num<T>::widen(k14_load_x<kCluster>(x + p_cur.c[k]));
#pragma unroll
      for (int k = 0; k < K14_WREG; ++k)
        if (k < m) acc = __fadd_rn(acc, __fmul_rn(p_cur.v[k], xx[k]));
      if (s_cur.w1 == W) {
        const float xi = __fdiv_rn(__fsub_rn(p_cur.b, acc), p_cur.d);
        if (p_cur.row == 0) {
          has0 = true;
          x0 = xi;
        } else {
          x[p_cur.row >= 0 ? p_cur.row : n] = Num<T>::round(xi);
        }
      }
    }
    if (s_cur.last) {  // the same for every thread of the CTA or cluster
      if (s_cur.lvl == l0) {
        k14_sync<kCluster>();
        if (has0) x[0] = Num<T>::round(x0);
        has0 = false;
      }
      k14_sync<kCluster>();
    }
    s_cur = s_nxt;
    p_cur = p_nxt;
    s_nxt = s_far;
    row_nxt = row_far;
  }
}

// The chain K14's levels cannot beat on a geometry: n_levels steps, each
// one barrier (across the CTA, or the cluster) and one load of the value
// another thread wrote before it (another CTA's, in a cluster). At step
// l >= 1, thread (l / C) % T of CTA l % C writes x[l] = x[l - 1] + 1, so x
// ends as 0, 1, ..., n_levels - 1.
template <bool kCluster>
__global__ void __launch_bounds__(K14_MAX_THREADS) k14_chain_probe(float* x, int n_levels) {
  const int C = kCluster ? (int)gridDim.x : 1;
  const int rank = kCluster ? (int)k14_cta_rank() : 0;
  if (rank == 0 && threadIdx.x == 0) x[0] = 0.f;
  k14_sync<kCluster>();
  for (int l = 1; l < n_levels; ++l) {
    if (rank == l % C && (int)threadIdx.x == (l / C) % (int)blockDim.x)
      x[l] = k14_load_x<kCluster>(x + l - 1) + 1.f;
    k14_sync<kCluster>();
  }
}

template <typename K, typename... Args>
static cudaError_t k14_launch(K kernel, int cluster, int threads, cudaStream_t stream,
                              Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

extern "C" int spmv_sptrsv(const int32_t* rows, const int32_t* cols, const void* vals,
                           const void* diag, const void* b, void* x, const int32_t* steps,
                           int32_t n_steps, int32_t n_levels, int32_t PL, int32_t W, int64_t n,
                           int32_t l0, int32_t cluster, int32_t threads, int32_t S, int32_t Wc,
                           int32_t dtype, void* stream) {
  if (n_levels < 0 || PL < 1 || W < 1 || n < 0 || n >= INT32_MAX || n_steps < 0 ||
      cluster < 1 || cluster > K14_MAX_CLUSTER || threads < 32 || threads > K14_MAX_THREADS ||
      threads % 32 || S < 1 || S > threads || Wc < 1 || Wc > K14_WREG ||
      (n > 0 && n_steps == 0))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)steps & 15) return (int)cudaErrorInvalidValue;  // int4 records
  if (n == 0) return 0;
  cudaError_t e = cudaSuccess;
#define SPMV_LAUNCH_K14(T)                                                                 \
  e = cluster > 1                                                                          \
          ? k14_launch(sptrsv_kernel<T, true>, cluster, threads, (cudaStream_t)stream,     \
                       rows, cols, static_cast<const Bits<T>*>(vals),                      \
                       static_cast<const Bits<T>*>(diag), static_cast<const Bits<T>*>(b),  \
                       static_cast<Bits<T>*>(x), steps, (int)n_steps, (int)PL, (int)W, n,  \
                       (int)l0, (int)S)                                                    \
          : k14_launch(sptrsv_kernel<T, false>, 1, threads, (cudaStream_t)stream, rows,    \
                       cols, static_cast<const Bits<T>*>(vals),                            \
                       static_cast<const Bits<T>*>(diag), static_cast<const Bits<T>*>(b),  \
                       static_cast<Bits<T>*>(x), steps, (int)n_steps, (int)PL, (int)W, n,  \
                       (int)l0, (int)S)
  SPMV_DTYPE_SWITCH(dtype, SPMV_LAUNCH_K14)
#undef SPMV_LAUNCH_K14
  return (int)e;
}

extern "C" int spmv_k14_chain_probe(float* x, int32_t n_levels, int32_t cluster,
                                    int32_t threads, void* stream) {
  if (n_levels < 1 || cluster < 1 || cluster > K14_MAX_CLUSTER || threads < 32 ||
      threads > K14_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  return (int)(cluster > 1
                   ? k14_launch(k14_chain_probe<true>, cluster, threads, (cudaStream_t)stream,
                                x, (int)n_levels)
                   : k14_launch(k14_chain_probe<false>, 1, threads, (cudaStream_t)stream, x,
                                (int)n_levels));
}
