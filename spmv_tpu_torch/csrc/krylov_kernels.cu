// K15, GMRES's Hessenberg least squares for Hopper. Plain C launcher for
// ctypes; see kernels/krylov.py for the wrapper, its plain PyTorch version
// and the launch counter.
//
// Replaces no pallas_call: the reference solves min ||H y - beta e1|| with
// jnp.linalg.lstsq inside its compiled restart cycle (spmv_tpu/solvers.py:
// gmres, :227), which XLA runs on the device. Here it is one launch a
// cycle, so that a whole cycle is one CUDA graph and no cycle reads the
// host.
//
// What it computes: H (m+1, m) float32, an upper Hessenberg matrix (the
// entries below its subdiagonal are not used), and beta (a 0-d float32) ->
// y (m,) float32, in float64 throughout, for any m >= 1:
//   - Givens rotations, one a column in order, take away H's subdiagonal:
//     rotation j is made from (R[j][j], R[j+1][j]) as r = sqrt(a^2 + b^2),
//     c = a / r, s = b / r (c = 1, s = 0 where r is 0), and applied to rows
//     j and j+1 of the columns after j and of g = beta e1:
//       u' = c u + s v,  v' = (-s) u + c v;
//   - the pivot r_jj of a column is zero when |r_jj| <= (m + 1) * 2^-23 *
//     max |R| (R the upper triangle after the rotations): the reference's
//     SVD cut, rcond = float32 eps * max(m + 1, m), with max |R| in place
//     of the largest singular value. A zero pivot's y_j is 0 and its column
//     is left out of the back-substitution; when the Krylov space closes
//     at step k, H's columns after k are exactly 0, every rotation leaves
//     them 0, and y is the minimum-norm solution the reference's lstsq
//     gives;
//   - back-substitution by columns, from the last: y_j = g_j / r_jj, then
//     g_i -= R[i][j] y_j for every i < j.
// Every operation is rounded once (__dmul_rn, __dadd_rn, ..., no FMA
// contraction), in the order the plain version (`_hessenberg_lstsq_plain`)
// takes, so the two agree bit for bit.
//
// What bounds it on this card: neither bytes nor operations. It reads
// (m+1) m + 1 floats and writes m (4.4 KB at m = 32, 1.3 ns at 3.35 TB/s)
// and does 4 m^2 + 9 m float64 operations. Its time is a dependent chain
// of 2m steps: rotation j needs the pivot a_j that rotation j-1 made (mul,
// mul, add, sqrt, div, then the pair's mul, mul, add), and y_j needs the
// g_j that y_{j+1} updated (div, mul, sub). `k15_chain_probe` runs that
// chain alone in one thread, from registers: the floor of this design.
//
// What the design does about it: one warp, no block barrier. Lane l owns
// the columns l, l + 32, ... in the rotations and the same rows in the
// back-substitution, and rotates (or updates) its own. Only R's strict
// upper triangle goes through memory, from the lane that makes an entry
// (its column's) to the one that reads it (its row's), with the pivots r_j
// and g after the rotations (each entry of g written and read by its
// owner): the work area, in shared memory while it fits (m <= K15_SMEM_M),
// else in a float64 scratch tensor of the wrapper's, in L2; one __syncwarp
// between the two phases.
//   - Up to K15_SMEM_M (7 columns a lane), the carried row (row j as the
//     rotations before j left it) and then g and y live in registers,
//     ceil(m / 32) slots a lane (one body each, so no slot is padding), a
//     slot index fixed at compile time (the loop over a lane's slots is
//     unrolled, so slot j / 32 is a constant in its steps). Every lane
//     runs the chain itself, as the probe does: it makes the next pivot
//     a_{j+1} = (-s_j) u + c_j H[j+1][j+1] (and g_j - R[j][j+1] y_{j+1})
//     from a value u (g_j) that the column's (row's) owner made a step
//     before and one __shfl_sync brought, so no shuffle and no update
//     waits in the chain; a step's updates are issued in the latency of
//     the next step's sqrt (division): no branch splits a step's block
//     (a quotient whose divisor counts as zero is taken and dropped by a
//     select). H's rows come into registers three rows ahead, R's columns
//     one column ahead and the chain's r_j and R[j][j+1] two steps ahead.
//     (Staging H's rows and R's columns through shared-memory rings by
//     cp.async, six and four steps ahead, measured slower on an H100 at
//     700 W: 101 against 74 us at m = 160.)
//   - Past it, the wide body: the work area and the carried row (3 m + m
//     (m-1) / 2 doubles) are the scratch, the carried row and g stay in
//     memory (each lane reads only its own entries), a step's pivot (a_j,
//     or g_j) goes from its owner to every lane by one __shfl_sync, and
//     each lane keeps its first column after j (its first row before j)
//     in a register: the owner of the next pivot has it there. The
//     chain's next H entries, r_j and R[i][j] are loaded a step ahead,
//     and a lane's other columns (rows) kB at a time, every load of a
//     batch before its stores, so that a step waits on L2 once a batch.

#include <cstdint>
#include <cuda_runtime.h>

// 7 columns a lane: the largest m of the register bodies, whose work area is
// in shared memory
#define K15_SMEM_M 224
// the work area at K15_SMEM_M: 2 m + m (m-1) / 2 doubles, 198.6 KB of a block's 227 KB
static_assert((2 * K15_SMEM_M + K15_SMEM_M * (K15_SMEM_M - 1) / 2) * 8 <= 232448, "smem");
// one register body per slot count 1 .. K15_SMEM_M / 32
static_assert(K15_SMEM_M % 32 == 0, "K15_SMEM_M is a whole number of slots");

namespace {

constexpr unsigned kFull = 0xffffffffu;

// |v| as its bits: for values >= 0 the bits order as the values do, and a
// NaN's (its sign cleared) come after +inf's, so an integer max of them is
// max |R| with NaN winning, as torch.amax's, at integer latency
__device__ __forceinline__ unsigned long long k15_abits(double v) {
  return (unsigned long long)__double_as_longlong(fabs(v));
}

// R[i][k], i < k, in R's strict upper triangle stored column by column
__device__ __forceinline__ size_t k15_tri(int i, int k) {
  return (size_t)k * (size_t)(k - 1) / 2 + (size_t)i;
}

// r, c and s of rotation j from its pair (a, b). The quotients are taken
// whatever r is and dropped where it is 0: a select and not a branch, so
// that the divisions share a basic block with the work issued around them
__device__ __forceinline__ void k15_rotation(double a, double b, double& r, double& c,
                                             double& s) {
  r = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
  const double cq = __ddiv_rn(a, r), sq = __ddiv_rn(b, r);
  c = r != 0.0 ? cq : 1.0;
  s = r != 0.0 ? sq : 0.0;
}

// the warp's max |R| (as k15_abits) -> the zero-pivot bound
__device__ __forceinline__ double k15_tol(unsigned long long mx, int m) {
  for (int d = 16; d > 0; d >>= 1) mx = max(mx, __shfl_xor_sync(kFull, mx, d));
  return __dmul_rn((double)(m + 1) * 0x1p-23, __longlong_as_double((long long)mx));
}

// m <= 32 * NC: the carried row, then g and y, in registers, NC slots a lane.
// Every lane runs the chain; a shuffle brings it what an owner made a step
// before (the carried column j+2, row j-1's g), so no shuffle is on the
// chain, and a step's updates sit in the same basic block as the next
// step's sqrt (or division), in its latency. NC = ceil(m / 32), so only
// the last slot can hold columns past m. The work area, in shared memory:
// the pivots (dg), g (gw), then R's triangle, R[i][k] at k (k-1) / 2 + i.
template <int NC>
__device__ __forceinline__ void k15_regs(const float* __restrict__ H,
                                         const float* __restrict__ beta,
                                         float* __restrict__ y, double* dg, int m) {
  double* gw = dg + m;
  double* R = gw + m;
  const int l = threadIdx.x;
  const bool last_in = (NC - 1) * 32 + l < m;  // my column in the last slot is one of H's
  double cr[NC];
  float h0[NC], h1[NC], h2[NC];  // H's rows j+1, j+2, j+3, my columns
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int k = q * 32 + l;
    const bool in = q < NC - 1 || last_in;
    cr[q] = in ? (double)H[k] : 0.0;
    h0[q] = in ? H[m + k] : 0.f;
    h1[q] = in && m >= 2 ? H[2 * m + k] : 0.f;
    h2[q] = in && m >= 3 ? H[3 * m + k] : 0.f;
  }
  const float* hn = H + (size_t)4 * m + l;  // row j+4, my first column
  double r, c, s;
  k15_rotation((double)H[0], (double)H[m], r, c, s);  // rotation 0: (H[0][0], H[1][0])
  // the chain's inputs of rotation j+1, a step ahead: column j+1 as the
  // rotations before j left it, H[j+1][j+1] and H[j+2][j+1]
  double u1 = m > 1 ? (double)H[1] : 0.0;
  double h11 = m > 1 ? (double)H[m + 1] : 0.0;
  double b1 = m > 1 ? (double)H[2 * m + 1] : 0.0;
  double gc = (double)beta[0];  // g_j before rotation j; g_{j+1} is 0 until then
  unsigned long long mx = 0;     // max |R| so far, as k15_abits
#pragma unroll
  for (int cb = 0; cb < NC; ++cb) {
    const int cn = cb + 1 < NC ? cb + 1 : cb;  // the slot after cb
#pragma unroll 1
    for (int jj = 0; jj < 32; ++jj) {
      const int j = cb * 32 + jj;
      if (j >= m) break;
      // the chain: rotation j+1's pair, a = (-s) u1 + c H[j+1][j+1], b = H[j+2][j+1]
      const double a1 = __dadd_rn(__dmul_rn(-s, u1), __dmul_rn(c, h11));
      const double ss = __dadd_rn(__dmul_rn(a1, a1), __dmul_rn(b1, b1));
      // rotation j on my columns k > j (the others' values are never read again)
#pragma unroll
      for (int q = cb; q < NC; ++q) {
        const int k = q * 32 + l;
        const bool on = (q > cb || l > jj) && (q < NC - 1 || last_in);
        const double u = cr[q], v = (double)h0[q];
        const double t = __dadd_rn(__dmul_rn(c, u), __dmul_rn(s, v));
        cr[q] = __dadd_rn(__dmul_rn(-s, u), __dmul_rn(c, v));
        if (on) R[k * (k - 1) / 2 + j] = t;
        mx = max(mx, on ? k15_abits(t) : 0ull);
      }
      if (l == 0) dg[j] = r;
      mx = max(mx, k15_abits(r));
      const double g1 = 0.0;
      const double gj = __dadd_rn(__dmul_rn(c, gc), __dmul_rn(s, g1));
      gc = __dadd_rn(__dmul_rn(-s, gc), __dmul_rn(c, g1));
      if (l == jj) gw[j] = gj;
      // rotation j+2's inputs from column j+2's owner: its carried value, H[j+2][j+2]
      // (row j+2 is h1) and H[j+3][j+2] (h2)
      const bool in2 = jj + 2 < 32;
      const int l2 = (jj + 2) & 31;
      const double u2 = __shfl_sync(kFull, in2 ? cr[cb] : cr[cn], l2);
      const float h22 = __shfl_sync(kFull, in2 ? h1[cb] : h1[cn], l2);
      const float b2 = __shfl_sync(kFull, in2 ? h2[cb] : h2[cn], l2);
      const bool more = j + 4 <= m;
#pragma unroll
      for (int q = cb; q < NC; ++q) {
        h0[q] = h1[q];
        h1[q] = h2[q];
        h2[q] = more && (q < NC - 1 || last_in) ? hn[q * 32] : 0.f;
      }
      hn += m;
      k15_rotation(a1, b1, r, c, s);
      u1 = u2;
      h11 = (double)h22;
      b1 = (double)b2;
    }
  }
  const double tol = k15_tol(mx, m);
  __syncwarp();  // R and the pivots, written by other lanes

  // back-substitution by columns: lane l owns rows l, l + 32, ...; step j
  // makes y_j from y_{j+1} (g_j - R[j][j+1] y_{j+1}, then / r_j) and applies
  // y_{j+1} to the rows below j
  double gr[NC], rc[NC];  // g (then y), R's column j+1, my rows
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int i = q * 32 + l;
    gr[q] = i < m ? gw[i] : 0.0;
    rc[q] = 0.0;
  }
  double gp = gw[m - 1];  // g_j less the y's after j+1, from its owner
  double yp = 0.0;        // y_{j+1}
  bool zp = true;         // y_{j+1}'s pivot was zero (or j + 1 = m)
  // the chain's r_j and R[j][j+1], two steps ahead
  double rj0 = dg[m - 1], rj1 = m >= 2 ? dg[m - 2] : 0.0;
  double rs0 = 0.0, rs1 = m >= 2 ? R[(m - 1) * (m - 2) / 2 + m - 2] : 0.0;
#pragma unroll
  for (int cb = NC - 1; cb >= 0; --cb) {
    const int cp = cb > 0 ? cb - 1 : cb;  // the slot before cb
    const int top = min(31, m - 1 - cb * 32);
#pragma unroll 1
    for (int jj = top; jj >= 0; --jj) {
      const int j = cb * 32 + jj;
      // the chain: g_j, then y_j = g_j / r_j (0 where r_j counts as zero)
      const double gj = zp ? gp : __dsub_rn(gp, __dmul_rn(rs0, yp));
      const bool zero = fabs(rj0) <= tol;
      // R's column j for the next step (my rows below j: every slot before
      // cb, and lanes below jj of slot cb), and the chain's inputs two steps ahead
      const double* cj = R + j * (j - 1) / 2 + l;
      double rn[NC];
#pragma unroll
      for (int q = 0; q <= cb; ++q) rn[q] = q < cb || l < jj ? cj[q * 32] : 0.0;
      const double rj2 = j >= 2 ? dg[j - 2] : 0.0;
      const double rs2 = j >= 2 ? R[(j - 1) * (j - 2) / 2 + j - 2] : 0.0;
      // y_{j+1} on my rows below j
#pragma unroll
      for (int q = cb; q >= 0; --q) {
        const double t = __dsub_rn(gr[q], __dmul_rn(rc[q], yp));
        gr[q] = !zp && (q < cb || l < jj) ? t : gr[q];
      }
      gp = __shfl_sync(kFull, jj >= 1 ? gr[cb] : gr[cp], (jj - 1) & 31);
      const double yq = __ddiv_rn(gj, rj0);
      const double yj = zero ? 0.0 : yq;
      if (l == jj) gr[cb] = yj;
      yp = yj;
      zp = zero;
#pragma unroll
      for (int q = 0; q <= cb; ++q) rc[q] = rn[q];
      rj0 = rj1;
      rj1 = rj2;
      rs0 = rs1;
      rs1 = rs2;
    }
  }
#pragma unroll
  for (int q = 0; q < NC; ++q) {
    const int k = q * 32 + l;
    if (k < m) y[k] = __double2float_rn(gr[q]);
  }
}

// the wide body's batch: a lane's later columns (rows) are loaded kB at a
// time, all before any store, so that a step waits for one round trip to
// L2 per kB of them and not one each
constexpr int kB = 8;

// any m (the launcher takes it past K15_SMEM_M): the work area and the
// carried row after it in the scratch. The chain's next H entries (the
// pair's b, my first column's) and the back-substitution's next r_j and
// R[i][j] are loaded a step ahead.
__device__ __forceinline__ void k15_wide(const float* __restrict__ H,
                                         const float* __restrict__ beta,
                                         float* __restrict__ y, double* work, int m) {
  double* dg = work;
  double* gg = work + m;
  double* R = work + 2 * m;
  double* cr = R + k15_tri(0, m);
  const int l = threadIdx.x;
  for (int k = l; k < m; k += 32) cr[k] = (double)H[k];
  double piv = l < m ? (double)H[l] : 0.0;  // my first column after j - 1, carried
  double gc = (double)beta[0];
  unsigned long long mx = 0;
  int k1 = 1 + ((l - 1) & 31);                    // my first column after j
  double bn = (double)H[m];                        // H[j+1][j]
  double vn = k1 < m ? (double)H[m + k1] : 0.0;    // H[j+1][k1]
  for (int j = 0; j < m; ++j) {
    const int jj = j & 31;
    const float* Hr = H + (size_t)(j + 1) * m;
    const double b = bn, v1 = vn;
    const int k1n = j + 2 + ((l - j - 2) & 31);  // my first column after j + 1
    bn = j + 1 < m ? (double)Hr[m + j + 1] : 0.0;
    vn = k1n < m ? (double)Hr[m + k1n] : 0.0;
    const double u1 = l == jj ? (k1 < m ? cr[k1] : 0.0) : piv;
    const double a = __shfl_sync(kFull, piv, jj);
    double r, c, s;
    k15_rotation(a, b, r, c, s);
    if (k1 < m) {
      const double t = __dadd_rn(__dmul_rn(c, u1), __dmul_rn(s, v1));
      piv = __dadd_rn(__dmul_rn(-s, u1), __dmul_rn(c, v1));
      R[k15_tri(j, k1)] = t;
      cr[k1] = piv;
      mx = max(mx, k15_abits(t));
      for (int k0 = k1 + 32; k0 < m; k0 += 32 * kB) {
        double u[kB], v[kB];
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          const int k = k0 + 32 * q;
          u[q] = k < m ? cr[k] : 0.0;
          v[q] = k < m ? (double)Hr[k] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          const int k = k0 + 32 * q;
          if (k >= m) break;
          const double t2 = __dadd_rn(__dmul_rn(c, u[q]), __dmul_rn(s, v[q]));
          cr[k] = __dadd_rn(__dmul_rn(-s, u[q]), __dmul_rn(c, v[q]));
          R[k15_tri(j, k)] = t2;
          mx = max(mx, k15_abits(t2));
        }
      }
    }
    k1 = k1n;
    if (l == 0) dg[j] = r;
    mx = max(mx, k15_abits(r));
    const double g1 = 0.0;
    const double gj = __dadd_rn(__dmul_rn(c, gc), __dmul_rn(s, g1));
    gc = __dadd_rn(__dmul_rn(-s, gc), __dmul_rn(c, g1));
    if (l == jj) gg[j] = gj;
  }
  const double tol = k15_tol(mx, m);
  __syncwarp();

  const int t0 = m - 1 - ((m - 1 - l) & 31);  // my last row
  double gp = t0 >= 0 ? gg[t0] : 0.0;         // my first row before j + 1, carried
  int i1 = m - 2 - ((m - 2 - l) & 31);        // my first row before j
  double rn = dg[m - 1];                       // r_j
  double r1n = i1 >= 0 ? R[k15_tri(i1, m - 1)] : 0.0;  // R[i1][j]
  for (int j = m - 1; j >= 0; --j) {
    const int jj = j & 31;
    const double rj = rn, r1 = r1n;
    const int i1n = j - 2 - ((j - 2 - l) & 31);  // my first row before j - 1
    rn = j >= 1 ? dg[j - 1] : 0.0;
    r1n = i1n >= 0 ? R[k15_tri(i1n, j - 1)] : 0.0;
    const double u1 = l == jj ? (i1 >= 0 ? gg[i1] : 0.0) : gp;
    const bool zero = fabs(rj) <= tol;
    const double gj = __shfl_sync(kFull, gp, jj);
    const double yq = __ddiv_rn(gj, rj);  // taken always, dropped by a select
    const double yj = zero ? 0.0 : yq;
    if (l == jj) y[j] = __double2float_rn(yj);
    gp = u1;
    if (!zero && i1 >= 0) {
      gp = __dsub_rn(u1, __dmul_rn(r1, yj));
      gg[i1] = gp;
      for (int i0 = i1 - 32; i0 >= 0; i0 -= 32 * kB) {
        double g[kB], rr[kB];
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          const int i = i0 - 32 * q;
          g[q] = i >= 0 ? gg[i] : 0.0;
          rr[q] = i >= 0 ? R[k15_tri(i, j)] : 0.0;
        }
#pragma unroll
        for (int q = 0; q < kB; ++q) {
          const int i = i0 - 32 * q;
          if (i < 0) break;
          gg[i] = __dsub_rn(g[q], __dmul_rn(rr[q], yj));
        }
      }
    }
    i1 = i1n;
  }
}

// NC = 0 is the wide body
template <int NC>
__global__ void __launch_bounds__(32, 1)
    hessenberg_lstsq_kernel(const float* __restrict__ H, const float* __restrict__ beta,
                            float* __restrict__ y, double* scratch, int m) {
  extern __shared__ double k15_smem[];
  if constexpr (NC == 0)
    k15_wide(H, beta, y, scratch, m);
  else
    k15_regs<NC>(H, beta, y, k15_smem, m);
}

// K15's chain alone, in one thread, from registers: m rotation steps (a ->
// r = sqrt(a a + b b) -> c = a / r, s = b / r -> a = c p + s q), then m
// back-substitution steps (g -> e - f (g / d), which adds e to g at the
// constants of kernels/krylov.py:_K15_CHAIN, so that g counts the steps).
// out = (a, g).
__global__ void k15_chain_probe(double* out, int m, double a, double b, double p, double q,
                                double d, double e, double f) {
  for (int j = 0; j < m; ++j) {
    const double r = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
    const double c = __ddiv_rn(a, r), s = __ddiv_rn(b, r);
    a = __dadd_rn(__dmul_rn(c, p), __dmul_rn(s, q));
  }
  double g = a;
  for (int j = 0; j < m; ++j) g = __dsub_rn(e, __dmul_rn(f, __ddiv_rn(g, d)));
  out[0] = a;
  out[1] = g;
}

template <int NC>
cudaError_t k15_launch(const float* H, const float* beta, float* y, double* scratch, int m,
                       size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hessenberg_lstsq_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  hessenberg_lstsq_kernel<NC><<<1, 32, smem, stream>>>(H, beta, y, scratch, m);
  return cudaGetLastError();
}

}  // namespace

// Doubles of float64 scratch K15 takes at m: none where the work area is in
// shared memory (m <= K15_SMEM_M), else the work area and the carried row,
// 3 m + m (m-1) / 2 (kernels/krylov.py:_k15_scratch asks here)
extern "C" int64_t spmv_k15_scratch_doubles(int32_t m) {
  return m <= K15_SMEM_M ? 0 : 3 * (int64_t)m + (int64_t)m * (m - 1) / 2;
}

// scratch: at least spmv_k15_scratch_doubles(m) doubles (null where that is 0)
extern "C" int spmv_hessenberg_lstsq(const float* H, const float* beta, float* y,
                                     double* scratch, int64_t scratch_doubles, int32_t m,
                                     void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  const int64_t need = spmv_k15_scratch_doubles(m);
  if (need > 0 && (scratch == nullptr || scratch_doubles < need))
    return (int)cudaErrorInvalidValue;
  const size_t smem = need > 0 ? 0 : sizeof(double) * (2 * (size_t)m + (size_t)m * (m - 1) / 2);
  // ceil(m / 32) slots a lane, none of them padding; 0: the wide body
  using Launch = cudaError_t (*)(const float*, const float*, float*, double*, int, size_t,
                                 cudaStream_t);
  static const Launch launch[K15_SMEM_M / 32 + 1] = {
      k15_launch<0>, k15_launch<1>, k15_launch<2>, k15_launch<3>,
      k15_launch<4>, k15_launch<5>, k15_launch<6>, k15_launch<7>};
  const int nc = need > 0 ? 0 : (m + 31) / 32;
  return (int)launch[nc](H, beta, y, scratch, m, smem, (cudaStream_t)stream);
}

extern "C" int spmv_k15_chain_probe(double* out, int32_t m, double a, double b, double p,
                                    double q, double d, double e, double f, void* stream) {
  if (m < 1) return (int)cudaErrorInvalidValue;
  k15_chain_probe<<<1, 1, 0, (cudaStream_t)stream>>>(out, (int)m, a, b, p, q, d, e, f);
  return (int)cudaGetLastError();
}
