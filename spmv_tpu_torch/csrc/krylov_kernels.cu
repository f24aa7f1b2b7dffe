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
// entries below its subdiagonal are not read), and beta (a 0-d float32) ->
// y (m,) float32, in float64 throughout:
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
// and does 4 m^2 + 9 m float64 operations; its time is the chain of m
// rotation steps and m back-substitution steps, each behind one barrier of
// one CTA, on top of one launch.
//
// What the design does about it: one CTA of 32 * ceil((m+1)/32) threads,
// H staged once in shared memory in float64; thread t owns the columns
// t, t + blockDim, ... in the rotation steps and the same rows in the
// back-substitution, so each step needs one barrier: every thread computes
// the step's rotation (or y_j) itself from values the step before made,
// and a step writes only entries no thread reads in that step (the pivot
// r_j goes to its own array, not over R[j][j]).

#include <cstdint>
#include <cuda_runtime.h>

#define K15_MAX_M 160  // (m+1) m + 3 m + 33 doubles of shared memory: 210 KB at 160

namespace {

__device__ __forceinline__ double k15_max(double a, double b) {
  return (b > a || b != b) ? b : a;  // NaN wins, as torch.amax
}

__global__ void hessenberg_lstsq_kernel(const float* __restrict__ H,
                                        const float* __restrict__ beta,
                                        float* __restrict__ y, int m) {
  extern __shared__ double k15_smem[];
  double* R = k15_smem;        // (m+1) x m, row-major
  double* diag = R + (m + 1) * m;  // the pivots r_j
  double* g = diag + m;        // m + 1
  double* yv = g + (m + 1);    // m
  double* red = yv + m;        // one partial max a warp
  const int t = threadIdx.x, nt = blockDim.x;
  for (int i = t; i < (m + 1) * m; i += nt) R[i] = (double)H[i];
  for (int i = t; i < m + 1; i += nt) g[i] = i == 0 ? (double)beta[0] : 0.0;
  __syncthreads();

  // the rotations, one a column: thread t updates its columns k > j
  for (int j = 0; j < m; ++j) {
    const double a = R[j * m + j], b = R[(j + 1) * m + j];
    const double r = __dsqrt_rn(__dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b)));
    const double c = r != 0.0 ? __ddiv_rn(a, r) : 1.0;
    const double s = r != 0.0 ? __ddiv_rn(b, r) : 0.0;
    for (int k = t; k < m; k += nt) {
      if (k <= j) continue;
      const double u = R[j * m + k], v = R[(j + 1) * m + k];
      R[j * m + k] = __dadd_rn(__dmul_rn(c, u), __dmul_rn(s, v));
      R[(j + 1) * m + k] = __dadd_rn(__dmul_rn(-s, u), __dmul_rn(c, v));
    }
    if (t == 0) {
      diag[j] = r;
      const double u = g[j], v = g[j + 1];
      g[j] = __dadd_rn(__dmul_rn(c, u), __dmul_rn(s, v));
      g[j + 1] = __dadd_rn(__dmul_rn(-s, u), __dmul_rn(c, v));
    }
    __syncthreads();
  }

  // max |R| over the pivots and the strict upper triangle
  double mx = 0.0;
  for (int k = t; k < m; k += nt) {
    mx = k15_max(mx, fabs(diag[k]));
    for (int i = 0; i < k; ++i) mx = k15_max(mx, fabs(R[i * m + k]));
  }
  for (int d = 16; d > 0; d >>= 1) mx = k15_max(mx, __shfl_xor_sync(0xffffffffu, mx, d));
  if ((t & 31) == 0) red[t >> 5] = mx;
  __syncthreads();
  mx = 0.0;
  for (int w = 0; w < nt / 32; ++w) mx = k15_max(mx, red[w]);
  const double tol = __dmul_rn((double)(m + 1) * 0x1p-23, mx);

  // back-substitution by columns: thread t owns rows t, t + nt, ...
  for (int j = m - 1; j >= 0; --j) {
    const double rjj = diag[j];
    const bool zero = fabs(rjj) <= tol;
    const double yj = zero ? 0.0 : __ddiv_rn(g[j], rjj);
    if (t == 0) yv[j] = yj;
    if (!zero)
      for (int i = t; i < j; i += nt) g[i] = __dsub_rn(g[i], __dmul_rn(R[i * m + j], yj));
    __syncthreads();
  }
  for (int i = t; i < m; i += nt) y[i] = __double2float_rn(yv[i]);
}

}  // namespace

extern "C" int spmv_hessenberg_lstsq(const float* H, const float* beta, float* y,
                                     int32_t m, void* stream) {
  if (m < 1 || m > K15_MAX_M) return (int)cudaErrorInvalidValue;
  const int threads = 32 * ((m + 1 + 31) / 32);
  const size_t smem = sizeof(double) * ((size_t)(m + 1) * m + 3 * (size_t)m + 1 + 32);
  cudaError_t e = cudaFuncSetAttribute(hessenberg_lstsq_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  hessenberg_lstsq_kernel<<<1, threads, smem, (cudaStream_t)stream>>>(H, beta, y, (int)m);
  return (int)cudaGetLastError();
}
