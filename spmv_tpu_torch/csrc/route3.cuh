// route3: the 3-stage in-tile route of ops/routing.py, as a device
// function, shared by the stream kernels.
//
// Replaces spmv_tpu/kernels/pallas_utils.py:212 route3_batched, which
// runs a lane gather, a transpose, a lane gather, a transpose and a
// lane gather inside one (128,128) tile. Composed, that is
//
//   out[r, c] = v[s2[k, r], s1[s2[k, r], k]]   with k = s3[r, c],
//
// so each output element reads three stage bytes and one value. A
// thread evaluates it for its own output slot, with no transposes.
// Followed through device memory that is four dependent trips to L2 per
// element, since the CTAs resident on an SM each work on another tile
// and L1 keeps none of them. So every kernel stages s1 and s2 in shared
// memory and follows the route there (route_src_staged): K1, K2, K3, K5
// and K7 (split_tile.cuh), K6 (stream_kernels.cu), K8 (roll_kernels.cu),
// K9 (direct_kernels.cu) and K10 (merge_kernels.cu).
#pragma once

#include <cstdint>

#define SPMV_LANES 128
#define SPMV_TILE (SPMV_LANES * SPMV_LANES)

// s2's rows staged in shared memory are padded from 128 to 132 bytes: the
// staged route reads one column r of s2 across rows k, which unpadded
// rows put in one bank.
#define SPMV_S2_PITCH 132
#define SPMV_S2_STAGED (SPMV_LANES * SPMV_S2_PITCH)

// The flat in-tile source position (row * 128 + col) that the route
// delivers to output slot (r, c), against the staged stages st1 (128 x
// 128 bytes) and st2 (pitch SPMV_S2_PITCH), given k = s3[r, c] (a
// kernel masks off any flag bit its plan keeps in s3 first)
__device__ __forceinline__ int route_src_staged(const uint8_t* st1,
                                                const uint8_t* st2, int k,
                                                int r) {
  const int r1 = st2[k * SPMV_S2_PITCH + r];
  return r1 * SPMV_LANES + st1[r1 * SPMV_LANES + k];
}

// One cp.async into shared memory: 16 bytes past L1, or 4 bytes
__device__ __forceinline__ void spmv_cp_async(void* dst, const void* src,
                                              int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Start the cp.async copies of one tile's s1 and s2 (from s1 + tb and
// s2 + tb) into st1 and st2, spread over `n` threads; the caller waits
// (cp.async.wait_all) and synchronises before it reads them. Only the
// first 4 * s2_quads columns of s2 are staged: a kernel that routes only
// rows [0, Q) reads no other column.
__device__ __forceinline__ void route_stage_async(uint8_t* st1, uint8_t* st2,
                                                  const uint8_t* s1,
                                                  const uint8_t* s2,
                                                  int64_t tb, int tid, int n,
                                                  int s2_quads = SPMV_LANES / 4) {
  for (int i = tid; i < SPMV_TILE / 16; i += n)
    spmv_cp_async(st1 + 16 * i, s1 + tb + 16 * i, 16);
  for (int i = tid; i < SPMV_TILE / 4; i += n)
    if ((i & 31) < s2_quads)
      spmv_cp_async(st2 + (i >> 5) * SPMV_S2_PITCH + 4 * (i & 31), s2 + tb + 4 * i, 4);
}

// Start the 16-byte cp.async copies of one tile's 16384 floats from src
// into dst, spread over `n` threads; the caller waits as above
__device__ __forceinline__ void tile_copy_async(float* dst, const float* src,
                                                int tid, int n) {
  for (int i = tid; i < SPMV_TILE / 4; i += n)
    spmv_cp_async(dst + 4 * i, src + 4 * i, 16);
}
