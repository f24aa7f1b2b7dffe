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
// thread evaluates it for its own output slot: no transposes, no
// shared-memory staging of the stages (a tile's three stages are 48 KB,
// which stay in L1/L2 while the block works on the tile).
#pragma once

#include <cstdint>

#define SPMV_LANES 128
#define SPMV_TILE (SPMV_LANES * SPMV_LANES)

// Flat in-tile source position (row * 128 + col) that the route
// (s1, s2, s3) delivers to output slot (r, c). `s3_mask` strips flag
// bits a plan keeps in the last stage (K2's c3 carries one in bit 7).
__device__ __forceinline__ int route_src(const uint8_t* __restrict__ s1,
                                         const uint8_t* __restrict__ s2,
                                         const uint8_t* __restrict__ s3,
                                         int r, int c, int s3_mask = 0xff) {
  const int k = s3[r * SPMV_LANES + c] & s3_mask;
  const int r1 = s2[k * SPMV_LANES + r];
  const int c1 = s1[r1 * SPMV_LANES + k];
  return r1 * SPMV_LANES + c1;
}
