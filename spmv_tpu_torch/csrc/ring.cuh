// The semirings as device types, for the kernels that are instantiated
// per ring (K2, K3, K4, K7, K8, K10, K11, K11', K12, K13). Each ring gives
// its identity, combine(a_ij, x_j) and reduce(earlier, later), in float32.
// The codes of the built-in rings match ops/semiring.py:DEVICE_RINGS, which
// picks the instantiation by object identity at the C launcher
// (SPMV_RING_SWITCH). A user-defined ring is Ring<SPMV_RING_USER>, written
// by ops/ring_codegen.py into a header that defines SPMV_RING_USER before
// it includes this file; a library built with it (kernels/_cuda.py:
// ring_lib) instantiates the kernels for that ring alone.
//
// Products and sums use the round-to-nearest intrinsics, which nvcc
// never contracts into a fused multiply-add: a kernel gives the same
// float32 values as its plain PyTorch version on the same operands.
// min and max propagate NaN, as torch.minimum and torch.maximum do.
#pragma once

#define SPMV_RING_PLUS_TIMES 0
#define SPMV_RING_MIN_PLUS 1
#define SPMV_RING_MAX_TIMES 2
#define SPMV_RING_OR_AND 3
#define SPMV_RING_OR_AND_COUNT 4

__device__ __forceinline__ float spmv_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float spmv_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float spmv_or_and(float a, float x) {
  return (a != 0.f && x != 0.f) ? 1.f : 0.f;
}

// torch.minimum / torch.maximum / torch.fmin / torch.fmax as a user
// ring's traced body calls them (ops/ring_codegen.py): NaN as torch
// propagates it (fmin and fmax drop it), and of two equal operands (+0 and
// -0) the first, as torch returns it.
__device__ __forceinline__ float spmv_tmin(float a, float b) {
  return (b != b || b < a) ? b : a;
}

__device__ __forceinline__ float spmv_tmax(float a, float b) {
  return (b != b || b > a) ? b : a;
}

__device__ __forceinline__ float spmv_tfmin(float a, float b) {
  return (a != a || b < a) ? b : a;
}

__device__ __forceinline__ float spmv_tfmax(float a, float b) {
  return (a != a || b > a) ? b : a;
}

template <int RING>
struct Ring;

template <>
struct Ring<SPMV_RING_PLUS_TIMES> {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ float reduce(float e, float l) {
    return __fadd_rn(e, l);
  }
};

template <>
struct Ring<SPMV_RING_MIN_PLUS> {
  static __device__ __forceinline__ float identity() { return __int_as_float(0x7f800000); }
  static __device__ __forceinline__ float combine(float a, float x) {
    return __fadd_rn(a, x);
  }
  static __device__ __forceinline__ float reduce(float e, float l) {
    return spmv_min(e, l);
  }
};

template <>
struct Ring<SPMV_RING_MAX_TIMES> {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float x) {
    return __fmul_rn(a, x);
  }
  static __device__ __forceinline__ float reduce(float e, float l) {
    return spmv_max(e, l);
  }
};

template <>
struct Ring<SPMV_RING_OR_AND> {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float x) {
    return spmv_or_and(a, x);
  }
  static __device__ __forceinline__ float reduce(float e, float l) {
    return spmv_max(e, l);
  }
};

// or-and as a counting ring: {0,1} products summed (thresholded later)
template <>
struct Ring<SPMV_RING_OR_AND_COUNT> {
  static __device__ __forceinline__ float identity() { return 0.f; }
  static __device__ __forceinline__ float combine(float a, float x) {
    return spmv_or_and(a, x);
  }
  static __device__ __forceinline__ float reduce(float e, float l) {
    return __fadd_rn(e, l);
  }
};

// Run LAUNCH(R) with R the compile-time ring of the runtime code `ring`;
// an unknown code returns cudaErrorInvalidValue from the launcher. A
// user ring's library knows that ring alone.
#ifdef SPMV_RING_USER
#define SPMV_RING_SWITCH(ring, LAUNCH)                   \
  switch (ring) {                                        \
    case SPMV_RING_USER: LAUNCH(SPMV_RING_USER); break;  \
    default: return (int)cudaErrorInvalidValue;          \
  }
#else
#define SPMV_RING_SWITCH(ring, LAUNCH)                   \
  switch (ring) {                                        \
    case SPMV_RING_PLUS_TIMES: LAUNCH(SPMV_RING_PLUS_TIMES); break;     \
    case SPMV_RING_MIN_PLUS: LAUNCH(SPMV_RING_MIN_PLUS); break;         \
    case SPMV_RING_MAX_TIMES: LAUNCH(SPMV_RING_MAX_TIMES); break;       \
    case SPMV_RING_OR_AND: LAUNCH(SPMV_RING_OR_AND); break;             \
    case SPMV_RING_OR_AND_COUNT: LAUNCH(SPMV_RING_OR_AND_COUNT); break; \
    default: return (int)cudaErrorInvalidValue;          \
  }
#endif

// (value, run-start flag) scan operator of a segmented scan, earlier
// operand first: the later value restarts the run if it is flagged.
template <int RING>
__device__ __forceinline__ void seg_combine(float ev, bool ef, float& lv,
                                            bool& lf) {
  if (!lf) lv = Ring<RING>::reduce(ev, lv);
  lf = lf || ef;
}

// Inclusive segmented scan of one (value, flag) pair per lane across a
// full warp, lane order = scan order.
template <int RING>
__device__ __forceinline__ void warp_seg_scan(float& v, bool& f, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float nv = __shfl_up_sync(0xffffffffu, v, d);
    const bool nf = __shfl_up_sync(0xffffffffu, (int)f, d) != 0;
    if (lane >= d) seg_combine<RING>(nv, nf, v, f);
  }
}
