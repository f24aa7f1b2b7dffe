// Value types of every kernel but K2 and K6: float, __nv_bfloat16 and
// __half, the dtypes the reference's kernels take.
//
// A kernel handles a value only as its bit pattern (Num<T>::Bits), loads
// it, widens it to float, combines and reduces in float32 registers (K10
// sums in float64), and rounds to T (round to nearest even) exactly where
// the Pallas kernel writes an array of the value dtype: K1's x table, K3's
// and K5's windows, K4's products, K7's partial stream, K8's and K10's y
// windows, K9's gathered values, K11's and K11''s leaders, K12's y and
// K13's window products. Widening is exact, so a move (K1, K5, K9) gives
// the input's bits. A bf16 or f16 value array takes half the bytes of a
// float32 one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

// The dtype codes of kernels/_cuda.py:DTYPE_CODES
#define SPMV_F32 0
#define SPMV_BF16 1
#define SPMV_F16 2
// Integer values, which K13 and K16 alone take (the window `spmm` and the
// row folds of integer A and x)
#define SPMV_I32 3
#define SPMV_I64 4

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Bits = float;
  using Pack4 = float4;  // 4 consecutive values, one 16-byte access
  using Pack2 = float2;  // 2 consecutive values, one 8-byte access
  static __device__ __forceinline__ float widen(float b) { return b; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float4 widen4(float4 p) { return p; }
  static __device__ __forceinline__ float4 round4(float4 v) { return v; }
  static __device__ __forceinline__ float4 pack4(float a, float b, float c, float d) {
    return make_float4(a, b, c, d);
  }
  static __device__ __forceinline__ float2 round2(float a, float b) {
    return make_float2(a, b);
  }
};

// The two 2-byte types: 4 values are one 8-byte uint2, value 0 in the low
// half of .x (little-endian, as the tensor stores them); 2 values one
// 32-bit word
template <class Self>
struct Num16 {
  using Bits = unsigned short;
  using Pack4 = uint2;
  using Pack2 = unsigned;
  static __device__ __forceinline__ float4 widen4(uint2 p) {
    return make_float4(Self::widen(p.x & 0xffffu), Self::widen(p.x >> 16),
                       Self::widen(p.y & 0xffffu), Self::widen(p.y >> 16));
  }
  static __device__ __forceinline__ uint2 pack4(unsigned short a, unsigned short b,
                                                unsigned short c, unsigned short d) {
    return make_uint2((unsigned)a | ((unsigned)b << 16), (unsigned)c | ((unsigned)d << 16));
  }
  static __device__ __forceinline__ uint2 round4(float4 v) {
    return pack4(Self::round(v.x), Self::round(v.y), Self::round(v.z), Self::round(v.w));
  }
  static __device__ __forceinline__ unsigned round2(float a, float b) {
    return (unsigned)Self::round(a) | ((unsigned)Self::round(b) << 16);
  }
};

template <>
struct Num<__nv_bfloat16> : Num16<Num<__nv_bfloat16>> {
  static __device__ __forceinline__ float widen(unsigned b) {
    return __uint_as_float(b << 16);
  }
  static __device__ __forceinline__ unsigned short round(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

template <>
struct Num<__half> : Num16<Num<__half>> {
  static __device__ __forceinline__ float widen(unsigned b) {
    return __half2float(__ushort_as_half((unsigned short)b));
  }
  static __device__ __forceinline__ unsigned short round(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

template <typename T>
using Bits = typename Num<T>::Bits;

// Run LAUNCH(T) with T the value type of the runtime code `dtype`; an
// unknown code returns cudaErrorInvalidValue from the launcher.
#define SPMV_DTYPE_SWITCH(dtype, LAUNCH)                  \
  switch (dtype) {                                        \
    case SPMV_F32: LAUNCH(float); break;                  \
    case SPMV_BF16: LAUNCH(__nv_bfloat16); break;         \
    case SPMV_F16: LAUNCH(__half); break;                 \
    default: return (int)cudaErrorInvalidValue;           \
  }
