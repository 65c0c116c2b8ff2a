// Shared helpers of the port's Hopper kernels: element types, 16-byte
// loads, rounding to the activation dtype, floor modulo, warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)

template <typename T> struct Ty;

template <> struct Ty<float> {
  static __device__ __forceinline__ float to_f(float x) { return x; }
  static __device__ __forceinline__ float from_f(float x) { return x; }
  // two neighbouring elements; p must be 8-byte aligned
  static __device__ __forceinline__ float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};

template <> struct Ty<__nv_bfloat16> {
  static __device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_f(float x) { return __float2bfloat16(x); }
  // two neighbouring elements; p must be 4-byte aligned
  static __device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

// 8 consecutive elements as floats, in one 16-byte load (bf16) or two
// (f32); p must be 16-byte (bf16) or 32-byte (f32) aligned.
template <typename T> struct Load8;
template <> struct Load8<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Load8<float> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
    o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
  }
};

// Round a float to T's precision (round to nearest even) and back: the
// kernels keep values in float registers but round wherever the plain
// PyTorch version stores a tensor in the activation dtype.
template <typename T>
__device__ __forceinline__ float rnd(float x) { return Ty<T>::to_f(Ty<T>::from_f(x)); }

// Python/JAX/torch `%`: the result takes the divisor's sign.  C++'s `%`
// truncates toward zero, so (-1) % w is -1 here but w - 1 in the reference.
__device__ __forceinline__ int floormod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Largest dynamic shared memory a block may use on sm_90.
constexpr int MAX_SMEM = 232448;
