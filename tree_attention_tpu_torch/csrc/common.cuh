// Shared device helpers of the attention kernels: per-lane vector loads that
// widen bf16/f32 rows to f32 registers, int8 lines packed in one 32-bit word,
// the store back to the output dtype, the P-rounding to V's dtype, and warp
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ta {

constexpr float kNegInf = -INFINITY;

// N contiguous elements at p (N*sizeof(T)-byte aligned) into f32 registers.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[N]) {
  if constexpr (N == 4) {
    float4 x = *reinterpret_cast<const float4*>(p);
    o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
  } else if constexpr (N == 2) {
    float2 x = *reinterpret_cast<const float2*>(p);
    o[0] = x.x; o[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = p[i];
  }
}

template <int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[N]) {
  if constexpr (N == 4) {
    uint2 u = *reinterpret_cast<const uint2*>(p);
    float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  } else if constexpr (N == 2) {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    o[0] = a.x; o[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __bfloat162float(p[i]);
  }
}

// N contiguous elements held in their storage type (half the registers of
// f32 for bf16) until unpacked: lets a warp keep more K/V lines in flight.
template <typename T, int N>
struct Line;

template <>
struct Line<__nv_bfloat16, 4> {
  uint2 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ void zero() { u = make_uint2(0u, 0u); }
  __device__ __forceinline__ void unpack(float (&o)[4]) const {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

template <>
struct Line<__nv_bfloat16, 2> {
  uint32_t u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = *reinterpret_cast<const uint32_t*>(p);
  }
  __device__ __forceinline__ void zero() { u = 0u; }
  __device__ __forceinline__ void unpack(float (&o)[2]) const {
    float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
    o[0] = a.x; o[1] = a.y;
  }
};

template <int N>
struct Line<float, N> {
  float f[N];
  __device__ __forceinline__ void load(const float* p) { load_vec<N>(p, f); }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = 0.f;
  }
  __device__ __forceinline__ void unpack(float (&o)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = f[i];
  }
};

// int8 lines: N <= 4 codes in the low bytes of one word (zero above), so a
// lane's share of a K row is one load and one __dp4a against a Q word.
template <int N>
struct Line<int8_t, N> {
  static_assert(N == 2 || N == 4, "int8 lines hold 2 or 4 codes");
  uint32_t u;
  __device__ __forceinline__ void load(const int8_t* p) {
    if constexpr (N == 4) {
      u = *reinterpret_cast<const uint32_t*>(p);
    } else {
      u = *reinterpret_cast<const uint16_t*>(p);
    }
  }
  __device__ __forceinline__ void zero() { u = 0u; }
  __device__ __forceinline__ void unpack(float (&o)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i)
      o[i] = static_cast<float>(static_cast<int>(u << (24 - 8 * i)) >> 24);
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// P is cast to V's dtype before the P.V product (f32 accumulation after).
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
// int8 V is cast to bf16 (exact for [-127, 127]), so P rounds to bf16.
__device__ __forceinline__ float round_as(float x, const int8_t*) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int warp_sum(int x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace ta
