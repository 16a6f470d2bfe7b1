// Shared helpers of the paged-attention kernels (sm_90a; bf16 queries and
// outputs, a bf16 or an e4m3 KV cache, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swiftllm {

typedef __nv_bfloat16 bf16;
typedef __nv_fp8_storage_t fp8;  // one e4m3 byte of an fp8 KV cache

// Finite stand-in for -inf in the online softmax: exp(kNegBig - m) is exactly
// 0 for any real score m, and kNegBig - kNegBig is 0, never NaN.
constexpr float kNegBig = -1e30f;

// Lanes a cache row carries past its K and V halves. An fp8 row ends in 128
// scale lanes: lane 2*KH holds the token's K scale and lane 2*KH+1 its V
// scale (powers of two, themselves e4m3), the rest zero. The stored values
// are the true ones TIMES the scale.
template <typename KV> struct ScaleLanes { static constexpr int value = 0; };
template <> struct ScaleLanes<fp8> { static constexpr int value = 128; };

// The GQA group bound an attention kernel is compiled for: the least of 1,
// 2, 4, 8 at or above the group n_q / n_kv (the kernels take the real group
// as an argument), or 0 for a shape they cannot take (a group that is not a
// whole number from 1 to 8). ops/paged_attention.py:group_bound is the
// host's copy.
inline int gqa_bound(int n_q, int n_kv) {
  if (n_kv < 1 || n_q < n_kv || n_q % n_kv) return 0;
  const int group = n_q / n_kv;
  return group == 1 ? 1 : group <= 2 ? 2 : group <= 4 ? 4 : group <= 8 ? 8 : 0;
}

// x rounded to the nearest bf16 (ties to even), back in an f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float fp8_to_float(fp8 b) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// 1 / scale of a stored scale byte. A slot never written holds scale 0; the
// guard keeps its inverse finite (such a slot is never a visible key).
__device__ __forceinline__ float inv_scale(fp8 b) {
  return __frcp_rn(fmaxf(fp8_to_float(b), 1e-20f));  // = 1.f / x, rounded alike
}

// Eight bf16 (one 16-byte load) -> eight floats.
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Eight e4m3 bytes (one 8-byte load) -> eight floats, converted in registers
// (e4m3 -> f16 is exact).
__device__ __forceinline__ void load8(const fp8* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3)));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// Eight cache elements as eight bf16 in one uint4, for staging into shared
// memory (e4m3 -> bf16 is exact: 3 mantissa bits into 7).
__device__ __forceinline__ uint4 load8_bf16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ uint4 load8_bf16(const fp8* p) {
  float f[8];
  load8(p, f);
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// Cache row (flat slot) of token position `pos` of a sequence whose pages are
// `pt[0..Pg)`. Both indices are clamped, as JAX clamps an out-of-range gather:
// a bad page id reads a real page of the pool instead of faulting.
__device__ __forceinline__ int64_t slot_of(const int* pt, int pos, int Pg,
                                           int page_size, int n_pages) {
  const int col = min(pos / page_size, Pg - 1);
  const int page = min(max(pt[col], 0), n_pages - 1);
  return static_cast<int64_t>(page) * page_size + pos % page_size;
}

}  // namespace swiftllm
