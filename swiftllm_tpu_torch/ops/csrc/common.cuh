// Shared helpers of the paged-attention kernels (sm_90a, bf16 in, f32 math).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace swiftllm {

typedef __nv_bfloat16 bf16;

// Finite stand-in for -inf in the online softmax: exp(kNegBig - m) is exactly
// 0 for any real score m, and kNegBig - kNegBig is 0, never NaN.
constexpr float kNegBig = -1e30f;

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
