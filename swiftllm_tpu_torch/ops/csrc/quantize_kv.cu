// The fp8 KV cache's row build: one step's K and V rows, quantized with
// per-token power-of-two scales, as the cache stores them.
//
// Replaces: no Pallas kernel, but XLA's fusion of the quantizing kv_new build
// in swiftllm_tpu/models/llama.py (587-601: each token's K and V absmax,
// fp8_scales, the scaled values clipped to +-448, the scale lanes, the cast
// to e4m3), which XLA fuses into its neighbours. In plain PyTorch that build
// is some 17 launches a layer.
//
// What it computes: for each token t, out[t] = [K(t) * sk, V(t) * sv, sk,
// sv, 0 ...] as e4m3 (FP8_SCALE_LANES = 128 scale lanes), byte for byte what
// ops/quantize_kv.py:quantize_kv_plain writes: the absmax of the token's K
// (and of its V) in f32; the scale 2^e with e = (m <= 0.875 ? 8 : 7) - ex
// for the absmax m * 2^ex (m in [0.5, 1)), clamped to [1e-20, FLT_MAX]
// first and e clipped to [-9, 8] (fp8_scales, the exact floor of log2(224 /
// absmax)); each value times its scale (exact: a power of two) clipped to
// +-448; the cast rounds to nearest even and saturates.
//
// What bounds it on the H100: the launch. At 8B width (8 KV heads of 128)
// a token reads 4 KB of bf16 and writes 2.2 KB, 0.8 MB at T = 128 (0.24 us
// at 3.35 TB/s). The design: one block a token, 16-byte loads (eight bf16 a
// thread), the two maxima reduced with warp shuffles and once across the
// block's warps, the row written in 8-byte stores.

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kThreads = 128;

// The power-of-two scale of an absmax (fp8_scales).
__device__ __forceinline__ float fp8_scale(float x_max) {
  int ex;
  const float m = frexpf(fminf(fmaxf(x_max, 1e-20f), 3.402823466e38f), &ex);
  const int e = min(max((m <= 0.875f ? 8 : 7) - ex, -9), 8);
  return __int_as_float((e + 127) << 23);
}

// Eight floats, each clipped to +-448, as eight e4m3 bytes (the pairs
// packed by shifts: a store through a 16-bit pointer into the uint2 was
// lost on the card, which then wrote the registers' stale bytes).
__device__ __forceinline__ uint2 to_e4m3(const float (&f)[8]) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __nv_cvt_float2_to_fp8x2(
        make_float2(fminf(fmaxf(f[2 * i], -448.f), 448.f),
                    fminf(fmaxf(f[2 * i + 1], -448.f), 448.f)),
        __NV_SATFINITE, __NV_E4M3);
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

__global__ void __launch_bounds__(kThreads)
quantize_kv_kernel(const bf16* __restrict__ kf, const bf16* __restrict__ vf,
                   fp8* __restrict__ out, int KH) {
  const int t = blockIdx.x;
  const int vecs = KH / 8;
  const bf16* src[2] = {kf + static_cast<int64_t>(t) * KH,
                        vf + static_cast<int64_t>(t) * KH};
  fp8* row = out + static_cast<int64_t>(t) * (2 * KH + ScaleLanes<fp8>::value);

  // Each token's K and V absmax, in f32 (exact: a maximum).
  float mx[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f[8];
      load8(src[h] + 8 * i, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) mx[h] = fmaxf(mx[h], fabsf(f[e]));
    }
  }
  __shared__ float part[2][kThreads / 32];
  __shared__ float scale[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
    if (threadIdx.x % 32 == 0) part[h][threadIdx.x / 32] = mx[h];
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float m = part[threadIdx.x][0];
    for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, part[threadIdx.x][w]);
    scale[threadIdx.x] = fp8_scale(m);
  }
  __syncthreads();

  // The scaled values (the loads hit L1 or L2), then the scale lanes.
  for (int i = threadIdx.x; i < vecs; i += kThreads) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float f[8];
      load8(src[h] + 8 * i, f);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] *= scale[h];
      *reinterpret_cast<uint2*>(row + h * KH + 8 * i) = to_e4m3(f);
    }
  }
  for (int i = threadIdx.x; i < ScaleLanes<fp8>::value / 8; i += kThreads) {
    float f[8] = {};
    if (i == 0) {
      f[0] = scale[0];
      f[1] = scale[1];
    }
    *reinterpret_cast<uint2*>(row + 2 * KH + 8 * i) = to_e4m3(f);
  }
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. T >= 1, KH a multiple of 8; kf and vf bf16 [T,
// KH], out e4m3 [T, 2 * KH + 128], all contiguous and 16-byte aligned (the
// wrapper checks it). Returns cudaGetLastError() after the launch.
extern "C" int quantize_kv(const void* kf, const void* vf, void* out, int T, int KH,
                           void* stream) {
  using namespace swiftllm;
  if (T < 1 || KH < 8 || KH % 8) return static_cast<int>(cudaErrorInvalidValue);
  quantize_kv_kernel<<<T, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(kf), static_cast<const bf16*>(vf),
      static_cast<fp8*>(out), KH);
  return static_cast<int>(cudaGetLastError());
}
