// Paged decode attention with the KV-cache write fused in.
//
// Replaces: swiftllm_tpu/ops/paged_attention.py:_decode_kernel_grouped (the
// q_bucket == 1 branch of ragged_paged_attention).
//
// What it computes: for every valid decode row b (q_lens[b] > 0; flat token b
// is row b) it first writes this block's kv head's K and V lanes of
// kv_new[b] into cache[layer, kv_slots[b]], then attends the head's GROUP
// query heads over the row's seq_lens[b] keys: positions 0 .. seq_len-2 come
// from the pages in page_table[b], position seq_len-1 (the new token) straight
// from kv_new[b]. Rows that are not valid decode rows, and tokens past the row
// axis, get zeros.
//
// What bounds it on the H100: bytes. Each key costs 2*HD*2 bytes of K and V
// per kv head and 4*GROUP*HD flops, far below the ~295 flops/byte at which
// the tensor cores would become the limit, so the kernel's job is to stream
// the row's pages once at full memory rate.
//
// What this simple design does about it: one block per (row, kv head), so
// every K/V byte is read exactly once and all GROUP query heads share it.
// Each key is read by HD/8 lanes with 16-byte loads (a warp covers 2 keys at
// head_dim 128, 4 at 64), eight warps stride over the keys, and each key
// group keeps its own f32 online softmax; the partial states merge through
// shuffles, then shared memory. Split-KV across blocks (for few rows with
// long histories), cp.async/TMA pipelining and wgmma come later.
//
// Writes race with nothing: blocks of different kv heads write disjoint lanes
// of one slot, and no block reads the slot being written (the history ends at
// seq_len-2 and the new key is read from kv_new).

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kWarps = 8;
constexpr int kVec = 8;  // bf16 per 16-byte load

template <int HD, int GROUP>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const bf16* __restrict__ q, bf16* __restrict__ cache,
                    const bf16* __restrict__ kv_new,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ kv_slots, bf16* __restrict__ out,
                    int B, int Pg, int n_kv, int S, int layer, int page_size,
                    float sm_scale) {
  constexpr int LPK = HD / kVec;  // lanes per key
  constexpr int KPW = 32 / LPK;   // keys per warp per step
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int n_q = n_kv * GROUP;
  const int KH = n_kv * HD;
  const int W = 2 * KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / LPK;
  const int li = lane % LPK;
  bf16* o = out + (static_cast<int64_t>(b) * n_q + h * GROUP) * HD;

  if (b >= B || q_lens[b] <= 0 || seq_lens[b] <= 0) {
    for (int i = tid; i < GROUP * HD; i += blockDim.x) o[i] = __float2bfloat16(0.f);
    return;
  }
  const int seq_len = seq_lens[b];
  const int64_t layer_off = static_cast<int64_t>(layer) * S * W;
  const bf16* new_row = kv_new + static_cast<int64_t>(b) * W;

  // 1. The fused write: this kv head's K and V lanes of the new token. An
  //    out-of-range slot is dropped, as JAX drops an out-of-range scatter.
  const int slot = kv_slots[b];
  if (slot >= 0 && slot < S) {
    bf16* dst = cache + layer_off + static_cast<int64_t>(slot) * W;
    for (int i = tid; i < HD; i += blockDim.x) {
      dst[h * HD + i] = new_row[h * HD + i];
      dst[KH + h * HD + i] = new_row[KH + h * HD + i];
    }
  }

  // 2. This lane's slice of the GROUP query heads, pre-scaled.
  float qf[GROUP][kVec];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    load8(q + (static_cast<int64_t>(b) * n_q + h * GROUP + g) * HD + li * kVec, qf[g]);
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[g][e] *= sm_scale;
  }
  float m[GROUP], l[GROUP], acc[GROUP][kVec];
#pragma unroll
  for (int g = 0; g < GROUP; ++g) {
    m[g] = kNegBig;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  // 3. Online softmax over the keys. The loop bound is warp-uniform so every
  //    lane reaches the shuffles; a key slot past seq_len is skipped, not
  //    weighted by zero.
  const int* pt = page_table + static_cast<int64_t>(b) * Pg;
  const int n_pages = S / page_size;
  for (int base = warp * KPW; base < seq_len; base += kWarps * KPW) {
    const int pos = base + sub;
    const bool active = pos < seq_len;
    const bf16* row = new_row;
    if (active && pos < seq_len - 1)
      row = cache + layer_off + slot_of(pt, pos, Pg, page_size, n_pages) * W;
    float kf[kVec], vf[kVec];
    load8(row + h * HD + li * kVec, kf);
    load8(row + KH + h * HD + li * kVec, vf);
    float s[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) d += qf[g][e] * kf[e];
      s[g] = d;
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
    }
    if (active) {
#pragma unroll
      for (int g = 0; g < GROUP; ++g) {
        const float mn = fmaxf(m[g], s[g]);
        const float c = expf(m[g] - mn);
        const float p = expf(s[g] - mn);
        l[g] = l[g] * c + p;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = acc[g][e] * c + p * vf[e];
        m[g] = mn;
      }
    }
  }

  // 4. Merge the KPW key groups of each warp (lanes li, li+LPK, ...).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = expf(m[g] - mn);
      const float c = expf(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        acc[g][e] = acc[g][e] * a + __shfl_xor_sync(0xffffffffu, acc[g][e], off) * c;
      m[g] = mn;
    }
  }

  // 5. Merge the warps through shared memory and write the output.
  __shared__ float sm_m[kWarps][GROUP];
  __shared__ float sm_l[kWarps][GROUP];
  __shared__ float sm_acc[kWarps][GROUP][HD];
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) sm_acc[warp][g][li * kVec + e] = acc[g][e];
      if (li == 0) {
        sm_m[warp][g] = m[g];
        sm_l[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < GROUP * HD; i += blockDim.x) {
    const int g = i / HD;
    const int d = i % HD;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    o[i] = __float2bfloat16(A / L);  // L > 0: the new key is always counted
  }
}

template <int HD, int GROUP>
void launch(const void* q, void* cache, const void* kv_new, const void* pt,
            const void* q_lens, const void* seq_lens, const void* kv_slots,
            void* out, int T, int B, int Pg, int n_kv, int S, int layer,
            int page_size, float sm_scale, cudaStream_t stream) {
  paged_decode_kernel<HD, GROUP><<<dim3(T, n_kv), kWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<bf16*>(cache),
      static_cast<const bf16*>(kv_new), static_cast<const int*>(pt),
      static_cast<const int*>(q_lens), static_cast<const int*>(seq_lens),
      static_cast<const int*>(kv_slots), static_cast<bf16*>(out), B, Pg, n_kv,
      S, layer, page_size, sm_scale);
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head_dim / GQA group it has no instance for.
extern "C" int paged_decode_attention(const void* q, void* cache,
                                      const void* kv_new, const void* page_table,
                                      const void* q_lens, const void* seq_lens,
                                      const void* kv_slots, void* out, int T,
                                      int B, int Pg, int n_q, int n_kv, int hd,
                                      int S, int layer, int page_size,
                                      float sm_scale, void* stream) {
  using namespace swiftllm;
  const int group = n_q / n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_DECODE_CASE(HD_, G_)                                          \
  if (hd == HD_ && group == G_) {                                              \
    launch<HD_, G_>(q, cache, kv_new, page_table, q_lens, seq_lens, kv_slots,  \
                    out, T, B, Pg, n_kv, S, layer, page_size, sm_scale, st);   \
    return static_cast<int>(cudaGetLastError());                               \
  }
  SWIFTLLM_DECODE_CASE(64, 1)
  SWIFTLLM_DECODE_CASE(64, 2)
  SWIFTLLM_DECODE_CASE(64, 4)
  SWIFTLLM_DECODE_CASE(64, 8)
  SWIFTLLM_DECODE_CASE(128, 1)
  SWIFTLLM_DECODE_CASE(128, 2)
  SWIFTLLM_DECODE_CASE(128, 4)
  SWIFTLLM_DECODE_CASE(128, 8)
#undef SWIFTLLM_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
