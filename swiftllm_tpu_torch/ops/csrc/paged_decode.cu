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
// Three variants of the same body, as in the TPU kernel:
// - An fp8 cache (the KV template parameter): rows of e4m3 bytes that end in
//   128 scale lanes (common.cuh). The bytes are converted to f32 in
//   registers; the score is (q . k_stored) * sm_scale / k_scale, and the
//   probability meets V as p / v_scale, while l sums the unscaled p. The new
//   token is read from kv_new as stored (quantized), un-scaled by its own
//   lanes. Every lane of a key reads the key's two scale bytes from the tail
//   of its row. The fused write copies bytes, the scale lanes with kv head 0.
// - A sliding window (`window` > 0): the query at position seq_len-1 sees
//   keys in (seq_len-1-window, seq_len-1]. The walk starts at the page that
//   holds the first visible key, so pages wholly below the window are never
//   read, and masks inside that page. A masked key is skipped, so a warp
//   whose keys are all masked keeps m = kNegBig, l = 0, acc = 0 and merges
//   with weight exp(kNegBig - M) = 0.
// - Deferred commit (the PEND template parameter; the TPU kernel's `pend`
//   mode, for multi-step windows whose tokens are committed to the cache
//   once, after the window): step 1 below does not run, kv_slots is not
//   read and the cache is only read. The row's cached history is
//   hist = max(seq_len - npend, 0) keys; position pos comes from the pages
//   for pos < hist, from kv_pend[layer, pos - hist, b] for
//   hist <= pos < seq_len - 1 (the window's npend - 1 completed tokens, in a
//   plain [L, P, B, W] buffer), and from kv_new[b] for the last. Pending
//   slots from npend - 1 on hold stale rows and are never addressed. npend
//   is the same for every row. bf16 rows only; `window` is honoured.
//
// What bounds it on the H100: bytes. Each key costs 2*HD*2 bytes of K and V
// per kv head in bf16 (half that in fp8) and 4*GROUP*HD flops, far below the
// ~295 flops/byte at which the tensor cores would become the limit, so the
// kernel's job is to stream the row's pages once at full memory rate.
//
// What this simple design does about it: one block per (row, kv head), so
// every K/V byte is read exactly once and all GROUP query heads share it.
// Each key is read by HD/8 lanes, eight elements each (16-byte loads in bf16,
// 8-byte loads in fp8; a warp covers 2 keys at head_dim 128, 4 at 64), eight
// warps stride over the keys, and each key
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
constexpr int kVec = 8;  // cache elements per lane and key

template <int HD, int GROUP, typename KV, bool PEND>
__global__ void __launch_bounds__(kWarps * 32)
paged_decode_kernel(const bf16* __restrict__ q, KV* __restrict__ cache,
                    const KV* __restrict__ kv_new,
                    const KV* __restrict__ kv_pend,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ kv_slots, bf16* __restrict__ out,
                    int B, int Pg, int n_kv, int S, int layer, int page_size,
                    int window, int npend, int P, float sm_scale) {
  constexpr int SL = ScaleLanes<KV>::value;
  constexpr int LPK = HD / kVec;  // lanes per key
  constexpr int KPW = 32 / LPK;   // keys per warp per step
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int n_q = n_kv * GROUP;
  const int KH = n_kv * HD;
  const int W = 2 * KH + SL;
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
  const KV* new_row = kv_new + static_cast<int64_t>(b) * W;

  // 1. The fused write: this kv head's K and V lanes of the new token (and,
  //    from kv head 0, the scale lanes). An out-of-range slot is dropped, as
  //    JAX drops an out-of-range scatter. Not in deferred-commit mode.
  if constexpr (!PEND) {
    const int slot = kv_slots[b];
    if (slot >= 0 && slot < S) {
      KV* dst = cache + layer_off + static_cast<int64_t>(slot) * W;
      for (int i = tid; i < HD; i += blockDim.x) {
        dst[h * HD + i] = new_row[h * HD + i];
        dst[KH + h * HD + i] = new_row[KH + h * HD + i];
      }
      if constexpr (SL > 0) {
        if (h == 0)
          for (int i = tid; i < SL; i += blockDim.x) dst[2 * KH + i] = new_row[2 * KH + i];
      }
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

  // 3. Online softmax over the keys lo .. seq_len-1 (lo > 0 only under a
  //    window), from the start of lo's page. The loop bound is warp-uniform
  //    so every lane reaches the shuffles; a key slot past seq_len or below
  //    lo is skipped, not weighted by zero, and reads no cache row.
  const int* pt = page_table + static_cast<int64_t>(b) * Pg;
  const int n_pages = S / page_size;
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int first = lo / page_size * page_size;
  // Deferred commit: keys from hist on are not in the cache. Slot j of this
  // layer's pending rows for row b is pend_b + j * B * W.
  const int hist = PEND ? max(seq_len - npend, 0) : seq_len;
  const KV* pend_b = nullptr;
  if constexpr (PEND)
    pend_b = kv_pend + (static_cast<int64_t>(layer) * P * B + b) * W;
  for (int base = first + warp * KPW; base < seq_len; base += kWarps * KPW) {
    const int pos = base + sub;
    const bool active = pos >= lo && pos < seq_len;
    const KV* row = new_row;
    if (active && pos < seq_len - 1) {
      if (!PEND || pos < hist)
        row = cache + layer_off + slot_of(pt, pos, Pg, page_size, n_pages) * W;
      else
        row = pend_b + static_cast<int64_t>(pos - hist) * B * W;
    }
    float kf[kVec], vf[kVec];
    load8(row + h * HD + li * kVec, kf);
    load8(row + KH + h * HD + li * kVec, vf);
    float inv_k = 1.f, inv_v = 1.f;
    if constexpr (SL > 0) {
      inv_k = inv_scale(row[2 * KH]);
      inv_v = inv_scale(row[2 * KH + 1]);
    }
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
        const float sc = s[g] * inv_k;
        const float mn = fmaxf(m[g], sc);
        const float c = expf(m[g] - mn);
        const float p = expf(sc - mn);
        l[g] = l[g] * c + p;
        const float pv = p * inv_v;
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] = acc[g][e] * c + pv * vf[e];
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

template <int HD, int GROUP, typename KV, bool PEND>
void launch(const void* q, void* cache, const void* kv_new,
            const void* kv_pend, const void* pt, const void* q_lens,
            const void* seq_lens, const void* kv_slots, void* out, int T,
            int B, int Pg, int n_kv, int S, int layer, int page_size,
            int window, int npend, int P, float sm_scale,
            cudaStream_t stream) {
  paged_decode_kernel<HD, GROUP, KV, PEND>
      <<<dim3(T, n_kv), kWarps * 32, 0, stream>>>(
          static_cast<const bf16*>(q), static_cast<KV*>(cache),
          static_cast<const KV*>(kv_new), static_cast<const KV*>(kv_pend),
          static_cast<const int*>(pt), static_cast<const int*>(q_lens),
          static_cast<const int*>(seq_lens), static_cast<const int*>(kv_slots),
          static_cast<bf16*>(out), B, Pg, n_kv, S, layer, page_size, window,
          npend, P, sm_scale);
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. kv_fp8 != 0: cache and kv_new are e4m3 rows
// with the scale lanes; else bf16. window: 0 = full causal. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// head_dim / GQA group it has no instance for.
extern "C" int paged_decode_attention(const void* q, void* cache,
                                      const void* kv_new, const void* page_table,
                                      const void* q_lens, const void* seq_lens,
                                      const void* kv_slots, void* out, int T,
                                      int B, int Pg, int n_q, int n_kv, int hd,
                                      int S, int layer, int page_size,
                                      int window, int kv_fp8, float sm_scale,
                                      void* stream) {
  using namespace swiftllm;
  const int group = n_q / n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_DECODE_CASE(HD_, G_)                                          \
  if (hd == HD_ && group == G_) {                                              \
    if (kv_fp8)                                                                \
      launch<HD_, G_, fp8, false>(q, cache, kv_new, nullptr, page_table,       \
                                  q_lens, seq_lens, kv_slots, out, T, B, Pg,   \
                                  n_kv, S, layer, page_size, window, 0, 0,     \
                                  sm_scale, st);                               \
    else                                                                       \
      launch<HD_, G_, bf16, false>(q, cache, kv_new, nullptr, page_table,      \
                                   q_lens, seq_lens, kv_slots, out, T, B, Pg,  \
                                   n_kv, S, layer, page_size, window, 0, 0,    \
                                   sm_scale, st);                              \
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

// C entry of the deferred-commit variant, bound with ctypes. cache, kv_new and
// kv_pend [L, P, B, W] are bf16; the cache is only read (it is taken
// non-const because the variants share one kernel signature). npend in 1..P:
// the window's npend - 1 completed tokens are read from kv_pend. Returns as
// paged_decode_attention does.
extern "C" int paged_decode_attention_pend(
    const void* q, const void* cache, const void* kv_new, const void* kv_pend,
    const void* page_table, const void* q_lens, const void* seq_lens,
    void* out, int T, int B, int Pg, int n_q, int n_kv, int hd, int S,
    int layer, int page_size, int window, int npend, int P, float sm_scale,
    void* stream) {
  using namespace swiftllm;
  const int group = n_q / n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npend < 1 || npend > P) return static_cast<int>(cudaErrorInvalidValue);
#define SWIFTLLM_PEND_CASE(HD_, G_)                                            \
  if (hd == HD_ && group == G_) {                                              \
    launch<HD_, G_, bf16, true>(q, const_cast<void*>(cache), kv_new, kv_pend,  \
                                page_table, q_lens, seq_lens, nullptr, out, T, \
                                B, Pg, n_kv, S, layer, page_size, window,      \
                                npend, P, sm_scale, st);                       \
    return static_cast<int>(cudaGetLastError());                               \
  }
  SWIFTLLM_PEND_CASE(64, 1)
  SWIFTLLM_PEND_CASE(64, 2)
  SWIFTLLM_PEND_CASE(64, 4)
  SWIFTLLM_PEND_CASE(64, 8)
  SWIFTLLM_PEND_CASE(128, 1)
  SWIFTLLM_PEND_CASE(128, 2)
  SWIFTLLM_PEND_CASE(128, 4)
  SWIFTLLM_PEND_CASE(128, 8)
#undef SWIFTLLM_PEND_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
