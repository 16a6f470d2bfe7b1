// Ragged causal paged attention for multi-token rows: prefill chunks, and
// the spans of a speculative verify step.
//
// Replaces: swiftllm_tpu/ops/paged_attention.py:_tiles_kernel (the
// q_bucket > 1 branch of ragged_paged_attention). Its fused span write is the
// separate store_kv launch (store_kv.cu), queued before this one; that split
// is the TPU kernel's unfused mode, which its verify steps take.
//
// What it computes: row b's q_lens[b] queries are flat tokens q_starts[b] ..
// q_starts[b]+q_lens[b]-1 and the last positions of a seq_lens[b]-long
// sequence whose keys live in pages page_table[b]; query i sees keys
// 0 .. seq_len-q_len+i (causal within the tail), with GQA and an f32 online
// softmax. Tokens of no row are left as the caller allocated them.
//
// Spans that start anywhere. Nothing here assumes a page-aligned span or an
// aligned q_starts: a verify span ([next token] + drafts, at most q_bucket =
// next_pow2(spec_k + 1) tokens) starts and ends mid-page, and each query's
// position comes from seq_len - q_len alone. Keys at or past seq_len are
// never read (the walk stops at the block's last query), so the stale rows
// of rejected drafts that a later slot may still hold are invisible once
// seq_len is short of them.
//
// Three variants of the same body, as in the TPU kernel:
// - An fp8 cache (the KV template parameter): rows of e4m3 bytes that end in
//   128 scale lanes (common.cuh). The bytes become bf16 on their way into
//   shared memory (exact), and each staged key's two inverse scales go
//   beside them: the score is (q . k_stored) * sm_scale / k_scale, the
//   probability meets V as p / v_scale, and l sums the unscaled p.
// - A sliding window (`window` > 0): query at position p sees keys in
//   (p - window, p]. The walk starts at the key tile that holds the first
//   key of the block's FIRST query's window (later queries' windows start
//   later) and masks per query. A masked key has probability exactly 0, and
//   a row whose keys of a tile are all masked keeps its m, l and acc (both m
//   and the tile's maximum are the finite kNegBig then, so the rescale
//   factor is exp(0) = 1 on an accumulator that is still 0).
// - bf16 scores (the BF16S template parameter; its own C entry,
//   paged_prefill_attention_bf16s; TPU: the SWIFTLLM_TILE_BF16_SCORES mode,
//   paged_attention.py:1163-1246), for a bf16 cache without a window only.
//   The softmax runs in log2 space and rounds where the TPU kernel rounds:
//   the raw score q . k to bf16; the exponent argument s * K2E - m (K2E =
//   sm_scale * log2(e), itself rounded to bf16, and m rounded to bf16 for
//   the subtraction) to bf16 after each of its two operations; exp2 of it,
//   P, to bf16 before the P.V product. m, l and the accumulator stay f32.
//
// What bounds it on the H100: for a long prefill, operations (4*HD flops per
// query-key pair and head, against K/V bytes that every query tile re-reads);
// for a short chunk or a verify span over a long history, bytes.
//
// What this simple design does about it: one block per (row, q tile, kv head)
// holds 64 query rows (64/GROUP tokens times the GROUP query heads of the kv
// head) in shared memory, so every K/V tile it stages serves all of them, and
// walks the row's keys in tiles of 32 up to the causal bound of its last
// query. Scores and P.V run on the CUDA cores in f32 (each thread owns 4 rows
// by 4 keys of the scores and 4 rows by HD/8 dims of the output); moving them
// to wgmma with TMA-fed tiles is the later step to the tensor-core bound.
// Short spans take a block of 32 rows instead (2 rows a thread), chosen from
// q_bucket: a verify step's bucket of 8 tokens at GQA group 4 is 32 rows, of
// which a span of at most 5 tokens fills 20; a 64-row block would spend the
// same time per key tile on 44 empty rows. Each block's walk over its row's
// history is serial, so a verify step's time is that of its longest row.

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kThreads = 128;
constexpr int kTK = 32;     // keys per tile
constexpr int kPad = 8;     // bf16 of padding per shared row: spreads banks
constexpr int kKPT = 4;     // keys per thread (kTK / 8)
// Query rows (token x head) per block: 64, or 32 for short spans (q_bucket
// * GROUP <= 32: a verify step's 8 tokens at GROUP 4), which halves the
// work of every key tile of a block that would hold at most 20 live rows.
constexpr int kRowsLong = 64;
constexpr int kRowsShort = 32;
constexpr float kLog2e = 1.4426950408889634f;

// x rounded to the nearest bf16 (ties to even), back in an f32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int HD, int GROUP, typename KV, bool BF16S, int ROWS>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(const bf16* __restrict__ q, const KV* __restrict__ cache,
                     const int* __restrict__ page_table,
                     const int* __restrict__ q_starts,
                     const int* __restrict__ q_lens,
                     const int* __restrict__ seq_lens, bf16* __restrict__ out,
                     int Pg, int n_kv, int S, int layer, int page_size,
                     int window, float sm_scale) {
  constexpr int SL = ScaleLanes<KV>::value;
  static_assert(!BF16S || SL == 0, "bf16 scores take a bf16 cache");
  constexpr int kRPT = ROWS / 16;     // rows per thread
  constexpr int TQ = ROWS / GROUP;   // query tokens per block
  constexpr int DPT = HD / 8;        // output dims per thread
  constexpr int VPR = HD / 8;        // 16-byte vectors per head row
  const int b = blockIdx.x;
  const int tile = blockIdx.y;
  const int h = blockIdx.z;
  const int q_len = q_lens[b];
  const int seq_len = seq_lens[b];
  if (q_len <= 0 || seq_len <= 0 || tile * TQ >= q_len) return;
  const int n_q = n_kv * GROUP;
  const int KH = n_kv * HD;
  const int W = 2 * KH + SL;
  const int tok0 = q_starts[b] + tile * TQ;            // flat token of query 0
  const int first_pos = seq_len - q_len + tile * TQ;   // its position
  const int n_tok = min(TQ, q_len - tile * TQ);
  const int kv_end = first_pos + n_tok;                // keys [0, kv_end)
  const int64_t layer_off = static_cast<int64_t>(layer) * S * W;
  const int* pt = page_table + static_cast<int64_t>(b) * Pg;
  const int n_pages = S / page_size;

  __shared__ __align__(16) bf16 Qs[ROWS][HD + kPad];
  __shared__ __align__(16) bf16 Ks[kTK][HD + kPad];
  __shared__ __align__(16) bf16 Vs[kTK][HD + kPad];
  __shared__ float Ps[ROWS][kTK + 1];
  __shared__ float inv_ks[kTK], inv_vs[kTK];  // 1 / scale of each staged key

  const int tid = threadIdx.x;
  const int tr = tid / 8;
  const int tk = tid % 8;

  // Query rows r = g*TQ + qi: token qi of the tile, query head h*GROUP + g.
  for (int i = tid; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * 8;
    const int g = r / TQ;
    const int qi = r % TQ;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (qi < n_tok)
      v = *reinterpret_cast<const uint4*>(
          q + (static_cast<int64_t>(tok0 + qi) * n_q + h * GROUP + g) * HD + c);
    *reinterpret_cast<uint4*>(&Qs[r][c]) = v;
  }

  int qpos[kRPT];
  bool row_ok[kRPT];
  float m[kRPT], l[kRPT], acc[kRPT][DPT];
#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    const int qi = (tr + 16 * i) % TQ;
    qpos[i] = first_pos + qi;
    row_ok[i] = qi < n_tok;
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // The first key tile any query of the block can see.
  const int k_first = window > 0 ? max(first_pos - window + 1, 0) / kTK * kTK : 0;
  for (int k0 = k_first; k0 < kv_end; k0 += kTK) {
    __syncthreads();  // the previous tile's Ks/Vs/Ps are consumed
    // Stage keys k0 .. k0+kTK-1 of this kv head; keys past the causal bound
    // of the last query are zero-filled, never read from the cache.
    for (int i = tid; i < kTK * VPR; i += kThreads) {
      const int kk = i / VPR;
      const int c = (i % VPR) * 8;
      const int pos = k0 + kk;
      uint4 kv = make_uint4(0, 0, 0, 0);
      uint4 vv = make_uint4(0, 0, 0, 0);
      float ik = 1.f, iv = 1.f;
      if (pos < kv_end) {
        const KV* row =
            cache + layer_off + slot_of(pt, pos, Pg, page_size, n_pages) * W;
        kv = load8_bf16(row + h * HD + c);
        vv = load8_bf16(row + KH + h * HD + c);
        if constexpr (SL > 0) {
          ik = inv_scale(row[2 * KH]);
          iv = inv_scale(row[2 * KH + 1]);
        }
      }
      *reinterpret_cast<uint4*>(&Ks[kk][c]) = kv;
      *reinterpret_cast<uint4*>(&Vs[kk][c]) = vv;
      if (SL > 0 && c == 0) {
        inv_ks[kk] = ik;
        inv_vs[kk] = iv;
      }
    }
    __syncthreads();

    float s[kRPT][kKPT];
#pragma unroll
    for (int i = 0; i < kRPT; ++i)
#pragma unroll
      for (int j = 0; j < kKPT; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 2) {
      float2 qv[kRPT], kv[kKPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
        qv[i] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&Qs[tr + 16 * i][d]));
#pragma unroll
      for (int j = 0; j < kKPT; ++j)
        kv[j] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&Ks[tk + 8 * j][d]));
#pragma unroll
      for (int i = 0; i < kRPT; ++i)
#pragma unroll
        for (int j = 0; j < kKPT; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y;
    }

    // Online softmax. A masked key gets probability exactly 0 (not the exp
    // of a large negative), and its V row is either real cache data of this
    // sequence or the zero fill above.
#pragma unroll
    for (int i = 0; i < kRPT; ++i) {
      bool valid[kKPT];
      float tmax = kNegBig;
#pragma unroll
      for (int j = 0; j < kKPT; ++j) {
        const int key = k0 + tk + 8 * j;
        valid[j] = row_ok[i] && key <= qpos[i] &&
                   (window <= 0 || key > qpos[i] - window);
        if constexpr (BF16S) {
          s[i][j] = round_bf16(s[i][j]);          // raw score, bf16
        } else {
          s[i][j] *= sm_scale;
          if constexpr (SL > 0) s[i][j] *= inv_ks[tk + 8 * j];
        }
        if (valid[j]) tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      float mn, c, rsum = 0.f;
      if constexpr (BF16S) {
        // m in log2 space: the raw maximum times K2E in f32.
        const float k2e = sm_scale * kLog2e;
        const float k2e_b = round_bf16(k2e);
        mn = fmaxf(m[i], tmax == kNegBig ? kNegBig : tmax * k2e);
        c = exp2f(m[i] - mn);
        const float mn_b = round_bf16(mn);
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          const float arg = round_bf16(round_bf16(s[i][j] * k2e_b) - mn_b);
          const float p = valid[j] ? round_bf16(exp2f(arg)) : 0.f;
          Ps[tr + 16 * i][tk + 8 * j] = p;
          rsum += p;
        }
      } else {
        mn = fmaxf(m[i], tmax);
        c = expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < kKPT; ++j) {
          const float p = valid[j] ? expf(s[i][j] - mn) : 0.f;
          if constexpr (SL > 0)
            Ps[tr + 16 * i][tk + 8 * j] = p * inv_vs[tk + 8 * j];
          else
            Ps[tr + 16 * i][tk + 8 * j] = p;
          rsum += p;
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[i] = l[i] * c + rsum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= c;
    }
    __syncthreads();

#pragma unroll 4
    for (int k = 0; k < kTK; ++k) {
      float p[kRPT];
#pragma unroll
      for (int i = 0; i < kRPT; ++i) p[i] = Ps[tr + 16 * i][k];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float v = __bfloat162float(Vs[k][tk + 8 * j]);
#pragma unroll
        for (int i = 0; i < kRPT; ++i) acc[i][j] += p[i] * v;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRPT; ++i) {
    if (!row_ok[i]) continue;
    const int r = tr + 16 * i;
    const int g = r / TQ;
    const int qi = r % TQ;
    bf16* o = out + (static_cast<int64_t>(tok0 + qi) * n_q + h * GROUP + g) * HD;
    const float inv = 1.f / l[i];  // l > 0: every query sees its own key
#pragma unroll
    for (int j = 0; j < DPT; ++j) o[tk + 8 * j] = __float2bfloat16(acc[i][j] * inv);
  }
}

template <int HD, int GROUP, typename KV, bool BF16S, int ROWS>
void launch_rows(const void* q, const void* cache, const void* pt,
                 const void* q_starts, const void* q_lens, const void* seq_lens,
                 void* out, int B, int q_bucket, int Pg, int n_kv, int S,
                 int layer, int page_size, int window, float sm_scale,
                 cudaStream_t stream) {
  constexpr int TQ = ROWS / GROUP;
  paged_prefill_kernel<HD, GROUP, KV, BF16S, ROWS>
      <<<dim3(B, (q_bucket + TQ - 1) / TQ, n_kv), kThreads, 0, stream>>>(
          static_cast<const bf16*>(q), static_cast<const KV*>(cache),
          static_cast<const int*>(pt), static_cast<const int*>(q_starts),
          static_cast<const int*>(q_lens), static_cast<const int*>(seq_lens),
          static_cast<bf16*>(out), Pg, n_kv, S, layer, page_size, window,
          sm_scale);
}

// One launch; the row tile follows from q_bucket (see kRowsShort).
template <int HD, int GROUP, typename KV, bool BF16S = false>
void launch(const void* q, const void* cache, const void* pt,
            const void* q_starts, const void* q_lens, const void* seq_lens,
            void* out, int B, int q_bucket, int Pg, int n_kv, int S, int layer,
            int page_size, int window, float sm_scale, cudaStream_t stream) {
  if (q_bucket * GROUP <= kRowsShort)
    launch_rows<HD, GROUP, KV, BF16S, kRowsShort>(
        q, cache, pt, q_starts, q_lens, seq_lens, out, B, q_bucket, Pg, n_kv,
        S, layer, page_size, window, sm_scale, stream);
  else
    launch_rows<HD, GROUP, KV, BF16S, kRowsLong>(
        q, cache, pt, q_starts, q_lens, seq_lens, out, B, q_bucket, Pg, n_kv,
        S, layer, page_size, window, sm_scale, stream);
}

}  // namespace
}  // namespace swiftllm

#define SWIFTLLM_PREFILL_INSTANCES(CASE) \
  CASE(64, 1) CASE(64, 2) CASE(64, 4) CASE(64, 8)   \
  CASE(128, 1) CASE(128, 2) CASE(128, 4) CASE(128, 8)

// C entries, bound with ctypes. q_bucket bounds every row's q_len; it sets
// the grid's tile axis and the row tile (kRowsShort when q_bucket * GROUP
// <= 32, else kRowsLong). Each returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a head_dim / GQA group it has no instance for.
//
// paged_prefill_attention: kv_fp8 != 0: the cache holds e4m3 rows with the
// scale lanes; else bf16. window: 0 = full causal.
extern "C" int paged_prefill_attention(const void* q, const void* cache,
                                       const void* page_table,
                                       const void* q_starts, const void* q_lens,
                                       const void* seq_lens, void* out, int B,
                                       int q_bucket, int Pg, int n_q, int n_kv,
                                       int hd, int S, int layer, int page_size,
                                       int window, int kv_fp8, float sm_scale,
                                       void* stream) {
  using namespace swiftllm;
  const int group = n_q / n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_PREFILL_CASE(HD_, G_)                                         \
  if (hd == HD_ && group == G_) {                                              \
    if (kv_fp8)                                                                \
      launch<HD_, G_, fp8>(q, cache, page_table, q_starts, q_lens, seq_lens,   \
                           out, B, q_bucket, Pg, n_kv, S, layer, page_size,    \
                           window, sm_scale, st);                              \
    else                                                                       \
      launch<HD_, G_, bf16>(q, cache, page_table, q_starts, q_lens, seq_lens,  \
                            out, B, q_bucket, Pg, n_kv, S, layer, page_size,   \
                            window, sm_scale, st);                             \
    return static_cast<int>(cudaGetLastError());                               \
  }
  SWIFTLLM_PREFILL_INSTANCES(SWIFTLLM_PREFILL_CASE)
#undef SWIFTLLM_PREFILL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// paged_prefill_attention_bf16s: the bf16-score variant. A bf16 cache and no
// window (the TPU kernel's gate): it takes neither argument.
extern "C" int paged_prefill_attention_bf16s(
    const void* q, const void* cache, const void* page_table,
    const void* q_starts, const void* q_lens, const void* seq_lens, void* out,
    int B, int q_bucket, int Pg, int n_q, int n_kv, int hd, int S, int layer,
    int page_size, float sm_scale, void* stream) {
  using namespace swiftllm;
  const int group = n_q / n_kv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_PREFILL_CASE(HD_, G_)                                         \
  if (hd == HD_ && group == G_) {                                              \
    launch<HD_, G_, bf16, true>(q, cache, page_table, q_starts, q_lens,        \
                                seq_lens, out, B, q_bucket, Pg, n_kv, S,       \
                                layer, page_size, 0, sm_scale, st);            \
    return static_cast<int>(cudaGetLastError());                               \
  }
  SWIFTLLM_PREFILL_INSTANCES(SWIFTLLM_PREFILL_CASE)
#undef SWIFTLLM_PREFILL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef SWIFTLLM_PREFILL_INSTANCES
