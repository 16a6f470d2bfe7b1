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
// softmax. Tokens of no row are zero (the bf16-score entry leaves them as
// the caller allocated them).
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
//   128 scale lanes (common.cuh). The bytes are staged as they are, then
//   converted to bf16 in shared memory (exact), because wgmma takes no e4m3
//   operand beside a bf16 one; each key's two inverse scales are read once,
//   beside the tile: the score is (q . k_stored) * sm_scale / k_scale, the
//   probability meets V as p / v_scale, and l sums the unscaled p.
// - A sliding window (`window` > 0): query at position p sees keys in
//   (p - window, p]. The walk starts at the first key of the block's FIRST
//   query's window (later queries' windows start later; key tiles need not
//   start on a multiple of 64) and masks per query. A masked key has
//   probability exactly 0, and a row whose keys of a tile are all masked
//   keeps its m, l and acc (both m and the tile's maximum are the finite
//   kNegBig then, so the rescale factor is exp2(0) = 1 on an accumulator
//   that is still 0). The running maximum is taken over visible keys only.
// - bf16 scores (the BF16S template parameter; its own C entry,
//   paged_prefill_attention_bf16s; TPU: the SWIFTLLM_TILE_BF16_SCORES mode,
//   paged_attention.py:1163-1246), for a bf16 cache without a window only.
//   The softmax rounds where the TPU kernel rounds: the raw score q . k to
//   bf16 (the running maximum from its exact value: a candidate whose wgmma
//   sum lies within 32 f32 steps of a bf16 rounding midpoint is summed
//   again in f64); the exponent argument s * K2E - m (K2E = sm_scale *
//   log2(e), itself rounded to bf16, and m rounded to bf16 for the
//   subtraction) to bf16 after each of its two operations; exp2 of it, P,
//   to bf16. m, l and the accumulator stay f32. This variant never splits its keys (below):
//   its rounding is defined against the running maximum of one walk over
//   the row, and a split's maximum is not the row's.
//
// P in the P.V product: the TPU kernel rounds P to bf16 before the dot
// (paged_attention.py:1230, 1235); the f32 variants here split it into two
// bf16 terms (hi + lo) and run the product twice on the same V tile, so P
// keeps about 17 bits, as the plain versions' f32 P. (With P in bf16 alone,
// a 4-layer verify step's logits strayed 0.1016 from the f32 reference,
// past the 0.1 that chip_smoke.py allows it.) l sums the f32 p. The
// bf16-score variant's P is bf16 by definition: one product.
//
// GQA groups: any group from 1 to 8. The kernel is compiled for a bound
// GMAX in {1, 2, 4, 8} and takes the real group, the least GMAX at or above
// it, as an argument. A block's rows are GMAX bands of TQ = ROWS / GMAX
// tokens (row r = g * TQ + token); bands g >= group are dead: their query
// is zero, they are masked as rows of no token, and nothing of them is
// written (no output; their partial rows are never merged into one). So at
// group 7 a tile holds 8 tokens of 7 heads, 56 of its 64 rows live; a group
// that is a power of two runs as before. The host plans the same tiles
// (ops/paged_attention.py:prefill_rows, prefill_tokens).
//
// What bounds it on the H100: for a long prefill, operations (4*HD flops per
// query-key pair and head, against K/V bytes that every query tile re-reads);
// for a short chunk or a verify span over a long history, bytes.
//
// What this design does about it:
// - Tensor cores. A block holds 64 or 128 query rows (ROWS/GMAX tokens
//   times the GMAX query head bands of one kv head, the row r = g *
//   (ROWS/GMAX) + token), a warpgroup (128 threads) for every 64, so every
//   K/V tile it stages serves all of them; 128 at head_dim 128 when the
//   bucket fills them (q_bucket * GMAX >= 128), else 64. Q.K^T is wgmma
//   m64n64k16 with Q (staged once) and the K tile [keys][hd] both K-major
//   in 128-byte-swizzled shared memory; P.V is
//   wgmma m64n{HD}k16 with P from registers (the score accumulator's
//   fragment, as bf16 pairs, is already in the A-operand layout, as in
//   FlashAttention-3) and the V tile [keys][hd] as an MN-major B operand
//   (the transpose bit). Sums in f32.
// - Loads in flight. Key tiles of 64 go through a ring of two stages in
//   dynamic shared memory, filled with cp.async (16 bytes a thread, zero
//   fill past the block's keys, clamped page ids as common.cuh's slot_of):
//   tiles 0 and 1 go out together, then tile t+1 is in flight while tile t
//   computes, and the page ids of tile t+2 are read meanwhile. Key tiles
//   wholly past the block's last query, or wholly below its first query's
//   window, are never loaded; the P.V steps of 16 keys past the split's
//   last key are skipped.
// - Splits. Short spans over long histories (verify steps, small chunks)
//   give few units of work, each walking a whole history. The wrapper's
//   planner (split_plan, host integers only) then cuts the keys into splits
//   of `chunk` keys walked as separate units, merged by the last one to
//   finish (splitkv.cuh); no second launch.
// - A persistent grid. The units (row, query tile, kv head, split) of a
//   bucket are mostly empty (decode rows, tiles past a row's q_len, splits
//   past its keys); a block for each would cost its launch and a read of
//   the row's lengths. Instead as many blocks as the SMs hold take the
//   units that have work, one at a time, from a queue. Each block stages
//   every row's lengths in shared memory and the running sum of the rows'
//   working units (16 bytes a row in all; the rows bucket may reach 8,192
//   at every instance), finds a unit's row by binary search in it and its
//   query tile within the row from the tiles' own key ranges. Between units
//   the blocks also write the zeros of the tokens of no row, so the wrapper
//   allocates its output uninitialised.

#include "common.cuh"
#include "splitkv.cuh"
#include "wgmma.cuh"

namespace swiftllm {
namespace {

constexpr int kTK = 64;        // keys of a tile
constexpr int kStages = 2;     // K/V tiles in the ring
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

constexpr int round_up(int x, int a) { return (x + a - 1) / a * a; }

// The exact dot product of query row r and key kk of the tile (both bf16 in
// the swizzled shared tiles), in f64, as the f32 whose rounding to bf16 is
// the exact value's: an f32 that lands on a bf16 rounding midpoint while the
// exact value does not is moved one step toward it. (Each product of two
// bf16 is exact in f64, and so is the sum of HD of them at the magnitudes
// attention sees, in any order: eight partial sums keep the chain short.)
template <int HD, int ROWS>
__device__ __noinline__ float exact_score(const uint8_t* q_tile,
                                         const uint8_t* k_tile, int r, int kk) {
  double acc[8] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int c = 0; c < HD / 8; ++c) {
    const uint4 qa = *reinterpret_cast<const uint4*>(q_tile + swz<ROWS>(r, c));
    const uint4 ka = *reinterpret_cast<const uint4*>(k_tile + swz<kTK>(kk, c));
    const bf16* qh = reinterpret_cast<const bf16*>(&qa);
    const bf16* kh = reinterpret_cast<const bf16*>(&ka);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] = fma(static_cast<double>(__bfloat162float(qh[e])),
                   static_cast<double>(__bfloat162float(kh[e])), acc[e]);
  }
  const double sum = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                     ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  float x = static_cast<float>(sum);
  if ((__float_as_uint(x) & 0xFFFFu) == 0x8000u && static_cast<double>(x) != sum)
    x = nextafterf(x, sum > static_cast<double>(x) ? INFINITY : -INFINITY);
  return x;
}

// Dynamic shared memory of a block, in bytes from a 1024-byte-aligned base.
// bf16 cache: Q, then the ring of (K tile, V tile) stages, all swizzled for
// wgmma. fp8 cache: Q; the ring of raw stages (the e4m3 head rows of K and
// V as they lie, and each key's 4 bytes from its scale lanes); the bf16 K
// and V tiles they are converted into; each key's two inverse scales.
template <int HD, bool FP8, int ROWS>
struct Smem {
  static constexpr int kTile = kTK * HD * 2;  // one swizzled bf16 K or V tile
  static constexpr int kQ = ROWS * HD * 2;
  static constexpr int kRaw = kTK * HD;       // raw e4m3 K or V tile
  static constexpr int kStage = FP8 ? 2 * kRaw + 4 * kTK : 2 * kTile;
  static constexpr int kRing = kQ;
  static constexpr int kConv = round_up(kRing + kStages * kStage, 1024);
  static constexpr int kInv = kConv + (FP8 ? 2 * kTile : 0);
  static constexpr int kBytes = kInv + (FP8 ? 2 * kTK * 4 : 0);
  static constexpr int kAlloc = kBytes + 1024;  // slack for the alignment
  static_assert(kStages * kStage >= kMaxSplits * ROWS * 4,
                "the merge's weights reuse the ring");
};

// Row b's q_len, seq_len and q_start, staged in shared memory at the
// kernel's start.
struct RowMeta {
  int q_len, seq_len, q_start;
};

// The queries and keys of query tile `tile` (TQ tokens) of a row: its
// first query's position, its token count (0: no work) and its keys
// [lo, kv_end); the splits that meet them; and the keys [beg, end) of the
// split a unit walks (set by the caller, split_keys).
struct TileKeys {
  int first_pos, n_tok, kv_end, lo;
  SplitRange act;
  int beg, end;
};

__device__ __forceinline__ TileKeys tile_keys(const RowMeta& row, int tile,
                                              int TQ, int window, int n_split,
                                              int chunk) {
  TileKeys k{};
  if (row.q_len <= 0 || row.seq_len <= 0 || tile * TQ >= row.q_len) return k;
  k.first_pos = row.seq_len - row.q_len + tile * TQ;
  k.n_tok = min(TQ, row.q_len - tile * TQ);
  k.kv_end = k.first_pos + k.n_tok;
  // The first key any query of the tile can see.
  k.lo = window > 0 ? max(k.first_pos - window + 1, 0) : 0;
  k.act = active_splits(k.lo, k.kv_end, n_split, chunk);
  return k;
}

// Query tiles of a row that hold queries.
__device__ __forceinline__ int row_tiles(const RowMeta& row, int TQ, int q_tiles) {
  if (row.q_len <= 0 || row.seq_len <= 0) return 0;
  return min((row.q_len + TQ - 1) / TQ, q_tiles);
}

// The query tile of a row that holds the row's working unit r (numbered
// tile by tile, n_kv for each split that a tile's keys meet), and r's rank
// within that tile: {tile, rank}. The lanes of a warp take 32 tiles at a
// time, and every lane returns the same. r must be below the row's units.
// Out of line: the persistent loop around the unit's tile walk takes it
// only for split rows, and its registers stay out of that loop's.
__device__ __noinline__ int2 find_tile(RowMeta row, int r, int TQ, int tiles,
                                       int window, int n_split, int chunk,
                                       int n_kv) {
  const int lane = threadIdx.x % 32;
  for (int t0 = 0;; t0 += 32) {
    const int t = t0 + lane;
    const int c = t < tiles
        ? tile_keys(row, t, TQ, window, n_split, chunk).act.count * n_kv : 0;
    int incl = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, r < incl);
    if (hit != 0) {
      const int l = __ffs(hit) - 1;
      return make_int2(t0 + l, r - __shfl_sync(0xffffffffu, incl - c, l));
    }
    r -= __shfl_sync(0xffffffffu, incl, 31);
  }
}

// One unit of work: query tile `tile` of row b, kv head h, split `split`;
// returns at once for a unit that has no query or no key of the split. The
// split's keys are tk.beg .. tk.end - 1; n_split (the plan's) places the
// partial states of a split row. Every thread of the block takes the same
// path through it.
template <int HD, int GMAX, typename KV, bool BF16S, int ROWS>
__device__ __forceinline__ void prefill_unit(
    const bf16* __restrict__ q, const KV* __restrict__ cache,
    const int* __restrict__ page_table, const RowMeta& row,
    bf16* __restrict__ out, int Pg, int n_kv, int S, int layer, int page_size,
    int window, float sm_scale, int n_split,
    float* __restrict__ part_acc, float* __restrict__ part_ml,
    int* __restrict__ counters, int b, int tile, int h, int split, int q_tiles,
    int group, const TileKeys& tk, uint8_t* smem_raw) {
  constexpr int SL = ScaleLanes<KV>::value;
  constexpr bool FP8 = SL > 0;
  static_assert(!BF16S || !FP8, "bf16 scores take a bf16 cache");
  using SM = Smem<HD, FP8, ROWS>;
  constexpr int kThreads = ROWS * 2;   // a warpgroup for every 64 rows
  constexpr int TPK = kThreads / kTK;  // threads that copy one key's rows
  constexpr int TQ = ROWS / GMAX;      // query tokens of a block
  constexpr int VPR = HD / 8;        // 16-byte chunks of a bf16 head row
  constexpr int NK = HD / 16;        // k16 steps of Q.K^T
  constexpr int NO = HD / 2;         // output accumulators a thread
  const SplitRange act = tk.act;
  if (tk.n_tok <= 0 || split < act.first || split >= act.first + act.count) return;
  const int n_q = n_kv * group;
  const int KH = n_kv * HD;
  const int W = 2 * KH + SL;
  const int tok0 = row.q_start + tile * TQ;  // flat token of query 0
  const int first_pos = tk.first_pos;        // its position
  const int n_tok = tk.n_tok;
  const int kv_end = tk.kv_end;              // keys [0, kv_end)
  const int k_beg = tk.beg, k_end = tk.end;
  const int n_tiles = (k_end - k_beg + kTK - 1) / kTK;
  const int64_t layer_off = static_cast<int64_t>(layer) * S * W;
  const int* pt = page_table + static_cast<int64_t>(b) * Pg;
  const int n_pages = S / page_size;

  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  uint8_t* sm = smem_raw + (base - raw_addr);
  const uint32_t sQ = base;

  const int tid = threadIdx.x;

  // Q: row r = g * TQ + qi is token qi of the tile, query head h*group + g;
  // rows of no token, and the dead bands g >= group, are zero.
  for (int i = tid; i < ROWS * VPR; i += kThreads) {
    const int r = i / VPR;
    const int c = i % VPR;
    const int g = r / TQ;
    const int qi = r % TQ;
    const bool ok = qi < n_tok && g < group;
    const bf16* src =
        ok ? q + (static_cast<int64_t>(tok0 + qi) * n_q + h * group + g) * HD + c * 8 : q;
    cp_async16(sQ + swz<ROWS>(r, c), src, ok);
  }

  // Stage key tile t (keys k_beg + t*kTK ..) into ring stage st: threads
  // TPK*k .. TPK*k+TPK-1 copy key k's head rows, from cache slot `slot`
  // (see slot_at); keys past k_end are zero.
  const int kk_ld = tid / TPK;
  auto slot_at = [&](int t) -> int64_t {
    const int pos = k_beg + t * kTK + kk_ld;
    return pos < k_end ? slot_of(pt, pos, Pg, page_size, n_pages) : -1;
  };
  auto load_tile = [&](int st, int64_t slot) {
    const uint32_t stage = base + SM::kRing + st * SM::kStage;
    const int kk = kk_ld;
    const int part = tid % TPK;
    const bool ok = slot >= 0;
    const KV* row = cache + layer_off + (ok ? slot : 0) * W;
    if constexpr (FP8) {
      constexpr int CPR = HD / 16;  // 16-byte chunks of an e4m3 head row
      const uint8_t* rb = reinterpret_cast<const uint8_t*>(row);
#pragma unroll
      for (int c = part * CPR / TPK; c < (part + 1) * CPR / TPK; ++c) {
        cp_async16(stage + kk * HD + c * 16, rb + h * HD + c * 16, ok);
        cp_async16(stage + SM::kRaw + kk * HD + c * 16, rb + KH + h * HD + c * 16, ok);
      }
      if (part == 0) cp_async4(stage + 2 * SM::kRaw + kk * 4, rb + 2 * KH, ok);
    } else {
#pragma unroll
      for (int c = part * VPR / TPK; c < (part + 1) * VPR / TPK; ++c) {
        cp_async16(stage + swz<kTK>(kk, c), row + h * HD + c * 8, ok);
        cp_async16(stage + SM::kTile + swz<kTK>(kk, c), row + KH + h * HD + c * 8, ok);
      }
    }
  };

  // Warpgroup wg holds rows 64*wg .. 64*wg+63. The thread's two rows of
  // every fragment: r0 = 64*wg + 16*warp + lane/4 and r0 + 8; its columns
  // 8j + 2*(lane%4) + {0, 1}. Accumulator index 4j + 2i + c is row r0 + 8i,
  // column 8j + 2*(lane%4) + c.
  const int wg = tid / 128;
  const int warp = (tid % 128) / 32;
  const int lane = tid % 32;
  const int cq = (lane % 4) * 2;
  const int r0 = 64 * wg + 16 * warp + lane / 4;
  int qpos[2];
  bool rok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = (r0 + 8 * i) % TQ;
    qpos[i] = first_pos + qi;
    rok[i] = qi < n_tok && (r0 + 8 * i) / TQ < group;
  }
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};  // this thread's columns only; summed at the end
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const float k2 = BF16S ? 1.f : sm_scale * kLog2e;  // score -> log2 space
  const float k2e_b = round_bf16(sm_scale * kLog2e);

  // The page-table reads run one tile ahead of the copies they address:
  // tile t+2's slot is read while tile t computes.
  // Tiles 0 and 1 go out together. Then one barrier a tile: past it, tile
  // t has landed for every thread and every warp is done with tile t-1,
  // whose stage tile t+1 refills while tile t computes (warpgroups may
  // drift apart by up to a tile).
  load_tile(0, slot_at(0));
  cp_async_commit();
  if (n_tiles > 1) {
    load_tile(1, slot_at(1));
    cp_async_commit();
  }
  int64_t slot_next = n_tiles > 2 ? slot_at(2) : -1;
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % kStages;
    if (t == 0 && n_tiles > 1)
      cp_async_wait<1>();  // Q and tile 0 have landed (this thread's copies)
    else
      cp_async_wait<0>();  // tile t has landed
    fence_proxy_async();
    __syncthreads();
    if (t >= 1 && t + 1 < n_tiles) {
      load_tile((t + 1) % kStages, slot_next);
      cp_async_commit();
      slot_next = t + 2 < n_tiles ? slot_at(t + 2) : -1;
    }
    const uint32_t stage = base + SM::kRing + st * SM::kStage;
    uint32_t sK = stage, sV = stage + SM::kTile;
    const float* inv_k = nullptr;
    const float* inv_v = nullptr;
    if constexpr (FP8) {
      // e4m3 -> bf16 into the swizzled tiles (exact), and the scales.
      const uint8_t* raw = sm + (stage - base);
      sK = base + SM::kConv;
      sV = sK + SM::kTile;
      constexpr int CPR = HD / 16;
      for (int i = tid; i < 2 * kTK * CPR; i += kThreads) {
        const int v = i / (kTK * CPR);
        const int kk = (i / CPR) % kTK;
        const int c = i % CPR;
        const fp8* src = reinterpret_cast<const fp8*>(raw + v * SM::kRaw + kk * HD + c * 16);
        uint8_t* dst = sm + SM::kConv + v * SM::kTile;
        *reinterpret_cast<uint4*>(dst + swz<kTK>(kk, 2 * c)) = load8_bf16(src);
        *reinterpret_cast<uint4*>(dst + swz<kTK>(kk, 2 * c + 1)) = load8_bf16(src + 8);
      }
      float* inv = reinterpret_cast<float*>(sm + SM::kInv);
      if (tid < kTK) {
        const fp8* sc = reinterpret_cast<const fp8*>(raw + 2 * SM::kRaw + tid * 4);
        inv[tid] = inv_scale(sc[0]);
        inv[kTK + tid] = inv_scale(sc[1]);
      }
      fence_proxy_async();
      __syncthreads();
      inv_k = inv;
      inv_v = inv + kTK;
    }

    // S = Q . K^T over the tile's 64 keys.
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const uint32_t off = (kk >> 2) * (ROWS * 128) + wg * (64 * 128) + (kk & 3) * 32;
      const uint32_t koff = (kk >> 2) * (kTK * 128) + (kk & 3) * 32;
      wgmma_ss_n64(s, sw128_desc(sQ + off, 16, 1024),
                   sw128_desc(sK + koff, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Masks and the online softmax, on the fragments. vis bit n: entry n
    // is a visible key of its row: in the row's window, at or before its
    // position, and this split's (a tile may run past k_end into the next
    // split's keys, zero-filled here). A tile whose keys every query of the
    // block sees (all at or before the first query, none below the last
    // query's window, none past k_end) takes no mask; rows of no token then
    // compute on zero queries, finite and never written (so do the dead
    // bands of a group below GMAX).
    const int k0 = k_beg + t * kTK;
    const bool full = k0 + kTK - 1 <= first_pos && k0 + kTK <= k_end &&
                      (window <= 0 || k0 >= kv_end - window);
    uint32_t vis = 0xffffffffu;
    if (!full) {
      vis = 0;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (!rok[i]) continue;
        // key k0 + kc is visible iff lo_i <= key <= min(qpos, k_end - 1):
        // one unsigned comparison of key - lo_i.
        const int lo_i = window > 0 ? qpos[i] - window + 1 : 0;
        const unsigned span = static_cast<unsigned>(min(qpos[i], k_end - 1) - lo_i);
        const int d0 = k0 + cq - lo_i;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int n = 4 * (e >> 1) + 2 * i + (e & 1);
          const unsigned d = static_cast<unsigned>(d0 + 8 * (e >> 1) + (e & 1));
          vis |= static_cast<uint32_t>(d <= span) << n;
        }
      }
    }
    if constexpr (BF16S) {
      // The running maximum is a raw score rounded to bf16, and every
      // probability of the row is rounded against it, so its rounding must
      // be the exact value's. wgmma sums in f32 with truncation, a few f32
      // steps from the exact sum: a score within a bf16 step of the row's
      // largest in the tile whose sum lies within 32 f32 steps of a bf16
      // rounding midpoint (16 low bits 0x8000) is summed again exactly.
      // (Other scores keep the wgmma sum: one that rounds the other way
      // moves its own probability by a bf16 step.)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float top = kNegBig;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int n = 4 * (e >> 1) + 2 * i + (e & 1);
          if ((vis >> n) & 1) top = fmaxf(top, s[n]);
        }
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
        const float near = top - fabsf(top) * (1.f / 64);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int n = 4 * (e >> 1) + 2 * i + (e & 1);
          if (((vis >> n) & 1) && s[n] >= near &&
              (__float_as_uint(s[n]) & 0xFFFFu) - 0x7FE0u <= 0x40u)
            s[n] = exact_score<HD, ROWS>(sm, sm + (sK - base), r0 + 8 * i,
                                         8 * (n >> 2) + cq + (n & 1));
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      float x = BF16S ? round_bf16(s[n]) : s[n] * k2;
      if constexpr (FP8) x *= inv_k[8 * (n >> 2) + cq + (n & 1)];
      s[n] = x;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float tmax = kNegBig;
#pragma unroll
      for (int n = 0; n < 32; ++n)
        if (((n >> 1) & 1) == i && ((vis >> n) & 1)) tmax = fmaxf(tmax, s[n]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      float mn;
      if constexpr (BF16S)
        mn = fmaxf(m[i], tmax == kNegBig ? kNegBig : tmax * (sm_scale * kLog2e));
      else
        mn = fmaxf(m[i], tmax);
      const float c = exp2f(m[i] - mn);
      const float mn_b = round_bf16(mn);
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        if (((n >> 1) & 1) != i) continue;
        float p = 0.f;
        if ((vis >> n) & 1) {
          if constexpr (BF16S)
            p = round_bf16(exp2f(round_bf16(round_bf16(s[n] * k2e_b) - mn_b)));
          else
            p = exp2f(s[n] - mn);
        }
        rsum += p;
        if constexpr (FP8) p *= inv_v[8 * (n >> 2) + cq + (n & 1)];
        s[n] = p;  // P, f32 until the bf16 fragments below
      }
      l[i] = l[i] * c + rsum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j + 2 * i] *= c;
        o[4 * j + 2 * i + 1] *= c;
      }
    }

    // O += P . V: P's fragments for keys 16kk .. 16kk+15 are accumulator
    // entries 8kk .. 8kk+7, in the A-operand order. P goes in as two bf16
    // terms, hi = bf16(p) and lo = bf16(p - hi), two products on one V
    // tile; the bf16-score variant's P is bf16 already (lo = 0).
    uint32_t pa[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = s[8 * kk + 2 * e], b = s[8 * kk + 2 * e + 1];
        pa[kk][e] = pack_bf16(a, b);
        pl[kk][e] = pack_bf16(a - round_bf16(a), b - round_bf16(b));
      }
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (16 * kk >= k_end - k0) break;  // keys past the split: P is 0
      const uint64_t dv = sw128_desc(sV + kk * 16 * 128, kTK * 128, 1024);
      if constexpr (HD == 128) {
        wgmma_rs_n128(o, pa[kk], dv);
        if constexpr (!BF16S) wgmma_rs_n128(o, pl[kk], dv);
      } else {
        wgmma_rs_n64(o, pa[kk], dv);
        if constexpr (!BF16S) wgmma_rs_n64(o, pl[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  auto out_row = [&](int r) -> bf16* {
    const int qi = r % TQ;
    if (qi >= n_tok || r / TQ >= group) return nullptr;
    return out + (static_cast<int64_t>(tok0 + qi) * n_q + h * group + r / TQ) * HD;
  };
  if (act.count == 1) {
    // The output: each warp stages its 16 rows in bf16 in its own rows of
    // the Q tile (its warpgroup's products are done with them), then stores
    // them 16 bytes a lane, a row's 16-byte chunks on neighbouring lanes.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float inv = rok[i] ? 1.f / l[i] : 0.f;  // l > 0: a query sees itself
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(sm + swz<ROWS>(r0 + 8 * i, j) + 2 * cq) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    __syncwarp();
    const int rw = 64 * wg + 16 * warp;  // the warp's first row
#pragma unroll
    for (int e = lane; e < 16 * VPR; e += 32) {
      bf16* o_row = out_row(rw + e / VPR);
      if (o_row != nullptr)
        *reinterpret_cast<uint4*>(o_row + 8 * (e % VPR)) =
            *reinterpret_cast<const uint4*>(sm + swz<ROWS>(rw + e / VPR, e % VPR));
    }
    return;
  }
  // Several active splits: this split's partial state, then the merge.
  const int64_t unit = (static_cast<int64_t>(b) * q_tiles + tile) * n_kv + h;
  float* acc = part_acc + unit * n_split * ROWS * HD;
  float* ml = part_ml + unit * n_split * ROWS * 2;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (cq == 0)
      *reinterpret_cast<float2*>(ml + (static_cast<int64_t>(split) * ROWS + r) * 2) =
          make_float2(m[i], l[i]);
    if (!rok[i]) continue;
    float* a = acc + (static_cast<int64_t>(split) * ROWS + r) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(a + 8 * j + cq) =
          make_float2(o[4 * j + 2 * i], o[4 * j + 2 * i + 1]);
  }
  if (arrive_last(counters + unit, act.count))
    merge_splits<HD>(acc, ml, act.first, act.count, ROWS,
                     reinterpret_cast<float*>(sm + SM::kRing), out_row);
}

// A persistent grid. A unit of work is (row, query tile, split, kv head);
// most units of a bucket have none (decode rows, tiles past a row's q_len,
// splits past its keys). Every block stages each row's q_len, seq_len and
// q_start in shared memory, counts each row's working units (n_kv for each
// split that each of its tiles' keys meet) and takes their running sum; the
// working units, numbered in (row, tile, split, kv head) order, are then
// handed out as the blocks free up. Rows from split_rows on are not split
// (their tiles walk all their keys as one split).
template <int HD, int GMAX, typename KV, bool BF16S, int ROWS>
__global__ void __launch_bounds__(ROWS * 2)
paged_prefill_kernel(const bf16* __restrict__ q, const KV* __restrict__ cache,
                     const int* __restrict__ page_table,
                     const int* __restrict__ q_starts,
                     const int* __restrict__ q_lens,
                     const int* __restrict__ seq_lens, bf16* __restrict__ out,
                     int T, int B, int q_tiles, int Pg, int n_kv, int S,
                     int layer, int page_size, int window, float sm_scale,
                     int n_split, int chunk, int split_rows,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int* __restrict__ counters, int q_at, int group) {
  using SM = Smem<HD, (ScaleLanes<KV>::value > 0), ROWS>;
  constexpr int TQ = ROWS / GMAX;
  extern __shared__ uint8_t smem_raw[];
  RowMeta* rows = reinterpret_cast<RowMeta*>(smem_raw + SM::kAlloc);
  int* start = reinterpret_cast<int*>(rows + B);  // [B + 1]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int n_warps = blockDim.x / 32;
  for (int i = threadIdx.x; i < B; i += blockDim.x)
    rows[i] = RowMeta{q_lens[i], seq_lens[i], q_starts[i]};
  __syncthreads();
  // Tokens of no row (T > 0): zero, written here, a warp a token in turn.
  if (T > 0) {
    const int n_vec = n_kv * group * HD / 8;  // 16-byte stores a token
    for (int t = blockIdx.x * n_warps + warp; t < T; t += gridDim.x * n_warps) {
      bool row_tok = false;
      for (int i = lane; i < B; i += 32)
        row_tok |= rows[i].q_len > 0 && rows[i].seq_len > 0 &&
                   t >= rows[i].q_start && t < rows[i].q_start + rows[i].q_len;
      if (__any_sync(0xffffffffu, row_tok)) continue;
      uint4* o = reinterpret_cast<uint4*>(out + static_cast<int64_t>(t) * n_vec * 8);
      for (int e = lane; e < n_vec; e += 32) o[e] = make_uint4(0, 0, 0, 0);
    }
  }
  // Each row's working units: a warp a row, its lanes over the row's tiles.
  for (int b = warp; b < B; b += n_warps) {
    const RowMeta row = rows[b];
    const int ns = b < split_rows ? n_split : 1;
    const int tiles = row_tiles(row, TQ, q_tiles);
    int n = 0;
    if (ns == 1)
      n = lane == 0 ? tiles : 0;  // one split for every tile with queries
    else
      for (int t = lane; t < tiles; t += 32)
        n += tile_keys(row, t, TQ, window, ns, chunk).act.count;
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) start[b + 1] = n * n_kv;
  }
  __syncthreads();
  if (warp == 0) {  // running sum: a lane a segment, then the lanes
    const int seg = (B + 31) / 32;
    const int beg = min(lane * seg, B), end = min(beg + seg, B);
    int sum = 0;
    for (int i = beg; i < end; ++i) sum += start[i + 1];
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - sum;
    for (int i = beg; i < end; ++i) {
      run += start[i + 1];
      start[i + 1] = run;
    }
    if (lane == 0) start[0] = 0;
  }
  __syncthreads();
  // Working unit a: blockIdx.x first, then, as each unit ends, the next
  // free one from the queue (counters[q_at]: taken so far past the first
  // gridDim.x; the last block out resets it), so a block that drew short
  // units draws more; without counters, every gridDim.x-th.
  const int total = start[B];
  int* queue = counters == nullptr ? nullptr : counters + q_at;
  __shared__ int next_unit;
  for (int a = blockIdx.x; a < total;) {
    int lo = 0, hi = B - 1;  // the row whose units hold a
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (start[mid] <= a) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const RowMeta row = rows[b];
    const int ns = b < split_rows ? n_split : 1;
    int r = a - start[b];  // its rank in the row, then in its tile
    int tile;
    if (ns == 1) {
      tile = r / n_kv;
      r %= n_kv;
    } else {
      const int2 tr = find_tile(row, r, TQ, row_tiles(row, TQ, q_tiles),
                                window, ns, chunk, n_kv);
      tile = tr.x;
      r = tr.y;
    }
    TileKeys k = tile_keys(row, tile, TQ, window, ns, chunk);
    const int split = k.act.first + r / n_kv;
    split_keys(split, ns, chunk, k.lo, k.kv_end, k.beg, k.end);
    prefill_unit<HD, GMAX, KV, BF16S, ROWS>(
        q, cache, page_table, row, out, Pg, n_kv, S, layer, page_size, window,
        sm_scale, n_split, part_acc, part_ml, counters, b, tile, r % n_kv,
        split, q_tiles, group, k, smem_raw);
    if (threadIdx.x == 0)
      next_unit = queue ? gridDim.x + atomicAdd(queue, 1) : a + gridDim.x;
    __syncthreads();  // the unit's shared memory is free for the next
    a = next_unit;
    __syncthreads();
  }
  if (threadIdx.x == 0 && queue &&
      atomicAdd(queue + 1, 1) == static_cast<int>(gridDim.x) - 1) {
    queue[0] = 0;
    queue[1] = 0;
  }
}

// Per card (a process may drive several): the dynamic shared memory an
// instance is allowed, and its grid (blocks an SM holds at the shared
// memory it was worked out for, times the SMs).
struct LaunchState {
  int smem_set, grid_smem, grid_max;
};
constexpr int kMaxDevices = 64;

template <int HD, int GMAX, typename KV, bool BF16S, int ROWS>
int launch_rows(const void* q, const void* cache, const void* pt,
                const void* q_starts, const void* q_lens, const void* seq_lens,
                void* out, int T, int B, int q_bucket, int Pg, int n_kv, int S,
                int layer, int page_size, int window, float sm_scale,
                int n_split, int chunk, int split_rows, void* part_acc,
                void* part_ml, void* counters, int group, cudaStream_t stream) {
  constexpr int TQ = ROWS / GMAX;
  constexpr int kBase = Smem<HD, (ScaleLanes<KV>::value > 0), ROWS>::kAlloc;
  auto kernel = paged_prefill_kernel<HD, GMAX, KV, BF16S, ROWS>;
  if (B < 1 || n_split < 1 || n_split > kMaxSplits || chunk < kTK ||
      chunk % kTK || split_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  split_rows = n_split > 1 ? min(split_rows, B) : 0;
  const int q_tiles = (q_bucket + TQ - 1) / TQ;
  const int64_t smem64 = kBase + static_cast<int64_t>(B) * sizeof(RowMeta) +
                         (static_cast<int64_t>(B) + 1) * 4;
  if (smem64 > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(smem64);
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidValue);
  static LaunchState state[kMaxDevices] = {};
  LaunchState& ls = state[dev];
  if (smem > ls.smem_set) {  // fails past the card's shared memory
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ls.smem_set = smem;
  }
  if (ls.grid_smem != smem) {
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, ROWS * 2, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    ls.grid_max = sms * (per_sm > 0 ? per_sm : 1);
    ls.grid_smem = smem;
  }
  const int64_t n_units = static_cast<int64_t>(B) * q_tiles * n_kv * n_split;
  const int grid = static_cast<int>(n_units < ls.grid_max ? n_units : ls.grid_max);
  kernel<<<grid, ROWS * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const KV*>(cache),
      static_cast<const int*>(pt), static_cast<const int*>(q_starts),
      static_cast<const int*>(q_lens), static_cast<const int*>(seq_lens),
      static_cast<bf16*>(out), T, B, q_tiles, Pg, n_kv, S, layer, page_size,
      window, sm_scale, n_split, chunk, split_rows, static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(counters),
      split_rows * q_tiles * n_kv, group);
  return static_cast<int>(cudaGetLastError());
}

// One launch. Blocks of 128 query rows (two warpgroups sharing every K/V
// tile) at head_dim 128 when the bucket fills them (q_bucket * GMAX >=
// 128), else of 64 (ops/paged_attention.py:prefill_rows, the same rule).
template <int HD, int GMAX, typename KV, bool BF16S = false>
int launch(const void* q, const void* cache, const void* pt,
           const void* q_starts, const void* q_lens, const void* seq_lens,
           void* out, int T, int B, int q_bucket, int Pg, int n_kv, int S,
           int layer, int page_size, int window, float sm_scale, int n_split,
           int chunk, int split_rows, void* part_acc, void* part_ml,
           void* counters, int group, cudaStream_t stream) {
  if constexpr (HD == 128) {
    if (q_bucket * GMAX >= 128)
      return launch_rows<HD, GMAX, KV, BF16S, 128>(
          q, cache, pt, q_starts, q_lens, seq_lens, out, T, B, q_bucket, Pg,
          n_kv, S, layer, page_size, window, sm_scale, n_split, chunk,
          split_rows, part_acc, part_ml, counters, group, stream);
  }
  return launch_rows<HD, GMAX, KV, BF16S, 64>(
      q, cache, pt, q_starts, q_lens, seq_lens, out, T, B, q_bucket, Pg, n_kv,
      S, layer, page_size, window, sm_scale, n_split, chunk, split_rows,
      part_acc, part_ml, counters, group, stream);
}

}  // namespace
}  // namespace swiftllm

// (head_dim, GMAX) instances; every group from 1 to 8 runs under the least
// GMAX at or above it (gqa_bound).
#define SWIFTLLM_PREFILL_INSTANCES(CASE) \
  CASE(64, 1) CASE(64, 2) CASE(64, 4) CASE(64, 8)   \
  CASE(128, 1) CASE(128, 2) CASE(128, 4) CASE(128, 8)

// C entries, bound with ctypes. q_bucket bounds every row's q_len; it sets
// the grid's tile axis (rows / GMAX tokens a tile). Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// head_dim other than 64 and 128, a GQA group (n_q / n_kv) that is not a
// whole number from 1 to 8, or a plan it cannot take.
//
// paged_prefill_attention: kv_fp8 != 0: the cache holds e4m3 rows with the
// scale lanes; else bf16. window: 0 = full causal. n_split, chunk: the split
// plan (1 and any multiple of 64 covering the keys: no split), for rows
// below split_rows (R, at most B; rows from R on walk their keys as one
// split); part_acc (f32 [R * tiles * n_kv * n_split * rows * hd]) and
// part_ml (f32 [... * rows * 2]) the partial states, unused when n_split is
// 1 (rows: 64 or 128, ops/paged_attention.py:prefill_rows); counters (int32
// [R * tiles * n_kv + 2], zero) the arrival counters and the work queue,
// left zero. T: the tokens of q and out; the kernel writes zeros at the
// tokens of no row.
extern "C" int paged_prefill_attention(
    const void* q, const void* cache, const void* page_table,
    const void* q_starts, const void* q_lens, const void* seq_lens, void* out,
    int B, int q_bucket, int Pg, int n_q, int n_kv, int hd, int S, int layer,
    int page_size, int window, int kv_fp8, float sm_scale, int n_split,
    int chunk, int split_rows, void* part_acc, void* part_ml, void* counters,
    int T, void* stream) {
  using namespace swiftllm;
  const int group = n_kv > 0 ? n_q / n_kv : 0;
  const int gmax = gqa_bound(n_q, n_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_PREFILL_CASE(HD_, G_)                                          \
  if (hd == HD_ && gmax == G_) {                                                \
    if (kv_fp8)                                                                 \
      return launch<HD_, G_, fp8>(q, cache, page_table, q_starts, q_lens,       \
                                  seq_lens, out, T, B, q_bucket, Pg, n_kv, S,   \
                                  layer, page_size, window, sm_scale, n_split,  \
                                  chunk, split_rows, part_acc, part_ml,         \
                                  counters, group, st);                         \
    return launch<HD_, G_, bf16>(q, cache, page_table, q_starts, q_lens,        \
                                 seq_lens, out, T, B, q_bucket, Pg, n_kv, S,    \
                                 layer, page_size, window, sm_scale, n_split,   \
                                 chunk, split_rows, part_acc, part_ml,          \
                                 counters, group, st);                          \
  }
  SWIFTLLM_PREFILL_INSTANCES(SWIFTLLM_PREFILL_CASE)
#undef SWIFTLLM_PREFILL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// paged_prefill_attention_bf16s: the bf16-score variant. A bf16 cache and no
// window (the TPU kernel's gate): it takes neither argument, and no split;
// tokens of no row are left as the caller allocated them, and its blocks
// take every gridDim.x-th working unit (no queue).
extern "C" int paged_prefill_attention_bf16s(
    const void* q, const void* cache, const void* page_table,
    const void* q_starts, const void* q_lens, const void* seq_lens, void* out,
    int B, int q_bucket, int Pg, int n_q, int n_kv, int hd, int S, int layer,
    int page_size, float sm_scale, void* stream) {
  using namespace swiftllm;
  const int group = n_kv > 0 ? n_q / n_kv : 0;
  const int gmax = gqa_bound(n_q, n_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_PREFILL_CASE(HD_, G_)                                          \
  if (hd == HD_ && gmax == G_)                                                  \
    return launch<HD_, G_, bf16, true>(q, cache, page_table, q_starts, q_lens,  \
                                       seq_lens, out, 0, B, q_bucket, Pg, n_kv, \
                                       S, layer, page_size, 0, sm_scale, 1, 64, \
                                       0, nullptr, nullptr, nullptr, group, st);
  SWIFTLLM_PREFILL_INSTANCES(SWIFTLLM_PREFILL_CASE)
#undef SWIFTLLM_PREFILL_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef SWIFTLLM_PREFILL_INSTANCES
