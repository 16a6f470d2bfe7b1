// Paged decode attention with the KV-cache write fused in.
//
// Replaces: swiftllm_tpu/ops/paged_attention.py:_decode_kernel_grouped (the
// q_bucket == 1 branch of ragged_paged_attention).
//
// What it computes: for every valid decode row b (q_lens[b] > 0; flat token b
// is row b) it writes the kv heads' K and V lanes of kv_new[b] into
// cache[layer, kv_slots[b]], and attends each kv head's `group` query heads over
// the row's seq_lens[b] keys: positions 0 .. seq_len-2 come from the pages in
// page_table[b], position seq_len-1 (the new token) straight from kv_new[b].
// Rows that are not valid decode rows, and tokens past the row axis, get
// zeros.
//
// Three variants of the same body, as in the TPU kernel:
// - An fp8 cache (the KV template parameter): rows of e4m3 bytes that end in
//   128 scale lanes (common.cuh). The bytes are converted to f32 in
//   registers; the score is (q . k_stored) * sm_scale / k_scale, and the
//   probability meets V as p / v_scale, while l sums the unscaled p. The new
//   token is read from kv_new as stored (quantized), un-scaled by its own
//   lanes. One lane of each key reads the key's two scale bytes and passes
//   them to the others by shuffle. The fused write copies bytes, the scale
//   lanes with kv head 0.
// - A sliding window (`window` > 0): the query at position seq_len-1 sees
//   keys in (seq_len-1-window, seq_len-1]; keys below the window are never
//   read.
// - Deferred commit (the PEND template parameter; the TPU kernel's `pend`
//   mode, for multi-step windows whose tokens are committed to the cache
//   once, after the window): the fused write does not run, kv_slots is not
//   read and the cache is only read. The row's cached history is
//   hist = max(seq_len - npend, 0) keys; position pos comes from the pages
//   for pos < hist, from kv_pend[layer, pos - hist, b] for
//   hist <= pos < seq_len - 1 (the window's npend - 1 completed tokens, in a
//   plain [L, P, B, W] buffer), and from kv_new[b] for the last. Pending
//   slots from npend - 1 on hold stale rows and are never addressed. npend
//   is the same for every row. bf16 rows only; `window` is honoured.
//
// GQA groups: any group from 1 to 8. The kernel is compiled for a bound
// GMAX in {1, 2, 4, 8} (its register arrays and vector widths) and takes the
// real group, the least GMAX at or above it, as an argument: head rows
// g >= group are never loaded or written (their query is zero, so their
// scores and sums stay finite and are dropped), and the partial states are
// laid out by the real group. A group that is a power of two runs as before.
//
// What bounds it on the H100: bytes. Each key costs 2*HD*2 bytes of K and V
// per kv head in bf16 (half that in fp8) and 4*group*HD flops, far below the
// ~295 flops/byte at which the tensor cores would become the limit, so the
// kernel's job is to keep every SM streaming the rows' pages at once.
//
// What this design does about it:
// - Split-KV. The wrapper's planner (split_plan, host integers only) cuts
//   the keys of each row below split_rows (the rows the batch builder says
//   may be live) into splits of `chunk` keys, enough for several blocks per
//   SM over those rows; the last block of a (row, kv head) to finish merges
//   the splits' partial states (splitkv.cuh), with no second launch. The
//   grid is one block for every (token, kv head), split 0, and then one for
//   every further split of the rows below split_rows, so rows past them (as
//   a decode bucket's empty rows) cost one block each. A row past them that
//   is valid all the same walks its keys as one split. All the query heads
//   of the kv head share every K/V byte a block reads.
// - Bytes in flight. Each key is read by HD/kVec lanes, 16 bytes each (8
//   bf16, or 16 e4m3); a warp covers 32*kVec/HD keys a step and issues the
//   loads of U steps before it uses any (U = 4 in bf16, 2 in fp8 and at a group
//   bound of 8), so each lane has 64 or 32 bytes of K and V in flight ahead of
//   the softmax. The U keys of a lane then take one online-softmax update.
//   (At a group bound of 8 an fp8 lane loads 8 bytes: 16 values of 8 heads would
//   not fit the registers.) Page ids are read a step ahead of the loads
//   they address. A block has 8 warps where its (row, kv head) is not
//   split (its one walk gets the most keys in flight), 4 where it is (more
//   blocks share each SM).
// - The fused write: exactly one block per (row, kv head) does it, split 0.
//   It races with nothing: blocks of different kv heads write disjoint lanes
//   of one slot, and no block reads the slot being written (the history ends
//   at seq_len-2 and the new key is read from kv_new). Split 0 also writes
//   the zeros of rows that are not valid.

#include <type_traits>

#include "common.cuh"
#include "splitkv.cuh"

namespace swiftllm {
namespace {

constexpr float kLog2e = 1.4426950408889634f;

// 16 bytes as eight bf16 -> eight floats (load8 of common.cuh, by value).
__device__ __forceinline__ void cvt(const uint4& u, const bf16*, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// n e4m3 bytes (8 or 16) -> n floats (e4m3 -> f16 is exact).
template <typename Raw>
__device__ __forceinline__ void cvt(const Raw& u, const fp8*, float* f) {
  constexpr int n = sizeof(Raw);
  const __nv_fp8x2_storage_t* h = reinterpret_cast<const __nv_fp8x2_storage_t*>(&u);
#pragma unroll
  for (int i = 0; i < n / 2; ++i) {
    const float2 t = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(h[i], __NV_E4M3)));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// One level of the key groups' reduce-scatter (step 5 of the kernel): of
// the 2*HALF dims a lane holds in acc[g][0 .. 2*HALF), it keeps the upper
// half if `upper`, else the lower, adds its partner's (lane ^ off) copy of
// them, and leaves the sums in acc[g][0 .. HALF).
template <int HALF, int GMAX, int VEC>
__device__ __forceinline__ void scatter_half(float (&acc)[GMAX][VEC], bool upper,
                                             int off, int& part) {
  part += upper ? HALF : 0;
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int e = 0; e < HALF; ++e) {
      const float lo = acc[g][e], hi = acc[g][e + HALF];
      const float sent = __shfl_xor_sync(0xffffffffu, upper ? lo : hi, off);
      acc[g][e] = (upper ? hi : lo) + sent;
    }
}

template <int HD, int GMAX, typename KV, bool PEND, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
paged_decode_kernel(const bf16* __restrict__ q, KV* __restrict__ cache,
                    const KV* __restrict__ kv_new,
                    const KV* __restrict__ kv_pend,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_lens,
                    const int* __restrict__ seq_lens,
                    const int* __restrict__ kv_slots, bf16* __restrict__ out,
                    int B, int Pg, int n_kv, int S, int layer, int page_size,
                    int window, int npend, int P, float sm_scale, int n_split,
                    int chunk, int split_rows, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int* __restrict__ counters,
                    int group) {
  constexpr int SL = ScaleLanes<KV>::value;
  constexpr bool FP8 = SL > 0;
  constexpr int kVec = (FP8 && GMAX <= 4) ? 16 : 8;  // cache values a lane
  using Raw = typename std::conditional<kVec * sizeof(KV) == 16, uint4, uint2>::type;
  constexpr int LPK = HD / kVec;  // lanes per key
  constexpr int KPW = 32 / LPK;   // keys per warp per step
  // Steps whose loads are in flight at once (fewer where GMAX x kVec
  // accumulators fill the registers).
  constexpr int U = (FP8 || GMAX >= 8) ? 2 : 4;
  // Blocks [0, T * n_kv): (token b, kv head h), split 0; then (row b <
  // split_rows, kv head h, split 1 + ...).
  const int n_first = gridDim.x - split_rows * n_kv * (n_split - 1);
  int b, h, split;
  if (static_cast<int>(blockIdx.x) < n_first) {
    b = blockIdx.x / n_kv;
    h = blockIdx.x % n_kv;
    split = 0;
  } else {
    const int r = blockIdx.x - n_first;
    split = 1 + r / (split_rows * n_kv);
    b = (r / n_kv) % split_rows;
    h = r % n_kv;
  }
  const int n_q = n_kv * group;
  const int KH = n_kv * HD;
  const int W = 2 * KH + SL;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int sub = lane / LPK;
  const int li = lane % LPK;
  bf16* o = out + (static_cast<int64_t>(b) * n_q + h * group) * HD;

  if (b >= B || q_lens[b] <= 0 || seq_lens[b] <= 0) {
    if (split == 0)
      for (int i = tid; i < group * HD; i += blockDim.x) o[i] = __float2bfloat16(0.f);
    return;
  }
  const int seq_len = seq_lens[b];
  const int64_t layer_off = static_cast<int64_t>(layer) * S * W;
  const KV* new_row = kv_new + static_cast<int64_t>(b) * W;

  // 1. This split's keys: the visible ones are lo .. seq_len-1. The page
  //    ids of its first step are read first: they head the chain of loads.
  const int lo = window > 0 ? max(seq_len - window, 0) : 0;
  const int ns = b < split_rows ? n_split : 1;
  const SplitRange act = active_splits(lo, seq_len, ns, chunk);
  const bool active = split >= act.first && split < act.first + act.count;
  int kbeg = 0, kend = 0;
  if (active) split_keys(split, ns, chunk, lo, seq_len, kbeg, kend);
  const int* pt = page_table + static_cast<int64_t>(b) * Pg;
  const int n_pages = S / page_size;
  // Page ids run one step ahead of the loads they address: the next step's
  // are read while this step's K and V are in flight (clamped as slot_of).
  constexpr int kStride = WARPS * KPW * U;
  auto page_at = [&](int pos) -> int {
    return pos < kend ? min(max(pt[min(pos / page_size, Pg - 1)], 0), n_pages - 1) : 0;
  };
  int page[U];
#pragma unroll
  for (int u = 0; u < U; ++u) page[u] = page_at(kbeg + warp * KPW * U + u * KPW + sub);

  // 2. The fused write (split 0): this kv head's K and V lanes of the new
  //    token (and, from kv head 0, the scale lanes). An out-of-range slot is
  //    dropped, as JAX drops an out-of-range scatter.
  if constexpr (!PEND) {
    const int slot = kv_slots[b];
    if (split == 0 && slot >= 0 && slot < S) {
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

  if (!active) return;

  // 3. This lane's slice of the group's query heads, scaled into log2
  //    space; rows from `group` on are zero.
  const float qscale = sm_scale * kLog2e;
  float qf[GMAX][kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    const bf16* qg = q + (static_cast<int64_t>(b) * n_q + h * group + g) * HD + li * kVec;
#pragma unroll
    for (int e = 0; e < kVec; e += 8) {
      const uint4 u = g < group ? *reinterpret_cast<const uint4*>(qg + e) : uint4{};
      cvt(u, qg, &qf[g][e]);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) qf[g][e] *= qscale;
  }
  float m[GMAX], l[GMAX], acc[GMAX][kVec];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = kNegBig;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] = 0.f;
  }

  // 4. The walk. Lane group `sub` of a warp takes key base + u*KPW + sub of
  //    each of the U steps; the loop bound is warp-uniform, so every lane
  //    reaches the shuffles, and a key past kend is skipped (no load, weight
  //    0). Deferred commit: keys from hist on are not in the cache; slot j
  //    of this layer's pending rows for row b is pend_b + j * B * W.
  const int hist = PEND ? max(seq_len - npend, 0) : seq_len;
  const KV* pend_b = nullptr;
  if constexpr (PEND)
    pend_b = kv_pend + (static_cast<int64_t>(layer) * P * B + b) * W;
  for (int base = kbeg + warp * KPW * U; base < kend; base += kStride) {
    Raw kr[U], vr[U];
    bool on[U];
    uint32_t sc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = base + u * KPW + sub;
      on[u] = pos < kend;
      kr[u] = Raw{};
      vr[u] = Raw{};
      sc[u] = 0;
      if (on[u]) {
        const KV* row = new_row;
        if (pos < seq_len - 1) {
          if (!PEND || pos < hist)
            row = cache + layer_off +
                  (static_cast<int64_t>(page[u]) * page_size + pos % page_size) * W;
          else
            row = pend_b + static_cast<int64_t>(pos - hist) * B * W;
        }
        kr[u] = *reinterpret_cast<const Raw*>(row + h * HD + li * kVec);
        vr[u] = *reinterpret_cast<const Raw*>(row + KH + h * HD + li * kVec);
        if constexpr (FP8)
          if (li == 0) sc[u] = *reinterpret_cast<const uint16_t*>(row + 2 * KH);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) page[u] = page_at(base + kStride + u * KPW + sub);
    float ik[U], iv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ik[u] = iv[u] = 1.f;
      if constexpr (FP8) {
        const uint32_t v = __shfl_sync(0xffffffffu, sc[u], lane - li);
        ik[u] = inv_scale(static_cast<fp8>(v & 0xff));
        iv[u] = inv_scale(static_cast<fp8>(v >> 8));
      }
    }
    float s[U][GMAX];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[kVec];
      cvt(kr[u], static_cast<const KV*>(nullptr), kf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < kVec; ++e) d += qf[g][e] * kf[e];
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GMAX; ++g) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
    float p[U][GMAX];
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      float tmax = kNegBig;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] *= ik[u];
        if (on[u]) tmax = fmaxf(tmax, s[u][g]);
      }
      const float mn = fmaxf(m[g], tmax);
      const float c = exp2f(m[g] - mn);
      float rsum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][g] = on[u] ? exp2f(s[u][g] - mn) : 0.f;
        rsum += p[u][g];
        p[u][g] *= iv[u];
      }
      l[g] = l[g] * c + rsum;
      m[g] = mn;
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc[g][e] *= c;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[kVec];
      cvt(vr[u], static_cast<const KV*>(nullptr), vf);
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[g][e] += p[u][g] * vf[e];
    }
  }

  // 5. Merge the KPW key groups of each warp (lanes li, li+LPK, ...): m and
  //    l by butterfly, every group's acc rescaled to the warp's m, then acc
  //    summed by reduce-scatter: each level halves the dims a lane keeps
  //    (the lower half where its bit of the level is 0) and adds its
  //    partner's copy of them. Lane (sub, li) ends with kVec/KPW dims of the
  //    warp's sum, from li*kVec + `part`.
  constexpr int kKeep = kVec / KPW;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    float mw = m[g];
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, off));
    const float f = exp2f(m[g] - mw);  // 0 for a group that saw no key
    l[g] *= f;
#pragma unroll
    for (int off = LPK; off < 32; off <<= 1)
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
    m[g] = mw;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[g][e] *= f;
  }
  int part = 0;
  if constexpr (KPW >= 2) scatter_half<kVec / 2>(acc, lane & LPK, LPK, part);
  if constexpr (KPW >= 4) scatter_half<kVec / 4>(acc, lane & (2 * LPK), 2 * LPK, part);
  if constexpr (KPW >= 8) scatter_half<kVec / 8>(acc, lane & (4 * LPK), 4 * LPK, part);

  // 6. Merge the warps through shared memory: the split's state (M, L, A)
  //    of every head and dim; the output itself when this is the row's only
  //    active split.
  __shared__ float sm_m[WARPS][GMAX];
  __shared__ float sm_l[WARPS][GMAX];
  __shared__ float sm_acc[WARPS][GMAX][HD];
  __shared__ float sm_w[kMaxSplits * GMAX];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < kKeep; ++e) sm_acc[warp][g][li * kVec + part + e] = acc[g][e];
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
  }
  __syncthreads();
  const int64_t unit = static_cast<int64_t>(b) * n_kv + h;
  float* pacc = part_acc + unit * ns * group * HD;  // rows below split_rows
  float* pml = part_ml + unit * ns * group * 2;
  for (int i = tid; i < group * HD; i += blockDim.x) {
    const int g = i / HD;
    const int d = i % HD;
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w][g]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float f = exp2f(sm_m[w][g] - M);
      L += sm_l[w][g] * f;
      A += sm_acc[w][g][d] * f;
    }
    if (act.count == 1) {
      o[i] = __float2bfloat16(A / L);  // L > 0: the new key is always counted
    } else {
      pacc[(static_cast<int64_t>(split) * group + g) * HD + d] = A;
      if (d == 0)
        *reinterpret_cast<float2*>(pml + (static_cast<int64_t>(split) * group + g) * 2) =
            make_float2(M, L);
    }
  }
  if (act.count > 1 && arrive_last(counters + unit, act.count))
    merge_splits<HD>(pacc, pml, act.first, act.count, group, sm_w,
                     [&](int g) { return o + g * HD; });
}

template <int HD, int GMAX, typename KV, bool PEND, int WARPS>
void launch_warps(const void* q, void* cache, const void* kv_new,
                  const void* kv_pend, const void* pt, const void* q_lens,
                  const void* seq_lens, const void* kv_slots, void* out, int T,
                  int B, int Pg, int n_kv, int S, int layer, int page_size,
                  int window, int npend, int P, float sm_scale, int n_split,
                  int chunk, int split_rows, void* part_acc, void* part_ml,
                  void* counters, int group, cudaStream_t stream) {
  const int64_t grid = (static_cast<int64_t>(T) + static_cast<int64_t>(split_rows) *
                        (n_split - 1)) * n_kv;
  paged_decode_kernel<HD, GMAX, KV, PEND, WARPS>
      <<<static_cast<unsigned>(grid), WARPS * 32, 0, stream>>>(
          static_cast<const bf16*>(q), static_cast<KV*>(cache),
          static_cast<const KV*>(kv_new), static_cast<const KV*>(kv_pend),
          static_cast<const int*>(pt), static_cast<const int*>(q_lens),
          static_cast<const int*>(seq_lens), static_cast<const int*>(kv_slots),
          static_cast<bf16*>(out), B, Pg, n_kv, S, layer, page_size, window,
          npend, P, sm_scale, n_split, chunk, split_rows, static_cast<float*>(part_acc),
          static_cast<float*>(part_ml), static_cast<int*>(counters), group);
}

// One launch. A (row, kv head) walked by one block (n_split 1) takes 8
// warps, for the most keys in flight on its one walk; split units take 4,
// for more blocks on each SM.
template <int HD, int GMAX, typename KV, bool PEND>
int launch(const void* q, void* cache, const void* kv_new, const void* kv_pend,
           const void* pt, const void* q_lens, const void* seq_lens,
           const void* kv_slots, void* out, int T, int B, int Pg, int n_kv,
           int S, int layer, int page_size, int window, int npend, int P,
           float sm_scale, int n_split, int chunk, int split_rows,
           void* part_acc, void* part_ml, void* counters, int group,
           cudaStream_t stream) {
  if (n_split < 1 || n_split > kMaxSplits || chunk < 1 || split_rows < 0 ||
      (static_cast<int64_t>(T) + static_cast<int64_t>(split_rows) * (n_split - 1)) *
              n_kv >= (int64_t{1} << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  split_rows = n_split > 1 ? min(split_rows, B) : 0;
  if (n_split == 1)
    launch_warps<HD, GMAX, KV, PEND, 8>(
        q, cache, kv_new, kv_pend, pt, q_lens, seq_lens, kv_slots, out, T, B,
        Pg, n_kv, S, layer, page_size, window, npend, P, sm_scale, n_split,
        chunk, split_rows, part_acc, part_ml, counters, group, stream);
  else
    launch_warps<HD, GMAX, KV, PEND, 4>(
        q, cache, kv_new, kv_pend, pt, q_lens, seq_lens, kv_slots, out, T, B,
        Pg, n_kv, S, layer, page_size, window, npend, P, sm_scale, n_split,
        chunk, split_rows, part_acc, part_ml, counters, group, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace swiftllm

// (head_dim, GMAX) instances; every group from 1 to 8 runs under the least
// GMAX at or above it (gqa_bound).
#define SWIFTLLM_DECODE_INSTANCES(CASE) \
  CASE(64, 1) CASE(64, 2) CASE(64, 4) CASE(64, 8)   \
  CASE(128, 1) CASE(128, 2) CASE(128, 4) CASE(128, 8)

// C entry, bound with ctypes. kv_fp8 != 0: cache and kv_new are e4m3 rows
// with the scale lanes; else bf16. window: 0 = full causal. n_split, chunk:
// the split plan (n_split 1: no split), for rows below split_rows (R, at
// most B; rows from R on are walked as one split); part_acc (f32 [R * n_kv *
// n_split * group * hd]) and part_ml (f32 [R * n_kv * n_split * group * 2])
// the partial states, unused when n_split is 1; counters (int32 [R * n_kv],
// zero) the arrival counters, left zero. Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a head_dim other than 64 and 128,
// a GQA group (n_q / n_kv) that is not a whole number from 1 to 8, or a plan
// it cannot take.
extern "C" int paged_decode_attention(
    const void* q, void* cache, const void* kv_new, const void* page_table,
    const void* q_lens, const void* seq_lens, const void* kv_slots, void* out,
    int T, int B, int Pg, int n_q, int n_kv, int hd, int S, int layer,
    int page_size, int window, int kv_fp8, float sm_scale, int n_split,
    int chunk, int split_rows, void* part_acc, void* part_ml, void* counters,
    void* stream) {
  using namespace swiftllm;
  const int group = n_kv > 0 ? n_q / n_kv : 0;
  const int gmax = gqa_bound(n_q, n_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SWIFTLLM_DECODE_CASE(HD_, G_)                                            \
  if (hd == HD_ && gmax == G_) {                                                 \
    if (kv_fp8)                                                                  \
      return launch<HD_, G_, fp8, false>(                                        \
          q, cache, kv_new, nullptr, page_table, q_lens, seq_lens, kv_slots,     \
          out, T, B, Pg, n_kv, S, layer, page_size, window, 0, 0, sm_scale,      \
          n_split, chunk, split_rows, part_acc, part_ml, counters, group, st);   \
    return launch<HD_, G_, bf16, false>(                                         \
        q, cache, kv_new, nullptr, page_table, q_lens, seq_lens, kv_slots, out,  \
        T, B, Pg, n_kv, S, layer, page_size, window, 0, 0, sm_scale, n_split,    \
        chunk, split_rows, part_acc, part_ml, counters, group, st);              \
  }
  SWIFTLLM_DECODE_INSTANCES(SWIFTLLM_DECODE_CASE)
#undef SWIFTLLM_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// C entry of the deferred-commit variant, bound with ctypes. cache, kv_new and
// kv_pend [L, P, B, W] are bf16; the cache is only read (it is taken
// non-const because the variants share one kernel signature). npend in 1..P:
// the window's npend - 1 completed tokens are read from kv_pend. The split
// arguments and the return as paged_decode_attention's.
extern "C" int paged_decode_attention_pend(
    const void* q, const void* cache, const void* kv_new, const void* kv_pend,
    const void* page_table, const void* q_lens, const void* seq_lens,
    void* out, int T, int B, int Pg, int n_q, int n_kv, int hd, int S,
    int layer, int page_size, int window, int npend, int P, float sm_scale,
    int n_split, int chunk, int split_rows, void* part_acc, void* part_ml,
    void* counters, void* stream) {
  using namespace swiftllm;
  const int group = n_kv > 0 ? n_q / n_kv : 0;
  const int gmax = gqa_bound(n_q, n_kv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (npend < 1 || npend > P) return static_cast<int>(cudaErrorInvalidValue);
#define SWIFTLLM_PEND_CASE(HD_, G_)                                              \
  if (hd == HD_ && gmax == G_)                                                   \
    return launch<HD_, G_, bf16, true>(                                          \
        q, const_cast<void*>(cache), kv_new, kv_pend, page_table, q_lens,        \
        seq_lens, nullptr, out, T, B, Pg, n_kv, S, layer, page_size, window,     \
        npend, P, sm_scale, n_split, chunk, split_rows, part_acc, part_ml,       \
        counters, group, st);
  SWIFTLLM_DECODE_INSTANCES(SWIFTLLM_PEND_CASE)
#undef SWIFTLLM_PEND_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef SWIFTLLM_DECODE_INSTANCES
