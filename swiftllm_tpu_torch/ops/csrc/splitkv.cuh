// Split-KV for the paged-attention kernels (and the arrival counter that
// int4_matmul.cu's split-K merge shares): the keys of one attention unit
// (a decode row's kv head, or a prefill row's query tile and kv head) are cut
// into splits that separate blocks walk at once, and the last block of the
// unit to finish merges their partial softmax states. No second launch.
//
// The plan (ops/paged_attention.py:split_plan, from host integers only):
// n_split splits of `chunk` keys, split s covering positions
// [s * chunk, (s + 1) * chunk), the last one running on to the row's end.
// Inside a block, a unit's ACTIVE splits are those that meet the unit's key
// range [lo, hi) (lo > 0 under a window, hi the causal end); a split outside
// it returns at once, writes nothing and is never read. When one split is
// active, it writes the output itself; otherwise each active split writes
// its partial state (m and l per query row, in log2 space, and the
// unnormalised f32 accumulator) to scratch the wrapper allocates, adds one
// to the unit's arrival counter, and the block that arrives last merges.
// The counter buffer is the wrapper's, zeroed once per device; the merging
// block sets its counter back to 0, so the next launch finds it zero.
#pragma once

#include "common.cuh"

namespace swiftllm {

// Most splits a unit may have (the planner's cap): the merge keeps one
// weight per split and row in shared memory.
constexpr int kMaxSplits = 32;

struct SplitRange {
  int first;  // first active split
  int count;  // active splits (0: the unit has no key)
};

// Active splits of a unit whose keys are [lo, hi).
__device__ __forceinline__ SplitRange active_splits(int lo, int hi, int n_split,
                                                    int chunk) {
  if (hi <= lo) return {0, 0};
  const int first = min(lo / chunk, n_split - 1);
  const int last = min((hi - 1) / chunk, n_split - 1);
  return {first, last - first + 1};
}

// This split's keys: [s * chunk, (s + 1) * chunk) within [lo, hi), the last
// split to hi.
__device__ __forceinline__ void split_keys(int s, int n_split, int chunk,
                                           int lo, int hi, int& beg, int& end) {
  beg = max(lo, s * chunk);
  end = s == n_split - 1 ? hi : min(hi, (s + 1) * chunk);
}

// Called by every thread of a block that wrote its partial state: true in
// the block that arrived last (all the unit's partials are then visible to
// it). The pattern of CUDA's threadFenceReduction sample. A kernel whose
// other warps run a loop of their own (int4_matmul.cu's producer) passes a
// named barrier `bar` (not 0) that only its first `nthreads` threads (whole
// warps, thread 0 among them) call this at.
__device__ __forceinline__ bool arrive_last(int* counter, int n_active, int bar = 0,
                                            int nthreads = 0) {
  __shared__ int is_last;
  auto sync = [&] {
    if (bar == 0)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(nthreads) : "memory");
  };
  __threadfence();
  sync();
  if (threadIdx.x == 0) {
    const int prev = atomicAdd(counter, 1);
    is_last = prev == n_active - 1;
    if (is_last) *counter = 0;
  }
  sync();
  const bool last = is_last != 0;
  if (last) __threadfence();
  return last;
}

// Merges the partials of splits first .. first+count-1 of one unit, R rows
// of HD dims: acc [n_split][R][HD] and ml [n_split][R][2] (m, l). The
// weight of split s in row r is exp2(m_s - M) / L, with M the largest m of
// the row's splits that saw a key (l > 0) and L the sum of their l times
// exp2(m_s - M); a split whose l is 0 has weight 0 and its accumulator is
// not read. `w` is shared memory for kMaxSplits * R floats. out_row(r)
// returns the bf16 output row of r, or nullptr for a row to skip.
template <int HD, typename OutRow>
__device__ __forceinline__ void merge_splits(const float* acc, const float* ml,
                                             int first, int count, int R,
                                             float* w, OutRow out_row) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float M = kNegBig;
    for (int i = 0; i < count; ++i) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(
          ml + (static_cast<int64_t>(first + i) * R + r) * 2));
      if (p.y > 0.f) M = fmaxf(M, p.x);
    }
    float L = 0.f;
    for (int i = 0; i < count; ++i) {
      const float2 p = __ldcg(reinterpret_cast<const float2*>(
          ml + (static_cast<int64_t>(first + i) * R + r) * 2));
      const float f = p.y > 0.f ? exp2f(p.x - M) : 0.f;
      w[i * R + r] = f;
      L += p.y * f;
    }
    const float inv = L > 0.f ? 1.f / L : 0.f;
    for (int i = 0; i < count; ++i) w[i * R + r] *= inv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * HD / 2; e += blockDim.x) {
    const int r = e / (HD / 2);
    const int d = (e % (HD / 2)) * 2;
    bf16* o = out_row(r);
    if (o == nullptr) continue;
    float2 v = make_float2(0.f, 0.f);
    for (int i = 0; i < count; ++i) {
      const float f = w[i * R + r];
      if (f == 0.f) continue;
      const float2 a = __ldcg(reinterpret_cast<const float2*>(
          acc + (static_cast<int64_t>(first + i) * R + r) * HD + d));
      v.x += f * a.x;
      v.y += f * a.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(o + d) = __floats2bfloat162_rn(v.x, v.y);
  }
}

}  // namespace swiftllm
