// Scatter of a step's fresh K||V rows into the paged cache.
//
// Replaces: the fused span write of swiftllm_tpu/ops/paged_attention.py:
// _tiles_kernel (fused=True), where each grid step first DMAs its span's new
// KV into the row's pages and then streams them back. On the TPU that grid
// runs in order, so span t of a row has landed before span t+1 reads it. On
// the GPU the blocks of one grid run at once, so a launch that both wrote and
// read a row's pages would race: the write is this launch of its own, queued
// before paged_prefill_attention on the same stream.
//
// What it computes: cache[layer, slots[t]] = kv_new[t] for every token t whose
// slot lies in [0, S); an out-of-range slot is dropped, as JAX drops an
// out-of-range scatter. The step gives decode-kind and pad tokens slot -1,
// so only the prefill-kind tokens' rows are copied. The copy is of raw bytes
// in 16-byte vectors, so it holds for any row whose size is a multiple of 16:
// a bf16 row of 2*n_kv*hd lanes, and an fp8 row of 2*n_kv*hd e4m3 bytes plus
// its 128 scale lanes (2,176 bytes at 8 kv heads of 128), which it copies
// whole, scales included.
//
// What bounds it on the H100: bytes (one read and one write of each row, no
// arithmetic). The design: one block per token, 16-byte loads and stores by
// neighbouring threads on neighbouring addresses.

#include "common.cuh"

namespace swiftllm {
namespace {

__global__ void store_kv_kernel(const uint4* __restrict__ kv_new,
                                uint4* __restrict__ cache,
                                const int* __restrict__ slots, int row_vecs,
                                int S, int64_t layer_off_vecs) {
  const int t = blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= S) return;
  const uint4* src = kv_new + static_cast<int64_t>(t) * row_vecs;
  uint4* dst = cache + layer_off_vecs + static_cast<int64_t>(slot) * row_vecs;
  for (int i = threadIdx.x; i < row_vecs; i += blockDim.x) dst[i] = src[i];
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. T >= 1 and row_bytes a multiple of 16 (the
// wrapper checks both). Returns cudaGetLastError() after the launch.
extern "C" int store_kv(const void* kv_new, void* cache, const void* slots,
                        int T, int row_bytes, int S, int layer, void* stream) {
  using namespace swiftllm;
  const int row_vecs = row_bytes / 16;
  store_kv_kernel<<<T, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(kv_new), static_cast<uint4*>(cache),
      static_cast<const int*>(slots), row_vecs, S,
      static_cast<int64_t>(layer) * S * row_vecs);
  return static_cast<int>(cudaGetLastError());
}
