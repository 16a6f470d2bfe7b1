// Host side of the TMA-fed weight kernels (int4_matmul.cu, int8_matmul.cu):
// libcuda's tensor-map encoder, found through the runtime, and a cache of
// the maps of the weights (bytes [L][N][K'], boxes of `box` bytes x kMapRows
// rows x 1 layer) and of the activations (bf16 [T][K], boxes of 64 columns x
// `box` rows), both 128-byte swizzled (64-byte for 64-byte weight boxes).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

namespace swiftllm {
namespace {

constexpr int kMapRows = 128;   // weight rows a box: the kernels' tile

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime (the
// library does not link libcuda itself).
EncodeTiled encode_fn() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

struct MapKey {
  const void* ptr;
  int64_t d0, d1, d2;
  int box;
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d0 == o.d0 && d1 == o.d1 && d2 == o.d2 && box == o.box;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.ptr);
    for (int64_t v : {k.d0, k.d1, k.d2, static_cast<int64_t>(k.box)})
      h = h * 1000003u ^ std::hash<int64_t>()(v);
    return h;
  }
};

// Tensor maps, encoded once per (address, shape, box): a decode step meets
// the same weights, and mostly the same activation buffers, again and again.
// The map holds only the address and the shape, so a buffer freed and
// reallocated at the same address with the same shape reuses it rightly.
bool tensor_map(CUtensorMap* out, const MapKey& key, bool weights) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *out = it->second;
    return true;
  }
  const EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  CUresult r;
  const cuuint32_t ones[3] = {1, 1, 1};
  if (weights) {   // bytes [L][N][K'], boxes of key.box bytes x kMapRows rows
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(key.d0),
                                static_cast<cuuint64_t>(key.d1),
                                static_cast<cuuint64_t>(key.d2)};
    const cuuint64_t strides[2] = {dims[0], dims[0] * dims[1]};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(key.box), kMapRows, 1};
    r = enc(out, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(key.ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            key.box == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  } else {         // x as bf16 [T][K], boxes of 64 columns x key.box rows
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(key.d0),
                                static_cast<cuuint64_t>(key.d1)};
    const cuuint64_t strides[1] = {dims[0] * 2};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(key.box)};
    r = enc(out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(key.ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  }
  if (r != CUDA_SUCCESS) return false;
  if (cache.size() >= 1024) cache.clear();
  cache.emplace(key, *out);
  return true;
}

}  // namespace
}  // namespace swiftllm
