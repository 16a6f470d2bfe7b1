// The page mover of swap preemption: whole KV pages between the device cache
// and the pinned host swap pool, across every layer, in either direction.
//
// Replaces no Pallas kernel. The JAX package moves a swapped sequence's pages
// with a jitted gather and device_get (out) and device_put and a scatter (in)
// (swiftllm_tpu/worker/model.py: _swap_gather_fn, _swap_scatter_fn,
// apply_swap_out, apply_swap_in), staged through its native host page copy.
// In PyTorch that form needs device scratch of the whole sequence's pages at
// the moment the card is full, and a copy into a strided pinned slice goes
// through an unpinned temporary and synchronises. This kernel needs neither:
// it reads the source pages and writes the destination pages in place, the
// pinned pool reached by its device address (pinned memory is mapped into the
// device's address space under unified addressing).
//
// What it computes: for i < n_pages and every layer l,
//   dst[l, pages[1][i]] = src[l, pages[0][i]]   (a page = page_bytes bytes)
// where src and dst are [L, rows, row_bytes] byte arrays, page p of layer l at
// l * layer_bytes + p * page_bytes. The copy is of raw bytes, so an fp8 row
// moves whole, its scale lanes included.
//
// What bounds it on the H100: the host link (PCIe), not device memory: every
// byte crosses it once. The design: a grid of `blocks` persistent blocks (at
// most one per (page, layer) unit) that stride over the units, 16-byte loads
// and stores by neighbouring threads on neighbouring addresses, four loads in
// flight a thread before its stores (a read of host memory across the link
// takes microseconds, so many bytes must be in flight), streaming cache hints
// (the moved bytes are not read again by this launch). A few blocks keep the
// link busy; one block a unit would fill every SM with blocks that wait on the
// link, and a step running beside the swap would wait for them (chip_smoke.py
// --sweep-swap). The page lists are int32 device arrays: no host work per
// page. It runs on the caller's stream and does not synchronise, so a
// swap-out is ordered after the steps that wrote its pages and a swap-in
// before the step that reads them.
//
// The pool is allocated here too (swap_pool_alloc): cudaHostAlloc memory, as
// PyTorch's pinned allocator takes it, but of exactly the size asked (that
// allocator rounds a request up to a power of two: an fp8 pool of 4.25 GiB
// would lock 8). Memory locked with cudaHostRegister instead reads and
// writes slower from a kernel (chip_smoke.py's mover, PERF.md).
//
// copy_page_runs is not a kernel of the port: it is the yardstick that
// chip_smoke.py times the mover against, swiftLLM's swap_blocks form (one
// cudaMemcpy2DAsync per run of consecutive pages, the layers as its rows, on
// the copy engines).

#include <cuda_runtime.h>
#include <stdint.h>

namespace swiftllm {
namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;

__global__ void __launch_bounds__(kThreads)
swap_pages_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst,
                  const int* __restrict__ pages, int n_pages, int64_t units,
                  int64_t src_layer_vecs, int64_t dst_layer_vecs,
                  int page_vecs) {
  // Unit (layer l, page i) at l * n_pages + i: neighbouring blocks take
  // neighbouring pages of one layer.
  for (int64_t unit = blockIdx.x; unit < units; unit += gridDim.x) {
    const int i = static_cast<int>(unit % n_pages);
    const int64_t l = unit / n_pages;
    const uint4* s = src + l * src_layer_vecs
                     + static_cast<int64_t>(pages[i]) * page_vecs;
    uint4* d = dst + l * dst_layer_vecs
               + static_cast<int64_t>(pages[n_pages + i]) * page_vecs;
    for (int base = threadIdx.x; base < page_vecs; base += kThreads * kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int k = base + u * kThreads;
        if (k < page_vecs) v[u] = __ldcs(s + k);
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int k = base + u * kThreads;
        if (k < page_vecs) __stcs(d + k, v[u]);
      }
    }
  }
}

// The address a kernel reads p by: p itself for device memory, the mapped
// device address for pinned host memory; an error for memory the device cannot
// reach (pageable host memory).
cudaError_t device_address(const void* p, const void** out) {
  cudaPointerAttributes a;
  cudaError_t err = cudaPointerGetAttributes(&a, p);
  if (err != cudaSuccess) return err;
  if (a.type == cudaMemoryTypeHost) {
    if (a.devicePointer == nullptr) return cudaErrorInvalidValue;
    *out = a.devicePointer;
  } else if (a.type == cudaMemoryTypeDevice || a.type == cudaMemoryTypeManaged) {
    *out = p;
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. pages: int32 device array [2, n_pages] (source
// pages, then destination pages). page_bytes and both layer strides are
// multiples of 16 and both bases 16-byte aligned (the wrapper checks). blocks:
// the grid, at most n_pages * L (0: one block a unit). Returns a CUDA error
// code: the address lookup's, or cudaGetLastError() after the launch.
extern "C" int swap_pages(const void* src, void* dst, const void* pages,
                          int n_pages, int L, long long src_layer_bytes,
                          long long dst_layer_bytes, int page_bytes,
                          int blocks, void* stream) {
  using namespace swiftllm;
  const void* s = nullptr;
  const void* d = nullptr;
  cudaError_t err = device_address(src, &s);
  if (err == cudaSuccess) err = device_address(dst, &d);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_pages == 0) return 0;
  const long long units = static_cast<long long>(n_pages) * L;
  const long long grid = blocks > 0 && blocks < units ? blocks : units;
  swap_pages_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(s),
      static_cast<uint4*>(const_cast<void*>(d)),
      static_cast<const int*>(pages), n_pages, units, src_layer_bytes / 16,
      dst_layer_bytes / 16, page_bytes / 16);
  return static_cast<int>(cudaGetLastError());
}

// The host pool: page-locked, mapped (cudaHostAllocDefault under unified
// addressing), *out = its address. Freed with swap_pool_free.
extern "C" int swap_pool_alloc(long long bytes, void** out) {
  return static_cast<int>(cudaHostAlloc(out, bytes, cudaHostAllocDefault));
}

extern "C" int swap_pool_free(void* p) {
  return static_cast<int>(cudaFreeHost(p));
}

// The yardstick (never called by the port): runs: int32 HOST array [3, n_runs]
// of (source page, destination page, pages in the run); one
// cudaMemcpy2DAsync per run, L rows of run * page_bytes bytes, each side's
// layer stride its pitch. Returns the first error.
extern "C" int copy_page_runs(const void* src, void* dst, const int* runs,
                              int n_runs, int L, long long src_layer_bytes,
                              long long dst_layer_bytes, int page_bytes,
                              void* stream) {
  for (int i = 0; i < n_runs; ++i) {
    const long long sp = runs[i], dp = runs[n_runs + i], n = runs[2 * n_runs + i];
    cudaError_t err = cudaMemcpy2DAsync(
        static_cast<char*>(dst) + dp * page_bytes, dst_layer_bytes,
        static_cast<const char*>(src) + sp * page_bytes, src_layer_bytes,
        n * page_bytes, L, cudaMemcpyDefault, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
