// The layer's elementwise work between its GEMMs: three kernels a layer of
// the step runs where plain PyTorch would run some forty small launches.
//
// Replaces: no Pallas kernel, but XLA's fusions inside the JAX package's
// layer body, swiftllm_tpu/models/llama.py:layer_step (510), which XLA fuses
// into its neighbouring dots or into a few fusions a layer:
//   add_rms_norm  the residual adds (616, 623) and rms_norm (244; called at
//                 527, 618, 632): x <- bf16(x + r), then
//                 h = bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w), the
//                 variance in f32;
//   rope_qkv      the Qwen2 bias adds (biased, 530-534, at 558-560), the
//                 half-split RoPE on q and k (apply_rope, 208, at 578-579)
//                 from the step's bf16 tables (rope_tables, 198), and the
//                 bf16 cache row kv_new = k_rot || v (600);
//   silu_mul      bf16(bf16(silu(f32(gate))) * up) (619-621).
//
// What each computes is what ops/layer_ops.py's plain versions compute, with
// every product and sum rounded to bf16 where PyTorch's bf16 operations
// round it: rope_qkv's output is bit-equal to its plain version (each
// product of two bf16 is exact in f32 and then rounded, as PyTorch rounds
// it); add_rms_norm's h and silu_mul's output may differ from it by one bf16
// rounding (the variance is summed in another order; rsqrtf and expf are the
// card's).
//
// What bounds them on the H100: bytes, and at small T the launch. At 8B
// width and T = 128 they move 4 MiB (add_rms_norm), 3 MiB (rope_qkv) and
// 10.5 MiB (silu_mul), 1.25, 0.94 and 3.3 us at 3.35 TB/s. The design:
// 16-byte loads and stores (eight bf16 a thread), f32 arithmetic;
// add_rms_norm a block a token row, its values held in registers between
// the sum of squares and the scaling; rope_qkv a block a token, a thread a
// pair of 8-lane vectors (lanes c.. of a head's two halves); silu_mul a
// thread an 8-lane vector.
//
// add_rms_norm runs at every T of a decode step far above its byte bound
// (a few KiB to 4 MiB): what it costs is its chain of dependent latencies.
// Since its redesign for Hopper the chain is one memory round trip, one
// barrier and the stores: w is loaded with x and r (not after the sum of
// squares), every warp reads all the warps' partial sums after a single
// barrier (no second one behind a thread's total), a block of 512 threads
// holds at most two vectors a thread (faster than 256 or 128 threads at
// 8B width, as fast at Qwen2-0.5B's), and the launch is programmatic, so
// that its start and its w overlap the kernel before it (the ordering and
// why it is safe: add_rms_norm_kernel). A row split over a cluster of 2 or
// 4 blocks (the sum exchanged through distributed shared memory) was
// slower at every T it was timed at (PERF.md).

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kNormThreads = 512;
constexpr int kNormVecs = 2;     // 8-lane vectors a thread holds: D <= 8192
constexpr int kRopeThreads = 128;
constexpr int kSiluThreads = 256;

// Eight floats rounded to bf16 (to nearest, ties to even) in one 16-byte
// store (the pairs packed by shifts, as quantize_kv.cu packs its bytes).
__device__ __forceinline__ void store8(bf16* p, const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])))
            << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Programmatic dependent launch: waits until the grid this one depends on
// has completed and its writes are visible; lets the next grid launch.
// Both are no-ops for a launch without the programmatic dependency.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// One token row a block: x <- bf16(x + r) (when r is given, written to
// x_out), then h = bf16(bf16(x * rsqrt(sum(x^2) / D + eps)) * w). Thread t
// holds vectors j * kNormThreads + t.
//
// The order of its memory operations, and why it is safe under the
// programmatic launch (the kernel may start while the kernel before it in
// the stream still runs):
// - w is requested first, before the grid wait: it is a model parameter,
//   which no kernel of a step writes (only loading the weights does, before
//   any step), so the kernel before cannot be writing it;
// - every read of x and r, and every write, comes after the wait, which
//   returns once the kernel before has completed and its writes are
//   visible; so does the reuse of memory that kernel read and PyTorch's
//   allocator then handed to x_out or h;
// - the next launch is allowed at once (launch_dependents): a kernel
//   launched after this one with the programmatic dependency waits on this
//   grid's completion before it reads h or x_out (int8_matmul does, and
//   any such kernel must); one launched without it starts after this one
//   has ended.
// The sum of squares takes one barrier: each warp's sum goes to shared
// memory, and every thread then adds the warps' sums in the same order (so
// every thread holds the same total).
__global__ void __launch_bounds__(kNormThreads)
add_rms_norm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ r,
                    const bf16* __restrict__ w, bf16* __restrict__ x_out,
                    bf16* __restrict__ h, int D, float eps) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * D;
  const int vecs = D / 8;
  uint4 g[kNormVecs];
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int i = j * kNormThreads + threadIdx.x;
    if (i < vecs) g[j] = *reinterpret_cast<const uint4*>(w + 8 * i);
  }
  grid_dep_launch();
  grid_dep_wait();
  float v[kNormVecs][8];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int i = j * kNormThreads + threadIdx.x;
    if (i < vecs) {
      load8(x + row + 8 * i, v[j]);
      if (r != nullptr) {
        float b[8];
        load8(r + row + 8 * i, b);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[j][e] = round_bf16(v[j][e] + b[e]);
        store8(x_out + row + 8 * i, v[j]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) ss += v[j][e] * v[j][e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  __shared__ float part[kNormThreads / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = ss;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kNormThreads / 32; ++k) s += part[k];
  const float rs = rsqrtf(s / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < kNormVecs; ++j) {
    const int i = j * kNormThreads + threadIdx.x;
    if (i < vecs) {
      const __nv_bfloat162* gh = reinterpret_cast<const __nv_bfloat162*>(&g[j]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 t = __bfloat1622float2(gh[e]);
        v[j][2 * e] = round_bf16(v[j][2 * e] * rs) * t.x;
        v[j][2 * e + 1] = round_bf16(v[j][2 * e + 1] * rs) * t.y;
      }
      store8(h + row + 8 * i, v[j]);
    }
  }
}

// Eight lanes with their bias added and rounded (biased), if there is one.
__device__ __forceinline__ void load8_biased(const bf16* p, const bf16* bias,
                                             float (&f)[8]) {
  load8(p, f);
  if (bias != nullptr) {
    float b[8];
    load8(bias, b);
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = round_bf16(f[e] + b[e]);
  }
}

// One token a block. Units 0 .. n_rot-1 rotate lanes [c, c+8) of one head's
// two halves (q heads first, then k heads); the rest copy 8 lanes of v. A
// rotated q goes to q_out, a rotated k and v to rows of kv_ld lanes at k_out
// and v_out (kv_new's two halves, or two [T, KH] tensors).
__global__ void __launch_bounds__(kRopeThreads)
rope_qkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ bq,
                const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                const bf16* __restrict__ cos, const bf16* __restrict__ sin,
                bf16* __restrict__ q_out, bf16* __restrict__ k_out,
                bf16* __restrict__ v_out, int n_q, int n_kv, int hd, int kv_ld) {
  const int64_t t = blockIdx.x;
  const int half = hd / 2, hv = half / 8;
  const int QH = n_q * hd, KH = n_kv * hd;
  const int n_rot = (n_q + n_kv) * hv;
  const bf16* cs_row = cos + t * half;
  const bf16* sn_row = sin + t * half;
  for (int u = threadIdx.x; u < n_rot + KH / 8; u += kRopeThreads) {
    if (u < n_rot) {
      const int head = u / hv, c = (u % hv) * 8;
      const bool is_q = head < n_q;
      const int off = (is_q ? head : head - n_q) * hd;
      const bf16* src = (is_q ? q + t * QH : k + t * KH) + off;
      const bf16* bias = is_q ? bq : bk;
      if (bias != nullptr) bias += off;
      bf16* dst = (is_q ? q_out + t * QH : k_out + t * kv_ld) + off;
      float x1[8], x2[8], cs[8], sn[8], o1[8], o2[8];
      load8_biased(src + c, bias == nullptr ? nullptr : bias + c, x1);
      load8_biased(src + half + c, bias == nullptr ? nullptr : bias + half + c, x2);
      load8(cs_row + c, cs);
      load8(sn_row + c, sn);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        o1[e] = round_bf16(x1[e] * cs[e]) - round_bf16(x2[e] * sn[e]);
        o2[e] = round_bf16(x2[e] * cs[e]) + round_bf16(x1[e] * sn[e]);
      }
      store8(dst + c, o1);
      store8(dst + half + c, o2);
    } else {
      const int c = (u - n_rot) * 8;
      float x[8];
      load8_biased(v + t * KH + c, bv == nullptr ? nullptr : bv + c, x);
      store8(v_out + t * kv_ld + c, x);
    }
  }
}

// out = bf16(bf16(silu(gate)) * up), 8 lanes a thread; silu in f32 as
// PyTorch computes it, g / (1 + exp(-g)).
__global__ void __launch_bounds__(kSiluThreads)
silu_mul_kernel(const bf16* __restrict__ gate, const bf16* __restrict__ up,
                bf16* __restrict__ out, int64_t n_vec) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kSiluThreads + threadIdx.x;
  if (i >= n_vec) return;
  float g[8], u[8];
  load8(gate + 8 * i, g);
  load8(up + 8 * i, u);
#pragma unroll
  for (int e = 0; e < 8; ++e) g[e] = round_bf16(g[e] / (1.f + expf(-g[e]))) * u[e];
  store8(out + 8 * i, g);
}

}  // namespace
}  // namespace swiftllm

// C entries, bound with ctypes. Every tensor bf16, contiguous and 16-byte
// aligned (the wrappers in ops/layer_ops.py check it). Each returns
// cudaGetLastError() after its launch.

// x, r, x_out, h [T, D]; w [D]. r null: no add, x_out unused (may be null).
// T >= 1, D a multiple of 8 and at most 8,192. Launched with the
// programmatic dependency (see add_rms_norm_kernel).
extern "C" int add_rms_norm(const void* x, const void* r, const void* w, void* x_out,
                            void* h, int T, int D, float eps, void* stream) {
  using namespace swiftllm;
  if (T < 1 || D < 8 || D % 8 || D > 8 * kNormVecs * kNormThreads ||
      (r != nullptr && x_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T);
  cfg.blockDim = dim3(kNormThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, add_rms_norm_kernel, static_cast<const bf16*>(x), static_cast<const bf16*>(r),
      static_cast<const bf16*>(w), static_cast<bf16*>(x_out), static_cast<bf16*>(h), D,
      eps);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// q, q_out [T, n_q * hd]; k, v [T, n_kv * hd]; biases [n_q * hd], [n_kv *
// hd] x 2, all three or none (null); cos, sin [T, hd / 2]; k_out and v_out
// rows of kv_ld lanes (kv_new: k_out = kv_new, v_out = kv_new + n_kv * hd,
// kv_ld = 2 * n_kv * hd). hd a multiple of 16.
extern "C" int rope_qkv(const void* q, const void* k, const void* v, const void* bq,
                        const void* bk, const void* bv, const void* cos,
                        const void* sin, void* q_out, void* k_out, void* v_out, int T,
                        int n_q, int n_kv, int hd, int kv_ld, void* stream) {
  using namespace swiftllm;
  if (T < 1 || n_q < 1 || n_kv < 1 || hd < 16 || hd % 16 || kv_ld % 8 ||
      kv_ld < n_kv * hd || (bq == nullptr) != (bk == nullptr) ||
      (bq == nullptr) != (bv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  rope_qkv_kernel<<<T, kRopeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bq),
      static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
      static_cast<const bf16*>(cos), static_cast<const bf16*>(sin),
      static_cast<bf16*>(q_out), static_cast<bf16*>(k_out), static_cast<bf16*>(v_out),
      n_q, n_kv, hd, kv_ld);
  return static_cast<int>(cudaGetLastError());
}

// gate, up, out [T, F]; F a multiple of 8.
extern "C" int silu_mul(const void* gate, const void* up, void* out, int T, int F,
                        void* stream) {
  using namespace swiftllm;
  if (T < 1 || F < 8 || F % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_vec = static_cast<int64_t>(T) * F / 8;
  const int64_t blocks = (n_vec + kSiluThreads - 1) / kSiluThreads;
  silu_mul_kernel<<<static_cast<unsigned>(blocks), kSiluThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
      static_cast<bf16*>(out), n_vec);
  return static_cast<int>(cudaGetLastError());
}
