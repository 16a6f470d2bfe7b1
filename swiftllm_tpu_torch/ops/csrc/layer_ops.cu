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
//   rope_qkv_fp8  the same with an fp8 cache, and the quantizing kv_new
//                 build (587-601: each token's K and V absmax, fp8_scales,
//                 the scaled values clipped to +-448, the scale lanes, the
//                 cast to e4m3) folded in, so that the row costs one launch;
//   silu_mul      bf16(bf16(silu(f32(gate))) * up) (619-621).
//
// What each computes is what ops/layer_ops.py's plain versions compute, with
// every product and sum rounded to bf16 where PyTorch's bf16 operations
// round it: rope_qkv's output is bit-equal to its plain version (each
// product of two bf16 is exact in f32 and then rounded, as PyTorch rounds
// it), and rope_qkv_fp8's row byte-equal (the maxima and the scaled values
// are of the bf16-rounded k_rot and v, each scale a power of two, so each
// product is exact, and the cast rounds to nearest even and saturates);
// add_rms_norm's h and silu_mul's output may differ from it by one bf16
// rounding (the variance is summed in another order; rsqrtf and expf are the
// card's).
//
// What bounds them on the H100: bytes, and at small T the launch. At 8B
// width and T = 128 they move 4 MiB (add_rms_norm), 3 MiB (rope_qkv; 2.8 MiB
// rope_qkv_fp8) and 10.5 MiB (silu_mul), 1.25, 0.94 (0.88) and 3.3 us at
// 3.35 TB/s. The design: 16-byte loads and stores (eight bf16 a thread), f32
// arithmetic; add_rms_norm a block a token row, its values held in
// registers between the sum of squares and the scaling; rope_qkv a block a
// token, a thread one unit (a pair of 8-lane vectors, lanes c.. of a
// head's two halves, or 8 lanes of v); silu_mul a thread an 8-lane vector.
//
// add_rms_norm and rope_qkv run at every T of a decode step far above their
// byte bounds (a few KiB to 4 MiB): what they cost is their chain of
// dependent latencies. Since their redesign for Hopper the chain is one
// memory round trip, at most one barrier and the stores. add_rms_norm: w is
// loaded with x and r (not after the sum of squares), every warp reads all
// the warps' partial sums after a single barrier (no second one behind a
// thread's total), a block of 512 threads holds at most two vectors a
// thread (faster than 256 or 128 threads at 8B width, as fast at
// Qwen2-0.5B's); a row split over a cluster of 2 or 4 blocks (the sum
// exchanged through distributed shared memory) was slower at every T it was
// timed at (PERF.md). rope_qkv: a thread holds a fixed count of units (one
// at 8B width, 448 units on 448 threads; Qwen2-0.5B's 80 on 96), every load
// issued before the first arithmetic, the biases before the grid wait, the
// outputs held as packed bf16 pairs (40 registers: three blocks an SM at
// T = 2,048); with an fp8 cache the row's two maxima take one barrier,
// where a separate row build cost a second launch that read k_rot and v
// back twice. On the H100 (chip_smoke.py --compare-rope) two tokens a block
// were slower at every T timed; two or four units a thread (at 8B width)
// were slower than one at T <= 128, and at T = 2,048 faster than the first
// one-unit design but not timed against the kept one. Both launch
// programmatically, so that their start and their parameters overlap the
// kernel before (the ordering and why it is safe: add_rms_norm_kernel,
// rope_qkv_kernel).

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kNormThreads = 512;
constexpr int kNormVecs = 2;     // 8-lane vectors a thread holds: D <= 8192
constexpr int kRopeThreads = 512;   // a token's threads at most
constexpr int kRopeUnits = 4;       // units a thread at most: 2,048 a token
// Blocks an SM must hold at one unit a thread: 40 registers a thread, so
// that three blocks of 448 threads (8B) fit each SM sub-partition's 16,384
// registers (on the H100 at 42 the fp8 kernel held two, and at T = 2,048
// took 0.0252 ms against 0.0215; at 4 blocks, 32 registers, both spill).
constexpr int kRopeMinBlocks = 3;
constexpr int kSiluThreads = 256;

// Eight floats rounded to bf16 (to nearest, ties to even) in one 16-byte
// store (the pairs packed by shifts, as to_e4m3 packs its bytes).
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

// The power-of-two scale of an absmax (ops/quantize_kv.py:fp8_scales): 2^e
// with e = (m <= 0.875 ? 8 : 7) - ex for the absmax m * 2^ex (m in [0.5,
// 1)), clamped to [1e-20, FLT_MAX] first and e clipped to [-9, 8], the
// exact floor of log2(224 / absmax).
__device__ __forceinline__ float fp8_scale(float x_max) {
  int ex;
  const float m = frexpf(fminf(fmaxf(x_max, 1e-20f), 3.402823466e38f), &ex);
  const int e = min(max((m <= 0.875f ? 8 : 7) - ex, -9), 8);
  return __int_as_float((e + 127) << 23);
}

// Eight floats, each clipped to +-448, as eight e4m3 bytes (the pairs
// packed by shifts: a store through a 16-bit pointer into the uint2 was
// lost on the card, which then wrote the registers' stale bytes).
__device__ __forceinline__ uint2 to_e4m3(const float (&f)[8]) {
  uint32_t h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __nv_cvt_float2_to_fp8x2(
        make_float2(fminf(fmaxf(f[2 * i], -448.f), 448.f),
                    fminf(fmaxf(f[2 * i + 1], -448.f), 448.f)),
        __NV_SATFINITE, __NV_E4M3);
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// Word i of a uint4 (i a constant after unrolling), the two bf16 of a word
// as floats (exact), and two floats rounded to bf16 (to nearest, ties to
// even) as a word, packed by shifts as store8 packs them.
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}
__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
}

// One token a block, a thread U units of it, unit u = j * tpt + thread
// for j < U. Units 0 .. n_rot-1 rotate lanes [c, c+8) of one head's two
// halves (q heads first, then k heads); the rest are 8 lanes of v. With
// FP8 false the kernel writes q_out and the bf16 row k_rot || v [T, 2 KH]
// at kv_out. With FP8 true it writes q_out and the fp8 cache row [T, 2 KH
// + 128] at kv_out: [k_rot * sk, v * sv, sk, sv, 0 ...] as e4m3, where sk
// and sv are the scales (fp8_scale) of the token's absmax of k_rot and of
// v, each value taken after its bf16 rounding, as the plain version rounds
// it (ops/layer_ops.py:rope_qkv_fp8_plain).
//
// A thread's units are a fixed count, the ones past the token's clamped to
// its last and not stored, so every load of a thread is issued before its
// first arithmetic. The order of its memory operations, and why it is safe
// under the programmatic launch (the kernel may start while the kernel
// before it in the stream still runs):
// - the biases bq, bk, bv are loaded first, before the grid wait: they are
//   model parameters, which no kernel of a step writes (only loading the
//   weights does, before any step), so the kernel before cannot be writing
//   them;
// - q, k, v and the cos/sin tables are read after the wait, which returns
//   once the kernel before has completed and its writes are visible: the
//   tables are written inside the step (rope_tables), and under INT8 or
//   INT4 the projections before this kernel are programmatic launches
//   themselves, so the tables' writer has not been shown complete when this
//   kernel starts; every write comes after the wait too, and so does the
//   reuse of memory that a kernel before read and PyTorch's allocator then
//   handed to q_out or kv_out;
// - the next launch is allowed at once (launch_dependents): a kernel
//   launched after this one with the programmatic dependency waits on this
//   grid's completion before it reads q_out or kv_out (any such kernel
//   must); one launched without it starts after this one has ended.
// The FP8 row's two maxima take one barrier: each warp's pair goes to
// shared memory, and every thread of the token then takes the maximum over
// its token's warps (the same on every thread: a maximum is exact).
template <bool FP8, int U>
__global__ void __launch_bounds__(kRopeThreads, U == 1 ? kRopeMinBlocks : 1)
rope_qkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ bq,
                const bf16* __restrict__ bk, const bf16* __restrict__ bv,
                const bf16* __restrict__ cos, const bf16* __restrict__ sin,
                bf16* __restrict__ q_out, void* __restrict__ kv_out, int T,
                int n_q, int n_kv, int hd, int tpt) {
  const int half = hd / 2, hv = half / 8;
  const int QH = n_q * hd, KH = n_kv * hd;
  const int n_qrot = n_q * hv, n_rot = n_qrot + n_kv * hv;
  const int units = n_rot + KH / 8;
  const int lt = threadIdx.x;
  const int64_t t = blockIdx.x;

  // Each unit: its kind (0 q, 1 k, 2 v), its first lane in the token's q,
  // k or v row (head * hd + c), its lane c in the tables (0 for v), and
  // whether it is stored.
  int kind[U], off[U], tc[U];
  bool ok[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u0 = j * tpt + lt;
    ok[j] = u0 < units;
    const int u = min(u0, units - 1);
    if (u < n_rot) {
      const int r = u < n_qrot ? u : u - n_qrot;
      const int head = r / hv;
      kind[j] = u < n_qrot ? 0 : 1;
      tc[j] = (r - head * hv) * 8;
      off[j] = head * hd + tc[j];
    } else {
      kind[j] = 2;
      tc[j] = 0;
      off[j] = (u - n_rot) * 8;
    }
  }
  // The biases, before the grid wait (parameters: see above). A v unit
  // loads its 8 lanes twice, as its second half.
  uint4 ba[U], bb[U];
  if (bq != nullptr) {
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bf16* b = (kind[j] == 0 ? bq : kind[j] == 1 ? bk : bv) + off[j];
      ba[j] = ld16(b);
      bb[j] = ld16(b + (kind[j] < 2 ? half : 0));
    }
  }
  grid_dep_launch();
  grid_dep_wait();
  uint4 xa[U], xb[U], ca[U], sa[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const bf16* src = (kind[j] == 0 ? q + t * QH : (kind[j] == 1 ? k : v) + t * KH) + off[j];
    xa[j] = ld16(src);
    xb[j] = ld16(src + (kind[j] < 2 ? half : 0));
    ca[j] = ld16(cos + t * half + tc[j]);
    sa[j] = ld16(sin + t * half + tc[j]);
  }
  // o1 the unit's first 8 lanes (rotated, or v's), o2 its second half's,
  // as the bf16 pairs stored (a pair of lanes at a time, so that few
  // registers are live beside the loads).
  uint32_t o1[U][4], o2[U][4];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const bool rot = kind[j] < 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t wa = word(xa[j], i), wb = word(xb[j], i);
      const uint32_t wc = word(ca[j], i), ws = word(sa[j], i);
      float a[2] = {lo_f(wa), hi_f(wa)}, b[2] = {lo_f(wb), hi_f(wb)};
      const float c[2] = {lo_f(wc), hi_f(wc)}, sn[2] = {lo_f(ws), hi_f(ws)};
      if (bq != nullptr) {
        const uint32_t pa = word(ba[j], i), pb = word(bb[j], i);
        a[0] = round_bf16(a[0] + lo_f(pa));
        a[1] = round_bf16(a[1] + hi_f(pa));
        b[0] = round_bf16(b[0] + lo_f(pb));
        b[1] = round_bf16(b[1] + hi_f(pb));
      }
      float r1[2], r2[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        r1[e] = rot ? round_bf16(a[e] * c[e]) - round_bf16(b[e] * sn[e]) : a[e];
        r2[e] = round_bf16(b[e] * c[e]) + round_bf16(a[e] * sn[e]);
      }
      o1[j][i] = pack_bf16(r1[0], r1[1]);
      o2[j][i] = pack_bf16(r2[0], r2[1]);
    }
  }
  const int64_t kv_row = 2 * static_cast<int64_t>(KH) + (FP8 ? ScaleLanes<fp8>::value : 0);
  if constexpr (!FP8) {
    bf16* row = static_cast<bf16*>(kv_out) + t * kv_row;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!ok[j]) continue;
      bf16* dst = (kind[j] == 0 ? q_out + t * QH : row + (kind[j] == 2 ? KH : 0)) + off[j];
      *reinterpret_cast<uint4*>(dst) = make_uint4(o1[j][0], o1[j][1], o1[j][2], o1[j][3]);
      if (kind[j] < 2)
        *reinterpret_cast<uint4*>(dst + half) =
            make_uint4(o2[j][0], o2[j][1], o2[j][2], o2[j][3]);
    }
  } else {
    float mk = 0.f, mv = 0.f;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!ok[j]) continue;
      if (kind[j] == 0) {
        bf16* dst = q_out + t * QH + off[j];
        *reinterpret_cast<uint4*>(dst) = make_uint4(o1[j][0], o1[j][1], o1[j][2], o1[j][3]);
        *reinterpret_cast<uint4*>(dst + half) =
            make_uint4(o2[j][0], o2[j][1], o2[j][2], o2[j][3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float m1 = fmaxf(fabsf(lo_f(o1[j][i])), fabsf(hi_f(o1[j][i])));
          if (kind[j] == 1)
            mk = fmaxf(mk, fmaxf(m1, fmaxf(fabsf(lo_f(o2[j][i])), fabsf(hi_f(o2[j][i])))));
          else
            mv = fmaxf(mv, m1);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, o));
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, o));
    }
    __shared__ float2 part[kRopeThreads / 32];
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = make_float2(mk, mv);
    __syncthreads();
    const int nw = tpt / 32;
    for (int w = 0; w < nw; ++w) {
      const float2 p = part[w];
      mk = fmaxf(mk, p.x);
      mv = fmaxf(mv, p.y);
    }
    const float sk = fp8_scale(mk), sv = fp8_scale(mv);
    fp8* row = static_cast<fp8*>(kv_out) + t * kv_row;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!ok[j] || kind[j] == 0) continue;
      const float s = kind[j] == 1 ? sk : sv;
      fp8* dst = row + (kind[j] == 2 ? KH : 0) + off[j];
      float f[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = lo_f(o1[j][i]) * s;
        f[2 * i + 1] = hi_f(o1[j][i]) * s;
      }
      *reinterpret_cast<uint2*>(dst) = to_e4m3(f);
      if (kind[j] == 1) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          f[2 * i] = lo_f(o2[j][i]) * s;
          f[2 * i + 1] = hi_f(o2[j][i]) * s;
        }
        *reinterpret_cast<uint2*>(dst + half) = to_e4m3(f);
      }
    }
    // The scale lanes, 16 bytes a thread: sk, sv, then zeros, written as
    // zero words (zeros converted by to_e4m3 here came out as the thread's
    // lane index on the card).
    if (lt < ScaleLanes<fp8>::value / 16) {
      const uint32_t s = __nv_cvt_float2_to_fp8x2(make_float2(sk, sv), __NV_SATFINITE,
                                                  __NV_E4M3);
      *reinterpret_cast<uint4*>(row + 2 * KH + 16 * lt) =
          make_uint4(lt == 0 ? s : 0u, 0u, 0u, 0u);
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

namespace swiftllm {
namespace {

// Launches rope_qkv_kernel<FP8, U> with the programmatic dependency: a
// block a token, U the least of 1, 2, 4 units a thread that keeps a token
// on at most kRopeThreads threads, the block its units over U rounded up to
// whole warps.
template <bool FP8>
int launch_rope(const void* q, const void* k, const void* v, const void* bq,
                const void* bk, const void* bv, const void* cos, const void* sin,
                void* q_out, void* kv_out, int T, int n_q, int n_kv, int hd,
                void* stream) {
  if (T < 1 || n_q < 1 || n_kv < 1 || hd < 16 || hd % 16 ||
      (bq == nullptr) != (bk == nullptr) || (bq == nullptr) != (bv == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (n_q + n_kv) * (hd / 16) + n_kv * hd / 8;
  const int U = units <= kRopeThreads ? 1 : units <= 2 * kRopeThreads ? 2
                : units <= kRopeUnits * kRopeThreads ? kRopeUnits : 0;
  if (U == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tpt = ((units + U - 1) / U + 31) / 32 * 32;
  using Kernel = void (*)(const bf16*, const bf16*, const bf16*, const bf16*,
                          const bf16*, const bf16*, const bf16*, const bf16*, bf16*,
                          void*, int, int, int, int, int);
  const Kernel kernel = U == 1   ? rope_qkv_kernel<FP8, 1>
                        : U == 2 ? rope_qkv_kernel<FP8, 2>
                                 : rope_qkv_kernel<FP8, kRopeUnits>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(T);
  cfg.blockDim = dim3(tpt);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(bq),
      static_cast<const bf16*>(bk), static_cast<const bf16*>(bv),
      static_cast<const bf16*>(cos), static_cast<const bf16*>(sin),
      static_cast<bf16*>(q_out), kv_out, T, n_q, n_kv, hd, tpt);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
}  // namespace swiftllm

// q, q_out [T, n_q * hd]; k, v [T, n_kv * hd]; biases [n_q * hd], [n_kv *
// hd] x 2, all three or none (null); cos, sin [T, hd / 2]; kv_new [T, 2 *
// n_kv * hd] bf16 (k_rot || v). hd a multiple of 16, at most 2,048 units a
// token ((n_q + n_kv) * hd / 16 + n_kv * hd / 8). Launched with the
// programmatic dependency (see rope_qkv_kernel).
extern "C" int rope_qkv(const void* q, const void* k, const void* v, const void* bq,
                        const void* bk, const void* bv, const void* cos,
                        const void* sin, void* q_out, void* kv_new, int T, int n_q,
                        int n_kv, int hd, void* stream) {
  return swiftllm::launch_rope<false>(q, k, v, bq, bk, bv, cos, sin, q_out, kv_new, T,
                                      n_q, n_kv, hd, stream);
}

// The same, with kv_new the fp8 cache row [T, 2 * n_kv * hd + 128] e4m3:
// [k_rot * sk, v * sv, sk, sv, 0 ...] (rope_qkv_kernel).
extern "C" int rope_qkv_fp8(const void* q, const void* k, const void* v, const void* bq,
                            const void* bk, const void* bv, const void* cos,
                            const void* sin, void* q_out, void* kv_new, int T, int n_q,
                            int n_kv, int hd, void* stream) {
  return swiftllm::launch_rope<true>(q, k, v, bq, bk, bv, cos, sin, q_out, kv_new, T,
                                     n_q, n_kv, hd, stream);
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
