// Weight-only INT8 matmul (W8A16) for Hopper: the weights stream from device
// memory as int8 and become bf16 in registers on their way into wgmma.
//
// Replaces: no Pallas kernel, but XLA's fusion in
// swiftllm_tpu/worker/quant.py:proj (112: dot_general(x, w["q"].astype(
// x.dtype)), the scale at 125). XLA fuses the int8 -> bf16 convert into the
// dot's operand load, so the weight's HBM traffic is its int8 bytes, once.
// Without this kernel the port wrote a bf16 copy of each weight every step
// and read it back: 5 bytes an element where 1 will do.
//
// What it computes: y[T, N] = x[T, K] @ q[layer]^T * s[layer], x bf16, q int8
// [L, N, K] (the stacked {"q", "s"} of worker/quant.py, read at the layer's
// offset), s f32 [L, N]. With proj's rounding points: one f32 sum an output,
// rounded to bf16 (the product in x's dtype), back to f32 times the scale,
// rounded to bf16 again. Any T > 0, any N, K a multiple of 16: up to 256
// tokens the configuration below; above, the wide one of wide_matmul.cuh
// (tiles of 256 tokens, pairs of blocks sharing x), with the same roundings.
//
// What bounds it on the H100: the bytes, at T <= 128. An 8B MLP projection
// (N = 14,336, K = 4,096) streams 58.7 MB of weights: 17.5 us at 3.35 TB/s,
// against 15.2 us of bf16 operations at T = 128; from T = 256 the operations
// (30.4 us; 60.8 us at T = 512, 243 us at T = 2,048).
//
// The design is int4_matmul.cu's (its notes say why each part is there):
// the operands swapped (y^T = W . x^T: 64-row slices of N are wgmma's M,
// the tokens, T rounded up to 16, 32, 64 or 128 with more token tiles above
// that, its N), the weights as the register operand, a producer warp's TMA
// ring (the layer a coordinate of the weights' map), two consumer
// warpgroups of 64 weight rows each, persistent blocks, split-K merged in
// split order by the tile's last block, and the epilogue staged through
// shared memory so that the stores run along N. What differs:
// - Products in flight across chunks (since the redesign for Hopper). A
//   chunk's eight products are one wgmma group, its fragments in one of two
//   sets in turn. A warpgroup converts chunk c + 1's fragments while chunk
//   c's products run, issues chunk c + 1's group behind them at once, and
//   only then waits until at most one group is in flight (wgmma_wait<1>):
//   chunk c's products are retired, its stage goes back to the producer,
//   and its fragment set takes chunk c + 2's. So the tensor cores always
//   find the next chunk queued, and no fragment register is written while
//   a product may still read it (the set is kept live, keep_live, up to
//   the wait that retires its reader). A loop that waits for every product
//   before it issues the next chunk's measures the same (below).
// - A prologue that overlaps the kernel before it (programmatic dependent
//   launch: the launch allows it, griddepcontrol orders it). The producer
//   requests the weights of the first unit's first two stages, which no
//   kernel writes, then waits for the grid before it (griddepcontrol.wait),
//   then requests their x boxes. Two, not the ring: the first x box queues
//   behind the weights requested before it, and with the ring's eight
//   first a unit of eight chunks (wq at T <= 16) started only once all its
//   weights were in (measured, below). Every global read of x and every
//   write of this kernel comes after that wait (the consumers write only
//   after the stages that x filled), so the overlap changes no value.
//   Each block allows the next launch to start at once (launch_dependents):
//   at one block an SM its blocks only take SMs this grid leaves, and wait
//   there.
// - A byte holds one weight: a chunk is 128 bytes (128 columns of K) of 128
//   weight rows and the two 64-column x boxes it multiplies, and a k16 step
//   is one product a warpgroup.
// - The conversion stays in bf16 (since the redesign; before, through f32:
//   a prmt and an f32 add a byte, one cvt.rn.bf16x2.f32 a pair, 11
//   instructions for four bytes). The INT4 nibble trick has no room for a
//   whole byte (128 + b needs 9 significant bits, bf16 has 8), so a byte
//   b = l - 128 h (l its low 7 bits, h its sign bit) is taken as
//   (128 + l) - (128 + 128 h): both terms are bf16 integers in [128, 256]
//   that one lop3 each builds from the byte's bits under 0x4300 (128.0), and
//   one hsub2 subtracts them exactly, two bytes at a time: 7 instructions
//   for four bytes. A thread's four bytes of a row and k16 step are gathered
//   by one prmt from two 32-bit shared loads, as in the INT4 kernel.
// - TMA only: K a multiple of 16 makes every weight row 16-byte aligned (the
//   wrapper refuses other K), so there is no ragged copy path.
// - The epilogue rounds twice (the product, then the scaled product), where
//   int4_matmul's rounds once: one more conversion an output.
// The plan (ops/int8_matmul.py:int8_plan, host integers only) picks the
// token width and the splits from a model of this design's time fitted on
// the card (chip_smoke.py --sweep-int8), with a floor of bytes: a chunk
// takes at least its weight bytes over the card's rate shared by the blocks
// that stream at once.
//
// Measured on the H100 (NVIDIA H100 80GB HBM3, 700 W), with builds that
// each took one part out (a measurement tool since removed: PERF.md keeps
// its readings), w_gate (N = 14,336, K = 4,096) at T = 128, 112 units on
// 112 SMs: 0.034 ms as built against a byte bound of 0.019. Products
// drained before each chunk: the same. The conversion skipped: -11%; no x
// staged: -6%; no weights staged: -9%; no products at all: -24%; no
// programmatic launch: +9% (launches back to back); an empty launch
// 0.0009 ms. At T = 1 the products cost 0.0072 of 0.028 ms and the rest is
// the chunks' shared loads, conversion and waits, with the weights' bytes
// not the limit (no weights staged: -16%). So each SM's consumer warps pace
// a chunk, and a chunk's products and the next chunk's conversion overlap
// little. The prologue (copies of this file with another depth, timed by
// chip_smoke.py --compare-int8, each launch alone, after an ordinary
// kernel): with the ring's eight stages of weights requested first, wq
// (N = K = 4,096) at T = 1 took 0.0155 ms against 0.0123 with two, and
// no 8B shape was faster with the ring's, alone or back to back.

#include <cuda.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "splitkv.cuh"
#include "tma.cuh"
#include "wgmma.cuh"
#include "wide_matmul.cuh"

namespace swiftllm {
namespace {

constexpr int kWG = 2;                  // consumer warpgroups
constexpr int kBM = 64 * kWG;           // weight rows (output channels) per tile
constexpr int kConsumers = 128 * kWG;   // consumer threads
constexpr int kThreads = kConsumers + 128;  // and a producer warpgroup
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "registers");
static_assert(kBM == kMapRows, "a weight box is one tile's rows");
constexpr int kEpiBar = 1;              // the consumers' named barrier
constexpr int kKC = 128;                // weight bytes (columns of K) a chunk
constexpr int kSteps = kKC / 16;        // k16 steps a chunk
constexpr int kPrefetch = 2;            // stages whose weights precede the wait

// Programmatic dependent launch: waits until the grids this one depends on
// have completed and their writes are visible; lets the next grid launch.
// Both are no-ops for a launch without the programmatic dependency.
__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

template <int NT>
struct Cfg {
  static constexpr int kXBlock = NT * 128;           // NT rows x 64 bf16
  static constexpr int kX = kXBlock * (kKC / 64);    // a chunk's x boxes
  static constexpr int kW = kBM * kKC;               // its weights
  static constexpr int kStage = kX + kW;
  static constexpr int kEpiCols = NT < 64 ? NT : 64;   // tokens staged at once
  static constexpr int kEpiPitch = kBM + 8;            // bf16 a staged token row
  static constexpr int kEpi = kEpiCols * kEpiPitch * 2;
  static constexpr int kStages = (220 * 1024 - kEpi) / kStage < 8
                                     ? (220 * 1024 - kEpi) / kStage : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + kEpi + 2 * kStages * 8;
  static_assert(kStage % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");
  static_assert(kSmem <= 232448, "shared memory");
};

struct Args {
  const bf16* x;
  const int8_t* q;
  const float* s;
  bf16* y;
  float* ws;       // partials: [tiles * t_tiles][splits][NT / 8][kConsumers] float4
  int* counters;   // one a (tile, token tile), zero between launches
  int T, N, K, layer;
  int t_tiles, splits, per, units;
};

// Byte offset of byte j of weight row r in a stage, rows of 128 bytes as
// TMA's 128-byte swizzle lays them: 16-byte chunk c at c ^ (r & 7).
__device__ __forceinline__ int w_off(int r, int j) {
  return r * kKC + ((((j >> 4) ^ r) & 7) << 4) + (j & 15);
}

template <int NT>
__device__ __forceinline__ void wgmma_x(float (&d)[NT / 2], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (NT == 16) wgmma_rs_n16<0>(d, a, db);
  else if constexpr (NT == 32) wgmma_rs_n32<0>(d, a, db);
  else if constexpr (NT == 64) wgmma_rs_n64<0>(d, a, db);
  else wgmma_rs_n128<0>(d, a, db);
}

// Four int8 weights, the bytes of p, as two bf16x2: bytes 0 and 2 (low and
// high half) in b02, bytes 1 and 3 in b13 (the notes above: (128 + l) less
// (128 + 128 h), each term one lop3, their difference exact).
__device__ __forceinline__ uint32_t s8x2(uint32_t v) {
  uint32_t lo, hi;
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n"   // (v & 0x007f007f) | 0x43004300
      : "=r"(lo) : "r"(v), "r"(0x007F007Fu), "r"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n"   // (v & 0x00800080) | 0x43004300
      : "=r"(hi) : "r"(v), "r"(0x00800080u), "r"(0x43004300u));
  __nv_bfloat162 d = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&lo),
                             *reinterpret_cast<__nv_bfloat162*>(&hi));
  return *reinterpret_cast<uint32_t*>(&d);
}
__device__ __forceinline__ void s8x4_bf16(uint32_t p, uint32_t& b02, uint32_t& b13) {
  b02 = s8x2(p);
  b13 = s8x2(p >> 8);
}

// Keeps registers live across an asynchronous product that reads them.
__device__ __forceinline__ void keep_live(uint32_t (&r)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kEpiBar), "n"(kConsumers) : "memory");
}

struct Unit {
  int tile, mt, split, c_begin, c_end;
};

__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit w;
  w.mt = u % a.t_tiles;
  const int rest = u / a.t_tiles;
  w.split = rest % a.splits;
  w.tile = rest / a.splits;
  const int chunks = (a.K + kKC - 1) / kKC;
  w.c_begin = w.split * a.per;
  w.c_end = min(chunks, w.c_begin + a.per);
  return w;
}

template <int NT>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x, const Args a) {
  using C = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  bf16* epi = reinterpret_cast<bf16*>(smem + C::kStages * C::kStage);
  const uint32_t bars = smem_addr(smem + C::kStages * C::kStage + C::kEpi);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (C::kStages + st); };

  grid_dep_launch();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full(i), 1);
      mbar_init(empty(i), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // ---- the producer warpgroup: lane 0 of its first warp fills the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || lane != 0) return;
    auto load_x = [&](int stage_i, int c, int t0) {
      const uint32_t dst = smem_addr(smem + stage_i * C::kStage);
#pragma unroll
      for (int b = 0; b < kKC / 64; ++b)
        tma_load_2d(dst + b * C::kXBlock, &tm_x, full(stage_i), c * kKC + 64 * b, t0);
    };
    // The weights of the first unit's first kPrefetch stages go out before
    // the grid waits on the kernel before it (the ring's stages are free at
    // first); their x boxes after.
    int pre = 0;
    if (static_cast<int>(blockIdx.x) < a.units) {
      const Unit w = unit_of(a, blockIdx.x);
      pre = min(w.c_end - w.c_begin, kPrefetch);
      for (int i = 0; i < pre; ++i) {
        mbar_arrive_expect_tx(full(i), C::kStage);
        tma_load_3d(smem_addr(smem + i * C::kStage + C::kX), &tm_w, full(i),
                    (w.c_begin + i) * kKC, w.tile * kBM, a.layer);
      }
    }
    grid_dep_wait();
    int st = 0, ph = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit w = unit_of(a, u);
      const int n0 = w.tile * kBM, t0 = w.mt * NT;
      for (int c = w.c_begin; c < w.c_end; ++c) {
        if (c - w.c_begin < pre) {   // the first unit's prefetched stages
          load_x(st, c, t0);
        } else {
          mbar_wait(empty(st), ph ^ 1);
          mbar_arrive_expect_tx(full(st), C::kStage);
          load_x(st, c, t0);
          tma_load_3d(smem_addr(smem + st * C::kStage + C::kX), &tm_w, full(st),
                      c * kKC, n0, a.layer);
        }
        if (++st == C::kStages) { st = 0; ph ^= 1; }
      }
      pre = 0;
    }
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, g = lane / 4, q = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // rows r0 and r0 + 8 of the tile
  // A thread's A fragment of a k16 step: bytes 2q, 2q+1 (word q/2, half
  // q%2) and 2q+8, 2q+9 (word 2 + q/2) of each of its two rows; one prmt
  // gathers them as [2q, 2q+8, 2q+1, 2q+9].
  const uint32_t sel = 0x5140 + (q & 1) * 0x2222;
  const int wofs = 4 * (q >> 1);
  const float* sl = a.s + static_cast<int64_t>(a.layer) * a.N;
  int st = 0, ph = 0;

  float acc[NT / 2];
  using Frag = uint32_t[kSteps][4];
  auto load_a = [&](int stage_i, Frag& f) {
    const unsigned char* sw = smem + stage_i * C::kStage + C::kX;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* row = sw + w_off(r0 + 8 * h, 16 * s);
        const uint32_t wa = *reinterpret_cast<const uint32_t*>(row + wofs);
        const uint32_t wb = *reinterpret_cast<const uint32_t*>(row + 8 + wofs);
        // Columns 2q, 2q+1 -> a[h]; 2q+8, 2q+9 -> a[2 + h].
        s8x4_bf16(__byte_perm(wa, wb, sel), f[s][h], f[s][2 + h]);
      }
    }
  };
  // The chunk's products: with wgmma, eight, one group, queued behind any
  // group still in flight when this returns.
  auto issue = [&](int stage_i, Frag& f) {
    const uint32_t xs = smem_addr(smem + stage_i * C::kStage);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const uint32_t o = (s >> 2) * C::kXBlock + 32 * (s & 3);
      wgmma_x<NT>(acc, f[s], sw128_desc(xs + o, 16, 1024));
    }
    wgmma_commit();
  };
  // Waits until at most N groups are in flight, which retires the group
  // that read fragments f (keeping them live until then), and gives that
  // group's stage back to the producer.
  auto retire = [&](auto n, int stage_i, Frag& f) {
    wgmma_wait<decltype(n)::value>();
    fence_regs(acc);
    keep_live(f);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage_i));
  };
  using One = std::integral_constant<int, 1>;
  using None = std::integral_constant<int, 0>;
  // The next chunk's stage: waits for it and converts its fragments.
  auto take = [&](Frag& f) {
    const int stage_i = st;
    mbar_wait(full(st), ph);
    load_a(st, f);
    if (++st == C::kStages) { st = 0; ph ^= 1; }
    return stage_i;
  };

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit_of(a, u);
    const int n0 = w.tile * kBM, t0 = w.mt * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

    // Two sets of fragments in turn: chunk c + 1's are converted while
    // chunk c's products run, its group is issued behind them, and then
    // chunk c's group is retired (at most one left in flight).
    Frag fa, fb;
    int sa = take(fa), sb = 0;
    issue(sa, fa);
    for (int c = w.c_begin + 1;; c += 2) {
      if (c == w.c_end) {
        retire(None{}, sa, fa);
        break;
      }
      sb = take(fb);
      issue(sb, fb);
      retire(One{}, sa, fa);
      if (c + 1 == w.c_end) {
        retire(None{}, sb, fb);
        break;
      }
      sa = take(fa);
      issue(sa, fa);
      retire(One{}, sb, fb);
    }

    // ---- split-K merge: the last split of the tile sums them in order ----
    if (a.splits > 1) {
      const int pair = w.tile * a.t_tiles + w.mt;
      float4* part = reinterpret_cast<float4*>(a.ws) +
                     static_cast<int64_t>(pair) * a.splits * (NT / 8) * kConsumers;
#pragma unroll
      for (int i = 0; i < NT / 8; ++i)
        part[(static_cast<int64_t>(w.split) * (NT / 8) + i) * kConsumers + threadIdx.x] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
      if (!arrive_last(a.counters + pair, a.splits, kEpiBar, kConsumers))
        continue;
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
      for (int sp = 0; sp < a.splits; ++sp) {
#pragma unroll
        for (int i = 0; i < NT / 8; ++i) {
          const float4 v = __ldcg(part + (static_cast<int64_t>(sp) * (NT / 8) + i) *
                                             kConsumers + threadIdx.x);
          acc[4 * i] += v.x;
          acc[4 * i + 1] += v.y;
          acc[4 * i + 2] += v.z;
          acc[4 * i + 3] += v.w;
        }
      }
    }

    // ---- epilogue: round, scale, round, stage transposed, store along N ----
    // Accumulator i: token column 8 (i / 4) + 2q + (i & 1), row r0 + 8 ((i / 2) & 1).
    const float sc[2] = {n0 + r0 < a.N ? sl[n0 + r0] : 0.f,
                         n0 + r0 + 8 < a.N ? sl[n0 + r0 + 8] : 0.f};
#pragma unroll
    for (int tb = 0; tb < NT; tb += C::kEpiCols) {
      consumers_sync();   // the staging buffer is free
#pragma unroll
      for (int i = 0; i < NT / 2; ++i) {
        const int col = 8 * (i / 4) + 2 * q + (i & 1);
        if (col < tb || col >= tb + C::kEpiCols) continue;
        const int h = (i >> 1) & 1;
        epi[(col - tb) * C::kEpiPitch + r0 + 8 * h] =
            __float2bfloat16(round_bf16(acc[i]) * sc[h]);
      }
      consumers_sync();
      for (int v = threadIdx.x; v < C::kEpiCols * (kBM / 8); v += kConsumers) {
        const int tr = v / (kBM / 8), c8 = (v % (kBM / 8)) * 8;
        const int t = t0 + tb + tr, n = n0 + c8;
        if (t >= a.T || n >= a.N) continue;
        const bf16* src = epi + tr * C::kEpiPitch + c8;
        bf16* dst = a.y + static_cast<int64_t>(t) * a.N + n;
        if (n + 8 <= a.N && a.N % 8 == 0) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < 8 && n + e < a.N; ++e) dst[e] = src[e];
        }
      }
    }
  }
}

// ---- host side ----

template <int NT>
int launch(const Args& a, int L, int grid, cudaStream_t stream) {
  constexpr int smem = Cfg<NT>::kSmem;
  CUtensorMap tw{}, tx{};
  if (!tensor_map(&tw, {a.q, a.K, a.N, L, kKC}, true) ||
      !tensor_map(&tx, {a.x, a.K, a.T, 0, NT}, false))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set[64] = {};   // per device: above 48 KB only when opted in
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaFuncSetAttribute(int8_matmul_kernel<NT>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int8_matmul_kernel<NT>, tw, tx, a);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. T > 0, K a multiple of 16, 0 <= layer < L; x,
// q, s and y contiguous and 16-byte aligned (the wrapper checks all of it).
// The plan (ops/int8_matmul.py:int8_plan): NT token columns a tile (16, 32,
// 64 or 128, chunks of 128 weight bytes; or 256, the wide configuration of
// wide_matmul.cuh, chunks of 64; t_tiles = ceil(T / NT)), splits of `per`
// chunks, grid blocks. At NT = 256: `per` units walked whole, `splits` the
// most segments a cut unit has, grid an even count (pairs of a cluster,
// over which the stream-K part is balanced). ws holds ceil(N / 128) *
// t_tiles * splits x 128 x NT f32 partials when splits > 1 (at NT = 256,
// units - per stream-K units x 2 blocks x splits); counters holds
// ceil(N / 128) * t_tiles int32, zero (every launch leaves them zero).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int int8_matmul(const void* x, const void* q, const void* s, void* y,
                           void* ws, void* counters, int T, int N, int K, int L,
                           int layer, int NT, int t_tiles, int splits, int per,
                           int grid, void* stream) {
  using namespace swiftllm;
  if (T <= 0 || N <= 0 || K <= 0 || K % 16 || layer < 0 || layer >= L ||
      splits < 1 || per < (NT == wide::kNT ? 0 : 1) || grid < 1 || t_tiles * NT < T ||
      (splits > 1 && (ws == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(q) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (NT == wide::kNT)
    return wide::launch<false>(static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
                               static_cast<const float*>(s), static_cast<bf16*>(y),
                               static_cast<float*>(ws), static_cast<int*>(counters), T,
                               N, K, L, layer, t_tiles, splits, per, grid, st);
  const int tiles = (N + kBM - 1) / kBM;
  Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q),
         static_cast<const float*>(s), static_cast<bf16*>(y), static_cast<float*>(ws),
         static_cast<int*>(counters), T, N, K, layer, t_tiles, splits, per,
         tiles * t_tiles * splits};
  grid = std::min(grid, a.units);
  switch (NT) {
    case 16: return launch<16>(a, L, grid, st);
    case 32: return launch<32>(a, L, grid, st);
    case 64: return launch<64>(a, L, grid, st);
    case 128: return launch<128>(a, L, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
