// The weight kernels' wide configuration (int8_matmul.cu, int4_matmul.cu):
// tiles of 256 tokens, for x of more than 256 rows (prefill buckets, large
// verify heads). Each .cu file's C entry launches it at NT = 256.
//
// Replaces: XLA's fusion in swiftllm_tpu/worker/quant.py:proj (105-125),
// the path of every quantized projection that the Pallas INT4 kernel does
// not take (INT8 at any T; INT4 in buckets over 256 tokens; the quantized
// lm_head): XLA fuses the int8 -> bf16 convert, and INT4's shifts, into the
// dot's operand load, so no dequantized weight is ever written.
//
// What it computes, with proj's rounding points:
// - INT8: y = bf16(bf16(x @ q[layer]^T) * s[layer]), one f32 sum an output.
// - INT4 (split-half packed q4 [L, N, K/2]): proj's INT4 branch. A low-nibble
//   pass over x[:, :K/2] and a high-nibble pass over x[:, K/2:], each an f32
//   sum rounded to bf16; their bf16 sum; that times the scale, rounded. The
//   narrow configuration (T <= 256) keeps the TPU kernel's single rounding.
//
// What bounds it on the H100: the operations. w_gate (N = 14,336, K = 4,096)
// at T = 512 is 60.1 GFLOP, 0.061 ms at 989 TFLOP/s; at T = 2,048 0.243 ms,
// while its 58.7 MB of INT8 weights stream in 0.0175 ms. A tile's operands
// come from L2 again for every tile that needs them: a 128 x 256 tile reads
// 128 weight bytes and 512 x bytes a K column, about 9.7 TB/s of L2 reads at
// the tensor cores' rate.
//
// The design (int4_matmul.cu's notes say why the shared parts are there):
// - y^T = W . x^T with the weights as wgmma's register operand, as in the
//   narrow configuration; 256 tokens as N (wgmma.m64n256k16: 128 f32
//   accumulators a thread), two consumer warpgroups of 64 weight rows, a
//   producer warp's TMA ring.
// - Clusters of two blocks on neighbouring weight tiles share x: each block
//   copies half of a chunk's x box (128 token rows) and multicasts it to
//   both, so x comes from L2 once a pair, about 5.8 TB/s at the tensor
//   cores' rate. A stage is freed when the consumers of BOTH blocks are done
//   with it (the empty barriers count the warps of both), and the cluster
//   synchronises after the barriers' set-up and before any block exits.
//   With an odd tile count the last pair's second block computes a tile
//   past N on the first tile's weights, writes nothing and merges nothing.
//   Measured on the H100 (PERF.md, PR 14), sharing x saves at most 1.5%
//   against blocks that copy their whole box: L2 is not what holds this
//   tile back, a chunk's products are (about 1.3 times the tensor cores'
//   time, each chunk's products waited for before the next are issued).
// - A chunk is 64 weight bytes: 64 columns of K (INT8) or 64 packed bytes of
//   one nibble half (INT4), and one 256 x 64 x box: 40 KB a stage, five
//   stages (INT8) or four (INT4, beside its 64 KB stash).
// - INT4 walks the chunks of its low half, then those of its high half;
//   between the two, the low sums go, rounded, to a stash in shared memory
//   (each thread its own words: no bank conflicts, no barrier but one before
//   it overwrites the staging of the last unit's epilogue), and the
//   epilogue adds them to the rounded high sums. A split covers chunks of
//   one half only, so the merge can round the halves apart.
// - Persistent pairs walk the units (a pair of weight tiles, a token tile, a
//   K split) from the cluster's index in steps of the cluster count, token
//   tiles innermost: the pairs in flight share weight tiles (and, with few
//   token tiles, all of x) in L2. Split-K as in the narrow configuration:
//   the last block of a tile merges the partials in split order.
// The plan (ops/int4_matmul.py:make_wide_plan and wide_plan_us, host
// integers only) picks the K splits from a model of this configuration's
// time fitted on the card; a split's 128 KB partial makes splits dear.

#pragma once

#include <cuda.h>

#include <algorithm>

#include "common.cuh"
#include "splitkv.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace swiftllm {

// ---- the weights' decoders, shared with the narrow configuration ----

// Two nibbles at bits 0-3 and 16-19 of v -> their signed values as bf16x2.
__device__ __forceinline__ uint32_t nib2(uint32_t v) {
  uint32_t b;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"   // (v & mask) ^ magic
      : "=r"(b)
      : "r"(v), "r"(0x000F000Fu), "r"(0x43084308u));
  __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&b);
  h = __hsub2(h, __nv_bfloat162(__float2bfloat16(136.f), __float2bfloat16(136.f)));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Byte k of u (a weight plus 128) as the f32 value of the weight: the byte
// in the low mantissa byte of 2^23 (sel = 0x744k), less 2^23 + 128.
__device__ __forceinline__ float s8_f32(uint32_t u, uint32_t sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, sel)) - 8388736.f;
}

// Four int8 weights, the bytes of p, as two bf16x2: bytes 0 and 2 (low and
// high half) in b02, bytes 1 and 3 in b13.
__device__ __forceinline__ void s8x4(uint32_t p, uint32_t& b02, uint32_t& b13) {
  const uint32_t u = p ^ 0x80808080u;
  __nv_bfloat162 h02 = __floats2bfloat162_rn(s8_f32(u, 0x7440), s8_f32(u, 0x7442));
  __nv_bfloat162 h13 = __floats2bfloat162_rn(s8_f32(u, 0x7441), s8_f32(u, 0x7443));
  b02 = *reinterpret_cast<uint32_t*>(&h02);
  b13 = *reinterpret_cast<uint32_t*>(&h13);
}

namespace wide {
namespace {

constexpr int kNT = 256;                // tokens a tile
constexpr int kWG = 2;                  // consumer warpgroups
constexpr int kBM = 64 * kWG;           // weight rows a block's tile
constexpr int kConsumers = 128 * kWG;
constexpr int kThreads = kConsumers + 128;
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "registers");
static_assert(kBM == kMapRows, "a weight box is one tile's rows");
constexpr int kEpiBar = 1;              // the consumers' named barrier
constexpr int kCluster = 2;             // blocks that share x
constexpr int kKC = 64;                 // weight bytes a chunk
constexpr int kSteps = kKC / 16;        // k16 steps a chunk
constexpr int kXRows = kNT / 2;         // token rows of a block's x copy
constexpr int kX = kNT * 128;           // a chunk's x box: 256 rows x 64 bf16
constexpr int kW = kBM * kKC;
constexpr int kStage = kX + kW;
constexpr int kEpiCols = 64;            // tokens staged at once
constexpr int kEpiPitch = kBM + 8;      // bf16 a staged token row
constexpr int kEpi = kEpiCols * kEpiPitch * 2;
constexpr int kStash = kNT / 4 * kConsumers * 4;   // the low sums, bf16x2
static_assert(kStage % 1024 == 0, "stages keep the swizzle's 1024-byte alignment");

template <bool INT4>
struct Cfg {
  static constexpr int kStages = INT4 ? 4 : 5;
  static constexpr int kTail = INT4 ? kStash : kEpi;   // the stash holds the staging
  static constexpr int kSmem = 1024 + kStages * kStage + kTail + 2 * kStages * 8;
  static_assert(kSmem + 16 <= 232448, "shared memory");
};

struct Args {
  const bf16* x;
  const int8_t* w;   // int8 q [L, N, K], or packed q4 [L, N, K/2]
  const float* s;
  bf16* y;
  float* ws;         // partials: [tiles * t_tiles][splits][kNT / 8][kConsumers] float4
  int* counters;     // one a (tile, token tile), zero between launches
  int T, N, K, layer;
  int t_tiles, splits, per;
  int tiles;         // weight tiles, ceil(N / 128)
  int units;         // pairs of tiles x token tiles x splits
  int cph;           // chunks a half (INT4) or of all of K (INT8)
};

struct Unit {
  int tile, mt, split, c_begin, c_end;
};

// Unit u of the cluster, for the block of rank `rank`. Chunks c < cph are
// the low half (INT8: all of K), c >= cph the high half; one split takes
// chunks of one half, `per` of them; an unsplit unit takes all.
template <bool INT4>
__device__ __forceinline__ Unit unit_of(const Args& a, int u, int rank) {
  constexpr int halves = INT4 ? 2 : 1;
  Unit w;
  w.mt = u % a.t_tiles;
  const int rest = u / a.t_tiles;
  w.split = rest % a.splits;
  w.tile = (rest / a.splits) * kCluster + rank;
  if (a.splits == 1) {
    w.c_begin = 0;
    w.c_end = halves * a.cph;
  } else {
    const int sph = a.splits / halves, h = w.split / sph;
    w.c_begin = h * a.cph + (w.split % sph) * a.per;
    w.c_end = min((h + 1) * a.cph, w.c_begin + a.per);
  }
  return w;
}

// Byte offset of byte j of weight row r in a stage, rows of 64 bytes as
// TMA's 64-byte swizzle lays them: 16-byte chunk c at c ^ ((r >> 1) & 3).
__device__ __forceinline__ int w_off(int r, int j) {
  return r * kKC + ((((j >> 4) ^ (r >> 1)) & 3) << 4) + (j & 15);
}

__device__ __forceinline__ void keep_live(uint32_t (&r)[kSteps][4]) {
#pragma unroll
  for (int i = 0; i < kSteps; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kEpiBar), "n"(kConsumers) : "memory");
}

template <bool INT4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
wide_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x, const Args a) {
  using C = Cfg<INT4>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  unsigned char* tail = smem + C::kStages * kStage;   // epilogue staging (and stash)
  bf16* epi = reinterpret_cast<bf16*>(tail);
  uint32_t* stash = reinterpret_cast<uint32_t*>(tail);
  const uint32_t bars = smem_addr(tail + C::kTail);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (C::kStages + st); };

  const int rank = static_cast<int>(cluster_rank());
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full(i), 1);
      // Every consumer warp of both blocks frees a stage: the peer's copy
      // writes into this block's stage too.
      mbar_init(empty(i), kCluster * kConsumers / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();   // the peer's barriers exist before any copy or arrival
  const int KH = a.K / 2;   // INT4: the high half's first x column

  if (warp >= kConsumers / 32) {
    // ---- the producer warpgroup: lane 0 of its first warp fills the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      int st = 0, ph = 0;
      for (int u = cluster_id(); u < a.units; u += cluster_count()) {
        const Unit w = unit_of<INT4>(a, u, rank);
        // A tile past N (the odd tile count's phantom) reads the first
        // tile; token rows past T read the first rows. Neither is stored.
        const int n0 = w.tile < a.tiles ? w.tile * kBM : 0;
        int t0 = w.mt * kNT + rank * kXRows;
        if (t0 >= a.T) t0 = 0;
        for (int c = w.c_begin; c < w.c_end; ++c) {
          mbar_wait(empty(st), ph ^ 1);
          const uint32_t dst = smem_addr(smem + st * kStage);
          mbar_arrive_expect_tx(full(st), kStage);
          const bool hi = INT4 && c >= a.cph;
          const int j0 = (hi ? c - a.cph : c) * kKC;
          const int col = (hi ? KH : 0) + j0;
          tma_load_2d_multicast(dst + rank * (kX / 2), &tm_x, full(st), col, t0,
                                (1 << kCluster) - 1);
          tma_load_3d(dst + kX, &tm_w, full(st), j0, n0, a.layer);
          if (++st == C::kStages) { st = 0; ph ^= 1; }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- the consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int wg = warp / 4, g = lane / 4, q = lane % 4;
    const int r0 = wg * 64 + (warp % 4) * 16 + g;   // rows r0 and r0 + 8 of the tile
    const uint32_t sel = 0x5140 + (q & 1) * 0x2222;
    const int wofs = 4 * (q >> 1);
    const float* sl = a.s + static_cast<int64_t>(a.layer) * a.N;
    int st = 0, ph = 0;

    float acc[kNT / 2];
    using Frag = uint32_t[kSteps][4];
    // The A fragments of a chunk: INT8 bytes, or one nibble of each INT4
    // byte (the high one in the high half).
    auto load_a = [&](int stage_i, Frag& f, bool hi) {
      const unsigned char* sw = smem + stage_i * kStage + kX;
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned char* row = sw + w_off(r0 + 8 * h, 16 * s);
          const uint32_t wa = *reinterpret_cast<const uint32_t*>(row + wofs);
          const uint32_t wb = *reinterpret_cast<const uint32_t*>(row + 8 + wofs);
          const uint32_t p = __byte_perm(wa, wb, sel);
          if constexpr (INT4) {
            const uint32_t v = hi ? p >> 4 : p;
            f[s][h] = nib2(v);
            f[s][2 + h] = nib2(v >> 8);
          } else {
            s8x4(p, f[s][h], f[s][2 + h]);
          }
        }
      }
    };
    auto issue = [&](int stage_i, Frag& f) {
      const uint32_t xs = smem_addr(smem + stage_i * kStage);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        wgmma_rs_n256<0>(acc, f[s], sw128_desc(xs + 32 * s, 16, 1024));
      wgmma_commit();
    };
    auto retire = [&](int stage_i, Frag& f) {
      wgmma_wait<0>();
      fence_regs(acc);
      keep_live(f);
      __syncwarp();
      if (lane == 0)
        for (int r = 0; r < kCluster; ++r) mbar_arrive_cta(empty(stage_i), r);
    };
    // INT4: the low sums, rounded, into this thread's stash words; acc zero.
    auto stash_low = [&]() {
      consumers_sync();   // the last unit's epilogue is done with the staging
#pragma unroll
      for (int i = 0; i < kNT / 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
        stash[i * kConsumers + threadIdx.x] = *reinterpret_cast<uint32_t*>(&h);
        acc[2 * i] = acc[2 * i + 1] = 0.f;
      }
    };
    // One chunk: issue its products, load the next chunk's fragments while
    // they run, retire. False after the unit's last chunk.
    auto step = [&](int& c, const Unit& w, Frag& now, Frag& nxt) {
      const int cur = st;
      if (++st == C::kStages) { st = 0; ph ^= 1; }
      if (INT4 && c == a.cph && c != w.c_begin) stash_low();
      issue(cur, now);
      const bool more = ++c < w.c_end;
      if (more) {
        mbar_wait(full(st), ph);
        load_a(st, nxt, INT4 && c >= a.cph);
      }
      retire(cur, now);
      return more;
    };

    for (int u = cluster_id(); u < a.units; u += cluster_count()) {
      const Unit w = unit_of<INT4>(a, u, rank);
      const int n0 = w.tile * kBM, t0 = w.mt * kNT;
#pragma unroll
      for (int i = 0; i < kNT / 2; ++i) acc[i] = 0.f;
      Frag fa, fb;
      mbar_wait(full(st), ph);
      load_a(st, fa, INT4 && w.c_begin >= a.cph);
      for (int c = w.c_begin;;) {
        if (!step(c, w, fa, fb)) break;
        if (!step(c, w, fb, fa)) break;
      }
      if (w.tile >= a.tiles) continue;   // the phantom tile: nothing to write

      // ---- split-K merge: the last split of the tile sums them in order ----
      if (a.splits > 1) {
        const int pair = w.tile * a.t_tiles + w.mt;
        float4* part = reinterpret_cast<float4*>(a.ws) +
                       static_cast<int64_t>(pair) * a.splits * (kNT / 8) * kConsumers;
#pragma unroll
        for (int i = 0; i < kNT / 8; ++i)
          part[(static_cast<int64_t>(w.split) * (kNT / 8) + i) * kConsumers +
               threadIdx.x] =
              make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
        if (!arrive_last(a.counters + pair, a.splits, kEpiBar, kConsumers)) continue;
        // Splits [from, to) in order into acc.
        auto sum = [&](int from, int to) {
#pragma unroll
          for (int i = 0; i < kNT / 2; ++i) acc[i] = 0.f;
          for (int sp = from; sp < to; ++sp) {
#pragma unroll
            for (int i = 0; i < kNT / 8; ++i) {
              const float4 v = __ldcg(part + (static_cast<int64_t>(sp) * (kNT / 8) + i) *
                                                 kConsumers + threadIdx.x);
              acc[4 * i] += v.x;
              acc[4 * i + 1] += v.y;
              acc[4 * i + 2] += v.z;
              acc[4 * i + 3] += v.w;
            }
          }
        };
        if constexpr (INT4) {
          sum(0, a.splits / 2);
          stash_low();
          sum(a.splits / 2, a.splits);
        } else {
          sum(0, a.splits);
        }
      }

      // ---- epilogue ----
      // INT8: the sum rounded; INT4: the rounded low and high sums added and
      // rounded. Then times the scale, rounded, staged transposed, stored
      // along N. Accumulator i: token column 8 (i / 4) + 2q + (i & 1), row
      // r0 + 8 ((i / 2) & 1).
      if constexpr (INT4) {
#pragma unroll
        for (int i = 0; i < kNT / 4; ++i) {
          const uint32_t u32 = stash[i * kConsumers + threadIdx.x];
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u32));
          acc[2 * i] = round_bf16(lo.x + round_bf16(acc[2 * i]));
          acc[2 * i + 1] = round_bf16(lo.y + round_bf16(acc[2 * i + 1]));
        }
      } else {
#pragma unroll
        for (int i = 0; i < kNT / 2; ++i) acc[i] = round_bf16(acc[i]);
      }
      const float sc[2] = {n0 + r0 < a.N ? sl[n0 + r0] : 0.f,
                           n0 + r0 + 8 < a.N ? sl[n0 + r0 + 8] : 0.f};
#pragma unroll
      for (int rb = 0; rb < kNT / kEpiCols; ++rb) {
        consumers_sync();   // the staging buffer (INT4: every stash word) is free
#pragma unroll
        for (int i = 0; i < kNT / 2; ++i) {   // constant indices: acc stays in registers
          if (i / (kEpiCols / 2) != rb) continue;
          const int col = 8 * (i / 4) + 2 * q + (i & 1) - rb * kEpiCols;
          const int h = (i >> 1) & 1;
          epi[col * kEpiPitch + r0 + 8 * h] = __float2bfloat16(acc[i] * sc[h]);
        }
        consumers_sync();
        for (int v = threadIdx.x; v < kEpiCols * (kBM / 8); v += kConsumers) {
          const int tr = v / (kBM / 8), c8 = (v % (kBM / 8)) * 8;
          const int t = t0 + rb * kEpiCols + tr, n = n0 + c8;
          if (t >= a.T || n >= a.N) continue;
          const bf16* src = epi + tr * kEpiPitch + c8;
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
  cluster_sync();   // no block exits while its peer may still signal it
}

// Pairs of blocks (clusters) of the configuration that fit on the current
// card at once, found once a device; or a negative CUDA error.
template <bool INT4>
int max_pairs() {
  static int pairs[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && pairs[dev] > 0) return pairs[dev];
  constexpr int smem = Cfg<INT4>::kSmem;
  cudaFuncSetAttribute(wide_matmul_kernel<INT4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, wide_matmul_kernel<INT4>, &cfg);
  if (e != cudaSuccess || n < 1) {
    cudaGetLastError();
    return -static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
  }
  if (dev < 64) pairs[dev] = n;
  return n;
}

// Launches the wide configuration: x bf16 [T, K], w the stacked weights
// (kbytes bytes a row), the plan's t_tiles, splits (INT4: 1 or even) and
// per, and `grid` blocks at most (pairs of a cluster, no more than fit at
// once). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue.
template <bool INT4>
int launch(const bf16* x, const int8_t* w, const float* s, bf16* y, float* ws,
           int* counters, int T, int N, int K, int L, int layer, int t_tiles,
           int splits, int per, int grid, cudaStream_t stream) {
  const int kbytes = INT4 ? K / 2 : K;
  if (kbytes % 16 || K % 16 || t_tiles * kNT < T || (INT4 && splits > 1 && splits % 2) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tw{}, tx{};
  if (!tensor_map(&tw, {w, kbytes, N, L, kKC}, true) ||
      !tensor_map(&tx, {x, K, T, 0, kXRows}, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fit = max_pairs<INT4>();
  if (fit < 0) return -fit;
  const int tiles = (N + kBM - 1) / kBM;
  Args a{x, w, s, y, ws, counters, T, N, K, layer, t_tiles, splits, per, tiles,
         (tiles + kCluster - 1) / kCluster * t_tiles * splits,
         (kbytes + kKC - 1) / kKC};
  const int pairs = std::max(1, std::min({grid / kCluster, a.units, fit}));
  wide_matmul_kernel<INT4><<<pairs * kCluster, kThreads, Cfg<INT4>::kSmem, stream>>>(
      tw, tx, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wide
}  // namespace swiftllm
