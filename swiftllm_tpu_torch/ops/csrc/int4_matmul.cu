// Fused INT4 dequant-matmul (W4A16) for Hopper: wgmma with the weight as
// the register operand, a ring of TMA copies, and the split-K merge inside
// the one launch.
//
// Replaces: swiftllm_tpu/ops/int4_matmul.py:_kernel, called through
// int4_proj_stacked. That kernel exists to stream each packed weight byte
// from device memory ONCE: the XLA path contracts the packed bytes twice,
// once per nibble half.
//
// What it computes: y[T, N] = x[T, K] @ dequant(q4[layer])^T * s[layer], x
// bf16, q4 int8 [L, N, K/2] split-half packed (byte j holds column j in its
// low nibble and column K/2 + j in its high nibble, each a signed 4-bit
// value), s f32 [L, N]. One f32 sum per output, times the scale, rounded to
// bf16 once, up to T = 256 (any N, any even K). Above 256 tokens the C entry
// launches the wide configuration of wide_matmul.cuh (tiles of 256 tokens,
// pairs of blocks sharing x; K/2 a multiple of 16), with the rounding points
// of the path the JAX package takes there, quant.proj: each nibble half's
// sum rounded to bf16, added in bf16, then scaled.
//
// What bounds it on the H100: at T <= 16 the bytes (an 8B MLP projection,
// N = 14,336 and K = 4,096, streams 29.4 MB: 8.8 us at 3.35 TB/s); from T =
// 128 the operations (15.0 GFLOP at T = 128: 15.2 us at 989 TFLOP/s; 60.8
// us at T = 512, 243 us at T = 2,048).
//
// The design:
// - The operands are swapped: the kernel computes y^T = W . x^T, so a
//   64-row slice of N is wgmma's M and the tokens (T rounded up to 16, 32,
//   64 or 128; more tokens take more token tiles) are its N. Tensor-core
//   work is wasted only on the tokens' rounding, not on padding T to 64.
// - A (the weight) comes from registers: each thread turns its packed bytes
//   straight into the A-fragment layout. Two nibbles become a bf16x2 in two
//   instructions, one lop3 that masks them and sets the exponent of 128
//   ((n & 15) ^ 8 | 0x4300 is 128 + (n ^ 8)) and one packed subtraction of
//   136; every nibble from -8 to 7 comes out exact. A byte pair feeds two
//   products: its low nibbles multiply x[:, j0:j0+16], its high nibbles
//   x[:, K/2+j0 : K/2+j0+16]. A thread's bytes of a k16 step are gathered
//   from two 32-bit shared loads a row by one prmt.
// - B (the x tile) is K-major in 128-byte-swizzled shared memory.
// - A block is two consumer warpgroups (64 weight rows each, one x tile
//   between them) and a producer warpgroup, which hands most of its
//   registers to them (setmaxnreg); its first warp keeps a ring of stages
//   in flight, each one chunk: KC packed bytes of 128 weight rows (KC = 128,
//   or 64 at NT = 128, whose x boxes are large) and the 64-column x boxes
//   they multiply. Where K/2 is a multiple of 16 bytes it copies them with
//   TMA (tensor maps cached on the host, tma.cuh; the layer is a coordinate
//   of the weights' map: no per-layer copy), completing on the stage's
//   mbarrier;
//   elsewhere (a ragged K/2, whose rows are not even 4-byte aligned, so
//   neither TMA nor cp.async can copy them) its 32 lanes load and store the
//   same swizzled layout, zeros past the edges. The weight rows are swizzled
//   as TMA writes them (KC bytes), so a warp's fragment loads hit 32 banks.
//   While one chunk's products run, the consumers load and dequantize the
//   next one's fragments.
// - Blocks are persistent (one an SM, at most the SM count): each walks the
//   units (a 128-row tile, a token tile, a K split) from blockIdx.x in
//   steps of gridDim.x, and the producer runs ahead into the next unit
//   while the consumers finish one.
// - Split-K without a second launch: every split writes its f32 partial
//   (in the threads' fragment order, so that the writes and the reads are
//   coalesced) and adds one to the tile's arrival counter; the block that
//   arrives last sums the partials IN SPLIT ORDER (two launches give the
//   same bits), scales, rounds, and stores. The counters reset themselves.
// - The epilogue stages each tile's bf16 outputs through shared memory,
//   transposed, so that the stores to y[T, N] run along N.
// The plan (ops/int4_matmul.py:int4_plan, host integers only) picks the
// token width and the splits from a model of this kernel's time fitted on
// the card. What holds it back (measured, PERF.md): a wgmma of 64 x 16
// weights costs some 45 cycles however few the tokens, so at T <= 16 the
// products, not the bytes, set the pace; and a split's partial, fence and
// merge cost microseconds, so a projection with few tiles (N = 1,024) pays
// for filling the card.

#include <cuda.h>

#include <algorithm>

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
// Registers a thread: the producer gives most of its own to the consumers
// (setmaxnreg), which hold the accumulators and two chunks' fragments.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(128 * kProducerRegs + kConsumers * kConsumerRegs <= 65536, "registers");
constexpr int kEpiBar = 1;              // the consumers' named barrier

template <int NT>
struct Cfg {
  // Packed bytes a chunk (columns of each half): 128 where the x boxes are
  // small, so that a chunk's fixed costs (its barriers, its hand-offs) buy
  // twice the weight bytes; 64 at NT = 128, whose x boxes fill the ring.
  static constexpr int kKC = NT == 128 ? 64 : 128;
  static constexpr int kSteps = kKC / 16;            // k16 steps a chunk
  static constexpr int kXBlock = NT * 128;           // NT rows x 64 bf16
  static constexpr int kXHalf = kXBlock * (kKC / 64);
  static constexpr int kW = kBM * kKC;               // packed weights
  static constexpr int kStage = 2 * kXHalf + kW;
  static constexpr int kEpiCols = NT < 64 ? NT : 64;   // tokens staged at once
  static constexpr int kEpiPitch = kBM + 8;            // bf16 a staged token row
  static constexpr int kEpi = kEpiCols * kEpiPitch * 2;
  static constexpr int kStages = (220 * 1024 - kEpi) / kStage < 8
                                     ? (220 * 1024 - kEpi) / kStage : 8;
  static constexpr int kSmem = 1024 + kStages * kStage + kEpi + 2 * kStages * 8;
  static_assert(kSmem <= 232448, "shared memory");
};

struct Args {
  const bf16* x;
  const int8_t* q4;
  const float* s;
  bf16* y;
  float* ws;       // partials: [tiles * t_tiles][splits][NT / 8][kConsumers] float4
  int* counters;   // one a (tile, token tile), zero between launches
  int T, N, K, layer;
  int t_tiles, splits, per, units;
};

// Byte offset of packed byte j of weight row r in a stage, rows of KC
// bytes as TMA's KC-byte swizzle lays them: 16-byte chunk c at c ^ (r & 7)
// (128 bytes) or c ^ ((r >> 1) & 3) (64 bytes).
template <int KC>
__device__ __forceinline__ int w_off(int r, int j) {
  const int c = KC == 128 ? (j >> 4) ^ (r & 7) : ((j >> 4) ^ (r >> 1)) & 3;
  return r * KC + (c << 4) + (j & 15);
}

template <int NT>
__device__ __forceinline__ void wgmma_x(float (&d)[NT / 2], const uint32_t (&a)[4],
                                        uint64_t db) {
  if constexpr (NT == 16) wgmma_rs_n16<0>(d, a, db);
  else if constexpr (NT == 32) wgmma_rs_n32<0>(d, a, db);
  else if constexpr (NT == 64) wgmma_rs_n64<0>(d, a, db);
  else wgmma_rs_n128<0>(d, a, db);
}

// Keeps registers live across an asynchronous product that reads them.
template <int S>
__device__ __forceinline__ void keep_live(uint32_t (&r)[S][4]) {
#pragma unroll
  for (int i = 0; i < S; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync %0, %1;\n" ::"n"(kEpiBar), "n"(kConsumers) : "memory");
}

struct Unit {
  int tile, mt, split, c_begin, c_end;
};

template <int KC>
__device__ __forceinline__ Unit unit_of(const Args& a, int u) {
  Unit w;
  w.mt = u % a.t_tiles;
  const int rest = u / a.t_tiles;
  w.split = rest % a.splits;
  w.tile = rest / a.splits;
  const int chunks = (a.K / 2 + KC - 1) / KC;
  w.c_begin = w.split * a.per;
  w.c_end = min(chunks, w.c_begin + a.per);
  return w;
}

// The ragged path's copy of chunk c into a stage: the producer warp's 32
// lanes, zeros outside the matrix (rows past N or T, columns past K/2).
template <int NT>
__device__ void fill_stage(const Args& a, unsigned char* st, int n0, int t0, int c,
                           int lane) {
  constexpr int KC = Cfg<NT>::kKC;
  const int KH = a.K / 2, j0 = c * KC;
  const int8_t* w = a.q4 + static_cast<int64_t>(a.layer) * a.N * KH;
  unsigned char* sw = st + 2 * Cfg<NT>::kXHalf;
  for (int i = lane; i < kBM * KC; i += 32) {
    const int r = i / KC, j = i % KC;
    const int n = n0 + r, jj = j0 + j;
    sw[w_off<KC>(r, j)] = (n < a.N && jj < KH)
        ? static_cast<unsigned char>(w[static_cast<int64_t>(n) * KH + jj]) : 0;
  }
  for (int i = lane; i < 2 * NT * KC; i += 32) {
    const int half = i / (NT * KC), r = (i / KC) % NT, j = i % KC;
    const int t = t0 + r, jj = j0 + j;
    bf16 v = __float2bfloat16(0.f);
    if (t < a.T && jj < KH) v = a.x[static_cast<int64_t>(t) * a.K + half * KH + jj];
    *reinterpret_cast<bf16*>(st + half * Cfg<NT>::kXHalf + swz<NT>(r, j >> 3) +
                             (j & 7) * 2) = v;
  }
}

template <int NT, bool TMA>
__global__ void __launch_bounds__(kThreads, 1)
int4_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x, const Args a) {
  using C = Cfg<NT>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  bf16* epi = reinterpret_cast<bf16*>(smem + C::kStages * C::kStage);
  const uint32_t bars = smem_addr(smem + C::kStages * C::kStage + C::kEpi);
  auto full = [&](int st) { return bars + 8 * st; };
  auto empty = [&](int st) { return bars + 8 * (C::kStages + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < C::kStages; ++i) {
      mbar_init(full(i), TMA ? 1 : 32);
      mbar_init(empty(i), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int KH = a.K / 2;
  if (warp >= kConsumers / 32) {
    // ---- the producer warpgroup: its first warp fills the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32) return;
    int st = 0, ph = 0;
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit w = unit_of<C::kKC>(a, u);
      const int n0 = w.tile * kBM, t0 = w.mt * NT;
      for (int c = w.c_begin; c < w.c_end; ++c) {
        mbar_wait(empty(st), ph ^ 1);
        unsigned char* stage = smem + st * C::kStage;
        if constexpr (TMA) {
          if (lane == 0) {
            const uint32_t dst = smem_addr(stage);
            mbar_arrive_expect_tx(full(st), C::kStage);
#pragma unroll
            for (int b = 0; b < C::kKC / 64; ++b) {
              tma_load_2d(dst + b * C::kXBlock, &tm_x, full(st), c * C::kKC + 64 * b, t0);
              tma_load_2d(dst + C::kXHalf + b * C::kXBlock, &tm_x, full(st),
                          KH + c * C::kKC + 64 * b, t0);
            }
            tma_load_3d(dst + 2 * C::kXHalf, &tm_w, full(st), c * C::kKC, n0, a.layer);
          }
        } else {
          fill_stage<NT>(a, stage, n0, t0, c, lane);
          fence_proxy_async();   // the x boxes are read by wgmma (async proxy)
          mbar_arrive(full(st));
        }
        if (++st == C::kStages) { st = 0; ph ^= 1; }
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, g = lane / 4, q = lane % 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + g;   // rows r0 and r0 + 8 of the tile
  // A thread's A fragment of a 16-byte k group: bytes 2q, 2q+1 (word q/2,
  // half q%2) and 2q+8, 2q+9 (word 2 + q/2) of each of its two rows; one
  // prmt gathers them as [2q, 2q+8, 2q+1, 2q+9].
  const uint32_t sel = 0x5140 + (q & 1) * 0x2222;
  const int wofs = 4 * (q >> 1);
  const float* sl = a.s + static_cast<int64_t>(a.layer) * a.N;
  int st = 0, ph = 0;

  float acc[NT / 2];
  // The A fragments of one chunk: four k16 steps, low and high nibbles.
  using Frag = uint32_t[C::kSteps][4];
  auto load_a = [&](int stage_i, Frag& lo, Frag& hi) {
    const unsigned char* sw = smem + stage_i * C::kStage + 2 * C::kXHalf;
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const unsigned char* row = sw + w_off<C::kKC>(r0 + 8 * h, 16 * s);
        const uint32_t wa = *reinterpret_cast<const uint32_t*>(row + wofs);
        const uint32_t wb = *reinterpret_cast<const uint32_t*>(row + 8 + wofs);
        const uint32_t p = __byte_perm(wa, wb, sel);
        lo[s][h] = nib2(p);
        lo[s][2 + h] = nib2(p >> 8);
        hi[s][h] = nib2(p >> 4);
        hi[s][2 + h] = nib2(p >> 12);
      }
    }
  };
  // The chunk's products: with wgmma, eight, in flight when this returns.
  auto issue = [&](int stage_i, Frag& lo, Frag& hi) {
    const uint32_t xlo = smem_addr(smem + stage_i * C::kStage), xhi = xlo + C::kXHalf;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < C::kSteps; ++s) {
      const uint32_t o = (s >> 2) * C::kXBlock + 32 * (s & 3);
      wgmma_x<NT>(acc, lo[s], sw128_desc(xlo + o, 16, 1024));
      wgmma_x<NT>(acc, hi[s], sw128_desc(xhi + o, 16, 1024));
    }
    wgmma_commit();
  };
  // Waits for a chunk's products; until then the fragments they read stay
  // live (the compiler must not give their registers to the next chunk's),
  // and then the stage goes back to the producer.
  auto retire = [&](int stage_i, Frag& lo, Frag& hi) {
    wgmma_wait<0>();
    fence_regs(acc);
    keep_live(lo);
    keep_live(hi);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(stage_i));
  };
  auto next = [&](int& stage_i, int& parity) {
    if (++stage_i == C::kStages) { stage_i = 0; parity ^= 1; }
  };

  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit w = unit_of<C::kKC>(a, u);
    const int n0 = w.tile * kBM, t0 = w.mt * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;

    // Two sets of fragments in turn: the next chunk's are loaded and
    // dequantized while this chunk's products run. Each chunk's products
    // are waited for before the next are issued. With a wgmma_wait<1> here
    // instead, this order loads chunk c + 1's fragments into the set that
    // chunk c - 1's products, still in flight, read, and keep_live then
    // holds those registers only to the wait that retires chunk c - 2: the
    // compiler may give them away early. That, not keeping products in
    // flight, is why it gave wrong sums on the card. The wide configuration
    // (wide_matmul.cuh) keeps products in flight with the order that avoids
    // it (wait, then load into the retired slot), and measured no gain
    // from it there: its chunks are bound by the fragments' conversion.
    Frag la, ha, lb, hb;
    mbar_wait(full(st), ph);
    load_a(st, la, ha);
    for (int c = w.c_begin;;) {
      int cur = st;
      next(st, ph);
      issue(cur, la, ha);
      bool more = ++c < w.c_end;
      if (more) {
        mbar_wait(full(st), ph);
        load_a(st, lb, hb);
      }
      retire(cur, la, ha);
      if (!more) break;
      cur = st;
      next(st, ph);
      issue(cur, lb, hb);
      more = ++c < w.c_end;
      if (more) {
        mbar_wait(full(st), ph);
        load_a(st, la, ha);
      }
      retire(cur, lb, hb);
      if (!more) break;
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

    // ---- epilogue: scale, round, stage transposed, store along N ----
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
        epi[(col - tb) * C::kEpiPitch + r0 + 8 * h] = __float2bfloat16(acc[i] * sc[h]);
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

static_assert(kBM == kMapRows, "a weight box is one tile's rows");

template <int NT, bool TMA>
int launch(const Args& a, int L, int grid, cudaStream_t stream) {
  constexpr int smem = Cfg<NT>::kSmem;
  CUtensorMap tw{}, tx{};
  if (TMA && (!tensor_map(&tw, {a.q4, a.K / 2, a.N, L, Cfg<NT>::kKC}, true) ||
              !tensor_map(&tx, {a.x, a.K, a.T, 0, NT}, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set[64] = {};   // per device: above 48 KB only when opted in
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaFuncSetAttribute(int4_matmul_kernel<NT, TMA>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set[dev] = true;
  }
  int4_matmul_kernel<NT, TMA><<<grid, kThreads, smem, stream>>>(tw, tx, a);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int dispatch(bool tma, const Args& a, int L, int grid, cudaStream_t stream) {
  return tma ? launch<NT, true>(a, L, grid, stream) : launch<NT, false>(a, L, grid, stream);
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. T > 0, K even, 0 <= layer < L; x, q4, s and y
// contiguous and 16-byte aligned (the wrapper checks all of it). The plan
// (ops/int4_matmul.py:int4_plan): NT token columns a tile (16, 32, 64 or
// 128, chunks of KC packed bytes, 128 or 64 at NT = 128, both halves at
// once; or 256, the wide configuration of wide_matmul.cuh, which takes K/2
// a multiple of 16 and walks chunks of 64 bytes of the low half, then of
// the high half; t_tiles = ceil(T / NT)), splits of `per` chunks, grid
// blocks. At NT = 256: `per` units walked whole, `splits` the most segments
// a cut unit has, grid an even count (pairs of a cluster, over which the
// stream-K part is balanced). ws holds ceil(N / 128) * t_tiles * splits x
// 128 x NT f32 partials when splits > 1 (at NT = 256, units - per stream-K
// units x 2 blocks x splits); counters holds ceil(N / 128) * t_tiles int32,
// zero (every launch leaves them zero).
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue.
extern "C" int int4_matmul(const void* x, const void* q4, const void* s, void* y,
                           void* ws, void* counters, int T, int N, int K, int L,
                           int layer, int NT, int t_tiles, int splits, int per,
                           int grid, void* stream) {
  using namespace swiftllm;
  if (T <= 0 || N <= 0 || K <= 0 || K % 2 || layer < 0 || layer >= L ||
      splits < 1 || per < (NT == wide::kNT ? 0 : 1) || grid < 1 || t_tiles * NT < T ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  if (NT == wide::kNT)
    return wide::launch<true>(static_cast<const bf16*>(x), static_cast<const int8_t*>(q4),
                              static_cast<const float*>(s), static_cast<bf16*>(y),
                              static_cast<float*>(ws), static_cast<int*>(counters), T,
                              N, K, L, layer, t_tiles, splits, per, grid, st);
  const int KH = K / 2;
  const int tiles = (N + kBM - 1) / kBM;
  Args a{static_cast<const bf16*>(x), static_cast<const int8_t*>(q4),
         static_cast<const float*>(s), static_cast<bf16*>(y), static_cast<float*>(ws),
         static_cast<int*>(counters), T, N, K, layer, t_tiles, splits, per,
         tiles * t_tiles * splits};
  // TMA needs 16-byte strides and 16-byte-aligned bases.
  const bool tma = KH % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q4) % 16 == 0;
  grid = std::min(grid, a.units);
  switch (NT) {
    case 16: return dispatch<16>(tma, a, L, grid, st);
    case 32: return dispatch<32>(tma, a, L, grid, st);
    case 64: return dispatch<64>(tma, a, L, grid, st);
    case 128: return dispatch<128>(tma, a, L, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
