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
// while its 58.7 MB of INT8 weights stream in 0.0175 ms. So the tensor cores
// must never wait: not for the next chunk's fragments, not for an epilogue,
// and not in a last wave that leaves pairs of SMs idle.
//
// The design (int4_matmul.cu's notes say why the shared parts are there):
// - y^T = W . x^T with the weights as wgmma's register operand, as in the
//   narrow configuration; 256 tokens as N (wgmma.m64n256k16: 128 f32
//   accumulators a thread), two consumer warpgroups of 64 weight rows, a
//   producer warp's TMA ring of four stages. A chunk is 64 weight bytes:
//   64 columns of K (INT8) or 64 packed bytes of one nibble half (INT4),
//   and one 256 x 64 x box: 40 KB a stage.
// - Clusters of two blocks on neighbouring weight tiles share x: each block
//   copies half of a chunk's x box (128 token rows) and multicasts it to
//   both. A stage is freed when the consumers of BOTH blocks are done with
//   it (the empty barriers count the warps of both), and the cluster
//   synchronises after the barriers' set-up and before any block exits.
//   With an odd tile count the last pair's second block computes a tile
//   past N on the first tile's weights, writes nothing and merges nothing.
// - Products in flight across chunks, as CUTLASS's register-operand
//   mainloop keeps them. Each k16 step's product is a wgmma group of its
//   own, its fragments in one of two slots in turn. After issuing step k a
//   warpgroup waits until at most one product is in flight (wgmma_wait<1>):
//   the one that read the other slot is then retired, and only then does it
//   load and convert that slot (the next step's, or the next chunk's
//   first). So a product stays queued while the next fragment is
//   converted, and no fragment register is written while a product may
//   still read it; a slot is kept live (keep_live) up to the wait that
//   retires its reader, so that the compiler gives its registers to nothing
//   else meanwhile. A chunk's stage is freed when the next chunk's last
//   step has been issued. Two slots is all the budget holds: with two
//   whole chunks of fragments (32 registers), or four step slots (16),
//   ptxas serialised every wgmma for want of registers.
// - Registers. ptxas compiles the whole kernel to the launch bound's 168
//   registers a thread (64K over 384 threads), whatever setmaxnreg grants
//   the consumers at run time (232); the 128 accumulators leave 40. So the
//   consumers keep nothing across a piece's chunk loop that they can read
//   again: a warp's walk and its piece (unit, chunks, tile, the merge's
//   bounds) wait in shared memory (the slot, written alike by every lane),
//   a thread's place is derived from tid() where it is used, each role
//   reads its rank after its setmaxnreg, the epilogue converts the
//   accumulators a pair at a time, and a merge keeps two 16-byte loads in
//   flight. ptxas reports no spill in either instance (chip_smoke.py fails
//   a build that spills or serialises this kernel's wgmmas).
// - The last wave balanced (stream-K). A unit is a pair of weight tiles x a
//   token tile over all its chunks. The plan's first `whole` units go whole
//   to the pairs in turn (full waves: pair i takes units i, i + P, ...);
//   the chunks of the other units are cut into one contiguous range a pair,
//   balanced to a chunk (Sched). A unit whose chunks fall in the ranges of
//   several pairs is cut: each piece, cut again at INT4's half boundary, is
//   a segment whose f32 partial (128 KB a block) goes to the workspace, and
//   the tile's last block to arrive sums the segments in K order
//   (splitkv.cuh:arrive_last), so two launches give the same bits.
// - The epilogue off the tensor cores' path. Each warpgroup writes its
//   64 x 256 outputs, transposed by stmatrix, into a 32 KB staging buffer of
//   its own (TMA's 128-byte swizzle), and one of its threads hands the box
//   to a TMA store: the warpgroup goes on to the next unit's products while
//   the store reads the staging, and waits for that read only before it
//   writes the staging again. Where N is not a multiple of 8, y's rows are
//   not 16-byte aligned for TMA, and the warpgroup copies the staging out.
// - INT4 walks a unit's low-half chunks, then its high-half ones; at the
//   boundary the products drain and the low sums go, rounded, to a stash in
//   the warpgroup's staging (each thread its own words); the epilogue adds
//   them to the rounded high sums.
// The plan (ops/int4_matmul.py:wide_plan and wide_plan_us, host integers
// only) picks the pairs and the whole units from a model of this
// configuration's time fitted on the card.
//
// Measured on the H100 (PERF.md §6; chip_smoke.py --sweep-int4, its fit
// of ops/int4_matmul.py's model): a chunk takes 0.721 us (INT8) and 0.691
// us (INT4), about 1.25 times the tensor cores' 0.56 us. A build that
// spilled (INT8 80 / 76, INT4 132 / 168 bytes of spill stores / loads, at
// a unit's or a merge's edges, none inside the chunk loop) took 0.781 /
// 0.755 us: ptxas's register budget reaches into the chunk
// loop even where nothing spills there. What the rest of a chunk waits on
// (the consumer warps' fragment loads and conversion, shared-memory reads,
// the waits) is not split by a measurement of a spill-free build. A
// segment's partial costs about 9 us when every pair writes one at once,
// so the plan walks every unit whole where the last wave's idle pairs cost
// less (w_gate at T = 512).

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
constexpr int kEpiBar = 1;              // both consumer warpgroups (the split merge)
constexpr int kWgBar = 2;               // + wg: one warpgroup and its staging
constexpr int kCluster = 2;             // blocks that share x
constexpr int kKC = 64;                 // weight bytes a chunk
constexpr int kSteps = kKC / 16;        // k16 steps a chunk
constexpr int kSlots = 2;               // fragment slots, one a product in flight and the next
static_assert(kSteps % kSlots == 0, "a chunk's steps fill whole rounds of slots");
constexpr int kXRows = kNT / 2;         // token rows of a block's x copy
constexpr int kX = kNT * 128;           // a chunk's x box: 256 rows x 64 bf16
constexpr int kW = kBM * kKC;
constexpr int kStage = kX + kW;
constexpr int kStages = 4;
constexpr int kMergeLoads = 2;          // a merge's 16-byte loads in flight
constexpr int kOut = kNT * 128;         // a warpgroup's staging: 256 tokens x 64 rows bf16
constexpr int kSlotWords = 12;         // a consumer warp's walk and piece
constexpr int kSmem =
    1024 + kStages * kStage + kWG * kOut + 2 * kStages * 8 + kConsumers / 32 * kSlotWords * 4;
static_assert(kStage % 1024 == 0 && kOut % 1024 == 0,
              "stages and staging keep the swizzle's 1024-byte alignment");
static_assert(kNT / 4 * 128 * 4 == kOut, "a warpgroup's INT4 stash fills its staging");
static_assert(kSmem + 16 <= 232448, "shared memory");

struct Args {
  const bf16* x;
  const int8_t* w;   // int8 q [L, N, K], or packed q4 [L, N, K/2]
  const float* s;
  bf16* y;
  float* ws;         // partials: [units - whole][kCluster][segs][kNT / 8][kConsumers] float4
  int* counters;     // one a (tile, token tile), zero between launches
  int T, N, K, layer;
  int t_tiles, tiles;
  int units;         // pairs of tiles x token tiles
  int whole;         // the units walked whole, before the stream-K part
  int segs;          // the most segments a cut unit has
  int sk;            // the stream-K part's chunks: (units - whole) x chunks
  int chunks, cph;   // chunks a unit; the first of INT4's high half (INT8: chunks)
  bool tma_y;        // y's rows 16-byte aligned: the epilogue stores by TMA
};

// The stream-K part of a launch: the S chunks of the units past `whole`,
// one contiguous range a pair, balanced to a chunk.
struct Sched {
  int base, rem;
  __device__ __forceinline__ int start(int i) const { return i * base + min(i, rem); }
  // The pair whose range holds chunk g (base >= 1, which the launch checks).
  __device__ __forceinline__ int pair_of(int g) const {
    const int big = rem * (base + 1);
    return g < big ? g / (base + 1) : rem + (g - big) / base;
  }
};

__device__ __forceinline__ Sched sched_of(const Args& a) {
  const int P = static_cast<int>(cluster_count());
  return {a.sk / P, a.sk % P};
}

// A pair's walk, the same for its producer and its consumers: its whole
// units (cluster_id, + cluster_count, ...), then its stream-K range, cut at
// the ends of units. It keeps two integers; the range's end is derived
// from the launch's arguments at each piece, so that nothing more of it
// stays live through the chunk loops.
struct Walk {
  int u, g;
  __device__ __forceinline__ static Walk first(const Args& a) {
    const int i = static_cast<int>(cluster_id());
    return {i, sched_of(a).start(i)};
  }
  // The next piece: unit `unit`, its chunks [c0, c1). False at the end.
  __device__ __forceinline__ bool next(const Args& a, int& unit, int& c0, int& c1) {
    if (u < a.whole) {
      unit = u;
      c0 = 0;
      c1 = a.chunks;
      u += static_cast<int>(cluster_count());
      return true;
    }
    const int g1 = sched_of(a).start(static_cast<int>(cluster_id()) + 1);
    if (g >= g1) return false;
    const int v = g / a.chunks;
    unit = a.whole + v;
    c0 = g - v * a.chunks;
    c1 = min(a.chunks, c0 + g1 - g);
    g += c1 - c0;
    return true;
  }
};

// The segment of chunk c of stream-K unit v: its pieces, cut again at
// INT4's half boundary, numbered in K order.
__device__ __forceinline__ int seg_of(const Args& a, int v, int c) {
  const Sched sk = sched_of(a);
  const int g = v * a.chunks;
  int j = sk.pair_of(g + c) - sk.pair_of(g);
  if (c >= a.cph && sk.pair_of(g + a.cph) == sk.pair_of(g + a.cph - 1)) ++j;
  return j;
}

// Byte offset of byte j of weight row r in a stage, rows of 64 bytes as
// TMA's 64-byte swizzle lays them: 16-byte chunk c at c ^ ((r >> 1) & 3).
__device__ __forceinline__ int w_off(int r, int j) {
  return r * kKC + ((((j >> 4) ^ (r >> 1)) & 3) << 4) + (j & 15);
}

using Frag = uint32_t[kSlots][4];   // fragment slots, one a k16 step in flight

// Keeps a slot's fragment registers live up to here: the compiler must not
// give them to other values while a product may still read them.
__device__ __forceinline__ void keep_live(uint32_t (&r)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[j])::"memory");
}

// This thread's index, read again at every use (volatile): what is derived
// from it is recomputed where it is needed, not kept in a register.
__device__ __forceinline__ int tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

// Two floats rounded to bf16x2 (one conversion), and back.
__device__ __forceinline__ uint32_t f2_bf(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float2 bf2_f(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// A consumer warpgroup's chunk loop: the ring's stages in order, each k16
// step's product in flight while the next step's fragments are loaded.
// What a thread needs of its own place (rows, bytes) it derives from
// threadIdx.x where it needs it: every register the loop keeps is one the
// accumulators and the fragments in flight cannot have.
template <bool INT4>
struct Pipe {
  float (&acc)[kNT / 2];
  uint32_t ring;     // shared address of stage 0
  uint32_t bars;
  int st, ph;        // the ring's next stage and its parity

  __device__ __forceinline__ uint32_t full(int i) const { return bars + 8 * i; }
  __device__ __forceinline__ uint32_t empty(int i) const {
    return bars + 8 * (kStages + i);
  }
  // Waits for the ring's next stage; returns it.
  __device__ __forceinline__ int take() {
    const int cur = st;
    mbar_wait(full(cur), ph);
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
    return cur;
  }
  // The A fragments of k16 step s of a chunk: INT8 bytes, or one nibble of
  // each INT4 byte (the high one in the high half). A thread's bytes of a
  // row and step: 2q, 2q+1 (word q / 2, half q % 2) and 2q+8, 2q+9 (word 2 +
  // q / 2), gathered by one prmt as [2q, 2q+8, 2q+1, 2q+9].
  __device__ __forceinline__ void load_a(int stage, int s, uint32_t (&f)[4], bool hi) const {
    const int warp = threadIdx.x / 32, q = threadIdx.x % 4;
    const int r0 = (warp / 4) * 64 + (warp % 4) * 16 + (threadIdx.x % 32) / 4;
    const uint32_t sw = ring + stage * kStage + kX + 4 * (q >> 1);
    const uint32_t sel = 0x5140u + (q & 1) * 0x2222u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t row = sw + w_off(r0 + 8 * h, 16 * s);
      const uint32_t p = __byte_perm(lds32(row), lds32(row + 8), sel);
      if constexpr (INT4) {
        const uint32_t v = hi ? p >> 4 : p;
        f[h] = nib2(v);
        f[2 + h] = nib2(v >> 8);
      } else {
        s8x4(p, f[h], f[2 + h]);
      }
    }
  }
  // Step s of a chunk: its product, one wgmma group.
  __device__ __forceinline__ void issue(int stage, int s, uint32_t (&f)[4]) {
    fence_regs(acc);
    wgmma_fence();
    wgmma_rs_n256<0>(acc, f, sw128_desc(ring + stage * kStage + 32 * s, 16, 1024));
    wgmma_commit();
  }
  // Frees a stage in both blocks of the cluster (the peer's copy writes into
  // this block's stage too).
  __device__ __forceinline__ void release(int stage) const {
    __syncwarp();
    if (threadIdx.x % 32 == 0)
      for (int r = 0; r < kCluster; ++r) mbar_arrive_cta(empty(stage), r);
  }
  // Chunks [ca, cb) into acc (INT4: of one half, `hi` or not). After step
  // k's product is issued, the wait leaves kSlots - 1 in flight: the
  // product that read slot k + 1 (mod kSlots) is retired, and only then is
  // slot k + 1 loaded (the next step's, or after a chunk's last step the
  // next chunk's first). After a chunk's last step every product of the
  // chunk before is retired, and its stage is freed. Returns with every
  // product retired and every stage freed.
  __device__ __forceinline__ void run(int ca, int cb, bool hi) {
    Frag f;
    int prev = -1, cur = take();
    load_a(cur, 0, f[0], hi);
    for (int c = ca;;) {
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        issue(cur, k, f[k % kSlots]);
        wgmma_wait<kSlots - 1>();
        fence_regs(acc);
        keep_live(f[(k + 1) % kSlots]);
        if (k + 1 < kSteps) load_a(cur, k + 1, f[(k + 1) % kSlots], hi);
      }
      if (prev >= 0) release(prev);
      prev = cur;
      if (++c == cb) break;
      cur = take();
      load_a(cur, 0, f[0], hi);
    }
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) keep_live(f[k]);
    release(prev);
  }
};

template <bool INT4>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
wide_matmul_kernel(const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_y, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bars = smem_addr(smem + kStages * kStage + kWG * kOut);

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      // Every consumer warp of both blocks frees a stage: the peer's copy
      // writes into this block's stage too.
      mbar_init(bars + 8 * (kStages + i), kCluster * kConsumers / 32);
    }
    mbar_init_fence();
  }
  cluster_sync();   // the peer's barriers exist before any copy or arrival

  // Each role reads its rank and thread index after its setmaxnreg: ptxas
  // spills what lives across one.
  if (tid() >= kConsumers) {
    // ---- the producer warpgroup: lane 0 of its first warp fills the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid() == kConsumers) {
      const int rank = static_cast<int>(cluster_rank());
      const int KH = a.K / 2;   // INT4: the high half's first x column
      int st = 0, ph = 0, u, c0, c1;
      Walk walk = Walk::first(a);
      while (walk.next(a, u, c0, c1)) {
        // A tile past N (the odd tile count's phantom) reads the first
        // tile; token rows past T read the first rows. Neither is stored.
        const int tile = (u / a.t_tiles) * kCluster + rank;
        const int n0 = tile < a.tiles ? tile * kBM : 0;
        int t0 = (u % a.t_tiles) * kNT + rank * kXRows;
        if (t0 >= a.T) t0 = 0;
        for (int c = c0; c < c1; ++c) {
          const uint32_t full = bars + 8 * st, empty = bars + 8 * (kStages + st);
          mbar_wait(empty, ph ^ 1);
          const uint32_t dst = smem_addr(smem + st * kStage);
          mbar_arrive_expect_tx(full, kStage);
          const bool hi = INT4 && c >= a.cph;
          const int j0 = (hi ? c - a.cph : c) * kKC;
          tma_load_2d_multicast(dst + rank * (kX / 2), &tm_x, full, (hi ? KH : 0) + j0, t0,
                                (1 << kCluster) - 1);
          tma_load_3d(dst + kX, &tm_w, full, j0, n0, a.layer);
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    __syncwarp();
  } else {
    // ---- the consumer warpgroups ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // A thread's place (its warpgroup, rows and staging words) is derived
    // from tid() where it is used, not kept: ptxas holds this kernel to 168
    // registers a thread (64K over 384 threads, whatever setmaxnreg gives at
    // run time), and the 128 accumulators leave the rest little room.
    float acc[kNT / 2];
    Pipe<INT4> pipe{acc, smem_addr(smem), bars, 0, 0};
    auto out = [&]() {   // this warpgroup's staging
      return pipe.ring + kStages * kStage + (tid() / 128) * kOut;
    };
    auto stash = [&]() { return out() + 4 * (tid() % 128); };   // this thread's first stash word
    auto lead = []() { return tid() % 128 == 0; };   // issues the warpgroup's stores
    auto wg_sync = []() {
      asm volatile("bar.sync %0, %1;\n" ::"r"(kWgBar + tid() / 128), "n"(128) : "memory");
    };
    auto zero = [&]() {
#pragma unroll
      for (int i = 0; i < kNT / 2; ++i) acc[i] = 0.f;
    };
    // INT4: the low sums, rounded, into this thread's stash words; acc zero.
    auto stash_low = [&]() {
      if (lead()) bulk_wait<true>();   // the last TMA store has read the staging
      wg_sync();                       // and no thread still copies out of it
      const uint32_t w = stash();
#pragma unroll
      for (int i = 0; i < kNT / 4; ++i) {
        __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * i], acc[2 * i + 1]);
        sts32(w + 512 * i, *reinterpret_cast<uint32_t*>(&h));
      }
      zero();
    };
    // Segment j of stream-K unit v, this block's tile: this thread's first
    // float4 of its f32 partial.
    auto part = [&](int v, int j) {
      return reinterpret_cast<float4*>(a.ws) + tid() +
             (static_cast<int64_t>(v * kCluster + static_cast<int>(cluster_rank())) * a.segs + j) *
                 (kNT / 8) * kConsumers;
    };
    auto write_part = [&](int v, int j) {
      float4* p = part(v, j);
#pragma unroll
      for (int i = 0; i < kNT / 8; ++i)
        p[i * kConsumers] =
            make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
    };
    // This warp's walk and its piece wait in shared memory while the chunk
    // loops run (every lane writes the same words), and are read back where
    // they are needed: registers are the accumulators' and the loop's.
    auto slot = [&]() { return pipe.bars + 2 * kStages * 8 + (tid() / 32) * kSlotWords * 4; };
    auto put = [&](int k, int v) { sts32(slot() + 4 * k, static_cast<uint32_t>(v)); };
    auto get = [&](int k) { return static_cast<int>(lds32(slot() + 4 * k)); };
    // Segments [from, to) of the piece's unit, in K order, into acc, the
    // bounds and the unit read from the slot (put(5, from), put(6, to)):
    // nothing but the segment's index and loads stays live beside the
    // accumulators. kMergeLoads loads in flight at a time.
    auto sum = [&]() {
      zero();
      for (int j = get(5); j < get(6); ++j) {
        const float4* p = part(get(2) - a.whole, j);
#pragma unroll
        for (int i = 0; i < kNT / 8; ++i) {
          if (i % kMergeLoads == 0) __syncwarp();
          const float4 e = __ldcg(p + i * kConsumers);
          acc[4 * i] += e.x;
          acc[4 * i + 1] += e.y;
          acc[4 * i + 2] += e.z;
          acc[4 * i + 3] += e.w;
        }
      }
    };

    {
      const Walk w = Walk::first(a);
      put(0, w.u);
      put(1, w.g);
    }
    for (;;) {
      int u, c0, c1;
      {
        Walk w{get(0), get(1)};
        if (!w.next(a, u, c0, c1)) break;
        __syncwarp();   // every lane has read the last piece's words
        put(0, w.u);
        put(1, w.g);
        put(2, u);
        put(3, c0);
        put(4, c1);
        put(7, (u / a.t_tiles) * kCluster + static_cast<int>(cluster_rank()));   // its tile
        put(8, u % a.t_tiles);                                                    // its token tile
      }
      zero();
      // [c0, cut), then (INT4's half boundary inside the piece) [cut, c1):
      // one call of the chunk loop, so that it is inlined once.
      int ca = c0, cb = INT4 && c0 < a.cph && a.cph < c1 ? a.cph : c1;
#pragma unroll 1
      for (;;) {
        pipe.run(ca, cb, INT4 && ca >= a.cph);
        u = get(2);
        c0 = get(3);
        c1 = get(4);
        if (cb == c1) break;
        if (c0 == 0 && c1 == a.chunks) {
          stash_low();
        } else {
          if (get(7) < a.tiles)
            write_part(u - a.whole, seg_of(a, u - a.whole, c0));
          zero();
        }
        ca = cb;
        cb = c1;
      }
      if (get(7) >= a.tiles) continue;   // the phantom tile: nothing to write

      // ---- a cut unit: the last block of its tile sums the segments ----
      if (c0 != 0 || c1 != a.chunks) {
        const int v = u - a.whole;
        write_part(v, seg_of(a, v, c1 - 1));
        const int g0 = v * a.chunks;
        const Sched sk = sched_of(a);
        const int pieces = sk.pair_of(g0 + a.chunks - 1) - sk.pair_of(g0) + 1;
        if (!arrive_last(a.counters + get(7) * a.t_tiles + get(8), pieces, kEpiBar,
                         kConsumers))
          continue;
        put(5, 0);
        if constexpr (INT4) {
          put(6, seg_of(a, get(2) - a.whole, a.cph - 1) + 1);
          sum();
          stash_low();
          put(5, get(6));
        }
        put(6, seg_of(a, get(2) - a.whole, a.chunks - 1) + 1);
        sum();
      }

      // ---- epilogue ----
      // INT8: the sum rounded; INT4: the rounded low and high sums added and
      // rounded; then times the scale, rounded, into the staging transposed:
      // y's rows (tokens) of 64 outputs, 16-byte chunk k of row t at k ^ (t &
      // 7). Accumulator i: token column 8 (i / 4) + 2q + (i & 1), row r0 + 8
      // ((i / 2) & 1). stmatrix m takes accumulators 8m .. 8m + 7, matrices
      // (row half h, token block jj) = (0, 2m), (1, 2m), (0, 2m + 1), (1, 2m +
      // 1); lane 8k + cr gives row cr of matrix k. Block m's stash words lie
      // where stmatrix m writes: INT4 reads four blocks' words, syncs the
      // warpgroup, then writes those four blocks.
      const int n0 = get(7) * kBM, t0 = get(8) * kNT;
      if constexpr (!INT4) {
        if (lead()) bulk_wait<true>();   // the last TMA store has read the staging
        wg_sync();
      }
      {
        const int t = tid(), lane = t % 32;
        const int r0 = (t / 128) * 64 + ((t / 32) % 4) * 16 + lane / 4;   // rows r0, r0 + 8
        const float* sl = a.s + static_cast<int64_t>(a.layer) * a.N + n0 + r0;
        const float sc[2] = {n0 + r0 < a.N ? sl[0] : 0.f, n0 + r0 + 8 < a.N ? sl[8] : 0.f};
        const int kk = lane >> 3, cr = lane & 7, nch = 2 * ((t / 32) % 4) + (kk & 1);
        const uint32_t base = out() + cr * 128 + ((nch ^ cr) << 4) + (kk >> 1) * 1024;
#pragma unroll
        for (int g = 0; g < kNT / 64; ++g) {
          // Each pair of a thread's accumulators (token columns 2q, 2q + 1
          // of a row) is rounded as a pair, by one conversion into a
          // register of its own (a conversion of one value each would be
          // issued all at once, each into a new register, and spill).
          uint32_t pk[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int i = 16 * g + j;
            float2 v = bf2_f(f2_bf(acc[2 * i], acc[2 * i + 1]));
            if constexpr (INT4) {   // the low sums' stash word, added and rounded
              const float2 lo = bf2_f(lds32(stash() + 512 * i));
              v = bf2_f(f2_bf(lo.x + v.x, lo.y + v.y));
            }
            const float s = sc[i & 1];   // row r0 + 8 (i & 1)
            pk[j] = f2_bf(v.x * s, v.y * s);
          }
          if constexpr (INT4) wg_sync();   // these blocks' stash words read before they are written
#pragma unroll
          for (int m = 0; m < 4; ++m)
            stmatrix_x4_trans(base + (4 * g + m) * 2048, pk[4 * m], pk[4 * m + 1],
                              pk[4 * m + 2], pk[4 * m + 3]);
        }
      }
      fence_proxy_async();   // the TMA store (async proxy) reads what stmatrix wrote
      wg_sync();
      const int nw = n0 + 64 * (tid() / 128);   // this warpgroup's first output column
      if (a.tma_y) {
        if (lead() && nw < a.N) {
          tma_store_2d(&tm_y, out(), nw, t0);
          bulk_commit();
        }
      } else {
        const unsigned char* stg = smem + kStages * kStage + (tid() / 128) * kOut;
        for (int e = tid() % 128; e < kNT * 64; e += 128) {
          const int t = e >> 6, n = e & 63;
          if (t0 + t >= a.T || nw + n >= a.N) continue;
          a.y[static_cast<int64_t>(t0 + t) * a.N + nw + n] = *reinterpret_cast<const bf16*>(
              stg + t * 128 + ((((n >> 3) ^ t) & 7) << 4) + (n & 7) * 2);
        }
      }
    }
    if (lead()) bulk_wait<false>();   // every store done before the block exits
  }
  cluster_sync();   // no block exits while its peer may still signal it
}

// Launches the wide configuration: x bf16 [T, K], w the stacked weights
// (kbytes bytes a row), the plan's t_tiles, segs (the most segments a cut
// unit has: the workspace's), whole (units walked whole) and grid (an even
// count: pairs of a cluster, whose number the stream-K part is balanced
// over). Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue.
template <bool INT4>
int launch(const bf16* x, const int8_t* w, const float* s, bf16* y, float* ws,
           int* counters, int T, int N, int K, int L, int layer, int t_tiles,
           int segs, int whole, int grid, cudaStream_t stream) {
  const int kbytes = INT4 ? K / 2 : K;
  const int tiles = (N + kBM - 1) / kBM, units = (tiles + kCluster - 1) / kCluster * t_tiles;
  const int cph = (kbytes + kKC - 1) / kKC, chunks = (INT4 ? 2 : 1) * cph;
  const int pairs = grid / kCluster;
  const int64_t sk = static_cast<int64_t>(units - whole) * chunks;   // < 2^31: checked
  if (kbytes % 16 || K % 16 || t_tiles * kNT < T || grid % kCluster || pairs < 1 ||
      whole < 0 || whole > units || (sk > 0 && sk < pairs) || sk > 0x7fffffff ||
      (segs > 1 && (ws == nullptr || counters == nullptr)) ||
      reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(y) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool tma_y = N % 8 == 0;
  CUtensorMap tw{}, tx{}, ty{};
  if (!tensor_map(&tw, {w, kbytes, N, L, kKC}, true) ||
      !tensor_map(&tx, {x, K, T, 0, kXRows}, false) ||
      (tma_y && !tensor_map(&ty, {y, N, T, 0, kNT}, false)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool attr_set[64] = {};   // per device: above 48 KB only when opted in
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && !attr_set[dev]) {
    cudaFuncSetAttribute(wide_matmul_kernel<INT4>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    attr_set[dev] = true;
  }
  const Args a{x, w, s, y, ws, counters, T, N, K, layer, t_tiles, tiles, units, whole,
               segs, static_cast<int>(sk), chunks, INT4 ? cph : chunks, tma_y};
  wide_matmul_kernel<INT4><<<pairs * kCluster, kThreads, kSmem, stream>>>(tw, tx, ty, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wide
}  // namespace swiftllm
