// Fused INT4 dequant-matmul (W4A16) on the tensor cores.
//
// Replaces: swiftllm_tpu/ops/int4_matmul.py:_kernel, called through
// int4_proj_stacked. That kernel exists to stream each packed weight byte
// from device memory ONCE: the XLA path contracts the packed bytes twice,
// once per nibble half.
//
// What it computes: y[T, N] = x[T, K] @ dequant(q4[layer])^T * s[layer], x
// bf16, q4 int8 [L, N, K/2] split-half packed (byte j holds column j in its
// low nibble and column K/2 + j in its high nibble, each a signed 4-bit
// value), s f32 [L, N]. One f32 accumulator per output, multiplied by the
// scale, rounded to bf16 once. T <= 256, any N, any even K.
//
// What bounds it on the H100: at the serving decode bucket (T = 128) and an
// 8B-width MLP projection (N = 14,336, K = 4,096) it is 15.0 GFLOP against
// 34 MB: operations (15.2 us on the bf16 tensor cores, 10.2 us for the
// bytes). At T <= 16 the bytes bound it. On the f32 CUDA cores the same
// product would take over 0.2 ms, so the products run on the tensor cores.
//
// The design, simple first:
// - mma.sync.m16n8k16 bf16 -> f32 through inline PTX. A block of 8 warps
//   owns a BN = 128 column tile and up to BM = 128 rows (BM = 16, 32, 64 or
//   128, the least that holds T; T > 128 takes two row tiles, in
//   neighbouring blocks that share each weight byte through L2). It walks K
//   in chunks of 32 packed bytes, i.e. 32 columns of each half.
// - Each chunk's packed bytes are read from device memory once per block,
//   by cp.async into shared memory, with the x chunk, in a ring of three
//   stages: two chunks are in flight while the block works on one. The
//   block then sign-extends both nibbles of every byte in registers, (b <<
//   28) >> 28 and (b << 24) >> 28 on int32, and stores them as bf16 once;
//   all warps read their B fragments from there. The low nibbles multiply
//   x[:, :K/2] and the high nibbles x[:, K/2:], into the same accumulators.
// - The layer is an offset into the stacked array, as the TPU kernel's
//   scalar-prefetched layer index: no per-layer copy.
// - To fill 132 SMs even at N = 1,024, the wrapper splits K over blocks
//   (gridDim.z); each split writes f32 partial sums and a second pass adds
//   them, scales and rounds. With one split the scale and rounding happen
//   in the epilogue.
// wgmma, TMA and a deeper ring of stages are for a later version.

#include <algorithm>

#include "common.cuh"

namespace swiftllm {
namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kBN = 128;           // output columns per block
constexpr int kBKH = 32;           // packed bytes (columns of each half) per chunk
constexpr int kRow = kBKH + 8;     // bf16 per shared row: 80 bytes, so the
                                   // fragment loads of a warp hit 32 banks
constexpr int kStages = 3;         // chunks in shared memory: 2 in flight
static_assert(kThreads * 16 == kBN * kBKH, "one 16-byte dequant slice a thread");

template <int BM>
struct Tiles {
  static constexpr int WM = BM == 16 ? 1 : 2;   // warps along M
  static constexpr int WN = 8 / WM;             // warps along N
  static constexpr int MT = BM / (16 * WM);     // m16 tiles per warp
  static constexpr int NT = kBN / (8 * WN);     // n8 tiles per warp
  // x: kStages x 2 halves x BM rows; packed w: kStages x BN x BKH bytes;
  // dequantized w: 2 halves x BN rows. At BM = 128: 94 KB, two blocks an SM.
  static constexpr int kXBytes = kStages * 2 * BM * kRow * 2;
  static constexpr int kWpBytes = kStages * kBN * kBKH;
  static constexpr int kSmem = kXBytes + kWpBytes + 2 * kBN * kRow * 2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two signed nibbles of byte `v` (0..255) -> bf16 values.
__device__ __forceinline__ float lo_nibble(unsigned v) {
  return static_cast<float>(static_cast<int>(v << 28) >> 28);
}
__device__ __forceinline__ float hi_nibble(unsigned v) {
  return static_cast<float>(static_cast<int>(v << 24) >> 28);
}

// Copy chunk c (packed columns j0 .. j0+kBKH of both halves) into stage st.
// vec: K/2 % 16 == 0, so every 16-byte segment is aligned and either wholly
// inside the matrix or wholly past its edge (then zero-filled); otherwise
// element by element with a bound on each.
template <int BM>
__device__ __forceinline__ void load_chunk(
    unsigned char* smem, const bf16* __restrict__ x,
    const int8_t* __restrict__ w, int T, int N, int K, int m0, int n0, int c,
    int st, bool vec) {
  using TL = Tiles<BM>;
  const int KH = K / 2;
  const int j0 = c * kBKH;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  unsigned char* wp = smem + TL::kXBytes;
  // x: BM rows x 2 halves x 4 segments of 8 bf16.
  for (int i = threadIdx.x; i < BM * 8; i += kThreads) {
    const int seg = i % 4, half = (i / 4) % 2, r = i / 8;
    const int m = m0 + r, col = j0 + seg * 8;
    bf16* dst = xs + ((st * 2 + half) * BM + r) * kRow + seg * 8;
    const bf16* src = x + static_cast<int64_t>(m) * K + half * KH + col;
    if (vec) {
      const bool ok = m < T && col < KH;
      cp_async16(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (m < T && col + e < KH) ? src[e] : __float2bfloat16(0.f);
    }
  }
  // packed w: BN rows x 2 segments of 16 bytes.
  for (int i = threadIdx.x; i < kBN * 2; i += kThreads) {
    const int seg = i % 2, r = i / 2;
    const int n = n0 + r, col = j0 + seg * 16;
    unsigned char* dst = wp + (st * kBN + r) * kBKH + seg * 16;
    const int8_t* src = w + static_cast<int64_t>(n) * KH + col;
    if (vec) {
      const bool ok = n < N && col < KH;
      cp_async16(dst, ok ? src : w, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (n < N && col + e < KH) ? static_cast<unsigned char>(src[e]) : 0;
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, 2)
int4_matmul_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q4,
                   const float* __restrict__ s, bf16* __restrict__ y,
                   float* __restrict__ ws, int T, int N, int K, int layer,
                   int per_split, bool vec) {
  using TL = Tiles<BM>;
  extern __shared__ __align__(16) unsigned char smem[];
  const bf16* xs = reinterpret_cast<const bf16*>(smem);
  const unsigned char* wp = smem + TL::kXBytes;
  bf16* wd = reinterpret_cast<bf16*>(smem + TL::kXBytes + TL::kWpBytes);

  const int KH = K / 2;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int chunks = (KH + kBKH - 1) / kBKH;
  const int c_begin = blockIdx.z * per_split;
  const int c_end = min(chunks, c_begin + per_split);
  const int8_t* w = q4 + static_cast<int64_t>(layer) * N * KH;
  const float* sl = s + static_cast<int64_t>(layer) * N;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / TL::WN, wn = warp % TL::WN;

  float acc[TL::MT][TL::NT][4];
#pragma unroll
  for (int i = 0; i < TL::MT; ++i)
#pragma unroll
    for (int j = 0; j < TL::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // One commit group per chunk (empty past the end), so that "all but the
  // newest kStages - 2 groups have landed" means "chunk c has landed".
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (c_begin + i < c_end)
      load_chunk<BM>(smem, x, w, T, N, K, m0, n0, c_begin + i, i, vec);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int c = c_begin; c < c_end; ++c) {
    const int st = (c - c_begin) % kStages;
    asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 2));
    // Chunk c has landed for every thread, and every warp is done with the
    // products of chunk c-1: its stage and the dequantized tile are free.
    __syncthreads();
    if (c + kStages - 1 < c_end)
      load_chunk<BM>(smem, x, w, T, N, K, m0, n0, c + kStages - 1,
                     (c + kStages - 1 - c_begin) % kStages, vec);
    asm volatile("cp.async.commit_group;\n" ::);

    // Sign-extend both nibbles of this chunk's bytes once, into bf16.
    {
      const int r = threadIdx.x / 2, seg = threadIdx.x % 2;  // 256 x 16 bytes
      const uint4 u = *reinterpret_cast<const uint4*>(
          wp + (st * kBN + r) * kBKH + seg * 16);
      const unsigned char* b = reinterpret_cast<const unsigned char*>(&u);
      uint32_t lo[8], hi[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const __nv_bfloat162 l = __floats2bfloat162_rn(lo_nibble(b[2 * p]),
                                                       lo_nibble(b[2 * p + 1]));
        const __nv_bfloat162 h = __floats2bfloat162_rn(hi_nibble(b[2 * p]),
                                                       hi_nibble(b[2 * p + 1]));
        lo[p] = *reinterpret_cast<const uint32_t*>(&l);
        hi[p] = *reinterpret_cast<const uint32_t*>(&h);
      }
      uint4* dl = reinterpret_cast<uint4*>(wd + r * kRow + seg * 16);
      uint4* dh = reinterpret_cast<uint4*>(wd + (kBN + r) * kRow + seg * 16);
      dl[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      dl[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
      dh[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      dh[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* xa = xs + (st * 2 + half) * BM * kRow;
      const bf16* wb = wd + half * kBN * kRow;
#pragma unroll
      for (int kk = 0; kk < kBKH; kk += 16) {
        uint32_t a[TL::MT][4], b[TL::NT][2];
#pragma unroll
        for (int i = 0; i < TL::MT; ++i) {
          const bf16* p = xa + ((wm * TL::MT + i) * 16 + g) * kRow + kk + 2 * t;
          a[i][0] = ld32(p);
          a[i][1] = ld32(p + 8 * kRow);
          a[i][2] = ld32(p + 8);
          a[i][3] = ld32(p + 8 * kRow + 8);
        }
#pragma unroll
        for (int j = 0; j < TL::NT; ++j) {
          const bf16* p = wb + ((wn * TL::NT + j) * 8 + g) * kRow + kk + 2 * t;
          b[j][0] = ld32(p);
          b[j][1] = ld32(p + 8);
        }
#pragma unroll
        for (int i = 0; i < TL::MT; ++i)
#pragma unroll
          for (int j = 0; j < TL::NT; ++j) mma_bf16(acc[i][j], a[i], b[j]);
      }
    }
  }

  // Epilogue: accumulator e of tile (i, j) is row g (e < 2) or g + 8, column
  // 2t + e % 2 of that tile.
  const bool split = gridDim.z > 1;
#pragma unroll
  for (int i = 0; i < TL::MT; ++i) {
#pragma unroll
    for (int j = 0; j < TL::NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + (wm * TL::MT + i) * 16 + g + (e / 2) * 8;
        const int n = n0 + (wn * TL::NT + j) * 8 + 2 * t + e % 2;
        if (m >= T || n >= N) continue;
        const int64_t o = static_cast<int64_t>(m) * N + n;
        if (split)
          ws[static_cast<int64_t>(blockIdx.z) * T * N + o] = acc[i][j][e];
        else
          y[o] = __float2bfloat16(acc[i][j][e] * sl[n]);
      }
    }
  }
}

// Second pass of a split launch: y = bf16(sum over splits of ws * s).
__global__ void int4_reduce_kernel(const float* __restrict__ ws,
                                   const float* __restrict__ s,
                                   bf16* __restrict__ y, int T, int N,
                                   int splits) {
  const int64_t total = static_cast<int64_t>(T) * N;
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = 0.f;
    for (int z = 0; z < splits; ++z) a += ws[z * total + i];
    y[i] = __float2bfloat16(a * s[i % N]);
  }
}

template <int BM>
void launch(const bf16* x, const int8_t* q4, const float* s, bf16* y,
            float* ws, int T, int N, int K, int layer, int splits,
            int per_split, bool vec, cudaStream_t stream) {
  constexpr int smem = Tiles<BM>::kSmem;
  static bool attr_set = false;  // above 48 KB only as opted-in dynamic smem
  if (!attr_set) {
    cudaFuncSetAttribute(int4_matmul_kernel<BM>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr_set = true;
  }
  const dim3 grid((T + BM - 1) / BM, (N + kBN - 1) / kBN, splits);
  int4_matmul_kernel<BM><<<grid, kThreads, smem, stream>>>(
      x, q4, s, y, ws, T, N, K, layer, per_split, vec);
}

}  // namespace
}  // namespace swiftllm

// C entry, bound with ctypes. 0 < T <= 256, K even, 0 <= layer < L; x, q4, s
// and y contiguous and 16-byte aligned (the wrapper checks all of it). ws
// holds splits x T x N f32 when splits > 1 (unused otherwise). Returns
// cudaGetLastError() after the launches.
extern "C" int int4_matmul(const void* x, const void* q4, const void* s,
                           void* y, void* ws, int T, int N, int K, int layer,
                           int splits, void* stream) {
  using namespace swiftllm;
  if (T <= 0 || T > 256 || N <= 0 || K <= 0 || K % 2 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (K / 2 + kBKH - 1) / kBKH;
  const int per_split = (chunks + splits - 1) / splits;
  const bool vec = (K / 2) % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const bf16*>(x);
  const auto* qb = static_cast<const int8_t*>(q4);
  const auto* sb = static_cast<const float*>(s);
  auto* yb = static_cast<bf16*>(y);
  auto* wsb = static_cast<float*>(ws);
  if (T <= 16)
    launch<16>(xb, qb, sb, yb, wsb, T, N, K, layer, splits, per_split, vec, st);
  else if (T <= 32)
    launch<32>(xb, qb, sb, yb, wsb, T, N, K, layer, splits, per_split, vec, st);
  else if (T <= 64)
    launch<64>(xb, qb, sb, yb, wsb, T, N, K, layer, splits, per_split, vec, st);
  else
    launch<128>(xb, qb, sb, yb, wsb, T, N, K, layer, splits, per_split, vec, st);
  if (splits > 1) {
    const int64_t total = static_cast<int64_t>(T) * N;
    const int blocks = static_cast<int>(std::min<int64_t>((total + 255) / 256, 4096));
    int4_reduce_kernel<<<blocks, 256, 0, st>>>(
        wsb, sb + static_cast<int64_t>(layer) * N, yb, T, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}
