// Weight-only quantized matmul for Hopper (sm_90a): out = (x · W) ⊙ scale,
// W decoded from int8, fp8-e4m3, int4 or fp6-e3m2 storage, one fp32 scale
// per output column, dense or batched over a leading group axis.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/quantized_linear.py:
//   dstt_quantized_matmul         ← _qmm_kernel (:227): x [M, K] · int8 or
//                                   float8_e4m3fn w [K, N];
//   dstt_quantized_matmul_packed  ← _make_packed_kernel (:295): int4 split
//                                   halves [K/2, N] or fp6 plane-major
//                                   quarters [3, K/4, N], dense and batched;
//   dstt_quantized_matmul_batched ← _qmm_batched_kernel (:498): x [G, M, K]
//                                   · int8/fp8 w [G, K, N] (the MoE experts
//                                   on capacity buffers).
// A packed row holds P logical rows (1 for int8/fp8, 2 for int4, 4 for fp6)
// in NBY byte planes (3 for fp6, else 1): plane q of packed row r is
// logical row q·K/P + r, so it pairs with x column q·K/P + r. int8, fp8,
// int4 and e3m2 values are all exact in bf16, so decoding loses nothing;
// the sums are fp32 and the scale multiplies them once, in the epilogue,
// which writes fp32, bf16 or fp16. The group is blockIdx.z (1 when dense).
//
// The wrapper (ops/quantized_linear.py, `plan`) picks one of three kernels
// from the shape alone and passes its plan (tile width, K slices, steps a
// slice); each entry point checks the plan and launches that kernel:
//
// 1. fp32 x (the CPU-parity dtype): qmm_fma_kernel, fp32 FMA on the CUDA
//    cores (the JAX kernel's dot of fp32 x and a bf16 weight tile promotes
//    to fp32), 64 x 64 tiles, register-staged loads one step ahead.
//
// 2. bf16 x, decode (M ≤ 64), and any bf16 shape TMA cannot address (K/P
//    not a multiple of 8 or N not of 16): qmm_splitk_kernel. The weight
//    bytes bound it: Llama-3 8B's 14336 x 4096 down projection is 58.7 MB
//    in int8, 17.5 us at 3.35 TB/s, against 2·M·K·N operations the tensor
//    cores do in under 2 us at M 16. So every byte must be read once, by
//    enough blocks, with enough bytes in flight:
//    - one block covers all M (rows rounded up to 16) and BN = 128 columns
//      (64 when N ≤ 2048), so each weight byte is read once;
//    - K is cut into S slices of whole 64-row steps, S chosen so that the
//      grid holds about as many blocks as fit on the card (4 a SM at M ≤
//      16, else 2; ≥ 4 steps a slice): 14336 x 4096 at M 16 gives 32 x 16
//      = 512 blocks where an unsplit grid had 32;
//    - a cp.async ring (16-byte cp.async.cg) of the raw weight bytes and
//      the matching x columns, one barrier a step: at M ≤ 16 (one m16
//      tile) 4 stages and 4 blocks a SM, above 6 stages and 2 blocks;
//    - the raw bytes go from shared memory straight into mma.sync
//      m16n8k16 B fragments, decoded in registers: a lane reads one 32-bit
//      word (4 columns) from each of the 4 rows its fragment needs, so
//      n8 tile j's column g is weight column 4g + j (the epilogue maps
//      back); rows are padded to BN + 16 bytes, which puts those 4 rows on
//      distinct banks. The 8 warps split the columns in groups of 32 and
//      the step's four k16 slices among the rest, and the k-groups' sums
//      meet in shared memory once, at the end;
//    - with S > 1 each block writes its fp32 partial to the workspace [G,
//      S, M, N]; the last block of a column tile to arrive (an atomicAdd on
//      its counter after __threadfence) sums the S partials in slice order
//      (deterministic), scales, casts, stores and resets the counter to 0:
//      one launch, no memset.
//    M > 64 (shapes off the TMA alignment only) walks M in 64-row tiles on
//    blockIdx.y, unsplit.
//    Measured on an H100 SXM (700 W) at M 16 with the weights out of L2:
//    int8 14336 x 4096 in 0.037 ms (1.6 TB/s, 47 % of 3.35 TB/s), the
//    525 MB int8 head at 2.4 TB/s, Mixtral's 8 int8 experts at 2.5 TB/s;
//    the 4 MB of 4096 x 1024 take ~8 us, latency-bound at any design.
//
// 3. bf16 x, prefill (M > 64), TMA-aligned: qmm_wgmma_kernel. The
//    operations bound it (2·M·K·N at 989 TFLOP/s: 0.243 ms for 2048 x 4096
//    x 14336), which only wgmma reaches:
//    - a block owns a BM x BN tile of out (128 x 128; 256 x 128 where the
//      grid still fills the card, so each decoded weight tile feeds twice
//      the rows): two consumer warpgroups of BM / 2 rows each issue
//      wgmma.mma_async m64n128k16 (bf16, fp32 sums), and one producer warp
//      keeps a ring of up to 4 stages of TMA loads in flight (as many as
//      fit: fp6 2), each completing on an mbarrier;
//    - a step is 64 packed rows: P x boxes [BM, 64] (x viewed as [G, M,
//      P, K/P], the box of plane q at column r0, 128-byte swizzled, K-major)
//      and one box of the raw weight rows [NBY, 64, BN]; rows past M or
//      K/P and columns past N arrive as zeros;
//    - per plane q (a k-block of 64) the consumers decode the stage's raw
//      bytes into a bf16 [64 k, BN n] tile in the MN-major 128-byte
//      swizzled layout (W's own orientation; the descriptor's transpose
//      bit), fence the async proxy, meet at a named barrier and issue four
//      k16 wgmmas; the decoded tile is double-buffered, so decoding k-block
//      j + 1 overlaps the wgmma of k-block j (wgmma.wait_group 1);
//    - m-tiles run fastest (blockIdx.x), so the blocks in flight share a
//      weight tile in L2.
//    tma_wgmma.cuh holds the mbarrier, TMA and wgmma pieces. Measured on an
//    H100 SXM (700 W) at M 2048: int8 and int4 at 410-540 TFLOP/s (41-55 %
//    of 989), fp8 and fp6 at 320-390. Shared memory, more than the tensor
//    cores, bounds it: a 256 x 128 tile's k-block moves ~160 KB through it
//    (TMA writes, the decoded tile written and read as B by each of four
//    m64 products, the A reads), as long as its wgmma take at peak.
//
// The cut between 2 and 3 is M = 64: at M ≤ 64 a 128-row wgmma tile would
// be mostly padding and the bytes, not the products, bound the time.
// Offsets are 64-bit. There is no fallback: a shape, dtype or plan that a
// kernel does not take is refused with cudaErrorInvalidValue.
#include <cuda_fp16.h>

#include "attention_mma.cuh"
#include "grouped_tile.cuh"
#include "tma_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hw = dstt::hopper;

enum Fmt { kInt8 = 0, kFp8 = 1, kInt4 = 2, kFp6 = 3 };
enum Regime { kFma = 0, kSplitK = 1, kWgmma = 2 };

// logical rows per packed row, and byte planes per packed row
template <int F> struct Format {
  static constexpr int P = F == kInt4 ? 2 : (F == kFp6 ? 4 : 1);
  static constexpr int NBY = F == kFp6 ? 3 : 1;
  // the byte planes plane_value reads as w1, w2 (plane 0 when unused)
  static constexpr int B1 = NBY > 1 ? 1 : 0, B2 = NBY > 2 ? 2 : 0;
};

struct Args {
  const void* x;        // [G, M, K] of the x dtype
  const uint8_t* w;     // [G, NBY, K/P, N] bytes
  const float* scale;   // [G, N]
  void* out;            // [G, M, N] of out_dtype
  float* ws;            // split-K partials [G, S, M, N] (S > 1)
  int* counters;        // split-K arrivals [G, N tiles], 0 between launches
  int M, K, N, kp;      // kp = K / P
  int out_dtype;        // 0 fp32, 1 bf16, 2 fp16
  int slices, steps;    // split-K: slices of K, steps a slice
  int rows;             // split-K: x tile rows (M rounded up to 16, ≤ 64)
  int vec_x, vec_w;     // 16-byte loads allowed along K (x), N (w)
};

// A small float's code → float without branches: its exponent and
// mantissa bits go to the top of an fp32's exponent and mantissa fields,
// which makes the fp32 value 2^(127 - bias) too small (subnormals land on
// fp32 subnormals, which the multiply keeps: no flush to zero), and one
// multiply by that power of two rescales it exactly.
//
// float8_e4m3fn byte: sign, 4 exponent bits (bias 7), 3 mantissa bits,
// subnormals m·2^-9, S.1111.111 NaN, no infinities.
__device__ __forceinline__ float e4m3_to_f(uint32_t b) {
  const float v = __int_as_float((int)(((b & 0x80u) << 24) |
                                       ((b & 0x7fu) << 20))) * 0x1p120f;
  return (b & 0x7fu) == 0x7fu ? __int_as_float(0x7fc00000) : v;
}

// 6-bit e3m2 code: sign, 3 exponent bits (bias 3), 2 mantissa bits;
// (4 + m)·2^(e-5) for e > 0, m·2^-4 for e = 0 (quantized_linear.py:84).
__device__ __forceinline__ float e3m2_to_f(uint32_t v) {
  return __int_as_float((int)(((v & 32u) << 26) | ((v & 31u) << 21))) *
         0x1p124f;
}

// bf16 bits of two fp32 values that bf16 holds exactly: their high halves
__device__ __forceinline__ uint32_t bf16x2_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// byte j of u as the fp32 2^23 + byte (bits 0x4B0000uu)
__device__ __forceinline__ float magic_byte(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + j));
}

// The value in plane q of byte column j (0..3) of a packed row, from the
// 32-bit words w0, w1, w2 that hold those 4 columns of its byte planes
// (w1, w2: fp6's second and third). It is built as an fp32 with at most 8
// significant bits, so bf16x2_hi keeps it exactly, and without the
// conversion units (16 a clock a SM, where decoding would wait on them):
// integers through the 2^23 magic (one subtract leaves the value), fp8 and
// e3m2 codes through their bit placement above.
template <int F>
__device__ __forceinline__ float plane_value(uint32_t w0, uint32_t w1,
                                             uint32_t w2, int j, int q) {
  if constexpr (F == kInt8) {
    return magic_byte(w0 ^ 0x80808080u, j) - 8388736.f;    // (v + 128) - 128
  } else if constexpr (F == kInt4) {   // low nibble: row r, high: K/2 + r
    const uint32_t u = ((q ? w0 >> 4 : w0) & 0x0F0F0F0Fu) ^ 0x08080808u;
    return magic_byte(u, j) - 8388616.f;                   // (v + 8) - 8
  } else if constexpr (F == kFp8) {
    return e4m3_to_f((w0 >> (8 * j)) & 0xFFu);
  } else {
    // the byte triple holds planes 0..3 as 6 + 2|4 + 4|2 + 6 bits
    // (quantized_linear.py: _fp6_pack)
    const uint32_t c =
        q == 0 ? (w0 >> 2) & 0x3F3F3F3Fu
        : q == 1 ? ((w0 & 0x03030303u) << 4) | ((w1 >> 4) & 0x0F0F0F0Fu)
        : q == 2 ? ((w1 & 0x0F0F0F0Fu) << 2) | ((w2 >> 6) & 0x03030303u)
                 : w2 & 0x3F3F3F3Fu;
    return e3m2_to_f((c >> (8 * j)) & 63u);
  }
}

// out[o] = y, cast once to the output dtype (0 fp32, 1 bf16, 2 fp16)
__device__ __forceinline__ void put_out(void* out, int out_dtype, long long o,
                                        float y) {
  if (out_dtype == 0) static_cast<float*>(out)[o] = y;
  else if (out_dtype == 1) static_cast<bf16*>(out)[o] = __float2bfloat16(y);
  else static_cast<__half*>(out)[o] = __float2half_rn(y);
}

// ---------------------------------------------------------------------------
// 1. fp32 x: FMA on the CUDA cores
// ---------------------------------------------------------------------------

namespace cuda_core {

constexpr int kThreads = 128;
constexpr int BM = 64, BN = 64;  // tile of out
constexpr int BKL = 64;          // logical K rows per step (all planes)
constexpr int LDA = BKL + 4, LDB = BN + 4;   // padded by 16 bytes

// A block owns a 64 x 64 tile of out and walks K in steps of 64 logical
// rows: it loads the step's 64 / P packed rows with 16-byte loads, decodes
// them into a [64, BN] fp32 tile (plane q of packed row r becomes tile row
// q·64/P + r) and the matching x columns into a [BM, 64] tile in the same
// order; each thread owns 4 rows x 8 columns. Tiles are loaded into
// registers one step ahead; masked loads (zeros past M, N and each plane's
// K/P rows) and masked stores take every shape.
template <int F>
__global__ void __launch_bounds__(kThreads) qmm_fma_kernel(const Args a) {
  constexpr int P = Format<F>::P, NBY = Format<F>::NBY;
  constexpr int BKP = BKL / P;                       // packed rows per step
  constexpr int CX = BM * BKL / 4 / kThreads;        // x chunks per thread
  constexpr int UNITS = BKP * (BN / 16);             // 16-byte weight units
  constexpr int CW = (UNITS + kThreads - 1) / kThreads;
  constexpr int NJ = BN / 32;                        // float4 column groups
  __shared__ __align__(16) float As[BM * LDA];
  __shared__ __align__(16) float Bs[BKL * LDB];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long g = blockIdx.z;
  const int M = a.M, K = a.K, N = a.N, kp = a.kp;
  const float* x = static_cast<const float*>(a.x) + g * M * (long long)K;
  const uint8_t* w = a.w + g * (long long)NBY * kp * N;
  const float* scale = a.scale + g * N;
  const int tid = threadIdx.x;

  uint4 rx[CX], rw[CW][NBY];
  // step t covers packed rows r0 .. r0 + BKP - 1
  auto load_tiles = [&](int r0) {
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (BKL / 4), lc = (c % (BKL / 4)) * 4;
      const int q = lc / BKP, r = lc % BKP;
      rx[i] = m0 + row < M
                  ? load_chunk(x + (long long)(m0 + row) * K, q * kp + r0 + r,
                               (q + 1) * kp, a.vec_x)
                  : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int u = tid + j * kThreads;
      const int r = u / (BN / 16), cc = (u % (BN / 16)) * 16;
#pragma unroll
      for (int b = 0; b < NBY; ++b)
        rw[j][b] = u < UNITS && r0 + r < kp
                       ? load_chunk(w + ((long long)b * kp + r0 + r) * N,
                                    n0 + cc, N, a.vec_w)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (BKL / 4), lc = (c % (BKL / 4)) * 4;
      *reinterpret_cast<uint4*>(As + row * LDA + lc) = rx[i];
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int u = tid + j * kThreads;
      if (u >= UNITS) continue;
      const int r = u / (BN / 16), cc = (u % (BN / 16)) * 16;
#pragma unroll
      for (int h = 0; h < 4; ++h) {   // 4 columns → one 16-byte store
        const uint32_t w0 = (&rw[j][0].x)[h];
        const uint32_t w1 = (&rw[j][Format<F>::B1].x)[h];
        const uint32_t w2 = (&rw[j][Format<F>::B2].x)[h];
#pragma unroll
        for (int q = 0; q < P; ++q) {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = plane_value<F>(w0, w1, w2, e, q);
          *reinterpret_cast<uint4*>(Bs + (q * BKP + r) * LDB + cc + 4 * h) =
              pack<float>(v);
        }
      }
    }
  };

  float acc[4][4 * NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4 * NJ; ++j) acc[i][j] = 0.f;

  const int ty = tid / 8, tx = tid % 8;       // 16 x 8 threads
  const int nk = (kp + BKP - 1) / BKP;
  load_tiles(0);
  for (int t = 0; t < nk; ++t) {
    store_tiles();
    __syncthreads();
    if (t + 1 < nk) load_tiles((t + 1) * BKP);
#pragma unroll 8
    for (int k = 0; k < BKL; ++k) {
      float av[4], bv[4 * NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[(ty + 16 * i) * LDA + k];
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        const float4 v = *reinterpret_cast<const float4*>(
            Bs + k * LDB + tx * 4 + 32 * c);
        bv[4 * c] = v.x; bv[4 * c + 1] = v.y;
        bv[4 * c + 2] = v.z; bv[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4 * NJ; ++q) acc[i][q] += av[i] * bv[q];
    }
    __syncthreads();
  }

  // epilogue: out = acc · scale[col] in fp32, cast once; rows past M and
  // columns past N are dropped
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4 * NJ; ++q) {
      const int row = m0 + ty + 16 * i;
      const int col = n0 + tx * 4 + (q / 4) * 32 + q % 4;
      if (row < M && col < N)
        put_out(a.out, a.out_dtype, (g * M + row) * (long long)N + col,
                acc[i][q] * scale[col]);
    }
}

}  // namespace cuda_core

// ---------------------------------------------------------------------------
// 2. bf16 x at decode: split-K over a cp.async ring, mma.sync
// ---------------------------------------------------------------------------

namespace splitk {

constexpr int kThreads = 256;   // 8 warps
// cp.async ring depth: 6 stages at up to 64 rows (2 blocks a SM), 4 at up
// to 16 (the decode batch: 4 blocks a SM, whose registers allow it)
template <int MT> struct Ring {
  static constexpr int kStages = MT == 1 ? 4 : 6;
  static constexpr int kBlocksPerSM = MT == 1 ? 4 : 2;
};
constexpr int BKL = 64;         // logical K rows per step (all planes)
constexpr int LDA = BKL + 8;    // x tile row stride (bf16), 16-byte pad

// raw weight row stride: BN bytes and 16 of pad, so that the four rows a
// B fragment reads (2t, 2t + 1, 2t + 8, 2t + 9) fall on distinct banks
template <int BN>
__host__ __device__ constexpr int row_bytes() { return BN + 16; }

// dynamic shared memory: the ring of x tiles [rows, LDA] and raw weight
// rows [NBY, 64 / P, BN + 16] (after the loop it holds the k-groups'
// partial sums)
template <int F, int BN, int MT>
constexpr int smem_bytes(int rows) {
  return Ring<MT>::kStages *
         (rows * LDA * 2 +
          Format<F>::NBY * (BKL / Format<F>::P) * row_bytes<BN>());
}

// A block: rows m0 .. m0 + 16·MT - 1 (all of M at decode; MT m16 tiles,
// 1 or 4), BN columns, one slice of K. Its 8 warps split the columns into
// BN / 32 groups of 32 and the four k16 slices of a step into 8 / (BN /
// 32) groups; the k-groups' sums meet in shared memory at the end, in a
// fixed order.
template <int F, int BN, int MT>
__global__ void __launch_bounds__(kThreads, Ring<MT>::kBlocksPerSM)
    qmm_splitk_kernel(const Args a) {
  constexpr int kStages = Ring<MT>::kStages;
  constexpr int P = Format<F>::P, NBY = Format<F>::NBY;
  constexpr int BKP = BKL / P;                  // packed rows per step
  constexpr int RB = row_bytes<BN>();
  constexpr int WST = NBY * BKP * RB;           // raw weight bytes a stage
  constexpr int CPR = BN / 16;                  // 16-byte chunks a row
  constexpr int CW = BN / 32, KW = 8 / CW;      // column, k groups of warps
  constexpr int XCH = (16 * MT * 8 + kThreads - 1) / kThreads;
  constexpr int WCH = (NBY * BKP * CPR + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) uint8_t smem[];
  const int rows = a.rows;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  uint8_t* wr = smem + kStages * rows * LDA * 2;

  const int n0 = blockIdx.x * BN;
  const int sl = blockIdx.y % a.slices;
  const int m0 = blockIdx.y / a.slices * 16 * MT;
  const long long g = blockIdx.z;
  const int M = a.M, K = a.K, N = a.N, kp = a.kp;
  const bf16* x = static_cast<const bf16*>(a.x) + g * M * (long long)K;
  const uint8_t* w = a.w + g * (long long)NBY * kp * N;
  const float* scale = a.scale + g * N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cw = warp % CW, kw = warp / CW;
  const int gq = lane >> 2, tq = lane & 3;
  const int nk = (kp + BKP - 1) / BKP;
  const int t0 = sl * a.steps, t1 = min(nk, t0 + a.steps);
  const int mtiles = (min(16 * MT, M - m0) + 15) / 16;   // m16 tiles < M

  // start loading step t (packed rows t·BKP ..) into stage st; x column
  // q·kp + r feeds tile column q·BKP + (r - r0); zeros past M, the plane's
  // kp rows and N
  auto issue = [&](int t, int st) {
    const int r0 = t * BKP;
    bf16* xd = xs + st * rows * LDA;
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * kThreads;
      if (c >= rows * 8) break;
      const int row = c >> 3, lc = (c & 7) * 8;
      const int q = lc / BKP, r = r0 + lc % BKP;
      const bool ok = m0 + row < M && r < kp;
      const bf16* src = x + (long long)(m0 + row) * K + q * kp + r;
      bf16* dst = xd + row * LDA + lc;
      if (a.vec_x) {
        dstt::mma::cp_async16(dst, ok ? src : x, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dst[e] = ok && r + e < kp ? src[e] : __float2bfloat16(0.f);
      }
    }
    uint8_t* wd = wr + st * WST;
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int u = tid + i * kThreads;
      if (u >= NBY * BKP * CPR) break;
      const int b = u / (BKP * CPR), r = (u / CPR) % BKP, cc = (u % CPR) * 16;
      const int row = r0 + r, col = n0 + cc;
      const uint8_t* src = w + ((long long)b * kp + row) * N + col;
      uint8_t* dst = wd + (b * BKP + r) * RB + cc;
      if (a.vec_w) {
        const bool ok = row < kp && col < N;
        dstt::mma::cp_async16(dst, ok ? src : w, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = row < kp && col + e < N ? src[e] : 0;
      }
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int z = 0; z < 4; ++z) acc[i][j][z] = 0.f;

  // ring: steps t .. t + kStages - 2 in flight, one barrier a step
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i, i);
    dstt::mma::cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    const int i = t - t0;
    // step t has landed; every warp is done with step t - 1, whose stage
    // takes step t + kStages - 1
    dstt::mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < t1) issue(t + kStages - 1, (i + kStages - 1) % kStages);
    dstt::mma::cp_async_commit();
    const bf16* xa = xs + (i % kStages) * rows * LDA;
    const uint8_t* wd = wr + (i % kStages) * WST;
    // k16 slice kk: tile rows 16kk .. (plane q, packed rows rb ..)
    auto slice = [&](auto kk_c) {
      constexpr int kk = decltype(kk_c)::value;
      constexpr int q = 16 * kk / BKP, rb = 16 * kk % BKP;
      uint32_t wv[NBY * 4];
#pragma unroll
      for (int p = 0; p < NBY; ++p)
#pragma unroll
        for (int i4 = 0; i4 < 4; ++i4) {
          const int r = rb + 2 * tq + (i4 & 1) + 8 * (i4 >> 1);
          wv[4 * p + i4] = *reinterpret_cast<const uint32_t*>(
              wd + (p * BKP + r) * RB + cw * 32 + 4 * gq);
        }
      // B fragment of n8 tile j: b0 = k 2t, 2t + 1; b1 = k 2t + 8, 2t + 9
      // (wv[i4]), column g = weight column 4g + j (byte j of the words)
      auto value = [&](int i4, int j) {
        return plane_value<F>(wv[i4], wv[4 * Format<F>::B1 + i4],
                              wv[4 * Format<F>::B2 + i4], j, q);
      };
      uint32_t fb[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        fb[j][0] = bf16x2_hi(value(0, j), value(1, j));
        fb[j][1] = bf16x2_hi(value(2, j), value(3, j));
      }
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        if (mi < mtiles) {
          uint32_t fa[4];
          ldmatrix_x4(fa, xa + (mi * 16 + (lane & 15)) * LDA + 16 * kk +
                              (lane >> 4) * 8);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mi][j], fa, fb[j]);
        }
      }
    };
    // warp-uniform dispatch: k-group kw takes slices kw, kw + KW, ..
    using std::integral_constant;
    if constexpr (KW == 2) {
      if (kw == 0) {
        slice(integral_constant<int, 0>{});
        slice(integral_constant<int, 2>{});
      } else {
        slice(integral_constant<int, 1>{});
        slice(integral_constant<int, 3>{});
      }
    } else {
      switch (kw) {
        case 0: slice(integral_constant<int, 0>{}); break;
        case 1: slice(integral_constant<int, 1>{}); break;
        case 2: slice(integral_constant<int, 2>{}); break;
        default: slice(integral_constant<int, 3>{});
      }
    }
  }

  // the k-groups' sums: groups 1 .. KW - 1 through shared memory (the ring
  // is done; (KW - 1)·CW·mtiles·2 KB fit in its 4·rows·144 bytes), added
  // to group 0 in order
  dstt::mma::cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  auto at = [&](int o, int mi, int j, int z) {
    return red + ((((o * CW + cw) * mtiles + mi) * 16 + 4 * j + z) * 32 +
                  lane);
  };
  if (kw > 0) {
#pragma unroll
    for (int mi = 0; mi < MT; ++mi)
      if (mi < mtiles)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int z = 0; z < 4; ++z) *at(kw - 1, mi, j, z) = acc[mi][j][z];
  }
  __syncthreads();
  if (kw == 0) {
    for (int o = 0; o < KW - 1; ++o)
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
        if (mi < mtiles)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int z = 0; z < 4; ++z) acc[mi][j][z] += *at(o, mi, j, z);
  }

  // epilogue (k-group 0): acc[mi][j] holds rows m0 + 16mi + gq (+ 8) at
  // columns n0 + 32cw + 8tq + j (+ 4)
  const int cb = n0 + cw * 32 + 8 * tq;
  auto each = [&](auto&& emit) {
    if (kw != 0) return;
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      if (mi >= mtiles) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + mi * 16 + gq + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cb + j + 4 * e;
            if (col < N) emit(row, col, acc[mi][j][2 * h + e]);
          }
      }
    }
  };
  if (a.slices == 1) {
    each([&](int row, int col, float v) {
      put_out(a.out, a.out_dtype, (g * M + row) * (long long)N + col,
              v * scale[col]);
    });
    return;
  }
  // split K (M ≤ 64, m0 = 0): partial → workspace; the last block of this
  // column tile to arrive sums all S partials in slice order
  float* part = a.ws + (g * a.slices + sl) * (long long)M * N;
  each([&](int row, int col, float v) { part[(long long)row * N + col] = v; });
  __threadfence();
  __syncthreads();
  __shared__ int last;
  int* counter = a.counters + g * gridDim.x + blockIdx.x;
  if (tid == 0) last = atomicAdd(counter, 1) == a.slices - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // 4 columns a thread (16-byte loads) when N allows, else 1
  const float* base = a.ws + g * a.slices * (long long)M * N;
  const long long plane = (long long)M * N;
  const int V = N % 4 == 0 ? 4 : 1;
  for (int e = tid; e < M * BN / V; e += kThreads) {
    const int row = e / (BN / V), col = n0 + (e % (BN / V)) * V;
    if (col >= N) continue;
    const float* src = base + (long long)row * N + col;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    if (V == 4) {
#pragma unroll 4
      for (int k = 0; k < a.slices; ++k) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + k * plane));
        s[0] += v.x; s[1] += v.y; s[2] += v.z; s[3] += v.w;
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < a.slices; ++k) s[0] += __ldcg(src + k * plane);
    }
    for (int c = 0; c < V; ++c)
      put_out(a.out, a.out_dtype, (g * M + row) * (long long)N + col + c,
              s[c] * scale[col + c]);
  }
  if (tid == 0) *counter = 0;
}

}  // namespace splitk

// ---------------------------------------------------------------------------
// 3. bf16 x at prefill: wgmma fed by a TMA ring
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BKP = 64;                     // packed rows a step
constexpr int BN = 128;                     // columns of out a block
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kSmemMax = 232448;            // a block's shared memory, sm_90

// A block owns BM = 128·MT rows (each consumer warpgroup MT m64 tiles) by
// BN columns of out.
template <int F, int MT> struct Cfg {
  static constexpr int P = Format<F>::P, NBY = Format<F>::NBY;
  static constexpr int BM = 128 * MT;
  static constexpr int XBOX = BM * 64 * 2;          // an x box [BM, 64]
  static constexpr int BDEC = 64 * BN * 2;          // a decoded tile
  static constexpr int WBYTES = NBY * BKP * BN;     // the raw weight box
  static constexpr int STAGE = P * XBOX + WBYTES;   // a multiple of 1024
  // as many stages as fit, up to 4, beside two decoded tiles, the full
  // and empty barriers and the slack that aligns the base to 1024 bytes
  // (the 128-byte swizzle's atom)
  static constexpr int kFit = (kSmemMax - 2 * BDEC - 1024 - 64) / STAGE;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "no room for a two-stage ring");
  static constexpr int SMEM = kStages * STAGE + 2 * BDEC + 16 * kStages +
                              1024;
};

// Plane q of the raw weight box [NBY, 64, BN] (stage bytes) → the bf16
// tile [64 k, BN n], MN-major with the 128-byte swizzle: n block n / 64
// (8 KB each), row k (128 bytes), 16-byte chunk ((n % 64) / 8) ^ (k % 8).
// The 256 consumer threads take BN / 32 units of 8 columns each.
template <int F>
__device__ __forceinline__ void decode_plane(const uint8_t* raw, uint8_t* bt,
                                             int q, int tid) {
  constexpr int NBY = Format<F>::NBY;
#pragma unroll
  for (int i = 0; i < BN / 32; ++i) {
    const int u = tid + i * kConsumers;
    const int r = u / (BN / 8), n = (u % (BN / 8)) * 8;
    uint2 v[NBY];
#pragma unroll
    for (int p = 0; p < NBY; ++p)
      v[p] = *reinterpret_cast<const uint2*>(raw + (p * BKP + r) * BN + n);
    float f[8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        f[4 * h + j] = plane_value<F>(
            h ? v[0].y : v[0].x, h ? v[Format<F>::B1].y : v[Format<F>::B1].x,
            h ? v[Format<F>::B2].y : v[Format<F>::B2].x, j, q);
    const int chunk = ((n & 63) >> 3) ^ (r & 7);
    *reinterpret_cast<uint4*>(bt + (n >> 6) * 8192 + r * 128 + chunk * 16) =
        make_uint4(bf16x2_hi(f[0], f[1]), bf16x2_hi(f[2], f[3]),
                   bf16x2_hi(f[4], f[5]), bf16x2_hi(f[6], f[7]));
  }
}

template <int F, int MT>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap, const Args a) {
  using C = Cfg<F, MT>;
  constexpr int P = C::P, S = C::kStages, BDEC = C::BDEC, XBOX = C::XBOX;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* bdec = smem + S * C::STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(bdec + 2 * BDEC);
  uint64_t* empty = full + S;

  const int m0 = blockIdx.x * C::BM, n0 = blockIdx.y * BN, g = blockIdx.z;
  const int nsteps = (a.kp + BKP - 1) / BKP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], 1);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: step t's x boxes (one a plane) and raw weight box into
    // stage t % S, once the consumers have released that stage
    if (lane == 0) {
      for (int t = 0; t < nsteps; ++t) {
        const int s = t % S;
        if (t >= S) hw::mbar_wait(&empty[s], (t / S - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        hw::mbar_arrive_expect_tx(&full[s], C::STAGE);
#pragma unroll
        for (int q = 0; q < P; ++q)
          hw::tma_load_4d(st + q * XBOX, &xmap, &full[s], t * BKP, q, m0, g);
        hw::tma_load_4d(st + P * XBOX, &wmap, &full[s], n0, t * BKP, 0, g);
      }
    }
    return;
  }

  // consumers: warpgroup wgi owns rows m0 + 64·(MT·wgi + mt) .. + 63
  const int wgi = warp >> 2;
  float acc[MT][BN / 2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mt][i] = 0.f;
  int j = 0;   // k-blocks issued
  for (int t = 0; t < nsteps; ++t) {
    const int s = t % S;
    hw::mbar_wait(&full[s], (t / S) & 1);
    const uint8_t* st = smem + s * C::STAGE;
#pragma unroll
    for (int q = 0; q < P; ++q, ++j) {
      uint8_t* bt = bdec + (j & 1) * BDEC;
      decode_plane<F>(st + P * XBOX, bt, q, tid);
      hw::fence_proxy_async();
      hw::named_bar_sync(1, kConsumers);     // the decoded tile is whole
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) hw::fence_regs(acc[mt]);
      hw::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hw::wgmma_m64n128k16<1>(
              acc[mt],
              hw::desc_sw128(st + q * XBOX + (wgi * MT + mt) * 8192 + kk * 32,
                             16, 1024),
              hw::desc_sw128(bt + kk * 2048, 8192, 1024), 1);
      hw::wgmma_commit();
      hw::wgmma_wait<1>();                   // k-block j - 1 is done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) hw::fence_regs(acc[mt]);
      // both warpgroups are past k-block j - 1: its decoded tile is free,
      // and at a step's first k-block the previous stage is too
      hw::named_bar_sync(1, kConsumers);
      if (q == 0 && t > 0 && tid == 0) hw::mbar_arrive(&empty[(t - 1) % S]);
    }
  }
  hw::wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) hw::fence_regs(acc[mt]);

  const int col0 = n0 + (lane & 3) * 2;
  const float* scale = a.scale + (long long)g * a.N;
  const long long obase = (long long)g * a.M * a.N;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int row0 = m0 + (wgi * MT + mt) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int i = 0; i < BN / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= a.M) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * i + e;
          if (col < a.N)
            put_out(a.out, a.out_dtype, obase + (long long)row * a.N + col,
                    acc[mt][4 * i + 2 * h + e] * scale[col]);
        }
      }
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

template <int F>
int launch_fma(Args a, int G, cudaStream_t stream) {
  a.vec_x = a.K % 4 == 0 && a.kp % 4 == 0 && aligned16(a.x);
  a.vec_w = a.N % 16 == 0 && aligned16(a.w);
  const dim3 grid((a.M + cuda_core::BM - 1) / cuda_core::BM, (a.N + cuda_core::BN - 1) / cuda_core::BN,
                  G);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  cuda_core::qmm_fma_kernel<F><<<grid, cuda_core::kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int F, int BN, int MT>
int launch_splitk(Args a, int G, cudaStream_t stream) {
  constexpr int P = Format<F>::P;
  const int nk = (a.kp + splitk::BKL / P - 1) / (splitk::BKL / P);
  const int mtiles = (a.M + 16 * MT - 1) / (16 * MT);
  // the plan: S slices of `steps` steps cover the nk steps, none empty
  const bool covers = nk == 0 ? a.slices == 1
                              : a.steps >= 1 &&
                                    (long long)(a.slices - 1) * a.steps < nk &&
                                    nk <= (long long)a.slices * a.steps;
  if (a.slices < 1 || !covers || (long long)mtiles * a.slices > 65535 ||
      G > 65535 || (a.slices > 1 && (a.M > 16 * MT || !a.ws || !a.counters)))
    return (int)cudaErrorInvalidValue;
  a.rows = a.M < 16 * MT ? (a.M + 15) / 16 * 16 : 16 * MT;
  a.vec_x = a.K % 8 == 0 && a.kp % 8 == 0 && aligned16(a.x);
  a.vec_w = a.N % 16 == 0 && aligned16(a.w);
  auto kernel = splitk::qmm_splitk_kernel<F, BN, MT>;
  static unsigned done = 0;
  const cudaError_t err =
      hw::allow_smem(reinterpret_cast<const void*>(kernel),
                 splitk::smem_bytes<F, BN, MT>(16 * MT), done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.N + BN - 1) / BN, mtiles * a.slices, G);
  kernel<<<grid, splitk::kThreads, splitk::smem_bytes<F, BN, MT>(a.rows),
           stream>>>(a);
  return (int)cudaGetLastError();
}

template <int F, int MT>
int launch_wgmma(const Args& a, int G, cudaStream_t stream) {
  using C = wg::Cfg<F, MT>;
  constexpr int BN = wg::BN;
  const long long mt = (a.M + C::BM - 1) / C::BM;
  const long long nt = (a.N + BN - 1) / BN;
  if (a.kp <= 0 || a.kp % 8 || a.N % 16 || !aligned16(a.x) ||
      !aligned16(a.w) || mt > 0x7fffffff || nt > 65535 || G > 65535)
    return (int)cudaErrorInvalidValue;
  // x as [G, M, P, K/P] bf16: box [1, BM, 1, 64] (plane q at column r0)
  CUtensorMap xmap, wmap;
  const cuuint64_t xd[4] = {(cuuint64_t)a.kp, (cuuint64_t)C::P,
                            (cuuint64_t)a.M, (cuuint64_t)G};
  const cuuint64_t xs[3] = {(cuuint64_t)a.kp * 2, (cuuint64_t)a.K * 2,
                            (cuuint64_t)a.M * a.K * 2};
  const cuuint32_t xb[4] = {64, 1, C::BM, 1};
  // w as [G, NBY, K/P, N] bytes: box [1, NBY, 64, BN]
  const cuuint64_t wd[4] = {(cuuint64_t)a.N, (cuuint64_t)a.kp,
                            (cuuint64_t)C::NBY, (cuuint64_t)G};
  const cuuint64_t wst[3] = {(cuuint64_t)a.N, (cuuint64_t)a.kp * a.N,
                             (cuuint64_t)C::NBY * a.kp * a.N};
  const cuuint32_t wb[4] = {BN, wg::BKP, C::NBY, 1};
  if (!hw::make_map_4d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, a.x, xd, xs,
                       xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hw::make_map_4d(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.w, wd, wst, wb,
                       CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  auto kernel = wg::qmm_wgmma_kernel<F, MT>;
  static unsigned done = 0;
  const cudaError_t err =
      hw::allow_smem(reinterpret_cast<const void*>(kernel), C::SMEM, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)mt, (unsigned)nt, G);
  kernel<<<grid, wg::kThreads, C::SMEM, stream>>>(xmap, wmap, a);
  return (int)cudaGetLastError();
}

template <int F>
int launch_as(const Args& a, int G, int regime, int bm, int bn,
              cudaStream_t st) {
  if (regime == kFma) return launch_fma<F>(a, G, st);
  if (regime == kWgmma) {
    // 128 x 128 tiles for every format; 256 x 128 except fp6 (its four x
    // boxes and three raw planes would leave no room for a ring)
    if (bm == 128 && bn == 128) return launch_wgmma<F, 1>(a, G, st);
    if constexpr (F != kFp6)
      if (bm == 256 && bn == 128) return launch_wgmma<F, 2>(a, G, st);
    return (int)cudaErrorInvalidValue;
  }
  // split-K: one m16 tile when M ≤ 16 (bm 16), else up to four (bm 64)
  if (bm == 16)
    return bn == 64 ? launch_splitk<F, 64, 1>(a, G, st)
                    : launch_splitk<F, 128, 1>(a, G, st);
  return bn == 64 ? launch_splitk<F, 64, 4>(a, G, st)
                  : launch_splitk<F, 128, 4>(a, G, st);
}

// fmt: 0 int8, 1 fp8-e4m3, 2 int4, 3 fp6-e3m2; x_dtype: 0 fp32, 1 bf16;
// out_dtype: 0 fp32, 1 bf16, 2 fp16; regime: 0 FMA (fp32 x), 1 split-K,
// 2 wgmma (bf16 x); bm, bn: the tile (wgmma: 128 x 128 or 256 x 128;
// split-K: bm 16 or 64, bn 64 or 128); slices, steps: the split-K plan.
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, void* counters, int G, int M, int K, int N, int fmt,
           int x_dtype, int out_dtype, int regime, int bm, int bn,
           int slices, int steps, void* stream) {
  const int planes = fmt == kInt4 ? 2 : (fmt == kFp6 ? 4 : 1);
  const bool regime_ok = regime == kFma ? x_dtype == 0
                         : regime == kSplitK
                             ? x_dtype == 1 && (bm == 16 || bm == 64) &&
                                   (bn == 64 || bn == 128)
                             : regime == kWgmma && x_dtype == 1;
  if (G < 1 || M < 0 || K < 0 || N < 0 || K % planes || out_dtype < 0 ||
      out_dtype > 2 || fmt < 0 || fmt > 3 || !regime_ok)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  Args a{x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
         out, static_cast<float*>(ws), static_cast<int*>(counters), M, K, N,
         K / planes, out_dtype, slices, steps, 0, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (fmt) {
    case kInt8: return launch_as<kInt8>(a, G, regime, bm, bn, st);
    case kFp8: return launch_as<kFp8>(a, G, regime, bm, bn, st);
    case kInt4: return launch_as<kInt4>(a, G, regime, bm, bn, st);
    default: return launch_as<kFp6>(a, G, regime, bm, bn, st);
  }
}

}  // namespace

// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a format, dtype, shape or plan it does not take). ws and counters
// are the split-K workspace [G, slices, M, N] fp32 and arrival counters
// [G, N tiles] int32 (all 0), needed when slices > 1.
//
// out [M, N] = (x [M, K] · w [K, N]) ⊙ scale [N]; w int8 or fp8 (fmt 0, 1).
extern "C" int dstt_quantized_matmul(const void* x, const void* w,
                                     const void* scale, void* out, void* ws,
                                     void* counters, int G, int M, int K,
                                     int N, int fmt, int x_dtype,
                                     int out_dtype, int regime, int bm,
                                     int bn, int slices, int steps,
                                     void* stream) {
  if (G != 1 || (fmt != kInt8 && fmt != kFp8))
    return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, ws, counters, G, M, K, N, fmt, x_dtype,
                out_dtype, regime, bm, bn, slices, steps, stream);
}

// out [G, M, N] = (x [G, M, K] · W[g]) ⊙ scale [G, N], W int4 [K/2, N] or
// fp6 [3, K/4, N] per group (fmt 2, 3); G = 1 is the dense form.
extern "C" int dstt_quantized_matmul_packed(
    const void* x, const void* w, const void* scale, void* out, void* ws,
    void* counters, int G, int M, int K, int N, int fmt, int x_dtype,
    int out_dtype, int regime, int bm, int bn, int slices, int steps,
    void* stream) {
  if (fmt != kInt4 && fmt != kFp6) return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, ws, counters, G, M, K, N, fmt, x_dtype,
                out_dtype, regime, bm, bn, slices, steps, stream);
}

// out [G, M, N] = (x [G, M, K] · w [G, K, N]) ⊙ scale [G, N]; w int8 or
// fp8 (fmt 0, 1).
extern "C" int dstt_quantized_matmul_batched(
    const void* x, const void* w, const void* scale, void* out, void* ws,
    void* counters, int G, int M, int K, int N, int fmt, int x_dtype,
    int out_dtype, int regime, int bm, int bn, int slices, int steps,
    void* stream) {
  if (fmt != kInt8 && fmt != kFp8) return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, ws, counters, G, M, K, N, fmt, x_dtype,
                out_dtype, regime, bm, bn, slices, steps, stream);
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
