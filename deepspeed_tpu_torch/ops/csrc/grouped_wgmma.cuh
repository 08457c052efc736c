// Grouped GEMMs of the dropless MoE FFN on Hopper's warpgroup MMA, fed by a
// ring of TMA loads — the bf16 "wgmma" form of grouped_gate_up and
// grouped_down (grouped_matmul.cu), grouped_dgdu, grouped_dxs and
// grouped_wgrad (grouped_matmul_bwd.cu). Each .cu builds into its own
// library, so the shared device code lives here, on the mbarrier, TMA and
// wgmma pieces of tma_wgmma.cuh. The row-tile template (grouped_wgmma)
// takes how a consumer forms A from a stage (AF), B's orientation
// (TRANS_B), the number of (A, B) pairs summed along K (PAIRS) and whether
// B's two halves are two matrices with an output each (kTWO); the dW
// template (grouped_wgrad_wgmma) walks one expert's rows as its K; the
// dgdu template (grouped_dgdu_wgmma) runs three products over one K and
// the GLU backward on their sums.
//
// What a row-tile block computes. Rows are sorted by expert and every
// expert starts on a bm-row layout tile (bm a multiple of 64), so each
// 64-row tile belongs to one expert, group_of_tile[row / bm]. A block owns
// 128 rows (two consecutive 64-row tiles) by BN = 256 columns of B and sums
//     acc += A_p[rows, k] · B_p[g][k, columns]
// over its pairs p, in fp32; the epilogue scales each row by w (fp32, when
// given), rounds to bf16 and stores, masked past N and past the live rows.
//   grouped_gate_up: PAIRS 1, A = xs, B = wg[g] columns n0 .. + 127 beside
//                 wi[g]'s same columns, both [K = d, N = f] with N
//                 contiguous (MN-major: TRANS_B 1; kTWO): one m64n256k16 a
//                 k16 slice gives gate (acc0) and up (acc1) from one read of
//                 the xs tile; a block covers 128 columns of each output;
//   grouped_down: PAIRS 1, A = h = silu(gate)·up (kAGlu: formed in the
//                 block from the gate and up tiles, see below), B = wo[g]
//                 [K = f, N = d] with N contiguous (TRANS_B 1);
//   grouped_dxs:  PAIRS 2, A = dg then du, B = wg[g] then wi[g], each read
//                 as [N = d, K = f] with K contiguous (K-major, wgmma's
//                 canonical B: TRANS_B 0) — one sum over both products.
// The block reads group_of_tile for its two tiles on the device. A block
// whose first tile is at or past live_tiles[0] returns before it issues any
// load (the host never learns how many tiles are live); a dead second tile
// is computed with the first and not stored. When the two tiles belong to
// two experts (split), the block walks K twice: rows 0-63 against the first
// expert's B, then rows 64-127 against the second's. The layout keeps bm
// 64, so an expert pads at most 63 rows.
//
// What a dW block computes (grouped_wgrad: dW[e] = Σ over e's live rows r
// of a[r]ᵀ·b[r]). K is the rows: the block (expert e = blockIdx.z, 128 of
// A's columns, 256 of B's) walks rows [r0, r1), e's tiles of group_of_tile
// (lower_bound) clipped to live_tiles, one 64-row box a step, so no step
// needs a mask. A = aᵀ is MN-major (a is [rows, M] with m contiguous: the
// wgmma's transposed A, kAMN), B = b MN-major, both from 2-D [rows, C]
// maps. An expert with no live row issues no load and writes zeros. The
// scaled product dwo = hᵀ·round(dz·w) keeps its rounding point by running
// transposed: dwoᵀ = round(dz·w)ᵀ·h, A formed in registers from the dz box
// (ldmatrix .trans, times w[row] in fp32, rounded to bf16: kAScaled, the RS
// form), B = h, and the epilogue stores the tile transposed through shared
// memory so the writes stay whole rows. Grid (B tiles, A tiles, expert),
// the expert slowest: one expert's blocks (88 at the 1B/8e shape) run
// together and read its rows from device memory about once.
//
// What a dgdu block computes (grouped_dgdu, replacing _dgdu_rc_kernel and
// _dgdu_kernel of deepspeed_tpu/ops/grouped_matmul.py:411, :366): 128 rows
// by BN_f = kDgduBN (64) f columns. All three products walk K = d
// together; a stage holds dz's and xs's 64-row boxes, wg's and wi's [64 k,
// 64 n] boxes side by side (one MN-major B whose 128-column halves are
// [gate | up] of a 64-column chunk: one m64n128k16 a k16 slice, gate_up's
// one-wide-wgmma lesson) and wo's [BN_f n, 64 k] box of the [E, f, d] view
// (K-major, as dxs reads wg): dh = dz·woᵀ is a second wgmma (m64n64k16).
// Both accumulators share the n-tiling, so a thread holds g, u and dh of
// the same (row, column), and the epilogue forms, in fp32 at the Pallas
// bodies' rounding points, g, u rounded to bf16 (or read from the saved
// gate/up: the saved form runs dh alone), dg = round(dh·w·u·dsilu(g)), du
// = round(dh·w·silu(g)), h = round(silu(g)·u) and, with w, the row's
// partial Σ dh·h over the tile's columns (unrounded h, no w, columns past
// f masked), written to dwp[column tile][row] without atomics. The three
// bf16 tiles go through the freed ring (rows padded by 16 bytes) and out
// as whole 16-byte pieces of their rows. Warpgroup i owns rows 64·i .. +
// 63 by all BN_f columns; a split block walks K once per expert, and the
// group whose rows a pass does not hold waits on the ring without
// products, so each row's partial is summed in one warpgroup, in one
// order. Raster: the column tiles fastest where one expert's three
// matrices stay within the L2 (1B/8e: 17.3 MB), else bands of row blocks
// whose dz and xs fit 16 MB of it (Mixtral: 352 MB an expert).
//
// Block and ring: one producer warp and two consumer warpgroups (288
// threads, one block a SM). The producer's lane 0 keeps a ring of up to 4
// stages of 64-deep k-steps in flight (dxs, gate_up and wgrad 4 of 48 KB,
// down 3 of 64 KB), each completing on a "full" mbarrier; each consumer
// warpgroup releases a stage on its "empty" mbarrier once its products of
// it have completed (wgmma.wait_group 1 keeps one step's products in
// flight). A stage holds
//   - A: a [64 rows, 64 k] box for each 64-row half of a 2-D view [R_pad,
//     K] (gate and up for down), 128-byte swizzled, K-major; for wgrad a
//     [64 rows (k), 64 m] box for each 64-column half of A, MN-major;
//   - B: [256 n, 64 k] K-major in one box of a view [E, d, f] (dxs), or
//     four [64 k, 64 n] boxes of a view [E, K, N] (down, gate_up: the
//     MN-major layout, 8 KB between 64-column blocks) or of a 2-D [rows,
//     N] view (wgrad), 128-byte swizzled. The expert is a dimension of its
//     own, so no box reads into the next expert, and TMA's zero fill
//     covers the K tail (K % 64) and the N tail: loads need no masks;
//   - scaled wgrad: the step's 64 values of w beside the stages.
// Unsplit, consumer warpgroup i owns rows 64·i .. + 63 by all 256 columns:
// one wgmma m64n256k16 a k16 slice. Split, both take the pass's 64 rows,
// warpgroup i columns 128·i .. + 127 (m64n128k16; gate_up: warpgroup 0 gate,
// 1 up).
//
// down's prologue (kAGlu): each consumer warp reads its 16 rows of the gate
// and up boxes with ldmatrix (the 128-byte swizzle applied to its
// addresses), forms h = silu(g)·u in fp32 with the hardware exp and divide
// (as the mma.sync kernel does), rounds it to bf16 straight into wgmma's A
// fragments, and the wgmma take A from registers (the RS form): h never
// reaches shared memory, and no proxy fence or barrier sits in the loop.
// Two register buffers of A fragments alternate, so a step's h is formed
// while the previous step's products run. The scaled wgrad does the same
// with round(dz·w).
//
// What bounds it (H100 SXM, 989 TFLOP/s bf16, 3.35 TB/s). The products
// (2·rows·d·f a pair) bound the work: down at Mixtral (2048 tokens, top-2,
// d 4096, f 14336) 481 GFLOP, 0.486 ms; dxs at the 1B/8e training shape
// (16,384 tokens, d 1024, f 2816) 378 GFLOP, 0.382 ms. Two things hold
// these kernels, measured with tools/grouped_wgmma_variants.py: the bytes
// from device memory (down and dxs walk the column tiles fastest, so each
// A tile is read once; row blocks fastest re-read all of A once per column
// tile and ran 1.15-1.4x slower), and the bytes a stage moves through
// shared memory at a roughly fixed rate a SM: dxs's 48 KB a 4.2 MFLOP step
// run at ~630 TFLOP/s at 1B/8e, down's 64 KB (gate and up) at ~350 at
// Mixtral (the same GEMM with one A operand ran 1.4x faster). The GLU's
// exp and divide, formed again for every column tile, cost ~17 % of down;
// a wgmma m64n256k16 a k16 slice beats two m64n128k16, and 32-deep steps
// lose to 64-deep ones. gate_up and wgrad move 48 KB a 4.2 MFLOP step, as
// dxs does. gate_up's weights outgrow the L2 at Mixtral (235 MB an expert,
// ~4.5 row blocks an expert): with the column tiles fastest only ~1 row
// block of its 112 column tiles is in flight and every row block streams
// its expert's weights again (2.935 ms), so there gate_up walks bands of
// row blocks (the rows of a band fastest, then its column tiles; `band`
// from ops/grouped_matmul.py plan: as many row blocks as keep their xs
// within 16 MB of L2): 1.946 ms, rows fastest 2.233. Where an expert's
// weights fit that share (Qwen, 1B/8e) the column tiles go fastest (Qwen
// 0.399 ms against 0.493 in bands). wgrad at Mixtral has only ~8 k-steps a
// block (512 rows an expert), so ring fill and the 64 KB epilogue of each
// of its 14,336 blocks weigh (~350 TFLOP/s against ~590 at 1B/8e). Figures:
// PERF.md §6.
#pragma once

#include "grouped_tile.cuh"
#include "tma_wgmma.cuh"

namespace dstt {
namespace grouped {

namespace hw = dstt::hopper;

constexpr int BM = 128;                     // rows a block: two 64-row tiles
constexpr int BN = 256;                     // columns of B a block
constexpr int BK = 64;                      // k a step (128 bytes of bf16)
constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kSmemMax = 232448;            // a block's shared memory
constexpr int kTile = 64 * BK * 2;          // a box [64 rows, 64 k]: 8 KB

// How a consumer warpgroup takes wgmma's A from a stage
constexpr int kAK = 0;       // K-major boxes, shared memory (dxs, gate_up)
constexpr int kAMN = 1;      // MN-major boxes, shared memory (wgrad: aᵀ)
constexpr int kAGlu = 2;     // silu(gate)·up in registers (down)
constexpr int kAScaled = 3;  // round(a·w[k]) of an MN-major box, in
                             // registers (wgrad's scaled product)

// The tensor maps of one launch: A_p and B_p for each pair p (down: a[0]
// gate, a[1] up, b[0] wo; dxs: a = dg, du; b = wg, wi; gate_up: a[0] xs,
// b = wg, wi; wgrad: a[0] A's source, a[1] w when scaled, b[0] B).
struct Maps {
  CUtensorMap a[2];
  CUtensorMap b[2];
};

struct Epilogue {
  __nv_bfloat16* out;            // [rows, N]
  __nv_bfloat16* out2;           // gate_up's up [rows, N], else nullptr
  const __nv_bfloat16* w;        // per-row scale [rows], or nullptr
  const int* group_of_tile;
  const int* live_tiles;
  int N, K, bm;                  // K: the depth of one pair
  int band;                      // row blocks a band of the raster
};

// grouped_wgrad: out [E, MA, NB] = per expert Aᵀ-side · B over its rows, or
// (scaled) out [E, NB, MA], the tile stored transposed
struct WgradEpilogue {
  __nv_bfloat16* out;
  const int* group_of_tile;
  const int* live_tiles;
  int n_tiles;                   // rows / bm
  int MA, NB, bm;                // columns of A's and B's sources
};

template <int AF>
struct Cfg {
  static constexpr bool kRS = AF == kAGlu || AF == kAScaled;  // A in regs
  // A: two 64-row boxes (rows 0-63, 64-127) of each A operand read a step
  static constexpr int AHALF = kTile * (AF == kAGlu ? 2 : 1);
  static constexpr int ABYTES = 2 * AHALF;
  static constexpr int BBYTES = BN * BK * 2;                  // 32 KB
  static constexpr int STAGE = ABYTES + BBYTES;               // 1 KB-aligned
  static constexpr int WBYTES = AF == kAScaled ? BK * 2 : 0;  // w a step
  // as many stages as fit, up to 4, beside the barriers and the slack that
  // aligns the base to 1024 bytes (the swizzle's atom)
  static constexpr int kFit = (kSmemMax - 1024 - 64) / (STAGE + WBYTES);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "no room for a two-stage ring");
  static constexpr int SMEM = kStages * (STAGE + WBYTES) + 16 * kStages
                              + 1024;
};

// grouped_dgdu's f columns a block (BN_f): 64, or 128 (see DgduCfg)
constexpr int kDgduBN = 64;

// grouped_dgdu's tensor maps: dz, xs [rows, d] in boxes [64 rows, 64 k];
// wg, wi [E, d, f] in boxes [64 k, 64 n] (MN-major B, as gate_up reads
// them); wo [E, f, d] in boxes [BN_f n, 64 k] (K-major B, as dxs reads
// wg). The saved form leaves xs, wg and wi unset.
struct DgduMaps {
  CUtensorMap dz, xs, wg, wi, wo;
};

struct DgduEpilogue {
  __nv_bfloat16* dg;             // [rows, f]
  __nv_bfloat16* du;             // [rows, f]
  __nv_bfloat16* h;              // [rows, f]
  const __nv_bfloat16* gate;     // [rows, f]: the saved form
  const __nv_bfloat16* up;       // [rows, f]: the saved form
  const __nv_bfloat16* w;        // per-row combine weight [rows], or nullptr
  float* dwp;                    // [column tiles, rows] (with w)
  const int* group_of_tile;
  const int* live_tiles;
  int rows, d, f, bm;
  int band;                      // row blocks a band of the raster
};

// grouped_dgdu's block and ring at BNF f columns, recomputed (kRC) or
// saved gate/up. A stage: dz's two 64-row boxes (and xs's), then wg's and
// wi's [64 k, 64 n] boxes of each 64-column chunk side by side (wg0 wi0
// wg1 wi1: one MN-major B whose 128-column halves are [gate | up] of a
// chunk), then wo's [BNF n, 64 k] box. BNF 64: 56 KB a stage, 4 stages,
// 96 fp32 accumulators a consumer thread, one producer warp. BNF 128: 80
// KB, 2 stages, 192 accumulators: a producer warpgroup hands its
// registers to the consumers (setmaxnreg; 168 a thread at launch).
template <int BNF, bool kRC>
struct DgduCfg {
  static_assert(BNF == 64 || BNF == 128, "64 or 128 f columns a block");
  // at 128 columns a producer warpgroup hands registers to the consumers
  static constexpr bool kShift = BNF == 128;
  static constexpr int kThreads = kConsumers + (kShift ? 128 : 32);
  static constexpr int kProducerRegs = 40, kConsumerRegs = 232;
  static constexpr int AHALF = kTile * (kRC ? 2 : 1);  // 64 rows of A
  static constexpr int ABYTES = 2 * AHALF;
  static constexpr int GUBYTES = kRC ? 2 * BNF * BK * 2 : 0;
  static constexpr int WOBYTES = BNF * BK * 2;
  static constexpr int STAGE = ABYTES + GUBYTES + WOBYTES;
  static constexpr int kFit = (kSmemMax - 1024 - 64) / STAGE;
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static_assert(kStages >= 2, "no room for a two-stage ring");
  static constexpr int SMEM = kStages * STAGE + 16 * kStages + 1024;
  // the epilogue stages each consumer warpgroup's dg, du and h tiles [64
  // rows, BNF] in the freed ring, rows padded by 16 bytes
  static constexpr int LDS = BNF + 8;
  static_assert(2 * 3 * 64 * LDS * 2 <= kStages * STAGE, "staging > ring");
};

// h = silu(g)·u of a bf16 pair, in fp32, rounded to bf16
__device__ __forceinline__ uint32_t glu2(uint32_t g, uint32_t u) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&g));
  const float2 y = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(silu_mul(x.x, y.x), silu_mul(x.y, y.y));
  return *reinterpret_cast<const uint32_t*>(&h);
}

// (a.x·w.x, a.y·w.y) of a bf16 pair in fp32, rounded to bf16
__device__ __forceinline__ uint32_t scale2(uint32_t a, float2 w) {
  const float2 x = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&a));
  const __nv_bfloat162 r = __floats2bfloat162_rn(x.x * w.x, x.y * w.y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// acc (a 64 x 128 accumulator of one warpgroup) → out rows row0 + 16w +
// lane/4 + 8h (w: the warp in its group), columns col0 + 8i + 2(lane%4) +
// {0, 1}, times w[row] in fp32 when given, rounded to bf16; rows at or past
// `live_rows` and columns at or past N are not written (N is a multiple of
// 8: both columns of a pair or neither).
__device__ __forceinline__ void store_acc(const float (&acc)[64],
                                          __nv_bfloat16* out, int N,
                                          const __nv_bfloat16* w, int row0,
                                          int col0, long long live_rows) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  col0 += (lane & 3) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + (lane >> 2) + 8 * h;
    if (row >= live_rows) continue;
    const float sc = w != nullptr ? __bfloat162float(w[row]) : 1.0f;
    __nv_bfloat16* o = out + (long long)row * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = col0 + 8 * i;
      if (col < N)
        *reinterpret_cast<__nv_bfloat162*>(o + col) = __floats2bfloat162_rn(
            acc[4 * i + 2 * h] * sc, acc[4 * i + 2 * h + 1] * sc);
    }
  }
}

// A consumer warpgroup's view of the ring
struct Ring {
  uint8_t* smem;                // stage s at smem + s * STAGE
  const __nv_bfloat16* w;       // kAScaled: stage s's w at w + s * BK
  uint64_t* full;
  uint64_t* empty;
  int wgi, wtid;                // this warpgroup, and the thread in it
};

// One step of a consumer warpgroup: wait for stage t, issue its products,
// keep them in flight, wait for step t - 1's and release its stage. MODE 0
// (two tiles of one expert, or a dW block): this group's rows (A half wgi)
// by both B halves into acc0 and acc1; MODE 1 / 2 (split, pass 0 / 1): A
// half MODE - 1 by B half wgi into acc0 / acc1.
//   kAK / kAMN (SS): A straight from the stage's swizzled box, K-major or
//   MN-major (the transposed-A wgmma).
//   kAGlu, kAScaled (RS): each warp reads its 16 rows of A from the stage
//   with ldmatrix (the swizzle applied to its addresses; .trans for the
//   MN-major box), forms h = silu(g)·u, or round(a·w[k]), into the A
//   fragments `af` (registers, this step's buffer), and the wgmma take A
//   from there: no A tile written to shared memory, no proxy fence, no
//   barrier. `af_prev` (step t - 1's buffer) is free once step t - 1 is
//   waited for.
template <int MODE, int AF, int TRANS_B>
__device__ __forceinline__ void step(const Ring& r, float (&acc0)[64],
                                     float (&acc1)[64], uint32_t (&af)[4][4],
                                     uint32_t (&af_prev)[4][4], int t) {
  using C = Cfg<AF>;
  constexpr int S = C::kStages;
  const int s = t % S;
  const int slot = MODE == 0 ? r.wgi : MODE - 1;  // the A half read
  hw::mbar_wait(&r.full[s], (t / S) & 1);
  const uint8_t* st = r.smem + s * C::STAGE;
  const uint8_t* a = st + slot * kTile;
  const int lane = r.wtid & 31;
  if constexpr (AF == kAGlu) {
    const int row = (r.wtid >> 5) * 16 + (lane & 15);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int o = row * 128 + (((2 * kk + (lane >> 4)) ^ (row & 7)) << 4);
      uint32_t g[4], u[4];
      ldmatrix_x4(g, a + o);
      ldmatrix_x4(u, a + 2 * kTile + o);
#pragma unroll
      for (int j = 0; j < 4; ++j) af[kk][j] = glu2(g[j], u[j]);
    }
  } else if constexpr (AF == kAScaled) {
    // the box holds 64 k rows of 64 m values; this warp's m16 x k16 A
    // fragment is four 8 x 8 matrices (m 0-7 / 8-15 by k 0-7 / 8-15),
    // each read transposed from 8 k rows: lane 8i + j names row j of
    // matrix i. A thread then holds k 2(lane%4) + {0, 1} (+ 8 for
    // matrices 2, 3), scaled by those rows' w, all 16 of which it reads
    // first (7 % faster than beside each slice's ldmatrix).
    const int mat = lane >> 3, j = lane & 7;
    const int chunk = (r.wtid >> 5) * 2 + (mat & 1);   // 16-byte m chunk
    const __nv_bfloat16* w = r.w + s * BK;
    float2 ws[BK / 16][2];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ws[kk][h] = __bfloat1622float2(*reinterpret_cast<
            const __nv_bfloat162*>(w + kk * 16 + 2 * (lane & 3) + 8 * h));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int k = kk * 16 + (mat >> 1) * 8 + j;
      uint32_t v[4];
      ldmatrix_x4_trans(v, a + k * 128 + ((chunk ^ (k & 7)) << 4));
      const float2 w0 = ws[kk][0], w1 = ws[kk][1];
      af[kk][0] = scale2(v[0], w0);
      af[kk][1] = scale2(v[1], w0);
      af[kk][2] = scale2(v[2], w1);
      af[kk][3] = scale2(v[3], w1);
    }
  }
  // B's two 128-column halves, 16 KB each in either orientation
  const uint8_t* b = st + C::ABYTES;
  hw::fence_regs(acc0);
  hw::fence_regs(acc1);
  if constexpr (C::kRS) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hw::fence_regs(af[kk]);
  }
  hw::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    auto db = [&](int q) {
      return TRANS_B ? hw::desc_sw128(b + q * 16384 + kk * 2048, kTile, 1024)
                     : hw::desc_sw128(b + q * 16384 + kk * 32, 16, 1024);
    };
    const uint64_t da = AF == kAMN
                            ? hw::desc_sw128(a + kk * 2048, kTile, 1024)
                            : hw::desc_sw128(a + kk * 32, 16, 1024);
    constexpr int TRANS_A = AF == kAMN ? 1 : 0;
    if constexpr (MODE == 0) {
      // one m64n256k16 over both halves (B's halves are contiguous)
      if constexpr (C::kRS)
        hw::wgmma_m64n256k16_rs<TRANS_B>(acc0, acc1, af[kk], db(0), 1);
      else
        hw::wgmma_m64n256k16<TRANS_B, TRANS_A>(acc0, acc1, da, db(0), 1);
    } else {
      float (&acc)[64] = MODE == 1 ? acc0 : acc1;
      if constexpr (C::kRS)
        hw::wgmma_m64n128k16_rs<TRANS_B>(acc, af[kk], db(r.wgi), 1);
      else
        hw::wgmma_m64n128k16<TRANS_B, TRANS_A>(acc, da, db(r.wgi), 1);
    }
  }
  hw::wgmma_commit();
  hw::wgmma_wait<1>();                         // step t - 1 is done
  hw::fence_regs(acc0);
  hw::fence_regs(acc1);
  if constexpr (C::kRS) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) hw::fence_regs(af_prev[kk]);
  }
  if (t > 0 && r.wtid == 0) hw::mbar_arrive(&r.empty[(t - 1) % S]);
}

// Steps [t0, t1) in MODE; the A fragments alternate between two register
// buffers (a pair of steps an iteration, so each has a fixed buffer). With
// A in registers the last step is waited for before the buffers go out of
// scope.
template <int MODE, int AF, int TRANS_B>
__device__ __forceinline__ void consume(const Ring& r, float (&acc0)[64],
                                        float (&acc1)[64], int t0, int t1) {
  uint32_t af0[4][4], af1[4][4];
  for (int t = t0; t < t1; t += 2) {
    step<MODE, AF, TRANS_B>(r, acc0, acc1, af0, af1, t);
    if (t + 1 < t1) step<MODE, AF, TRANS_B>(r, acc0, acc1, af1, af0, t + 1);
  }
  if constexpr (Cfg<AF>::kRS) {
    hw::wgmma_wait<0>();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      hw::fence_regs(af0[kk]);
      hw::fence_regs(af1[kk]);
    }
  }
}

// The ring's shared memory: S stages of `stage` bytes, then `wbytes` of w
// for each stage (the scaled form), then the full and empty barriers; the
// barriers initialised
__device__ __forceinline__ Ring ring_at(uint8_t* smem_raw, int S, int stage,
                                        int wbytes) {
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* w = smem + S * stage;
  uint64_t* full = reinterpret_cast<uint64_t*>(w + S * wbytes);
  uint64_t* empty = full + S;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hw::mbar_init(&full[s], 1);
      hw::mbar_init(&empty[s], kConsumers / 128);
    }
    hw::fence_barrier_init();
  }
  __syncthreads();
  const int wtid = threadIdx.x & 127;
  return Ring{smem, reinterpret_cast<const __nv_bfloat16*>(w), full, empty,
              (int)(threadIdx.x >> 7), wtid};
}

template <int AF>
__device__ __forceinline__ Ring ring_init(uint8_t* smem_raw) {
  using C = Cfg<AF>;
  return ring_at(smem_raw, C::kStages, C::STAGE, C::WBYTES);
}

// The block's (row block, column tile) in a raster of bands of `band` row
// blocks: the blocks walk a band's row blocks fastest, then its column
// tiles, then the next band (band 1: the column tiles fastest).
__device__ __forceinline__ void raster(int band, int& rb, int& ct) {
  const int cols = gridDim.x, rows = gridDim.y;
  const long long i = (long long)blockIdx.y * cols + blockIdx.x;
  const int b0 = (int)(i / ((long long)band * cols)) * band;
  const int h = min(band, rows - b0);
  const int j = (int)(i - (long long)b0 * cols);
  rb = b0 + j % h;
  ct = j / h;
}

template <int AF, int TRANS_B, int PAIRS, bool kTWO = false>
__device__ __forceinline__ void grouped_wgmma(const Maps& maps,
                                              const Epilogue& ep) {
  using C = Cfg<AF>;
  constexpr int S = C::kStages;
  constexpr int BNO = kTWO ? BN / 2 : BN;      // output columns a block
  int rb, ct;
  raster(ep.band, rb, ct);
  // the block's two 64-row tiles: the first live, the second maybe dead
  // (or past the rows); a dead second tile is computed with the first
  // and not stored
  const int row0 = rb * BM;
  const long long live_rows = (long long)ep.live_tiles[0] * ep.bm;
  if (row0 >= live_rows) return;
  const int g0 = ep.group_of_tile[row0 / ep.bm];
  const int g1 = row0 + 64 < live_rows ? ep.group_of_tile[(row0 + 64) / ep.bm]
                                       : g0;
  // split: the tiles belong to two experts, so the block walks K twice,
  // rows 0-63 against g0's B, then rows 64-127 against g1's
  const bool split = g1 != g0;
  const int n0 = ct * BNO;

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init<AF>(smem_raw);
  uint8_t* smem = ring.smem;

  const int ksteps = (ep.K + BK - 1) / BK;     // per pair
  const int nsteps = PAIRS * ksteps;           // per pass
  const int total = split ? 2 * nsteps : nsteps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == kConsumers / 32) {
    // producer: step t (pass, pair, k-step) into stage t % S, once both
    // consumer warpgroups have released that stage. A stage holds the A
    // boxes of the rows the pass reads (both halves, or half `pass` when
    // split; gate and up for down), each at its half's slot, and B of the
    // pass's expert.
    if (lane == 0) {
      for (int t = 0; t < total; ++t) {
        const int s = t % S, pass = t / nsteps, u = t % nsteps;
        const int p = u / ksteps, k0 = (u % ksteps) * BK;
        const int g = pass ? g1 : g0;
        uint64_t* full = &ring.full[s];
        if (t >= S) hw::mbar_wait(&ring.empty[s], (t / S - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        hw::mbar_arrive_expect_tx(full,
                                  split ? C::STAGE - C::AHALF : C::STAGE);
        auto load_a = [&](int at, const CUtensorMap* map, int r) {
          hw::tma_load_4d(st + at * kTile, map, full, k0, r, 0, 0);
        };
        for (int half = 0; half < 2; ++half) {
          if (split && half != pass) continue;
          const int r = row0 + 64 * half;
          if constexpr (AF == kAGlu) {
            load_a(half, &maps.a[0], r);
            load_a(2 + half, &maps.a[1], r);
          } else {
            load_a(half, &maps.a[p], r);
          }
        }
        uint8_t* b = st + C::ABYTES;
        if constexpr (kTWO) {
          // wg[g]'s columns n0 .. + 127, then wi[g]'s
#pragma unroll
          for (int q = 0; q < 4; ++q)
            hw::tma_load_4d(b + q * kTile, &maps.b[q >> 1], full,
                            n0 + 64 * (q & 1), k0, g, 0);
        } else if constexpr (TRANS_B) {
#pragma unroll
          for (int q = 0; q < BN / 64; ++q)
            hw::tma_load_4d(b + q * kTile, &maps.b[p], full, n0 + 64 * q,
                            k0, g, 0);
        } else {
          hw::tma_load_4d(b, &maps.b[p], full, k0, n0, g, 0);
        }
      }
    }
  } else {
    // consumers. Unsplit: warpgroup wgi owns rows 64·wgi .. + 63 and all
    // 256 columns of B (acc0 columns 0-127, acc1 128-255). Split: pass q's
    // rows 64·q .. + 63 by B columns 128·wgi .. + 127 go to acc0 (q 0) or
    // acc1.
    const int wgi = ring.wgi;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
    if (!split) {
      consume<0, AF, TRANS_B>(ring, acc0, acc1, 0, nsteps);
    } else {
      consume<1, AF, TRANS_B>(ring, acc0, acc1, 0, nsteps);
      consume<2, AF, TRANS_B>(ring, acc0, acc1, nsteps, total);
    }
    hw::wgmma_wait<0>();
    hw::fence_regs(acc0);
    hw::fence_regs(acc1);

    // gate_up: B columns 0-127 are gate's, 128-255 up's
    auto store = [&](const float (&acc)[64], int half, int r0) {
      if constexpr (kTWO)
        store_acc(acc, half ? ep.out2 : ep.out, ep.N, ep.w, r0, n0,
                  live_rows);
      else
        store_acc(acc, ep.out, ep.N, ep.w, r0, n0 + 128 * half, live_rows);
    };
    if (!split) {
      store(acc0, 0, row0 + 64 * wgi);
      store(acc1, 1, row0 + 64 * wgi);
    } else {
      store(acc0, wgi, row0);
      store(acc1, wgi, row0 + 64);
    }
  }
}

// grouped_wgrad's block: expert blockIdx.z, A columns m0 = 128·blockIdx.y
// .. + 127 (warpgroup i the 64 from m0 + 64·i), B columns n0 =
// 256·blockIdx.x .. + 255, K = the expert's live rows.
template <bool kScale>
__device__ __forceinline__ void grouped_wgrad_wgmma(
    const Maps& maps, const WgradEpilogue& ep) {
  constexpr int AF = kScale ? kAScaled : kAMN;
  using C = Cfg<AF>;
  constexpr int S = C::kStages;
  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  // this expert's live rows: its tiles of group_of_tile, below live_tiles
  const int live = min(ep.live_tiles[0], ep.n_tiles);
  const int t0 = min(lower_bound(ep.group_of_tile, ep.n_tiles, e), live);
  const int t1 = min(lower_bound(ep.group_of_tile, ep.n_tiles, e + 1), live);
  const int r0 = t0 * ep.bm;
  const int nsteps = (t1 - t0) * (ep.bm / BK);

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_init<AF>(smem_raw);
  uint8_t* smem = ring.smem;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp == kConsumers / 32) {
    // producer: rows r0 + 64·t .. + 63 into stage t % S: A's two column
    // halves, B's four 64-column boxes and (scaled) those rows' w
    if (lane == 0) {
      for (int t = 0; t < nsteps; ++t) {
        const int s = t % S, k0 = r0 + t * BK;
        uint64_t* full = &ring.full[s];
        if (t >= S) hw::mbar_wait(&ring.empty[s], (t / S - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        hw::mbar_arrive_expect_tx(full, C::STAGE + C::WBYTES);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          hw::tma_load_4d(st + half * kTile, &maps.a[0], full, m0 + 64 * half,
                          k0, 0, 0);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q)
          hw::tma_load_4d(st + C::ABYTES + q * kTile, &maps.b[0], full,
                          n0 + 64 * q, k0, 0, 0);
        if constexpr (kScale)
          hw::tma_load_4d(smem + S * C::STAGE + s * C::WBYTES, &maps.a[1],
                          full, k0, 0, 0, 0);
      }
    }
    return;
  }
  const int wgi = ring.wgi;
  float acc0[64], acc1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.f;
  consume<0, AF, 1>(ring, acc0, acc1, 0, nsteps);
  hw::wgmma_wait<0>();
  hw::fence_regs(acc0);
  hw::fence_regs(acc1);

  if constexpr (!kScale) {
    __nv_bfloat16* out = ep.out + (long long)e * ep.MA * ep.NB;
    store_acc(acc0, out, ep.NB, nullptr, m0 + 64 * wgi, n0, ep.MA);
    store_acc(acc1, out, ep.NB, nullptr, m0 + 64 * wgi, n0 + 128, ep.MA);
  } else {
    // out[e] is [NB, MA]: the tile goes transposed through the ring's
    // shared memory (every stage has been read: both warpgroups are past
    // their last wgmma), then out as whole 16-byte pieces of its rows
    constexpr int LDT = BM + 8;                 // padded: no bank conflict
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem);
    hw::named_bar_sync(1, kConsumers);
    const int w4 = (tid >> 5) & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ma = 64 * wgi + 16 * w4 + (lane >> 2) + 8 * h;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int nb = 8 * i + 2 * (lane & 3);
        tile[nb * LDT + ma] = __float2bfloat16(acc0[4 * i + 2 * h]);
        tile[(nb + 1) * LDT + ma] = __float2bfloat16(acc0[4 * i + 2 * h + 1]);
        tile[(nb + 128) * LDT + ma] = __float2bfloat16(acc1[4 * i + 2 * h]);
        tile[(nb + 129) * LDT + ma] =
            __float2bfloat16(acc1[4 * i + 2 * h + 1]);
      }
    }
    hw::named_bar_sync(1, kConsumers);
    __nv_bfloat16* out = ep.out + (long long)e * ep.MA * ep.NB;
    for (int c = tid; c < BN * (BM / 8); c += kConsumers) {
      const int nb = c / (BM / 8), q = c % (BM / 8);
      const int row = n0 + nb, col = m0 + 8 * q;
      if (row < ep.NB && col < ep.MA)   // MA is a multiple of 8
        *reinterpret_cast<uint4*>(out + (long long)row * ep.MA + col) =
            *reinterpret_cast<const uint4*>(tile + nb * LDT + 8 * q);
    }
  }
}

// grouped_dgdu's accumulators of one consumer warpgroup (its 64 rows):
// gu[c] holds gate (columns 0-63) beside up (64-127) of the block's 64-
// column chunk c, dh all BNF columns of dz·wo[g]ᵀ; a thread holds g, u
// and dh of the same (row, column).
template <int BNF, bool kRC>
struct DgduAcc {
  float gu[kRC ? BNF / 64 : 1][64];
  float dh[BNF / 2];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < BNF / 2; ++i) dh[i] = 0.f;
    if constexpr (kRC) {
#pragma unroll
      for (int c = 0; c < BNF / 64; ++c)
#pragma unroll
        for (int i = 0; i < 64; ++i) gu[c][i] = 0.f;
    }
  }
  __device__ __forceinline__ void fence() {
    hw::fence_regs(dh);
    if constexpr (kRC) {
#pragma unroll
      for (int c = 0; c < BNF / 64; ++c) hw::fence_regs(gu[c]);
    }
  }
};

// One step of a consumer warpgroup: wait for stage t; when ACTIVE, issue
// its products on this group's rows (A slot wgi) — [gate | up] = xs·[wg |
// wi] as one wgmma over the stage's whole MN-major B, dh = dz·woᵀ as a
// second, K-major — keep them in flight and wait for step t - 1's; else
// wait for every product issued (a split block's other pass). Then
// release stage t - 1.
template <int BNF, bool kRC, bool ACTIVE>
__device__ __forceinline__ void dgdu_step(const Ring& r,
                                          DgduAcc<BNF, kRC>& acc, int t) {
  using C = DgduCfg<BNF, kRC>;
  constexpr int S = C::kStages;
  const int s = t % S;
  hw::mbar_wait(&r.full[s], (t / S) & 1);
  if constexpr (ACTIVE) {
    const uint8_t* st = r.smem + s * C::STAGE;
    const uint8_t* dz = st + r.wgi * kTile;
    const uint8_t* xs = st + (2 + r.wgi) * kTile;
    const uint8_t* gu = st + C::ABYTES;
    const uint8_t* wo = gu + C::GUBYTES;
    acc.fence();
    hw::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if constexpr (kRC) {
        const uint64_t dx = hw::desc_sw128(xs + kk * 32, 16, 1024);
        const uint64_t dgu = hw::desc_sw128(gu + kk * 2048, kTile, 1024);
        if constexpr (BNF == 64)
          hw::wgmma_m64n128k16<1>(acc.gu[0], dx, dgu, 1);
        else
          hw::wgmma_m64n256k16<1>(acc.gu[0], acc.gu[1], dx, dgu, 1);
      }
      const uint64_t dd = hw::desc_sw128(dz + kk * 32, 16, 1024);
      const uint64_t dw = hw::desc_sw128(wo + kk * 32, 16, 1024);
      if constexpr (BNF == 64)
        hw::wgmma_m64n64k16<0>(acc.dh, dd, dw, 1);
      else
        hw::wgmma_m64n128k16<0>(acc.dh, dd, dw, 1);
    }
    hw::wgmma_commit();
    hw::wgmma_wait<1>();                       // step t - 1 is done
  } else {
    hw::wgmma_wait<0>();
  }
  acc.fence();
  if (t > 0 && r.wtid == 0) hw::mbar_arrive(&r.empty[(t - 1) % S]);
}

// grouped_dgdu's block: rows row0 = 128·(row block) .. + 127 by f columns
// n0 = BNF·(column tile) .. + BNF - 1, in the raster of ep.band. Consumer
// warpgroup i owns rows 64·i .. + 63. Split (the two 64-row tiles belong
// to two experts) the block walks K twice, rows 0-63 against g0's
// weights, then rows 64-127 against g1's, and the group whose rows a pass
// does not hold only keeps pace with the ring: each group still owns all
// BNF columns of its rows, so a row's dw partial is summed within one
// warpgroup, in one order.
template <int BNF, bool kRC, bool kW>
__device__ __forceinline__ void grouped_dgdu_wgmma(const DgduMaps& maps,
                                                   const DgduEpilogue& ep) {
  using C = DgduCfg<BNF, kRC>;
  constexpr int S = C::kStages;
  int rb, ct;
  raster(ep.band, rb, ct);
  const int row0 = rb * BM;
  const long long live_rows = (long long)ep.live_tiles[0] * ep.bm;
  if (row0 >= live_rows) return;
  const int g0 = ep.group_of_tile[row0 / ep.bm];
  const int g1 = row0 + 64 < live_rows ? ep.group_of_tile[(row0 + 64) / ep.bm]
                                       : g0;
  const bool split = g1 != g0;
  const int n0 = ct * BNF;

  extern __shared__ uint8_t smem_raw[];
  const Ring ring = ring_at(smem_raw, S, C::STAGE, 0);
  uint8_t* smem = ring.smem;
  const int ksteps = (ep.d + BK - 1) / BK;
  const int total = split ? 2 * ksteps : ksteps;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (warp >= kConsumers / 32) {
    // producer: step t (pass, k-step) into stage t % S once both consumer
    // groups have released it: the pass's dz (and xs) boxes at their
    // half's slot, the pass's expert's wg, wi and wo boxes
    if constexpr (C::kShift) hw::setmaxnreg_dec<C::kProducerRegs>();
    if (warp == kConsumers / 32 && lane == 0) {
      for (int t = 0; t < total; ++t) {
        const int s = t % S, pass = t / ksteps, k0 = (t % ksteps) * BK;
        const int g = pass ? g1 : g0;
        uint64_t* full = &ring.full[s];
        if (t >= S) hw::mbar_wait(&ring.empty[s], (t / S - 1) & 1);
        uint8_t* st = smem + s * C::STAGE;
        hw::mbar_arrive_expect_tx(full,
                                  split ? C::STAGE - C::AHALF : C::STAGE);
        for (int half = 0; half < 2; ++half) {
          if (split && half != pass) continue;
          const int r = row0 + 64 * half;
          hw::tma_load_4d(st + half * kTile, &maps.dz, full, k0, r, 0, 0);
          if constexpr (kRC)
            hw::tma_load_4d(st + (2 + half) * kTile, &maps.xs, full, k0, r,
                            0, 0);
        }
        uint8_t* gu = st + C::ABYTES;
        if constexpr (kRC) {
#pragma unroll
          for (int q = 0; q < 2 * BNF / 64; ++q)
            hw::tma_load_4d(gu + q * kTile, (q & 1) ? &maps.wi : &maps.wg,
                            full, n0 + 64 * (q >> 1), k0, g, 0);
        }
        hw::tma_load_4d(gu + C::GUBYTES, &maps.wo, full, k0, n0, g, 0);
      }
    }
    return;
  }
  if constexpr (C::kShift) hw::setmaxnreg_inc<C::kConsumerRegs>();
  const int wgi = ring.wgi;
  DgduAcc<BNF, kRC> acc;
  acc.zero();
  // this group's steps: all of them, or (split) its own pass's
  const int a0 = split ? wgi * ksteps : 0, a1 = a0 + ksteps;
  for (int t = 0; t < a0; ++t) dgdu_step<BNF, kRC, false>(ring, acc, t);
  for (int t = a0; t < a1; ++t) dgdu_step<BNF, kRC, true>(ring, acc, t);
  for (int t = a1; t < total; ++t) dgdu_step<BNF, kRC, false>(ring, acc, t);
  hw::wgmma_wait<0>();
  acc.fence();

  // epilogue: the GLU backward in fp32 at the Pallas bodies' rounding
  // points, g and u rounded to bf16 first (recomputed) or read as saved;
  // the three bf16 tiles staged in the freed ring (both groups are past
  // their last wgmma, and every load has landed), then stored as whole
  // 16-byte pieces of their rows; rows at or past live_rows and columns
  // at or past f (a multiple of 8) are not written
  const int rowg = row0 + 64 * wgi;              // this group's rows
  const int lr0 = 16 * ((tid >> 5) & 3) + (lane >> 2);
  constexpr int LDS = C::LDS;
  __nv_bfloat16* tile =
      reinterpret_cast<__nv_bfloat16*>(smem) + wgi * 3 * 64 * LDS;
  hw::named_bar_sync(1, kConsumers);
  float part[2] = {0.f, 0.f};                    // Σ dh·h of rows lr0, +8
  float wsc[2] = {1.f, 1.f};
  if constexpr (kW) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long long r = rowg + lr0 + 8 * hh;
      if (r < live_rows) wsc[hh] = __bfloat162float(ep.w[r]);
    }
  }
#pragma unroll
  for (int c = 0; c < BNF / 64; ++c) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = 64 * c + 8 * i + 2 * (lane & 3);
      const bool in_f = n0 + col < ep.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int lr = lr0 + 8 * hh;
        const long long r = rowg + lr;
        float g[2], u[2];
        if constexpr (kRC) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            g[j] = __bfloat162float(
                __float2bfloat16(acc.gu[c][4 * i + 2 * hh + j]));
            u[j] = __bfloat162float(
                __float2bfloat16(acc.gu[c][4 * (i + 8) + 2 * hh + j]));
          }
        } else {
          float2 gv = make_float2(0.f, 0.f), uv = gv;
          if (r < live_rows && in_f) {
            const long long o = r * ep.f + n0 + col;
            gv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ep.gate + o));
            uv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(ep.up + o));
          }
          g[0] = gv.x, g[1] = gv.y, u[0] = uv.x, u[1] = uv.y;
        }
        float vdg[2], vdu[2], vh[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float dh = acc.dh[4 * (8 * c + i) + 2 * hh + j];
          const float sg = 1.0f / (1.0f + __expf(-g[j]));
          const float silu = g[j] * sg;
          const float dsilu = sg * (1.0f + g[j] * (1.0f - sg));
          const float h32 = silu * u[j];
          const float dhw = kW ? dh * wsc[hh] : dh;
          vdg[j] = dhw * u[j] * dsilu;
          vdu[j] = dhw * silu;
          vh[j] = h32;
          if (kW && in_f) part[hh] += dh * h32;
        }
        __nv_bfloat16* p = tile + lr * LDS + col;
        *reinterpret_cast<__nv_bfloat162*>(p) =
            __floats2bfloat162_rn(vdg[0], vdg[1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 64 * LDS) =
            __floats2bfloat162_rn(vdu[0], vdu[1]);
        *reinterpret_cast<__nv_bfloat162*>(p + 128 * LDS) =
            __floats2bfloat162_rn(vh[0], vh[1]);
      }
    }
  }
  if constexpr (kW) {
    // the row's partial over this tile: the four threads of a quad hold
    // its columns
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 1);
      part[hh] += __shfl_xor_sync(0xffffffffu, part[hh], 2);
      const long long r = rowg + lr0 + 8 * hh;
      if ((lane & 3) == 0 && r < live_rows)
        ep.dwp[(long long)ct * ep.rows + r] = part[hh];
    }
  }
  hw::named_bar_sync(2 + wgi, 128);
  constexpr int CH = BNF / 8;                    // 16-byte pieces a row
  for (int idx = ring.wtid; idx < 3 * 64 * CH; idx += 128) {
    const int o = idx / (64 * CH), lr = (idx / CH) % 64, q = idx % CH;
    const long long r = rowg + lr;
    const int col = n0 + 8 * q;
    if (r < live_rows && col < ep.f) {
      __nv_bfloat16* out = o == 0 ? ep.dg : o == 1 ? ep.du : ep.h;
      *reinterpret_cast<uint4*>(out + r * ep.f + col) =
          *reinterpret_cast<const uint4*>(tile + (o * 64 + lr) * LDS +
                                          8 * q);
    }
  }
}

// --- host ---------------------------------------------------------------------

// A 2-D bf16 view [rows, K] (row-major) as the 4-D map TMA takes: box
// [64 rows, 64 k], 128-byte swizzle. False when the encoder refuses it.
inline bool map_rows(CUtensorMap* m, const void* p, int rows, int K) {
  const cuuint64_t bytes = (cuuint64_t)rows * K * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)K, (cuuint64_t)rows, 1, 1};
  const cuuint64_t strides[3] = {(cuuint64_t)K * 2, bytes, bytes};
  const cuuint32_t box[4] = {BK, 64, 1, 1};
  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// E matrices [R, C] (row-major, [E, R, C] contiguous) as a 4-D map with the
// expert as its own dimension: box [box_r rows, box_c columns] of one
// expert, 128-byte swizzle (box_c · 2 = 128 bytes).
inline bool map_experts(CUtensorMap* m, const void* p, int E, int R, int C,
                        int box_r, int box_c) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)R, (cuuint64_t)E, 1};
  const cuuint64_t mat = (cuuint64_t)R * C * 2;
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, mat, mat * E};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_r, 1, 1};
  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A bf16 vector [n] (n a multiple of 8) as a 4-D map: boxes of 64 values,
// no swizzle.
inline bool map_vec(CUtensorMap* m, const void* p, int n) {
  const cuuint64_t bytes = (cuuint64_t)n * 2;
  const cuuint64_t dims[4] = {(cuuint64_t)n, 1, 1, 1};
  const cuuint64_t strides[3] = {bytes, bytes, bytes};
  const cuuint32_t box[4] = {BK, 1, 1, 1};
  return hw::make_map_4d(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// What TMA can address: K and N multiples of 8 (16-byte row strides) and
// 16-byte-aligned bases.
inline bool tma_ok(int K, int N, const void* const* ptrs, int n) {
  if (K <= 0 || N <= 0 || K % 8 || N % 8) return false;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
  return true;
}

// Launch `kernel` (a __global__ taking (Maps, Epilogue)) over ceil(N / BNO)
// column tiles by ceil(rows / 128) row blocks, in the raster of ep.band
// (raster): down and dxs take band 1, the column tiles fastest, so the
// blocks in flight are a few row blocks with all their column tiles, each
// A tile is read from device memory once (row blocks fastest re-read all
// of A once per column tile) and they span few experts, whose B tiles they
// share in L2; gate_up takes wider bands (see the header).
template <int AF, int BNO, typename Kernel>
int launch(Kernel kernel, const Maps& maps, const Epilogue& ep, int rows,
           unsigned& smem_done, cudaStream_t stream) {
  using C = Cfg<AF>;
  const dim3 grid((ep.N + BNO - 1) / BNO, (rows + BM - 1) / BM);
  if (grid.y == 0) return (int)cudaSuccess;
  if (grid.y > 65535 || ep.band <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = hw::allow_smem(
      reinterpret_cast<const void*>(kernel), C::SMEM, smem_done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, C::SMEM, stream>>>(maps, ep);
  return (int)cudaGetLastError();
}

// Launch a grouped_wgrad `kernel` (taking (Maps, WgradEpilogue)) over
// ceil(NB / 256) x ceil(MA / 128) tiles by `experts`, the expert slowest.
template <int AF, typename Kernel>
int launch_wgrad(Kernel kernel, const Maps& maps, const WgradEpilogue& ep,
                 int experts, unsigned& smem_done, cudaStream_t stream) {
  using C = Cfg<AF>;
  const dim3 grid((ep.NB + BN - 1) / BN, (ep.MA + BM - 1) / BM, experts);
  if (grid.y > 65535 || experts <= 0 || experts > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = hw::allow_smem(
      reinterpret_cast<const void*>(kernel), C::SMEM, smem_done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, C::SMEM, stream>>>(maps, ep);
  return (int)cudaGetLastError();
}

// Launch a grouped_dgdu `kernel` (taking (DgduMaps, DgduEpilogue)) over
// ceil(f / BNF) column tiles by ceil(rows / 128) row blocks, in the raster
// of ep.band.
template <int BNF, bool kRC, typename Kernel>
int launch_dgdu(Kernel kernel, const DgduMaps& maps, const DgduEpilogue& ep,
                unsigned& smem_done, cudaStream_t stream) {
  using C = DgduCfg<BNF, kRC>;
  const dim3 grid((ep.f + BNF - 1) / BNF, (ep.rows + BM - 1) / BM);
  if (grid.y == 0) return (int)cudaSuccess;
  if (grid.y > 65535 || ep.band <= 0) return (int)cudaErrorInvalidValue;
  const cudaError_t err = hw::allow_smem(
      reinterpret_cast<const void*>(kernel), C::SMEM, smem_done);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, C::kThreads, C::SMEM, stream>>>(maps, ep);
  return (int)cudaGetLastError();
}

}  // namespace grouped
}  // namespace dstt
