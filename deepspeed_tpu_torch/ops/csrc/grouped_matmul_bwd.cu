// Backward of the grouped SwiGLU FFN for Hopper (sm_90a) — the gradient
// kernels of the port's dropless MoE layer.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/grouped_matmul.py:
//   grouped_dgdu   ← _dgdu_rc_kernel (:411) and _dgdu_kernel (:366), one
//                    kernel templated on (a) gate/up recomputed in-kernel
//                    from xs·wg[g], xs·wi[g] and rounded to the dtype (the
//                    rc form, whose residuals hold no [R, f] tensor) or
//                    read from the saved forward, and (b) the per-row
//                    combine weight w present or absent. Per 64-row m-tile
//                    and f-tile: dh = dz·wo[g]ᵀ (contracted on wo's own
//                    [E, f, d] layout), dg = (dh·w)·u·dsilu(g), du =
//                    (dh·w)·silu(g), h = silu(g)·u rounded to the dtype
//                    (for dwo), and, with w, the per-row partial of the
//                    combine-weight gradient dwp[j][r] = Σ_{f in tile j}
//                    dh·h, summed over the f-tiles by the caller;
//   grouped_wgrad  ← _dw_pair_kernel (:502) and the dwo product of both
//                    dgdu kernels: dW[e] = Σ_{rows r of e} a[r]ᵀ·b[r],
//                    optionally with b's rows scaled by round(b·s[r]) (dwo
//                    = hᵀ·round(dz·w), :475). Each block owns one (expert,
//                    64-row tile of dW, column tile) and walks that
//                    expert's live m-tiles, found in group_of_tile and
//                    live_tiles on the device, keeping the sum in fp32
//                    registers: one write, no atomics, deterministic. dW is
//                    written in the weights' dtype, rounded once (:908-911);
//                    an expert with no live row gets zeros;
//   grouped_dxs    ← _dxs_kernel (:488): dxs = dg·wg[g]ᵀ + du·wi[g]ᵀ, one
//                    fp32 accumulator over both products, on the weights'
//                    native [E, d, f] layout.
//
// Layout as the forward (grouped_matmul.cu): rows sorted by expert, each
// expert's rows start on a bm-row boundary (bm a multiple of 64), so a
// 64-row tile belongs to one expert, g = group_of_tile[m0 / bm]; tiles at
// or past live_tiles[0] * bm hold no row and their blocks return without
// writing. The host never learns how many tiles are live.
//
// Tiles of the mma.sync and FMA forms: 64 rows x BN columns per block,
// k-steps of 32, 128 threads; each operand's k-tile is loaded into
// registers one step ahead (masked: zeros past the matrix, so any d and f
// work) and stored to shared memory in the global matrix's own orientation
// while the previous one is consumed; ldmatrix, transposed or not by that
// orientation (mma_step), feeds mma.sync m16n8k16 bf16 with fp32
// accumulation; fp32 runs plain FMA on the CUDA cores (the instantiation
// the parity checks hold to 1e-4). Offsets are 64-bit. All three kernels
// have three forms, picked by ops/grouped_matmul.py `plan` from the dtype
// and shape and passed in (the entry points refuse a form the dtype does
// not take; nothing falls back): fma (fp32), wgmma (bf16 where TMA can
// address every operand: its two widths multiples of 8, 16-byte-aligned
// data; grouped_wgmma.cuh, fed by a TMA ring — dgdu: 128 rows by 64 f
// columns a block, [gate | up] recomputed as one wgmma over wg's and wi's
// columns side by side and dh as a second, both walking d together, the
// GLU backward in the epilogue and the three bf16 tiles stored through the
// freed ring as whole rows; dxs: 128 x 256 tiles, both products into one
// accumulator; wgrad: 128 x 256 tiles of dW a block, the expert's rows as
// K, aᵀ as wgmma's transposed A; the scaled product run transposed with
// round(dz·w) formed in registers), mma (any other bf16).
//
// What bounds them on the H100: at the Mixtral 8x7B training shape (2048
// tokens, top-2, d 4096, f 14336) dgdu does 6·d·f FLOP per row (two
// recomputed products and dh), dxs 4·d·f and the three dW products 6·d·f,
// against ~2.8 GB of expert weights read once: 1.46 + 0.97 + 1.46 ms at
// the bf16 tensor-core peak, above the bytes (dW's bf16 writes 0.56 ms),
// so operations bound them. The mma.sync kernels use register-staged
// tiles without TMA, wgmma or a multi-stage ring, so instruction issue and
// shared-memory traffic are their real limit (dxs 163 TFLOP/s, dgdu ~105
// at the 1B/8e shape). The wgmma forms are held by the bytes each step
// moves through shared memory (grouped_wgmma.cuh): dxs's 48 KB a 4.2
// MFLOP step run at ~630 TFLOP/s there, dgdu's 56 KB a 3.1 MFLOP step at
// ~365 (PERF.md §6); wgrad's moves 48 KB a step too, and at Mixtral (~8
// steps a block) its ring fill and epilogue weigh as well.
#include "grouped_tile.cuh"
#include "grouped_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BM = 64;   // rows of every output tile
constexpr int BK = 32;   // reduction depth per step

template <typename T>
constexpr bool kMMA = std::is_same<T, __nv_bfloat16>::value;

// Output columns per block: bf16 64 (dgdu: three products), 128 (dxs,
// wgrad: one); fp32 FMA half of that, so the accumulators fit registers.
template <typename T> constexpr int BN_DGDU = kMMA<T> ? 64 : 32;
template <typename T> constexpr int BN_ONE = kMMA<T> ? 128 : 64;

// An R x C tile of a row-major matrix, staged through registers into
// shared memory in the matrix's own orientation (R rows of C values, each
// shared-memory row padded by 16 bytes). Rows at or past `rows` and
// columns at or past `cols` read as zero.
template <typename T, int R, int C>
struct Tile {
  static constexpr int V = 16 / sizeof(T);
  static constexpr int CH = R * C / V / kThreads;   // chunks per thread
  static constexpr int LD = C + V;
  static_assert(CH >= 1 && R * C == CH * V * kThreads, "tile vs threads");
  uint4 r[CH];

  // p: the tile's first row; ld: the row stride in elements; c0: its
  // first column
  __device__ __forceinline__ void load(const T* p, long long ld, int rows,
                                       int c0, int cols, int vec) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (C / V), cc = (c % (C / V)) * V;
      r[i] = row < rows ? load_chunk(p + row * ld, c0 + cc, cols, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(T* s) const {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (C / V), cc = (c % (C / V)) * V;
      *reinterpret_cast<uint4*>(s + row * LD + cc) = r[i];
    }
  }
  // each row times scale[row] in fp32, rounded to T
  __device__ __forceinline__ void store_scaled(T* s, const T* scale) const {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int row = c / (C / V), cc = (c % (C / V)) * V;
      float f[V];
      unpack<T>(r[i], f);
      const float w = to_f(scale[row]);
#pragma unroll
      for (int q = 0; q < V; ++q) f[q] *= w;
      *reinterpret_cast<uint4*>(s + row * LD + cc) = pack<T>(f);
    }
  }
};

// acc += A·B for one BK step on the tensor cores. A is the 64 x BK tile
// stored [m][k] (A_KM false) or [k][m] (true), B the BK x BN tile stored
// [k][n] (B_NK false) or [n][k] (true); lda/ldb are the shared rows'
// lengths. The four warps split the tile 2 x 2, 32 rows x BN/2 columns
// each; acc holds that quarter as [m16 tile][n8 tile][4]. ldmatrix gives
// the fragments mma.sync wants from either orientation: A's m16k16
// fragment is four 8x8 matrices (m 0-7 / 8-15 by k 0-7 / 8-15), read
// plainly from [m][k] rows or transposed from [k][m] rows; B's k16n8
// fragment pairs are read transposed from [k][n] rows or plainly from
// [n][k] rows.
template <bool A_KM, bool B_NK, int BN>
__device__ __forceinline__ void mma_step(float* acc,
                                         const __nv_bfloat16* As, int lda,
                                         const __nv_bfloat16* Bs, int ldb) {
  constexpr int NT = BN / 16, WN = BN / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int j = lane & 7, mat = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int mb = wm * 32 + mi * 16;
      if constexpr (A_KM)
        ldmatrix_x4_trans(a[mi], As + (kk + (mat >> 1) * 8 + j) * lda + mb +
                                     (mat & 1) * 8);
      else
        ldmatrix_x4(a[mi], As + (mb + (lane & 15)) * lda + kk +
                               (lane >> 4) * 8);
    }
    uint32_t b[NT][2];
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      const int nb = wn * WN + p * 16;
      uint32_t r[4];
      if constexpr (B_NK)
        ldmatrix_x4(r, Bs + (nb + (mat >> 1) * 8 + j) * ldb + kk +
                           (mat & 1) * 8);
      else
        ldmatrix_x4_trans(r, Bs + (kk + (lane & 15)) * ldb + nb +
                                 (lane >> 4) * 8);
      b[2 * p][0] = r[0];
      b[2 * p][1] = r[1];
      b[2 * p + 1][0] = r[2];
      b[2 * p + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
        mma_bf16(acc + (mi * NT + ni) * 4, a[mi], b[ni]);
  }
}

// The same step in fp32 FMA: each thread owns rows ty + 16 i (i < 4) and
// columns tx * 4 + 32 c + q (c < BN / 32, q < 4) as acc[i][4 c + q].
template <bool A_KM, bool B_NK, int BN>
__device__ __forceinline__ void fma_step(float* acc, const float* As,
                                         int lda, const float* Bs, int ldb) {
  constexpr int NJ = BN / 32;
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[4], b[4 * NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = A_KM ? As[k * lda + ty + 16 * i] : As[(ty + 16 * i) * lda + k];
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      const int n = tx * 4 + 32 * c;
      if constexpr (B_NK) {
#pragma unroll
        for (int q = 0; q < 4; ++q) b[4 * c + q] = Bs[(n + q) * ldb + k];
      } else {
        const float4 v = *reinterpret_cast<const float4*>(Bs + k * ldb + n);
        b[4 * c] = v.x; b[4 * c + 1] = v.y;
        b[4 * c + 2] = v.z; b[4 * c + 3] = v.w;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4 * NJ; ++q) acc[i * 4 * NJ + q] += a[i] * b[q];
  }
}

template <typename T, bool A_KM, bool B_NK, int BN>
__device__ __forceinline__ void step(float* acc, const T* As, int lda,
                                     const T* Bs, int ldb) {
  if constexpr (kMMA<T>)
    mma_step<A_KM, B_NK, BN>(acc, As, lda, Bs, ldb);
  else
    fma_step<A_KM, B_NK, BN>(acc, As, lda, Bs, ldb);
}

// Where accumulator element e (of BN / 2 per thread) sits in the 64 x BN
// tile, and which of the thread's four rows it is on (its row slot).
template <typename T, int BN>
__device__ __forceinline__ void acc_pos(int e, int& row, int& col,
                                        int& slot) {
  if constexpr (kMMA<T>) {
    constexpr int NT = BN / 16, WN = BN / 2;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int mi = e / (NT * 4), ni = (e / 4) % NT, z = e % 4;
    row = (warp / 2) * 32 + mi * 16 + (lane >> 2) + 8 * (z >> 1);
    col = (warp % 2) * WN + ni * 8 + (lane & 3) * 2 + (z & 1);
    slot = mi * 2 + (z >> 1);
  } else {
    constexpr int NJ = BN / 32;
    const int i = e / (4 * NJ), q = e % (4 * NJ);
    row = threadIdx.x / 8 + 16 * i;
    col = (threadIdx.x % 8) * 4 + (q / 4) * 32 + q % 4;
    slot = i;
  }
}

// ---------------------------------------------------------------------------
// grouped_dgdu
// ---------------------------------------------------------------------------

template <typename T>
struct DgduArgs {
  const T* dz;                 // [rows, d]
  const T* xs;                 // [rows, d] (rc form)
  const T* wg;                 // [E, d, f] (rc form)
  const T* wi;                 // [E, d, f] (rc form)
  const T* wo;                 // [E, f, d]
  const T* gate;               // [rows, f] (saved form)
  const T* up;                 // [rows, f] (saved form)
  const T* w;                  // [rows] (w form)
  T* dg;                       // [rows, f]
  T* du;                       // [rows, f]
  T* h;                        // [rows, f]
  float* dwp;                  // [n_f_tiles, rows] (w form)
  const int* group_of_tile;
  const int* live_tiles;
  int rows, d, f, bm;
  int vec_d, vec_f;            // 16-byte loads along d / along f allowed
};

template <typename T, bool kRC, bool kW>
__global__ void __launch_bounds__(kThreads)
grouped_dgdu_kernel(const DgduArgs<T> a) {
  constexpr int BN = BN_DGDU<T>;
  constexpr int NA = BN / 2;                 // accumulators per thread
  using TA = Tile<T, BM, BK>;                // dz, xs: [m][k]
  using TB = Tile<T, BK, BN>;                // wg, wi: [k][n]
  using TO = Tile<T, BN, BK>;                // wo: [n][k]
  __shared__ __align__(16) T s_dz[BM * TA::LD];
  __shared__ __align__(16) T s_xs[kRC ? BM * TA::LD : 8];
  __shared__ __align__(16) T s_wg[kRC ? BK * TB::LD : 8];
  __shared__ __align__(16) T s_wi[kRC ? BK * TB::LD : 8];
  __shared__ __align__(16) T s_wo[BN * TO::LD];
  __shared__ float s_red[2][BM];

  const int m0 = blockIdx.x * BM;
  if ((long long)m0 >= (long long)a.live_tiles[0] * a.bm) return;
  const long long g = a.group_of_tile[m0 / a.bm];
  const int n0 = blockIdx.y * BN;
  const int d = a.d, f = a.f;
  const T* dz = a.dz + (long long)m0 * d;
  const T* xs = kRC ? a.xs + (long long)m0 * d : nullptr;
  const T* wg = kRC ? a.wg + g * d * f : nullptr;
  const T* wi = kRC ? a.wi + g * d * f : nullptr;
  const T* wo = a.wo + (g * f + n0) * d;     // rows n0.. of wo[g]

  TA t_dz, t_xs;
  TB t_wg, t_wi;
  TO t_wo;
  auto load = [&](int k0) {
    t_dz.load(dz, d, BM, k0, d, a.vec_d);
    t_wo.load(wo, d, f - n0, k0, d, a.vec_d);
    if constexpr (kRC) {
      t_xs.load(xs, d, BM, k0, d, a.vec_d);
      t_wg.load(wg + (long long)k0 * f, f, d - k0, n0, f, a.vec_f);
      t_wi.load(wi + (long long)k0 * f, f, d - k0, n0, f, a.vec_f);
    }
  };

  float acc_h[NA], acc_g[kRC ? NA : 1], acc_u[kRC ? NA : 1];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc_h[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (kRC ? NA : 1); ++e) acc_g[e] = acc_u[e] = 0.f;

  const int nk = (d + BK - 1) / BK;
  load(0);
  for (int t = 0; t < nk; ++t) {
    t_dz.store(s_dz);
    t_wo.store(s_wo);
    if constexpr (kRC) {
      t_xs.store(s_xs);
      t_wg.store(s_wg);
      t_wi.store(s_wi);
    }
    __syncthreads();
    if (t + 1 < nk) load((t + 1) * BK);
    step<T, false, true, BN>(acc_h, s_dz, TA::LD, s_wo, TO::LD);
    if constexpr (kRC) {
      step<T, false, false, BN>(acc_g, s_xs, TA::LD, s_wg, TB::LD);
      step<T, false, false, BN>(acc_u, s_xs, TA::LD, s_wi, TB::LD);
    }
    __syncthreads();
  }

  // epilogue, per element in fp32 as the Pallas bodies: gate/up rounded
  // to the dtype (recomputed) or read as saved; columns past f dropped
  float part[4] = {0.f, 0.f, 0.f, 0.f};      // Σ dh·h over this thread's
                                             // columns, per row slot
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    int row, col, slot;
    acc_pos<T, BN>(e, row, col, slot);
    const long long r = m0 + row;
    const int c = n0 + col;
    if (c < f) {
      const long long o = r * f + c;
      float g32, u32;
      if constexpr (kRC) {
        g32 = to_f(from_f<T>(acc_g[e]));
        u32 = to_f(from_f<T>(acc_u[e]));
      } else {
        g32 = to_f(a.gate[o]);
        u32 = to_f(a.up[o]);
      }
      const float dh = acc_h[e];
      const float sg = 1.0f / (1.0f + expf(-g32));
      const float silu = g32 * sg;
      const float dsilu = sg * (1.0f + g32 * (1.0f - sg));
      const float h32 = silu * u32;
      const float dhw = kW ? dh * to_f(a.w[r]) : dh;
      a.dg[o] = from_f<T>(dhw * u32 * dsilu);
      a.du[o] = from_f<T>(dhw * silu);
      a.h[o] = from_f<T>(h32);
      if constexpr (kW) part[slot] += dh * h32;
    }
  }
  if constexpr (kW) {
    // the row sums of this f-tile: over the threads that share a row,
    // then (tensor-core layout) over the two warps that split its columns
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if constexpr (kMMA<T>) {
        part[s] += __shfl_xor_sync(0xffffffffu, part[s], 1);
        part[s] += __shfl_xor_sync(0xffffffffu, part[s], 2);
      } else {
        part[s] += __shfl_xor_sync(0xffffffffu, part[s], 1);
        part[s] += __shfl_xor_sync(0xffffffffu, part[s], 2);
        part[s] += __shfl_xor_sync(0xffffffffu, part[s], 4);
      }
    }
    float* dwp = a.dwp + (long long)blockIdx.y * a.rows + m0;
    if constexpr (kMMA<T>) {
      const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
      if ((lane & 3) == 0)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          s_red[warp % 2][(warp / 2) * 32 + (s >> 1) * 16 + (lane >> 2) +
                          8 * (s & 1)] = part[s];
      __syncthreads();
      if (threadIdx.x < BM)
        dwp[threadIdx.x] = s_red[0][threadIdx.x] + s_red[1][threadIdx.x];
    } else {
      if (threadIdx.x % 8 == 0)
#pragma unroll
        for (int s = 0; s < 4; ++s) dwp[threadIdx.x / 8 + 16 * s] = part[s];
    }
  }
}

// ---------------------------------------------------------------------------
// grouped_dxs
// ---------------------------------------------------------------------------

template <typename T>
struct DxsArgs {
  const T* dg;                 // [rows, f]
  const T* du;                 // [rows, f]
  const T* wg;                 // [E, d, f]
  const T* wi;                 // [E, d, f]
  T* dxs;                      // [rows, d]
  const int* group_of_tile;
  const int* live_tiles;
  int d, f, bm;
  int vec_f;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
grouped_dxs_kernel(const DxsArgs<T> a) {
  constexpr int BN = BN_ONE<T>;
  constexpr int NA = BN / 2;
  using TA = Tile<T, BM, BK>;                // dg, du: [m][k]
  using TB = Tile<T, BN, BK>;                // wg[g], wi[g] rows: [n][k]
  __shared__ __align__(16) T s_a[BM * TA::LD];
  __shared__ __align__(16) T s_b[BN * TB::LD];

  const int m0 = blockIdx.x * BM;
  if ((long long)m0 >= (long long)a.live_tiles[0] * a.bm) return;
  const long long g = a.group_of_tile[m0 / a.bm];
  const int n0 = blockIdx.y * BN;
  const int d = a.d, f = a.f;
  const long long wofs = (g * d + n0) * f;   // row n0 of wg[g] / wi[g]

  TA ta;
  TB tb;
  // steps [0, nk) contract dg with wg, [nk, 2 nk) du with wi
  const int nk = (f + BK - 1) / BK;
  auto load = [&](int t) {
    const bool first = t < nk;
    const int k0 = (first ? t : t - nk) * BK;
    ta.load((first ? a.dg : a.du) + (long long)m0 * f, f, BM, k0, f,
            a.vec_f);
    tb.load((first ? a.wg : a.wi) + wofs, f, d - n0, k0, f, a.vec_f);
  };

  float acc[NA];
#pragma unroll
  for (int e = 0; e < NA; ++e) acc[e] = 0.f;
  load(0);
  for (int t = 0; t < 2 * nk; ++t) {
    ta.store(s_a);
    tb.store(s_b);
    __syncthreads();
    if (t + 1 < 2 * nk) load(t + 1);
    step<T, false, true, BN>(acc, s_a, TA::LD, s_b, TB::LD);
    __syncthreads();
  }
#pragma unroll
  for (int e = 0; e < NA; ++e) {
    int row, col, slot;
    acc_pos<T, BN>(e, row, col, slot);
    if (n0 + col < d)
      a.dxs[(long long)(m0 + row) * d + n0 + col] = from_f<T>(acc[e]);
  }
}

// ---------------------------------------------------------------------------
// grouped_wgrad
// ---------------------------------------------------------------------------

template <typename T>
struct WgradArgs {
  const T* a;                  // [rows, M]
  const T* b;                  // [rows, N]
  const T* scale;              // [rows] or null
  T* out;                      // [E, M, N]
  const int* group_of_tile;
  const int* live_tiles;
  int n_tiles, M, N, bm;
  int vec_m, vec_n;
};

template <typename T, bool kScale>
__global__ void __launch_bounds__(kThreads)
grouped_wgrad_kernel(const WgradArgs<T> a) {
  constexpr int BN = BN_ONE<T>;
  constexpr int NA = BN / 2;
  using TA = Tile<T, BK, BM>;                // a rows: [k][m]
  using TB = Tile<T, BK, BN>;                // b rows: [k][n]
  __shared__ __align__(16) T s_a[BK * TA::LD];
  __shared__ __align__(16) T s_b[BK * TB::LD];

  const int e = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = a.M, N = a.N;
  // this expert's live rows: its tiles of group_of_tile, below live_tiles
  const int live = min(a.live_tiles[0], a.n_tiles);
  const int t0 = min(lower_bound(a.group_of_tile, a.n_tiles, e), live);
  const int t1 = min(lower_bound(a.group_of_tile, a.n_tiles, e + 1), live);
  const long long r0 = (long long)t0 * a.bm, r1 = (long long)t1 * a.bm;

  TA ta;
  TB tb;
  auto load = [&](long long k0) {
    ta.load(a.a + k0 * M, M, BK, m0, M, a.vec_m);
    tb.load(a.b + k0 * N, N, BK, n0, N, a.vec_n);
  };

  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  if (r0 < r1) load(r0);
  for (long long k0 = r0; k0 < r1; k0 += BK) {
    ta.store(s_a);
    if constexpr (kScale) tb.store_scaled(s_b, a.scale + k0);
    else tb.store(s_b);
    __syncthreads();
    if (k0 + BK < r1) load(k0 + BK);
    step<T, true, false, BN>(acc, s_a, TA::LD, s_b, TB::LD);
    __syncthreads();
  }
  T* out = a.out + (long long)e * M * N;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    int row, col, slot;
    acc_pos<T, BN>(i, row, col, slot);
    if (m0 + row < M && n0 + col < N)
      out[(long long)(m0 + row) * N + n0 + col] = from_f<T>(acc[i]);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr int kInvalid = (int)cudaErrorInvalidValue;

bool tiles_ok(int rows, int bm) {
  return rows >= 0 && bm > 0 && bm % BM == 0 && rows % bm == 0;
}

template <typename T>
int dgdu(DgduArgs<T> a, int n_f_tiles, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T), BN = BN_DGDU<T>;
  const bool rc = a.xs != nullptr, w = a.w != nullptr;
  if (!tiles_ok(a.rows, a.bm) || a.d <= 0 || a.f <= 0 ||
      n_f_tiles != (a.f + BN - 1) / BN || n_f_tiles > 65535 ||
      (rc ? (a.wg == nullptr || a.wi == nullptr)
          : (a.gate == nullptr || a.up == nullptr)) ||
      (w && a.dwp == nullptr))
    return kInvalid;
  a.vec_d = a.d % V == 0 && aligned16(a.dz) && aligned16(a.xs) &&
            aligned16(a.wo);
  a.vec_f = a.f % V == 0 && aligned16(a.wg) && aligned16(a.wi);
  const dim3 grid(a.rows / BM, n_f_tiles);
  if (grid.x == 0) return (int)cudaSuccess;
  if (rc && w) grouped_dgdu_kernel<T, true, true><<<grid, kThreads, 0, st>>>(a);
  else if (rc) grouped_dgdu_kernel<T, true, false><<<grid, kThreads, 0, st>>>(a);
  else if (w) grouped_dgdu_kernel<T, false, true><<<grid, kThreads, 0, st>>>(a);
  else grouped_dgdu_kernel<T, false, false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dxs(DxsArgs<T> a, int rows, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T), BN = BN_ONE<T>;
  if (!tiles_ok(rows, a.bm) || a.d <= 0 || a.f <= 0) return kInvalid;
  a.vec_f = a.f % V == 0 && aligned16(a.dg) && aligned16(a.du) &&
            aligned16(a.wg) && aligned16(a.wi);
  const dim3 grid(rows / BM, (a.d + BN - 1) / BN);
  if (grid.x == 0) return (int)cudaSuccess;
  if (grid.y > 65535) return kInvalid;
  grouped_dxs_kernel<T><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int wgrad(WgradArgs<T> a, int rows, int num_experts, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T), BN = BN_ONE<T>;
  if (!tiles_ok(rows, a.bm) || a.M <= 0 || a.N <= 0 ||
      num_experts <= 0 || num_experts > 65535)
    return kInvalid;
  a.n_tiles = rows / a.bm;
  a.vec_m = a.M % V == 0 && aligned16(a.a);
  a.vec_n = a.N % V == 0 && aligned16(a.b);
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, num_experts);
  if (grid.y > 65535) return kInvalid;
  if (a.scale != nullptr)
    grouped_wgrad_kernel<T, true><<<grid, kThreads, 0, st>>>(a);
  else
    grouped_wgrad_kernel<T, false><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// the kernel forms of dstt_grouped_dxs and dstt_grouped_wgrad
// (ops/grouped_matmul.py FORMS)
constexpr int kFma = 0, kMma = 1, kWgmma = 2;

__global__ void __launch_bounds__(dstt::grouped::kThreads, 1)
    grouped_dxs_wgmma_kernel(const __grid_constant__ dstt::grouped::Maps maps,
        const dstt::grouped::Epilogue ep) {
  dstt::grouped::grouped_wgmma<dstt::grouped::kAK, 0, 2>(maps, ep);
}

__global__ void __launch_bounds__(dstt::grouped::kThreads, 1)
    grouped_wgrad_wgmma_kernel(
        const __grid_constant__ dstt::grouped::Maps maps,
        const dstt::grouped::WgradEpilogue ep) {
  dstt::grouped::grouped_wgrad_wgmma<false>(maps, ep);
}

__global__ void __launch_bounds__(dstt::grouped::kThreads, 1)
    grouped_wgrad_scaled_wgmma_kernel(
        const __grid_constant__ dstt::grouped::Maps maps,
        const dstt::grouped::WgradEpilogue ep) {
  dstt::grouped::grouped_wgrad_wgmma<true>(maps, ep);
}

// out [E, m, n] from a [rows, m], b [rows, n] (and scale [rows]); with
// scale the kernel computes outᵀ = round(b·scale)ᵀ·a, A formed from b
int wgrad_wgmma(const void* a, const void* b, const void* scale, void* out,
                const int* gt, const int* lt, int rows, int m, int n,
                int num_experts, int bm, cudaStream_t st) {
  namespace G = dstt::grouped;
  const bool sc = scale != nullptr;
  const void* tma[3] = {a, b, scale};
  if (!tiles_ok(rows, bm) || num_experts <= 0 ||
      !G::tma_ok(m, n, tma, sc ? 3 : 2))
    return kInvalid;
  // no row at all: every expert's dW is zero (TMA maps need rows > 0)
  if (rows == 0)
    return (int)cudaMemsetAsync(out, 0, (size_t)num_experts * m * n * 2, st);
  G::Maps maps;
  const void* pa = sc ? b : a;
  const void* pb = sc ? a : b;
  const int ma = sc ? n : m, nb = sc ? m : n;
  // A's and B's sources [rows, ma], [rows, nb]: boxes [64 rows, 64 columns]
  // (each MN-major: one row a k); w [rows]: boxes of 64
  if (!G::map_rows(&maps.a[0], pa, rows, ma) ||
      !G::map_rows(&maps.b[0], pb, rows, nb) ||
      (sc && !G::map_vec(&maps.a[1], scale, rows)))
    return kInvalid;
  if (!sc) maps.a[1] = maps.a[0];
  maps.b[1] = maps.b[0];
  const G::WgradEpilogue ep{static_cast<__nv_bfloat16*>(out), gt, lt,
                            rows / bm, ma, nb, bm};
  if (sc) {
    static unsigned smem_done = 0;
    return G::launch_wgrad<G::kAScaled>(grouped_wgrad_scaled_wgmma_kernel,
                                        maps, ep, num_experts, smem_done, st);
  }
  static unsigned smem_done = 0;
  return G::launch_wgrad<G::kAMN>(grouped_wgrad_wgmma_kernel, maps, ep,
                                  num_experts, smem_done, st);
}

int dxs_wgmma(const void* dg, const void* du, const void* wg, const void* wi,
              void* dxs_, const int* gt, const int* lt, int rows, int d,
              int f, int bm, int num_experts, cudaStream_t st) {
  namespace G = dstt::grouped;
  const void* tma[4] = {dg, du, wg, wi};
  if (rows == 0) return (int)cudaSuccess;
  if (!tiles_ok(rows, bm) || num_experts <= 0 || !G::tma_ok(f, d, tma, 4))
    return kInvalid;
  G::Maps maps;
  // dg, du [rows, f]: boxes [64 rows, 64 k]; wg, wi [E, d, f]: boxes
  // [256 n, 64 k] of one expert (the K-major B)
  if (!G::map_rows(&maps.a[0], dg, rows, f) ||
      !G::map_rows(&maps.a[1], du, rows, f) ||
      !G::map_experts(&maps.b[0], wg, num_experts, d, f, G::BN, G::BK) ||
      !G::map_experts(&maps.b[1], wi, num_experts, d, f, G::BN, G::BK))
    return kInvalid;
  const G::Epilogue ep{static_cast<__nv_bfloat16*>(dxs_), nullptr, nullptr,
                       gt, lt, d, f, bm, 1};
  static unsigned smem_done = 0;
  return G::launch<G::kAK, G::BN>(grouped_dxs_wgmma_kernel, maps, ep, rows,
                                  smem_done, st);
}

template <bool kRC, bool kW>
__global__ void __launch_bounds__(
    (dstt::grouped::DgduCfg<dstt::grouped::kDgduBN, kRC>::kThreads), 1)
    grouped_dgdu_wgmma_kernel(
        const __grid_constant__ dstt::grouped::DgduMaps maps,
        const dstt::grouped::DgduEpilogue ep) {
  dstt::grouped::grouped_dgdu_wgmma<dstt::grouped::kDgduBN, kRC, kW>(maps,
                                                                     ep);
}

// dg, du, h [rows, f] (and dwp [n_f_tiles, rows]) on the template: dz, xs
// [rows, d] and wo [E, f, d] (with wg, wi [E, d, f]: recomputed) through
// TMA; the saved gate, up read in the epilogue
int dgdu_wgmma(const void* dz, const void* xs, const void* wg,
               const void* wi, const void* wo, const void* gate,
               const void* up, const void* w, void* dg, void* du, void* h,
               void* dwp, const int* gt, const int* lt, int rows, int d,
               int f, int bm, int n_f_tiles, int num_experts, int band,
               cudaStream_t st) {
  namespace G = dstt::grouped;
  constexpr int BNF = G::kDgduBN;
  const bool rc = xs != nullptr, sc = w != nullptr;
  const void* tma[5] = {dz, wo, rc ? xs : gate, rc ? wg : up,
                        rc ? wi : dz};
  if (!tiles_ok(rows, bm) || num_experts <= 0 || band <= 0 ||
      n_f_tiles != (f + BNF - 1) / BNF ||
      (rc ? (wg == nullptr || wi == nullptr)
          : (gate == nullptr || up == nullptr)) ||
      (sc && dwp == nullptr) || !G::tma_ok(d, f, tma, 5))
    return kInvalid;
  if (rows == 0) return (int)cudaSuccess;
  G::DgduMaps maps{};
  if (!G::map_rows(&maps.dz, dz, rows, d) ||
      !G::map_experts(&maps.wo, wo, num_experts, f, d, BNF, G::BK) ||
      (rc && (!G::map_rows(&maps.xs, xs, rows, d) ||
              !G::map_experts(&maps.wg, wg, num_experts, d, f, G::BK, 64) ||
              !G::map_experts(&maps.wi, wi, num_experts, d, f, G::BK, 64))))
    return kInvalid;
  using B = __nv_bfloat16;
  const G::DgduEpilogue ep{static_cast<B*>(dg), static_cast<B*>(du),
                           static_cast<B*>(h), static_cast<const B*>(gate),
                           static_cast<const B*>(up),
                           static_cast<const B*>(w),
                           static_cast<float*>(dwp), gt, lt, rows, d, f,
                           bm, band};
  if (rc && sc) {
    static unsigned smem_done = 0;
    return G::launch_dgdu<BNF, true>(grouped_dgdu_wgmma_kernel<true, true>,
                                     maps, ep, smem_done, st);
  }
  if (rc) {
    static unsigned smem_done = 0;
    return G::launch_dgdu<BNF, true>(grouped_dgdu_wgmma_kernel<true, false>,
                                     maps, ep, smem_done, st);
  }
  if (sc) {
    static unsigned smem_done = 0;
    return G::launch_dgdu<BNF, false>(grouped_dgdu_wgmma_kernel<false, true>,
                                      maps, ep, smem_done, st);
  }
  static unsigned smem_done = 0;
  return G::launch_dgdu<BNF, false>(grouped_dgdu_wgmma_kernel<false, false>,
                                    maps, ep, smem_done, st);
}

template <typename T>
const T* in(const void* p) { return static_cast<const T*>(p); }
template <typename T>
T* out(void* p) { return static_cast<T*>(p); }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for an unsupported dtype or shape).
//
// dg, du, h [rows, f] (and, with w, dwp [n_f_tiles, rows] fp32) from dz
// [rows, d], wo [E, f, d] and either xs [rows, d] with wg, wi [E, d, f]
// (recomputed gate/up: xs non-null) or the saved gate, up [rows, f].
// form: 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma (d and f
// multiples of 8, 16-byte-aligned dz, xs, wg, wi, wo, gate and up; `band`
// row blocks a band of its raster); any other pairing of dtype and form
// is refused. n_f_tiles must be the form's column tiles: ceil(f / 32)
// (FMA), ceil(f / 64) (mma.sync), ceil(f / kDgduBN) (wgmma).
extern "C" int dstt_grouped_dgdu(const void* dz, const void* xs,
                                 const void* wg, const void* wi,
                                 const void* wo, const void* gate,
                                 const void* up, const void* w, void* dg,
                                 void* du, void* h, void* dwp,
                                 const void* group_of_tile,
                                 const void* live_tiles, int rows, int d,
                                 int f, int bm, int n_f_tiles,
                                 int num_experts, int dtype, int form,
                                 int band, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gt = static_cast<const int*>(group_of_tile);
  const int* lt = static_cast<const int*>(live_tiles);
  if (dtype == 0 && form == kFma) {
    using T = float;
    DgduArgs<T> a{in<T>(dz), in<T>(xs), in<T>(wg), in<T>(wi), in<T>(wo),
                  in<T>(gate), in<T>(up), in<T>(w), out<T>(dg), out<T>(du),
                  out<T>(h), static_cast<float*>(dwp), gt, lt, rows, d, f,
                  bm, 0, 0};
    return dgdu<T>(a, n_f_tiles, st);
  }
  if (dtype == 1 && form == kMma) {
    using T = __nv_bfloat16;
    DgduArgs<T> a{in<T>(dz), in<T>(xs), in<T>(wg), in<T>(wi), in<T>(wo),
                  in<T>(gate), in<T>(up), in<T>(w), out<T>(dg), out<T>(du),
                  out<T>(h), static_cast<float*>(dwp), gt, lt, rows, d, f,
                  bm, 0, 0};
    return dgdu<T>(a, n_f_tiles, st);
  }
  if (dtype == 1 && form == kWgmma)
    return dgdu_wgmma(dz, xs, wg, wi, wo, gate, up, w, dg, du, h, dwp, gt,
                      lt, rows, d, f, bm, n_f_tiles, num_experts, band, st);
  return kInvalid;
}

// dxs [rows, d] = dg · wg[g]ᵀ + du · wi[g]ᵀ; dg, du [rows, f], wg, wi
// [E, d, f]. form: 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma (f and
// d multiples of 8, 16-byte-aligned dg, du, wg and wi); any other pairing
// of dtype and form is refused.
extern "C" int dstt_grouped_dxs(const void* dg, const void* du,
                                const void* wg, const void* wi, void* dxs_,
                                const void* group_of_tile,
                                const void* live_tiles, int rows, int d,
                                int f, int bm, int num_experts, int dtype,
                                int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gt = static_cast<const int*>(group_of_tile);
  const int* lt = static_cast<const int*>(live_tiles);
  if (dtype == 0 && form == kFma) {
    using T = float;
    DxsArgs<T> a{in<T>(dg), in<T>(du), in<T>(wg), in<T>(wi), out<T>(dxs_),
                 gt, lt, d, f, bm, 0};
    return dxs<T>(a, rows, st);
  }
  if (dtype == 1 && form == kMma) {
    using T = __nv_bfloat16;
    DxsArgs<T> a{in<T>(dg), in<T>(du), in<T>(wg), in<T>(wi), out<T>(dxs_),
                 gt, lt, d, f, bm, 0};
    return dxs<T>(a, rows, st);
  }
  if (dtype == 1 && form == kWgmma)
    return dxs_wgmma(dg, du, wg, wi, dxs_, gt, lt, rows, d, f, bm,
                     num_experts, st);
  return kInvalid;
}

// out [E, m, n] = per expert e, Σ over e's live rows r of a[r]ᵀ · b'[r],
// a [rows, m], b [rows, n], b' = round(b · scale[r]) when scale is given.
// form: 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma (m and n multiples
// of 8, 16-byte-aligned a, b and scale); any other pairing of dtype and
// form is refused.
extern "C" int dstt_grouped_wgrad(const void* a_, const void* b,
                                  const void* scale, void* out_,
                                  const void* group_of_tile,
                                  const void* live_tiles, int rows, int m,
                                  int n, int num_experts, int bm, int dtype,
                                  int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gt = static_cast<const int*>(group_of_tile);
  const int* lt = static_cast<const int*>(live_tiles);
  if (dtype == 0 && form == kFma) {
    using T = float;
    WgradArgs<T> a{in<T>(a_), in<T>(b), in<T>(scale), out<T>(out_), gt, lt,
                   0, m, n, bm, 0, 0};
    return wgrad<T>(a, rows, num_experts, st);
  }
  if (dtype == 1 && form == kMma) {
    using T = __nv_bfloat16;
    WgradArgs<T> a{in<T>(a_), in<T>(b), in<T>(scale), out<T>(out_), gt, lt,
                   0, m, n, bm, 0, 0};
    return wgrad<T>(a, rows, num_experts, st);
  }
  if (dtype == 1 && form == kWgmma)
    return wgrad_wgmma(a_, b, scale, out_, gt, lt, rows, m, n, num_experts,
                       bm, st);
  return kInvalid;
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
