// Flash-attention backward for Hopper (sm_90a) — kernel K3 of the port.
//
// Replaces the TPU kernels _bwd_dq_kernel (deepspeed_tpu/ops/flash_attention.py:330),
// _bwd_dkv_kernel (:378) and their KV-blocked twins _bwd_dq_kernel_xl (:504)
// and _bwd_dkv_kernel_xl (:549): the flash-attention-2 backward, which
// recomputes p = exp(s * scale - lse) from q, k and the forward's lse and
// never stores the [T, T] probabilities. The TPU pair exists only for VMEM
// limits; here one pair of kernels streams tiles through shared memory at
// any length, as K1 does for the forward.
//
//   delta = rowsum(dO * O)  (fp32; a pre-pass kernel, FA2's "preprocess")
//   ds    = p * (dO V^T - delta) * scale
//   dq    = ds K          (dq kernel: a block owns 64 query rows of one head
//                          and walks the key tiles it can see)
//   dk    = ds^T Q, dv = p^T dO
//                         (dk/dv kernel: a block owns the keys of one kv head
//                          and walks the query tiles of EVERY q head of its
//                          GQA group, so the group sum happens in registers
//                          and no per-q-head fp32 dk/dv is ever written)
// Two kernels and no atomics: each output element is written once, by one
// block, so a backward is bit-for-bit repeatable.
//
// Layout: q/out/dO/dq [B, Tq, H, D], k/v/dk/dv [B, Tk, KvH, D] (the JAX
// package's public layout, read in place), lse/delta [B, Tq, H] fp32.
// Masking is the forward's: key kp is visible to query qp = t + q_offset iff
// kp < Tk, kp <= qp (causal) and kp > qp - window (window > 0). A masked
// pair and every pair of a row with no visible key (lse = -1e30) gets
// p = 0, hence ds = 0: such rows give zero gradients. Ragged Tq/Tk are
// masked in the kernels (no tile multiple needed).
//
// What bounds it on the H100: at the training path's shape (B 4, T 2048,
// 16 q / 8 kv heads, D 128, causal) the backward does 5 products of
// [T, T/2] x D per head — 7 with the dq kernel's recomputed S and dP —
// 172 GFLOP (5 products) against ~200 MB of q/k/v/O/dO/lse and dq/dk/dv in
// bf16: far above the tensor-core ridge, so operations bound it (0.174 ms
// at the bf16 peak).
//
// Two implementations, chosen by dtype in the C entry point:
//   bf16 — FlashAttention-2 on the tensor cores (attention_mma.cuh). Every
//          product is mma.sync m16n8k16, bf16 in, fp32 accumulation; S and
//          dP are recomputed from the bf16 inputs, and P and dS are rounded
//          to bf16 in registers and fed on as A operands. 4 warps a block,
//          each owning 16 rows (queries in the dq kernel, keys in the dk/dv
//          kernel); tiles arrive by cp.async through a 2-stage ring into
//          16-byte padded rows (conflict-free ldmatrix).
//          dq kernel: Q and dO of its 64 rows staged once; K/V tiles of 64
//          keys through the ring; dQ += dS K with dS from registers.
//          dk/dv kernel: 64 keys of one kv head, K and V staged once; Q, dO,
//          lse and delta tiles of 64 rows of each q head of the group
//          through the ring. It computes S^T = K Q^T and dP^T = V dO^T, so
//          P^T and dS^T come out key-major in the accumulators and
//          dV += P^T dO, dK += dS^T Q take them from registers (no shared
//          round trip), half a query tile (32 rows) at a time to bound
//          the registers. Masks run only on tiles that straddle the
//          diagonal, the window edge or Tk; the heaviest causal blocks
//          start first.
//   fp32 — the first kernels below: fp32 FMA on the CUDA cores, which the
//          fp32 parity checks hold to 1e-4 (TF32 would not meet it).
#include <type_traits>

#include "attention_mma.cuh"
#include "attention_tile.cuh"

using namespace dstt;

namespace {

constexpr int kBQ = 64;    // query rows per tile of the dk/dv kernel
constexpr int kBKQ = 64;   // keys per tile of the dq kernel
constexpr int kBKV = 32;   // keys owned by a dk/dv block

struct Visible {
  int tq, tk, causal, q_offset, window;
  __device__ __forceinline__ bool operator()(int t, int kp) const {
    if (t >= tq || kp >= tk) return false;
    const int qp = t + q_offset;
    if (causal && kp > qp) return false;
    if (window > 0 && kp <= qp - window) return false;
    return true;
  }
};

// p for one (row, key) pair; 0 where masked or where the row saw no key
__device__ __forceinline__ float prob(float s, float scale, float lse,
                                      bool ok) {
  return (ok && lse > kNegInf / 2) ? expf(s * scale - lse) : 0.f;
}

// acc[i][j] = <A row (ar + as*i), B row (br + bs*j)> over D, both rows in
// shared memory with stride LD
template <typename T, int D, int LD, int NI, int NJ>
__device__ __forceinline__ void dot_tile(const T* A, int ar, int as,
                                         const T* B, int br, int bs,
                                         float (&acc)[NI][NJ]) {
  constexpr int kStep = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += kStep) {
    float a[NI][kStep];
#pragma unroll
    for (int i = 0; i < NI; ++i) load_f<kStep>(A + (ar + as * i) * LD + d, a[i]);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      float bv[kStep];
      load_f<kStep>(B + (br + bs * j) * LD + d, bv);
#pragma unroll
      for (int i = 0; i < NI; ++i)
#pragma unroll
        for (int e = 0; e < kStep; ++e) acc[i][j] = fmaf(a[i][e], bv[e], acc[i][j]);
    }
  }
}

// Stage rows [r0, r0 + R) of a [B, T, NH, D] tensor (head hd) in shared
// memory; rows at or past `limit` (<= T) are zeros.
template <typename T, int D, int LD, int R>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int b, int r0,
                                           int limit, int T_, int NH, int hd) {
  constexpr int kVec = D * (int)sizeof(T) / 16;
  for (int idx = threadIdx.x; idx < R * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec, t = r0 + r;
    const T* row = t < limit ? src + (((long long)b * T_ + t) * NH + hd) * D : nullptr;
    copy_chunk<T, D>(dst + r * LD, row, c);
  }
}

// The dq kernel's query rows a block: 64, or 32 at D 256, where 64 rows
// of fp32 Q and dO beside the K/V tile (256 rows of 1,040 bytes) would
// pass the 227 KB of shared memory a block may have.
template <typename T, int D>
struct DqSmem {
  static constexpr int BQ = D > 128 ? 32 : 64;
  static constexpr int LD = D + 16 / sizeof(T);
  static constexpr int LDP = kBKQ + 4;
  static constexpr size_t bytes() {
    return sizeof(T) * (size_t)(2 * BQ + 2 * kBKQ) * LD +
           sizeof(float) * ((size_t)BQ * LDP + 2 * BQ);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    T* __restrict__ dq, int tq, int tk, int H, int KvH, int causal,
                    int q_offset, int window, float scale) {
  using S = DqSmem<T, D>;
  constexpr int LD = S::LD, LDP = S::LDP, BQ = S::BQ, SR = BQ / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + BQ * LD;
  T* Ks = dOs + BQ * LD;
  T* Vs = Ks + kBKQ * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kBKQ * LD);   // P, then dS
  float* lse_s = Ps + BQ * LDP;
  float* dl_s = lse_s + BQ;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KvH);
  const Visible vis{tq, tk, causal, q_offset, window};

  stage_rows<T, D, LD, BQ>(Qs, q, b, t0, tq, tq, H, h);
  stage_rows<T, D, LD, BQ>(dOs, dout, b, t0, tq, tq, H, h);
  if (tid < BQ) {
    const int t = t0 + tid;
    const long long o = ((long long)b * tq + t) * H + h;
    lse_s[tid] = t < tq ? lse[o] : kNegInf;
    dl_s[tid] = t < tq ? delta[o] : 0.f;
  }

  // key tiles this block's rows can see (the forward's loop bounds)
  const int q_first = t0 + q_offset;
  const int q_last = min(t0 + BQ, tq) - 1 + q_offset;
  int k_end = tk;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  // dq accumulator: rows rg + 8 i, columns c0 .. c0 + OC
  constexpr int OR = BQ / 8, OC = D / 16;
  float acc[OR][OC];
#pragma unroll
  for (int i = 0; i < OR; ++i)
#pragma unroll
    for (int e = 0; e < OC; ++e) acc[i][e] = 0.f;
  const int rg = tid / 16, c0 = (tid % 16) * OC;

  for (int kt = (k_begin / kBKQ) * kBKQ; kt < k_end; kt += kBKQ) {
    __syncthreads();                    // previous tile consumed
    stage_rows<T, D, LD, kBKQ>(Ks, k, b, kt, k_end, tk, KvH, kh);
    stage_rows<T, D, LD, kBKQ>(Vs, v, b, kt, k_end, tk, KvH, kh);
    __syncthreads();
    {
      // P, then dS = P (dP - delta) scale: rows sr + 16 i, keys sk + 8 j
      const int sr = tid / 8, sk = tid % 8;
      float s[SR][8];
      dot_tile<T, D, LD, SR, 8>(Qs, sr, 16, Ks, sk, 8, s);
      float p[SR][8];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = sr + 16 * i, kk = sk + 8 * j;
          p[i][j] = prob(s[i][j], scale, lse_s[r], vis(t0 + r, kt + kk));
        }
      dot_tile<T, D, LD, SR, 8>(dOs, sr, 16, Vs, sk, 8, s);
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = sr + 16 * i, kk = sk + 8 * j;
          Ps[r * LDP + kk] = p[i][j] * (s[i][j] - dl_s[r]) * scale;
        }
    }
    __syncthreads();
    // dq += dS K
#pragma unroll 4
    for (int kk = 0; kk < kBKQ; ++kk) {
      float kv[OC];
      load_f<OC>(Ks + kk * LD + c0, kv);
#pragma unroll
      for (int i = 0; i < OR; ++i) {
        const float ds = Ps[(rg + 8 * i) * LDP + kk];
#pragma unroll
        for (int e = 0; e < OC; ++e) acc[i][e] = fmaf(ds, kv[e], acc[i][e]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < OR; ++i) {
    const int t = t0 + rg + 8 * i;
    if (t >= tq) continue;
    T* dst = dq + (((long long)b * tq + t) * H + h) * D + c0;
#pragma unroll
    for (int e = 0; e < OC; ++e) from_f(acc[i][e], dst + e);
  }
}

template <typename T, int D>
struct DkvSmem {
  static constexpr int LD = D + 16 / sizeof(T);
  static constexpr int LDP = kBKV + 4;
  static constexpr size_t bytes() {
    return sizeof(T) * (size_t)(2 * kBKV + 2 * kBQ) * LD +
           sizeof(float) * ((size_t)2 * kBQ * LDP + 2 * kBQ);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     T* __restrict__ dk, T* __restrict__ dv, int tq, int tk, int H,
                     int KvH, int causal, int q_offset, int window, float scale) {
  using S = DkvSmem<T, D>;
  constexpr int LD = S::LD, LDP = S::LDP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBKV * LD;
  T* Qs = Vs + kBKV * LD;
  T* dOs = Qs + kBQ * LD;
  float* Ps = reinterpret_cast<float*>(dOs + kBQ * LD);
  float* dSs = Ps + kBQ * LDP;
  float* lse_s = dSs + kBQ * LDP;
  float* dl_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int k0 = blockIdx.x * kBKV, kh = blockIdx.y, b = blockIdx.z;
  const int g = H / KvH;
  const Visible vis{tq, tk, causal, q_offset, window};

  stage_rows<T, D, LD, kBKV>(Ks, k, b, k0, tk, tk, KvH, kh);
  stage_rows<T, D, LD, kBKV>(Vs, v, b, k0, tk, tk, KvH, kh);

  // query rows t that can see a key of [k0, k_last]: qp >= k0 (causal) and
  // qp < k_last + window (window)
  const int k_last = min(k0 + kBKV, tk) - 1;
  const int t_lo = causal ? max(0, k0 - q_offset) : 0;
  int t_hi = tq;
  if (window > 0) t_hi = min(t_hi, max(0, k_last + window - q_offset));

  // dk/dv accumulators: keys kr + 8 i, columns c0 .. c0 + OC
  constexpr int OK = kBKV / 8, OC = D / 16;
  float adk[OK][OC], adv[OK][OC];
#pragma unroll
  for (int i = 0; i < OK; ++i)
#pragma unroll
    for (int e = 0; e < OC; ++e) { adk[i][e] = 0.f; adv[i][e] = 0.f; }
  const int kr = tid / 16, c0 = (tid % 16) * OC;

  for (int hh = 0; hh < g; ++hh) {
    const int h = kh * g + hh;
    for (int qt = (t_lo / kBQ) * kBQ; qt < t_hi; qt += kBQ) {
      __syncthreads();                  // previous tile consumed
      stage_rows<T, D, LD, kBQ>(Qs, q, b, qt, tq, tq, H, h);
      stage_rows<T, D, LD, kBQ>(dOs, dout, b, qt, tq, tq, H, h);
      if (tid < kBQ) {
        const int t = qt + tid;
        const long long o = ((long long)b * tq + t) * H + h;
        lse_s[tid] = t < tq ? lse[o] : kNegInf;
        dl_s[tid] = t < tq ? delta[o] : 0.f;
      }
      __syncthreads();
      {
        // P and dS: rows sr + 16 i, keys sk + 8 j
        const int sr = tid / 8, sk = tid % 8;
        float s[4][4];
        dot_tile<T, D, LD, 4, 4>(Qs, sr, 16, Ks, sk, 8, s);
        float p[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = sr + 16 * i, kk = sk + 8 * j;
            p[i][j] = prob(s[i][j], scale, lse_s[r], vis(qt + r, k0 + kk));
            Ps[r * LDP + kk] = p[i][j];
          }
        dot_tile<T, D, LD, 4, 4>(dOs, sr, 16, Vs, sk, 8, s);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = sr + 16 * i, kk = sk + 8 * j;
            dSs[r * LDP + kk] = p[i][j] * (s[i][j] - dl_s[r]) * scale;
          }
      }
      __syncthreads();
      // dv += P^T dO, dk += dS^T Q
#pragma unroll 2
      for (int r = 0; r < kBQ; ++r) {
        float dov[OC], qv[OC];
        load_f<OC>(dOs + r * LD + c0, dov);
        load_f<OC>(Qs + r * LD + c0, qv);
#pragma unroll
        for (int i = 0; i < OK; ++i) {
          const int kk = kr + 8 * i;
          const float p = Ps[r * LDP + kk], ds = dSs[r * LDP + kk];
#pragma unroll
          for (int e = 0; e < OC; ++e) {
            adv[i][e] = fmaf(p, dov[e], adv[i][e]);
            adk[i][e] = fmaf(ds, qv[e], adk[i][e]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < OK; ++i) {
    const int kp = k0 + kr + 8 * i;
    if (kp >= tk) continue;
    const long long o = (((long long)b * tk + kp) * KvH + kh) * D + c0;
#pragma unroll
    for (int e = 0; e < OC; ++e) {
      from_f(adk[i][e], dk + o + e);
      from_f(adv[i][e], dv + o + e);
    }
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in fp32, both dtypes: TPR threads share a row of D
// values, V each, and reduce with shuffles. TPR is the largest power of two
// up to 32 that divides the row's 16-byte chunks (a row never straddles a
// warp, and the shuffle tree needs a power of two), so V is a whole number
// of chunks: 16 bytes a thread at D 64 and 128 (and bf16 256), more at
// D 80, 96 and fp32 256.
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DeltaShape {
  static constexpr int kChunks = D * (int)sizeof(T) / 16;
  static constexpr int TPR = kChunks % 32 == 0 ? 32
                             : kChunks % 16 == 0 ? 16
                             : kChunks % 8 == 0 ? 8
                             : kChunks % 4 == 0 ? 4
                             : kChunks % 2 == 0 ? 2 : 1;
  static constexpr int V = D / TPR;
};

template <typename T, int D>
__global__ void __launch_bounds__(256)
flash_bwd_delta_kernel(const T* __restrict__ out, const T* __restrict__ dout,
                       float* __restrict__ delta, long long rows) {
  constexpr int V = DeltaShape<T, D>::V, TPR = DeltaShape<T, D>::TPR;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long r = i / TPR;
  const int c = (int)(i % TPR);
  float acc = 0.f;
  if (r < rows) {
    float a[V], d[V];
    load_f<V>(out + r * D + c * V, a);
    load_f<V>(dout + r * D + c * V, d);
#pragma unroll
    for (int e = 0; e < V; ++e) acc = fmaf(a[e], d[e], acc);
  }
#pragma unroll
  for (int off = TPR / 2; off > 0; off /= 2)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < rows && c == 0) delta[r] = acc;
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------
constexpr float kLog2e = 1.4426950408889634f;

// lse in log2 units, or +inf for a row with no visible key, so that
// exp2(s * scale * log2(e) - lse2) is p there and 0 here
__device__ __forceinline__ float lse_log2(float lse) {
  return lse > kNegInf / 2 ? lse * kLog2e : __int_as_float(0x7f800000);
}

// Blocks a SM the bf16 kernels are built for: two up to D 128; one at
// D 256, where a block's shared memory (Q, dO and the 2-stage ring, or
// K, V and the ring: 202,752 / 203,776 bytes) leaves room for no second
// block, and one block a SM lets a lane keep 255 registers.
template <int D>
constexpr int kMinBlocks = D > 128 ? 1 : 2;

// dq kernel: each warp owns 16 query rows of one head (two m16 tiles a
// warp spill: PERF.md §6). Grid (H, B, ceil(Tq / 16 kWarps)); blockIdx.z
// = 0 is the last query tile (the longest causal rows start first). At
// D 256 a key tile is taken 32 keys at a time (KH = 2 parts), so that the
// scores of a part (S, dP: 32 registers) sit beside dq's 128 fp32
// accumulators under the register cap.
template <int D>
__global__ void __launch_bounds__(mma::kThreads, kMinBlocks<D>)
flash_bwd_dq_mma_kernel(const mma::bf16* __restrict__ q,
                        const mma::bf16* __restrict__ k,
                        const mma::bf16* __restrict__ v,
                        const mma::bf16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        mma::bf16* __restrict__ dq, int tq, int tk, int H,
                        int KvH, int causal, int q_offset, int window,
                        float scale) {
  using mma::bf16;
  constexpr int BR = 16 * mma::kWarps, BK = mma::kTile, LD = mma::Tile<D>::LD;
  constexpr int KH = D > 128 ? 2 : 1, NK = BK / 8 / KH, ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BR * LD;
  bf16* Ks = dOs + BR * LD;                 // 2 stages
  bf16* Vs = Ks + 2 * BK * LD;              // 2 stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3, m0 = warp * 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BR;
  const int kh = h / (H / KvH);
  const long long qs = (long long)H * D, ks = (long long)KvH * D;
  const float sl2 = scale * kLog2e;

  const int q_first = t0 + q_offset;
  const int q_last = min(t0 + BR, tq) - 1 + q_offset;
  int k_end = tk;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  const long long qo = (((long long)b * tq + t0) * H + h) * D;
  mma::load_tile<D, BR>(Qs, q + qo, qs, tq - t0);
  mma::load_tile<D, BR>(dOs, dout + qo, qs, tq - t0);
  mma::cp_async_commit();
  auto load_kv = [&](int i) {
    const int kt = kt0 + i * BK;
    const long long o = (((long long)b * tk + kt) * KvH + kh) * D;
    mma::load_tile<D, BK>(Ks + (i & 1) * BK * LD, k + o, ks, tk - kt);
    mma::load_tile<D, BK>(Vs + (i & 1) * BK * LD, v + o, ks, tk - kt);
    mma::cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0);

  // this lane's rows g and g + 8: lse (log2 units) and delta
  float l2[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = t0 + m0 + g + hf * 8;
    const long long o = ((long long)b * tq + t) * H + h;
    l2[hf] = t < tq ? lse_log2(lse[o]) : __int_as_float(0x7f800000);
    dl[hf] = t < tq ? delta[o] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    // tile i (and Q/dO) staged by every thread, and every warp is done
    // with tile i - 1, whose stage now takes tile i + 1
    __syncthreads();
    if (i + 1 < n_tiles) load_kv(i + 1);
    const bf16* Kt = Ks + (i & 1) * BK * LD;
    const bf16* Vt = Vs + (i & 1) * BK * LD;
    const int kt = kt0 + i * BK;
    bool straddles = kt + BK > tk;
    if (causal) straddles |= kt + BK - 1 > q_first;
    if (window > 0) straddles |= kt <= t0 + BR - 1 + q_offset - window;

#pragma unroll
    for (int hk = 0; hk < KH; ++hk) {
      const int n0 = hk * NK * 8;             // first key of this part
      // P = exp(S scale - lse), 0 where masked
      float s[NK][4];
      mma::mma_smem<D, NK>(s, Qs, m0, Kt, n0, lane);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (straddles) {
            const int qp = t0 + m0 + g + (e >> 1) * 8 + q_offset;
            const int kp = kt + n0 + n * 8 + 2 * tg + (e & 1);
            ok = kp < tk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
          }
          s[n][e] = ok ? exp2f(fmaf(s[n][e], sl2, -l2[e >> 1])) : 0.f;
        }
      // dS = P (dO V^T - delta), unscaled (dq is scaled once at the end),
      // rounded to bf16 as the A operand of dQ += dS K
      float dp[NK][4];
      mma::mma_smem<D, NK>(dp, dOs, m0, Vt, n0, lane);
#pragma unroll
      for (int n = 0; n < NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[n][e] = s[n][e] * (dp[n][e] - dl[e >> 1]);
      uint32_t da[NK / 2][4];
#pragma unroll
      for (int j = 0; j < NK / 2; ++j) mma::acc_to_a(da[j], dp[2 * j], dp[2 * j + 1]);
      mma::mma_a_regs(acc, da, Kt, LD, n0, lane);
    }
  }
  if (n_tiles == 0) {                       // Q/dO landed before reuse
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  mma::store_rows<D>(acc, scale, scale, Qs, m0,
                     dq + (((long long)b * tq + t0 + m0) * H + h) * D, qs,
                     tq - t0 - m0, lane);
}

// What a launch of the dk/dv kernel accumulates. Up to D 128 one launch
// takes both (kDkv). At D 256 a warp's dk and dv accumulators would be
// 2 x 16 x 256 fp32 (256 registers a lane, past the 255 cap before any
// score), so two launches split them: kDv (S, P^T, dV += P^T dO) and kDk
// (S, dP, dS^T, dK += dS^T Q). The dk launch recomputes S: 5 products
// where one launch does 4, and no lane holds more than one accumulator.
enum DkvPass { kDkv = 0, kDv = 1, kDk = 2 };

// dk/dv kernel: each warp owns 16 keys of one kv head. Grid (KvH, B,
// ceil(Tk / 16 kWarps)); blockIdx.z = 0 holds the first keys (under a
// causal mask, the ones most queries see).
template <int D, int PASS>
__global__ void __launch_bounds__(mma::kThreads, kMinBlocks<D>)
flash_bwd_dkv_mma_kernel(const mma::bf16* __restrict__ q,
                         const mma::bf16* __restrict__ k,
                         const mma::bf16* __restrict__ v,
                         const mma::bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         mma::bf16* __restrict__ dk, mma::bf16* __restrict__ dv,
                         int tq, int tk, int H, int KvH, int causal,
                         int q_offset, int window, float scale) {
  using mma::bf16;
  constexpr int BKV = 16 * mma::kWarps, BQ = mma::kTile, LD = mma::Tile<D>::LD;
  constexpr int ND = D / 8, HQ = BQ / 2;   // query rows per half pass
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BKV * LD;
  bf16* Qs = Vs + BKV * LD;                 // 2 stages
  bf16* dOs = Qs + 2 * BQ * LD;             // 2 stages
  float* ls = reinterpret_cast<float*>(dOs + 2 * BQ * LD);   // 2 stages
  float* dls = ls + 2 * BQ;                 // 2 stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3, m0 = warp * 16;
  const int kh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int grp = H / KvH;
  const long long qs = (long long)H * D, ks = (long long)KvH * D;
  const float sl2 = scale * kLog2e;

  const long long ko = (((long long)b * tk + k0) * KvH + kh) * D;
  mma::load_tile<D, BKV>(Ks, k + ko, ks, tk - k0);
  mma::load_tile<D, BKV>(Vs, v + ko, ks, tk - k0);
  mma::cp_async_commit();

  // query rows t that can see a key of [k0, k_last]: qp >= k0 (causal) and
  // qp < k_last + window (window)
  const int k_last = min(k0 + BKV, tk) - 1;
  const int t_lo = causal ? max(0, k0 - q_offset) : 0;
  int t_hi = tq;
  if (window > 0) t_hi = min(t_hi, max(0, k_last + window - q_offset));
  const int qt0 = (t_lo / BQ) * BQ;
  const int nq = t_hi > qt0 ? (t_hi - qt0 + BQ - 1) / BQ : 0;
  const int total = grp * nq;               // (q head, query tile) steps

  // stage step i: Q, dO rows of q head kh * grp + i / nq, tile i % nq, and
  // their lse / delta (zeros past Tq: those rows add exactly nothing)
  auto load_q = [&](int i) {
    const int h = kh * grp + i / nq, qt = qt0 + (i % nq) * BQ, st = i & 1;
    const long long o = (((long long)b * tq + qt) * H + h) * D;
    mma::load_tile<D, BQ>(Qs + st * BQ * LD, q + o, qs, tq - qt);
    mma::load_tile<D, BQ>(dOs + st * BQ * LD, dout + o, qs, tq - qt);
    if (threadIdx.x < 2 * BQ) {
      const int r = threadIdx.x % BQ, t = qt + r;
      const bool ok = t < tq;
      const long long ro = ok ? ((long long)b * tq + t) * H + h : 0;
      if (threadIdx.x < BQ)
        mma::cp_async4(ls + st * BQ + r, lse + ro, ok);
      else
        mma::cp_async4(dls + st * BQ + r, delta + ro, ok);
    }
    mma::cp_async_commit();
  };
  if (total > 0) load_q(0);

  float adk[ND][4], adv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
    adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  }

  for (int i = 0; i < total; ++i) {
    mma::cp_async_wait<0>();
    // step i (and K/V) staged by every thread, and every warp is done with
    // step i - 1, whose stage now takes step i + 1
    __syncthreads();
    if (i + 1 < total) load_q(i + 1);
    const int st = i & 1, qt = qt0 + (i % nq) * BQ;
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* dOt = dOs + st * BQ * LD;
    const float* lt = ls + st * BQ;
    const float* dlt = dls + st * BQ;
    bool straddles = k0 + BKV > tk;
    if (causal) straddles |= k0 + BKV - 1 > qt + q_offset;
    if (window > 0) straddles |= k0 <= qt + BQ - 1 + q_offset - window;

#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      // P^T = exp(S^T scale - lse): rows are this warp's 16 keys, columns
      // the half tile's 32 queries
      float s[HQ / 8][4];
      mma::mma_smem<D, HQ / 8>(s, Ks, m0, Qt, hq * HQ, lane);
#pragma unroll
      for (int n = 0; n < HQ / 8; ++n) {
        const int j = hq * HQ + n * 8 + 2 * tg;          // query rows j, j + 1
        const float2 lj = *reinterpret_cast<const float2*>(lt + j);
        const float l2[2] = {lse_log2(lj.x), lse_log2(lj.y)};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bool ok = true;
          if (straddles) {
            const int qp = qt + j + (e & 1) + q_offset;
            const int kp = k0 + m0 + g + (e >> 1) * 8;
            ok = kp < tk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
          }
          s[n][e] = ok ? exp2f(fmaf(s[n][e], sl2, -l2[e & 1])) : 0.f;
        }
      }
      if constexpr (PASS != kDk) {
        uint32_t pa[HQ / 16][4];
#pragma unroll
        for (int j = 0; j < HQ / 16; ++j) mma::acc_to_a(pa[j], s[2 * j], s[2 * j + 1]);
        mma::mma_a_regs(adv, pa, dOt, LD, hq * HQ, lane);   // dV += P^T dO
      }
      if constexpr (PASS != kDv) {
        // dS^T = P^T (V dO^T - delta), unscaled (dk is scaled at the end)
        float dp[HQ / 8][4];
        mma::mma_smem<D, HQ / 8>(dp, Vs, m0, dOt, hq * HQ, lane);
#pragma unroll
        for (int n = 0; n < HQ / 8; ++n) {
          const float2 dj =
              *reinterpret_cast<const float2*>(dlt + hq * HQ + n * 8 + 2 * tg);
          dp[n][0] = s[n][0] * (dp[n][0] - dj.x);
          dp[n][1] = s[n][1] * (dp[n][1] - dj.y);
          dp[n][2] = s[n][2] * (dp[n][2] - dj.x);
          dp[n][3] = s[n][3] * (dp[n][3] - dj.y);
        }
        uint32_t da[HQ / 16][4];
#pragma unroll
        for (int j = 0; j < HQ / 16; ++j) mma::acc_to_a(da[j], dp[2 * j], dp[2 * j + 1]);
        mma::mma_a_regs(adk, da, Qt, LD, hq * HQ, lane);    // dK += dS^T Q
      }
    }
  }
  if (total == 0) {                         // K/V landed before reuse
    mma::cp_async_wait<0>();
    __syncthreads();
  }
  const long long o = (((long long)b * tk + k0 + m0) * KvH + kh) * D;
  if constexpr (PASS != kDv)
    mma::store_rows<D>(adk, scale, scale, Ks, m0, dk + o, ks, tk - k0 - m0, lane);
  if constexpr (PASS != kDk)
    mma::store_rows<D>(adv, 1.f, 1.f, Vs, m0, dv + o, ks, tk - k0 - m0, lane);
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk,
               void* dv, int B, int tq, int tk, int H, int KvH, int causal,
               int q_offset, int window, float scale, cudaStream_t stream) {
  using mma::bf16;
  constexpr int LD = mma::Tile<D>::LD, BT = mma::kTile;
  constexpr int BQ = 16 * mma::kWarps, BKV = 16 * mma::kWarps;
  const int smem_q = (int)(sizeof(bf16) * (2 * BQ + 4 * BT) * LD);
  const int smem_kv =
      (int)(sizeof(bf16) * (2 * BKV + 4 * BT) * LD + sizeof(float) * 4 * BT);
  constexpr bool kSplit = D > 128;          // dv and dk in two launches
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_q);
  if (err != cudaSuccess) return (int)err;
  if constexpr (kSplit) {
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D, kDv>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D, kDk>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
  } else {
    err = cudaFuncSetAttribute(flash_bwd_dkv_mma_kernel<D, kDkv>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_kv);
  }
  if (err != cudaSuccess) return (int)err;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* dop = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  if (tq > 0) {
    const dim3 grid(H, B, (tq + BQ - 1) / BQ);
    flash_bwd_dq_mma_kernel<D><<<grid, mma::kThreads, smem_q, stream>>>(
        qp, kp, vp, dop, lp, dlp, static_cast<bf16*>(dq), tq, tk, H, KvH,
        causal, q_offset, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (tk > 0) {
    const dim3 grid(KvH, B, (tk + BKV - 1) / BKV);
    bf16* dkp = static_cast<bf16*>(dk);
    bf16* dvp = static_cast<bf16*>(dv);
    if constexpr (kSplit) {
      flash_bwd_dkv_mma_kernel<D, kDv><<<grid, mma::kThreads, smem_kv, stream>>>(
          qp, kp, vp, dop, lp, dlp, dkp, dvp, tq, tk, H, KvH, causal, q_offset,
          window, scale);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      flash_bwd_dkv_mma_kernel<D, kDk><<<grid, mma::kThreads, smem_kv, stream>>>(
          qp, kp, vp, dop, lp, dlp, dkp, dvp, tq, tk, H, KvH, causal, q_offset,
          window, scale);
    } else {
      flash_bwd_dkv_mma_kernel<D, kDkv><<<grid, mma::kThreads, smem_kv, stream>>>(
          qp, kp, vp, dop, lp, dlp, dkp, dvp, tq, tk, H, KvH, causal, q_offset,
          window, scale);
    }
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 on the CUDA cores
// ---------------------------------------------------------------------------
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, void* dk, void* dv,
           int B, int tq, int tk, int H, int KvH, int causal, int q_offset,
           int window, float scale, cudaStream_t stream) {
  const int smem_q = (int)DqSmem<T, D>::bytes();
  const int smem_kv = (int)DkvSmem<T, D>::bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (err != cudaSuccess) return (int)err;
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  const T* dop = static_cast<const T*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dlp = static_cast<const float*>(delta);
  if (tq > 0) {
    constexpr int BQ = DqSmem<T, D>::BQ;
    const dim3 grid((tq + BQ - 1) / BQ, H, B);
    flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem_q, stream>>>(
        qp, kp, vp, dop, lp, dlp, static_cast<T*>(dq), tq, tk, H, KvH, causal,
        q_offset, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (tk > 0) {
    const dim3 grid((tk + kBKV - 1) / kBKV, KvH, B);
    flash_bwd_dkv_kernel<T, D><<<grid, kThreads, smem_kv, stream>>>(
        qp, kp, vp, dop, lp, dlp, static_cast<T*>(dk), static_cast<T*>(dv), tq,
        tk, H, KvH, causal, q_offset, window, scale);
  }
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_delta(const void* out, const void* dout, void* delta, long long rows,
                 cudaStream_t stream) {
  constexpr int TPR = DeltaShape<T, D>::TPR;
  const long long blocks = (rows * TPR + 255) / 256;
  if (blocks > 0)
    flash_bwd_delta_kernel<T, D><<<(unsigned)blocks, 256, 0, stream>>>(
        static_cast<const T*>(out), static_cast<const T*>(dout),
        static_cast<float*>(delta), rows);
  return (int)cudaGetLastError();
}

// the delta pre-pass, then the dq and dk/dv kernels of T's implementation
template <typename T, int D>
int run(const void* q, const void* k, const void* v, const void* out,
        const void* dout, const void* lse, void* delta, void* dq, void* dk,
        void* dv, int B, int tq, int tk, int H, int KvH, int causal,
        int q_offset, int window, float scale, cudaStream_t stream) {
  const int err = launch_delta<T, D>(out, dout, delta, (long long)B * tq * H,
                                     stream);
  if (err != 0) return err;
  if constexpr (std::is_same<T, float>::value)
    return launch<T, D>(q, k, v, dout, lse, delta, dq, dk, dv, B, tq, tk, H,
                        KvH, causal, q_offset, window, scale, stream);
  else
    return launch_mma<D>(q, k, v, dout, lse, delta, dq, dk, dv, B, tq, tk, H,
                         KvH, causal, q_offset, window, scale, stream);
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernels), 1 = bfloat16 (tensor-core
// kernels). window <= 0 means no window. Fills `delta` ([B, Tq, H] fp32)
// with rowsum(dO * O), then launches the dq kernel and the dk/dv kernel, on
// `stream`. Returns cudaGetLastError() after the launches
// (cudaErrorInvalidValue for an unsupported dtype / head_dim).
extern "C" int dstt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, void* dq, void* dk,
    void* dv, int B, int tq, int tk, int H, int KvH, int D, int dtype,
    int causal, int q_offset, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSTT_BWD(T, DIM)                                                      \
  run<T, DIM>(q, k, v, out, dout, lse, delta, dq, dk, dv, B, tq, tk, H, KvH, \
              causal, q_offset, window, scale, st)
#define DSTT_BWD_D(DIM)                                                     \
  if (D == DIM) {                                                           \
    if (dtype == 0) return DSTT_BWD(float, DIM);                            \
    if (dtype == 1) return DSTT_BWD(__nv_bfloat16, DIM);                    \
  }
  DSTT_BWD_D(64)
  DSTT_BWD_D(80)
  DSTT_BWD_D(96)
  DSTT_BWD_D(128)
  DSTT_BWD_D(256)
#undef DSTT_BWD_D
#undef DSTT_BWD
  return (int)cudaErrorInvalidValue;
}
