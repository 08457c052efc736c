// Flash-attention forward for Hopper (sm_90a) — kernel K1 of the port.
//
// Replaces the TPU kernels _fwd_kernel (deepspeed_tpu/ops/flash_attention.py:71)
// and _fwd_kernel_xl (:232): softmax(Q K^T / sqrt(d)) V with online softmax,
// causal with q_offset, optional sliding window, returning out and the
// per-row fp32 logsumexp. The TPU pair exists only for VMEM limits; here
// one kernel streams K/V tiles through shared memory at any length.
//
// Layout: q/out [B, Tq, H, D], k/v [B, Tk, KvH, D] (the JAX package's
// public layout, read in place — no transposes), lse [B, Tq, H]. GQA by
// head index: kv head = h / (H / KvH); K/V are never repeated.
//
// A block owns 64 query rows of one head and walks key tiles of 64 from
// the window's first live tile to the causal bound; dead tiles are skipped
// by the loop bound, as _fwd_kernel does (:86-101). Ragged Tq/Tk are
// masked in the kernel. Rows with no visible key give out = 0 and
// lse = -1e30.
//
// What bounds it on the H100: at the training path's shape (B 4, T 2048,
// 16 q / 8 kv heads, D 128, causal) 4 d H T (T + 1) / 2 a sequence makes
// 68.7 GFLOP against 101 MB of q/k/v/out: operations (0.0695 ms at the
// bf16 tensor-core peak). At the serving path's 256-token chunks (8 x 256, 32 q
// heads) it is 4.3 GFLOP against 42 MB, about 100 FLOP per byte, under the
// bf16 ridge (~295): bytes (0.0125 ms).
//
// Two kernels, chosen by dtype in the C entry point:
//   bf16 — FlashAttention-2 on the tensor cores (attention_mma.cuh): 4 warps
//          of 16 query rows each; the Q tile is staged once by cp.async and
//          held in registers as mma A operands across D; K/V tiles of 64
//          keys move through a 2-stage cp.async ring (the next tile loads
//          while this one is consumed) into 16-byte padded rows;
//          S = Q K^T and O += P V are mma.sync m16n8k16 with fp32
//          accumulation; the online softmax runs in registers (a row lives
//          in a quad of lanes: two shuffles for its max; the sum is reduced
//          once at the end) with exp2 and scale * log2(e) folded into one
//          FMA; P is rounded to bf16 in registers and is the A operand of
//          P V directly. Masks run only on tiles that straddle the diagonal,
//          the window edge or Tk. Blocks of the longest causal rows start
//          first (the query tile index runs backwards over the grid).
//   fp32 — the first kernel (attention_tile.cuh, shared with K2): fp32 FMA
//          on the CUDA cores, which the fp32 parity checks hold to 1e-4
//          (TF32 tensor cores would not meet it).
#include "attention_mma.cuh"
#include "attention_tile.cuh"

using namespace dstt;

namespace {

constexpr int kBR = 64;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int tq, int tk, int H, int KvH,
                 int causal, int q_offset, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  AttnTile<T, D, kBR> tile(smem);
  const int t0 = blockIdx.x * kBR;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KvH);

  auto row = [&](int r) -> long long {       // q/out/lse row, -1 outside
    const int t = t0 + r;
    return t < tq ? ((long long)b * tq + t) * H + h : -1LL;
  };
  tile.load_q([&](int r) -> const T* {
    const long long o = row(r);
    return o < 0 ? nullptr : q + o * D;
  });

  const int q_first = t0 + q_offset;
  const int q_last = min(t0 + kBR, tq) - 1 + q_offset;
  int k_end = tk;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  for (int kt = (k_begin / kBK) * kBK; kt < k_end; kt += kBK) {
    tile.load_kv([&](int kk, int which) -> const T* {
      const int p = kt + kk;
      if (p >= k_end) return nullptr;
      return (which ? v : k) + (((long long)b * tk + p) * KvH + kh) * D;
    });
    tile.update(scale, [&](int r, int kk) {
      const int qpos = t0 + r + q_offset, kpos = kt + kk;
      bool ok = kpos < k_end;
      if (causal) ok = ok && kpos <= qpos;
      if (window > 0) ok = ok && kpos > qpos - window;
      return ok;
    });
  }
  tile.finish(
      [&](int r) -> T* {
        const long long o = row(r);
        return o < 0 ? nullptr : out + o * D;
      },
      [&](int r) -> float* {
        const long long o = row(r);
        return o < 0 ? nullptr : lse + o;
      });
}

// bf16 on the tensor cores: each warp owns MT m16 tiles of query rows
// (16 MT kWarps rows a block), so each K/V fragment read from shared
// memory feeds MT tiles (one tile a warp measured 25 % slower). Grid (H,
// B, ceil(Tq / kFwdRows)); blockIdx.z = 0 is the last query tile.
constexpr int kFwdMTiles = 2, kFwdRows = 16 * kFwdMTiles * mma::kWarps;

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
flash_fwd_mma_kernel(const mma::bf16* __restrict__ q,
                     const mma::bf16* __restrict__ k,
                     const mma::bf16* __restrict__ v, mma::bf16* __restrict__ out,
                     float* __restrict__ lse, int tq, int tk, int H, int KvH,
                     int causal, int q_offset, int window, float scale) {
  using mma::bf16;
  constexpr int MT = kFwdMTiles, BR = kFwdRows, BK = mma::kTile;
  constexpr int LD = mma::Tile<D>::LD;
  constexpr int ND = D / 8, NK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BR * LD;                  // 2 stages
  bf16* Vs = Ks + 2 * BK * LD;              // 2 stages
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3, m0 = warp * 16 * MT;
  const int h = blockIdx.x, b = blockIdx.y;
  const int t0 = (gridDim.z - 1 - blockIdx.z) * BR;
  const int kh = h / (H / KvH);
  const long long qs = (long long)H * D, ks = (long long)KvH * D;
  const float sl2 = scale * 1.4426950408889634f;   // scale * log2(e)

  // key tiles the block's rows can see (the forward's loop bounds)
  const int q_first = t0 + q_offset;
  const int q_last = min(t0 + BR, tq) - 1 + q_offset;
  int k_end = tk;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int kt0 = (k_begin / BK) * BK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + BK - 1) / BK : 0;

  mma::load_tile<D, BR>(Qs, q + (((long long)b * tq + t0) * H + h) * D, qs,
                        tq - t0);
  mma::cp_async_commit();
  auto load_kv = [&](int i) {
    const int kt = kt0 + i * BK;
    const long long o = (((long long)b * tk + kt) * KvH + kh) * D;
    mma::load_tile<D, BK>(Ks + (i & 1) * BK * LD, k + o, ks, tk - kt);
    mma::load_tile<D, BK>(Vs + (i & 1) * BK * LD, v + o, ks, tk - kt);
    mma::cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0);

  float o[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  // rows g (hf 0) and g + 8 (hf 1) of each m-tile: running max of the raw
  // scores, and this lane's part of the row sum
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    m_run[mt][0] = m_run[mt][1] = kNegInf, l_run[mt][0] = l_run[mt][1] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<0>();
    // tile i (and Q) staged by every thread, and every warp is done with
    // tile i - 1, whose stage now takes tile i + 1 while tile i is used
    __syncthreads();
    if (i + 1 < n_tiles) load_kv(i + 1);
    const bf16* Kt = Ks + (i & 1) * BK * LD;
    const bf16* Vt = Vs + (i & 1) * BK * LD;
    const int kt = kt0 + i * BK;

    // S = Q K^T (raw, unscaled)
    float s[MT][NK][4];
    mma::mma_smem_mt<D, MT, NK>(s, Qs, m0, Kt, 0, lane);

    // mask only a tile that straddles Tk, the diagonal or the window edge
    bool straddles = kt + BK > tk;
    if (causal) straddles |= kt + BK - 1 > q_first;
    if (window > 0) straddles |= kt <= t0 + BR - 1 + q_offset - window;
    if (straddles) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = t0 + m0 + 16 * mt + g + (e >> 1) * 8 + q_offset;
            const int kp = kt + n * 8 + 2 * tg + (e & 1);
            bool ok = kp < tk;
            if (causal) ok = ok && kp <= qp;
            if (window > 0) ok = ok && kp > qp - window;
            if (!ok) s[mt][n][e] = kNegInf;
          }
    }

    // online softmax in registers: a row lives in a quad of lanes
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NK; ++n)
          mx = fmaxf(mx, fmaxf(s[mt][n][2 * hf], s[mt][n][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][hf], mx);
        // a row that has seen no key yet keeps p = 0 and corr = 0: with
        // m = -1e30, exp(s - m) would be 1
        const bool alive = m_new > kNegInf / 2;
        const float corr = alive ? exp2f((m_run[mt][hf] - m_new) * sl2) : 0.f;
        const float base = m_new * sl2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float p = alive ? exp2f(fmaf(s[mt][n][e], sl2, -base)) : 0.f;
            s[mt][n][e] = p;
            sum += p;
          }
        l_run[mt][hf] = l_run[mt][hf] * corr + sum;
        m_run[mt][hf] = m_new;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          o[mt][n][2 * hf] *= corr;
          o[mt][n][2 * hf + 1] *= corr;
        }
      }

    // O += P V, P rounded to bf16 in registers, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma::acc_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t bf[4];
        mma::load_b_kn(bf, Vt, LD, n * 8, kk * 16, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma::mma_bf16(o[mt][n], pa[mt], bf[0], bf[1]);
          mma::mma_bf16(o[mt][n + 1], pa[mt], bf[2], bf[3]);
        }
      }
    }
  }
  if (n_tiles == 0) {                       // Q landed before reuse
    mma::cp_async_wait<0>();
    __syncthreads();
  }

  // out = O / l, lse = m * scale + log(l), or zeros and -1e30 for a row
  // that saw no key
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float l = l_run[mt][hf];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l = fmaxf(l, 1e-30f);
      inv[hf] = 1.f / l;
      const int t = t0 + m0 + 16 * mt + g + hf * 8;
      if (tg == 0 && t < tq)
        lse[((long long)b * tq + t) * H + h] =
            m_run[mt][hf] > kNegInf / 2 ? m_run[mt][hf] * scale + logf(l)
                                        : kNegInf;
    }
    const int r0 = m0 + 16 * mt;
    mma::store_rows<D>(o[mt], inv[0], inv[1], Qs, r0,
                       out + (((long long)b * tq + t0 + r0) * H + h) * D, qs,
                       tq - t0 - r0, lane);
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int tq, int tk, int H, int KvH, int causal,
               int q_offset, int window, float scale, cudaStream_t stream) {
  constexpr int BR = kFwdRows;
  const int smem =
      (int)(sizeof(mma::bf16) * (BR + 4 * mma::kTile) * mma::Tile<D>::LD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (tq + BR - 1) / BR);
  flash_fwd_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), static_cast<mma::bf16*>(out),
      static_cast<float*>(lse), tq, tk, H, KvH, causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int tq, int tk, int H, int KvH, int causal, int q_offset,
           int window, float scale, cudaStream_t stream) {
  const int smem = (int)AttnTile<T, D, kBR>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((tq + kBR - 1) / kBR, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      tq, tk, H, KvH, causal, q_offset, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core kernel).
// window <= 0 means no window.
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for
// an unsupported dtype / head_dim).
extern "C" int dstt_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse,
    int B, int tq, int tk, int H, int KvH, int D, int dtype, int causal,
    int q_offset, int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  if (dtype == 1 && D == 64)
    return launch_mma<64>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch_mma<128>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
