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
//   delta = rowsum(dO * O)                  (computed by the caller, fp32)
//   ds    = p * (dO V^T - delta) * scale
//   dq    = ds K          (dq kernel: a block owns 64 query rows of one head
//                          and walks the key tiles it can see)
//   dk    = ds^T Q, dv = p^T dO
//                         (dk/dv kernel: a block owns 32 keys of one kv head
//                          and walks the query tiles of EVERY q head of its
//                          GQA group, so the group sum happens in registers
//                          and no per-q-head fp32 dk/dv is ever written)
//
// Layout: q/dO/dq [B, Tq, H, D], k/v/dk/dv [B, Tk, KvH, D] (the JAX
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
// ~240 GFLOP against ~200 MB of q/k/v/O/dO/lse and dq/dk/dv in bf16: far
// above the tensor-core ridge, so operations bound the ideal kernel. This
// first kernel does its products as fp32 FMA on the CUDA cores (67 TFLOP/s
// peak), like K1; tensor cores (mma.sync / wgmma) are the next step.
#include "attention_tile.cuh"

using namespace dstt;

namespace {

constexpr int kBQ = 64;    // query rows per tile
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

template <typename T, int D>
struct DqSmem {
  static constexpr int LD = D + 16 / sizeof(T);
  static constexpr int LDP = kBKQ + 4;
  static constexpr size_t bytes() {
    return sizeof(T) * (size_t)(2 * kBQ + 2 * kBKQ) * LD +
           sizeof(float) * ((size_t)kBQ * LDP + 2 * kBQ);
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
  constexpr int LD = S::LD, LDP = S::LDP;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBQ * LD;
  T* Ks = dOs + kBQ * LD;
  T* Vs = Ks + kBKQ * LD;
  float* Ps = reinterpret_cast<float*>(Vs + kBKQ * LD);   // P, then dS
  float* lse_s = Ps + kBQ * LDP;
  float* dl_s = lse_s + kBQ;

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KvH);
  const Visible vis{tq, tk, causal, q_offset, window};

  stage_rows<T, D, LD, kBQ>(Qs, q, b, t0, tq, tq, H, h);
  stage_rows<T, D, LD, kBQ>(dOs, dout, b, t0, tq, tq, H, h);
  if (tid < kBQ) {
    const int t = t0 + tid;
    const long long o = ((long long)b * tq + t) * H + h;
    lse_s[tid] = t < tq ? lse[o] : kNegInf;
    dl_s[tid] = t < tq ? delta[o] : 0.f;
  }

  // key tiles this block's rows can see (the forward's loop bounds)
  const int q_first = t0 + q_offset;
  const int q_last = min(t0 + kBQ, tq) - 1 + q_offset;
  int k_end = tk;
  if (causal) k_end = min(k_end, q_last + 1);
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  // dq accumulator: rows rg + 8 i, columns c0 .. c0 + OC
  constexpr int OR = kBQ / 8, OC = D / 16;
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
      float s[4][8];
      dot_tile<T, D, LD, 4, 8>(Qs, sr, 16, Ks, sk, 8, s);
      float p[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = sr + 16 * i, kk = sk + 8 * j;
          p[i][j] = prob(s[i][j], scale, lse_s[r], vis(t0 + r, kt + kk));
        }
      dot_tile<T, D, LD, 4, 8>(dOs, sr, 16, Vs, sk, 8, s);
#pragma unroll
      for (int i = 0; i < 4; ++i)
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
    const dim3 grid((tq + kBQ - 1) / kBQ, H, B);
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Launches
// the dq kernel, then the dk/dv kernel, on `stream`. Returns
// cudaGetLastError() after the launches (cudaErrorInvalidValue for an
// unsupported dtype / head_dim).
extern "C" int dstt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv, int B,
    int tq, int tk, int H, int KvH, int D, int dtype, int causal, int q_offset,
    int window, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DSTT_BWD(T, DIM)                                                      \
  launch<T, DIM>(q, k, v, dout, lse, delta, dq, dk, dv, B, tq, tk, H, KvH,   \
                 causal, q_offset, window, scale, st)
  if (dtype == 0 && D == 64) return DSTT_BWD(float, 64);
  if (dtype == 0 && D == 128) return DSTT_BWD(float, 128);
  if (dtype == 1 && D == 64) return DSTT_BWD(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) return DSTT_BWD(__nv_bfloat16, 128);
#undef DSTT_BWD
  return (int)cudaErrorInvalidValue;
}
