// Shared block-level online-softmax attention for the port's two
// attention kernels (flash_attention.cu, paged_attention.cu).
//
// One block of 128 threads owns BR query rows. It walks key tiles of
// BK = 64 keys: the caller stages each tile's K and V rows in shared
// memory (zeros for keys it does not load), and `tile_update` folds the
// tile into the running (max m, sum l, accumulator acc) per row — the
// flash-attention-2 recurrence of the TPU kernels (_fwd_kernel,
// _paged_kernel), with the same masked-row conventions:
//   masked scores are -1e30; a row whose running max is still -1e30 has
//   no visible key yet and gets p = 0 and corr = 0; at the end
//   out = acc / max(l, 1e-30) (zeros for a row with no key) and
//   lse = m + log(max(l, 1e-30)), or -1e30 for a row with no key.
//
// Arithmetic is plain fp32 FMA on the CUDA cores (bf16 or fp32 inputs are
// widened when read from shared memory): a simple kernel that is right
// first. Tensor cores (mma.sync / wgmma) are later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kBK = 64;   // keys per tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void from_f(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(x);
}

// N contiguous values at p (8-byte aligned, N % 4 == 0) widened to fp32.
template <int N>
__device__ __forceinline__ void load_f(const float* p, float* out) {
  static_assert(N % 4 == 0, "load_f: N must be a multiple of 4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    out[i] = v.x; out[i + 1] = v.y; out[i + 2] = v.z; out[i + 3] = v.w;
  }
}
template <int N>
__device__ __forceinline__ void load_f(const __nv_bfloat16* p, float* out) {
  static_assert(N % 4 == 0, "load_f: N must be a multiple of 4");
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p + i);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[i] = a.x; out[i + 1] = a.y; out[i + 2] = b.x; out[i + 3] = b.y;
  }
}

// Copy one row of D values of T from global `src` to shared `dst`, or
// zeros when src is null; the 16-byte chunk `v` of the row.
template <typename T, int D>
__device__ __forceinline__ void copy_chunk(T* dst, const T* src, int v) {
  constexpr int kVec = 16 / sizeof(T);
  uint4 val = make_uint4(0u, 0u, 0u, 0u);
  if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + v * kVec);
  *reinterpret_cast<uint4*>(dst + v * kVec) = val;
}

template <typename T, int D, int BR>
struct AttnTile {
  static_assert(D == 64 || D == 128, "head_dim must be 64 or 128");
  static_assert(BR == 16 || BR == 64, "row tile must be 16 or 64");
  // shared-memory row strides: 16 bytes of padding spreads rows over banks
  static constexpr int LD = D + 16 / sizeof(T);
  static constexpr int LDP = kBK + 4;
  // S = Q K^T micro-tile: 16 row groups x 8 key groups of threads
  static constexpr int SR = BR / 16;     // rows per thread (r = rg + 16 i)
  static constexpr int SK = kBK / 8;     // keys per thread (k = kg + 8 j)
  // O += P V micro-tile: 8 row groups x 16 column groups of threads
  static constexpr int OR = BR / 8;      // rows per thread (r = rg + 8 i)
  static constexpr int OC = D / 16;      // contiguous columns per thread
  // softmax: TPR threads share a row, each KPT keys (k = part + TPR i)
  static constexpr int TPR = kThreads / BR;
  static constexpr int KPT = kBK / TPR;
  static constexpr int kVecPerRow = D * (int)sizeof(T) / 16;

  static constexpr size_t smem_bytes() {
    return sizeof(T) * (size_t)(BR + 2 * kBK) * LD +
           sizeof(float) * ((size_t)BR * LDP + 3 * BR);
  }

  T* Qs; T* Ks; T* Vs; float* Ps; float* m_s; float* l_s; float* c_s;
  float acc[OR][OC];

  __device__ explicit AttnTile(unsigned char* smem) {
    Qs = reinterpret_cast<T*>(smem);
    Ks = Qs + BR * LD;
    Vs = Ks + kBK * LD;
    Ps = reinterpret_cast<float*>(Vs + kBK * LD);
    m_s = Ps + BR * LDP;
    l_s = m_s + BR;
    c_s = l_s + BR;
#pragma unroll
    for (int i = 0; i < OR; ++i)
#pragma unroll
      for (int e = 0; e < OC; ++e) acc[i][e] = 0.f;
    if (threadIdx.x < BR) { m_s[threadIdx.x] = kNegInf; l_s[threadIdx.x] = 0.f; }
  }

  // Stage the query rows: row_ptr(r) gives row r's D values, or null for
  // a row outside the problem (staged as zeros).
  template <typename RowPtr>
  __device__ void load_q(RowPtr row_ptr) {
    for (int idx = threadIdx.x; idx < BR * kVecPerRow; idx += kThreads) {
      const int r = idx / kVecPerRow, v = idx % kVecPerRow;
      copy_chunk<T, D>(Qs + r * LD, row_ptr(r), v);
    }
  }

  // Stage one key tile: key_ptr(kk, which) gives key kk's K (which = 0)
  // or V (which = 1) row, or null for a key that is not loaded.
  template <typename KeyPtr>
  __device__ void load_kv(KeyPtr key_ptr) {
    for (int idx = threadIdx.x; idx < kBK * kVecPerRow; idx += kThreads) {
      const int kk = idx / kVecPerRow, v = idx % kVecPerRow;
      copy_chunk<T, D>(Ks + kk * LD, key_ptr(kk, 0), v);
      copy_chunk<T, D>(Vs + kk * LD, key_ptr(kk, 1), v);
    }
  }

  // Fold the staged tile into the running state. visible(r, kk) says
  // whether row r sees key kk of this tile. Call between __syncthreads
  // after load_kv; it ends with the tile's shared memory free to reuse.
  template <typename Visible>
  __device__ void update(float scale, Visible visible) {
    const int tid = threadIdx.x;
    __syncthreads();                      // K/V tile staged
    {
      // S = Q K^T * scale, masked to -1e30
      const int rg = tid / 8, kg = tid % 8;
      float s[SR][SK];
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) s[i][j] = 0.f;
      constexpr int kStep = 16 / sizeof(T);
#pragma unroll 2
      for (int d = 0; d < D; d += kStep) {
        float q[SR][kStep];
#pragma unroll
        for (int i = 0; i < SR; ++i) load_f<kStep>(Qs + (rg + 16 * i) * LD + d, q[i]);
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          float kv[kStep];
          load_f<kStep>(Ks + (kg + 8 * j) * LD + d, kv);
#pragma unroll
          for (int i = 0; i < SR; ++i)
#pragma unroll
            for (int e = 0; e < kStep; ++e) s[i][j] = fmaf(q[i][e], kv[e], s[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < SR; ++i)
#pragma unroll
        for (int j = 0; j < SK; ++j) {
          const int r = rg + 16 * i, kk = kg + 8 * j;
          Ps[r * LDP + kk] = visible(r, kk) ? s[i][j] * scale : kNegInf;
        }
    }
    __syncthreads();
    {
      // online softmax: new max, p = exp(s - m_new), row sums, correction
      const int r = tid / TPR, part = tid % TPR;
      float* prow = Ps + r * LDP;
      float bmax = kNegInf;
#pragma unroll
      for (int i = 0; i < KPT; ++i) bmax = fmaxf(bmax, prow[part + TPR * i]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        bmax = fmaxf(bmax, __shfl_xor_sync(0xffffffffu, bmax, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, bmax);
      const bool alive = m_new > kNegInf / 2;
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kk = part + TPR * i;
        const float p = alive ? expf(prow[kk] - m_new) : 0.f;
        prow[kk] = p;
        psum += p;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      const float corr = alive ? expf(m_old - m_new) : 0.f;
      __syncwarp();
      if (part == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + psum;
        c_s[r] = corr;
      }
    }
    __syncthreads();
    {
      // acc = acc * corr + P V
      const int rg = tid / 16, c0 = (tid % 16) * OC;
#pragma unroll
      for (int i = 0; i < OR; ++i) {
        const float corr = c_s[rg + 8 * i];
#pragma unroll
        for (int e = 0; e < OC; ++e) acc[i][e] *= corr;
      }
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        float v[OC];
        load_f<OC>(Vs + kk * LD + c0, v);
#pragma unroll
        for (int i = 0; i < OR; ++i) {
          const float p = Ps[(rg + 8 * i) * LDP + kk];
#pragma unroll
          for (int e = 0; e < OC; ++e) acc[i][e] = fmaf(p, v[e], acc[i][e]);
        }
      }
    }
    __syncthreads();                      // tile consumed: K/V/P reusable
  }

  // Write out = acc / max(l, 1e-30) and lse. out_ptr(r) / lse_ptr(r) give
  // row r's destinations, or null for a row outside the problem.
  template <typename OutPtr, typename LsePtr>
  __device__ void finish(OutPtr out_ptr, LsePtr lse_ptr) {
    const int tid = threadIdx.x;
    __syncthreads();
    const int rg = tid / 16, c0 = (tid % 16) * OC;
#pragma unroll
    for (int i = 0; i < OR; ++i) {
      const int r = rg + 8 * i;
      T* dst = out_ptr(r);
      if (dst == nullptr) continue;
      const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
      for (int e = 0; e < OC; ++e) from_f(acc[i][e] / l, dst + c0 + e);
    }
    if (tid < BR) {
      float* dst = lse_ptr(tid);
      if (dst != nullptr) {
        const float m = m_s[tid];
        *dst = m > kNegInf / 2 ? m + logf(fmaxf(l_s[tid], 1e-30f)) : kNegInf;
      }
    }
  }
};

}  // namespace dstt

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
