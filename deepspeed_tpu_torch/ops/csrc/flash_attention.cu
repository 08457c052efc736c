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
// Grid: (ceil(Tq / 64), H, B). A block owns 64 query rows and walks key
// tiles of 64 from the window's first live tile to the causal bound; dead
// tiles are skipped by the loop bound, as _fwd_kernel does (:86-101).
// Ragged Tq/Tk are masked in the kernel. Rows with no visible key give
// out = 0 and lse = -1e30.
//
// What bounds it on the H100: at the serving path's 256-token chunks the
// work is small — per (sequence of 256, 32 q heads, d = 128), causal:
// 4 d * H * T (T + 1) / 2 = 0.54 GFLOP against 5.2 MB of q/k/v/out in bf16,
// about 100 FLOP per byte, under the bf16 tensor-core ridge (~295) — so
// bytes bound the ideal kernel. This first kernel does its products as
// fp32 FMA on the CUDA cores (67 TFLOP/s peak), which makes operations
// its real limit; the design keeps each K/V tile in shared memory for all
// 64 rows of the block, so a key is read from device memory (or L2) once
// per 64-row query tile and query head that sees it.
// Tensor cores (mma.sync / wgmma) and TMA are the next step.
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

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
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
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, tq, tk, H, KvH, causal, q_offset, window, scale, st);
  return (int)cudaErrorInvalidValue;
}
