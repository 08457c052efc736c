// Paged attention over the blocked KV arena for Hopper (sm_90a) — kernel
// K2 of the port.
//
// Replaces the TPU kernel _paged_kernel (deepspeed_tpu/ops/paged_attention.py:235),
// launched by paged_attention (:333) and paged_attention_with_lse (:388).
// For sequence i and kv head kh, query row = g_idx * c + j (the GQA group
// times the chunk, :350-352) attends arena key position p iff
// p <= starts[i] + j and p < starts[i] + counts[i] (:295-300), walking the
// sequence's pages through its page-table row. counts = 0 gives the
// history-only read. A sequence with no key gives out = 0, lse = -1e30
// (:326-330). Padded rows (j >= counts[i]) attend [0, ctx) and stay finite.
//
// Layout: q/out [n, c, H, dh]; arena k/v [kvh, NB, bs, dh] (the flat
// pool of every layer, NB = L * (num_blocks + 1)); page table [n, mb]
// int32 of absolute block ids; starts/counts [n] int32; lse [n, c, H].
//
// The TPU kernel keeps all g * c rows in one program; at c = 256, g = 4
// that is 1024 rows x 128 fp32 of accumulator, which no SM holds. So the
// rows are tiled: grid (ceil(g * c / BR), kvh, n) with BR = 16 rows for
// decode-sized problems (g * c <= 16) and 64 otherwise. The block loads
// its own page-table entries (no scalar prefetch) and walks keys in tiles
// of 64 positions up to min(ctx, last visible position of its rows,
// mb * bs); each key's row address comes from the page table, so any
// block_size that is a multiple of 8 works.
//
// What bounds it on the H100: decode is bound by bytes — a step must read
// every live K/V page once (2 * ctx * kvh * dh * itemsize per sequence)
// and does ~4 g FLOP per byte read. The design reads each live page once
// per (sequence, kv head, row tile) — once in total at decode — with
// 16-byte loads, and stops at the sequence's true length rather than the
// padded page-table width. Its weakness at decode is parallelism: one
// block per (sequence, kv head) walks the whole context alone (no split
// over the keys yet), so a short batch fills few SMs. Products are fp32
// FMA on the CUDA cores; tensor cores are later work.
#include "attention_tile.cuh"

using namespace dstt;

namespace {

template <typename T, int D, int BR>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ ak,
                  const T* __restrict__ av, const int* __restrict__ pt,
                  const int* __restrict__ starts,
                  const int* __restrict__ counts, T* __restrict__ out,
                  float* __restrict__ lse, int c, int H, int KvH, int NB,
                  int bs, int mb, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  AttnTile<T, D, BR> tile(smem);
  const int s = blockIdx.z, kh = blockIdx.y;
  const int g = H / KvH;
  const int rows = g * c;
  const int r0 = blockIdx.x * BR;
  const int r1 = min(r0 + BR, rows) - 1;
  const int start = starts[s];
  const int ctx = start + counts[s];

  auto row = [&](int r) -> long long {       // q/out/lse row, -1 outside
    const int R = r0 + r;
    if (R >= rows) return -1LL;
    const int gi = R / c, j = R % c;
    return ((long long)s * c + j) * H + kh * g + gi;
  };
  tile.load_q([&](int r) -> const T* {
    const long long o = row(r);
    return o < 0 ? nullptr : q + o * D;
  });

  // largest chunk offset j among this tile's rows
  const int jmax = (r1 - r0 + 1 >= c || r0 % c > r1 % c) ? c - 1 : r1 % c;
  const int k_end = min(min(ctx, start + jmax + 1), mb * bs);
  const int* pt_row = pt + (long long)s * mb;

  for (int kt = 0; kt < k_end; kt += kBK) {
    tile.load_kv([&](int kk, int which) -> const T* {
      const int p = kt + kk;
      if (p >= k_end) return nullptr;
      const long long page = pt_row[p / bs];
      return (which ? av : ak) + (((long long)kh * NB + page) * bs + p % bs) * D;
    });
    tile.update(scale, [&](int r, int kk) {
      const int kpos = kt + kk;
      return kpos < k_end && kpos <= start + (r0 + r) % c;
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

template <typename T, int D, int BR>
int launch(const void* q, const void* ak, const void* av, const void* pt,
           const void* starts, const void* counts, void* out, void* lse,
           int n, int c, int H, int KvH, int NB, int bs, int mb, float scale,
           cudaStream_t stream) {
  const int smem = (int)AttnTile<T, D, BR>::smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      paged_attn_kernel<T, D, BR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = (H / KvH) * c;
  const dim3 grid((rows + BR - 1) / BR, KvH, n);
  paged_attn_kernel<T, D, BR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(ak),
      static_cast<const T*>(av), static_cast<const int*>(pt),
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      static_cast<T*>(out), static_cast<float*>(lse), c, H, KvH, NB, bs, mb,
      scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_rows(const void* q, const void* ak, const void* av, const void* pt,
                const void* starts, const void* counts, void* out, void* lse,
                int n, int c, int H, int KvH, int NB, int bs, int mb,
                float scale, cudaStream_t stream) {
  if ((H / KvH) * c <= 16)
    return launch<T, D, 16>(q, ak, av, pt, starts, counts, out, lse, n, c, H,
                            KvH, NB, bs, mb, scale, stream);
  return launch<T, D, 64>(q, ak, av, pt, starts, counts, out, lse, n, c, H,
                          KvH, NB, bs, mb, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Always writes lse (paged_attention
// drops it). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for an unsupported dtype / head_dim).
extern "C" int dstt_paged_attention(
    const void* q, const void* ak, const void* av, const void* pt,
    const void* starts, const void* counts, void* out, void* lse, int n,
    int c, int H, int KvH, int D, int NB, int bs, int mb, int dtype,
    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_rows<float, 64>(q, ak, av, pt, starts, counts, out, lse, n, c, H, KvH, NB, bs, mb, scale, st);
  if (dtype == 0 && D == 128)
    return launch_rows<float, 128>(q, ak, av, pt, starts, counts, out, lse, n, c, H, KvH, NB, bs, mb, scale, st);
  if (dtype == 1 && D == 64)
    return launch_rows<__nv_bfloat16, 64>(q, ak, av, pt, starts, counts, out, lse, n, c, H, KvH, NB, bs, mb, scale, st);
  if (dtype == 1 && D == 128)
    return launch_rows<__nv_bfloat16, 128>(q, ak, av, pt, starts, counts, out, lse, n, c, H, KvH, NB, bs, mb, scale, st);
  return (int)cudaErrorInvalidValue;
}
