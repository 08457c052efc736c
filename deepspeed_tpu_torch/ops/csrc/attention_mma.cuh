// Tensor-core building blocks of the bf16 flash-attention kernels (K1's
// forward in flash_attention.cu, K3's backward in flash_attention_bwd.cu),
// the FlashAttention-2 design on mma.sync:
//   - tiles of 64 rows of a [B, T, NH, D] tensor (one head) move from
//     device memory to shared memory with 16-byte cp.async, zero-filled
//     past the tensor's end, into rows padded by 16 bytes so that ldmatrix
//     reads 8 rows without bank conflicts (a 256-byte stride would put all
//     8 on the same banks);
//   - ldmatrix builds the mma.sync m16n8k16 operands (bf16 in, fp32
//     accumulation) from those rows, plain or transposed;
//   - an m16n8 fp32 accumulator tile rounds to bf16 in registers and, two
//     tiles side by side, is the A operand of the next product (P or dS
//     never goes through shared memory).
// The fragment helpers repeat grouped_tile.cuh's (proven on the card by the
// grouped kernels); that header's unnamed-namespace helpers would clash
// with attention_tile.cuh's, which the fp32 kernels of the same files use.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {
namespace mma {

using bf16 = __nv_bfloat16;

constexpr int kTile = 64;      // rows of a streamed tile (keys or queries)
// warps a block; each owns 16 rows (or two m16 tiles: K1's forward) of the
// block's queries or keys. 8 warps measured slower in every kernel.
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// padded shared row stride of a D-wide bf16 tile, in elements
template <int D>
struct Tile {
  static_assert(D == 64 || D == 128, "head_dim must be 64 or 128");
  static constexpr int LD = D + 8;
  static constexpr int kChunks = D / 8;   // 16-byte chunks of a row
};

// 16-byte copy global → shared, in flight until cp_async_wait; zeros
// instead when !valid (src is then not read, but must be a mapped address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte copy global → shared (one fp32), zeros when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start loading rows [0, ROWS) of a tile: row r is base + r * stride (D
// bf16 values), zeros for r >= valid_rows. All threads of the block call it.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride, int valid_rows) {
  constexpr int C = Tile<D>::kChunks;
  for (int i = threadIdx.x; i < ROWS * C; i += blockDim.x) {
    const int r = i / C, c = i % C;
    const bool ok = r < valid_rows;
    cp_async16(dst + r * Tile<D>::LD + c * 8, ok ? base + r * stride + c * 8
                                                 : base, ok);
  }
}

// The operands of mma.sync m16n8k16 (row.col), for lane `lane`:
//   A 16x16: a[0] (row g, cols 2t, 2t+1), a[1] (row g+8), a[2] (row g,
//            cols +8), a[3] (row g+8, cols +8), g = lane / 4, t = lane % 4
//   B 16x8:  b[0] (k 2t, 2t+1; col g), b[1] (k +8)
//   C 16x8:  c[0], c[1] (row g, cols 2t, 2t+1), c[2], c[3] (row g+8)

// A from a row-major tile (m rows, k columns): rows m0..m0+15, cols k0..+15
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, int lane) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(
      s + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// B for two n8 tiles (n0..n0+7 in b[0..1], n0+8.. in b[2..3]) at k0..k0+15
// from a tile stored n-major (row n holds the k values: K or V rows for
// S = Q K^T, Q or dO rows for S^T = K Q^T)
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(
      s + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
      ((lane >> 3) & 1) * 8));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(p));
}

// B for two n8 tiles at k0..k0+15 from a tile stored k-major (row k holds
// the n values: V rows for O = P V, K rows for dQ = dS K, Q or dO rows for
// dK = dS^T Q, dV = P^T dO), through the transposing ldmatrix
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* s,
                                          int ld, int n0, int k0, int lane) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(
      s + (k0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
      : "r"(p));
}

// c += a · (b0, b1)
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand over k = 16 j .. 16 j + 15 from the fp32 accumulators of
// n8 tiles 2 j and 2 j + 1 (rows stay rows, their columns become k)
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c0)[4],
                                         const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// acc (16 rows, ND n8 tiles) += A · B: A 16 x 16 KS from registers (one
// operand per 16 of k), B rows k0 .. k0 + 16 KS - 1 of a k-major tile
template <int ND, int KS>
__device__ __forceinline__ void mma_a_regs(float (&acc)[ND][4],
                                           const uint32_t (&a)[KS][4],
                                           const bf16* s, int ld, int k0,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n = 0; n < ND; n += 2) {
      uint32_t b[4];
      load_b_kn(b, s, ld, n * 8, k0 + kk * 16, lane);
      mma_bf16(acc[n], a[kk], b[0], b[1]);
      mma_bf16(acc[n + 1], a[kk], b[2], b[3]);
    }
}

// acc[mt][NN][4] = rows m0 + 16 mt .. + 15 of A (a row-major tile, D
// columns) times the n-major tile B's rows n0 .. n0 + 8 NN - 1, over all D,
// for MT m16 tiles of A; each B fragment is loaded once for all MT
template <int D, int MT, int NN>
__device__ __forceinline__ void mma_smem_mt(float (&acc)[MT][NN][4],
                                            const bf16* A, int m0,
                                            const bf16* B, int n0, int lane) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < NN; ++n)
      acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) load_a(a[mt], A, LD, m0 + 16 * mt, k, lane);
#pragma unroll
    for (int n = 0; n < NN; n += 2) {
      uint32_t b[4];
      load_b_nk(b, B, LD, n0 + n * 8, k, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(acc[mt][n], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][n + 1], a[mt], b[2], b[3]);
      }
    }
  }
}

// mma_smem_mt for one m16 tile
template <int D, int NN>
__device__ __forceinline__ void mma_smem(float (&acc)[NN][4], const bf16* A,
                                         int m0, const bf16* B, int n0,
                                         int lane) {
  mma_smem_mt<D, 1, NN>(reinterpret_cast<float(&)[1][NN][4]>(acc), A, m0, B,
                        n0, lane);
}

// Write a warp's 16 rows of fp32 accumulators (cols 0..D) as bf16: first
// into its own rows m0.. of the shared tile `s`, then 16 bytes a lane to
// rows m0 + r of dst (base + r * stride) for r < valid_rows.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4],
                                           float scale_lo, float scale_hi,
                                           bf16* s, int m0, bf16* base,
                                           long long stride, int valid_rows,
                                           int lane) {
  constexpr int LD = Tile<D>::LD, C = Tile<D>::kChunks;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(s + (m0 + g) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0] * scale_lo, acc[n][1] * scale_lo);
    *reinterpret_cast<uint32_t*>(s + (m0 + g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2] * scale_hi, acc[n][3] * scale_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i % C;
    if (r < valid_rows)
      *reinterpret_cast<uint4*>(base + r * stride + c * 8) =
          *reinterpret_cast<const uint4*>(s + (m0 + r) * LD + c * 8);
  }
}

}  // namespace mma
}  // namespace dstt
