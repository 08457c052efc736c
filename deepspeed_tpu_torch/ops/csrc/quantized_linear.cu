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
// One templated kernel serves all three (template: x dtype and weight
// format; the group is blockIdx.z, 1 for the dense forms).
//
// A block owns a BM x BN tile of out and walks K in steps of 64 logical
// rows. A step covers 64 / P packed rows of the weight, where P is the
// number of logical rows one packed row holds (1 for int8/fp8, 2 for int4,
// 4 for fp6): the block loads those rows' bytes with 16-byte loads, decodes
// them into a [64, BN] tile of x's type in shared memory (plane q of packed
// row r becomes tile row q·64/P + r), and loads the matching x columns
// (plane q of packed row r is x column q·K/P + r) into a [BM, 64] tile in
// the same order, so one product over the 64 tile rows sums every plane.
// int8, fp8-e4m3, int4 and e3m2 values are all exact in bf16, so the
// decode loses nothing. The scale multiplies the fp32 sum once in the
// epilogue, which writes fp32, bf16 or fp16. Masked loads (zeros past M,
// N and each plane's K/P rows) and masked stores take every M, K and N;
// there is no tile gate and no fallback.
//   bf16 x: tensor cores, mma.sync m16n8k16 with fp32 accumulation, BN 128;
//           each of the 4 warps owns 32 rows x 64 columns.
//   fp32 x: fp32 FMA on the CUDA cores (the JAX kernel's dot of fp32 x and
//           a bf16 weight tile promotes to fp32), BN 64; each thread owns
//           4 rows x 8 columns.
// Each step's tiles are loaded into registers one step ahead and stored to
// shared memory while the previous step is consumed. Offsets are 64-bit.
//
// What bounds it on the H100: at decode (M 8-16) the weight bytes — Llama-3
// 8B's 4096 x 14336 MLP matrix is 58.7 MB in int8, 17.5 us at 3.35 TB/s —
// against 2·M·K·N operations that the tensor cores do in under 2 us. With
// 128 columns a block, N = 4096 gives 32 blocks on 132 SMs and N = 14336
// 112, one step of bytes in flight each: far from the card's bandwidth.
// At prefill (M 2048) the operations bound it (0.24 ms for that matrix at
// 989 TFLOP/s) and m-tiles run fastest (blockIdx.x), so the blocks in
// flight share one weight tile in L2. Split-K, more steps in flight, wgmma
// and TMA are later work.
#include <cuda_fp16.h>

#include "grouped_tile.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BM = 64;    // rows of out per block
constexpr int BKL = 64;   // logical K rows per step (all planes together)

enum Fmt { kInt8 = 0, kFp8 = 1, kInt4 = 2, kFp6 = 3 };

// logical rows per packed row, and byte planes per packed row
template <int F> struct Format {
  static constexpr int P = F == kInt4 ? 2 : (F == kFp6 ? 4 : 1);
  static constexpr int NBY = F == kFp6 ? 3 : 1;
};

struct Args {
  const void* x;        // [G, M, K] of TX
  const uint8_t* w;     // [G, NBY, K/P, N] bytes
  const float* scale;   // [G, N]
  void* out;            // [G, M, N] of out_dtype
  int M, K, N, kp;      // kp = K / P
  int out_dtype;        // 0 fp32, 1 bf16, 2 fp16
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

// The P logical values held by byte column i of a packed row's byte
// planes b[0..NBY-1] (16 columns each), plane by plane.
template <int F>
__device__ __forceinline__ void decode(const uint8_t* const* b, int i,
                                       float* v) {
  if constexpr (F == kInt8) {
    v[0] = (float)(int8_t)b[0][i];
  } else if constexpr (F == kFp8) {
    v[0] = e4m3_to_f(b[0][i]);
  } else if constexpr (F == kInt4) {
    const int p = b[0][i];
    v[0] = (float)(((p & 15) ^ 8) - 8);          // row r
    v[1] = (float)((((p >> 4) & 15) ^ 8) - 8);   // row K/2 + r
  } else {
    const uint32_t r0 = b[0][i], r1 = b[1][i], r2 = b[2][i];
    v[0] = e3m2_to_f(r0 >> 2);
    v[1] = e3m2_to_f(((r0 & 3u) << 4) | (r1 >> 4));
    v[2] = e3m2_to_f(((r1 & 15u) << 2) | (r2 >> 6));
    v[3] = e3m2_to_f(r2 & 63u);
  }
}

template <typename TX, int F>
__global__ void __launch_bounds__(kThreads) qmm_kernel(const Args a) {
  constexpr bool kMMA = std::is_same<TX, __nv_bfloat16>::value;
  constexpr int P = Format<F>::P, NBY = Format<F>::NBY;
  constexpr int BKP = BKL / P;                       // packed rows per step
  constexpr int BN = kMMA ? 128 : 64;                // out columns per block
  constexpr int VX = 16 / sizeof(TX);                // x values per 16 bytes
  constexpr int CX = BM * BKL / VX / kThreads;       // x chunks per thread
  constexpr int UNITS = BKP * (BN / 16);             // 16-byte weight units
  constexpr int CW = (UNITS + kThreads - 1) / kThreads;
  constexpr int VS = 16 / sizeof(TX);                // tile values per 16 B
  constexpr int LDA = BKL + VS, LDB = BN + VS;       // padded by 16 bytes
  constexpr int NT = BN / 16;  // MMA: n8 tiles per warp (2 x 2 warps)
  constexpr int NJ = BN / 32;  // FMA: float4 column groups per thread
  __shared__ __align__(16) TX As[BM * LDA];
  __shared__ __align__(16) TX Bs[BKL * LDB];

  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const long long g = blockIdx.z;
  const int M = a.M, K = a.K, N = a.N, kp = a.kp;
  const TX* x = static_cast<const TX*>(a.x) + g * M * (long long)K;
  const uint8_t* w = a.w + g * (long long)NBY * kp * N;
  const float* scale = a.scale + g * N;
  const int tid = threadIdx.x;

  uint4 rx[CX], rw[CW][NBY];
  // step t covers packed rows r0 .. r0 + BKP - 1
  auto load_tiles = [&](int r0) {
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = tid + i * kThreads;
      const int row = c / (BKL / VX), lc = (c % (BKL / VX)) * VX;
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
      const int row = c / (BKL / VX), lc = (c % (BKL / VX)) * VX;
      *reinterpret_cast<uint4*>(As + row * LDA + lc) = rx[i];
    }
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int u = tid + j * kThreads;
      if (u >= UNITS) continue;
      const int r = u / (BN / 16), cc = (u % (BN / 16)) * 16;
      const uint8_t* b[NBY];
#pragma unroll
      for (int p = 0; p < NBY; ++p)
        b[p] = reinterpret_cast<const uint8_t*>(&rw[j][p]);
#pragma unroll
      for (int h = 0; h < 16; h += VS) {   // VS columns → one 16-byte store
        float v[P][VS];
#pragma unroll
        for (int e = 0; e < VS; ++e) {
          float d[P];
          decode<F>(b, h + e, d);
#pragma unroll
          for (int q = 0; q < P; ++q) v[q][e] = d[q];
        }
#pragma unroll
        for (int q = 0; q < P; ++q)
          *reinterpret_cast<uint4*>(Bs + (q * BKP + r) * LDB + cc + h) =
              pack<TX>(v[q]);
      }
    }
  };

  constexpr int A0 = kMMA ? 2 : 4, A1 = kMMA ? NT : 4 * NJ, A2 = kMMA ? 4 : 1;
  float acc[A0][A1][A2];
#pragma unroll
  for (int i = 0; i < A0; ++i)
#pragma unroll
    for (int j = 0; j < A1; ++j)
#pragma unroll
      for (int z = 0; z < A2; ++z) acc[i][j][z] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;     // MMA: 2 x 2 warps
  const int ty = tid / 8, tx = tid % 8;       // FMA: 16 x 8 threads
  constexpr int WN = BN / 2;                  // MMA: columns per warp

  const int nk = (kp + BKP - 1) / BKP;
  load_tiles(0);
  for (int t = 0; t < nk; ++t) {
    store_tiles();
    __syncthreads();
    if (t + 1 < nk) load_tiles((t + 1) * BKP);
    if constexpr (kMMA) {
#pragma unroll
      for (int kk = 0; kk < BKL; kk += 16) {
        uint32_t fa[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(fa[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * LDA +
                                  kk + (lane >> 4) * 8);
        uint32_t fb[NT][2];
#pragma unroll
        for (int p = 0; p < NT / 2; ++p) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, Bs + (kk + (lane & 15)) * LDB + wn * WN +
                                   p * 16 + (lane >> 4) * 8);
          fb[2 * p][0] = r[0];
          fb[2 * p][1] = r[1];
          fb[2 * p + 1][0] = r[2];
          fb[2 * p + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[mi][ni], fa[mi], fb[ni]);
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < BKL; ++k) {
        float av[4], bv[4 * NJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = to_f(As[(ty + 16 * i) * LDA + k]);
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
          for (int q = 0; q < 4 * NJ; ++q) acc[i][q][0] += av[i] * bv[q];
      }
    }
    __syncthreads();
  }

  // epilogue: out = acc · scale[col] in fp32, cast once; rows past M and
  // columns past N are dropped
  const long long obase = g * M * (long long)N;
  auto put = [&](int row, int col, float v) {
    if (row >= M || col >= N) return;
    const long long o = obase + (long long)row * N + col;
    const float y = v * scale[col];
    if (a.out_dtype == 0) static_cast<float*>(a.out)[o] = y;
    else if (a.out_dtype == 1)
      static_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16(y);
    else static_cast<__half*>(a.out)[o] = __float2half_rn(y);
  };
  if constexpr (kMMA) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
#pragma unroll
        for (int ni = 0; ni < NT; ++ni) {
          const int col = n0 + wn * WN + ni * 8 + (lane & 3) * 2;
          put(row, col, acc[mi][ni][2 * h]);
          put(row, col + 1, acc[mi][ni][2 * h + 1]);
        }
      }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4 * NJ; ++q)
        put(m0 + ty + 16 * i, n0 + tx * 4 + (q / 4) * 32 + q % 4,
            acc[i][q][0]);
  }
}

template <typename TX, int F>
int launch_as(Args a, int G, cudaStream_t stream) {
  constexpr int P = Format<F>::P, NBY = Format<F>::NBY;
  constexpr int BN = std::is_same<TX, __nv_bfloat16>::value ? 128 : 64;
  constexpr int VX = 16 / sizeof(TX);
  a.kp = a.K / P;
  a.vec_x = a.K % VX == 0 && a.kp % VX == 0 && aligned16(a.x);
  a.vec_w = a.N % 16 == 0 && aligned16(a.w);
  const dim3 grid((a.M + BM - 1) / BM, (a.N + BN - 1) / BN, G);
  if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
  (void)NBY;
  qmm_kernel<TX, F><<<grid, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX>
int launch_fmt(const Args& a, int G, int fmt, cudaStream_t stream) {
  switch (fmt) {
    case kInt8: return launch_as<TX, kInt8>(a, G, stream);
    case kFp8: return launch_as<TX, kFp8>(a, G, stream);
    case kInt4: return launch_as<TX, kInt4>(a, G, stream);
    case kFp6: return launch_as<TX, kFp6>(a, G, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// fmt: 0 int8, 1 fp8-e4m3, 2 int4, 3 fp6-e3m2; x_dtype: 0 fp32, 1 bf16;
// out_dtype: 0 fp32, 1 bf16, 2 fp16.
int launch(const void* x, const void* w, const void* scale, void* out, int G,
           int M, int K, int N, int fmt, int x_dtype, int out_dtype,
           void* stream) {
  const int planes = fmt == kInt4 ? 2 : (fmt == kFp6 ? 4 : 1);
  if (G < 1 || M < 0 || K < 0 || N < 0 || K % planes || out_dtype < 0 ||
      out_dtype > 2)
    return (int)cudaErrorInvalidValue;
  if (M == 0 || N == 0) return (int)cudaSuccess;
  Args a{x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
         out, M, K, N, 0, out_dtype, 0, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_fmt<float>(a, G, fmt, st);
  if (x_dtype == 1) return launch_fmt<__nv_bfloat16>(a, G, fmt, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each returns cudaGetLastError() after its launch (cudaErrorInvalidValue
// for a format, dtype or shape it does not take).
//
// out [M, N] = (x [M, K] · w [K, N]) ⊙ scale [N]; w int8 or fp8 (fmt 0, 1).
extern "C" int dstt_quantized_matmul(const void* x, const void* w,
                                     const void* scale, void* out, int G,
                                     int M, int K, int N, int fmt,
                                     int x_dtype, int out_dtype,
                                     void* stream) {
  if (G != 1 || (fmt != kInt8 && fmt != kFp8))
    return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, G, M, K, N, fmt, x_dtype, out_dtype,
                stream);
}

// out [G, M, N] = (x [G, M, K] · W[g]) ⊙ scale [G, N], W int4 [K/2, N] or
// fp6 [3, K/4, N] per group (fmt 2, 3); G = 1 is the dense form.
extern "C" int dstt_quantized_matmul_packed(const void* x, const void* w,
                                            const void* scale, void* out,
                                            int G, int M, int K, int N,
                                            int fmt, int x_dtype,
                                            int out_dtype, void* stream) {
  if (fmt != kInt4 && fmt != kFp6) return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, G, M, K, N, fmt, x_dtype, out_dtype,
                stream);
}

// out [G, M, N] = (x [G, M, K] · w [G, K, N]) ⊙ scale [G, N]; w int8 or
// fp8 (fmt 0, 1).
extern "C" int dstt_quantized_matmul_batched(const void* x, const void* w,
                                             const void* scale, void* out,
                                             int G, int M, int K, int N,
                                             int fmt, int x_dtype,
                                             int out_dtype, void* stream) {
  if (fmt != kInt8 && fmt != kFp8) return (int)cudaErrorInvalidValue;
  return launch(x, w, scale, out, G, M, K, N, fmt, x_dtype, out_dtype,
                stream);
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
