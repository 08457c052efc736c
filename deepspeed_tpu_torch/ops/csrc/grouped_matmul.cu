// Grouped SwiGLU FFN for Hopper (sm_90a) — the grouped GEMM kernels of the
// port's dropless MoE layer.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/grouped_matmul.py:
//   grouped_gate_up  ← _gate_up_kernel (:328): gate = xs·wg[g], up = xs·wi[g],
//                      both from ONE load of each xs tile (the TPU kernel's
//                      fusion of the two products, which halves the
//                      activation reads), written in xs's dtype;
//   grouped_down     ← _down_w_kernel (:352) and _down_kernel (:341):
//                      y = diag(w)·(silu(gate)·up)·wo[g], with h =
//                      silu(gate)·up formed in the prologue of each k-tile
//                      (fp32, rounded to wo's dtype) so that h [R, f] never
//                      reaches device memory; w (optional, per row) scales
//                      the fp32 sum before the cast.
//
// Layout (aligned_dispatch in ops/grouped_matmul.py): rows are sorted by
// expert and each expert's rows start on a bm-row tile boundary, so a
// 64-row kernel tile (bm is a multiple of 64) belongs to one expert,
// g = group_of_tile[m0 / bm]. Tiles at or past live_tiles[0] * bm hold no
// row: their blocks return at once and write nothing, so those output rows
// stay unspecified. The grid covers the static worst case R_pad; the host
// never learns how many tiles are live.
//
// Forms. ops/grouped_matmul.py `plan` picks each kernel's form from the
// dtype and shape and passes it in; the entry points refuse a form the
// dtype does not take, and nothing falls back:
//   fma   (fp32): plain fp32 FMA on the CUDA cores, the instantiation the
//         parity checks hold to 1e-4;
//   wgmma (bf16 where TMA can address every operand: f and d multiples of
//         8, 16-byte-aligned xs, wg, wi (gate_up) or gate, up and wo
//         (down)): grouped_wgmma.cuh — a TMA ring, two consumer
//         warpgroups on wgmma m64n256k16; gate_up: 128 rows by 128 columns
//         of gate and of up a block (wg's and wi's columns side by side as
//         one 256-column B), the column tiles fastest, or in bands of
//         row blocks where an expert's weights outgrow L2 (`band`, from
//         plan);
//         down: 128 x 256 tiles, h formed in registers as wgmma's A;
//   mma   (any other bf16): mma.sync m16n8k16 from register-staged tiles.
//
// The mma.sync and FMA kernels: 64 rows x 64 columns of gate and of up
// (gate_up), or 64 rows x 128 columns of y (down), per block; k-steps of
// 32; 128 threads. Each k-tile is loaded from device memory into registers
// one step ahead (masked: zeros past K and N, so any d and f work) and
// stored to shared memory while the previous one is consumed. Offsets are
// 64-bit. bf16: each of the 4 warps owns a quarter of the block (32 rows
// by half its columns, per product); fp32: each thread owns 4 rows and
// BN / 8 columns (per product).
//
// What bounds them on the H100: at the Mixtral prefill shape (2048 tokens,
// top-2, d 4096, f 14336) the two kernels do 6·d·f = 352 MFLOP per row
// against ~2.8 GB of expert weights and ~0.3 GB of activations: 1.44 TFLOP,
// 1.46 ms at the bf16 tensor-core peak against ~0.9 ms for the bytes, so
// operations bound them. mma.sync from register-staged tiles issues and
// moves too much through shared memory to approach that: grouped_down ran
// at 127 TFLOP/s (3.772 ms at Mixtral), gate_up at ~200 (4.719 ms). The
// wgmma form of down takes ~1.4 ms there (~350 TFLOP/s; PERF.md §6), held
// by the bytes of gate, up and wo each step moves; gate_up's moves 48 KB
// a 4.2 MFLOP step, as dxs's does (grouped_wgmma.cuh). The mma.sync and
// FMA kernels walk the row tiles fastest (blockIdx.x), so the blocks in
// flight share each expert's weight tiles in L2.
#include "grouped_tile.cuh"
#include "grouped_wgmma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BM = 64;   // rows per block (a multiple of it divides bm)
constexpr int BK = 32;   // reduction depth per step
// output columns per block and product: 64 for gate/up (two products),
// 128 for down (one), so both give each warp 32 x 64 outputs. The wider
// down tile also halves how often each h value is recomputed (once per
// 128 columns of d).
constexpr int BN_GATE_UP = 64, BN_DOWN = 128;

// bf16 runs on the tensor cores; flip to false for plain FMA in bf16 too
constexpr bool kBf16TensorCores = true;

template <typename T>
struct Operands {
  const T* a;          // xs [rows, K] | gate [rows, K]
  const T* a2;         // nullptr      | up [rows, K]
  const T* b[2];       // wg, wi [E, K, N] | wo [E, K, N], nullptr
  T* out[2];           // gate, up [rows, N] | y [rows, N], nullptr
  const T* w;          // per-row scale of the down product, or nullptr
  const int* group_of_tile;
  const int* live_tiles;
  int K, N, bm;
  int vec_a, vec_b;    // 16-byte loads along K (A) and along N (B) allowed
};

// h = silu(gate) * up in fp32, rounded to T (wo's dtype), per element.
// The hardware exp and divide (~2 ulp): h is formed once per k-tile per
// 128 output columns, so its cost is that of the tile's products.
template <typename T, int V>
__device__ __forceinline__ void glu(const uint4& g, const uint4& u, float* h) {
  float gf[V], uf[V];
  unpack<T>(g, gf);
  unpack<T>(u, uf);
#pragma unroll
  for (int i = 0; i < V; ++i) h[i] = to_f(from_f<T>(silu_mul(gf[i], uf[i])));
}

// kMMA: tensor cores (bf16 only), else fp32 FMA. kGLU: A is silu(gate)·up
// formed from two inputs (the down kernel), else A is read as it is.
// NB: number of B operands (2 for gate/up, 1 for down); BN: columns per
// block of each.
template <typename T, bool kMMA, bool kGLU, int NB, int BN>
__global__ void __launch_bounds__(kThreads)
grouped_gemm_kernel(const Operands<T> op) {
  static_assert(!kMMA || std::is_same<T, __nv_bfloat16>::value,
                "the tensor-core path is bf16");
  constexpr int V = 16 / sizeof(T);                 // values per 16 bytes
  constexpr int CA = BM * BK / V / kThreads;        // A chunks per thread
  constexpr int CB = BK * BN / V / kThreads;        // B chunks per thread
  constexpr int NT = BN / 16;       // MMA: n8 tiles per warp (2 x 2 warps)
  constexpr int NJ = BN / 32;       // FMA: float4 column groups per thread
  // shared-memory rows padded by 16 bytes (bank spread, 16-byte alignment)
  using S = typename std::conditional<kMMA, T, float>::type;
  constexpr int LDA = BK + 16 / (int)sizeof(S);
  constexpr int LDB = BN + 16 / (int)sizeof(S);
  __shared__ __align__(16) S As[BM * LDA];
  __shared__ __align__(16) S Bs[NB][BK * LDB];

  const int m0 = blockIdx.x * BM;
  if ((long long)m0 >= (long long)op.live_tiles[0] * op.bm) return;
  const long long g = op.group_of_tile[m0 / op.bm];
  const int n0 = blockIdx.y * BN;
  const int K = op.K, N = op.N;
  const int tid = threadIdx.x;

  uint4 ra[CA], ra2[kGLU ? CA : 1], rb[NB][CB];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / V), cc = (c % (BK / V)) * V;
      const long long row = (long long)(m0 + r) * K;
      ra[i] = load_chunk(op.a + row, k0 + cc, K, op.vec_a);
      if constexpr (kGLU) ra2[i] = load_chunk(op.a2 + row, k0 + cc, K, op.vec_a);
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (BN / V), cc = (c % (BN / V)) * V;
        const int kk = k0 + r;
        rb[j][i] = kk < K ? load_chunk(op.b[j] + (g * K + kk) * N, n0 + cc,
                                       N, op.vec_b)
                          : make_uint4(0u, 0u, 0u, 0u);
      }
  };
  auto store_tiles = [&]() {
#pragma unroll
    for (int i = 0; i < CA; ++i) {
      const int c = tid + i * kThreads;
      const int r = c / (BK / V), cc = (c % (BK / V)) * V;
      S* dst = As + r * LDA + cc;
      if constexpr (kMMA) {
        if constexpr (kGLU) {
          float h[V];
          glu<T, V>(ra[i], ra2[i], h);
          *reinterpret_cast<uint4*>(dst) = pack<T>(h);
        } else {
          *reinterpret_cast<uint4*>(dst) = ra[i];
        }
      } else {
        float f[V];
        if constexpr (kGLU) glu<T, V>(ra[i], ra2[i], f);
        else unpack<T>(ra[i], f);
#pragma unroll
        for (int q = 0; q < V; q += 4)
          *reinterpret_cast<float4*>(dst + q) =
              make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < CB; ++i) {
        const int c = tid + i * kThreads;
        const int r = c / (BN / V), cc = (c % (BN / V)) * V;
        S* dst = Bs[j] + r * LDB + cc;
        if constexpr (kMMA) {
          *reinterpret_cast<uint4*>(dst) = rb[j][i];
        } else {
          float f[V];
          unpack<T>(rb[j][i], f);
#pragma unroll
          for (int q = 0; q < V; q += 4)
            *reinterpret_cast<float4*>(dst + q) =
                make_float4(f[q], f[q + 1], f[q + 2], f[q + 3]);
        }
      }
  };

  // accumulators: MMA [op][m16 tile][n8 tile][4], FMA [op][row][col]
  constexpr int A0 = kMMA ? 2 : 4, A1 = kMMA ? NT : 4 * NJ, A2 = kMMA ? 4 : 1;
  float acc[NB][A0][A1][A2];
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int x = 0; x < A0; ++x)
#pragma unroll
      for (int y = 0; y < A1; ++y)
#pragma unroll
        for (int z = 0; z < A2; ++z) acc[j][x][y][z] = 0.f;

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;          // MMA: 2 x 2 warps
  const int ty = tid / 8, tx = tid % 8;            // FMA: 16 x 8 threads
  constexpr int WN = BN / 2;                       // MMA: columns per warp

  const int nk = (K + BK - 1) / BK;
  load_tiles(0);
  for (int t = 0; t < nk; ++t) {
    store_tiles();
    __syncthreads();
    if (t + 1 < nk) load_tiles((t + 1) * BK);
    if constexpr (kMMA) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldmatrix_x4(a[mi], As + (wm * 32 + mi * 16 + (lane & 15)) * LDA +
                                 kk + (lane >> 4) * 8);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          uint32_t b[NT][2];
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t r[4];
            ldmatrix_x4_trans(r, Bs[j] + (kk + (lane & 15)) * LDB + wn * WN +
                                     p * 16 + (lane >> 4) * 8);
            b[2 * p][0] = r[0];
            b[2 * p][1] = r[1];
            b[2 * p + 1][0] = r[2];
            b[2 * p + 1][1] = r[3];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int ni = 0; ni < NT; ++ni) mma_bf16(acc[j][mi][ni], a[mi], b[ni]);
        }
      }
    } else {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[(ty + 16 * i) * LDA + k];
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          float b[4 * NJ];
#pragma unroll
          for (int c = 0; c < NJ; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(
                Bs[j] + k * LDB + tx * 4 + 32 * c);
            b[4 * c] = v.x; b[4 * c + 1] = v.y;
            b[4 * c + 2] = v.z; b[4 * c + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4 * NJ; ++q) acc[j][i][q][0] += a[i] * b[q];
        }
      }
    }
    __syncthreads();
  }

  // epilogue: columns past N are dropped; the down kernel scales each row
  // by w in fp32 before the cast
  auto put = [&](int j, int row, int col, float v, float s) {
    if (col < N) op.out[j][(long long)row * N + col] = from_f<T>(v * s);
  };
  auto scale = [&](int row) -> float {
    if constexpr (kGLU) return op.w != nullptr ? to_f(op.w[row]) : 1.0f;
    return 1.0f;
  };
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if constexpr (kMMA) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = m0 + wm * 32 + mi * 16 + (lane >> 2) + 8 * h;
          const float s = scale(row);
#pragma unroll
          for (int ni = 0; ni < NT; ++ni) {
            const int col = n0 + wn * WN + ni * 8 + (lane & 3) * 2;
            put(j, row, col, acc[j][mi][ni][2 * h], s);
            put(j, row, col + 1, acc[j][mi][ni][2 * h + 1], s);
          }
        }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty + 16 * i;
        const float s = scale(row);
#pragma unroll
        for (int q = 0; q < 4 * NJ; ++q)
          put(j, row, n0 + tx * 4 + (q / 4) * 32 + q % 4, acc[j][i][q][0], s);
      }
    }
  }
}

template <typename T, bool kGLU, int NB, int BN>
int launch(Operands<T> op, int rows, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  if (rows < 0 || op.bm <= 0 || op.bm % BM || rows % op.bm || op.K < 0 ||
      op.N <= 0)
    return (int)cudaErrorInvalidValue;
  op.vec_a = op.K % V == 0 && aligned16(op.a) && aligned16(op.a2);
  op.vec_b = op.N % V == 0 && aligned16(op.b[0]) && aligned16(op.b[1]);
  const dim3 grid(rows / BM, (op.N + BN - 1) / BN);
  if (grid.x == 0) return (int)cudaSuccess;
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  constexpr bool mma = kBf16TensorCores && std::is_same<T, __nv_bfloat16>::value;
  grouped_gemm_kernel<T, mma, kGLU, NB, BN><<<grid, kThreads, 0, stream>>>(op);
  return (int)cudaGetLastError();
}

// the kernel forms of dstt_grouped_gate_up and dstt_grouped_down
// (ops/grouped_matmul.py FORMS)
constexpr int kFma = 0, kMma = 1, kWgmma = 2;

__global__ void __launch_bounds__(dstt::grouped::kThreads, 1)
    grouped_down_wgmma_kernel(const __grid_constant__ dstt::grouped::Maps maps,
        const dstt::grouped::Epilogue ep) {
  dstt::grouped::grouped_wgmma<dstt::grouped::kAGlu, 1, 1>(maps, ep);
}

__global__ void __launch_bounds__(dstt::grouped::kThreads, 1)
    grouped_gate_up_wgmma_kernel(
        const __grid_constant__ dstt::grouped::Maps maps,
        const dstt::grouped::Epilogue ep) {
  dstt::grouped::grouped_wgmma<dstt::grouped::kAK, 1, 1, true>(maps, ep);
}

int gate_up_wgmma(const void* xs, const void* wg, const void* wi,
                  void* gate, void* up, const int* gt, const int* lt,
                  int rows, int d, int f, int bm, int num_experts, int band,
                  cudaStream_t st) {
  namespace G = dstt::grouped;
  const void* tma[3] = {xs, wg, wi};
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || bm <= 0 || bm % 64 || rows % bm || num_experts <= 0 ||
      band <= 0 || !G::tma_ok(d, f, tma, 3))
    return (int)cudaErrorInvalidValue;
  G::Maps maps;
  // xs [rows, d]: boxes [64 rows, 64 k]; wg, wi [E, d, f]: boxes [64 k,
  // 64 n] of one expert (the MN-major B)
  if (!G::map_rows(&maps.a[0], xs, rows, d) ||
      !G::map_experts(&maps.b[0], wg, num_experts, d, f, G::BK, 64) ||
      !G::map_experts(&maps.b[1], wi, num_experts, d, f, G::BK, 64))
    return (int)cudaErrorInvalidValue;
  maps.a[1] = maps.a[0];
  const G::Epilogue ep{static_cast<__nv_bfloat16*>(gate),
                       static_cast<__nv_bfloat16*>(up), nullptr, gt, lt, f,
                       d, bm, band};
  static unsigned smem_done = 0;
  return G::launch<G::kAK, G::BN / 2>(grouped_gate_up_wgmma_kernel, maps, ep,
                                      rows, smem_done, st);
}

int down_wgmma(const void* gate, const void* up, const void* wo,
               const void* w, void* y, const int* gt, const int* lt,
               int rows, int f, int d, int bm, int num_experts,
               cudaStream_t st) {
  namespace G = dstt::grouped;
  const void* tma[3] = {gate, up, wo};
  if (rows == 0) return (int)cudaSuccess;
  if (rows < 0 || bm <= 0 || bm % 64 || rows % bm || num_experts <= 0 ||
      !G::tma_ok(f, d, tma, 3))
    return (int)cudaErrorInvalidValue;
  G::Maps maps;
  // gate, up [rows, f]: boxes [64 rows, 64 k]; wo [E, f, d]: boxes
  // [64 k, 64 n] of one expert (the MN-major B)
  if (!G::map_rows(&maps.a[0], gate, rows, f) ||
      !G::map_rows(&maps.a[1], up, rows, f) ||
      !G::map_experts(&maps.b[0], wo, num_experts, f, d, G::BK, 64))
    return (int)cudaErrorInvalidValue;
  maps.b[1] = maps.b[0];
  const G::Epilogue ep{static_cast<__nv_bfloat16*>(y), nullptr,
                       static_cast<const __nv_bfloat16*>(w), gt, lt, d, f,
                       bm, 1};
  static unsigned smem_done = 0;
  return G::launch<G::kAGlu, G::BN>(grouped_down_wgmma_kernel, maps, ep,
                                    rows, smem_done, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each returns cudaGetLastError() after
// its launch (cudaErrorInvalidValue for an unsupported dtype or shape).
//
// gate, up [rows, f] = xs [rows, d] · wg[g], wi[g] ([E, d, f]) per tile.
// form: 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma (d and f multiples
// of 8, 16-byte-aligned xs, wg and wi; `band` row blocks a band of its
// raster); any other pairing of dtype and form is refused.
extern "C" int dstt_grouped_gate_up(const void* xs, const void* wg,
                                    const void* wi, void* gate, void* up,
                                    const void* group_of_tile,
                                    const void* live_tiles, int rows, int d,
                                    int f, int bm, int num_experts,
                                    int dtype, int form, int band,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gt = static_cast<const int*>(group_of_tile);
  const int* lt = static_cast<const int*>(live_tiles);
  if (dtype == 0 && form == kFma) {
    using T = float;
    Operands<T> op{static_cast<const T*>(xs), nullptr,
                   {static_cast<const T*>(wg), static_cast<const T*>(wi)},
                   {static_cast<T*>(gate), static_cast<T*>(up)}, nullptr,
                   gt, lt, d, f, bm, 0, 0};
    return launch<T, false, 2, BN_GATE_UP>(op, rows, st);
  }
  if (dtype == 1 && form == kMma) {
    using T = __nv_bfloat16;
    Operands<T> op{static_cast<const T*>(xs), nullptr,
                   {static_cast<const T*>(wg), static_cast<const T*>(wi)},
                   {static_cast<T*>(gate), static_cast<T*>(up)}, nullptr,
                   gt, lt, d, f, bm, 0, 0};
    return launch<T, false, 2, BN_GATE_UP>(op, rows, st);
  }
  if (dtype == 1 && form == kWgmma)
    return gate_up_wgmma(xs, wg, wi, gate, up, gt, lt, rows, d, f, bm,
                         num_experts, band, st);
  return (int)cudaErrorInvalidValue;
}

// y [rows, d] = (w ⊙) (silu(gate) · up) · wo[g] ([E, f, d]) per tile;
// w [rows] may be null. form: 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16
// wgmma (f and d multiples of 8, 16-byte-aligned gate, up and wo); any
// other pairing of dtype and form is refused.
extern "C" int dstt_grouped_down(const void* gate, const void* up,
                                 const void* wo, const void* w, void* y,
                                 const void* group_of_tile,
                                 const void* live_tiles, int rows, int f,
                                 int d, int bm, int num_experts, int dtype,
                                 int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* gt = static_cast<const int*>(group_of_tile);
  const int* lt = static_cast<const int*>(live_tiles);
  if (dtype == 0 && form == kFma) {
    using T = float;
    Operands<T> op{static_cast<const T*>(gate), static_cast<const T*>(up),
                   {static_cast<const T*>(wo), nullptr},
                   {static_cast<T*>(y), nullptr}, static_cast<const T*>(w),
                   gt, lt, f, d, bm, 0, 0};
    return launch<T, true, 1, BN_DOWN>(op, rows, st);
  }
  if (dtype == 1 && form == kMma) {
    using T = __nv_bfloat16;
    Operands<T> op{static_cast<const T*>(gate), static_cast<const T*>(up),
                   {static_cast<const T*>(wo), nullptr},
                   {static_cast<T*>(y), nullptr}, static_cast<const T*>(w),
                   gt, lt, f, d, bm, 0, 0};
    return launch<T, true, 1, BN_DOWN>(op, rows, st);
  }
  if (dtype == 1 && form == kWgmma)
    return down_wgmma(gate, up, wo, w, y, gt, lt, rows, f, d, bm,
                      num_experts, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
