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
// Every arena offset is 64-bit: a full-size serving arena's last layer
// lies past element 2^31.
//
// Three forms, picked per call from the shapes alone by
// ops/paged_attention.plan (never from starts/counts: no device→host sync):
//
//   split (g * c <= 16 rows a kv head: decode; bf16 and fp32) —
//     flash-decoding. Bound by bytes: a step reads every live K/V page once
//     (2 ctx kvh dh itemsize a sequence) and does ~4 g FLOP a byte read,
//     far under the card's ~295. So the design is about bytes in flight on
//     every SM: grid (splits, kvh, n), a block takes the GQA group's g * c
//     live rows of one kv head (so each K/V byte is read once for all g
//     heads) and one split of the keys, whole 64-key tiles (and whole pages
//     when bs >= 64), the split count chosen from mb * bs so that the grid
//     holds 2-4 blocks a SM. Keys arrive through a cp.async ring of
//     64-key K/V tiles (3 stages in bf16, 2 in fp32), 16-byte loads, the
//     next tiles in flight while one is computed; a tile inside one page
//     (bs % 64 == 0) has one base address, else each key row looks up its
//     page. Each warp owns 16 keys of a tile and keeps its own online
//     softmax (two lanes a key for Q K^T, a lane per dh/32 columns for
//     P V, P through the warp's shared slots), so a tile needs no block
//     barrier beyond the ring's; the four warps merge at the end. Products
//     are fp32 FMA. A split past a sequence's ctx returns at once: it
//     issues no load, writes nothing and takes no part in the combine. A
//     sequence whose keys fit one split writes out directly; else each
//     live split writes its partial (out, lse) in fp32 to a workspace, and
//     the last of them to arrive (an atomicAdd on the (sequence, kv head)
//     counter after __threadfence) combines them with merge_attention's
//     arithmetic and resets the counter to 0: one launch.
//   mma (bf16, g * c > 16 rows: split-prefill history, chunks) — bound by
//     operations (4 dh visible-pairs FLOP: ~100 a byte at the serving
//     path's 256-token chunks), so it runs on the tensor cores, K1's
//     design (attention_mma.cuh): 4 warps x 32 rows (the GQA group x chunk
//     packed per kv head, so each K/V tile feeds all g heads), Q staged
//     once in shared memory, a 2-stage cp.async K/V ring, ldmatrix
//     operands, mma.sync m16n8k16 with fp32 accumulators, an exp2 online
//     softmax in registers, P rounded to bf16 as the A operand of P V.
//     K/V rows come through the page table; the walk ends at the tile's
//     last visible key. Masks run only on tiles that straddle ctx or a
//     row's causal edge.
//   fma (fp32, g * c > 16) — the first kernel, on attention_tile.cuh's fp32
//     FMA (64 rows a block), which the fp32 parity checks hold to 1e-4.
#include "attention_mma.cuh"
#include "attention_tile.cuh"

using namespace dstt;

namespace {

// Kernel arguments, shared by the three forms.
struct Args {
  const void* q;
  const void* ak;
  const void* av;
  const int* pt;
  const int* starts;
  const int* counts;
  void* out;
  float* lse;
  float* ws;            // split: partials, [n, kvh, splits, rows, dh + 1]
  int* counters;        // split: arrivals [n, kvh], 0 between launches
  int c, H, KvH, NB, bs, mb;
  int splits, split_keys;
  float scale;
};

// Row offset (in rows of dh values) of query row r = gi * c + j of
// sequence s and kv head kh in q/out ([n, c, H, dh]); lse uses the same.
__device__ __forceinline__ long long qrow(int s, int kh, int r, int c, int H,
                                          int g) {
  return ((long long)s * c + r % c) * H + kh * g + r / c;
}

// Arena row (in rows of dh values) of key position p of sequence row
// pt_row, kv head kh.
__device__ __forceinline__ long long krow(const int* pt_row, int kh, int p,
                                          int NB, int bs) {
  return ((long long)kh * NB + pt_row[p / bs]) * bs + p % bs;
}

// ---------------------------------------------------------------------------
// fma: the first kernel (fp32)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// split: flash-decoding over key splits
// ---------------------------------------------------------------------------

template <typename T>
struct SplitRing {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
};

// 16 bytes of T at p (shared memory) widened to fp32
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// N (2 or 4) values of T at p (shared memory, aligned to N values) as fp32
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    load16(p, v);
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}
template <int N>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float (&v)[N]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

template <typename T, int D>
constexpr size_t split_smem_bytes(int rm) {
  return sizeof(T) * (size_t)SplitRing<T>::kStages * 2 * kBK * (D + 16 / sizeof(T)) +
         sizeof(float) * ((size_t)rm * 2 * (D / 2 + 4) + 4 * 16 * rm);
}

// RM: rows a block holds (a power of two >= g * c, at most 16)
template <typename T, int D, int RM>
__global__ void __launch_bounds__(kThreads)
paged_attn_split_kernel(Args a) {
  constexpr int kVec = 16 / (int)sizeof(T);     // values a 16-byte chunk
  constexpr int kChunks = D / kVec;             // chunks a K/V row
  constexpr int LDK = D + kVec;                 // padded K/V row stride
  constexpr int HALF = D / 2;                   // dh columns a lane's half
  constexpr int LDQ = HALF + 4;                 // padded fp32 q half-row
  constexpr int CPL = D / 32;                   // P V columns a lane
  constexpr int STAGES = SplitRing<T>::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);         // STAGES x {K, V} x 64 keys
  float* Qs = reinterpret_cast<float*>(ring + STAGES * 2 * kBK * LDK);
  float* Ps = Qs + RM * 2 * LDQ;                // 4 warps x 16 keys x RM
  __shared__ int last;

  const T* K = static_cast<const T*>(a.ak);
  const T* V = static_cast<const T*>(a.av);
  const int split = blockIdx.x, kh = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = a.H / a.KvH, rows = g * a.c;
  const int start = a.starts[s], ctx = start + a.counts[s];
  // every row j < c sits in the block: the walk ends at min(ctx, the last
  // row's last visible key + 1, the page table's width)
  const int k_end = min(min(ctx, start + a.c), a.mb * a.bs);
  // splits that hold keys; a split past them returns at once, and with at
  // most one (or none: split 0 writes the zeros) the block writes out itself
  const int live = (k_end + a.split_keys - 1) / a.split_keys;
  if (split > 0 && split >= live) return;
  const bool direct = live <= 1;
  const int lo = split * a.split_keys;
  const int hi = min(lo + a.split_keys, k_end);
  const int n_tiles = hi > lo ? (hi - lo + kBK - 1) / kBK : 0;
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)
  // partial (split, r) of this (sequence, kv head) in the workspace
  const long long part0 = ((long long)s * a.KvH + kh) * a.splits;
  const long long n_parts = (long long)gridDim.z * a.KvH * a.splits * rows;
  float* ws_lse = direct ? nullptr : a.ws + n_parts * D;

  // Q as fp32, each row's two dh halves padded apart; rows >= rows zero
  for (int i = tid; i < RM * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float v = 0.f;
    if (r < rows)
      v = to_f(static_cast<const T*>(a.q)[qrow(s, kh, r, a.c, a.H, g) * D + d]);
    Qs[(r * 2 + d / HALF) * LDQ + d % HALF] = v;
  }
  const int* pt_row = a.pt + (long long)s * a.mb;
  const bool tile_page = a.bs % kBK == 0;   // a 64-key tile in one page
  auto load_tile = [&](int i) {
    if (i < n_tiles) {
      const int kt = lo + i * kBK;
      T* Kd = ring + (i % STAGES) * 2 * kBK * LDK;
      T* Vd = Kd + kBK * LDK;
      const long long base = tile_page ? krow(pt_row, kh, kt, a.NB, a.bs) : 0;
      for (int e = tid; e < kBK * kChunks; e += kThreads) {
        const int kk = e / kChunks, ch = e % kChunks, p = kt + kk;
        const bool ok = p < hi;
        long long o = 0;
        if (ok) o = (tile_page ? base + kk : krow(pt_row, kh, p, a.NB, a.bs)) * D;
        mma::cp_async16(Kd + kk * LDK + ch * kVec, K + o + ch * kVec, ok);
        mma::cp_async16(Vd + kk * LDK + ch * kVec, V + o + ch * kVec, ok);
      }
    }
    mma::cp_async_commit();                 // empty groups keep the count
  };
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_tile(i);

  // this lane's key in a tile (two lanes a key, one dh half each) and
  // each row's last visible position
  const int kk = warp * 16 + (lane & 15), hf = lane >> 4;
  int lim[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) lim[r] = r < rows ? start + r % a.c : -1;
  // the warp's own online softmax over its 16 keys of every tile
  float m_r[RM], l_r[RM], acc[RM][CPL];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_r[r] = kNegInf;
    l_r[r] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[r][e] = 0.f;
  }
  float* Pw = Ps + warp * 16 * RM;

  for (int i = 0; i < n_tiles; ++i) {
    mma::cp_async_wait<STAGES - 2>();
    // tile i (and Q) staged by every thread; every warp is done with
    // tile i - 1, whose stage now takes tile i + STAGES - 1
    __syncthreads();
    load_tile(i + STAGES - 1);
    const T* Kt = ring + (i % STAGES) * 2 * kBK * LDK;
    const T* Vt = Kt + kBK * LDK;
    const int p = lo + i * kBK + kk;

    // S = q . k over this lane's half of dh, then the two halves summed
    float sc[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) sc[r] = 0.f;
    const T* kr = Kt + kk * LDK + hf * HALF;
    const float* qh = Qs + hf * LDQ;
#pragma unroll 4
    for (int d = 0; d < HALF; d += kVec) {
      float kv[kVec];
      load16(kr + d, kv);
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int e = 0; e < kVec; e += 4) {
          float qv[4];
          load16(qh + r * 2 * LDQ + d + e, qv);
          sc[r] = fmaf(qv[0], kv[e], sc[r]);
          sc[r] = fmaf(qv[1], kv[e + 1], sc[r]);
          sc[r] = fmaf(qv[2], kv[e + 2], sc[r]);
          sc[r] = fmaf(qv[3], kv[e + 3], sc[r]);
        }
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      sc[r] += __shfl_xor_sync(0xffffffffu, sc[r], 16);
      if (!(p < hi && p <= lim[r])) sc[r] = kNegInf;
      // online softmax over the warp's 16 keys (lanes l and l ^ 16
      // hold the same key, so offsets below 16 reduce them)
      float mx = sc[r];
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_r[r], mx);
      // a row that has seen no key yet keeps p = 0 and corr = 0
      const bool alive = m_new > kNegInf / 2;
      const float corr = alive ? exp2f((m_r[r] - m_new) * sl2) : 0.f;
      const float pr = alive ? exp2f((sc[r] - m_new) * sl2) : 0.f;
      float sum = pr;
#pragma unroll
      for (int off = 8; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l_r[r] = l_r[r] * corr + sum;
      m_r[r] = m_new;
#pragma unroll
      for (int e = 0; e < CPL; ++e) acc[r][e] *= corr;
      sc[r] = pr;
    }
    if (lane < 16)
#pragma unroll
      for (int r = 0; r < RM; ++r) Pw[lane * RM + r] = sc[r];
    __syncwarp();
    // acc += P V over the warp's 16 keys, CPL columns a lane
#pragma unroll 4
    for (int k2 = 0; k2 < 16; ++k2) {
      float v[CPL];
      load_cols<CPL>(Vt + (warp * 16 + k2) * LDK + lane * CPL, v);
      const float* pp = Pw + k2 * RM;
#pragma unroll
      for (int r = 0; r < RM; ++r) {
        const float pr = pp[r];
#pragma unroll
        for (int e = 0; e < CPL; ++e) acc[r][e] = fmaf(pr, v[e], acc[r][e]);
      }
    }
    __syncwarp();                            // P slots free
  }
  mma::cp_async_wait<0>();
  __syncthreads();                           // the ring is free

  // merge the four warps' states through the ring's shared memory
  float* Mw = reinterpret_cast<float*>(smem);    // [4][RM]
  float* Lw = Mw + 4 * RM;                       // [4][RM]
  float* Aw = Lw + 4 * RM;                       // [4][RM][D]
  if (lane == 0)
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      Mw[warp * RM + r] = m_r[r];
      Lw[warp * RM + r] = l_r[r];
    }
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int e = 0; e < CPL; ++e)
      Aw[(warp * RM + r) * D + lane * CPL + e] = acc[r][e];
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) M = fmaxf(M, Mw[w * RM + r]);
    const bool alive = M > kNegInf / 2;
    float L = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float ew = alive ? exp2f((Mw[w * RM + r] - M) * sl2) : 0.f;
      L = fmaf(ew, Lw[w * RM + r], L);
      o = fmaf(ew, Aw[(w * RM + r) * D + d], o);
    }
    L = fmaxf(L, 1e-30f);
    const float ov = o / L;
    const float lv = alive ? M * a.scale + logf(L) : kNegInf;
    if (direct) {
      const long long row = qrow(s, kh, r, a.c, a.H, g);
      from_f(ov, static_cast<T*>(a.out) + row * D + d);
      if (d == 0) a.lse[row] = lv;
    } else {
      const long long pi = (part0 + split) * rows + r;
      a.ws[pi * D + d] = ov;
      if (d == 0) ws_lse[pi] = lv;
    }
  }

  if (direct) return;

  // the last live split of this (sequence, kv head) to arrive combines
  // the live splits as merge_attention does
  __threadfence();
  __syncthreads();
  int* counter = a.counters + (long long)s * a.KvH + kh;
  if (tid == 0) last = atomicAdd(counter, 1) == live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float M = kNegInf;
    for (int sp = 0; sp < live; ++sp)
      M = fmaxf(M, __ldcg(ws_lse + (part0 + sp) * rows + r));
    float den = 0.f, num = 0.f;
    for (int sp = 0; sp < live; ++sp) {
      const long long pi = (part0 + sp) * rows + r;
      const float w = expf(__ldcg(ws_lse + pi) - M);
      den += w;
      num = fmaf(w, __ldcg(a.ws + pi * D + d), num);
    }
    const long long row = qrow(s, kh, r, a.c, a.H, g);
    from_f(num / fmaxf(den, 1e-30f), static_cast<T*>(a.out) + row * D + d);
    if (d == 0) a.lse[row] = M > kNegInf / 2 ? M + logf(den) : kNegInf;
  }
  if (tid == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// mma: bf16 on the tensor cores (K1's design through the page table)
// ---------------------------------------------------------------------------

// each warp owns MT m16 tiles of rows, so each K/V fragment feeds MT tiles
constexpr int kMmaMTiles = 2, kMmaRows = 16 * kMmaMTiles * mma::kWarps;

template <int D>
__global__ void __launch_bounds__(mma::kThreads, 2)
paged_attn_mma_kernel(Args a) {
  using mma::bf16;
  constexpr int MT = kMmaMTiles, BR = kMmaRows, BK = mma::kTile;
  constexpr int LD = mma::Tile<D>::LD, C = mma::Tile<D>::kChunks;
  constexpr int ND = D / 8, NK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BR * LD;                  // 2 stages
  bf16* Vs = Ks + 2 * BK * LD;              // 2 stages
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* K = static_cast<const bf16*>(a.ak);
  const bf16* V = static_cast<const bf16*>(a.av);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tg = lane & 3, m0 = warp * 16 * MT;
  const int kh = blockIdx.y, s = blockIdx.z;
  const int grp = a.H / a.KvH, rows = grp * a.c, c = a.c;
  const int r0 = blockIdx.x * BR;
  const int r1 = min(r0 + BR, rows) - 1;
  const int start = a.starts[s], ctx = start + a.counts[s];
  const float sl2 = a.scale * 1.4426950408889634f;   // scale * log2(e)

  // the chunk offsets j = r % c of the block's rows span [jmin, jmax]
  const bool all_j = r1 - r0 + 1 >= c || r0 % c > r1 % c;
  const int jmin = all_j ? 0 : r0 % c, jmax = all_j ? c - 1 : r1 % c;
  const int k_end = min(min(ctx, start + jmax + 1), a.mb * a.bs);
  const int n_tiles = (k_end + BK - 1) / BK;
  const int* pt_row = a.pt + (long long)s * a.mb;
  const bool tile_page = a.bs % BK == 0;     // a 64-key tile in one page

  for (int i = threadIdx.x; i < BR * C; i += blockDim.x) {
    const int r = i / C, ch = i % C, R = r0 + r;
    const bool ok = R < rows;
    const bf16* src = ok ? q + qrow(s, kh, R, c, a.H, grp) * D + ch * 8 : q;
    mma::cp_async16(Qs + r * LD + ch * 8, src, ok);
  }
  mma::cp_async_commit();
  auto load_kv = [&](int i) {
    const int kt = i * BK;
    bf16* Kd = Ks + (i & 1) * BK * LD;
    bf16* Vd = Vs + (i & 1) * BK * LD;
    const long long base = tile_page ? krow(pt_row, kh, kt, a.NB, a.bs) : 0;
    for (int e = threadIdx.x; e < BK * C; e += blockDim.x) {
      const int kk = e / C, ch = e % C, p = kt + kk;
      const bool ok = p < k_end;
      long long o = 0;
      if (ok) o = (tile_page ? base + kk : krow(pt_row, kh, p, a.NB, a.bs)) * D;
      mma::cp_async16(Kd + kk * LD + ch * 8, K + o + ch * 8, ok);
      mma::cp_async16(Vd + kk * LD + ch * 8, V + o + ch * 8, ok);
    }
    mma::cp_async_commit();
  };
  if (n_tiles > 0) load_kv(0);

  // the last visible key of rows m0 + 16 mt + g (hf 0) and + 8 (hf 1)
  int lim[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      lim[mt][hf] = start + (r0 + m0 + 16 * mt + g + 8 * hf) % c;
  float o[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
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
    const int kt = i * BK;

    // S = Q K^T (raw, unscaled)
    float sc[MT][NK][4];
    mma::mma_smem_mt<D, MT, NK>(sc, Qs, m0, Kt, 0, lane);

    // mask only a tile that straddles k_end or some row's last key
    if (kt + BK > k_end || kt + BK - 1 > start + jmin) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + n * 8 + 2 * tg + (e & 1);
            if (!(kp < k_end && kp <= lim[mt][e >> 1])) sc[mt][n][e] = kNegInf;
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
          mx = fmaxf(mx, fmaxf(sc[mt][n][2 * hf], sc[mt][n][2 * hf + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[mt][hf], mx);
        // a row that has seen no key yet keeps p = 0 and corr = 0
        const bool alive = m_new > kNegInf / 2;
        const float corr = alive ? exp2f((m_run[mt][hf] - m_new) * sl2) : 0.f;
        const float base = m_new * sl2;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n)
#pragma unroll
          for (int e = 2 * hf; e < 2 * hf + 2; ++e) {
            const float p = alive ? exp2f(fmaf(sc[mt][n][e], sl2, -base)) : 0.f;
            sc[mt][n][e] = p;
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
        mma::acc_to_a(pa[mt], sc[mt][2 * kk], sc[mt][2 * kk + 1]);
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
  // that saw no key; rows go out through the warp's own Q rows, 16 bytes
  // a lane to each row's place in [n, c, H, dh]
  bf16* out = static_cast<bf16*>(a.out);
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
      const int R = r0 + m0 + 16 * mt + g + hf * 8;
      if (tg == 0 && R < rows)
        a.lse[qrow(s, kh, R, c, a.H, grp)] =
            m_run[mt][hf] > kNegInf / 2 ? m_run[mt][hf] * a.scale + logf(l)
                                        : kNegInf;
    }
    const int rm = m0 + 16 * mt;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(Qs + (rm + g) * LD + n * 8 + 2 * tg) =
          mma::pack_bf16(o[mt][n][0] * inv[0], o[mt][n][1] * inv[0]);
      *reinterpret_cast<uint32_t*>(Qs + (rm + g + 8) * LD + n * 8 + 2 * tg) =
          mma::pack_bf16(o[mt][n][2] * inv[1], o[mt][n][3] * inv[1]);
    }
    __syncwarp();
    for (int i = lane; i < 16 * C; i += 32) {
      const int r = i / C, ch = i % C, R = r0 + rm + r;
      if (R < rows)
        *reinterpret_cast<uint4*>(out + qrow(s, kh, R, c, a.H, grp) * D + ch * 8) =
            *reinterpret_cast<const uint4*>(Qs + (rm + r) * LD + ch * 8);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
int set_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int D>
int launch_fma(const Args& a, int n, cudaStream_t stream) {
  constexpr int BR = 64;
  const size_t smem = AttnTile<T, D, BR>::smem_bytes();
  if (int err = set_smem(paged_attn_kernel<T, D, BR>, smem)) return err;
  const int rows = (a.H / a.KvH) * a.c;
  const dim3 grid((rows + BR - 1) / BR, a.KvH, n);
  paged_attn_kernel<T, D, BR><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.ak),
      static_cast<const T*>(a.av), a.pt, a.starts, a.counts,
      static_cast<T*>(a.out), a.lse, a.c, a.H, a.KvH, a.NB, a.bs, a.mb,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D, int RM>
int launch_split_rm(const Args& a, int n, cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T, D>(RM);
  if (int err = set_smem(paged_attn_split_kernel<T, D, RM>, smem)) return err;
  const dim3 grid(a.splits, a.KvH, n);
  paged_attn_split_kernel<T, D, RM><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_split(const Args& a, int n, cudaStream_t stream) {
  const int rows = (a.H / a.KvH) * a.c;
  if (rows <= 1) return launch_split_rm<T, D, 1>(a, n, stream);
  if (rows <= 2) return launch_split_rm<T, D, 2>(a, n, stream);
  if (rows <= 4) return launch_split_rm<T, D, 4>(a, n, stream);
  if (rows <= 8) return launch_split_rm<T, D, 8>(a, n, stream);
  return launch_split_rm<T, D, 16>(a, n, stream);
}

template <int D>
int launch_mma(const Args& a, int n, cudaStream_t stream) {
  const size_t smem =
      sizeof(mma::bf16) * (size_t)(kMmaRows + 4 * mma::kTile) * mma::Tile<D>::LD;
  if (int err = set_smem(paged_attn_mma_kernel<D>, smem)) return err;
  const int rows = (a.H / a.KvH) * a.c;
  const dim3 grid((rows + kMmaRows - 1) / kMmaRows, a.KvH, n);
  paged_attn_mma_kernel<D><<<grid, mma::kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_form(const Args& a, int n, int form, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4)
    if (form == 0) return launch_fma<T, D>(a, n, stream);
  return launch_split<T, D>(a, n, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. form (ops/paged_attention.FORMS): 0 =
// fma (fp32, more than 16 rows a kv head), 1 = split (at most 16 rows),
// 2 = mma (bf16, more than 16 rows). splits / split_keys: the split form's
// key splits (split_keys a multiple of 64); with splits > 1, ws holds the
// fp32 partials [n, kvh, splits, rows, dh + 1] and counters the int32
// arrivals [n, kvh], all 0 between launches. Always writes lse
// (paged_attention drops it). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a dtype, head_dim, form or plan it does not
// take).
extern "C" int dstt_paged_attention(
    const void* q, const void* ak, const void* av, const void* pt,
    const void* starts, const void* counts, void* out, void* lse, void* ws,
    void* counters, int n, int c, int H, int KvH, int D, int NB, int bs,
    int mb, int dtype, int form, int splits, int split_keys, float scale,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = KvH > 0 ? (H / KvH) * c : 0;
  const bool split_ok = rows <= 16 && splits >= 1 && split_keys > 0 &&
                        split_keys % kBK == 0 &&
                        (splits == 1 || (ws != nullptr && counters != nullptr));
  if ((form == 1 && !split_ok) || (form == 0 && (dtype != 0 || rows <= 16)) ||
      (form == 2 && (dtype != 1 || rows <= 16)) || form < 0 || form > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{q, ak, av, static_cast<const int*>(pt),
               static_cast<const int*>(starts), static_cast<const int*>(counts),
               out, static_cast<float*>(lse), static_cast<float*>(ws),
               static_cast<int*>(counters), c, H, KvH, NB, bs, mb, splits,
               split_keys, scale};
  if (form == 2 && D == 64) return launch_mma<64>(a, n, st);
  if (form == 2 && D == 128) return launch_mma<128>(a, n, st);
  if (dtype == 0 && D == 64) return launch_form<float, 64>(a, n, form, st);
  if (dtype == 0 && D == 128) return launch_form<float, 128>(a, n, form, st);
  if (dtype == 1 && D == 64) return launch_form<__nv_bfloat16, 64>(a, n, form, st);
  if (dtype == 1 && D == 128) return launch_form<__nv_bfloat16, 128>(a, n, form, st);
  return (int)cudaErrorInvalidValue;
}
