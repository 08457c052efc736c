// Symmetric int8 block quantizer for Hopper (sm_90a): a flat tensor viewed
// as [nb, block] rows; each row gets scale = max|x| · fl(1/127) (fp32) and
// q = clip(round_half_even(x / scale), -127, 127) as int8, with a zero
// scale dividing by 1 instead.
//
// Replaces the TPU kernel _quant_kernel of deepspeed_tpu/ops/quantizer.py
// (:131, launched by quantize_blocks_pallas :140), whose compiled
// arithmetic it repeats step for step: the absmax in fp32, the scale as
// absmax times 1/127 rounded to fp32 (XLA rewrites the kernel's division
// by the constant 127 so), the IEEE division x / scale, __float2int_rn's
// round-half-to-even (jnp.round); q and the scales come out bit-identical.
//
// One warp owns one row (block values): it reads the row with 16-byte
// loads where the row allows them, reduces the absmax with shuffles, then
// reads the row again (from L1) to quantize it and writes 4 or 8 int8 per
// lane at once. 8 warps a block.
//
// What bounds it on the H100: bytes. A row of 256 bf16 reads 512 bytes and
// writes 260, with ~3 operations per value; at the size ZeRO++ quantizes
// (a 1.24 B-value gradient) that is 3.7 GB, 1.1 ms at 3.35 TB/s.
#include "grouped_tile.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
quantize_blocks_kernel(const T* x, int8_t* q, float* s, long long nb,
                       int block, int vec) {
  constexpr int V = 16 / sizeof(T);
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= nb) return;
  const T* xr = x + row * block;
  int8_t* qr = q + row * block;
  float amax = 0.f;
  if (vec) {
    for (int c = lane * V; c < block; c += 32 * V) {
      float f[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr + c)), f);
#pragma unroll
      for (int i = 0; i < V; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
  } else {
    for (int c = lane; c < block; c += 32)
      amax = fmaxf(amax, fabsf(to_f(xr[c])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float scale = amax * (1.0f / 127.0f);
  const float safe = scale > 0.f ? scale : 1.0f;
  auto quant = [&](float v) -> int8_t {
    return (int8_t)max(-127, min(127, __float2int_rn(v / safe)));
  };
  if (vec) {
    for (int c = lane * V; c < block; c += 32 * V) {
      float f[V];
      unpack<T>(__ldg(reinterpret_cast<const uint4*>(xr + c)), f);
      uint32_t wd[V / 4] = {};
#pragma unroll
      for (int i = 0; i < V; ++i)
        wd[i / 4] |= (uint32_t)(uint8_t)quant(f[i]) << (8 * (i % 4));
      if constexpr (V == 8)
        *reinterpret_cast<uint2*>(qr + c) = make_uint2(wd[0], wd[1]);
      else
        *reinterpret_cast<uint32_t*>(qr + c) = wd[0];
    }
  } else {
    for (int c = lane; c < block; c += 32) qr[c] = quant(to_f(xr[c]));
  }
  if (lane == 0) s[row] = scale;
}

template <typename T>
int launch(const void* x, void* q, void* s, long long nb, int block,
           cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec = block % V == 0 && aligned16(x) && aligned16(q);
  const long long blocks = (nb + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  quantize_blocks_kernel<T><<<(unsigned)blocks, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q),
      static_cast<float*>(s), nb, block, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x [nb * block] (dtype 0 fp32, 1 bf16) → q int8 [nb * block], s fp32
// [nb]. Returns cudaGetLastError() after the launch.
extern "C" int dstt_quantize_blocks(const void* x, void* q, void* s,
                                    long long nb, int block, int dtype,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb < 0 || block <= 0) return (int)cudaErrorInvalidValue;
  if (nb == 0) return (int)cudaSuccess;
  if (dtype == 0) return launch<float>(x, q, s, nb, block, st);
  if (dtype == 1) return launch<__nv_bfloat16>(x, q, s, nb, block, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dstt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
