// Tile helpers shared by the grouped GEMM kernels of the dropless MoE FFN
// (grouped_matmul.cu, forward; grouped_matmul_bwd.cu, backward;
// grouped_wgmma.cuh, their wgmma forms): dtype conversion, the GLU,
// masked 16-byte row loads, the tensor-core fragments (ldmatrix, mma.sync
// m16n8k16 bf16 with fp32 accumulation) and an expert's first tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// silu(x)·u in fp32 with the hardware exp and divide (~2 ulp): the GLU of
// grouped_down's prologue, in every form
__device__ __forceinline__ float silu_mul(float x, float u) {
  return __fdividef(x, 1.0f + __expf(-x)) * u;
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The 16 bytes of row `p` from column c on (16 / sizeof(T) values), zeros
// past column n; one vector load when allowed and whole.
template <typename T>
__device__ __forceinline__ uint4 load_chunk(const T* p, int c, int n,
                                            int vec) {
  constexpr int V = 16 / sizeof(T);
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (vec && c + V <= n) {
    r = __ldg(reinterpret_cast<const uint4*>(p + c));
  } else {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (c + i < n) e[i] = p[c + i];
  }
  return r;
}

template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* f) {
  if constexpr (std::is_same<T, float>::value) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  } else {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(p[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
}

// The inverse of unpack: 16 bytes of T from 16 / sizeof(T) floats, each
// rounded to T.
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 v;
  if constexpr (std::is_same<T, float>::value) {
    v = make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                   __float_as_uint(f[2]), __float_as_uint(f[3]));
  } else {
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  }
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// first index in the non-decreasing got[0, n) not below v: where expert v's
// tiles start in group_of_tile
__device__ __forceinline__ int lower_bound(const int* got, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (got[mid] < v) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace
