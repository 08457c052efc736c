// Hopper (sm_90a) building blocks for kernels that a Tensor Memory
// Accelerator ring feeds and warpgroup MMA multiplies:
//   - mbarriers (init, arrive, arrive with an expected byte count, wait on
//     a phase parity), the named barriers of a subset of warps, and the
//     proxy fence that makes generic-proxy shared stores visible to wgmma;
//   - TMA tile loads (cp.async.bulk.tensor, 4-D) that complete on an
//     mbarrier, and the host side that encodes their tensor maps through
//     libcuda's cuTensorMapEncodeTiled, looked up at run time (no -lcuda);
//   - wgmma shared-memory descriptors for the 128-byte swizzle, and
//     wgmma.mma_async m64n64k16 / m64n128k16 / m64n256k16 bf16 → fp32 with
//     A and B in shared memory (either K-major or MN-major: TRANS_A,
//     TRANS_B), or A in registers;
//   - setmaxnreg, which moves registers from a producer warpgroup to the
//     consumer warpgroups.
// Used by quantized_linear.cu (K5's prefill kernel) and, through
// grouped_wgmma.cuh, by the grouped GEMMs' bf16 wgmma forms; the attention
// kernels can share them too.
//
// Layouts (PTX ISA, "Shared Memory Matrix Layout", 16-bit types, 128-byte
// swizzle: the 16-byte chunk c of 128-byte row r is stored at chunk c ^ (r
// % 8), which TMA's CU_TENSOR_MAP_SWIZZLE_128B writes; tiles 1024-byte
// aligned):
//   - K-major (rows of 64 k values): SBO = 1024 bytes between groups of 8
//     rows, LBO unused; the k16 slice kk starts 32·kk bytes into the row;
//   - MN-major (rows of 64 m or n values, one row a k): SBO = 1024 bytes
//     between groups of 8 k rows, LBO = the bytes between blocks of 64 m
//     or n; the k16 slice kk starts 16 rows (2048 bytes) further.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dstt {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers --------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// after the inits, before any thread uses the barriers
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival, and `bytes` more of transactions (TMA) to complete the phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` has completed (the barrier's
// current phase differs from it). A barrier starts in phase 0, so its
// c-th completion (1-based) is waited for with parity (c - 1) & 1. A wait
// that polls 2^28 times (seconds) traps: a lost arrival becomes a launch
// error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

// --- fences and named barriers ----------------------------------------------

// Generic-proxy shared-memory stores (st.shared) → visible to the async
// proxy (wgmma operands, TMA stores). Each writing thread issues it before
// the barrier that hands the tile over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15; 0 is __syncthreads) among `count` threads, whole warps
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Move this warpgroup's registers a thread to N (a multiple of 8, 24..256):
// a producer warpgroup that needs few gives them up (dec) so the consumer
// warpgroups can take them (inc). Every warp of the warpgroup executes it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// --- TMA ----------------------------------------------------------------------

// Load the box at coordinates (c0, c1, c2, c3) (innermost first) of a 4-D
// tensor map into shared memory `dst`; its bytes complete on `bar`.
// Elements out of the tensor's bounds are filled with zeros (and counted).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units in the descriptor)
__device__ __forceinline__ uint64_t desc_sw128(const void* p, uint32_t lbo,
                                               uint32_t sbo) {
  const uint64_t a = smem_u32(p);
  return ((a & 0x3FFFFull) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N of this warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma (no instruction is emitted)
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[32] += A (64 x 16; K-major, or MN-major when TRANS_A) · B (16 x 64;
// K-major, or MN-major when TRANS_B) for one warpgroup; d laid out as
// wgmma_m64n128k16's d over 64 columns (d[4i + ...], i < 8).
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// d[64] += A (64 x 16; K-major, or MN-major when TRANS_A) · B (16 x 128;
// K-major, or MN-major when TRANS_B) for one warpgroup (d = A · B when
// scale_d is 0). Accumulator layout: warp w of the group owns rows 16w ..
// 16w + 15; d[4i + {0, 1}] are row 16w + lane/4, columns 8i + 2(lane%4) +
// {0, 1}; d[4i + {2, 3}] the same columns 8 rows further.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// uint32 operands of an asynchronous wgmma (A fragments): keeps the
// compiler from reusing their registers before the wgmma that reads them
// has been waited for
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d[64] += A (64 x 16 bf16, from registers) · B (16 x 128; K-major, or
// MN-major when TRANS_B) for one warpgroup. Warp w of the group holds rows
// 16w .. 16w + 15 of A as mma.sync's m16k16 A fragment (what ldmatrix.x4
// gives): a[0] row lane/4, k 2(lane%4) + {0, 1}; a[1] 8 rows further;
// a[2], a[3] the same 8 k further. The registers must stay untouched until
// the wgmma has been waited for.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// d0, d1 (columns 0-127, 128-255 of a 64 x 256 accumulator; each laid out
// as wgmma_m64n128k16's d) += A (64 x 16 in shared memory; K-major, or
// MN-major when TRANS_A) · B (16 x 256; K-major, or MN-major when TRANS_B)
// for one warpgroup: one instruction where two m64n128k16 would read A
// twice.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d0)[64],
                                                 float (&d1)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %132, %131;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]),
        "+f"(d0[14]), "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]),
        "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]),
        "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]), "+f"(d0[25]),
        "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d0[32]), "+f"(d0[33]),
        "+f"(d0[34]), "+f"(d0[35]), "+f"(d0[36]), "+f"(d0[37]),
        "+f"(d0[38]), "+f"(d0[39]), "+f"(d0[40]), "+f"(d0[41]),
        "+f"(d0[42]), "+f"(d0[43]), "+f"(d0[44]), "+f"(d0[45]),
        "+f"(d0[46]), "+f"(d0[47]), "+f"(d0[48]), "+f"(d0[49]),
        "+f"(d0[50]), "+f"(d0[51]), "+f"(d0[52]), "+f"(d0[53]),
        "+f"(d0[54]), "+f"(d0[55]), "+f"(d0[56]), "+f"(d0[57]),
        "+f"(d0[58]), "+f"(d0[59]), "+f"(d0[60]), "+f"(d0[61]),
        "+f"(d0[62]), "+f"(d0[63]), "+f"(d1[0]), "+f"(d1[1]),
        "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]),
        "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]),
        "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]),
        "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]),
        "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]),
        "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]),
        "+f"(d1[31]), "+f"(d1[32]), "+f"(d1[33]), "+f"(d1[34]),
        "+f"(d1[35]), "+f"(d1[36]), "+f"(d1[37]), "+f"(d1[38]),
        "+f"(d1[39]), "+f"(d1[40]), "+f"(d1[41]), "+f"(d1[42]),
        "+f"(d1[43]), "+f"(d1[44]), "+f"(d1[45]), "+f"(d1[46]),
        "+f"(d1[47]), "+f"(d1[48]), "+f"(d1[49]), "+f"(d1[50]),
        "+f"(d1[51]), "+f"(d1[52]), "+f"(d1[53]), "+f"(d1[54]),
        "+f"(d1[55]), "+f"(d1[56]), "+f"(d1[57]), "+f"(d1[58]),
        "+f"(d1[59]), "+f"(d1[60]), "+f"(d1[61]), "+f"(d1[62]),
        "+f"(d1[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B), "n"(TRANS_A));
}

// The same with A from registers (wgmma_m64n128k16_rs's fragments).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d0)[64],
                                                    float (&d1)[64],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, %134;\n"
      "}\n"
      : "+f"(d0[0]), "+f"(d0[1]), "+f"(d0[2]), "+f"(d0[3]), "+f"(d0[4]),
        "+f"(d0[5]), "+f"(d0[6]), "+f"(d0[7]), "+f"(d0[8]), "+f"(d0[9]),
        "+f"(d0[10]), "+f"(d0[11]), "+f"(d0[12]), "+f"(d0[13]),
        "+f"(d0[14]), "+f"(d0[15]), "+f"(d0[16]), "+f"(d0[17]),
        "+f"(d0[18]), "+f"(d0[19]), "+f"(d0[20]), "+f"(d0[21]),
        "+f"(d0[22]), "+f"(d0[23]), "+f"(d0[24]), "+f"(d0[25]),
        "+f"(d0[26]), "+f"(d0[27]), "+f"(d0[28]), "+f"(d0[29]),
        "+f"(d0[30]), "+f"(d0[31]), "+f"(d0[32]), "+f"(d0[33]),
        "+f"(d0[34]), "+f"(d0[35]), "+f"(d0[36]), "+f"(d0[37]),
        "+f"(d0[38]), "+f"(d0[39]), "+f"(d0[40]), "+f"(d0[41]),
        "+f"(d0[42]), "+f"(d0[43]), "+f"(d0[44]), "+f"(d0[45]),
        "+f"(d0[46]), "+f"(d0[47]), "+f"(d0[48]), "+f"(d0[49]),
        "+f"(d0[50]), "+f"(d0[51]), "+f"(d0[52]), "+f"(d0[53]),
        "+f"(d0[54]), "+f"(d0[55]), "+f"(d0[56]), "+f"(d0[57]),
        "+f"(d0[58]), "+f"(d0[59]), "+f"(d0[60]), "+f"(d0[61]),
        "+f"(d0[62]), "+f"(d0[63]), "+f"(d1[0]), "+f"(d1[1]),
        "+f"(d1[2]), "+f"(d1[3]), "+f"(d1[4]), "+f"(d1[5]), "+f"(d1[6]),
        "+f"(d1[7]), "+f"(d1[8]), "+f"(d1[9]), "+f"(d1[10]),
        "+f"(d1[11]), "+f"(d1[12]), "+f"(d1[13]), "+f"(d1[14]),
        "+f"(d1[15]), "+f"(d1[16]), "+f"(d1[17]), "+f"(d1[18]),
        "+f"(d1[19]), "+f"(d1[20]), "+f"(d1[21]), "+f"(d1[22]),
        "+f"(d1[23]), "+f"(d1[24]), "+f"(d1[25]), "+f"(d1[26]),
        "+f"(d1[27]), "+f"(d1[28]), "+f"(d1[29]), "+f"(d1[30]),
        "+f"(d1[31]), "+f"(d1[32]), "+f"(d1[33]), "+f"(d1[34]),
        "+f"(d1[35]), "+f"(d1[36]), "+f"(d1[37]), "+f"(d1[38]),
        "+f"(d1[39]), "+f"(d1[40]), "+f"(d1[41]), "+f"(d1[42]),
        "+f"(d1[43]), "+f"(d1[44]), "+f"(d1[45]), "+f"(d1[46]),
        "+f"(d1[47]), "+f"(d1[48]), "+f"(d1[49]), "+f"(d1[50]),
        "+f"(d1[51]), "+f"(d1[52]), "+f"(d1[53]), "+f"(d1[54]),
        "+f"(d1[55]), "+f"(d1[56]), "+f"(d1[57]), "+f"(d1[58]),
        "+f"(d1[59]), "+f"(d1[60]), "+f"(d1[61]), "+f"(d1[62]),
        "+f"(d1[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TRANS_B));
}

// --- host: tensor maps ----------------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle,
                                   CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once; nullptr when the
// installed CUDA does not have it.
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D tiled tensor map: dims and box innermost first, strides in bytes of
// dims 1..3; out-of-bounds elements load as zeros. Returns false when the
// encoder refuses it.
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, const cuuint64_t (&dims)[4],
                        const cuuint64_t (&strides)[3],
                        const cuuint32_t (&box)[4], CUtensorMapSwizzle swz) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// --- host: launch attributes ----------------------------------------------------

// Raise a kernel's dynamic shared-memory cap once per device (`done`: a
// bit per device, one word per kernel): decode launches hundreds of these
// kernels a step, and the attribute call costs host time.
inline cudaError_t allow_smem(const void* kernel, int bytes, unsigned& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace hopper
}  // namespace dstt
