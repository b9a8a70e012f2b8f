// Hopper (sm_90a) building blocks as inline PTX: wgmma (bf16 in, f32
// accumulated in registers), 1-D bulk copies into shared memory, mbarriers,
// named barriers, proxy fences and setmaxnreg. Shared by the decoder of
// decoder.cuh.

#pragma once

#include <stdint.h>

namespace nvsr {

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers ------------------------------------------------------------

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
// A wait that has not completed after ~2^36 clocks (tens of seconds)
// traps, so a broken protocol ends the kernel with an error instead of
// hanging the card.
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1LL << 36)) __trap();
  } while (!done);
}

// -- 1-D bulk copy global -> shared, completing on an mbarrier ----------

__device__ inline void bulk_load(uint32_t dst, const void* src,
                                 uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// -- barriers and fences ----------------------------------------------------

// named barrier `id` (1..15) over `threads` threads
__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// make this thread's generic-proxy writes to shared memory visible to the
// async proxy (wgmma operand reads)
__device__ inline void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- register rebalancing between warpgroups -------------------------------

// setmaxnreg: every warp of the warpgroup executes it with the same count
// (a multiple of 8 in 24..256). dec gives registers back to the SM's pool,
// inc waits until the pool holds enough and takes them.
template <int kRegs>
__device__ inline void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ inline void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// -- wgmma ------------------------------------------------------------------

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, no swizzle ("interleave"): the operand
// is stored as 8x8 core matrices of 128 contiguous bytes (8 rows of 16 B,
// K contiguous within a row); lbo = bytes between core matrices adjacent
// in K, sbo = bytes between core matrices adjacent in M (or N).
__device__ inline uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                     uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32);
}

#define NVSR_ACC64(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define NVSR_D64                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"

// d[64] (+)= A[64 x 16] @ B[16 x 128]: A and B from shared memory (K-major);
// scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_128_ss(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NVSR_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : NVSR_ACC64(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// the same with A from registers: a[4] holds this thread's bf16 pairs of
// the 64 x 16 A tile in the accumulator's row/column order
__device__ __forceinline__ void wgmma_128_rs(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NVSR_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : NVSR_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// d[8] (+)= A[64 x 16] (registers) @ B[16 x 16] (shared memory)
__device__ __forceinline__ void wgmma_16_rs(float* d, const uint32_t* a,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef NVSR_D64

}  // namespace nvsr
