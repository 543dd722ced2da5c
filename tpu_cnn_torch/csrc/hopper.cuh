// Hopper-only primitives of the megakernel (sm_90a): mbarriers, the bulk
// copy engine (cp.async.bulk, the TMA's 1-D form) and the warpgroup MMA
// (wgmma.mma_async) u8 x s8 -> s32 with A from registers and B from
// shared memory. Included by mega_cnn.cu; everything here has internal
// linkage.
//
// B's shared-memory layout (what ops/mega.py's pack_weights writes for a
// multi-channel layer, and what wgmma_desc describes): wgmma reads an
// 8-bit B K-major, in core matrices of 8 N rows x 16 K bytes, 128 bytes
// each, row-major within. A layer's B is, for each K step of 32 bytes,
// for each group of 8 output channels, the two core matrices of K bytes
// 0-15 and 16-31 of that step: core matrix (s, n8, h) at byte
// ((s * NG + n8) * 2 + h) * 128, NG = the padded channels / 8. So the
// leading-dimension offset (between the two K halves) is 128 bytes and
// the stride-dimension offset (between groups of 8 channels) 256, with
// no swizzle.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ── mbarriers and the bulk copy engine ───────────────────────────────

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible to the async proxy.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also expects `bytes` more of copies to complete.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits for the phase of parity `parity` to complete.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// Orders this thread's earlier generic-proxy accesses of shared memory
// before later async-proxy ones (a bulk copy into it, a wgmma reading it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global
// to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// ── wgmma ────────────────────────────────────────────────────────────

// The shared-memory matrix descriptor of a no-swizzle K-major operand:
// start address, leading-dimension and stride-dimension byte offsets,
// each in 16-byte units; base offset 0, layout type 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// B of output channels 8 n8 .. of K step s in the layout above.
__device__ __forceinline__ uint64_t b_desc(uint32_t w_s, int ng, int s, int n8) {
  return wgmma_desc(w_s + static_cast<uint32_t>((s * ng + n8) * 256), 128, 256);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous MMAs that own them.
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

// d (+)= A (64 x 32 u8; this warp's rows 16 (warp % 4) .. + 15, the
// fragment of mma.m16n8k32: a0 row g bytes 4t..4t+3, a1 row g + 8, a2 and
// a3 the same rows at bytes 16 + 4t..) x B (32 x N s8, from `desc`),
// exact in s32; scale_d 0 overwrites d. d[4j + e] holds row g (e < 2) or
// g + 8 (e >= 2) of columns 8j + 2t + (e & 1): mma.m16n8k32's C fragment
// for each N tile j. Issued by all 128 threads of a warpgroup.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void mma(int (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p;\n"
        "}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
          "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
          "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

}  // namespace
