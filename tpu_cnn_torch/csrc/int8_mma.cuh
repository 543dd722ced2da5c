// The int8 tensor-core primitives the Hopper kernels share (sm_90a):
// channel padding, the shared-memory chunk swizzle, mma.sync u8 x s8 -> s32
// at k32 and k16, and ldmatrix.x4. Included by mega_cnn.cu (the megakernel)
// and conv_layer.cuh (the layer kernel); each includer is its own library,
// so everything here has internal linkage.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

// Bytes one pixel of a c-channel map takes in shared memory, channels-last:
// 1 for one channel, else a power of two >= 16 (one ldmatrix row per 16).
__host__ __device__ inline int cpad_of(int c) {
  if (c == 1) return 1;
  int p = 16;
  while (p < c) p <<= 1;
  return p;
}

// The 16-byte chunk a pixel's channel chunk c sits at: c ^ swz(pixel).
// cpp = chunks per pixel (1, 2, 4, 8 or more).
__device__ __forceinline__ int swz(int pixel, int cpp) {
  return cpp >= 8 ? (pixel & 7)
       : cpp == 4 ? ((pixel >> 1) & 3)
       : cpp == 2 ? ((pixel >> 2) & 1) : 0;
}

// c += A (16 x 32 u8, a0-a3) * B (32 x 8 s8, b0-b1), exact in s32.
__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A (16 x 16 u8, a0-a1) * B (16 x 8 s8, b0), exact in s32. Lane
// (g = lane / 4, t = lane % 4) holds A rows g (a0) and g + 8 (a1) at K
// bytes 4t..4t+3, B column g at the same K bytes, and C rows g (c0, c1)
// and g + 8 (c2, c3) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_u8s8_k16(int (&c)[4], uint32_t a0, uint32_t a1,
                                             uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

}  // namespace
