// One contract conv, without the pool, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_cnn/ops/pallas_int8.py:_conv_mxu (body
// _kernel_body_mxu), the per-layer kernel of the `pallas` and `hybrid`
// backends. For uint8 activations and int8 weights:
//
//     (B, ic, H, W) u8 -> SAME conv3x3 (zero halo), exact int32 accumulate
//     -> >> shift[layer] (arithmetic) -> clip 0..255 -> (B, oc, H, W) u8
//
// The 2x2 pool is not here: it stays torch glue around the kernel, as it is
// XLA glue around the TPU kernel. H and W are separate: any rectangle.
//
// Design: conv_pool_layer.cu's scheme without the pool. A grid of (32x32
// output tile, image) blocks of 256 threads; each thread owns a 2x2 quad
// of outputs. A block stages its input tile with a 1-pixel halo (34x34
// per channel, zero outside the image) for up to 16 input channels at a
// time, and the int8 weights of the current 16 output channels, tap-major
// so that one 16-byte-aligned row holds one tap of all 16 channels, in
// shared memory. Each thread keeps the four int32 sums of 16 output
// channels in registers, so one staged 4x4 patch feeds 64 sums. The
// launch bound asks for two blocks per SM: left to itself ptxas takes 133
// registers, which fits one 256-thread block per SM; at two it fits in 127
// without spills and runs 14-36% faster (lyr3-std's layers and lyr4-wide's
// L0 on an H100 SXM at 700 W). Geometry
// and the shift (read from the device shift vector at index `layer`) are
// runtime arguments: one build serves every layer, and a shift change
// rebuilds nothing.
//
// What bounds it on an H100: scalar integer multiply-adds and the
// shared-memory loads that feed them (per input channel and thread, 16
// patch bytes and 36 16-byte weight rows for 576 MACs); HBM is not a
// bound (lyr3-std's L0 writes 256 KiB per image against 2.4 M MACs). The
// TPU kernel's zero-point staging (a ^ 0x80 and the 128 * sum(k)
// correction), block-diagonal weight packing, batch-tile VMEM model,
// pad-to-4 batch, lane wrap masks, < 4-row XLA reroute and row bands were
// Mosaic's; none exists here. Later work: mma.sync m16n8k32 u8 x s8.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                       // outputs per tile side
constexpr int kThreads = (kTile / 2) * (kTile / 2);  // one thread per 2x2 quad
constexpr int kPatch = kTile + 2;               // input rows (and cols) a tile reads
constexpr int kPatchBytes = kPatch * kPatch;
constexpr int kOcGroup = 16;                    // output channels per accumulator set
constexpr int kIcChunk = 16;                    // input channels staged at once
constexpr int kMaxSize = 32768;                 // keeps y * W + x in int

__global__ void __launch_bounds__(kThreads, 2)
conv_act_kernel(const uint8_t* __restrict__ x, const int8_t* __restrict__ w,
                const int32_t* __restrict__ shifts, int layer,
                uint8_t* __restrict__ out, int batch, int ic, int oc, int height,
                int width, int tiles_x) {
  __shared__ uint8_t patch[kIcChunk][kPatchBytes];
  __shared__ __align__(16) int wsm[kIcChunk * 9][kOcGroup];  // [c * 9 + tap][o]

  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ly = threadIdx.x / (kTile / 2);
  const int lx = threadIdx.x % (kTile / 2);
  const int oy = ty0 + 2 * ly;  // top-left output of this thread's quad
  const int ox = tx0 + 2 * lx;
  const bool live = oy < height && ox < width;
  const int iy0 = ty0 - 1;  // input row of patch row 0
  const int ix0 = tx0 - 1;
  // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1.
  // The wrapper's callers refuse shifts outside 0..31.
  const int shift = min(max(shifts[layer], 0), 31);
  const size_t plane = static_cast<size_t>(height) * width;

  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const uint8_t* xb = x + static_cast<size_t>(b) * ic * plane;
    uint8_t* ob = out + static_cast<size_t>(b) * oc * plane;
    for (int o0 = 0; o0 < oc; o0 += kOcGroup) {
      int acc[kOcGroup][4];
#pragma unroll
      for (int o = 0; o < kOcGroup; ++o) {
        acc[o][0] = acc[o][1] = acc[o][2] = acc[o][3] = 0;
      }
      for (int c0 = 0; c0 < ic; c0 += kIcChunk) {
        const int nc = min(kIcChunk, ic - c0);
        __syncthreads();  // every thread is done with the previous chunk
        for (int i = threadIdx.x; i < nc * kPatchBytes; i += kThreads) {
          const int c = i / kPatchBytes;
          const int r = i - c * kPatchBytes;
          const int yy = iy0 + r / kPatch;
          const int xx = ix0 + r % kPatch;
          const bool ok = static_cast<unsigned>(yy) < static_cast<unsigned>(height) &&
                          static_cast<unsigned>(xx) < static_cast<unsigned>(width);
          patch[c][r] = ok ? xb[(c0 + c) * plane + yy * width + xx] : 0;
        }
        // rows c * 9 + tap of the nc staged channels; rows past them are
        // never read
        for (int i = threadIdx.x; i < nc * 9 * kOcGroup; i += kThreads) {
          const int row = i / kOcGroup;
          const int o = i - row * kOcGroup;
          const int c = row / 9;
          wsm[row][o] = o0 + o < oc
                            ? static_cast<int>(w[(static_cast<size_t>(o0 + o) * ic + c0 + c) * 9 +
                                                 row % 9])
                            : 0;
        }
        __syncthreads();
        if (!live) continue;
        for (int c = 0; c < nc; ++c) {
          const uint8_t* src = patch[c] + (2 * ly) * kPatch + 2 * lx;
          int v[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int s = 0; s < 4; ++s) v[r][s] = src[r * kPatch + s];
          }
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
            for (int kx = 0; kx < 3; ++kx) {
              const int4* wr = reinterpret_cast<const int4*>(wsm[c * 9 + ky * 3 + kx]);
              int k[kOcGroup];
#pragma unroll
              for (int q = 0; q < kOcGroup / 4; ++q) {
                const int4 t = wr[q];
                k[4 * q] = t.x;
                k[4 * q + 1] = t.y;
                k[4 * q + 2] = t.z;
                k[4 * q + 3] = t.w;
              }
#pragma unroll
              for (int o = 0; o < kOcGroup; ++o) {
                acc[o][0] += k[o] * v[ky][kx];
                acc[o][1] += k[o] * v[ky][kx + 1];
                acc[o][2] += k[o] * v[ky + 1][kx];
                acc[o][3] += k[o] * v[ky + 1][kx + 1];
              }
            }
          }
        }
      }
      if (!live) continue;
#pragma unroll
      for (int o = 0; o < kOcGroup; ++o) {
        if (o0 + o >= oc) break;
        uint8_t* dst = ob + (o0 + o) * plane;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int y = oy + q / 2;
          const int xo = ox + q % 2;
          // >> on int is arithmetic (floor), as the contract requires
          if (y < height && xo < width) {
            dst[y * width + xo] = static_cast<uint8_t>(min(max(acc[o][q] >> shift, 0), 255));
          }
        }
      }
    }
  }
}

}  // namespace

extern "C" const char* conv_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one conv on `stream` of CUDA device `device`: x (B, ic, H, W)
// u8, w (oc, ic, 3, 3) s8, shifts a device int32 vector read at `layer`,
// out (B, oc, H, W) u8, all device pointers. Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
extern "C" int conv_act_forward(const void* x, const void* w, const void* shifts, int layer,
                                void* out, int batch, int ic, int oc, int height, int width,
                                int device, void* stream) {
  if (batch < 0 || ic < 1 || oc < 1 || layer < 0 || height < 1 || width < 1 ||
      height > kMaxSize || width > kMaxSize) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const int tiles_x = (width + kTile - 1) / kTile;
  const int tiles_y = (height + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_y, std::min(batch, 65535));
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  conv_act_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(shifts), layer, static_cast<uint8_t*>(out), batch, ic, oc,
      height, width, tiles_x);
  return cudaGetLastError();
}
