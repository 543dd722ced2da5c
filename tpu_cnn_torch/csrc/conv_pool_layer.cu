// One contract layer for NVIDIA Hopper (sm_90a): the chained plan's head.
//
// Replaces two TPU kernels that compute the same function:
//   tpu_cnn/ops/pallas_poly.py:conv_pool_layer_poly   (body _single_layer_body)
//   tpu_cnn/ops/pallas_poly.py:conv_pool_layer_phase  (body _phase_layer_body)
// The second only writes the first's output in the phase-split row layout
// of the TPU tail kernel; the Hopper tail (mega_cnn.cu) reads NCHW, so one
// kernel and one layout serve both. For uint8 activations and int8 weights:
//
//     (B, ic, S, S) u8 -> SAME conv3x3, integer accumulate
//     -> >> shift[layer] (arithmetic) -> clip 0..255 -> 2x2 stride-2 max pool
//     -> (B, oc, S/2, S/2) u8
//
// Design: a grid of (pooled 16x16 output tile, image) blocks of 256
// threads, one thread per pooled output of the tile. A block stages its
// input tile with a 1-pixel halo (34x34 per channel, zero outside the
// image) for up to 16 input channels at a time, and the int8 weights of
// the current 16 output channels, in shared memory. Each thread keeps the
// four pre-pool int32 sums of 16 output channels in registers, so one
// staged 4x4 patch feeds all 16; it then shifts, clips and keeps the max.
// Geometry (ic, oc, S) and the shift (read from the device shift vector at
// index `layer`) are runtime arguments: one build serves every layer, and
// a shift change rebuilds nothing.
//
// What bounds it on an H100: lyr4-wide's L0 (1 -> 16 at 256^2) is 9.4 M
// int MACs per image against 64 KB read and 256 KB written, so it is bound
// by scalar integer issue and shared-memory loads, like mega_cnn.cu. The
// TPU kernels' lane chunking (n_sub), 128-lane alignment, >= 4-row rule,
// zero-point staging and phase-split layouts were Mosaic's limits; none
// exists here. Later work: mma.sync m16n8k32 u8 x s8 over the staged tile.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                 // pooled outputs per tile side
constexpr int kThreads = kTile * kTile;   // one thread per pooled output
constexpr int kPatch = 2 * kTile + 2;     // input rows (and cols) a tile reads
constexpr int kPatchBytes = kPatch * kPatch;
constexpr int kOcGroup = 16;              // output channels per accumulator set
constexpr int kIcChunk = 16;              // input channels staged at once
constexpr int kMaxSize = 32768;           // keeps y * S + x and (S/2)^2 in int

__global__ void __launch_bounds__(kThreads)
conv_pool_layer_kernel(const uint8_t* __restrict__ x,
                       const int8_t* __restrict__ w,
                       const int32_t* __restrict__ shifts, int layer,
                       uint8_t* __restrict__ out, int batch, int ic, int oc,
                       int size, int tiles_x) {
  __shared__ uint8_t patch[kIcChunk][kPatchBytes];
  __shared__ int wsm[kOcGroup][kIcChunk * 9];

  const int p = size / 2;
  const int ty0 = (blockIdx.x / tiles_x) * kTile;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ly = threadIdx.x / kTile;
  const int lx = threadIdx.x % kTile;
  const int py = ty0 + ly;
  const int px = tx0 + lx;
  const bool live = py < p && px < p;
  const int iy0 = 2 * ty0 - 1;  // input row of patch row 0
  const int ix0 = 2 * tx0 - 1;
  // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1
  const int shift = min(max(shifts[layer], 0), 31);
  const size_t plane = static_cast<size_t>(size) * size;
  const size_t out_plane = static_cast<size_t>(p) * p;

  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const uint8_t* xb = x + static_cast<size_t>(b) * ic * plane;
    uint8_t* ob = out + static_cast<size_t>(b) * oc * out_plane;
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
          const bool ok = static_cast<unsigned>(yy) < static_cast<unsigned>(size) &&
                          static_cast<unsigned>(xx) < static_cast<unsigned>(size);
          patch[c][r] = ok ? xb[(c0 + c) * plane + yy * size + xx] : 0;
        }
        for (int i = threadIdx.x; i < kOcGroup * kIcChunk * 9; i += kThreads) {
          const int o = i / (kIcChunk * 9);
          const int r = i - o * (kIcChunk * 9);
          const int c = r / 9;
          wsm[o][r] = (o0 + o < oc && c < nc)
                          ? static_cast<int>(w[(static_cast<size_t>(o0 + o) * ic + c0 + c) * 9 + r % 9])
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
          for (int o = 0; o < kOcGroup; ++o) {
            const int* wc = &wsm[o][c * 9];
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
              for (int kx = 0; kx < 3; ++kx) {
                const int k = wc[ky * 3 + kx];
                acc[o][0] += k * v[ky][kx];
                acc[o][1] += k * v[ky][kx + 1];
                acc[o][2] += k * v[ky + 1][kx];
                acc[o][3] += k * v[ky + 1][kx + 1];
              }
            }
          }
        }
      }
      if (!live) continue;
#pragma unroll
      for (int o = 0; o < kOcGroup; ++o) {
        if (o0 + o >= oc) break;
        // >> on int is arithmetic (floor), as the contract requires
        const int m = max(max(acc[o][0] >> shift, acc[o][1] >> shift),
                          max(acc[o][2] >> shift, acc[o][3] >> shift));
        ob[(o0 + o) * out_plane + py * p + px] = static_cast<uint8_t>(min(max(m, 0), 255));
      }
    }
  }
}

}  // namespace

extern "C" const char* conv_pool_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one layer on `stream` of CUDA device `device`: x (B, ic, S, S)
// u8, w (oc, ic, 3, 3) s8, shifts a device int32 vector read at `layer`,
// out (B, oc, S/2, S/2) u8, all device pointers. Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
extern "C" int conv_pool_layer_forward(const void* x, const void* w,
                                       const void* shifts, int layer, void* out,
                                       int batch, int ic, int oc, int size,
                                       int device, void* stream) {
  if (batch < 0 || ic < 1 || oc < 1 || layer < 0 || size < 2 || size % 2 != 0 ||
      size > kMaxSize) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const int tiles_x = (size / 2 + kTile - 1) / kTile;
  const dim3 grid(tiles_x * tiles_x, std::min(batch, 65535));
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  conv_pool_layer_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(shifts), layer, static_cast<uint8_t*>(out), batch,
      ic, oc, size, tiles_x);
  return cudaGetLastError();
}
