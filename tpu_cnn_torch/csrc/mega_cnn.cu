// Whole-network int8 CNN megakernel for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_cnn/ops/pallas_poly.py:cnn_forward_polyphase_pallas
// (body _mega_body): the whole net in one kernel, activations kept on chip.
// Per layer, for uint8 activations and int8 weights:
//
//     SAME conv3x3, integer accumulate -> >> shift[l] (arithmetic)
//     -> clip 0..255 -> 2x2 stride-2 max pool
//
// and, from the final map, whichever of three outputs is requested:
//   feats  (B, oc_L, P*P) uint8        the features, (channel, y*P + x)
//   bins   (B, oc_L*16)   float32      4x4 bin means: sum / (npx*npx) / 255
//   twin   (B, oc_L, P*P) bfloat16     the features again (0..255 is exact)
//
// The input is (B, ic0, S, S) uint8, NCHW: ic0 = 1 for a whole net, and
// the head's output channels when the kernel runs the tail of the chained
// plan (lyr4-wide's L1-L3 read the 16 x 128^2 output of conv_pool_layer.cu).
//
// Design: one CTA per image. The layers ping-pong between two regions of
// dynamic shared memory; the input is read from global memory (for a tail,
// the L2-cached head output). For lyr3-std the peak is L0 out + L1 out =
// 65,536 + 32,768 = 98,304 bytes; for lyr4-wide's tail L1 out + L2 out =
// 131,072 + 65,536 = 196,608 bytes.
// Each thread owns pooled outputs: for one it accumulates the four pre-pool
// int32 sums over ic x 9 taps (a 4x4 input patch, zero padding by bounds
// check), shifts, clips and keeps the max. Geometry (L <= 4 layers,
// ic/oc per layer, input size) and the shift vector (a device pointer) are
// runtime arguments, so one build serves every geometry that fits and a
// shift change rebuilds nothing.
//
// What bounds it on an H100: lyr3-std is ~40 M int MACs per image against
// 16 KB read and at most 52 KB written (16 KB features, 32 KB twin, 4 KB
// bins), so this scalar-IMAD kernel is bound by integer issue rate (and the
// shared-memory loads feeding it), not by HBM. The TPU kernel's phase
// split, lane rolls, block-diagonal batch packing and zero-point staging
// were Mosaic workarounds and have no counterpart here. Later work:
// mma.sync m16n8k32 u8 x s8 (native on Hopper, no zero-point trick),
// wgmma, several images per CTA.

#include <algorithm>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;  // opt-in limit of one block on sm_90

struct MegaParams {
  const uint8_t* images;               // (B, ic0, S, S)
  const int8_t* weights[kMaxLayers];   // per layer (oc, ic, 3, 3)
  const int32_t* shifts;               // (L,)
  uint8_t* feats;                      // optional outputs, nullptr = skip
  float* bins;
  __nv_bfloat16* twin;
  int n_layers;
  int size0;
  int ic[kMaxLayers];
  int oc[kMaxLayers];
  int region0_bytes;                   // ping-pong split of shared memory
};

// One contract layer: in (ic, size, size) -> out (oc, size/2, size/2).
__device__ void conv_pool_layer(const uint8_t* __restrict__ in,
                                uint8_t* __restrict__ out,
                                const int8_t* __restrict__ w, int ic, int oc,
                                int size, int shift) {
  const int p = size / 2;
  const int n_out = oc * p * p;
  for (int idx = threadIdx.x; idx < n_out; idx += blockDim.x) {
    const int o = idx / (p * p);
    const int rem = idx - o * p * p;
    const int py = rem / p;
    const int px = rem - py * p;
    const int y0 = 2 * py - 1;  // top-left of the 4x4 input patch
    const int x0 = 2 * px - 1;
    int a00 = 0, a01 = 0, a10 = 0, a11 = 0;
    const int8_t* wo = w + o * ic * 9;
    for (int c = 0; c < ic; ++c) {
      const uint8_t* plane = in + c * size * size;
      int v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int y = y0 + r;
        const bool y_ok = static_cast<unsigned>(y) < static_cast<unsigned>(size);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int x = x0 + s;
          const bool ok = y_ok && static_cast<unsigned>(x) < static_cast<unsigned>(size);
          v[r][s] = ok ? static_cast<int>(plane[y * size + x]) : 0;
        }
      }
      const int8_t* wc = wo + c * 9;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const int k = wc[ky * 3 + kx];
          a00 += k * v[ky][kx];
          a01 += k * v[ky][kx + 1];
          a10 += k * v[ky + 1][kx];
          a11 += k * v[ky + 1][kx + 1];
        }
      }
    }
    // >> on int32_t is arithmetic (floor), as the contract requires
    const int m = max(max(a00 >> shift, a01 >> shift), max(a10 >> shift, a11 >> shift));
    out[idx] = static_cast<uint8_t>(min(max(m, 0), 255));
  }
}

__global__ void __launch_bounds__(kThreads) mega_cnn_kernel(MegaParams prm) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;

  const uint8_t* cur =
      prm.images + static_cast<size_t>(b) * prm.ic[0] * prm.size0 * prm.size0;
  int size = prm.size0;
  for (int l = 0; l < prm.n_layers; ++l) {
    uint8_t* out = (l & 1) ? smem + prm.region0_bytes : smem;
    // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1
    const int shift = min(max(prm.shifts[l], 0), 31);
    conv_pool_layer(cur, out, prm.weights[l], prm.ic[l], prm.oc[l], size, shift);
    __syncthreads();
    cur = out;
    size /= 2;
  }

  const int oc = prm.oc[prm.n_layers - 1];
  const int pp = size * size;
  const int n = oc * pp;
  if (prm.feats != nullptr) {
    uint8_t* f = prm.feats + static_cast<size_t>(b) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) f[i] = cur[i];
  }
  if (prm.twin != nullptr) {
    __nv_bfloat16* t = prm.twin + static_cast<size_t>(b) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      t[i] = __float2bfloat16_rn(static_cast<float>(cur[i]));
    }
  }
  if (prm.bins != nullptr) {
    const int npx = size / 4;
    float* bo = prm.bins + static_cast<size_t>(b) * oc * 16;
    for (int j = threadIdx.x; j < oc * 16; j += blockDim.x) {
      const int o = j >> 4;
      const int by = (j & 15) >> 2;
      const int bx = j & 3;
      const uint8_t* plane = cur + o * pp + (by * npx) * size + bx * npx;
      int sum = 0;
      for (int y = 0; y < npx; ++y) {
        for (int x = 0; x < npx; ++x) sum += plane[y * size + x];
      }
      // the same order as the TPU kernel: exact integer sum, / npx^2, / 255
      bo[j] = static_cast<float>(sum) / static_cast<float>(npx * npx) / 255.0f;
    }
  }
}

// Shared-memory bytes the kernel needs for a geometry: the two ping-pong
// regions, each sized for the largest layer output it holds. 0 if the
// geometry is not one the kernel takes.
int smem_bytes(int n_layers, int size0, const int* ic, const int* oc,
               int* region0_bytes) {
  if (n_layers < 1 || n_layers > kMaxLayers || size0 <= 0) return 0;
  if (size0 % (1 << n_layers) != 0) return 0;
  // the first layer indexes its input planes in int
  if (ic[0] <= 0 || static_cast<long long>(ic[0]) * size0 * size0 > INT32_MAX) return 0;
  int region[2] = {0, 0};
  int size = size0;
  for (int l = 0; l < n_layers; ++l) {
    if (ic[l] <= 0 || oc[l] <= 0) return 0;
    if (l > 0 && ic[l] != oc[l - 1]) return 0;
    size /= 2;
    region[l & 1] = std::max(region[l & 1], oc[l] * size * size);
  }
  region[0] = (region[0] + 15) / 16 * 16;
  *region0_bytes = region[0];
  return region[0] + region[1];
}

}  // namespace

extern "C" const char* mega_cnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the megakernel on `stream` of CUDA device `device` for a batch
// of (B, ic[0], size0, size0) u8 inputs. Pointers are device pointers
// (weights[l] for l >= n_layers and unrequested outputs may be null);
// ic/oc are host arrays of n_layers entries. Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
extern "C" int mega_cnn_forward(const void* images, const void* w0,
                                const void* w1, const void* w2, const void* w3,
                                const void* shifts, void* feats, void* bins,
                                void* twin, int batch, int n_layers, int size0,
                                const int* ic, const int* oc, int device,
                                void* stream) {
  MegaParams prm;
  const int smem = smem_bytes(n_layers, size0, ic, oc, &prm.region0_bytes);
  if (smem == 0 || smem > kMaxSmemBytes || batch < 0) return cudaErrorInvalidValue;
  if (bins != nullptr && (size0 >> n_layers) % 4 != 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  prm.images = static_cast<const uint8_t*>(images);
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLayers; ++l) {
    prm.weights[l] = static_cast<const int8_t*>(ws[l]);
    prm.ic[l] = l < n_layers ? ic[l] : 0;
    prm.oc[l] = l < n_layers ? oc[l] : 0;
  }
  prm.shifts = static_cast<const int32_t*>(shifts);
  prm.feats = static_cast<uint8_t*>(feats);
  prm.bins = static_cast<float*>(bins);
  prm.twin = static_cast<__nv_bfloat16*>(twin);
  prm.n_layers = n_layers;
  prm.size0 = size0;
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(
      mega_cnn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mega_cnn_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  return cudaGetLastError();
}
