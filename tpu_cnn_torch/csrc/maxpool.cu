// The max-pool rows of a darknet layer graph (YOLOv7's), on channels-last
// u8 maps, for NVIDIA Hopper (sm_90a). It replaces no TPU kernel: the JAX
// package has no layer graph.
//
//     x (B, H, W, C) u8 channels-last, its pixels `in_pitch` bytes apart
//     (a map inside a wider concatenated one)
//     -> 2x2 stride 2 (H, W even): out (B, H/2, W/2, C), the max of each
//        window (2 y .. 2 y + 1, 2 x .. 2 x + 1): YOLOv7's MP branch
//     -> or stride 1, SAME: up to three outputs, pooled at 5, 9 and 13
//        (the max over y - k // 2 .. y + k // 2 and the same columns,
//        taps outside the map ignored): SPPCSPC's pools, each written
//        into its slice of their concatenation
//
// Every byte is u8, never below 0, so a k x k window of the clipped map
// is a 5x5 window of a 5x5 window ... (k - 1) / 4 times: 9 is 5 twice, 13
// three times, and a 5x5 window is a row of 5 then a column of 5. The
// stride-1 launch stages one image's map of a run of 16-channel vectors
// in shared memory once and cascades the 5x5 there, writing each output
// after its step, so the map is read once for all three pools.
//
// Both are byte-bound: the 2x2/2 pool reads its map once and writes a
// quarter of it, 16 bytes (16 channels) a thread at a time, __vmaxu4 on
// each word; the cascade reads its map once and writes it once an output.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "path_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOuts = 3;
constexpr int kSmemBudget = 96 * 1024;  // the cascade's two buffers: two CTAs an SM

struct PoolArgs {
  const uint8_t* x;
  uint8_t* out[kMaxOuts];
  long long in_pitch, out_pitch[kMaxOuts];
  int step[kMaxOuts];  // the cascade's 5x5 step after which out[i] is written (1..3)
  int outs, steps;
  int batch, vecs, height, width;  // vecs: 16-channel vectors a pixel
  int group;                       // vectors a CTA of the cascade stages
};

__device__ __forceinline__ uint4 vmax16(uint4 a, uint4 b) {
  return make_uint4(__vmaxu4(a.x, b.x), __vmaxu4(a.y, b.y), __vmaxu4(a.z, b.z),
                    __vmaxu4(a.w, b.w));
}

// 2x2 stride 2: a thread an output pixel's 16 channels, in the order of
// the output's bytes.
__device__ __forceinline__ void pool2(const PoolArgs& a) {
  const int oh = a.height / 2, ow = a.width / 2;
  const long long total = static_cast<long long>(a.batch) * oh * ow * a.vecs;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int v = static_cast<int>(i % a.vecs);
    const long long p = i / a.vecs;  // the output pixel over the batch
    const int x = static_cast<int>(p % ow);
    const long long by = p / ow;
    const int y = static_cast<int>(by % oh);
    const long long b = by / oh;
    const long long src = (b * a.height + 2 * y) * a.width + 2 * x;
    const uint8_t* q = a.x + src * a.in_pitch + 16 * v;
    const long long down = a.width * a.in_pitch;
    const uint4 m = vmax16(vmax16(__ldg(reinterpret_cast<const uint4*>(q)),
                                  __ldg(reinterpret_cast<const uint4*>(q + a.in_pitch))),
                           vmax16(__ldg(reinterpret_cast<const uint4*>(q + down)),
                                  __ldg(reinterpret_cast<const uint4*>(q + down + a.in_pitch))));
    *reinterpret_cast<uint4*>(a.out[0] + p * a.out_pitch[0] + 16 * v) = m;
  }
}

// Stride 1: CTA (image, run of `group` vectors) stages the image's map in
// `cur`, then per 5x5 step the rows' maxima into `tmp` and the columns'
// back into `cur`, writing the outputs of that step on the way.
__device__ __forceinline__ void cascade(const PoolArgs& a, uint4* smem) {
  const int H = a.height, W = a.width, G = a.group, n = H * W * G;
  uint4* cur = smem;
  uint4* tmp = smem + n;
  const int groups = a.vecs / G;
  const int b = blockIdx.x / groups, v0 = (blockIdx.x - b * groups) * G;
  const long long pix0 = static_cast<long long>(b) * H * W;
  for (int i = threadIdx.x; i < n; i += kThreads) {  // i = pixel G + vector
    const int p = i / G, v = i - p * G;
    cur[i] = __ldg(reinterpret_cast<const uint4*>(a.x + (pix0 + p) * a.in_pitch + 16 * (v0 + v)));
  }
  __syncthreads();
  for (int s = 1; s <= a.steps; ++s) {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int p = i / G, v = i - p * G, y = p / W, x = p - y * W;
      uint4 m = cur[i];
      for (int d = max(x - 2, 0); d <= min(x + 2, W - 1); ++d) {
        m = vmax16(m, cur[(y * W + d) * G + v]);
      }
      tmp[i] = m;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int p = i / G, v = i - p * G, y = p / W, x = p - y * W;
      uint4 m = tmp[i];
      for (int d = max(y - 2, 0); d <= min(y + 2, H - 1); ++d) {
        m = vmax16(m, tmp[(d * W + x) * G + v]);
      }
      cur[i] = m;
      for (int o = 0; o < a.outs; ++o) {
        if (a.step[o] == s) {
          *reinterpret_cast<uint4*>(a.out[o] + (pix0 + p) * a.out_pitch[o] + 16 * (v0 + v)) = m;
        }
      }
    }
    __syncthreads();
  }
}

// The pooling kernel: one name for both strides (the benchmark counts its
// time as the net's), an instantiation each.
template <int kStride>
__global__ void __launch_bounds__(kThreads) maxpool_kernel(const PoolArgs a) {
  extern __shared__ __align__(16) uint4 smem[];
  if constexpr (kStride == 2) {
    pool2(a);
  } else {
    cascade(a, smem);
  }
}

enum PoolPath { kPathPool2, kPathCascade, kPathCascadeOuts2, kPathCascadeOuts3, kPathInPitch,
                kPathOutPitch, kPoolPaths };
constexpr const char* kPoolPathNames[kPoolPaths] = {
    "2x2 stride 2, 16 bytes a thread", "stride 1: the 5x5 cascaded in shared memory",
    "the cascade writes two outputs", "the cascade writes three outputs (SPPCSPC's)",
    "the input inside a wider map", "an output inside a wider map (a route's slice)"};
PathCounts<kPoolPaths> g_pool_paths(kPoolPathNames);

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Vectors of 16 channels a CTA of the stride-1 cascade stages on an H x W
// map of `vecs` vectors a pixel: the most of 4, 2 and 1 that divides vecs
// and fits its two buffers in kSmemBudget; 0 where none fits.
int cascade_group(int vecs, int height, int width) {
  for (int g = 4; g >= 1; g >>= 1) {
    if (vecs % g == 0 && 2LL * height * width * g * 16 <= kSmemBudget) return g;
  }
  return 0;
}

}  // namespace

extern "C" const char* maxpool_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int maxpool_paths(const char** names, unsigned long long* hits, int n) {
  return g_pool_paths.read(names, hits, n);
}

// Launches the pool on `stream` of CUDA device `device`: x (B, H, W, C)
// u8 channels-last, pixels `in_pitch` bytes apart; `stride` 2 (one output,
// (B, H/2, W/2, C); H, W even) or 1 (`outs` 1-3 outputs of (B, H, W, C),
// out[i] written after `steps[i]` (1, 2, 3: pooled at 5, 9, 13) of the 5x5
// cascade); each output's pixels out_pitch[i] bytes apart. C, the pitches
// and every pointer multiples of 16. Returns a cudaError_t: cudaSuccess,
// cudaErrorInvalidValue for a geometry the kernel does not take, or the
// launch error. Neither synchronises nor allocates.
extern "C" int maxpool_forward(const void* x, long long in_pitch, int batch, int channels,
                               int height, int width, int stride, int outs, void* const* out,
                               const long long* out_pitch, const int* steps, int device,
                               void* stream) {
  PoolArgs a;
  if (batch < 0 || channels < 16 || channels % 16 != 0 || height < 1 || width < 1 ||
      in_pitch < channels || in_pitch % 16 != 0 || !aligned16(x) || outs < 1 ||
      outs > kMaxOuts || (stride != 1 && stride != 2) || (stride == 2 && outs != 1) ||
      (stride == 2 && (height % 2 != 0 || width % 2 != 0))) {
    return cudaErrorInvalidValue;
  }
  a.x = static_cast<const uint8_t*>(x);
  a.in_pitch = in_pitch;
  a.outs = outs;
  a.steps = 0;
  bool pitched = false;
  for (int i = 0; i < kMaxOuts; ++i) {
    a.out[i] = nullptr;
    a.out_pitch[i] = 0;
    a.step[i] = 0;
  }
  for (int i = 0; i < outs; ++i) {
    if (out[i] == nullptr || !aligned16(out[i]) || out_pitch[i] < channels ||
        out_pitch[i] % 16 != 0 || (stride == 1 && (steps[i] < 1 || steps[i] > 3))) {
      return cudaErrorInvalidValue;
    }
    a.out[i] = static_cast<uint8_t*>(out[i]);
    a.out_pitch[i] = out_pitch[i];
    a.step[i] = stride == 1 ? steps[i] : 0;
    a.steps = a.step[i] > a.steps ? a.step[i] : a.steps;
    pitched |= out_pitch[i] != channels;
  }
  a.batch = batch;
  a.vecs = channels / 16;
  a.height = height;
  a.width = width;
  a.group = stride == 1 ? cascade_group(a.vecs, height, width) : 0;
  if (stride == 1 && a.group == 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stride == 2) {
    const long long total =
        static_cast<long long>(batch) * (height / 2) * (width / 2) * a.vecs;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    const long long blocks = std::min<long long>((total + kThreads - 1) / kThreads, 16LL * sms);
    maxpool_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  } else {
    const int smem = 2 * height * width * a.group * 16;
    err = cudaFuncSetAttribute(maxpool_kernel<1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    const long long blocks = static_cast<long long>(batch) * (a.vecs / a.group);
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    maxpool_kernel<1><<<static_cast<unsigned>(blocks), kThreads, smem, s>>>(a);
  }
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_pool_paths.add(stride == 2 ? kPathPool2 : kPathCascade);
    if (stride == 1 && outs == 2) g_pool_paths.add(kPathCascadeOuts2);
    if (stride == 1 && outs == 3) g_pool_paths.add(kPathCascadeOuts3);
    if (in_pitch != channels) g_pool_paths.add(kPathInPitch);
    if (pitched) g_pool_paths.add(kPathOutPitch);
  }
  return err;
}
