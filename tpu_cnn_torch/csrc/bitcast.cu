// Width-changing bitcasts and the packed lane roll, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel scripts/probe_bitcast.py:run (bodies k_narrow,
// k_widen, k_packed_roll), the probe of Mosaic's width-changing
// pltpu.bitcast and of pltpu.roll on packed words. What it computes, with
// the layouts the TPU showed (docs/DESIGN.md, "Mosaic constraints" 7):
//
//     narrow: x (R, L) int32 -> y (4R, L) int8,  y[4r+b, l] = byte b
//             (little-endian) of x[r, l]
//     widen:  x (4R, L) u8   -> y (R, L) int32,  y[r, l] = sum_b x[4r+b, l] << 8b
//     roll:   x (R, L) int32 -> y (R, L) int32,  y[r, (l+k) mod L] = x[r, l]
//
// Design: a 2-D grid, rows on y (grid-stride past 65535) and column groups
// on x, so no thread divides a flat index by L (a 64-bit division per word
// bounded the first version of this kernel, far below the copy rate). A
// group is V = 4 words when L % 4 == 0 and the pointers are aligned for the
// vector accesses, else one word (ragged L, an offset view).
//   narrow, V = 4: one 16-byte load of four words, a 4x4 byte transpose in
//     registers (__byte_perm), and one 4-byte store into each of the four
//     output rows 4r..4r+3;
//   widen, V = 4: the reverse (four 4-byte loads, the same transpose, one
//     16-byte store);
//   roll: a gather along the row with the wrapped index j - k (k reduced to
//     0..L-1 on the host); with V = 4 one 16-byte store of four gathered
//     words.
// Neighbouring threads touch neighbouring columns, so every warp's loads
// and stores are coalesced. Offsets are size_t: any R >= 1 and L >= 1.
//
// What bounds it on an H100: HBM bytes only (4 bytes in and 4 out per word,
// no arithmetic to speak of), so the aim is the copy rate. Mosaic's vreg
// relayout behind the TPU bitcast has no counterpart: global memory is byte
// addressable here, and a bitcast is an address pattern.

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>

#include "path_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridY = 65535;

// The 4x4 byte transpose: out[b] byte t = in[t] byte b. It is its own
// inverse, so narrow and widen share it.
__device__ __forceinline__ void transpose4x4(const uint32_t in[4], uint32_t out[4]) {
  const uint32_t t0 = __byte_perm(in[0], in[1], 0x5140);  // in0.b0 in1.b0 in0.b1 in1.b1
  const uint32_t t1 = __byte_perm(in[2], in[3], 0x5140);
  const uint32_t t2 = __byte_perm(in[0], in[1], 0x7362);  // in0.b2 in1.b2 in0.b3 in1.b3
  const uint32_t t3 = __byte_perm(in[2], in[3], 0x7362);
  out[0] = __byte_perm(t0, t1, 0x5410);
  out[1] = __byte_perm(t0, t1, 0x7632);
  out[2] = __byte_perm(t2, t3, 0x5410);
  out[3] = __byte_perm(t2, t3, 0x7632);
}

// This thread's first column (V words per group) and first row; rows
// advance by the grid's height.
template <int V>
__device__ __forceinline__ size_t first_col() {
  return (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) * V;
}

__device__ __forceinline__ size_t first_row() {
  return static_cast<size_t>(blockIdx.y) * blockDim.y + threadIdx.y;
}

__device__ __forceinline__ size_t row_stride() {
  return static_cast<size_t>(gridDim.y) * blockDim.y;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
narrow_kernel(const uint32_t* __restrict__ x, uint8_t* __restrict__ y, size_t rows,
              size_t cols) {
  const size_t c = first_col<V>();
  if (c >= cols) return;
  for (size_t r = first_row(); r < rows; r += row_stride()) {
    uint8_t* dst = y + 4 * r * cols + c;
    if constexpr (V == 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + r * cols + c);
      const uint32_t in[4] = {w.x, w.y, w.z, w.w};
      uint32_t out[4];
      transpose4x4(in, out);
#pragma unroll
      for (int b = 0; b < 4; ++b) *reinterpret_cast<uint32_t*>(dst + b * cols) = out[b];
    } else {
      const uint32_t w = x[r * cols + c];
#pragma unroll
      for (int b = 0; b < 4; ++b) dst[b * cols] = static_cast<uint8_t>(w >> (8 * b));
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
widen_kernel(const uint8_t* __restrict__ x, uint32_t* __restrict__ y, size_t rows,
             size_t cols) {
  const size_t c = first_col<V>();
  if (c >= cols) return;
  for (size_t r = first_row(); r < rows; r += row_stride()) {
    const uint8_t* src = x + 4 * r * cols + c;
    if constexpr (V == 4) {
      uint32_t in[4], out[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) in[b] = *reinterpret_cast<const uint32_t*>(src + b * cols);
      transpose4x4(in, out);
      *reinterpret_cast<uint4*>(y + r * cols + c) = make_uint4(out[0], out[1], out[2], out[3]);
    } else {
      uint32_t w = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) w |= static_cast<uint32_t>(src[b * cols]) << (8 * b);
      y[r * cols + c] = w;
    }
  }
}

template <int V>
__global__ void __launch_bounds__(kThreads)
roll_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ y, size_t rows, size_t cols,
            size_t shift) {
  const size_t c = first_col<V>();
  if (c >= cols) return;
  for (size_t r = first_row(); r < rows; r += row_stride()) {
    const uint32_t* row = x + r * cols;
    // y[r, j] = x[r, (j - shift) mod cols], shift in 0..cols-1
    uint32_t w[V];
#pragma unroll
    for (int t = 0; t < V; ++t) {
      const size_t j = c + t;
      w[t] = row[j >= shift ? j - shift : j + cols - shift];
    }
    if constexpr (V == 4) {
      *reinterpret_cast<uint4*>(y + r * cols + c) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
      y[r * cols + c] = w[0];
    }
  }
}

// Threads along a row cover its column groups (a power of two up to 256);
// the rest of the block's 256 threads take further rows.
void launch_shape(size_t rows, size_t groups, dim3* grid, dim3* block) {
  unsigned tx = 1;
  while (tx < kThreads && tx < groups) tx *= 2;
  const unsigned ty = kThreads / tx;
  *block = dim3(tx, ty);
  *grid = dim3(static_cast<unsigned>((groups + tx - 1) / tx),
               static_cast<unsigned>(std::min<size_t>((rows + ty - 1) / ty, kMaxGridY)));
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

bool bad_shape(long long rows, long long cols) { return rows < 1 || cols < 1; }

// The launchers' code paths (path_counts.cuh), in the order of their names:
// per function the vector path, one word a thread on a width the vector
// path does not take, and one word a thread on a width it takes but on
// pointers misaligned for it.
enum BitcastPath {
  kNarrowVec, kNarrowWord, kNarrowMisaligned, kWidenVec, kWidenWord, kWidenMisaligned,
  kRollVec, kRollWord, kRollMisaligned, kBitcastPaths
};
constexpr const char* kBitcastPathNames[kBitcastPaths] = {
    "narrow vector", "narrow one-word", "narrow one-word, misaligned view",
    "widen vector", "widen one-word", "widen one-word, misaligned view",
    "roll vector", "roll one-word", "roll one-word, misaligned view"};
PathCounts<kBitcastPaths> g_bitcast_paths(kBitcastPathNames);

// Counts one launch of the function whose vector path is `fn`.
void count_variant(BitcastPath fn, long long cols, bool vec) {
  g_bitcast_paths.add(fn + (vec ? 0 : cols % 4 == 0 ? 2 : 1));
}

}  // namespace

extern "C" const char* bitcast_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launchers' path counts in this process (path_counts.cuh).
extern "C" int bitcast_paths(const char** names, unsigned long long* hits, int n) {
  return g_bitcast_paths.read(names, hits, n);
}

// Each launcher runs one kernel on `stream` of CUDA device `device`, with
// device pointers to contiguous tensors, and returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a shape it does not take, or the
// launch error. None synchronises or allocates.

// x (rows, cols) int32 -> y (4 * rows, cols) int8
extern "C" int bitcast_narrow(const void* x, void* y, long long rows, long long cols, int device,
                              void* stream) {
  if (bad_shape(rows, cols)) return cudaErrorInvalidValue;
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = cols % 4 == 0 && aligned(x, 16) && aligned(y, 4);
  dim3 grid, block;
  launch_shape(rows, vec ? cols / 4 : cols, &grid, &block);
  const auto* in = static_cast<const uint32_t*>(x);
  auto* out = static_cast<uint8_t*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    narrow_kernel<4><<<grid, block, 0, s>>>(in, out, rows, cols);
  else
    narrow_kernel<1><<<grid, block, 0, s>>>(in, out, rows, cols);
  err = cudaGetLastError();
  if (err == cudaSuccess) count_variant(kNarrowVec, cols, vec);
  return err;
}

// x (4 * rows, cols) u8 -> y (rows, cols) int32
extern "C" int bitcast_widen(const void* x, void* y, long long rows, long long cols, int device,
                             void* stream) {
  if (bad_shape(rows, cols)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = cols % 4 == 0 && aligned(x, 4) && aligned(y, 16);
  dim3 grid, block;
  launch_shape(rows, vec ? cols / 4 : cols, &grid, &block);
  const auto* in = static_cast<const uint8_t*>(x);
  auto* out = static_cast<uint32_t*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    widen_kernel<4><<<grid, block, 0, s>>>(in, out, rows, cols);
  else
    widen_kernel<1><<<grid, block, 0, s>>>(in, out, rows, cols);
  err = cudaGetLastError();
  if (err == cudaSuccess) count_variant(kWidenVec, cols, vec);
  return err;
}

// x (rows, cols) int32 -> y (rows, cols) int32, rolled by `shift` along the
// row (np.roll's sign: positive moves elements to higher indices)
extern "C" int bitcast_roll(const void* x, void* y, long long rows, long long cols,
                            long long shift, int device, void* stream) {
  if (bad_shape(rows, cols)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t k = static_cast<size_t>(((shift % cols) + cols) % cols);
  const bool vec = cols % 4 == 0 && aligned(y, 16);
  dim3 grid, block;
  launch_shape(rows, vec ? cols / 4 : cols, &grid, &block);
  const auto* in = static_cast<const uint32_t*>(x);
  auto* out = static_cast<uint32_t*>(y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    roll_kernel<4><<<grid, block, 0, s>>>(in, out, rows, cols, k);
  else
    roll_kernel<1><<<grid, block, 0, s>>>(in, out, rows, cols, k);
  err = cudaGetLastError();
  if (err == cudaSuccess) count_variant(kRollVec, cols, vec);
  return err;
}
