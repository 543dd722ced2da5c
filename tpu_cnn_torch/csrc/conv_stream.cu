// One layer of a region-head detector whose weights do not fit a block's
// shared memory, on Hopper's int8 tensor cores (sm_90a): YOLOv2-tiny's L4-L8
// (0.29-9.44 MB of weights each; the layer kernel of conv_layer.cuh holds a
// layer's weights whole in every CTA and takes at most ~227 KB). It
// replaces no TPU kernel: the JAX package has no region-head detector.
//
//     x (B, ic, H, W) u8, NCHW or channels-last (B, H, W, ic)
//     -> SAME k x k conv (k = 1 or 3), exact s32 sums, + bias[oc]
//     -> u8 = clip(>> shift[layer], 0, 255), then the pool: none, 2x2
//        stride 2, or 2x2 stride 1 (the max over (y..y+1, x..x+1) inside
//        the map)                                -> (B, OH, OW, oc) u8
//     or, the linear last layer, the s32 sums    -> (B, H, W, oc) s32
//
// An implicit GEMM: M = output pixels (pre-pool), N = output channels, K =
// k*k taps x ic channels, tap-major (K = tap * ic + c), in slices of 128
// bytes (one tap, 128 channels: ic a multiple of 128). A CTA computes a
// 192 x 128 tile with three consumer warpgroups, each wgmma m64n128k32 with
// A and B from shared memory (no-swizzle K-major core matrices, the layout
// of csrc/hopper.cuh). The weights stream through a ring of four stages:
// one thread puts each slice's 16 KB of B (ops/conv_stream.py's
// pack_stream, already in that layout) in flight with one bulk copy (the
// TMA's 1-D form) behind the stage's mbarrier; every thread stages A, the
// im2col of its own M row, by cp.async (16 bytes of channels a copy from a
// channels-last map, zero past the edges) or byte by byte from an NCHW map.
// Loads run two slices ahead of the MMAs, and a slice's MMAs overlap the
// next one's wait.
//
// M rows map to pixels by the pool: without one, row = the batch's pixels
// in order; with the 2x2/2 pool, four consecutive rows are one pooling
// window, so the pool is a max over lanes (shuffles by 4 and 8) in
// registers; with the 2x2/1 pool, a CTA takes one whole image (H * W <=
// 192 rows), its clipped bytes gathered in shared memory, and pools there.
//
// What bounds it on an H100: operations. L6-L7 are 2.39 G MACs a frame of
// 2.8 G in L4-L8 against 16 MB of weights (read from L2 once a CTA) and
// ~0.8 MB of maps in and out; the design spends its care on keeping the
// tensor cores fed (the ring, two slices of loads in flight) and is right
// and simple first: no warp specialisation, no persistent grid, no swizzle.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "path_counts.cuh"

namespace {

constexpr int kThreads = 384;  // three consumer warpgroups
constexpr int kTM = 192;       // M rows of a tile
constexpr int kTN = 128;       // N columns of a tile
constexpr int kTK = 128;       // K bytes of a slice
constexpr int kStages = 4;
constexpr int kAhead = kStages - 2;  // slices of loads in flight
constexpr int kRowGroups = kTM / 8;
constexpr int kABytes = kTM * kTK;
constexpr int kBBytes = kTN * kTK;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmem = kStages * kStageBytes + 64;  // + the mbarriers

enum Mode { kPlain, kPool2, kPool1, kLinear };

struct StreamArgs {
  const uint8_t* x;
  const int8_t* w;        // packed: (N tiles, slices, 16 KB)
  const int32_t* bias;    // (oc,)
  const int32_t* shifts;  // read at `layer`
  void* out;
  int layer, ic, oc, height, width, k;
  int rows_per_image;  // M rows of one image
  long long m_rows;    // batch * rows_per_image
  int slices;          // k * k * ic / 128
};

__device__ __forceinline__ void cp_async16(uint32_t smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kAhead - 1) : "memory");
}

__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// d += A (64 x 32 u8) x B (32 x 128 s8), both from shared memory.
__device__ __forceinline__ void wgmma_ss(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ int clip_shift(int v, int shift) {
  return min(max(v >> shift, 0), 255);  // >> on int is arithmetic (floor)
}

// The image and pixel of M row `row` (-1 for a row past the batch or, with
// the 2x2/1 pool, past the image's pixels).
template <int MODE>
__device__ __forceinline__ void row_pixel(const StreamArgs& a, long long row, int& b, int& y,
                                          int& x) {
  b = y = x = -1;
  if (row >= a.m_rows) return;
  const int W = a.width;
  if (MODE == kPool2) {
    const long long q = row >> 2;  // the pooling window over the batch
    const int sub = static_cast<int>(row & 3);
    const int ow = W / 2, per = (a.height / 2) * ow;
    b = static_cast<int>(q / per);
    const int p = static_cast<int>(q - static_cast<long long>(b) * per);
    y = 2 * (p / ow) + (sub >> 1);
    x = 2 * (p % ow) + (sub & 1);
  } else {
    b = static_cast<int>(row / a.rows_per_image);
    const int p = static_cast<int>(row - static_cast<long long>(b) * a.rows_per_image);
    if (p >= a.height * W) {
      b = -1;
      return;
    }
    y = p / W;
    x = p % W;
  }
}

// This thread's chunks of A for slice `ks`: M row `m`, 16-byte K chunks
// c0, c0 + 2, c0 + 4, c0 + 6, into the stage's no-swizzle core matrices
// (chunk c of row m at ((c / 2 * kRowGroups + m / 8) * 2 + c % 2) * 128 +
// (m % 8) * 16).
template <bool NHWC>
__device__ __forceinline__ void stage_a(const StreamArgs& a, uint32_t sa, int ks, int m, int c0,
                                        int b, int y, int x) {
  const int cslices = a.ic / kTK;
  const int tap = ks / cslices;
  const int cb = (ks - tap * cslices) * kTK;
  const int half = a.k / 2;
  const int yy = y + tap / a.k - half, xx = x + tap % a.k - half;
  const bool in = b >= 0 && static_cast<unsigned>(yy) < static_cast<unsigned>(a.height) &&
                  static_cast<unsigned>(xx) < static_cast<unsigned>(a.width);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int c = c0 + 2 * u;
    const uint32_t dst =
        sa + (((c >> 1) * kRowGroups + (m >> 3)) * 2 + (c & 1)) * 128 + (m & 7) * 16;
    if (NHWC) {
      const uint8_t* src =
          in ? a.x + ((static_cast<size_t>(b) * a.height + yy) * a.width + xx) * a.ic + cb +
                   16 * c
             : a.x;
      cp_async16(dst, src, in);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const size_t plane = static_cast<size_t>(a.height) * a.width;
        const uint8_t* src = a.x + (static_cast<size_t>(b) * a.ic + cb + 16 * c) * plane +
                             static_cast<size_t>(yy) * a.width + xx;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          v[i >> 2] |= static_cast<uint32_t>(__ldg(src + i * plane)) << (8 * (i & 3));
        }
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
                   :: "r"(dst), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3]) : "memory");
    }
  }
}

template <int MODE, bool NHWC>
__global__ void __launch_bounds__(kThreads, 1) conv_stream_kernel(StreamArgs a) {
  extern __shared__ __align__(1024) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  const int tid = threadIdx.x;
  const int nt = blockIdx.x;
  const long long row0 = static_cast<long long>(blockIdx.y) * kTM;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&bars[s], 1);
    mbar_init_fence();
  }
  __syncthreads();

  const int m = tid % kTM, c0 = tid / kTM;
  int b, y, x;
  row_pixel<MODE>(a, row0 + m, b, y, x);
  const uint32_t s0 = smem_u32(smem);
  const int8_t* wt = a.w + static_cast<size_t>(nt) * a.slices * kBBytes;
  auto issue = [&](int ks) {
    const int st = ks % kStages;
    const uint32_t sa = s0 + st * kStageBytes;
    if (tid == 0) {
      mbar_expect_tx(&bars[st], kBBytes);
      bulk_load(smem + st * kStageBytes + kABytes, wt + static_cast<size_t>(ks) * kBBytes,
                kBBytes, &bars[st]);
    }
    stage_a<NHWC>(a, sa, ks, m, c0, b, y, x);
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const int wg = tid / 128;
  for (int ks = 0; ks < kAhead; ++ks) {
    issue(ks);
    cp_async_commit();
  }
  for (int ks = 0; ks < a.slices; ++ks) {
    const int st = ks % kStages;
    cp_async_wait_ahead();  // this thread's A of slice ks has landed
    fence_proxy_async();    // ... and is visible to the tensor cores
    mbar_wait(&bars[st], (ks / kStages) & 1);
    __syncthreads();  // every thread's A; the MMAs of slice ks - 2 are done
    if (ks + kAhead < a.slices) issue(ks + kAhead);
    cp_async_commit();
    const uint32_t sa = s0 + st * kStageBytes, sb = sa + kABytes;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kTK / 32; ++s) {
      wgmma_ss(acc, wgmma_desc(sa + (s * kRowGroups + 8 * wg) * 256, 128, 256),
               wgmma_desc(sb + (s * (kTN / 8)) * 256, 128, 256));
    }
    wgmma_commit();
    wgmma_wait_one();
  }
  wgmma_wait_all();
  fence_regs(acc);

  // acc[4j + e]: row 64 wg + 16 (warp % 4) + g (+ 8 for e >= 2) of the tile,
  // column 8j + 2t + (e & 1)
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int rbase = 64 * wg + 16 * ((tid >> 5) & 3) + g;
  const int shift = min(max(a.shifts[a.layer], 0), 31);
  const int n0 = nt * kTN;
  auto bias = [&](int j, int e) {
    const int n = n0 + 8 * j + 2 * t4 + e;
    return n < a.oc ? __ldg(a.bias + n) : 0;
  };

  if (MODE == kLinear) {
    int32_t* out = static_cast<int32_t*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      if (row >= a.m_rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t4 + e;
          if (n < a.oc) out[row * a.oc + n] = acc[4 * j + 2 * h + e] + bias(j, e);
        }
      }
    }
  } else if (MODE == kPlain || MODE == kPool2) {
    uint8_t* out = static_cast<uint8_t*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      uint32_t v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        int p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int s = acc[4 * j + 2 * h + e];
          if (MODE == kPool2) {  // the window: rows g ^ 1, g ^ 2, g ^ 3
            s = max(s, __shfl_xor_sync(0xffffffffu, s, 4));
            s = max(s, __shfl_xor_sync(0xffffffffu, s, 8));
          }
          p[e] = clip_shift(s + bias(j, e), shift);
        }
        v[j] = static_cast<uint32_t>(p[0] | (p[1] << 8));
      }
      if (row >= a.m_rows || (MODE == kPool2 && (g & 3) != 0)) continue;
      const long long orow = MODE == kPool2 ? row >> 2 : row;
      uint8_t* o = out + orow * a.oc + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (n0 + 8 * j + 2 * t4 + 1 < a.oc) {
          *reinterpret_cast<uint16_t*>(o + 8 * j) = static_cast<uint16_t>(v[j]);
        }
      }
    }
  } else {  // kPool1: one image a tile; pool its clipped bytes in shared memory
    __syncthreads();  // every warpgroup is done with the ring
    uint8_t* tile = smem;  // (kTM, kTN) bytes
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int v0 = clip_shift(acc[4 * j + 2 * h] + bias(j, 0), shift);
        const int v1 = clip_shift(acc[4 * j + 2 * h + 1] + bias(j, 1), shift);
        *reinterpret_cast<uint16_t*>(tile + r * kTN + 8 * j + 2 * t4) =
            static_cast<uint16_t>(v0 | (v1 << 8));
      }
    }
    __syncthreads();
    const int H = a.height, W = a.width, np = H * W;
    const int bi = blockIdx.y;
    uint8_t* out = static_cast<uint8_t*>(a.out) + static_cast<size_t>(bi) * np * a.oc + n0;
    const int cols = min(kTN, a.oc - n0);
    for (int i = tid; i < np * kTN; i += kThreads) {
      const int p = i / kTN, c = i - p * kTN;
      if (c >= cols) continue;
      const int py = p / W, px = p - py * W;
      const uint8_t* t = tile + p * kTN + c;
      int v = t[0];
      if (px + 1 < W) v = max(v, static_cast<int>(t[kTN]));
      if (py + 1 < H) {
        v = max(v, static_cast<int>(t[W * kTN]));
        if (px + 1 < W) v = max(v, static_cast<int>(t[(W + 1) * kTN]));
      }
      out[static_cast<size_t>(p) * a.oc + c] = static_cast<uint8_t>(v);
    }
  }
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum StreamPath {
  kPathNchw, kPathNhwc, kPathPlain, kPathPool2, kPathPool1, kPathLinear, kPathK1,
  kPathPartialN, kPathPartialM, kStreamPaths
};
constexpr const char* kStreamPathNames[kStreamPaths] = {
    "A staged byte by byte from an NCHW map", "A by cp.async from a channels-last map",
    "no pool", "pool 2x2 stride 2 across lanes", "pool 2x2 stride 1 in shared memory",
    "linear s32 out", "1x1 kernel", "a partial N tile (oc % 128 != 0)",
    "a partial M tile"};
PathCounts<kStreamPaths> g_stream_paths(kStreamPathNames);

using StreamKernel = void (*)(StreamArgs);

template <int MODE>
StreamKernel stream_kernel(bool nhwc) {
  return nhwc ? conv_stream_kernel<MODE, true> : conv_stream_kernel<MODE, false>;
}

}  // namespace

extern "C" const char* conv_stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int conv_stream_paths(const char** names, unsigned long long* hits, int n) {
  return g_stream_paths.read(names, hits, n);
}

// Launches one layer on `stream` of CUDA device `device`: x (B, ic, H, W)
// u8, NCHW (nhwc 0) or channels-last (nhwc 1); w the packed weights
// (ops/conv_stream.py's pack_stream), bias (oc,) s32, shifts a device s32
// vector read at `layer`; out (B, OH, OW, oc) u8, or with `linear` (B, H,
// W, oc) s32 and no pool. pool: 0, 1 (2x2 stride 1; H * W <= 192) or 2 (2x2
// stride 2; H, W even). Takes ic a multiple of 128, k 1 or 3. Returns a
// cudaError_t: cudaSuccess, cudaErrorInvalidValue for a geometry the kernel
// does not take, or the launch error. Neither synchronises nor allocates.
extern "C" int conv_stream_forward(const void* x, int nhwc, const void* w, const void* bias,
                                   const void* shifts, int layer, void* out, int batch, int ic,
                                   int oc, int height, int width, int k, int pool, int linear,
                                   int device, void* stream) {
  if (batch < 0 || ic < kTK || ic % kTK != 0 || oc < 1 || layer < 0 || height < 1 ||
      width < 1 || (k != 1 && k != 3) || pool < 0 || pool > 2 || (linear && pool != 0) ||
      (!linear && oc % 2 != 0)) {
    return cudaErrorInvalidValue;
  }
  if (pool == 2 && (height % 2 != 0 || width % 2 != 0)) return cudaErrorInvalidValue;
  if (pool == 1 && height * width > kTM) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  const int mode = linear ? kLinear : pool == 2 ? kPool2 : pool == 1 ? kPool1 : kPlain;
  StreamArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const int32_t*>(bias);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.out = out;
  a.layer = layer;
  a.ic = ic;
  a.oc = oc;
  a.height = height;
  a.width = width;
  a.k = k;
  a.slices = k * k * ic / kTK;
  a.rows_per_image = mode == kPool1 ? kTM : height * width;
  a.m_rows = static_cast<long long>(batch) * a.rows_per_image;
  const long long m_tiles = (a.m_rows + kTM - 1) / kTM;
  const int n_tiles = (oc + kTN - 1) / kTN;
  if (m_tiles > 65535 || a.slices < kAhead) return cudaErrorInvalidValue;

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const StreamKernel kernel = mode == kLinear ? stream_kernel<kLinear>(nhwc != 0)
                            : mode == kPool2  ? stream_kernel<kPool2>(nhwc != 0)
                            : mode == kPool1  ? stream_kernel<kPool1>(nhwc != 0)
                                              : stream_kernel<kPlain>(nhwc != 0);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, static_cast<unsigned>(m_tiles));
  kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_stream_paths.add(nhwc ? kPathNhwc : kPathNchw);
    g_stream_paths.add(mode == kLinear ? kPathLinear : mode == kPool2 ? kPathPool2
                       : mode == kPool1 ? kPathPool1 : kPathPlain);
    if (k == 1) g_stream_paths.add(kPathK1);
    if (oc % kTN != 0) g_stream_paths.add(kPathPartialN);
    if (a.m_rows % kTM != 0) g_stream_paths.add(kPathPartialM);
  }
  return err;
}
