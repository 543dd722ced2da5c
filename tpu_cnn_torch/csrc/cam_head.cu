// The single-box CAM head in one launch, for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's head (tpu_cnn/ops/detect_head.py)
// is XLA ops, and the port ran it as ~50 aten launches a batch
// (ops/detect_head.py's detect_with_pooled with box_mode "ref"). Per image,
// from the megakernel's bins (B, 16C) f32 and its bf16 twin of the features
// (B, C, P), P = side^2 pixels, it computes what that function computes:
//
//   1. logits = pooled . fc_weight^T + fc_bias, in f64 (exact products,
//      a closer answer than the plain version's f32 sums, whose order
//      differs from any fixed order by up to ~1e-5 on a lyr4-wide logit;
//      on an H100 the kernel with this step in f32 measured 5-17% slower
//      a batch, in each of four forms); pred = the first index of
//      the largest logit (torch.argmax's tie rule); probs = the softmax
//      (the max subtracted, exp, divided by the sum, the sum in f64);
//      conf = probs[pred];
//   2. each channel's sum over the twin (integers below 2^24, exact in any
//      order): valid[c] = sum / P <= kSaturationMean;
//   3. cam[p] = sum_c fc_weight[pred, 16 c + bin(p)] * valid[c] * twin[c, p]
//      in f32, in a fixed order, only the pixel's own bin column of the 4x4
//      bins; ReLU, then division by the image's largest value where it is
//      > 0;
//   4. the ascending order statistics lo and hi of the P values, and
//      thr = max(a_lo + (a_hi - a_lo) * frac, 0.25) in f32, each step
//      rounded as the plain version's separate ops round it (no fused
//      multiply-add);
//   5. the box of cam > thr: its first and last rows and columns, times
//      img_size / side, the far edges clamped to img_size - 1; the full
//      frame when no pixel passes.
//
// What bounds it on an H100: HBM bytes. An image's twin is C * P * 2 bytes
// (32 KB on lyr3-std, 64 KB on lyr4-wide) and everything else it reads or
// writes (the bins, the outputs) is an eighth of that; the classifier's
// weights (K x 16C f32) are read by every CTA but stay in L1 and L2.
//
// Design: one 256-thread CTA an image, as many on an SM as its shared
// memory allows (four on lyr3-std, two on lyr4-wide), so that one image's
// copy overlaps another's arithmetic: one thread brings the image's bins
// and twin into shared memory with two bulk copies (cp.async.bulk, each
// behind an mbarrier), and the classifier runs on the bins while the twin
// is still on its way. The image is then a short chain of steps between
// barriers, each parallel over the CTA and free of atomics in its loops:
//   - the classifier, one warp a class, and the softmax in one warp;
//   - one pass over the twin in 16-byte chunks of 8 pixels (a warp on
//     neighbouring chunks: conflict-free), a thread's partial CAM sums over
//     a group of channels for its 8 pixels, with the predicted class's
//     weights unmasked, and each chunk's sum kept as 16 bits; then each
//     channel's sum from those. Only where a channel is saturated (rare)
//     is the CAM computed again with its weights zeroed, which gives the
//     same products and sums as masking them in the one pass;
//   - the groups' partial sums added in group order, and the largest;
//   - the order statistics of the values before the division by the
//     largest (the division keeps their order, and divides them exactly
//     as it divides the pixels): a bitonic sort of a value a thread, by
//     shuffles within a warp and through shared memory across warps (at
//     most 256 pixels), else each value's count of those below it;
//   - the box, by warp reductions.
//
// A persistent grid that copied the next image into a second buffer under
// the current one's arithmetic measured slower on the card: the second
// buffer halves the CTAs an SM holds, and the steps' latency, not the
// copies, sets the pace.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "path_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmemBytes = 232448;
constexpr float kSaturationMean = 250.0f;  // head/cam.py's SATURATION_MEAN
constexpr float kThresholdFloor = 0.25f;   // detect_head.CAM_THRESHOLD_FLOOR
constexpr uint32_t kFull = 0xffffffffu;

// The ints after the two mbarriers at the start of shared memory.
enum Misc { kPred, kMaxBits, kLoBits, kHiBits, kRow1, kRow2, kCol1, kCol2, kMiscInts };

struct CamParams {
  const float* pooled;  // (B, 16C) the 4x4 bin means
  const uint4* twin;    // (B, C, P) bf16, in 16-byte chunks of 8 pixels
  const float* weight;  // (K, 16C)
  const float* bias;    // (K,)
  int32_t* pred;        // (B,)
  float* conf;          // (B,)
  float* probs;         // (B, K)
  int32_t* bbox;        // (B, 4) x1, y1, x2, y2
  int channels, pixels, classes;
  int side_log2;  // the CAM is side x side, side a power of two
  int npx_log2;   // a bin is side / 4 pixels wide
  int img_size, scale;
  int lo, hi;  // the order statistics of the percentile
  float frac;  // its interpolation fraction
  int groups;   // 16-byte chunks a channel: P / 8
  int cgroups;  // channel groups of the CAM pass
  // byte offsets into shared memory
  int off_logits, off_csum, off_wv, off_cam, off_part, off_pooled, off_twin;
  int pooled_bytes, twin_bytes;
};

__device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

__device__ __forceinline__ double warp_max(double v) {
  for (int off = 16; off > 0; off >>= 1) v = fmax(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The 8 bf16 values of a 16-byte chunk as f32 (exact: a bf16 is the top
// half of an f32), in pixel order.
__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The CAM's partial sums of one pass over the twin: thread u < cgroups x
// groups takes channel group cg = u / groups (channels cg, cg + cgroups,
// ...) of the 8 pixels of chunk g = u % groups, and writes its 8 sums to
// part[cg][8 g ...]. With kSums, each chunk's sum (an integer 0..2040) goes
// to csum[c][g], rows of groups + 2 sums (an odd number of words: a warp
// on neighbouring channels reads distinct banks). kWide: a bin is at least
// 4 pixels wide, so the chunk's pixels 0-3 share a bin and 4-7 share one
// (the same weights as the general path's, read twice instead of 8 times).
template <bool kSums, bool kWide>
__device__ __forceinline__ void cam_pass(const CamParams& prm, const uint4* twin, const float* wv,
                                         float* part, uint16_t* csum) {
  const int u = threadIdx.x, C = prm.channels, G = prm.groups, cgs = prm.cgroups;
  if (u >= cgs * G) return;
  const int side = 1 << prm.side_log2;
  const int cg = u / G, g = u - cg * G;
  int bins[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int p = 8 * g + k;
    bins[k] = ((p >> prm.side_log2) >> prm.npx_log2) * 4 + ((p & (side - 1)) >> prm.npx_log2);
  }
  float acc[8] = {};
  for (int c = cg; c < C; c += cgs) {
    float x[8];
    unpack8(twin[c * G + g], x);
    const float* w = wv + 16 * c;
    if (kWide) {
      const float w0 = w[bins[0]], w1 = w[bins[4]];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        acc[k] = fmaf(w0, x[k], acc[k]);
        acc[k + 4] = fmaf(w1, x[k + 4], acc[k + 4]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaf(w[bins[k]], x[k], acc[k]);
    }
    if (kSums) {
      // the integer's bits, as the low bits of s + 2^23
      const float s = ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
      csum[c * (G + 2) + g] = static_cast<uint16_t>(__float_as_uint(s + 8388608.0f));
    }
  }
  float4* out = reinterpret_cast<float4*>(part + static_cast<size_t>(cg) * prm.pixels + 8 * g);
  out[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  out[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
}

template <bool kSums>
__device__ __forceinline__ void cam_pass(const CamParams& prm, const uint4* twin, const float* wv,
                                         float* part, uint16_t* csum) {
  if (prm.npx_log2 >= 2) {
    cam_pass<kSums, true>(prm, twin, wv, part, csum);
  } else {
    cam_pass<kSums, false>(prm, twin, wv, part, csum);
  }
}

__global__ void __launch_bounds__(kThreads) cam_head_kernel(const CamParams prm) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // the bins', the twin's
  int* misc = reinterpret_cast<int*>(smem + 16);
  double* logits = reinterpret_cast<double*>(smem + prm.off_logits);
  uint16_t* csum = reinterpret_cast<uint16_t*>(smem + prm.off_csum);
  float* wv = reinterpret_cast<float*>(smem + prm.off_wv);
  float* cam = reinterpret_cast<float*>(smem + prm.off_cam);
  float* part = reinterpret_cast<float*>(smem + prm.off_part);
  double* pooled64 = reinterpret_cast<double*>(smem + prm.off_part);  // before part is written
  uint32_t* xchg = reinterpret_cast<uint32_t*>(smem + prm.off_part);  // after part is read
  const float* pooled = reinterpret_cast<const float*>(smem + prm.off_pooled);
  const uint4* twin = reinterpret_cast<const uint4*>(smem + prm.off_twin);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const int C = prm.channels, P = prm.pixels, K = prm.classes, D = 16 * C, G = prm.groups;
  const int side = 1 << prm.side_log2;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init_fence();
    mbar_expect_tx(&bars[0], prm.pooled_bytes);
    bulk_load(smem + prm.off_pooled, prm.pooled + b * D, prm.pooled_bytes, &bars[0]);
    mbar_expect_tx(&bars[1], prm.twin_bytes);
    bulk_load(smem + prm.off_twin, prm.twin + b * C * G, prm.twin_bytes, &bars[1]);
    misc[kMaxBits] = 0;  // +0.0f: every CAM value is >= 0
    misc[kLoBits] = 0;
    misc[kHiBits] = 0;
    misc[kRow1] = side;
    misc[kRow2] = -1;
    misc[kCol1] = side;
    misc[kCol2] = -1;
  }
  __syncthreads();

  // 1. The classifier on the bins, while the twin comes in: the bins in
  // f64 (each converted once), then one warp a class, its lanes' exact
  // products summed in f64.
  mbar_wait(&bars[0], 0);
  for (int i = tid; i < D; i += kThreads) pooled64[i] = static_cast<double>(pooled[i]);
  __syncthreads();
  for (int k = warp; k < K; k += kWarps) {
    const float* wk = prm.weight + static_cast<size_t>(k) * D;
    double s0 = 0.0, s1 = 0.0;
    for (int i = lane; i < D; i += 64) {
      s0 = fma(pooled64[i], static_cast<double>(__ldg(wk + i)), s0);
      if (i + 32 < D) s1 = fma(pooled64[i + 32], static_cast<double>(__ldg(wk + i + 32)), s1);
    }
    const double s = warp_sum(s0 + s1);
    if (lane == 0) logits[k] = s + static_cast<double>(prm.bias[k]);
  }
  __syncthreads();
  if (warp == 0) {
    // a class a lane, in rounds of 32; torch.argmax: the first NaN if
    // there is one, else the first maximum
    double m = -__longlong_as_double(0x7ff0000000000000ll);
    for (int k = lane; k < K; k += 32) m = fmax(m, logits[k]);
    m = warp_max(m);
    int first_nan = K, first_top = K;
    for (int k = lane; k < K; k += 32) {
      const double l = logits[k];
      if (l != l) first_nan = min(first_nan, k);
      if (l == m) first_top = min(first_top, k);
    }
    first_nan = __reduce_min_sync(kFull, first_nan);
    first_top = __reduce_min_sync(kFull, first_top);
    const int pred = first_nan < K ? first_nan : first_top;
    double sum = 0.0;
    for (int k = lane; k < K; k += 32) sum += expf(static_cast<float>(logits[k] - m));
    const float total = static_cast<float>(warp_sum(sum));
    for (int k = lane; k < K; k += 32) {
      const float pr = expf(static_cast<float>(logits[k] - m)) / total;
      prm.probs[b * K + k] = pr;
      if (k == pred) prm.conf[b] = pr;
    }
    if (lane == 0) {
      prm.pred[b] = pred;
      misc[kPred] = pred;
    }
  }
  __syncthreads();

  // 2. The predicted class's bin weights, then one pass over the twin, then
  // each channel's sum: valid = mean <= 250 as the plain version's f32 mean
  // (P is a power of two: sum / P is exact).
  const float* wrow = prm.weight + static_cast<size_t>(misc[kPred]) * D;
  for (int i = tid; i < D; i += kThreads) wv[i] = __ldg(wrow + i);
  mbar_wait(&bars[1], 0);
  __syncthreads();
  cam_pass<true>(prm, twin, wv, part, csum);
  __syncthreads();
  bool saturated = false;
  for (int c = tid; c < C; c += kThreads) {
    const uint32_t* row = reinterpret_cast<const uint32_t*>(csum + c * (G + 2));
    int s = 0;
    for (int j = 0; j < G / 2; ++j) s += (row[j] & 0xffff) + (row[j] >> 16);
    if (static_cast<float>(s) / static_cast<float>(P) > kSaturationMean) {
      saturated = true;
      for (int j = 0; j < 16; ++j) wv[16 * c + j] = wv[16 * c + j] * 0.f;
    }
  }
  if (__syncthreads_or(saturated)) {
    cam_pass<false>(prm, twin, wv, part, csum);
    __syncthreads();
  }

  // 3. The groups' sums in group order, ReLU, and the largest value.
  int top_bits = 0;
  for (int p = tid; p < P; p += kThreads) {
    float s = part[p];
    for (int cg = 1; cg < prm.cgroups; ++cg) s += part[static_cast<size_t>(cg) * P + p];
    s = s > 0.f ? s : 0.f;
    cam[p] = s;
    top_bits = max(top_bits, __float_as_int(s));  // >= 0: ordered as ints
  }
  top_bits = __reduce_max_sync(kFull, top_bits);
  if (lane == 0) atomicMax(&misc[kMaxBits], top_bits);
  __syncthreads();
  const float top = __int_as_float(misc[kMaxBits]);

  // 4. The order statistics lo and hi of the values before the division by
  // the largest (it keeps their order, and divides them exactly as it
  // divides the pixels), on their bits (all are >= 0, so their bits order
  // as they do).
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(cam);
  if (P <= kThreads) {
    // a bitonic sort of a value a thread (the missing ones above all),
    // across lanes by shuffles and across warps through shared memory (two
    // buffers in turn: one barrier a step)
    uint32_t v = tid < P ? bits[tid] : 0xffffffffu;
    int step = 0;
    for (int k = 2; k <= kThreads; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        uint32_t o;
        if (j >= 32) {
          uint32_t* buf = xchg + (step++ & 1) * kThreads;
          buf[tid] = v;
          __syncthreads();
          o = buf[tid ^ j];
        } else {
          o = __shfl_xor_sync(kFull, v, j);
        }
        v = ((tid & j) == 0) == ((tid & k) == 0) ? min(v, o) : max(v, o);
      }
    }
    if (tid == prm.lo) misc[kLoBits] = static_cast<int>(v);
    if (tid == prm.hi) misc[kHiBits] = static_cast<int>(v);
  } else {
    // a value x is at most the lo-th order statistic exactly when no more
    // than lo values lie below it: a_lo is the largest such x (a_hi
    // likewise), each thread counting for its values against all P
    const uint4* bits4 = reinterpret_cast<const uint4*>(cam);
    uint32_t lo_bits = 0, hi_bits = 0;
    for (int p = tid; p < P; p += kThreads) {
      const uint32_t x = bits[p];
      int below = 0;
      for (int q = 0; q < P / 4; ++q) {
        const uint4 y = bits4[q];
        below += (y.x < x) + (y.y < x) + (y.z < x) + (y.w < x);
      }
      if (below <= prm.lo) lo_bits = max(lo_bits, x);
      if (below <= prm.hi) hi_bits = max(hi_bits, x);
    }
    lo_bits = __reduce_max_sync(kFull, lo_bits);
    hi_bits = __reduce_max_sync(kFull, hi_bits);
    if (lane == 0) {
      atomicMax(reinterpret_cast<unsigned*>(&misc[kLoBits]), lo_bits);
      atomicMax(reinterpret_cast<unsigned*>(&misc[kHiBits]), hi_bits);
    }
  }
  __syncthreads();
  float a_lo = __int_as_float(misc[kLoBits]), a_hi = __int_as_float(misc[kHiBits]);
  if (top > 0.f) {
    a_lo = a_lo / fmaxf(top, 1e-30f);
    a_hi = a_hi / fmaxf(top, 1e-30f);
  }
  const float thr =
      fmaxf(__fadd_rn(a_lo, __fmul_rn(__fsub_rn(a_hi, a_lo), prm.frac)), kThresholdFloor);

  // 5. The box of cam / top > thr.
  int r1 = side, r2 = -1, c1 = side, c2 = -1;
  for (int p = tid; p < P; p += kThreads) {
    float v = cam[p];
    if (top > 0.f) v = v / fmaxf(top, 1e-30f);
    if (v > thr) {
      const int r = p >> prm.side_log2, c = p & (side - 1);
      r1 = min(r1, r);
      r2 = max(r2, r);
      c1 = min(c1, c);
      c2 = max(c2, c);
    }
  }
  r1 = __reduce_min_sync(kFull, r1);
  r2 = __reduce_max_sync(kFull, r2);
  c1 = __reduce_min_sync(kFull, c1);
  c2 = __reduce_max_sync(kFull, c2);
  if (lane == 0) {
    atomicMin(&misc[kRow1], r1);
    atomicMax(&misc[kRow2], r2);
    atomicMin(&misc[kCol1], c1);
    atomicMax(&misc[kCol2], c2);
  }
  __syncthreads();
  if (tid == 0) {
    const int last = prm.img_size - 1, s = prm.scale;
    int4 box = make_int4(0, 0, last, last);
    if (misc[kRow2] >= 0) {
      box = make_int4(misc[kCol1] * s, misc[kRow1] * s, min((misc[kCol2] + 1) * s, last),
                      min((misc[kRow2] + 1) * s, last));
    }
    reinterpret_cast<int4*>(prm.bbox)[b] = box;
  }
}

int align16(int x) { return (x + 15) & ~15; }

int log2_exact(int x) {
  int l = 0;
  while ((1 << l) < x) ++l;
  return (1 << l) == x ? l : -1;
}

// The geometry and the shared-memory plan into *prm; returns the bytes a
// CTA needs, 0 for a geometry the kernel does not take: P = side^2 with
// side a power of two, 4 <= side <= 32 (a thread for each chunk of 8
// pixels), K >= 1, and everything within one CTA's shared memory.
int cam_head_plan(int channels, int pixels, int classes, CamParams* prm) {
  if (channels < 1 || classes < 1 || classes > kMaxSmemBytes / 8 || pixels < 16 ||
      pixels > 8 * kThreads) {
    return 0;
  }
  const int side_log2 = log2_exact(pixels) / 2;
  if (side_log2 < 2 || pixels != 1 << (2 * side_log2)) return 0;
  const long long twin_bytes = 2ll * channels * pixels;
  if (twin_bytes > kMaxSmemBytes) return 0;
  const int groups = pixels / 8;
  const int d = 16 * channels;
  prm->channels = channels;
  prm->pixels = pixels;
  prm->classes = classes;
  prm->side_log2 = side_log2;
  prm->npx_log2 = side_log2 - 2;
  prm->groups = groups;
  prm->cgroups = std::min(kThreads / groups, channels);
  prm->pooled_bytes = 4 * d;
  prm->twin_bytes = static_cast<int>(twin_bytes);
  int off = 16 + 4 * kMiscInts;  // two mbarriers, then the Misc ints
  prm->off_logits = off;
  off = align16(off + 8 * classes);
  prm->off_csum = off;
  off = align16(off + 2 * channels * (groups + 2));
  prm->off_wv = off;
  off = align16(off + 4 * d);
  prm->off_cam = off;
  off = align16(off + 4 * pixels);
  // the bins in f64, then the CAM's partial sums, then the sort's two
  // exchange buffers
  prm->off_part = off;
  off = align16(off + std::max({4 * prm->cgroups * pixels, 8 * d, 8 * kThreads}));
  prm->off_pooled = off;
  off += prm->pooled_bytes;
  prm->off_twin = off;
  const long long total = off + twin_bytes;
  return total <= kMaxSmemBytes ? static_cast<int>(total) : 0;
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum CamPath { kWideBins, kNarrowBins, kBitonic, kCounting, kCamPaths };
constexpr const char* kCamPathNames[kCamPaths] = {
    "bins at least 4 pixels wide (two weights a chunk)",
    "bins narrower than 4 pixels (a weight a pixel)",
    "order statistics by a bitonic sort (at most 256 pixels)",
    "order statistics by counting (more than 256 pixels)"};
PathCounts<kCamPaths> g_cam_paths(kCamPathNames);

// The shared-memory limit raised to the most the kernel may take, once per
// device.
cudaError_t raise_smem_limit(int device) {
  static std::mutex mu;
  static std::vector<int> raised;
  std::lock_guard<std::mutex> lock(mu);
  if (std::find(raised.begin(), raised.end(), device) != raised.end()) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cam_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (err == cudaSuccess) raised.push_back(device);
  return err;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" const char* cam_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launcher's path counts in this process (path_counts.cuh).
extern "C" int cam_head_paths(const char** names, unsigned long long* hits, int n) {
  return g_cam_paths.read(names, hits, n);
}

// The shared memory a CTA takes for a geometry, 0 if the kernel does not
// take it.
extern "C" int cam_head_smem_bytes(int channels, int pixels, int classes) {
  CamParams prm;
  return cam_head_plan(channels, pixels, classes, &prm);
}

// Launches the head on `stream` of CUDA device `device` for a batch of
// `batch` images. Pointers are device pointers to contiguous tensors:
// pooled (B, 16C) f32, twin (B, C, P) bf16 and weight (K, 16C) f32 16-byte
// aligned, bias (K,) f32; the outputs pred (B,) int32, conf (B,) f32,
// probs (B, K) f32 and bbox (B, 4) int32, bbox 16-byte aligned. lo, hi and
// frac are the percentile's order statistics and interpolation fraction,
// as ops/detect_head.py's _percentile_topk computes them on the host.
// Returns a cudaError_t: cudaSuccess, cudaErrorInvalidValue for a geometry
// or an argument the kernel does not take, or the launch error. Neither
// synchronises nor allocates.
extern "C" int cam_head_forward(const void* pooled, const void* twin, const void* weight,
                                const void* bias, void* pred, void* conf, void* probs, void* bbox,
                                int batch, int channels, int pixels, int classes, int img_size,
                                int lo, int hi, float frac, int device, void* stream) {
  CamParams prm;
  const int smem = cam_head_plan(channels, pixels, classes, &prm);
  const int side = 1 << prm.side_log2;
  if (smem == 0 || batch < 0 || img_size < side || img_size % side != 0 || lo < 0 || hi < lo ||
      hi >= pixels) {
    return cudaErrorInvalidValue;
  }
  if (!aligned16(pooled) || !aligned16(twin) || !aligned16(weight) || !aligned16(bbox)) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  prm.pooled = static_cast<const float*>(pooled);
  prm.twin = static_cast<const uint4*>(twin);
  prm.weight = static_cast<const float*>(weight);
  prm.bias = static_cast<const float*>(bias);
  prm.pred = static_cast<int32_t*>(pred);
  prm.conf = static_cast<float*>(conf);
  prm.probs = static_cast<float*>(probs);
  prm.bbox = static_cast<int32_t*>(bbox);
  prm.img_size = img_size;
  prm.scale = img_size / side;
  prm.lo = lo;
  prm.hi = hi;
  prm.frac = frac;
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = raise_smem_limit(device);
  if (err != cudaSuccess) return err;
  cam_head_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  g_cam_paths.add(prm.npx_log2 >= 2 ? kWideBins : kNarrowBins);
  g_cam_paths.add(pixels <= kThreads ? kBitonic : kCounting);
  return cudaSuccess;
}
