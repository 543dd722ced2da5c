// The [yolo] head of a YOLOv3 detector (darknet's yolo_layer.c
// get_yolo_detections over its three heads, then do_nms_sort and the best
// max_det pairs), one CTA an image, for NVIDIA Hopper (sm_90a). It
// replaces no TPU kernel: the JAX package has no region-head detector.
//
//     t_h (B, g_h, g_h, 3 (5 + C)) s32, channels-last, h = 0, 1, 2: the
//     linear layers' sums of the three heads
//     -> per box (head h, cell i g_h + j, anchor n of the head's mask;
//        darknet's order: head by head, cell-major, anchor inner):
//        v = sum / 2^shift[layer_h]; objectness o = sigmoid(v_o), a box
//        only where o > thresh; x = (j + sigmoid(v_x)) / g_h, y = (i +
//        sigmoid(v_y)) / g_h, w = exp(v_w) a_w / net, h = exp(v_h) a_h /
//        net (anchors in pixels); class k scores o sigmoid(v_ck), 0 at or
//        below thresh
//     -> per class, greedy NMS in order of score (ties: the lower index):
//        a kept pair drops every later pair of its class whose box's IoU
//        with its box exceeds nms
//     -> dets (B, max_det, 6) f32 (x, y, w, h, score, class) in order of
//        score (ties: the lower index, then the lower class), zero past
//        count (B,) s32 = min(pairs left, max_det)
//
// The scaled decode (YOLOv7's Detect, darknet's new_coords=1 with
// scale_x_y=2) is the kernel's other instantiation: x = (j + 2 sigmoid(v_x)
// - 0.5) / g_h, y likewise, w = (2 sigmoid(v_w))^2 a_w / net, h likewise;
// it takes up to 32,768 boxes (a key's candidate in 15 bits: YOLOv7-640's
// 25,200) and 320 kept pairs (test.py's 300), the darknet one 16,384 boxes
// and 256 pairs.
//
// Float32 throughout; the plain version is ops/yolo_head.py's.
//
// A frame's scores alone (10,647 boxes x 80 classes x 4 B = 3.4 MB for
// YOLOv3-416) are fifteen times a block's shared memory, so the head
// compacts first and never holds the dense scores:
//
// 1. One pass over the boxes' objectness (one 4-byte load a box) keeps
//    the candidates, in darknet's order by a block-wide ballot scan, and
//    decodes only them into a workspace in global memory.
// 2. A warp a candidate computes its class scores (its 80 sums one
//    coalesced read) and keeps each pair above thresh as a 64-bit key that
//    orders pairs as the answer does: score descending, then candidate
//    (darknet's index), then class. The keys land in shared memory and are
//    sorted there (bitonic, over the next power of two of the pairs).
// 3. One warp walks the sorted pairs, 32 at a time (each lane loads one
//    pair's box, so the walk waits on no load): a pair survives unless a
//    kept pair of its class overlaps it past nms (the lanes test the kept
//    pairs at once), and the walk ends at max_det kept pairs. Per-class
//    greedy NMS visits a class's pairs in this same order, and every pair
//    kept before a pair is in the list, so the walk is do_nms_sort and the
//    cut in one.
//
// More pairs than the key buffer holds are taken in pages of the smallest
// keys left (a search over the key's bits bounds each page), until
// max_det pairs are kept or none are left.

#include <cstdint>

#include <cuda_runtime.h>

#include "path_counts.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 3;
constexpr int kAnchorsHead = 3;        // anchors a head (its mask)
constexpr int kPage = 16384;           // keys a page (128 KB of dynamic shared memory)
constexpr int kClassBits = 7;          // a class in a key
constexpr int kMaxClasses = 1 << kClassBits;
// each decode's candidate number in a key, and the kept pairs shared memory holds
constexpr int kDarknetCandBits = 14, kDarknetMaxDet = 256;
constexpr int kScaledCandBits = 15, kScaledMaxDet = 320;  // YOLOv7-640's 25,200 boxes, 300 pairs

struct YoloArgs {
  const int32_t* t[kHeads];
  const int32_t* shifts;  // read at layers[h]
  int layers[kHeads], grids[kHeads];
  float anchor_w[kHeads][kAnchorsHead], anchor_h[kHeads][kAnchorsHead];
  float4* boxes;   // workspace (B, boxes_n): the candidates' boxes
  float* obj;      // workspace (B, boxes_n): their objectness
  int32_t* cand;   // workspace (B, boxes_n): their box numbers
  float* dets;
  int32_t* count;
  int classes, boxes_n, max_det;
  float net, thresh, nms;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ float overlap(float c1, float w1, float c2, float w2) {
  const float left = fmaxf(c1 - w1 / 2, c2 - w2 / 2);
  const float right = fminf(c1 + w1 / 2, c2 + w2 / 2);
  return right - left;
}

// darknet's box_iou
__device__ __forceinline__ float box_iou(float4 a, float4 b) {
  const float w = overlap(a.x, a.z, b.x, b.z), h = overlap(a.y, a.w, b.y, b.w);
  const float inter = (w < 0 || h < 0) ? 0.0f : w * h;
  return inter / (a.z * a.w + b.z * b.w - inter);
}

// A pair's key: smaller keys come first in the answer (score descending,
// then candidate, then class); the score is positive, so its bits order it.
template <int kCandBits>
__device__ __forceinline__ uint64_t pair_key(float s, int c, int k) {
  return (static_cast<uint64_t>(0xFFFFFFFFu - __float_as_uint(s)) << (kCandBits + kClassBits)) |
         (static_cast<uint64_t>(c) << kClassBits) | static_cast<uint64_t>(k);
}

template <int kCandBits>
__device__ __forceinline__ float key_score(uint64_t key) {
  return __uint_as_float(0xFFFFFFFFu - static_cast<uint32_t>(key >> (kCandBits + kClassBits)));
}

// Head, cell and anchor of box `id` (darknet's order), and its sums.
__device__ __forceinline__ const int32_t* box_sums(const YoloArgs& a, int b, int id, int& h,
                                                  int& cell, int& n) {
  const int E = 5 + a.classes;
  int base = 0;
  for (h = 0; h < kHeads - 1; ++h) {
    const int nb = kAnchorsHead * a.grids[h] * a.grids[h];
    if (id < base + nb) break;
    base += nb;
  }
  const int local = id - base, g2 = a.grids[h] * a.grids[h];
  cell = local / kAnchorsHead;
  n = local - cell * kAnchorsHead;
  return a.t[h] + (static_cast<size_t>(b) * g2 + cell) * (kAnchorsHead * E) + n * E;
}

__device__ __forceinline__ float head_scale(const YoloArgs& a, int h) {
  return scalbnf(1.0f, -min(max(__ldg(a.shifts + a.layers[h]), 0), 31));
}

// Each pair of this image above thresh whose key lies in (lo, hi]: into
// `keys` (its first kPage) when `keys` is given; returns how many there
// are (every thread).
template <int kCandBits>
__device__ int collect(const YoloArgs& a, int b, int ncand, uint64_t lo, uint64_t hi,
                       uint64_t* keys, int* counter) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* obj = a.obj + static_cast<size_t>(b) * a.boxes_n;
  const int32_t* cand = a.cand + static_cast<size_t>(b) * a.boxes_n;
  if (tid == 0) *counter = 0;
  __syncthreads();
  constexpr int kPer = kMaxClasses / 32;  // classes a lane
  for (int c = warp; c < ncand; c += kWarps) {
    int h, cell, n;
    const int32_t* v = box_sums(a, b, cand[c], h, cell, n);
    const float scale = head_scale(a, h), o = obj[c];
    int32_t sums[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // every load first: one wait a candidate
      const int k = lane + 32 * i;
      sums[i] = k < a.classes ? v[5 + k] : 0;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int k = lane + 32 * i;
      if (k >= a.classes) continue;
      const float s = o * sigmoid(__int2float_rn(sums[i]) * scale);
      if (!(s > a.thresh)) continue;
      const uint64_t key = pair_key<kCandBits>(s, c, k);
      if (key <= lo || key > hi) continue;
      const int at = atomicAdd(counter, 1);
      if (keys != nullptr && at < kPage) keys[at] = key;
    }
  }
  __syncthreads();
  const int total = *counter;
  __syncthreads();
  return total;
}

// The head, its decode the scaled one or darknet's, candidates numbered in
// kCandBits of a key, up to kMaxDet kept pairs.
template <bool kScaled, int kCandBits, int kMaxDet>
__global__ void __launch_bounds__(kThreads, 1) yolo_head_kernel(YoloArgs a) {
  constexpr int kMaxBoxes = 1 << kCandBits;
  extern __shared__ __align__(16) uint64_t keys[];  // kPage
  __shared__ float4 kept_box[kMaxDet];
  __shared__ int kept_class[kMaxDet];
  __shared__ uint64_t kept_key[kMaxDet];
  __shared__ int warp_sum[kWarps];
  __shared__ int counter;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* boxes = a.boxes + static_cast<size_t>(b) * a.boxes_n;
  float* obj = a.obj + static_cast<size_t>(b) * a.boxes_n;
  int32_t* cand = a.cand + static_cast<size_t>(b) * a.boxes_n;

  // 1. the candidates, in order: a ballot scan a round of kThreads boxes
  int ncand = 0;
  for (int base = 0; base < a.boxes_n; base += kThreads) {
    const int id = base + tid;
    bool keep = false;
    float o = 0.0f, scale = 1.0f;
    int h = 0, cell = 0, n = 0;
    const int32_t* v = nullptr;
    if (id < a.boxes_n) {
      v = box_sums(a, b, id, h, cell, n);
      scale = head_scale(a, h);
      o = sigmoid(__int2float_rn(v[4]) * scale);
      keep = o > a.thresh;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) warp_sum[warp] = __popc(mask);
    __syncthreads();
    if (warp == 0) {
      const int mine = warp_sum[lane];
      int incl = mine;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      warp_sum[lane] = incl - mine;  // exclusive
    }
    __syncthreads();
    if (keep) {
      const int at = ncand + warp_sum[warp] + __popc(mask & ((1u << lane) - 1));
      const int g = a.grids[h], i = cell / g, j = cell - i * g;
      float4 box;
      if constexpr (kScaled) {
        const float sw = 2.0f * sigmoid(__int2float_rn(v[2]) * scale);
        const float sh = 2.0f * sigmoid(__int2float_rn(v[3]) * scale);
        box.x = (static_cast<float>(j) + (2.0f * sigmoid(__int2float_rn(v[0]) * scale) - 0.5f)) / g;
        box.y = (static_cast<float>(i) + (2.0f * sigmoid(__int2float_rn(v[1]) * scale) - 0.5f)) / g;
        box.z = sw * sw * a.anchor_w[h][n] / a.net;
        box.w = sh * sh * a.anchor_h[h][n] / a.net;
      } else {
        box.x = (static_cast<float>(j) + sigmoid(__int2float_rn(v[0]) * scale)) / g;
        box.y = (static_cast<float>(i) + sigmoid(__int2float_rn(v[1]) * scale)) / g;
        box.z = expf(__int2float_rn(v[2]) * scale) * a.anchor_w[h][n] / a.net;
        box.w = expf(__int2float_rn(v[3]) * scale) * a.anchor_h[h][n] / a.net;
      }
      boxes[at] = box;
      obj[at] = o;
      cand[at] = id;
    }
    // the round's count: the last warp's exclusive sum and its own
    if (tid == kThreads - 1) counter = warp_sum[kWarps - 1] + __popc(mask);
    __syncthreads();
    ncand += counter;
    __syncthreads();
  }
  // 2-3. pages of pairs, sorted, walked
  int nk = 0;  // kept pairs (uniform)
  uint64_t last = 0;
  const uint64_t kNone = ~0ull;
  for (;;) {
    int n = collect<kCandBits>(a, b, ncand, last, kNone, keys, &counter);
    if (n == 0) break;
    const bool more = n > kPage;
    if (more) {  // the kPage smallest keys left: the largest bound holding at most kPage
      uint64_t lo = last, hi = (1ull << (32 + kCandBits + kClassBits)) - 1;
      while (hi - lo > 1) {
        const uint64_t mid = lo + (hi - lo) / 2;
        if (collect<kCandBits>(a, b, ncand, last, mid, nullptr, &counter) <= kPage) lo = mid;
        else hi = mid;
      }
      n = collect<kCandBits>(a, b, ncand, last, lo, keys, &counter);
    }
    int width = 1;
    while (width < n) width <<= 1;
    for (int i = n + tid; i < width; i += kThreads) keys[i] = kNone;
    __syncthreads();
    for (int size = 2; size <= width; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < width; i += kThreads) {
          const int j = i ^ stride;
          if (j > i) {
            const uint64_t x = keys[i], y = keys[j];
            const bool up = (i & size) == 0;
            if ((x > y) == up) {
              keys[i] = y;
              keys[j] = x;
            }
          }
        }
        __syncthreads();
      }
    }
    if (warp == 0) {
      for (int i0 = 0; i0 < n && nk < a.max_det; i0 += 32) {
        // this lane's pair of the next 32: its key, class and box
        const uint64_t mine = i0 + lane < n ? keys[i0 + lane] : 0;
        const int mine_k = static_cast<int>(mine & (kMaxClasses - 1));
        const float4 mine_box =
            i0 + lane < n ? boxes[(mine >> kClassBits) & (kMaxBoxes - 1)] : make_float4(0, 0, 0, 0);
        const int m = min(32, n - i0);
        for (int j = 0; j < m && nk < a.max_det; ++j) {
          const int k = __shfl_sync(0xffffffffu, mine_k, j);
          float4 bx;
          bx.x = __shfl_sync(0xffffffffu, mine_box.x, j);
          bx.y = __shfl_sync(0xffffffffu, mine_box.y, j);
          bx.z = __shfl_sync(0xffffffffu, mine_box.z, j);
          bx.w = __shfl_sync(0xffffffffu, mine_box.w, j);
          bool hit = false;
          for (int q = lane; q < nk; q += 32) {
            hit |= kept_class[q] == k && box_iou(kept_box[q], bx) > a.nms;
          }
          if (__any_sync(0xffffffffu, hit)) continue;
          if (lane == j) {
            kept_box[nk] = bx;
            kept_class[nk] = k;
            kept_key[nk] = mine;
          }
          __syncwarp();
          ++nk;
        }
      }
      if (lane == 0) counter = nk;
    }
    __syncthreads();
    nk = counter;
    __syncthreads();
    if (nk >= a.max_det || !more) break;
    last = keys[n - 1];
    __syncthreads();
  }

  float* db = a.dets + static_cast<size_t>(b) * a.max_det * 6;
  for (int r = tid; r < a.max_det; r += kThreads) {
    float* d = db + r * 6;
    if (r < nk) {
      const float4 bx = kept_box[r];
      d[0] = bx.x;
      d[1] = bx.y;
      d[2] = bx.z;
      d[3] = bx.w;
      d[4] = key_score<kCandBits>(kept_key[r]);
      d[5] = static_cast<float>(kept_class[r]);
    } else {
      for (int e = 0; e < 6; ++e) d[e] = 0.0f;
    }
  }
  if (tid == 0) a.count[b] = nk;
}

enum YoloPath { kPathOnePage, kPathPages, kPathScaled, kYoloPaths };
constexpr const char* kYoloPathNames[kYoloPaths] = {
    "launch: every image's pairs in one page of keys (host view: the workspace's size)",
    "launch: pages possible (more boxes x classes than a page holds)",
    "decode: the scaled one (YOLOv7's)"};
PathCounts<kYoloPaths> g_yolo_paths(kYoloPathNames);

}  // namespace

extern "C" const char* yolo_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int yolo_head_paths(const char** names, unsigned long long* hits, int n) {
  return g_yolo_paths.read(names, hits, n);
}

// Bytes of workspace an image takes at `boxes_n` boxes (the caller's
// buffer: boxes, objectness and box numbers of the candidates).
extern "C" long long yolo_head_workspace_bytes(int boxes_n) {
  return static_cast<long long>(boxes_n) * (16 + 4 + 4);
}

// Launches the head on `stream` of CUDA device `device`: t0..t2 the three
// heads' (B, g_h, g_h, 3 (5 + classes)) s32 sums, shifts a device s32
// vector read at layers[h], anchors (3, 3, 2) f32 host values (each head's
// mask's anchors, in pixels), `net` the input side, workspace
// yolo_head_workspace_bytes(boxes) x B bytes (16-byte aligned), dets (B,
// max_det, 6) f32, count (B,) s32; `scaled` 0 the darknet decode, 1 the
// scaled one. Takes at most 16,384 boxes a frame and max_det 256 (scaled:
// 32,768 and 320), and 128 classes. Returns a cudaError_t: cudaSuccess,
// cudaErrorInvalidValue for a geometry the kernel does not take, or the
// launch error. Neither synchronises nor allocates.
extern "C" int yolo_head_forward(const void* t0, const void* t1, const void* t2,
                                 const void* shifts, const int* layers, const int* grids,
                                 const float* anchors, float net, void* workspace, void* dets,
                                 void* count, int batch, int classes, float thresh, float nms,
                                 int max_det, int scaled, int device, void* stream) {
  YoloArgs a;
  const void* t[kHeads] = {t0, t1, t2};
  long long boxes_n = 0;
  for (int h = 0; h < kHeads; ++h) {
    if (grids[h] < 1 || layers[h] < 0) return cudaErrorInvalidValue;
    a.t[h] = static_cast<const int32_t*>(t[h]);
    a.layers[h] = layers[h];
    a.grids[h] = grids[h];
    boxes_n += 1LL * kAnchorsHead * grids[h] * grids[h];
    for (int n = 0; n < kAnchorsHead; ++n) {
      a.anchor_w[h][n] = anchors[(h * kAnchorsHead + n) * 2];
      a.anchor_h[h][n] = anchors[(h * kAnchorsHead + n) * 2 + 1];
    }
  }
  const int max_boxes = 1 << (scaled ? kScaledCandBits : kDarknetCandBits);
  const int most_det = scaled ? kScaledMaxDet : kDarknetMaxDet;
  if (batch < 0 || classes < 1 || classes > kMaxClasses || boxes_n > max_boxes ||
      (scaled != 0 && scaled != 1) || max_det < 1 || max_det > most_det || !(net > 0.0f) ||
      (reinterpret_cast<uintptr_t>(workspace) & 15) != 0) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  char* ws = static_cast<char*>(workspace);
  const size_t per = static_cast<size_t>(batch) * boxes_n;
  a.boxes = reinterpret_cast<float4*>(ws);
  a.obj = reinterpret_cast<float*>(ws + per * 16);
  a.cand = reinterpret_cast<int32_t*>(ws + per * 20);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.dets = static_cast<float*>(dets);
  a.count = static_cast<int32_t*>(count);
  a.classes = classes;
  a.boxes_n = static_cast<int>(boxes_n);
  a.max_det = max_det;
  a.net = net;
  a.thresh = thresh;
  a.nms = nms;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kSmem = kPage * sizeof(uint64_t);
  using Kernel = void (*)(YoloArgs);
  const Kernel kernel = scaled ? Kernel(yolo_head_kernel<true, kScaledCandBits, kScaledMaxDet>)
                               : Kernel(yolo_head_kernel<false, kDarknetCandBits, kDarknetMaxDet>);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  kernel<<<batch, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_yolo_paths.add(boxes_n * classes <= kPage ? kPathOnePage : kPathPages);
    if (scaled) g_yolo_paths.add(kPathScaled);
  }
  return err;
}
