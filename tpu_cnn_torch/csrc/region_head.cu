// The region head of a YOLOv2 detector (darknet's [region] layer with
// softmax, then do_nms_sort and the best max_det pairs), one CTA an image,
// for NVIDIA Hopper (sm_90a). It replaces no TPU kernel: the JAX package
// has no region-head detector.
//
//     t (B, g, g, A * (5 + C)) s32, channels-last: the last layer's sums
//     -> per box (anchor n, cell i, j; darknet index n g^2 + i g + j):
//        v = sum / 2^shift[layer]; x = (j + sigmoid(v_tx)) / g,
//        y = (i + sigmoid(v_ty)) / g, w = a_n^w exp(v_tw) / g,
//        h = a_n^h exp(v_th) / g; class k scores sigmoid(v_to) softmax(v_c)_k,
//        0 at or below thresh
//     -> per class, greedy NMS in order of score (ties: the lower index):
//        a kept box zeroes every later box whose IoU exceeds nms
//     -> dets (B, max_det, 6) f32 (x, y, w, h, score, class) in order of
//        score (ties: the lower index, then the lower class), zero past
//        count (B,) s32 = min(pairs left, max_det)
//
// Float32 throughout; the plain version is ops/region_head.py's.
//
// What bounds it: neither bytes (84 KB of sums an image) nor operations,
// but the serial steps of NMS. So every image's state (boxes, each class's
// scores and candidate lists) stays in shared memory, one warp takes each
// class (the candidates compacted by ballots, ordered by rank counting, NMS
// with the warp's lanes over the later boxes), and the cut to max_det is a
// rank count over the pairs left.

#include <cstdint>

#include <cuda_runtime.h>

#include "path_counts.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;

struct RegionArgs {
  const int32_t* t;
  const int32_t* shifts;  // read at `layer`
  const float* anchors;   // (A, 2)
  float* dets;
  int32_t* count;
  int layer, grid, anchors_n, classes;
  float thresh, nms;
  int max_det;
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

size_t region_smem(int n, int c) {
  return static_cast<size_t>(n) * (16 + 4 * c + 4 * c) + 8 * (c + 1);
}

__global__ void __launch_bounds__(kThreads, 1) region_head_kernel(RegionArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = a.grid, g2 = g * g, C = a.classes, E = 5 + C;
  const int N = a.anchors_n * g2, oc = a.anchors_n * E;
  float4* boxes = reinterpret_cast<float4*>(smem);
  float* scores = reinterpret_cast<float*>(boxes + N);                // (C, N)
  uint16_t* cand = reinterpret_cast<uint16_t*>(scores + C * N);       // (C, N)
  uint16_t* sorted = cand + C * N;                                     // (C, N)
  int* kept = reinterpret_cast<int*>(sorted + C * N);                  // (C,)
  int* offs = kept + C;                                                // (C + 1,)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float scale = scalbnf(1.0f, -min(max(a.shifts[a.layer], 0), 31));
  const int32_t* tb = a.t + static_cast<size_t>(b) * g2 * oc;

  // decode: one box a thread
  for (int id = tid; id < N; id += kThreads) {
    const int n = id / g2, p = id - n * g2;
    const int32_t* v = tb + static_cast<size_t>(p) * oc + n * E;
    const float i = static_cast<float>(p / g), j = static_cast<float>(p % g);
    float4 box;
    box.x = (j + sigmoid(__int2float_rn(v[0]) * scale)) / g;
    box.y = (i + sigmoid(__int2float_rn(v[1]) * scale)) / g;
    box.z = a.anchors[2 * n] * expf(__int2float_rn(v[2]) * scale) / g;
    box.w = a.anchors[2 * n + 1] * expf(__int2float_rn(v[3]) * scale) / g;
    boxes[id] = box;
    const float obj = sigmoid(__int2float_rn(v[4]) * scale);
    float m = -INFINITY;
    for (int k = 0; k < C; ++k) m = fmaxf(m, __int2float_rn(v[5 + k]) * scale);
    float sum = 0.0f;
    for (int k = 0; k < C; ++k) sum += expf(__int2float_rn(v[5 + k]) * scale - m);
    for (int k = 0; k < C; ++k) {
      const float s = obj * (expf(__int2float_rn(v[5 + k]) * scale - m) / sum);
      scores[k * N + id] = s > a.thresh ? s : 0.0f;
    }
  }
  __syncthreads();

  // per class, one warp: candidates in index order, ranked, NMS, the kept
  for (int k = warp; k < C; k += kWarps) {
    float* sc = scores + k * N;
    uint16_t* cd = cand + k * N;
    uint16_t* so = sorted + k * N;
    int cnt = 0;
    for (int base = 0; base < N; base += 32) {
      const int id = base + lane;
      const bool v = id < N && sc[id] > 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) cd[cnt + __popc(mask & ((1u << lane) - 1))] = static_cast<uint16_t>(id);
      cnt += __popc(mask);
    }
    __syncwarp();
    for (int i = lane; i < cnt; i += 32) {
      const int id = cd[i];
      const float s = sc[id];
      int r = 0;
      for (int q = 0; q < cnt; ++q) {
        const int o = cd[q];
        const float so_ = sc[o];
        r += (so_ > s) || (so_ == s && o < id);
      }
      so[r] = static_cast<uint16_t>(id);
    }
    __syncwarp();
    for (int i = 0; i < cnt; ++i) {
      const int id = so[i];
      if (sc[id] == 0.0f) continue;  // suppressed: the warp reads one value
      const float4 bi = boxes[id];
      for (int q = i + 1 + lane; q < cnt; q += 32) {
        const int o = so[q];
        if (box_iou(bi, boxes[o]) > a.nms) sc[o] = 0.0f;
      }
      __syncwarp();
    }
    int keep = 0;
    for (int base = 0; base < cnt; base += 32) {
      const int q = base + lane;
      const int id = q < cnt ? so[q] : 0;
      const bool v = q < cnt && sc[id] > 0.0f;
      const unsigned mask = __ballot_sync(0xffffffffu, v);
      if (v) so[keep + __popc(mask & ((1u << lane) - 1))] = static_cast<uint16_t>(id);
      keep += __popc(mask);
      __syncwarp();
    }
    if (lane == 0) kept[k] = keep;
  }
  __syncthreads();
  if (tid == 0) {
    offs[0] = 0;
    for (int k = 0; k < C; ++k) offs[k + 1] = offs[k] + kept[k];
  }
  __syncthreads();

  // the best max_det pairs by rank
  const int total = offs[C];
  const int n_out = min(total, a.max_det);
  float* db = a.dets + static_cast<size_t>(b) * a.max_det * 6;
  for (int u = tid; u < total; u += kThreads) {
    int k = 0;
    while (offs[k + 1] <= u) ++k;
    const int id = sorted[k * N + (u - offs[k])];
    const float s = scores[k * N + id];
    const long long key = static_cast<long long>(id) * C + k;
    int r = 0;
    for (int k2 = 0; k2 < C && r < a.max_det; ++k2) {
      const uint16_t* so = sorted + k2 * N;
      const float* sc = scores + k2 * N;
      for (int q = 0; q < kept[k2]; ++q) {
        const int o = so[q];
        const float s2 = sc[o];
        r += (s2 > s) || (s2 == s && static_cast<long long>(o) * C + k2 < key);
      }
    }
    if (r < a.max_det) {
      const float4 bx = boxes[id];
      float* d = db + r * 6;
      d[0] = bx.x;
      d[1] = bx.y;
      d[2] = bx.z;
      d[3] = bx.w;
      d[4] = s;
      d[5] = static_cast<float>(k);
    }
  }
  for (int i = n_out * 6 + tid; i < a.max_det * 6; i += kThreads) db[i] = 0.0f;
  if (tid == 0) a.count[b] = n_out;
}

enum RegionPath { kPathCut, kPathUnderCut, kPathManyClasses, kRegionPaths };
constexpr const char* kRegionPathNames[kRegionPaths] = {
    "launch at max_det below every box x class pair", "launch at max_det of every pair",
    "more classes than warps"};
PathCounts<kRegionPaths> g_region_paths(kRegionPathNames);

}  // namespace

extern "C" const char* region_head_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int region_head_paths(const char** names, unsigned long long* hits, int n) {
  return g_region_paths.read(names, hits, n);
}

// Shared memory one image takes at `grid`, `anchors_n` and `classes`, 0 if
// no block can hold it.
extern "C" long long region_head_smem_bytes(int grid, int anchors_n, int classes) {
  const long long n = 1LL * anchors_n * grid * grid;
  if (grid < 1 || anchors_n < 1 || classes < 1 || n > 65535) return 0;
  const size_t bytes = region_smem(static_cast<int>(n), classes);
  return bytes <= static_cast<size_t>(kMaxSmem) ? static_cast<long long>(bytes) : 0;
}

// Launches the head on `stream` of CUDA device `device`: t (B, grid, grid,
// anchors_n * (5 + classes)) s32, shifts a device s32 vector read at
// `layer`, anchors (anchors_n, 2) f32, dets (B, max_det, 6) f32, count (B,)
// s32, all device pointers. Returns a cudaError_t: cudaSuccess,
// cudaErrorInvalidValue for a geometry the kernel does not take, or the
// launch error. Neither synchronises nor allocates.
extern "C" int region_head_forward(const void* t, const void* shifts, int layer,
                                   const void* anchors, void* dets, void* count, int batch,
                                   int grid, int anchors_n, int classes, float thresh, float nms,
                                   int max_det, int device, void* stream) {
  const long long smem = region_head_smem_bytes(grid, anchors_n, classes);
  if (batch < 0 || layer < 0 || max_det < 1 || smem == 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  RegionArgs a;
  a.t = static_cast<const int32_t*>(t);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.anchors = static_cast<const float*>(anchors);
  a.dets = static_cast<float*>(dets);
  a.count = static_cast<int32_t*>(count);
  a.layer = layer;
  a.grid = grid;
  a.anchors_n = anchors_n;
  a.classes = classes;
  a.thresh = thresh;
  a.nms = nms;
  a.max_det = max_det;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(region_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  region_head_kernel<<<batch, kThreads, static_cast<int>(smem),
                       static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    const long long pairs = 1LL * anchors_n * grid * grid * classes;
    g_region_paths.add(max_det < pairs ? kPathCut : kPathUnderCut);
    if (classes > kWarps) g_region_paths.add(kPathManyClasses);
  }
  return err;
}
