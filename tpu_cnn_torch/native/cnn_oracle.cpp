// cnn_oracle.cpp — native independent oracle for the fixed-point CNN contract
// (the port's copy of tpu_cnn/native/cnn_oracle.cpp's forward pass).
//
// Role: an independent compiled implementation of the contract (uint8 act x
// int8 weight -> int32 accumulate -> arithmetic right shift -> clamp [0,255]
// -> 2x2 maxpool), structurally different from the numpy oracle, the plain
// torch contract and the CUDA kernels, used by the parity checks.
//
// Deliberately different construction from both the JAX paths and the numpy
// oracle: direct convolution with clamped window bounds (no padded copy),
// generic layer count/geometry, batch API, OpenMP parallel over images.
//
// Build: g++ -O3 -march=native -fopenmp -shared -fPIC (ops/_build.py).

#include <cstdint>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Accumulate one input channel's 3x3 contribution into acc (H x W, int32).
// Window bounds are clamped instead of padding the input: tap (dy, dx) with
// offsets in {-1, 0, 1} contributes in[y+dy][x+dx] wherever that is in range,
// which is exactly SAME zero-padding semantics.
void conv3x3_accumulate(const uint8_t* in, int H, int W, const int8_t* k9,
                        int32_t* acc) {
  for (int dy = -1; dy <= 1; ++dy) {
    for (int dx = -1; dx <= 1; ++dx) {
      const int32_t kv = k9[(dy + 1) * 3 + (dx + 1)];
      if (kv == 0) continue;
      const int y0 = dy < 0 ? 1 : 0, y1 = dy > 0 ? H - 1 : H;
      const int x0 = dx < 0 ? 1 : 0, x1 = dx > 0 ? W - 1 : W;
      for (int y = y0; y < y1; ++y) {
        const uint8_t* src = in + (y + dy) * W + dx;
        int32_t* dst = acc + y * W;
        for (int x = x0; x < x1; ++x) dst[x] += kv * (int32_t)src[x];
      }
    }
  }
}

// shift -> clamp -> 2x2 maxpool, int32 (H x W) -> uint8 (H/2 x W/2).
void shift_clamp_pool(const int32_t* acc, int H, int W, int shift,
                      uint8_t* out) {
  const int oh = H / 2, ow = W / 2;
  for (int py = 0; py < oh; ++py) {
    const int32_t* r0 = acc + (2 * py) * W;
    const int32_t* r1 = r0 + W;
    for (int px = 0; px < ow; ++px) {
      int32_t m = INT32_MIN;
      const int32_t quad[4] = {r0[2 * px], r0[2 * px + 1], r1[2 * px],
                               r1[2 * px + 1]};
      for (int32_t v : quad) {
        int32_t s = v >> shift;  // arithmetic shift (floor), then clamp
        if (s < 0) s = 0;
        if (s > 255) s = 255;
        if (s > m) m = s;
      }
      out[py * ow + px] = (uint8_t)m;
    }
  }
}

struct Scratch {
  std::vector<int32_t> acc;
  std::vector<uint8_t> ping, pong;
};

// One image through all layers. cfg is (ic, oc, size) per layer; kernels is
// the concatenation of (oc, ic, 3, 3) int8 blocks.
void forward_one(const uint8_t* image, const int8_t* kernels, const int* cfg,
                 int n_layers, const int* shifts, uint8_t* features_out,
                 Scratch& s) {
  const uint8_t* cur = image;
  const int8_t* kbase = kernels;
  for (int L = 0; L < n_layers; ++L) {
    const int ic = cfg[3 * L + 0], oc = cfg[3 * L + 1], size = cfg[3 * L + 2];
    const int in_hw = size * size, out_hw = (size / 2) * (size / 2);
    uint8_t* out =
        (L == n_layers - 1) ? features_out : (L % 2 == 0 ? s.ping.data() : s.pong.data());
    if ((int)s.acc.size() < in_hw) s.acc.resize(in_hw);
    for (int o = 0; o < oc; ++o) {
      std::memset(s.acc.data(), 0, sizeof(int32_t) * in_hw);
      for (int i = 0; i < ic; ++i) {
        conv3x3_accumulate(cur + i * in_hw, size, size,
                           kbase + ((size_t)o * ic + i) * 9, s.acc.data());
      }
      shift_clamp_pool(s.acc.data(), size, size, shifts[L], out + (size_t)o * out_hw);
    }
    kbase += (size_t)oc * ic * 9;
    cur = out;
  }
}

}  // namespace

extern "C" {

// Batched forward. images: batch x (size0^2) uint8; features_out:
// batch x (oc_last * (size_last/2)^2) uint8. Returns 0 on success.
int tcnn_forward(const uint8_t* images, int batch, const int8_t* kernels,
                 const int* layer_cfg, int n_layers, const int* shifts,
                 uint8_t* features_out) {
  if (batch <= 0 || n_layers <= 0) return -1;
  const int in_hw = layer_cfg[2] * layer_cfg[2];
  const int last_oc = layer_cfg[3 * (n_layers - 1) + 1];
  const int last_size = layer_cfg[3 * (n_layers - 1) + 2];
  const size_t out_per_img = (size_t)last_oc * (last_size / 2) * (last_size / 2);

  // Per-layer intermediate sizing: max over layers of oc * (size/2)^2.
  size_t inter = 0;
  for (int L = 0; L < n_layers; ++L) {
    const size_t n =
        (size_t)layer_cfg[3 * L + 1] * (layer_cfg[3 * L + 2] / 2) * (layer_cfg[3 * L + 2] / 2);
    if (n > inter) inter = n;
  }

#pragma omp parallel
  {
    Scratch s;
    s.ping.resize(inter);
    s.pong.resize(inter);
#pragma omp for schedule(dynamic)
    for (int b = 0; b < batch; ++b) {
      forward_one(images + (size_t)b * in_hw, kernels, layer_cfg, n_layers,
                  shifts, features_out + (size_t)b * out_per_img, s);
    }
  }
  return 0;
}

int tcnn_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Batched camera-frame preprocess (the port's copy of
// tpu_cnn/native/cnn_oracle.cpp's tcnn_preprocess) — the native host-side
// twin of the device path ops/preprocess.py (and of the reference's
// per-frame ARM preprocess, software/realtime_detect.py:584-591):
//   center-crop to square -> BT.601 fixed-point luma (cv2.COLOR_BGR2GRAY
//   exact: (4899 R + 9617 G + 1868 B + 8192) >> 14) -> area resize (exact
//   integer block mean when the crop divides out_size, nearest otherwise).
// frames: batch x H x W x channels uint8 (channels 1 or 3); bgr selects the
// channel order when channels == 3. out: batch x out_size x out_size uint8.
// Returns 0 on success.
int tcnn_preprocess(const uint8_t* frames, int batch, int H, int W,
                    int channels, int bgr, int out_size, uint8_t* out) {
  if (batch <= 0 || H <= 0 || W <= 0 || out_size <= 0) return -1;
  if (channels != 1 && channels != 3) return -2;
  // crops smaller than out_size upsample through the nearest-index path
  // below — same behaviour as the numpy twin (apps/realtime.preprocess)
  const int s = H < W ? H : W;
  const int y0 = (H - s) / 2, x0 = (W - s) / 2;
  const int f = s / out_size;
  const bool exact = (s % out_size) == 0;
  const size_t frame_sz = (size_t)H * W * channels;
  const size_t out_sz = (size_t)out_size * out_size;
  const int ri = channels == 3 ? (bgr ? 2 : 0) : 0;
  const int bi = channels == 3 ? (bgr ? 0 : 2) : 0;

  // nearest-sample index map (non-divisible geometries)
  std::vector<int> idx(out_size);
  for (int i = 0; i < out_size; ++i) {
    int v = (int)(((int64_t)i * s) / out_size);
    idx[i] = v < s - 1 ? v : s - 1;
  }

#pragma omp parallel for schedule(dynamic)
  for (int b = 0; b < batch; ++b) {
    const uint8_t* fr = frames + (size_t)b * frame_sz;
    uint8_t* dst = out + (size_t)b * out_sz;
    auto gray_at = [&](int y, int x) -> uint32_t {
      const uint8_t* p = fr + ((size_t)(y0 + y) * W + (x0 + x)) * channels;
      if (channels == 1) return p[0];
      return (4899u * p[ri] + 9617u * p[1] + 1868u * p[bi] + 8192u) >> 14;
    };
    if (exact) {
      const uint32_t denom = (uint32_t)f * f;
      for (int oy = 0; oy < out_size; ++oy) {
        for (int ox = 0; ox < out_size; ++ox) {
          uint32_t sum = 0;
          for (int dy = 0; dy < f; ++dy)
            for (int dx = 0; dx < f; ++dx)
              sum += gray_at(oy * f + dy, ox * f + dx);
          dst[(size_t)oy * out_size + ox] = (uint8_t)(sum / denom);
        }
      }
    } else {
      for (int oy = 0; oy < out_size; ++oy)
        for (int ox = 0; ox < out_size; ++ox)
          dst[(size_t)oy * out_size + ox] = (uint8_t)gray_at(idx[oy], idx[ox]);
    }
  }
  return 0;
}

}  // extern "C"
