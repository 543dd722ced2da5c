// The streamed kernel's geometry (conv_stream.cu): its tile shapes by
// mode, the refusals, the persistent schedule, which pixel each M row of a
// tile is, where a TMA im2col load of a slab starts, and which source rows
// the producer warps stage for a tile. Plain C++ that the kernel's
// launcher and its device code share, and that g++ builds alone for the
// CPU tests (tests/test_torch_yolov2.py).

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define PLAN_FN __host__ __device__ __forceinline__
#else
#define PLAN_FN inline
#endif

namespace stream_plan {

enum Mode { kPlain = 0, kPool2 = 1, kPool1 = 2, kLinear = 3 };

constexpr int kSliceK = 128;  // K bytes of a slice: one tap, 128 channels
constexpr int kSlab = 64;     // M rows of one consumer warpgroup (a wgmma's rows)
constexpr int kPackN = 256;   // pack_stream pads oc to a multiple of this

// Consumer warpgroups of a tile: two of 64 x 256 (m64n256k32); two of 64 x
// 128 on the linear layer (yolov2-tiny-voc's oc of 125 in one tile); three
// of 64 x 128 for the 2x2/1 pool, whose tile holds one whole image.
PLAN_FN constexpr int consumers(int mode) { return mode == kPool1 ? 3 : 2; }
PLAN_FN constexpr int tile_m(int mode) { return kSlab * consumers(mode); }
PLAN_FN constexpr int tile_n(int mode) { return mode == kPool1 || mode == kLinear ? 128 : 256; }
// The pixels (of 128 channels) the producer warps can stage for a tile.
PLAN_FN constexpr int staging_pixels(int mode) { return mode == kPool1 ? 256 : 264; }

struct Geometry {
  int batch, ic, oc, height, width, k, mode;
  int pad, taps, chunks, slices;  // k / 2, k * k, ic / 128, taps * chunks
  int tile_m, tile_n, n_tiles, np;  // np: the rows of a packed slice
  int rows_per_image;               // M rows of one image
  long long m_rows, m_tiles, units;
  int staging_rows;  // the most source rows a tile stages (0: A by TMA)
  int tma;           // A by TMA im2col (a channels-last map, no 2x2/2 pool)
  // A layer graph's additions (make_geometry_ex); a chain's layers keep
  // make_geometry's values: stride 1, the pitches their channels, no
  // residual, no upsample.
  int stride;                          // 1, or 2: a 3x3 conv read by TMA im2col every 2 pixels
  int out_h, out_w;                    // the conv's output map (before an upsample)
  int in_pitch, out_pitch, res_pitch;  // bytes from one pixel to the next of x, out, the residual
  int upsample;                        // each output pixel stored to its 2x2 block
};

// The most source rows (b * H + y) a tile of `g` reads, halo included.
PLAN_FN int max_source_rows(const Geometry& g) {
  const int W = g.width;
  if (g.mode == kPool1) return g.height + 2 * g.pad;
  if (g.mode == kPool2) return 2 * ((g.tile_m / 4 - 1) / (W / 2) + 2) + 2 * g.pad;
  return (g.tile_m - 1) / W + 2 + 2 * g.pad;
}

// Fills `g` for one layer; returns 0, or 1 for a geometry the kernel does
// not take.
PLAN_FN int make_geometry(int batch, int ic, int oc, int height, int width, int k, int pool,
                          int linear, int nhwc, Geometry* g) {
  if (batch < 0 || ic < kSliceK || ic % kSliceK != 0 || oc < 1 || height < 1 || width < 1 ||
      (k != 1 && k != 3) || pool < 0 || pool > 2 || (linear && pool != 0) ||
      (!linear && oc % 2 != 0)) {
    return 1;
  }
  const int mode = linear ? kLinear : pool == 2 ? kPool2 : pool == 1 ? kPool1 : kPlain;
  if (mode == kPool2 && (height % 2 != 0 || width % 2 != 0)) return 1;
  if (mode == kPool1 && height * width > tile_m(kPool1)) return 1;
  if (static_cast<long long>(height) * width > (1LL << 30)) return 1;
  g->batch = batch;
  g->ic = ic;
  g->oc = oc;
  g->height = height;
  g->width = width;
  g->k = k;
  g->mode = mode;
  g->pad = k / 2;
  g->taps = k * k;
  g->chunks = ic / kSliceK;
  g->slices = g->taps * g->chunks;
  g->tile_m = tile_m(mode);
  g->tile_n = tile_n(mode);
  g->n_tiles = (oc + g->tile_n - 1) / g->tile_n;
  g->np = (oc + kPackN - 1) / kPackN * kPackN;
  g->rows_per_image = mode == kPool1 ? g->tile_m : height * width;
  g->m_rows = static_cast<long long>(batch) * g->rows_per_image;
  g->m_tiles = (g->m_rows + g->tile_m - 1) / g->tile_m;
  g->units = g->m_tiles * g->n_tiles;
  g->tma = nhwc && mode != kPool2;
  g->staging_rows = g->tma ? 0 : max_source_rows(*g);
  if (!g->tma && g->staging_rows * width > staging_pixels(mode)) return 1;
  g->stride = 1;
  g->out_h = mode == kPool2 ? height / 2 : height;
  g->out_w = mode == kPool2 ? width / 2 : width;
  g->in_pitch = ic;
  g->out_pitch = oc;
  g->res_pitch = 0;
  g->upsample = 0;
  return 0;
}

// make_geometry for a layer of a layer graph: `stride` 2 (a 3x3 conv,
// darknet's out(y, x) = sum in(2 y - 1 + dy, 2 x - 1 + dx), on an even
// map), x's pixels `in_pitch` bytes apart (a map inside a wider
// concatenated one; A by TMA), the output's `out_pitch` apart, a residual
// map (res_pitch > 0: u8 = min(u8 + residual, 255) after the clip) and
// `upsample` (each output pixel stored to its 2x2 block of a map of twice
// the side). Every addition but the pitch of x is the unpooled mode's.
PLAN_FN int make_geometry_ex(int batch, int ic, int oc, int height, int width, int k, int pool,
                             int linear, int nhwc, int stride, int in_pitch, int out_pitch,
                             int res_pitch, int upsample, Geometry* g) {
  if (make_geometry(batch, ic, oc, height, width, k, pool, linear, nhwc, g) != 0) return 1;
  const bool plain = g->mode == kPlain;
  if ((stride != 1 && stride != 2) || (upsample != 0 && upsample != 1) || in_pitch < ic ||
      out_pitch < oc || res_pitch < 0) {
    return 1;
  }
  if (stride == 2 && (!plain || !g->tma || k != 3 || height % 2 != 0 || width % 2 != 0 ||
                      upsample)) {
    return 1;
  }
  if (in_pitch != ic && (!g->tma || in_pitch % 16 != 0)) return 1;
  if ((out_pitch != oc || res_pitch != 0 || upsample) && (!plain || out_pitch % 2 != 0)) return 1;
  if (res_pitch != 0 && (res_pitch < oc || res_pitch % 2 != 0 || upsample)) return 1;
  g->stride = stride;
  if (stride == 2) {
    g->out_h = height / 2;
    g->out_w = width / 2;
  }
  g->in_pitch = in_pitch;
  g->out_pitch = out_pitch;
  g->res_pitch = res_pitch;
  g->upsample = upsample;
  if (stride == 2) {  // M rows: the output's pixels
    g->rows_per_image = g->out_h * g->out_w;
    g->m_rows = static_cast<long long>(batch) * g->rows_per_image;
    g->m_tiles = (g->m_rows + g->tile_m - 1) / g->tile_m;
    g->units = g->m_tiles * g->n_tiles;
  }
  return 0;
}

// The tile of work unit `u` of the persistent grid, N fastest: the CTAs
// working at once share M tiles, so an M tile's A is read from L2 by all
// of its N tiles at about the same time.
PLAN_FN void unit_tile(const Geometry& g, long long u, long long& mt, int& nt) {
  nt = static_cast<int>(u % g.n_tiles);
  mt = u / g.n_tiles;
}

// The image, row and column of M row `r` of tile `mt` (b = -1 for a row
// past the batch or, with the 2x2/1 pool, past its image). Without a pool
// and on the linear layer the rows are the batch's pixels in order; with
// the 2x2/2 pool four rows in a row are one pooling window; with the 2x2/1
// pool a tile is one image.
PLAN_FN void row_pixel(const Geometry& g, long long mt, int r, int& b, int& y, int& x) {
  b = y = x = -1;
  const int W = g.width;
  if (g.mode == kPool1) {
    if (mt >= g.batch || r >= g.height * W) return;
    b = static_cast<int>(mt);
    y = r / W;
    x = r % W;
    return;
  }
  const long long row = mt * g.tile_m + r;
  if (row >= g.m_rows) return;
  if (g.mode == kPool2) {
    const long long q = row >> 2;  // the pooling window over the batch
    const int sub = static_cast<int>(row & 3);
    const int ow = W / 2, per = (g.height / 2) * ow;
    b = static_cast<int>(q / per);
    const int p = static_cast<int>(q - static_cast<long long>(b) * per);
    y = 2 * (p / ow) + (sub >> 1);
    x = 2 * (p % ow) + (sub & 1);
  } else {
    const int hw = g.height * W;
    b = static_cast<int>(row / hw);
    const int p = static_cast<int>(row - static_cast<long long>(b) * hw);
    y = p / W;
    x = p % W;
  }
}

// The pixel where the TMA im2col load of slab `j` (rows 64 j ..) of tile
// `mt` starts; the load walks on through the map's pixels in order, across
// rows and images (b may pass the batch: the copy fills zeros there). With
// the 2x2/1 pool a tile is image `mt`, and its rows past the image's
// pixels read the next image's (the epilogue drops them).
PLAN_FN void slab_start(const Geometry& g, long long mt, int j, int& b, int& y, int& x) {
  const int hw = g.height * g.width;
  const long long q = (g.mode == kPool1 ? mt * hw : mt * g.tile_m) + static_cast<long long>(kSlab) * j;
  b = static_cast<int>(q / hw);
  const int p = static_cast<int>(q - static_cast<long long>(b) * hw);
  y = p / g.width;
  x = p % g.width;
}

// slab_start on the output map (out_h x out_w) of a strided layer: the
// output pixel where slab `j` of tile `mt` starts; its taps read from
// (stride y - pad, stride x - pad) on.
PLAN_FN void slab_start_out(const Geometry& g, long long mt, int j, int& b, int& y, int& x) {
  const int hw = g.out_h * g.out_w;
  const long long q = mt * g.tile_m + static_cast<long long>(kSlab) * j;
  b = static_cast<int>(q / hw);
  const int p = static_cast<int>(q - static_cast<long long>(b) * hw);
  y = p / g.out_w;
  x = p % g.out_w;
}

// The source rows (b * H + y over the batch) that tile `mt` reads, halo
// included, clipped to the batch: [lo, hi], empty (lo > hi) for a tile
// past the batch.
PLAN_FN void tile_source_rows(const Geometry& g, long long mt, int& lo, int& hi) {
  long long first, last;
  if (g.mode == kPool1) {
    first = mt * g.height;
    last = first + g.height - 1;
  } else {
    const long long r0 = mt * g.tile_m;
    const long long r1 = (r0 + g.tile_m < g.m_rows ? r0 + g.tile_m : g.m_rows) - 1;
    if (g.mode == kPool2) {
      const int ow = g.width / 2;
      first = 2 * ((r0 >> 2) / ow);
      last = 2 * ((r1 >> 2) / ow) + 1;
    } else {
      first = r0 / g.width;
      last = r1 / g.width;
    }
  }
  const long long total = static_cast<long long>(g.batch) * g.height;
  if (first >= total || last < first) {
    lo = 1;
    hi = 0;
    return;
  }
  first -= g.pad;
  last += g.pad;
  lo = static_cast<int>(first < 0 ? 0 : first);
  hi = static_cast<int>(last >= total ? total - 1 : last);
}

// A's im2col tensor map over a channels-last (B, H, W, ic) u8 map,
// innermost first: dims (ic, W, H, B), byte strides of W, H and B (a
// pixel `in_pitch` bytes on), and the bounding box's corners for a SAME k
// x k conv (the offsets of a tap run 0 .. k - 1 from the corner); the
// load walks the box every `stride` pixels (its traversal stride).
PLAN_FN void im2col_box(const Geometry& g, unsigned long long dims[4],
                        unsigned long long strides[3], int lower[2], int upper[2]) {
  dims[0] = static_cast<unsigned long long>(g.ic);
  dims[1] = static_cast<unsigned long long>(g.width);
  dims[2] = static_cast<unsigned long long>(g.height);
  dims[3] = static_cast<unsigned long long>(g.batch);
  strides[0] = static_cast<unsigned long long>(g.in_pitch);
  strides[1] = strides[0] * dims[1];
  strides[2] = strides[1] * dims[2];
  lower[0] = lower[1] = -g.pad;
  upper[0] = upper[1] = g.pad - (g.k - 1);
}

}  // namespace stream_plan
