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
// innermost first: dims (ic, W, H, B), byte strides of W, H and B, and the
// bounding box's corners for a SAME k x k conv (the offsets of a tap run
// 0 .. k - 1 from the corner).
PLAN_FN void im2col_box(const Geometry& g, unsigned long long dims[4],
                        unsigned long long strides[3], int lower[2], int upper[2]) {
  dims[0] = static_cast<unsigned long long>(g.ic);
  dims[1] = static_cast<unsigned long long>(g.width);
  dims[2] = static_cast<unsigned long long>(g.height);
  dims[3] = static_cast<unsigned long long>(g.batch);
  strides[0] = dims[0];
  strides[1] = strides[0] * dims[1];
  strides[2] = strides[1] * dims[2];
  lower[0] = lower[1] = -g.pad;
  upper[0] = upper[1] = g.pad - (g.k - 1);
}

}  // namespace stream_plan
