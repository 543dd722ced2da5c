// The region route's layer kernel's geometry (region_layer.cu): which
// paths a layer takes, the shared-memory plan, the persistent schedule of
// work items, which pixel each M row of a tile is and which source pixel
// each staged pixel holds. Plain C++ that the kernel's launcher and its
// device code share, and that g++ builds alone for the CPU tests
// (tests/test_torch_region_layer.py).
//
// A work item is one band of `band` pooled rows of one image, over one
// segment of `seg_w` pre-pool columns (one segment, the whole width, where
// shared memory holds it). Its staging holds the band's 2 band + 2 source
// rows (the halo rows above and below included, zeros outside the image)
// over `lead` columns left of the segment, the segment and one column right
// of it; its pooled output (bulk_out) is gathered in shared memory and
// leaves by bulk copy, its rows in one where the segment is the whole
// width. A tile is 64 M rows: 32 positions q of the item's (pooled row,
// pre-pool column) space, 8 a warp; M row g of a warp (g < 8) is the upper
// pixel (row 2 pr) of position q0 + g, row g + 8 the lower one (row 2 pr +
// 1), so a 2x2 window is a lane's rows g and g + 8 and lane ^ 4's.

#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define RPLAN_FN __host__ __device__ __forceinline__
#else
#define RPLAN_FN inline
#endif

namespace region_plan {

enum Mode { kRecast = 0, kTaps = 1 };  // how A is built (region_layer.cu's note)
enum Load { kLoadPlanes = 0, kLoadNhwc16 = 1, kLoadBytes = 2 };  // how the staging is filled

constexpr int kMaxIc = 127;       // ic of 128 or more streams (ops/conv_stream.py)
constexpr int kMaxOc = 128;       // the widest wgmma N this kernel issues
constexpr int kTileQ = 32;        // positions q of a tile: 64 M rows
constexpr int kMaxQ = 2048;       // positions of an item: 64 tiles
constexpr int kSmemMax = 232448;  // a block's shared memory on sm_90
constexpr int kSmemSm = 233472;   // an SM's, each CTA's 1 KB reserve included
constexpr int kAlign = 128;

// wgmma's N for `oc` output channels (oc padded with zero weights).
RPLAN_FN int wgmma_n(int oc) { return oc <= 16 ? 16 : oc <= 32 ? 32 : oc <= 64 ? 64 : 128; }

// Staged bytes of a pixel in the taps mode: ic padded to 16, 32, 64 or 128.
RPLAN_FN int taps_cp(int ic) {
  int p = 16;
  while (p < ic) p <<= 1;
  return p;
}

// K steps of 32 bytes: one for a recast pixel (9 ic <= 27 bytes); nine taps
// of cp bytes in the taps mode (16 channels: taps in pairs, the tenth tap
// zero).
RPLAN_FN constexpr int k_steps(int mode, int cp) {
  return mode == kRecast ? 1 : cp == 16 ? 5 : 9 * cp / 32;
}

// K steps whose A fragments are loaded before their MMAs are issued (a
// divisor of the layer's steps).
RPLAN_FN constexpr int k_group(int mode, int cp) {
  return mode == kRecast ? 1 : cp == 16 ? 5 : cp == 32 ? 9 : 6;
}

// Warpgroups of a CTA: four for N 128 (one CTA an SM: its weights), else two.
RPLAN_FN constexpr int warpgroups(int n) { return n == 128 ? 4 : 2; }

// CTAs an SM holds (the kernel's register cap, and the plan's share of
// shared memory): the narrower N, the less work a tile has to hide its
// latencies behind, so the more warpgroups an SM runs at once.
RPLAN_FN constexpr int ctas_an_sm(int n) { return n <= 32 ? 3 : n == 64 ? 2 : 1; }

RPLAN_FN int align_up(int v, int a) { return (v + a - 1) / a * a; }

// Whether an item's pooled output is gathered in shared memory and leaves
// by bulk copy: N 16 and 32 (a pooled pixel's 16 or 32 bytes, so a warp's
// four pixels' stores fall in distinct banks) of 16-channel multiples.
// Wider N store 16 bytes a lane from registers.
RPLAN_FN constexpr bool bulk_out(int n, int oc) { return n <= 32 && oc % 16 == 0; }

struct Geometry {
  int batch, ic, oc, height, width;
  int mode, load, n, cp, steps;
  int oh, ow;               // the pooled map
  int seg_w, segs;          // pre-pool columns of a segment, segments a band
  int band, bands;          // pooled rows of an item, items down an image
  int lead;                 // staged columns left of a segment's first
  int cols, rows;           // staged pixels of a row, staged rows
  int stage_bytes;          // one staging buffer
  int raw_bytes;            // one raw buffer of the planes (kLoadPlanes)
  int w_bytes;              // the packed weights
  int out_bytes;            // an item's pooled output, stored by bulk copy (bulk_out)
  int off_bias, off_raw, off_stage, off_out;  // byte offsets in shared memory (weights at 0)
  int stages;               // staging buffers: 2, or 1 behind raw planes
  int smem;                 // dynamic shared memory
  long long units;          // work items
  // A layer graph's output modes (make_geometry_ex; a chain's pooled
  // layers take kOutPool): the 2x2/2 pool; the unpooled map (an item's
  // `band` row pairs, M rows g and g + 8 a pair's two pixels); or the
  // stride-2 conv (darknet's out(y, x) = sum in(2 y - 1 + dy, 2 x - 1 +
  // dx)), its `band` output rows over the same staged source rows, M rows
  // g and g + 8 two output rows of one column.
  int out_mode;
};

enum OutMode { kOutPool = 0, kOutPlain = 1, kOutStride2 = 2 };

// Shared memory of a plan of `band` pooled rows over `seg_w` columns.
RPLAN_FN void fill_plan(Geometry* g, int band, int seg_w) {
  g->band = band;
  g->seg_w = seg_w;
  g->segs = (g->width + seg_w - 1) / seg_w;
  g->bands = (g->oh + band - 1) / band;
  g->rows = 2 * band + 2;
  const int cols = g->lead + seg_w + 1;
  // recast: staged rows 16 words apart mod 32, so that the taps a warp's
  // lanes read at once fall in distinct banks
  g->cols = g->mode != kRecast ? cols : cols <= 16 ? 16 : align_up(cols - 16, 32) + 16;
  const int pix = g->mode == kRecast ? 4 : g->cp;
  g->stage_bytes = align_up(g->rows * g->cols * pix, kAlign);
  g->raw_bytes = g->load == kLoadPlanes ? align_up(3 * g->rows * g->width, kAlign) : 0;
  g->stages = g->load == kLoadPlanes ? 1 : 2;
  g->off_bias = align_up(g->w_bytes, kAlign);
  g->off_raw = g->off_bias + align_up(4 * g->n, kAlign);
  g->off_stage = g->off_raw + 2 * g->raw_bytes;
  g->out_bytes = g->out_mode == kOutPool && bulk_out(g->n, g->oc)
                     ? align_up(band * (seg_w / 2) * g->oc, kAlign) : 0;
  g->off_out = g->off_stage + g->stages * g->stage_bytes;
  g->smem = g->off_out + g->out_bytes;
  g->units = static_cast<long long>(g->batch) * g->bands * g->segs;
}

// Fills `g` for one pooled 3x3 layer of (batch, ic, H, W) u8 -> (batch,
// oc, H / 2, W / 2) u8; `layout` 0 for a contiguous NCHW input, 1 for a
// contiguous channels-last one, 2 for other strides; `aligned` when its
// pointer is 16-byte aligned. Returns 0, or 1 for a geometry the kernel
// does not take.
RPLAN_FN int make_geometry_ex(int batch, int ic, int oc, int height, int width, int layout,
                              int aligned, int out_mode, Geometry* g) {
  if (batch < 0 || ic < 1 || ic > kMaxIc || oc < 1 || oc > kMaxOc || height < 2 ||
      width < 2 || height % 2 != 0 || width % 2 != 0 || height > 32768 || width > 32768 ||
      static_cast<long long>(height) * width > (1LL << 28) || out_mode < kOutPool ||
      out_mode > kOutStride2 || (out_mode != kOutPool && (oc <= 16 || oc % 2 != 0)) ||
      (out_mode == kOutStride2 && ic <= 3)) {
    return 1;
  }
  g->out_mode = out_mode;
  g->batch = batch;
  g->ic = ic;
  g->oc = oc;
  g->height = height;
  g->width = width;
  g->oh = height / 2;
  g->ow = width / 2;
  g->mode = ic <= 3 ? kRecast : kTaps;
  g->n = wgmma_n(oc);
  g->cp = g->mode == kRecast ? 4 : taps_cp(ic);
  g->steps = k_steps(g->mode, g->cp);
  g->lead = g->mode == kRecast ? 4 : 1;
  g->w_bytes = g->steps * 32 * g->n;
  const int planes = g->mode == kRecast && ic == 3 && layout == 0 && aligned && width % 16 == 0;
  g->load = planes ? kLoadPlanes
          : g->mode == kTaps && layout == 1 && aligned && ic % 16 == 0 ? kLoadNhwc16 : kLoadBytes;
  // A CTA's share of the SM (ctas_an_sm); the tallest band (at most kMaxQ
  // positions) over the whole width, else over the widest segment whose
  // band of one pooled row fits.
  const int ctas = ctas_an_sm(g->n);
  const int budget = ctas == 1 ? kSmemMax : kSmemSm / ctas - 1024;
  int seg_w = width;
  for (;;) {
    if (g->load == kLoadPlanes && seg_w != width) g->load = kLoadBytes;  // planes: whole rows
    int best = 0;
    const int cap = seg_w >= kMaxQ ? 1 : kMaxQ / seg_w;
    for (int band = 1; band <= g->oh && band <= cap; ++band) {
      fill_plan(g, band, seg_w);
      if (g->smem > budget) break;
      best = band;
    }
    if (best > 0) {
      // the same count of bands, as even as they go
      const int bands = (g->oh + best - 1) / best;
      fill_plan(g, (g->oh + bands - 1) / bands, seg_w);
      return 0;
    }
    if (seg_w <= 2) return 1;
    seg_w = (seg_w / 2 + 1) & ~1;  // halve, kept even
  }
}

// Fills `g` for one pooled 3x3 layer (make_geometry_ex's pool mode).
RPLAN_FN int make_geometry(int batch, int ic, int oc, int height, int width, int layout,
                           int aligned, Geometry* g) {
  return make_geometry_ex(batch, ic, oc, height, width, layout, aligned, kOutPool, g);
}

// The output map of `g`: (H / 2, W / 2) pooled or stride 2, else (H, W).
RPLAN_FN void out_map(const Geometry& g, int& oh, int& ow) {
  oh = g.out_mode == kOutPlain ? g.height : g.oh;
  ow = g.out_mode == kOutPlain ? g.width : g.ow;
}

// An item's positions: per row (the stride-2 mode's output columns, else
// the segment's columns) and in all (its row pairs x per_row).
RPLAN_FN void item_positions(const Geometry& g, int prows, int sw, int& per_row, int& q) {
  per_row = g.out_mode == kOutStride2 ? sw / 2 : sw;
  q = (g.out_mode == kOutStride2 ? (prows + 1) / 2 : prows) * per_row;
}

// The image, band and segment of work item `u` (items of one image
// consecutive, so that CTAs working at once share the halo rows in L2).
RPLAN_FN void unit_item(const Geometry& g, long long u, int& b, int& band, int& seg) {
  const long long per = static_cast<long long>(g.bands) * g.segs;
  b = static_cast<int>(u / per);
  const int r = static_cast<int>(u - static_cast<long long>(b) * per);
  band = r / g.segs;
  seg = r - band * g.segs;
}

// An item's pooled rows, pre-pool columns, first pre-pool column and
// positions q (pooled rows x columns).
RPLAN_FN void item_shape(const Geometry& g, int band, int seg, int& prows, int& sw, int& x0,
                         int& q) {
  prows = g.oh - band * g.band < g.band ? g.oh - band * g.band : g.band;
  x0 = seg * g.seg_w;
  sw = g.width - x0 < g.seg_w ? g.width - x0 : g.seg_w;
  q = prows * sw;
}

// The pre-pool pixel (y, x) of M row `r` (0..63) of tile `tile` of an item
// (y = x = -1 past the item's positions), and where that row's tap (dy, dx)
// (0..2 each) reads the staging: staged row, staged column.
RPLAN_FN void tile_row(const Geometry& g, int band, int seg, int tile, int r, int& y, int& x) {
  int prows, sw, x0, q;
  item_shape(g, band, seg, prows, sw, x0, q);
  const int p = tile * kTileQ + 8 * (r / 16) + (r % 8);
  if (p >= q) {
    y = x = -1;
    return;
  }
  const int pr = p / sw;
  y = 2 * (band * g.band + pr) + (r % 16) / 8;
  x = x0 + (p - pr * sw);
}

RPLAN_FN void staged_at(const Geometry& g, int band, int seg, int y, int x, int dy, int dx,
                        int& srow, int& scol) {
  srow = y - (2 * band * g.band - 1) + dy - 1;
  scol = x - seg * g.seg_w + g.lead + dx - 1;
}

// The source pixel of staged pixel (srow, scol) of an item: (y, x) in the
// image, or y = x = -1 where the staging holds zeros (outside the image).
RPLAN_FN void staged_source(const Geometry& g, int band, int seg, int srow, int scol, int& y,
                            int& x) {
  y = 2 * band * g.band - 1 + srow;
  x = seg * g.seg_w - g.lead + scol;
  if (y < 0 || y >= g.height || x < 0 || x >= g.width) y = x = -1;
}

// Tiles of an item.
RPLAN_FN int item_tiles(const Geometry& g, int band, int seg) {
  int prows, sw, x0, q, per_row;
  item_shape(g, band, seg, prows, sw, x0, q);
  item_positions(g, prows, sw, per_row, q);
  return (q + kTileQ - 1) / kTileQ;
}

// The output pixel (y, x) of M row `r` (0..63) of tile `tile` of an item
// in the unpooled and stride-2 modes (y = x = -1 past the item's pixels).
RPLAN_FN void tile_out_pixel(const Geometry& g, int band, int seg, int tile, int r, int& y,
                             int& x) {
  int prows, sw, x0, q, per_row;
  item_shape(g, band, seg, prows, sw, x0, q);
  item_positions(g, prows, sw, per_row, q);
  const int p = tile * kTileQ + 8 * (r / 16) + (r % 8), lower = (r % 16) / 8;
  y = x = -1;
  if (p >= q) return;
  const int pr = p / per_row, pc = p - pr * per_row;
  if (g.out_mode == kOutStride2) {
    if (2 * pr + lower >= prows) return;
    y = band * g.band + 2 * pr + lower;
    x = x0 / 2 + pc;
  } else {
    y = 2 * (band * g.band + pr) + lower;
    x = x0 + pc;
  }
}

}  // namespace region_plan
