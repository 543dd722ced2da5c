// One contract conv layer on Hopper's int8 tensor cores (sm_90a), with or
// without the 2x2 pool: the body of conv_act.cu (the `pallas`/`hybrid`
// per-layer kernel) and conv_pool_layer.cu (the chained plan's head layer).
// For uint8 activations and int8 weights:
//
//     (B, ic, H, W) u8 -> SAME conv3x3 (zero halo), exact s32 sums
//     -> >> shift[layer] (arithmetic) -> clip 0..255
//     -> (B, oc, H, W) u8, or with POOL the 2x2 stride-2 max
//     -> (B, oc, H/2, W/2) u8 (H, W even)
//
// A persistent grid of 256-thread CTAs loops over work items (one output
// tile of one image; a 1-D item index, so any batch). Each item's input
// tile with its 1-pixel halo is copied raw (NCHW rows) into shared memory by
// cp.async while the CTA computes the previous item: two raw buffers. The
// output tile is shifted, clipped and pooled in registers, gathered in
// shared memory, and leaves as 16-byte stores along NCHW rows.
//
// Multi-channel layers (ic >= 2): an implicit GEMM on mma.sync.m16n8k32 as
// in mega_cnn.cu. The raw tile is transposed (4 channels x 4 pixels per
// thread, __byte_perm) into channels-last with channels padded to cpad(ic)
// and the XOR chunk swizzle, so ldmatrix.x4 is the im2col; M tiles are
// 2 rows x 8 columns, so a pooling window is one lane's C fragment plus
// lane ^ 4; N tiles of 8 output channels; K = 9 taps x cpad(ic), B packed
// by ops/mega.py's pack_fragments and copied once per CTA into shared memory.
// A tile is th x 32 pixels, th the tallest of 32, 16, 8, 4, 2 whose shared
// memory lets two CTAs share an SM, else the tallest that fits one.
//
// One-channel layers (ic = 1): every K byte is a real pixel. An M row is a
// 2x2 output quad; its K = the 4x4 input patch under it, 16 bytes, patch
// row r at K bytes 4r..4r+3, so one lane's A register is one patch row;
// N = 4 quad positions x 16 output channels, position-major (N tile
// 2p + h holds channels 8h..8h+7 at position p), the 3x3 kernel placed at
// each position's offset in a 16 x 64 weight matrix (ops/mega.py's
// pack_one_channel; zeros elsewhere). mma.sync.m16n8k16 then gives each
// lane the four positions of its channels in its own registers: the pool
// is a register max, and the unpooled variant stores all four. B is held
// in 8 registers per 16 output channels. A tile is 16 x 64 quads.
//
// What bounds it on an H100: HBM. lyr3-std's layers unpooled move 560 KB
// per image for 40 M MACs (0.263 ms of bytes against 0.062 ms of MACs per
// batch of 1536); lyr4-wide's L0 pooled moves 320 KB for 9.4 M. So the
// design keeps the tensor pipe well fed and spends its care on the bytes:
// each input byte is read once from HBM (tile halos come from L2), each
// output byte is written once with 16-byte stores, and the copies overlap
// the MMAs. Odd geometries (a width not a multiple of 16, a misaligned
// pointer) stage and store byte by byte instead.

#pragma once

#include <algorithm>
#include <climits>
#include <cstdint>
#include <initializer_list>

#include <cuda_runtime.h>

#include "int8_mma.cuh"
#include "path_counts.cuh"

namespace {

constexpr int kLayerThreads = 256;
constexpr int kLayerWarps = kLayerThreads / 32;
constexpr int kLayerMaxSmem = 232448;  // opt-in limit of one block on sm_90
constexpr int kLayerMaxSide = 32768;   // keeps y * W + x in int
// one-channel tiles: kQRows x kQCols quads = 32 x 128 pre-pool pixels
constexpr int kQRows = 16;
constexpr int kQCols = 64;
constexpr int kOnePitch = 160;         // raw bytes per row (40 words: rows 8 banks apart)
// multi-channel tiles: th x kTileW pre-pool pixels
constexpr int kTileW = 32;
constexpr int kMultiPitch = 64;        // raw bytes per channel row
constexpr int kActPitch = kTileW + 2;  // channels-last pixels per row
constexpr int kMTiles = kTileW / 8;    // M tiles per warp unit: one 2-row band
constexpr int kNT = 4;                 // N tiles of 8 per warp unit
// A raw row holds x = tx0 - 16 + c at byte c: the word left of the tile at
// c = 12..15, the tile's columns from c = 16 (16-byte aligned for
// cp.async), the word right of it after them.
constexpr int kRawLead = 16;

struct LayerArgs {
  const uint8_t* x;        // (B, ic, H, W)
  const void* w;           // packed weights
  const int32_t* shifts;   // read at `layer`
  uint8_t* out;            // (B, oc, OH, OW)
  int layer, ic, oc, height, width;
  int th;                  // pre-pool rows of a tile
  int tiles_x, tiles;      // tiles per row and per image
  int n_items;             // batch * tiles
  int raw_bytes;           // one raw buffer
  int act_bytes;           // the channels-last tile (multi-channel)
  int w_bytes;             // the packed weights in shared memory (multi-channel)
  int opitch;              // bytes per output channel plane of the tile
  int ogroups;             // one-channel: groups of 16 channels per pass
  bool vec_in, vec_out;    // 16-byte global loads / stores
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ int clip_shift(int v, int shift) {
  return min(max(v >> shift, 0), 255);  // >> on int is arithmetic (floor)
}

// The rows y = ty0 - 1 .. ty0 + ROWS - 2 of channels 0..nch-1, columns
// x = tx0 - 4 .. tx0 + TW + 3, into `raw` (channel c's row r at
// raw + c * CSTRIDE + r * PITCH, x at byte x - tx0 + kRawLead), zero outside
// the image. vec: W % 16 == 0 and the image 16-byte aligned, so every row
// and every 16-byte column chunk from tx0 is aligned and wholly in or out.
template <int ROWS, int TW, int PITCH, int CSTRIDE>
__device__ void stage_raw(const uint8_t* __restrict__ xb, int nch, int H, int W, int ty0,
                          int tx0, uint8_t* __restrict__ raw, bool vec) {
  const size_t plane = static_cast<size_t>(H) * W;
  if (vec) {
    constexpr int kChunks = TW / 16 + 2;  // left word, body chunks, right word
    const int total = nch * ROWS * kChunks;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int j = i % kChunks;
      const int cr = i / kChunks;
      const int c = cr / ROWS, r = cr - c * ROWS;
      const int y = ty0 - 1 + r;
      const bool yok = static_cast<unsigned>(y) < static_cast<unsigned>(H);
      const uint8_t* src = xb + c * plane + static_cast<size_t>(yok ? y : 0) * W;
      uint8_t* dst = raw + c * CSTRIDE + r * PITCH;
      if (j == 0) {
        const bool ok = yok && tx0 > 0;
        cp_async4(dst + kRawLead - 4, ok ? src + tx0 - 4 : xb, ok);
      } else if (j == kChunks - 1) {
        const bool ok = yok && tx0 + TW < W;
        cp_async4(dst + kRawLead + TW, ok ? src + tx0 + TW : xb, ok);
      } else {
        const int x = tx0 + 16 * (j - 1);
        const bool ok = yok && x < W;
        cp_async16(dst + kRawLead + 16 * (j - 1), ok ? src + x : xb, ok);
      }
    }
    return;
  }
  constexpr int kSpan = TW + 8;
  const int total = nch * ROWS * kSpan;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int k = i % kSpan;
    const int cr = i / kSpan;
    const int c = cr / ROWS, r = cr - c * ROWS;
    const int y = ty0 - 1 + r, x = tx0 - 4 + k;
    const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(H) &&
                    static_cast<unsigned>(x) < static_cast<unsigned>(W);
    raw[c * CSTRIDE + r * PITCH + kRawLead - 4 + k] =
        ok ? xb[c * plane + static_cast<size_t>(y) * W + x] : 0;
  }
}

// Raw NCHW rows -> the channels-last tile: pixel (r, col) of `act` (pitch
// kActPitch) holds x = tx0 - 1 + col, its cpad channels chunk-swizzled,
// zero past ic. A thread takes 4 channels x 4 pixels: four 4-byte row
// reads, a 4 x 4 byte transpose, four 4-byte stores.
template <int ROWS, int CSTRIDE>
__device__ void raw_to_act(const uint8_t* __restrict__ raw, int ic, int cp,
                           uint8_t* __restrict__ act) {
  constexpr int kWords = (kActPitch + 3) / 4;  // 4-pixel columns per row
  const int lg = __ffs(cp / 4) - 1;            // cp / 4 channel quads, a power of two
  const int cpc = cp / 16;
  const int total = (ROWS * kWords) << lg;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int cq = i & ((1 << lg) - 1);
    const int rj = i >> lg;
    const int r = rj / kWords, j = rj - r * kWords;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 4 * cq + q;
      if (c < ic) {
        // pixels 4j..4j+3 are raw bytes 4j + kRawLead - 1 ..: one byte
        // before a word boundary
        const uint32_t* wp =
            reinterpret_cast<const uint32_t*>(raw + c * CSTRIDE + r * kMultiPitch) + j +
            (kRawLead - 4) / 4;
        v[q] = __funnelshift_r(wp[0], wp[1], 24);
      } else {
        v[q] = 0u;
      }
    }
    const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140);
    const uint32_t t1 = __byte_perm(v[2], v[3], 0x5140);
    const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362);
    const uint32_t t3 = __byte_perm(v[2], v[3], 0x7362);
    const uint32_t px[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                            __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = 4 * j + q;
      if (col >= kActPitch) break;
      const int p = r * kActPitch + col;
      *reinterpret_cast<uint32_t*>(act + p * cp + 16 * ((cq >> 2) ^ swz(p, cpc)) +
                                   4 * (cq & 3)) = px[q];
    }
  }
}

// The multi-channel GEMM of one TH-row tile into the output tile `ot`
// (channel planes `opitch` bytes apart; rows of kTileW, or kTileW / 2
// pooled). A warp's unit is one 2-row band (kMTiles M tiles side by side:
// one B fragment feeds kMTiles MMAs) times kNT N tiles. `w`: the packed
// weights in shared memory. CPC: 16-channel chunks per pixel (1, 2, 4),
// or 0 for cp_rt / 16 (8 or more), so that the K loop's tap and chunk
// arithmetic folds at compile time where it can.
template <bool POOL, int TH, int CPC>
__device__ void multi_tile(const uint8_t* __restrict__ act, int cp_rt,
                           const uint2* __restrict__ w, int oc, int shift,
                           uint8_t* __restrict__ ot, int opitch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int cpc = CPC > 0 ? CPC : cp_rt >> 4;
  const int cp = 16 * cpc;
  const int n_ks = cpc == 1 ? 5 : 9 * cpc / 2;
  const int ntiles = (oc + 7) >> 3;
  const int n_groups = (ntiles + kNT - 1) / kNT;
  constexpr int bands = TH / 2;
  // ldmatrix: this lane addresses row (lane & 7) + (lane & 8) of the M
  // tile (pixel column lane & 7 of its upper or lower row) at K chunk
  // lane >> 4 of the step
  const int ldy = (lane >> 3) & 1, lcol = lane & 7, lh = lane >> 4;
  const uint32_t act_s = static_cast<uint32_t>(__cvta_generic_to_shared(act));

  for (int unit = warp; unit < bands * n_groups; unit += kLayerWarps) {
    const int pr = unit % bands;
    const int t0 = (unit / bands) * kNT;
    int acc[kMTiles][kNT][4];
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int i = 0; i < kNT; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0;
    }
    const int p0 = (2 * pr + ldy) * kActPitch + lcol;
#pragma unroll(CPC == 1 ? 5 : CPC == 2 ? 9 : CPC == 4 ? 6 : 1)
    for (int ks = 0; ks < n_ks; ++ks) {
      int tap, c16;
      if (cpc == 1) {
        tap = min(2 * ks + lh, 8);  // the tenth tap: zero weights
        c16 = 0;
      } else {
        tap = (2 * ks) / cpc;
        c16 = 2 * ks - tap * cpc + lh;
      }
      const int ky = tap / 3;
      const int toffs = ky * kActPitch + (tap - 3 * ky);
      uint32_t a[kMTiles][4];
#pragma unroll
      for (int m = 0; m < kMTiles; ++m) {
        const int p = p0 + 8 * m + toffs;
        ldmatrix_x4(a[m], act_s + p * cp + 16 * (c16 ^ swz(p, cpc)));
      }
      const uint2* wk = w + ks * ntiles * 32 + lane;
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (t0 + i < ntiles) {  // warp-uniform
          const uint2 b = wk[(t0 + i) * 32];
#pragma unroll
          for (int m = 0; m < kMTiles; ++m) {
            mma_u8s8(acc[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b.x, b.y);
          }
        }
      }
    }

    // rows g (upper) and g + 8 (lower) of columns 2 t4, 2 t4 + 1; pooled,
    // then the pixel column g ^ 1 from lane ^ 4. Max before the shift is
    // exact: both are monotone.
#pragma unroll
    for (int m = 0; m < kMTiles; ++m) {
#pragma unroll
      for (int i = 0; i < kNT; ++i) {
        if (t0 + i >= ntiles) continue;  // warp-uniform
        const int n0 = 8 * (t0 + i) + 2 * t4;
        if (POOL) {
          int m0 = max(acc[m][i][0], acc[m][i][2]);
          int m1 = max(acc[m][i][1], acc[m][i][3]);
          m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
          m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
          if (g & 1) continue;
          uint8_t* o = ot + pr * (kTileW / 2) + 4 * m + (g >> 1);
          if (n0 < oc) o[n0 * opitch] = static_cast<uint8_t>(clip_shift(m0, shift));
          if (n0 + 1 < oc) o[(n0 + 1) * opitch] = static_cast<uint8_t>(clip_shift(m1, shift));
        } else {
          uint8_t* o = ot + 2 * pr * kTileW + 8 * m + g;
          if (n0 < oc) {
            o[n0 * opitch] = static_cast<uint8_t>(clip_shift(acc[m][i][0], shift));
            o[n0 * opitch + kTileW] = static_cast<uint8_t>(clip_shift(acc[m][i][2], shift));
          }
          if (n0 + 1 < oc) {
            o[(n0 + 1) * opitch] = static_cast<uint8_t>(clip_shift(acc[m][i][1], shift));
            o[(n0 + 1) * opitch + kTileW] =
                static_cast<uint8_t>(clip_shift(acc[m][i][3], shift));
          }
        }
      }
    }
  }
}

// The one-channel recast of one tile, output channel groups g0 .. g1 - 1
// (16 channels each) into `ot` (planes `opitch` apart, channel 16 g0
// first; rows of 2 kQCols, or kQCols pooled). A warp's unit is one M tile
// of 16 quads in one quad row; B (packed (G, 8, 32) words) stays in 8
// registers per group.
template <bool POOL>
__device__ void one_tile(const uint8_t* __restrict__ raw, const uint32_t* __restrict__ w,
                         int oc, int g0, int g1, int shift, uint8_t* __restrict__ ot,
                         int opitch) {
  constexpr int kMtPerRow = kQCols / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  for (int grp = g0; grp < g1; ++grp) {
    uint32_t b[8];
    one_channel_b<true>(b, w, grp, lane);
    for (int mt = warp; mt < kQRows * kMtPerRow; mt += kLayerWarps) {
      const int qr = mt / kMtPerRow;
      const int qc0 = (mt - qr * kMtPerRow) * 16;
      // patch row t4 of quads qc0 + g and qc0 + g + 8: raw row 2 qr + t4,
      // bytes from 2 qc + kRawLead - 1 (odd: two words and a funnel shift)
      uint32_t a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a[h] = one_channel_a(raw + (2 * qr + t4) * kOnePitch, 2 * (qc0 + g + 8 * h) + kRawLead - 1);
      }
      int acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
        mma_u8s8_k16(acc[t], a[0], a[1], b[t]);
      }
      // N tile 2p + h, column 2 t4 + e: channel 16 grp + 8 h + 2 t4 + e at
      // position p = 2 py + px; C rows g and g + 8: quads qc0 + g (+ 8)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = 16 * grp + 8 * h + 2 * t4 + e;
          if (ch >= oc) continue;
          uint8_t* plane = ot + (ch - 16 * g0) * opitch;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int qc = qc0 + g + 8 * r;
            const int v0 = acc[h][2 * r + e], v1 = acc[2 + h][2 * r + e];
            const int v2 = acc[4 + h][2 * r + e], v3 = acc[6 + h][2 * r + e];
            if (POOL) {
              plane[qr * kQCols + qc] =
                  static_cast<uint8_t>(clip_shift(max(max(v0, v1), max(v2, v3)), shift));
            } else {
              uint16_t* o = reinterpret_cast<uint16_t*>(plane + 2 * qr * 2 * kQCols + 2 * qc);
              o[0] = static_cast<uint16_t>(clip_shift(v0, shift) | (clip_shift(v1, shift) << 8));
              o[kQCols] =
                  static_cast<uint16_t>(clip_shift(v2, shift) | (clip_shift(v3, shift) << 8));
            }
          }
        }
      }
    }
  }
}

// The output tile (nch channel planes `opitch` apart, ROWS x COLS) to
// (oy0, ox0) of the output planes at `ob`, masked at the map's edge.
template <int ROWS, int COLS>
__device__ void store_tile(const uint8_t* __restrict__ ot, int opitch, int nch,
                           uint8_t* __restrict__ ob, int OH, int OW, int oy0, int ox0,
                           bool vec) {
  const size_t oplane = static_cast<size_t>(OH) * OW;
  if (vec) {
    constexpr int kPerRow = COLS / 16;
    const int total = nch * ROWS * kPerRow;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      const int k = i % kPerRow;
      const int cr = i / kPerRow;
      const int c = cr / ROWS, r = cr - c * ROWS;
      const int y = oy0 + r, x = ox0 + 16 * k;
      if (y < OH && x < OW) {
        *reinterpret_cast<uint4*>(ob + c * oplane + static_cast<size_t>(y) * OW + x) =
            *reinterpret_cast<const uint4*>(ot + c * opitch + r * COLS + 16 * k);
      }
    }
    return;
  }
  const int total = nch * ROWS * COLS;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int k = i % COLS;
    const int cr = i / COLS;
    const int c = cr / ROWS, r = cr - c * ROWS;
    const int y = oy0 + r, x = ox0 + k;
    if (y < OH && x < OW) {
      ob[c * oplane + static_cast<size_t>(y) * OW + x] = ot[c * opitch + r * COLS + k];
    }
  }
}

// TH: pre-pool rows of a tile (2 kQRows on the one-channel path). Shared
// memory: two raw buffers, the channels-last tile and the packed weights
// (both multi-channel only), the output tile.
template <bool POOL, bool ONE, int TH>
__global__ void __launch_bounds__(kLayerThreads, 2) conv_layer_kernel(LayerArgs a) {
  constexpr int kTW = ONE ? 2 * kQCols : kTileW;
  constexpr int kRows = TH + 2;
  constexpr int kPitch = ONE ? kOnePitch : kMultiPitch;
  constexpr int kCStride = kRows * kPitch + (ONE ? 0 : 16);  // 16: channel rows off one bank
  constexpr int kORows = POOL ? TH / 2 : TH, kOCols = POOL ? kTW / 2 : kTW;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const raw0 = smem;
  uint8_t* const raw1 = smem + a.raw_bytes;
  uint8_t* const act = smem + 2 * a.raw_bytes;
  uint8_t* const wsm = act + a.act_bytes;
  uint8_t* const ot = wsm + a.w_bytes;
  // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1.
  // The wrappers' callers refuse shifts outside 0..31.
  const int shift = min(max(a.shifts[a.layer], 0), 31);
  const int nch = ONE ? 1 : a.ic;
  const int H = a.height, W = a.width;
  const int OH = POOL ? H / 2 : H, OW = POOL ? W / 2 : W;
  const size_t plane = static_cast<size_t>(H) * W;
  const size_t oplane = static_cast<size_t>(OH) * OW;
  const int cp = ONE ? 1 : cpad_of(a.ic);

  auto stage = [&](int item, uint8_t* buf) {
    const int b = item / a.tiles, t = item - b * a.tiles;
    const int ty = t / a.tiles_x;
    stage_raw<kRows, kTW, kPitch, kCStride>(a.x + static_cast<size_t>(b) * a.ic * plane, nch,
                                            H, W, ty * TH, (t - ty * a.tiles_x) * kTW, buf,
                                            a.vec_in);
  };

  int item = blockIdx.x;
  if (item >= a.n_items) return;
  // the packed weights, once per CTA, with the first item's copies
  for (int i = threadIdx.x; i < a.w_bytes / 16; i += blockDim.x) {
    cp_async16(wsm + 16 * i, static_cast<const uint8_t*>(a.w) + 16 * i, true);
  }
  stage(item, raw0);
  cp_async_commit();
  for (int k = 0; item < a.n_items; item += gridDim.x, ++k) {
    uint8_t* const cur = (k & 1) ? raw1 : raw0;
    const int next = item + gridDim.x;
    if (next < a.n_items) stage(next, (k & 1) ? raw0 : raw1);
    cp_async_commit();
    cp_async_wait_prior();  // this item's copies have landed
    __syncthreads();
    const int b = item / a.tiles, t = item - b * a.tiles;
    const int ty = t / a.tiles_x;
    const int oy0 = ty * kORows, ox0 = (t - ty * a.tiles_x) * kOCols;
    uint8_t* ob = a.out + static_cast<size_t>(b) * a.oc * oplane;
    if (ONE) {
      const int groups = (a.oc + 15) / 16;
      for (int g0 = 0; g0 < groups; g0 += a.ogroups) {
        const int g1 = min(groups, g0 + a.ogroups);
        if (g0 > 0) __syncthreads();  // the previous pass is stored
        one_tile<POOL>(cur, static_cast<const uint32_t*>(a.w), a.oc, g0, g1, shift, ot,
                       a.opitch);
        __syncthreads();
        store_tile<kORows, kOCols>(ot, a.opitch, min(a.oc, 16 * g1) - 16 * g0,
                                   ob + 16 * g0 * oplane, OH, OW, oy0, ox0, a.vec_out);
      }
    } else {
      raw_to_act<kRows, kCStride>(cur, a.ic, cp, act);
      __syncthreads();
      const uint2* wk = reinterpret_cast<const uint2*>(wsm);
      switch (cp) {
        case 16: multi_tile<POOL, TH, 1>(act, cp, wk, a.oc, shift, ot, a.opitch); break;
        case 32: multi_tile<POOL, TH, 2>(act, cp, wk, a.oc, shift, ot, a.opitch); break;
        case 64: multi_tile<POOL, TH, 4>(act, cp, wk, a.oc, shift, ot, a.opitch); break;
        default: multi_tile<POOL, TH, 0>(act, cp, wk, a.oc, shift, ot, a.opitch);
      }
      __syncthreads();
      store_tile<kORows, kOCols>(ot, a.opitch, a.oc, ob, OH, OW, oy0, ox0, a.vec_out);
    }
  }
}

// Two CTAs of an SM split its shared memory (less 1 KB each for the runtime).
constexpr int kLayerTwoPerSm = 233472 / 2 - 1024;

// The shared memory a geometry needs (and its tiling in `a`), 0 if no
// tiling fits one block. A tiling that lets two CTAs share an SM comes
// first; then the tallest tile.
template <bool POOL>
int layer_smem(LayerArgs& a) {
  if (a.ic == 1) {
    a.th = 2 * kQRows;
    a.raw_bytes = (a.th + 2) * kOnePitch;
    a.act_bytes = 0;
    a.w_bytes = 0;  // read from global into registers, 1 KB per 16 channels
    const int orows = POOL ? kQRows : 2 * kQRows, ocols = POOL ? kQCols : 2 * kQCols;
    a.opitch = orows * ocols + 16;
    const int groups = (a.oc + 15) / 16;
    const int room = 2 * a.raw_bytes + 16 * a.opitch <= kLayerTwoPerSm ? kLayerTwoPerSm
                                                                     : kLayerMaxSmem;
    a.ogroups = std::min(groups, (room - 2 * a.raw_bytes) / (16 * a.opitch));
    if (a.ogroups < 1) return 0;
    return 2 * a.raw_bytes + 16 * a.ogroups * a.opitch;
  }
  const long long cp = cpad_of(a.ic);
  const long long n_ks = (9 * cp + 31) / 32;
  const long long wb = n_ks * ((a.oc + 7) / 8) * 256;
  for (const int room : {kLayerTwoPerSm, kLayerMaxSmem}) {
    for (int th = 32; th >= 2; th >>= 1) {
      const long long rows = th + 2;
      const long long raw = a.ic * (rows * kMultiPitch + 16);
      const long long act = (rows * kActPitch * cp + 15) / 16 * 16;
      const long long opitch = (POOL ? (th / 2) * (kTileW / 2) : th * kTileW) + 16;
      const long long total = 2 * raw + act + wb + a.oc * opitch;
      if (total <= room) {
        a.th = th;
        a.raw_bytes = static_cast<int>(raw);
        a.act_bytes = static_cast<int>(act);
        a.w_bytes = static_cast<int>(wb);
        a.opitch = static_cast<int>(opitch);
        a.ogroups = 0;
        return static_cast<int>(total);
      }
    }
  }
  return 0;
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum LayerPath {
  kOnePooled, kOneUnpooled, kOneGroupPasses,
  kCp16Pooled, kCp16Unpooled, kCp32Pooled, kCp32Unpooled, kCp64Pooled, kCp64Unpooled,
  kCpGenericPooled, kCpGenericUnpooled,
  kBytewiseStaging, kBytewiseStores, kOneSecondItem, kMultiSecondItem, kLayerPaths
};
constexpr const char* kLayerPathNames[kLayerPaths] = {
    "one-channel pooled", "one-channel unpooled", "one-channel, output-group pass g0 > 0",
    "multi-channel cp=16 pooled", "multi-channel cp=16 unpooled",
    "multi-channel cp=32 pooled", "multi-channel cp=32 unpooled",
    "multi-channel cp=64 pooled", "multi-channel cp=64 unpooled",
    "multi-channel cp=generic pooled", "multi-channel cp=generic unpooled",
    "byte-wise staging (vec_in false)", "byte-wise stores (vec_out false)",
    "one-channel, persistent loop k >= 1", "multi-channel, persistent loop k >= 1"};
PathCounts<kLayerPaths> g_layer_paths(kLayerPathNames);

// Counts the paths a launch of `grid` CTAs on the plan `a` takes: the
// one-channel path (with more than one output-group pass when a pass holds
// fewer groups than the layer has), the multi-channel path by channel
// padding (multi_tile's cases), the byte-wise staging and stores, and a
// second item for some CTA of the persistent loop (one buffer swap).
template <bool POOL>
void count_layer_paths(const LayerArgs& a, int grid) {
  const int unpooled = POOL ? 0 : 1;
  if (a.ic == 1) {
    g_layer_paths.add(kOnePooled + unpooled);
    if (a.ogroups < (a.oc + 15) / 16) g_layer_paths.add(kOneGroupPasses);
  } else {
    const int cp = cpad_of(a.ic);
    const int base = cp == 16 ? kCp16Pooled : cp == 32 ? kCp32Pooled
                   : cp == 64 ? kCp64Pooled : kCpGenericPooled;
    g_layer_paths.add(base + unpooled);
  }
  if (!a.vec_in) g_layer_paths.add(kBytewiseStaging);
  if (!a.vec_out) g_layer_paths.add(kBytewiseStores);
  if (a.n_items > grid) g_layer_paths.add(a.ic == 1 ? kOneSecondItem : kMultiSecondItem);
}

using LayerKernel = void (*)(LayerArgs);

template <bool POOL>
LayerKernel layer_kernel(int ic, int th) {
  if (ic == 1) return conv_layer_kernel<POOL, true, 2 * kQRows>;
  switch (th) {
    case 32: return conv_layer_kernel<POOL, false, 32>;
    case 16: return conv_layer_kernel<POOL, false, 16>;
    case 8: return conv_layer_kernel<POOL, false, 8>;
    case 4: return conv_layer_kernel<POOL, false, 4>;
    default: return conv_layer_kernel<POOL, false, 2>;
  }
}

// Launches the layer on `stream` of CUDA device `device`: x (B, ic, H, W)
// u8, w the packed weights (ops/mega.py: pack_one_channel for ic = 1, else
// pack_fragments), shifts a device int32 vector read at `layer`, out
// (B, oc, H, W) u8 or with POOL (B, oc, H/2, W/2). Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
template <bool POOL>
cudaError_t launch_layer(const void* x, const void* w, const void* shifts, int layer,
                         void* out, int batch, int ic, int oc, int height, int width,
                         int device, void* stream) {
  if (batch < 0 || ic < 1 || oc < 1 || layer < 0 || height < 1 || width < 1 ||
      height > kLayerMaxSide || width > kLayerMaxSide) {
    return cudaErrorInvalidValue;
  }
  if (POOL && (height % 2 != 0 || width % 2 != 0)) return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  LayerArgs a;
  a.x = static_cast<const uint8_t*>(x);
  a.w = w;
  a.shifts = static_cast<const int32_t*>(shifts);
  a.out = static_cast<uint8_t*>(out);
  a.layer = layer;
  a.ic = ic;
  a.oc = oc;
  a.height = height;
  a.width = width;
  const int smem = layer_smem<POOL>(a);
  if (smem == 0) return cudaErrorInvalidValue;
  const int tw = ic == 1 ? 2 * kQCols : kTileW;
  a.tiles_x = (width + tw - 1) / tw;
  a.tiles = a.tiles_x * ((height + a.th - 1) / a.th);
  if (static_cast<long long>(a.tiles) * batch > INT_MAX) return cudaErrorInvalidValue;
  a.n_items = a.tiles * batch;
  const int ow = POOL ? width / 2 : width;
  a.vec_in = width % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  a.vec_out = ow % 16 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const LayerKernel kernel = layer_kernel<POOL>(ic, a.th);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kLayerThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(std::min<long long>(a.n_items, 1LL * per_sm * sms));
  kernel<<<grid, kLayerThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) count_layer_paths<POOL>(a, grid);
  return err;
}

}  // namespace
