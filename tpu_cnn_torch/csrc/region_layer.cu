// One pooled 3x3 layer of a region-head detector with fewer than 128 input
// channels, on Hopper's int8 tensor cores (sm_90a): YOLOv2-tiny's L0-L3
// (3->16 at 416, 16->32 at 208, 32->64 at 104, 64->128 at 52). It replaces
// no TPU kernel: the JAX package has no region-head detector.
//
//     x (B, ic, H, W) u8, NCHW or channels-last (B, H, W, ic); H, W even
//     -> SAME 3x3 conv, exact s32 sums, + bias[oc]
//     -> u8 = clip(>> shift[layer], 0, 255) -> 2x2 stride-2 max
//     -> (B, H/2, W/2, oc) u8, channels-last
//
// A darknet graph's convs (YOLOv3's of fewer than 128 input channels) take
// the same tiles with another output (region_layer_plan.h's out_mode, a
// compile-time instantiation each): the unpooled map, M rows g and g + 8 a
// row pair's pixels, or the stride-2 conv, M rows two output rows of one
// column reading every other staged pixel; each stores 2 bytes a lane
// from registers, the residual map (the shortcut's other input) added
// after the clip, saturating at 255.
//
// An implicit GEMM on wgmma: M = pre-pool pixels, N = oc (16, 32, 64 or
// 128: m64nNk32, oc padded with zero weights), K = the pixel's 3x3
// neighbourhood. The geometry (paths, shared-memory plan, the persistent
// schedule, which pixel each M row is) lives in region_layer_plan.h.
//
// What bounds it on an H100, a round of 512 frames: bytes for L0 and L1
// (0.185 and 0.159 ms at 3.35 TB/s: the frames in and the maps out against
// 38 G and 102 G MACs), MACs for L2 and L3 (0.103 ms each at 989.5 T
// MAC/s). So each map byte is read from HBM once (a band's halo rows come
// from L2) and written once, at least 16 bytes at a time, and the tensor
// cores are fed from shared memory without a byte-wise path on these
// shapes. The design:
//
// - Channels-last maps between layers. A work item is a band of pooled
//   rows of one image; its source rows with their halo are copied by
//   cp.async into a staging buffer while the CTA computes the previous
//   item (two buffers). A channels-last map of 16-channel multiples is
//   copied in 16-byte chunks straight into the staged layout (a pixel's
//   channels padded to 16, 32, 64 or 128 bytes, its 16-byte chunks XOR
//   swizzled by pixel). The output leaves channels-last, so the next layer
//   (and the streamed kernel's L4) reads it the same way.
// - A from registers, by ldmatrix from the staged band: the im2col is an
//   address. M row g of a warp is the upper pixel of position q0 + g, row
//   g + 8 the lower one, and each K step's fragment is one ldmatrix.x4 of
//   the staged pixels its tap reads. Feeding A paces these small-K layers,
//   not the MMAs (the streamed kernel's L4 on the card). A producer
//   warpgroup building swizzled A in shared memory would write every byte
//   of A once more and read it again; ldmatrix from a band staged once
//   reads it once, and every warpgroup of the CTA computes.
// - L0's three channels recast: the frames' NCHW planes are copied raw and
//   interleaved in shared memory into a 32-bit word a pixel (c0, c1, c2);
//   a pixel's K row is its 27 bytes (tap-major, channel-minor) in one k32
//   step, 27 of 32 real, each A word two words of the staging joined by a
//   byte permute. At N 16 a warpgroup issues two tiles' MMAs a wait.
// - wgmma m64nNk32 with the weights resident: a layer's packed B (0.5-74
//   KB; ops/region_layer.py's pack_layer, hopper.cuh's layout) is copied
//   into shared memory once by every CTA of a persistent grid (three CTAs
//   an SM at N 16 and 32, two at 64, one of four warpgroups at 128), which
//   then walks the items.
// - The epilogue in registers: the window's rows g and g + 8 are a lane's
//   own accumulators, its columns lane ^ 4's (one shuffle of a word of
//   clipped bytes). At N 16 and 32 the pooled bytes gather in the item's
//   output in shared memory, which leaves by one bulk copy (the TMA's 1-D
//   form) an item; at N 64 and 128 a quad's lanes trade 16-bit halves so
//   that each lane stores 16 consecutive channels of a pooled pixel.
// - Switching parts off on an H100 showed where L0's time goes: the
//   staging and the output's copies take 0.24 ms of its 1.24, the MMAs
//   with building A about as much as the epilogue; both are instruction
//   bound, at 16 channels a tile has little work to spread them over.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>

#include <cuda_runtime.h>

#include "hopper.cuh"
#include "int8_mma.cuh"
#include "path_counts.cuh"
#include "region_layer_plan.h"

namespace {

using namespace region_plan;

constexpr int kGroup = 128;  // threads of a warpgroup

template <int N>
struct Cfg {
  static constexpr int kGroups = warpgroups(N);
  static constexpr int kThreads = kGroup * kGroups;
  static constexpr int kMinBlocks = ctas_an_sm(N);  // the register cap
};

struct LayerArgs {
  const uint8_t* x;
  const int8_t* w;        // pack_layer's B
  const int32_t* bias;    // (oc,)
  const int32_t* shifts;  // read at `layer`
  uint8_t* out;           // (B, H/2, W/2, oc)
  long long sb, sc, sy, sx;  // x's strides in bytes (the byte-wise staging)
  int layer;
  Geometry g;
  const uint8_t* res;  // the unpooled modes' residual map, out's shape (null: none)
};

// d (+)= A (registers) x B (64 x 128 of 32 K bytes; hopper.cuh's Wgmma).
template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p;\n"
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
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

// 16 bytes global -> shared, completing asynchronously; zeros where !valid.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits for every group of copies but the newest.
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// `bytes` (a multiple of 16; both addresses 16-byte aligned) from shared
// to global memory by the bulk copy engine, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void st_global16(void* p, uint4 v) {
  asm volatile("st.global.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ void sts16(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u16 [%0], %1;\n" :: "r"(addr), "h"(static_cast<uint16_t>(v)) : "memory");
}

__device__ __forceinline__ int clip_shift(int v, int shift) {
  return min(max(v >> shift, 0), 255);  // >> on int is arithmetic (floor)
}

// ── staging ──────────────────────────────────────────────────────────

// A walk over flattened items in rows of `per_row`, `stride` items a
// step, without a division a step: item i is (row, col).
struct Walk {
  int i, row, col, per_row, stride, drow, dcol;
  __device__ __forceinline__ Walk(int start, int per_row_, int stride_)
      : i(start), per_row(per_row_), stride(stride_) {
    row = start / per_row;
    col = start - row * per_row;
    drow = stride / per_row;
    dcol = stride - drow * per_row;
  }
  __device__ __forceinline__ void step() {
    i += stride;
    row += drow;
    col += dcol;
    if (col >= per_row) {
      col -= per_row;
      ++row;
    }
  }
};

// Issues the copies of work item `u`'s source rows into buffer `buf` (the
// raw planes, or the staging): cp.async, or plain loads byte by byte. CPC:
// the staged pixel's 16-byte chunks (taps), 0 for the recast's 4 bytes.
template <int CPC>
__device__ __forceinline__ void load_item(const LayerArgs& a, uint8_t* smem, long long u,
                                          int buf, int tid, int nthreads) {
  const Geometry& g = a.g;
  int b, band, seg, prows, sw, x0, q;
  unit_item(g, u, b, band, seg);
  item_shape(g, band, seg, prows, sw, x0, q);
  const int rows = 2 * prows + 2, scols = g.lead + sw + 1;
  const int y0 = 2 * band * g.band - 1, xs0 = x0 - g.lead;  // staged (0, 0)'s source
  const int H = g.height, W = g.width;
  if (g.load == kLoadPlanes) {  // three NCHW planes, W % 16 == 0: whole rows
    uint8_t* raw = smem + g.off_raw + buf * g.raw_bytes;
    const int chunks = W / 16;
    for (int c = 0; c < 3; ++c) {
      const uint8_t* xc = a.x + (static_cast<size_t>(b) * 3 + c) * H * W;
      for (Walk k(tid, chunks, nthreads); k.i < rows * chunks; k.step()) {
        const int y = y0 + k.row;
        const bool ok = y >= 0 && y < H;
        cp_async16(raw + (c * g.rows + k.row) * W + 16 * k.col,
                   ok ? xc + static_cast<size_t>(y) * W + 16 * k.col : a.x, ok);
      }
    }
    return;
  }
  uint8_t* st = smem + g.off_stage + buf * g.stage_bytes;
  if constexpr (CPC > 0) {
    if (g.load == kLoadNhwc16) {  // channels-last, ic % 16 == 0: 16-byte chunks
      const int cin = g.ic / 16, per_row = scols * CPC;
      const uint8_t* xb = a.x + static_cast<size_t>(b) * H * W * g.ic;
      for (Walk k(tid, per_row, nthreads); k.i < rows * per_row; k.step()) {
        const int sc = k.col / CPC, c = k.col % CPC;
        if (c >= cin) continue;  // a padding chunk: the zeros written first
        const int y = y0 + k.row, x = xs0 + sc;
        const bool ok = y >= 0 && y < H && x >= 0 && x < W;
        const int p = k.row * g.cols + sc;
        cp_async16(st + p * g.cp + 16 * (c ^ swz(p, CPC)),
                   ok ? xb + (static_cast<size_t>(y) * W + x) * g.ic + 16 * c : a.x, ok);
      }
      return;
    }
  }
  // any layout, any ic: byte by byte through x's strides (padding channels
  // stay the zeros the kernel wrote first)
  for (int i = tid; i < rows * scols * g.ic; i += nthreads) {
    const int pix = i / g.ic, c = i - pix * g.ic;
    const int sr = pix / scols, sc = pix - sr * scols;
    const int y = y0 + sr, x = xs0 + sc;
    const bool ok = y >= 0 && y < H && x >= 0 && x < W;
    const uint8_t v = ok ? a.x[b * a.sb + c * a.sc + y * a.sy + x * a.sx] : 0;
    const int p = sr * g.cols + sc;
    st[CPC == 0 ? 4 * p + c : p * g.cp + 16 * ((c >> 4) ^ swz(p, CPC)) + (c & 15)] = v;
  }
}

// The raw planes of `rows` staged rows -> the recast's staging, a word a
// pixel (c0, c1, c2, c2) from staged column `lead` on: four pixels a
// thread, three word loads and six byte permutes.
__device__ __forceinline__ void planes_to_stage(const Geometry& g, uint8_t* smem, int buf,
                                                int rows, int tid, int nthreads) {
  const uint8_t* raw = smem + g.off_raw + buf * g.raw_bytes;
  uint8_t* st = smem + g.off_stage;
  const int W = g.width, quads = W / 4, plane = g.rows * W;
  for (Walk k(tid, quads, nthreads); k.i < rows * quads; k.step()) {
    const uint8_t* r0 = raw + k.row * W + 4 * k.col;
    const uint32_t c0 = *reinterpret_cast<const uint32_t*>(r0);
    const uint32_t c1 = *reinterpret_cast<const uint32_t*>(r0 + plane);
    const uint32_t c2 = *reinterpret_cast<const uint32_t*>(r0 + 2 * plane);
    const uint32_t lo = __byte_perm(c0, c1, 0x5140), hi = __byte_perm(c0, c1, 0x7362);
    *reinterpret_cast<uint4*>(st + 4 * (k.row * g.cols + g.lead + 4 * k.col)) =
        make_uint4(__byte_perm(lo, c2, 0x4410), __byte_perm(lo, c2, 0x5532),
                   __byte_perm(hi, c2, 0x6610), __byte_perm(hi, c2, 0x7732));
  }
}

// ── a warpgroup's tiles ──────────────────────────────────────────────

// What a thread keeps for the whole walk: its lane's roles, the recast's
// word offsets and byte selectors, and (N <= 32) its channels' biases.
template <int N>
struct Lane {
  int lane, w, gq, t;
  uint32_t rc_off[2][2];  // K half h: the two staged words' byte offsets
  uint32_t rc_sel[2];
  int bias[N <= 32 ? N / 4 : 1];
};

// The recast's A (3 channels, one k32 step): K bytes 4t.. and 16 + 4t.. of
// a pixel's row are two staged words joined from byte k0 % 3 of the first
// on (ln.rc_*); for 1-2 channels, byte by byte. `pix`: the staged pixel of
// the upper row's tap (0, 0); the lower row's is a staged row down.
template <int N>
__device__ __forceinline__ void recast_a(const uint8_t* st, const Geometry& g, const Lane<N>& ln,
                                         int pix, uint32_t (&af)[4]) {
  const uint32_t base = smem_u32(st) + 4 * pix, down = 4 * g.cols;
  auto lds = [](uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
  };
  if (g.ic == 3) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int lower = 0; lower < 2; ++lower) {
        const uint32_t at = base + lower * down;
        af[2 * h + lower] = __byte_perm(lds(at + ln.rc_off[h][0]), lds(at + ln.rc_off[h][1]),
                                        ln.rc_sel[h]);
      }
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int k0 = 16 * h + 4 * ln.t;
#pragma unroll
    for (int lower = 0; lower < 2; ++lower) {
      uint32_t v = 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + i, tap = k / g.ic, c = k - tap * g.ic, tt = min(tap, 8);
        const int ky = tt / 3;
        v |= (static_cast<uint32_t>(st[4 * (pix + lower * g.cols + ky * g.cols + tt - 3 * ky) + c])
              & 0xFFu) << (8 * i);
      }
      af[2 * h + lower] = v;  // a0, a1: rows g, g + 8 at K bytes 4t..; a2, a3: 16 + 4t..
    }
  }
}

// K steps, and the steps a tile's A fragments are loaded for before their
// MMAs are issued.
template <int CPC>
struct Steps {
  static constexpr int kSteps = k_steps(CPC == 0 ? kRecast : kTaps, 16 * CPC);
  static constexpr int kKg = k_group(CPC == 0 ? kRecast : kTaps, 16 * CPC);
};

// Issues a tile's MMAs into `acc` (the first overwrites it): A of each K step by
// ldmatrix (taps) or the recast from the staged pixel `pix` (this lane's
// A row's tap (0, 0)), B from the resident weights. The last batch is left
// in flight (committed; the caller waits); earlier ones are waited for.
template <int CPC, int N>
__device__ __forceinline__ void issue_tile(const uint8_t* smem, const uint8_t* st,
                                           const Geometry& g, const Lane<N>& ln, int pix,
                                           int (&acc)[N / 2],
                                           uint32_t (&af)[Steps<CPC>::kKg][4]) {
  constexpr int kSteps = Steps<CPC>::kSteps, kKg = Steps<CPC>::kKg;
  // B of K step s starts s (N / 8) 256 bytes on: the descriptor's address
  // field (16-byte units) advances by (N / 8) 16 a step
  const uint64_t desc0 = b_desc(smem_u32(smem), N / 8, 0, 0);
  constexpr int kDstep = (N / 8) * 16;
  if constexpr (CPC == 0) {
    recast_a<N>(st, g, ln, pix, af[0]);
    fence_regs(acc);
    wgmma_fence();
    Wgmma<N>::mma(acc, af[0], desc0, 0);
    wgmma_commit();
  } else {
    constexpr int kCp = 16 * CPC;
    const uint32_t st_s = smem_u32(st);
    const int lh = ln.lane >> 4;
#pragma unroll
    for (int ks0 = 0; ks0 < kSteps; ks0 += kKg) {
#pragma unroll
      for (int k = 0; k < kKg; ++k) {
        const int ks = ks0 + k;
        // 16 channels: taps 2 ks, 2 ks + 1 (the tenth tap meets zero
        // weights); else tap 2 ks / CPC, chunks from (2 ks) % CPC
        const int tap = CPC == 1 ? min(2 * ks + lh, 8) : 2 * ks / CPC;
        const int c16 = CPC == 1 ? 0 : (2 * ks) % CPC + lh;
        const int ky = tap / 3;
        const int pp = pix + ky * g.cols + tap - 3 * ky;
        ldmatrix_x4(af[k], st_s + pp * kCp + 16 * (c16 ^ swz(pp, CPC)));
      }
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < kKg; ++k) {
        Wgmma<N>::mma(acc, af[k], desc0 + static_cast<uint64_t>((ks0 + k) * kDstep),
                      ks0 + k > 0);
      }
      wgmma_commit();
      if (kSteps > kKg) {  // the next batch overwrites af
        wgmma_wait_all();
        fence_regs(acc);
      }
    }
  }
  fence_regs(acc);
}

// The bias, shift, clip and 2x2 pool of a tile's accumulators, stored
// channels-last: into the item's output in shared memory at byte `soff` of
// its pooled pixel (bulk_out), else to global memory at pooled pixel `pix`
// (valid: inside the item).
template <int N>
__device__ __forceinline__ void store_tile(const LayerArgs& a, const Lane<N>& ln,
                                           const uint8_t* smem, int (&acc)[N / 2], bool valid,
                                           int soff, long long pix, int shift) {
  const Geometry& g = a.g;
  const int32_t* bias_s = reinterpret_cast<const int32_t*>(smem + g.off_bias);
  // u[j]: the bytes of channels 8 j + 2 t, + 1 of the window's rows g and
  // g + 8 (this lane's accumulators), shifted and clipped (monotone, so the
  // max commutes with them); two j a word, and the max with lane ^ 4's word
  // (columns g ^ 1) pools the window
  uint32_t u[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    int b0, b1;
    if constexpr (N <= 32) {
      b0 = ln.bias[2 * j];
      b1 = ln.bias[2 * j + 1];
    } else {
      const int2 bb = *reinterpret_cast<const int2*>(bias_s + 8 * j + 2 * ln.t);
      b0 = bb.x;
      b1 = bb.y;
    }
    u[j] = static_cast<uint32_t>(clip_shift(max(acc[4 * j], acc[4 * j + 2]) + b0, shift) |
                                 (clip_shift(max(acc[4 * j + 1], acc[4 * j + 3]) + b1, shift) << 8));
  }
  uint32_t wv[N / 16];  // wv[m] = u[2m] | u[2m + 1] << 16, pooled
#pragma unroll
  for (int m = 0; m < N / 16; ++m) {
    const uint32_t w = u[2 * m] | (u[2 * m + 1] << 16);
    wv[m] = __vmaxu4(w, __shfl_xor_sync(0xffffffffu, w, 4));
    u[2 * m] = wv[m] & 0xFFFFu;
    u[2 * m + 1] = wv[m] >> 16;
  }
  uint8_t* out = a.out + pix * g.oc;
  if (N >= 64 && g.oc % 16 == 0) {
    // 16 channels (vector m) of the pooled pixel are units u[2m], u[2m + 1]
    // of the quad's four lanes, and lanes g and g ^ 1 hold the same: each
    // round, each quad gathers one vector (the even quad one of the first
    // half, the odd one of the second) into its lane t = round, which
    // stores it
    constexpr int kR = N / 32;
    const int odd = ln.gq & 1, src = ln.lane & ~3;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const uint32_t pw = odd ? wv[kR + r] : wv[r];
      const uint32_t w0 = __shfl_sync(0xffffffffu, pw, src);
      const uint32_t w1 = __shfl_sync(0xffffffffu, pw, src + 1);
      const uint32_t w2 = __shfl_sync(0xffffffffu, pw, src + 2);
      const uint32_t w3 = __shfl_sync(0xffffffffu, pw, src + 3);
      const int m = odd ? kR + r : r;
      if (valid && ln.t == r && m < g.oc / 16) {
        st_global16(out + 16 * m,
                    make_uint4(__byte_perm(w0, w1, 0x5410), __byte_perm(w2, w3, 0x5410),
                               __byte_perm(w0, w1, 0x7632), __byte_perm(w2, w3, 0x7632)));
      }
    }
    return;
  }
  if (!valid || (ln.gq & 1) != 0) return;  // lanes g and g ^ 1 hold the same
  if (g.out_bytes) {
    const uint32_t at = smem_u32(smem + g.off_out) + soff + 2 * ln.t;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      if (8 * j < g.oc) sts16(at + 8 * j, u[j]);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = 8 * j + 2 * ln.t;
    if (c + 1 < g.oc && g.oc % 2 == 0) {
      *reinterpret_cast<uint16_t*>(out + c) = static_cast<uint16_t>(u[j]);
    } else {
      if (c < g.oc) out[c] = static_cast<uint8_t>(u[j]);
      if (c + 1 < g.oc) out[c + 1] = static_cast<uint8_t>(u[j] >> 8);
    }
  }
}

// The unpooled and stride-2 modes' epilogue: the bias, shift and clip of
// a tile's accumulators, the residual added (saturating) where there is
// one, stored channels-last: M row g (acc[4 j + e]) is output pixel (y, x)
// of position (prow, pcol) of the item, row g + 8 (acc[4 j + 2 + e]) the
// pixel a row down (valid: inside the item).
template <int N, int OUT>
__device__ __forceinline__ void store_plain(const LayerArgs& a, const Lane<N>& ln,
                                            const uint8_t* smem, int (&acc)[N / 2], bool valid,
                                            int prow, int pcol, int b, int band, int x0,
                                            int prows, int shift) {
  if (!valid) return;
  const Geometry& g = a.g;
  const int32_t* bias_s = reinterpret_cast<const int32_t*>(smem + g.off_bias);
  const int oh = OUT == kOutPlain ? g.height : g.oh, ow = OUT == kOutPlain ? g.width : g.ow;
  const int y = OUT == kOutPlain ? 2 * (band * g.band + prow) : band * g.band + 2 * prow;
  const int x = OUT == kOutPlain ? x0 + pcol : x0 / 2 + pcol;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (OUT == kOutStride2 && 2 * prow + h >= prows) continue;
    const long long pix = (static_cast<long long>(b) * oh + y + h) * ow + x;
    uint8_t* o = a.out + pix * g.oc;
    const uint8_t* r = a.res != nullptr ? a.res + pix * g.oc : nullptr;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int c = 8 * j + 2 * ln.t;
      if (c >= g.oc) continue;  // oc is even (make_geometry_ex)
      int b0, b1;
      if constexpr (N <= 32) {
        b0 = ln.bias[2 * j];
        b1 = ln.bias[2 * j + 1];
      } else {
        const int2 bb = *reinterpret_cast<const int2*>(bias_s + c);
        b0 = bb.x;
        b1 = bb.y;
      }
      int v0 = clip_shift(acc[4 * j + 2 * h] + b0, shift);
      int v1 = clip_shift(acc[4 * j + 2 * h + 1] + b1, shift);
      if (r != nullptr) {
        const uint32_t rv = *reinterpret_cast<const uint16_t*>(r + c);
        v0 = min(v0 + static_cast<int>(rv & 0xFFu), 255);
        v1 = min(v1 + static_cast<int>(rv >> 8), 255);
      }
      *reinterpret_cast<uint16_t*>(o + c) = static_cast<uint16_t>(v0 | (v1 << 8));
    }
  }
}

// The warpgroup's tiles wg, wg + groups, .. of one item: each tile's MMAs,
// then its epilogue (the other warpgroups of the SM run theirs meanwhile;
// ptxas serialises a warpgroup's MMAs whose accumulators another tile's
// epilogue reads while they run).
template <int CPC, int N, int OUT>
__device__ __forceinline__ void run_item(const LayerArgs& a, const uint8_t* smem,
                                         const uint8_t* st, const Lane<N>& ln, int wg, int b,
                                         int band, int x0, int sw, int q, int shift,
                                         int prows) {
  const Geometry& g = a.g;
  constexpr int kGroups = Cfg<N>::kGroups, kStride = kTileQ * kGroups;
  const int tiles = (q + kTileQ - 1) / kTileQ;
  // positions a row: the stride-2 mode's output columns, else the segment's
  const int per_row = OUT == kOutStride2 ? sw / 2 : sw;
  if (wg >= tiles) return;
  // this lane's A row: its recast row g (the upper pixel; the lower one a
  // staged row down), or the row it addresses for ldmatrix (lane & 7, the
  // lower pixel for lane & 8)
  const int arow = CPC == 0 ? ln.gq : (ln.lane & 7);
  const int lower = CPC == 0 ? 0 : (ln.lane >> 3) & 1;
  // a lane's positions, as (pooled row, column) of the item: its A row's,
  // and its window's left column
  Walk pa(wg * kTileQ + 8 * ln.w + arow, per_row, kStride);
  Walk pe(wg * kTileQ + 8 * ln.w + (OUT == kOutPool ? (ln.gq & ~1) : ln.gq), per_row, kStride);
  const long long pix0 = (static_cast<long long>(b) * g.oh + band * g.band) * g.ow + x0 / 2;

  // N 16: two tiles' MMAs a wait, their epilogues side by side
  constexpr int kTwo = N == 16;
  int acc0[N / 2], acc1[N / 2];
  uint32_t af0[Steps<CPC>::kKg][4], af1[Steps<CPC>::kKg][4];
  auto a_pix = [&]() {
    if constexpr (OUT == kOutStride2) {  // output row 2 row + lower reads source rows from twice it
      return pa.i < q && 2 * pa.row + lower < prows
                 ? 2 * (2 * pa.row + lower) * g.cols + g.lead + 2 * pa.col - 1
                 : g.lead;  // past the item: read, never stored
    }
    return pa.i < q ? (2 * pa.row + lower) * g.cols + g.lead + pa.col - 1
                    : g.lead;  // past the item: read, never stored
  };
  auto pooled = [&]() { return pix0 + static_cast<long long>(pe.row) * g.ow + pe.col / 2; };
  auto soff = [&]() { return (pe.row * (sw / 2) + pe.col / 2) * g.oc; };
  for (int tile = wg; tile < tiles; tile += (1 + kTwo) * kGroups) {
    const bool two = kTwo && tile + kGroups < tiles;
    issue_tile<CPC, N>(smem, st, g, ln, a_pix(), acc0, af0);
    pa.step();
    if (two) {
      issue_tile<CPC, N>(smem, st, g, ln, a_pix(), acc1, af1);
      pa.step();
    }
    wgmma_wait_all();
    fence_regs(acc0);
    fence_regs(acc1);
    if constexpr (OUT == kOutPool) {
      store_tile<N>(a, ln, smem, acc0, pe.i < q, soff(), pooled(), shift);
    } else {
      store_plain<N, OUT>(a, ln, smem, acc0, pe.i < q, pe.row, pe.col, b, band, x0, prows, shift);
    }
    pe.step();
    if (two) {
      if constexpr (OUT == kOutPool) {
        store_tile<N>(a, ln, smem, acc1, pe.i < q, soff(), pooled(), shift);
      } else {
        store_plain<N, OUT>(a, ln, smem, acc1, pe.i < q, pe.row, pe.col, b, band, x0, prows,
                            shift);
      }
      pe.step();
    }
  }
}

// ── the kernel ───────────────────────────────────────────────────────

// The region route's layer kernel.
template <int CPC, int N, int OUT>
__global__ void __launch_bounds__(Cfg<N>::kThreads, Cfg<N>::kMinBlocks)
    conv_layer_kernel(const __grid_constant__ LayerArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Geometry& g = a.g;
  constexpr int kThreads = Cfg<N>::kThreads;
  const int tid = threadIdx.x;
  // zeros under the staging: halos, padding channels, the recast's fourth
  // byte; then the bias, and the weights once for the CTA's whole walk
  for (int i = tid; i < (g.smem - g.off_raw) / 16; i += kThreads) {
    reinterpret_cast<uint4*>(smem + g.off_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  int32_t* bias_s = reinterpret_cast<int32_t*>(smem + g.off_bias);
  for (int i = tid; i < N; i += kThreads) bias_s[i] = i < g.oc ? __ldg(a.bias + i) : 0;
  for (int i = tid; i < g.w_bytes / 16; i += kThreads) cp_async16(smem + 16 * i, a.w + 16 * i, true);
  const int shift = min(max(__ldg(a.shifts + a.layer), 0), 31);
  Lane<N> ln;
  ln.lane = tid & 31;
  ln.w = (tid >> 5) & 3;
  ln.gq = ln.lane >> 2;
  ln.t = ln.lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the recast's K bytes k0.. of a row: taps k0 / 3, + 1
    const int k0 = 16 * h + 4 * ln.t, tap = k0 / 3, off = k0 - 3 * tap;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int tt = min(tap + e, 8), ky = tt / 3;
      ln.rc_off[h][e] = 4 * (ky * g.cols + tt - 3 * ky);
    }
    ln.rc_sel[h] = off == 0 ? 0x4210 : off == 1 ? 0x5421 : 0x6542;
  }
  if constexpr (N <= 32) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * ln.t + e;
        ln.bias[2 * j + e] = c < g.oc ? __ldg(a.bias + c) : 0;
      }
    }
  }
  __syncthreads();  // the zeros land before any copy into the staging
  long long u = blockIdx.x;
  if (u < g.units) load_item<CPC>(a, smem, u, 0, tid, kThreads);
  cp_async_commit();
  // the warpgroup, uniform to the compiler too (a wgmma in a path it takes
  // for divergent is serialised)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  for (int buf = 0; u < g.units; u += gridDim.x, buf ^= 1) {
    if (u + gridDim.x < g.units) load_item<CPC>(a, smem, u + gridDim.x, buf ^ 1, tid, kThreads);
    cp_async_commit();
    cp_async_wait_prior();  // this item's copies (and the weights) have landed
    if (tid == 0 && g.out_bytes) bulk_wait_read();  // the last item's output has left
    __syncthreads();
    int b, band, seg, prows, sw, x0, q;
    unit_item(g, u, b, band, seg);
    item_shape(g, band, seg, prows, sw, x0, q);
    const uint8_t* st = smem + g.off_stage + (g.stages == 2 ? buf * g.stage_bytes : 0);
    if (g.load == kLoadPlanes) {
      planes_to_stage(g, smem, buf, 2 * prows + 2, tid, kThreads);
      __syncthreads();
    }
    if constexpr (OUT != kOutPool) {
      int per_row;
      item_positions(g, prows, sw, per_row, q);
    }
    run_item<CPC, N, OUT>(a, smem, st, ln, wg, b, band, x0, sw, q, shift, prows);
    fence_proxy_async();  // this thread's output stores, before the bulk copy reads them
    __syncthreads();      // every warpgroup is done with this buffer and its output
    if (tid == 0 && g.out_bytes) {
      // the item's pooled rows: one run where the segment is the whole width
      const int orow = sw / 2 * g.oc;
      uint8_t* dst = a.out + ((static_cast<long long>(b) * g.oh + band * g.band) * g.ow + x0 / 2) * g.oc;
      const uint8_t* src = smem + g.off_out;
      if (g.segs == 1) {
        bulk_store(dst, src, prows * orow);
      } else {
        for (int r = 0; r < prows; ++r) bulk_store(dst + static_cast<long long>(r) * g.ow * g.oc, src + r * orow, orow);
      }
      bulk_commit();
    }
  }
  if (tid == 0 && g.out_bytes) bulk_wait();
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum LayerPath {
  kPathPlanes, kPathNhwc16, kPathBytes, kPathRecast3, kPathRecastSmall, kPathTaps16,
  kPathTaps32, kPathTaps64, kPathTaps128, kPathN16, kPathN32, kPathN64, kPathN128,
  kPathStoreBulk, kPathStore16, kPathStore2, kPathStore1, kPathTwoCtas, kPathSegments, kPathSecondItem,
  kPathPartialBand, kPathPartialTile, kPathOutPlain, kPathOutStride2, kPathResidual, kLayerPaths
};
constexpr const char* kLayerPathNames[kLayerPaths] = {
    "staging: three NCHW planes by cp.async, interleaved to a word a pixel",
    "staging: a channels-last map by 16-byte cp.async",
    "staging: byte by byte (another layout, channel count or alignment)",
    "A: 3 channels recast, 27 of 32 K bytes in one k32 step",
    "A: 1-2 channels recast, one k32 step",
    "A: ldmatrix from 16-byte staged pixels", "A: ldmatrix from 32-byte staged pixels",
    "A: ldmatrix from 64-byte staged pixels", "A: ldmatrix from 128-byte staged pixels",
    "wgmma m64n16k32", "wgmma m64n32k32", "wgmma m64n64k32", "wgmma m64n128k32",
    "stores: a band's rows by bulk copy from shared memory (N 16, 32)",
    "stores: 16 bytes a lane (N 64, 128)", "stores: 2 bytes (oc not a multiple of 16)",
    "stores: bytes (odd oc)", "persistent: CTAs sharing an SM", "a band in column segments",
    "persistent: a CTA's second item", "a partial band (the last pooled rows)",
    "a partial tile (an item's last)", "output: the unpooled map, 2 bytes a lane",
    "output: the stride-2 conv's map, 2 bytes a lane", "a residual added after the clip"};
PathCounts<kLayerPaths> g_layer_paths(kLayerPathNames);

using LayerKernel = void (*)(LayerArgs);

struct Variant {
  LayerKernel fn;
  int threads, index;
};

template <int CPC, int N, int OUT = kOutPool>
Variant variant(int index) {
  return {conv_layer_kernel<CPC, N, OUT>, Cfg<N>::kThreads, index};
}

template <int CPC>
Variant pick_n(int n, int c) {
  switch (n) {
    case 16: return variant<CPC, 16>(4 * c);
    case 32: return variant<CPC, 32>(4 * c + 1);
    case 64: return variant<CPC, 64>(4 * c + 2);
    default: return variant<CPC, 128>(4 * c + 3);
  }
}

// The unpooled and stride-2 modes' variants: N 32, 64 and 128 (oc > 16).
template <int CPC, int OUT>
Variant pick_out(int n, int c) {
  const int index = 20 + 15 * (OUT - 1) + 3 * c;
  switch (n) {
    case 32: return variant<CPC, 32, OUT>(index);
    case 64: return variant<CPC, 64, OUT>(index + 1);
    default: return variant<CPC, 128, OUT>(index + 2);
  }
}

Variant pick(const Geometry& g) {
  if (g.out_mode == kOutPlain) {
    if (g.mode == kRecast) return pick_out<0, kOutPlain>(g.n, 0);
    switch (g.cp) {
      case 16: return pick_out<1, kOutPlain>(g.n, 1);
      case 32: return pick_out<2, kOutPlain>(g.n, 2);
      case 64: return pick_out<4, kOutPlain>(g.n, 3);
      default: return pick_out<8, kOutPlain>(g.n, 4);
    }
  }
  if (g.out_mode == kOutStride2) {  // never the recast (make_geometry_ex)
    switch (g.cp) {
      case 16: return pick_out<1, kOutStride2>(g.n, 1);
      case 32: return pick_out<2, kOutStride2>(g.n, 2);
      case 64: return pick_out<4, kOutStride2>(g.n, 3);
      default: return pick_out<8, kOutStride2>(g.n, 4);
    }
  }
  if (g.mode == kRecast) return pick_n<0>(g.n, 0);
  switch (g.cp) {
    case 16: return pick_n<1>(g.n, 1);
    case 32: return pick_n<2>(g.n, 2);
    case 64: return pick_n<4>(g.n, 3);
    default: return pick_n<8>(g.n, 4);
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_resident_mutex;
// (device, variant, shared memory) -> (CTAs an SM, SMs)
std::map<std::tuple<int, int, int>, std::pair<int, int>> g_resident;

// How many CTAs of `v` with `smem` bytes an SM holds at once, and the SMs.
cudaError_t resident_ctas(const Variant& v, int smem, int device, int* per_sm, int* sms) {
  std::lock_guard<std::mutex> lock(g_resident_mutex);
  const auto key = std::make_tuple(device, v.index, smem);
  auto it = g_resident.find(key);
  if (it == g_resident.end()) {
    cudaError_t err = cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           kSmemMax);
    int n = 0, s = 0;
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, v.fn, v.threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (n < 1) return cudaErrorInvalidConfiguration;
    it = g_resident.emplace(key, std::make_pair(n, s)).first;
  }
  *per_sm = it->second.first;
  *sms = it->second.second;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* region_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int region_layer_paths(const char** names, unsigned long long* hits, int n) {
  return g_layer_paths.read(names, hits, n);
}

// Launches one layer on `stream` of CUDA device `device`: x (B, ic, H, W)
// u8 with byte strides (sb, sc, sy, sx), `layout` 0 NCHW contiguous, 1
// channels-last contiguous, 2 neither; w pack_layer's bytes (16-byte
// aligned), bias (oc,) s32, shifts a device s32 vector read at `layer`.
// `out_mode` 0 (a chain's: the 2x2/2 pool, out (B, H/2, W/2, oc)), 1 (the
// unpooled map: out (B, H, W, oc)) or 2 (the stride-2 conv: out (B, H/2,
// W/2, oc)); `res` (the unpooled modes, null for none) a channels-last map
// of out's shape, added to the clipped bytes (saturating at 255). Takes ic
// 1-127, oc 1-128, H and W even (region_layer_plan.h); the unpooled modes
// oc 18-128, even, and the stride-2 one ic 4 or more. Returns a
// cudaError_t: cudaSuccess, cudaErrorInvalidValue for a geometry or a
// pointer the kernel does not take, or the launch error. Neither
// synchronises nor allocates.
extern "C" int region_layer_forward(const void* x, int layout, const void* w, const void* bias,
                                    const void* shifts, int layer, void* out, int batch, int ic,
                                    int oc, int height, int width, long long sb, long long sc,
                                    long long sy, long long sx, int out_mode, const void* res,
                                    int device, void* stream) {
  LayerArgs a;
  Geometry& g = a.g;
  const int aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  if (layer < 0 || device < 0 || device >= kMaxDevices ||
      make_geometry_ex(batch, ic, oc, height, width, layout, aligned, out_mode, &g) != 0 ||
      (reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (res != nullptr && (out_mode == kOutPool || (reinterpret_cast<uintptr_t>(res) & 1) != 0))) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Variant v = pick(g);
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const int32_t*>(bias);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.out = static_cast<uint8_t*>(out);
  a.sb = sb;
  a.sc = sc;
  a.sy = sy;
  a.sx = sx;
  a.layer = layer;
  a.res = static_cast<const uint8_t*>(res);
  int per_sm, sms;
  err = resident_ctas(v, g.smem, device, &per_sm, &sms);
  if (err != cudaSuccess) return err;
  const long long launched = std::min<long long>(g.units, static_cast<long long>(per_sm) * sms);
  v.fn<<<static_cast<unsigned>(launched), v.threads, g.smem, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_layer_paths.add(g.load == kLoadPlanes ? kPathPlanes
                      : g.load == kLoadNhwc16 ? kPathNhwc16 : kPathBytes);
    g_layer_paths.add(g.mode == kRecast ? (ic == 3 ? kPathRecast3 : kPathRecastSmall)
                      : g.cp == 16 ? kPathTaps16 : g.cp == 32 ? kPathTaps32
                      : g.cp == 64 ? kPathTaps64 : kPathTaps128);
    g_layer_paths.add(g.n == 16 ? kPathN16 : g.n == 32 ? kPathN32 : g.n == 64 ? kPathN64 : kPathN128);
    if (out_mode == kOutPool) {
      g_layer_paths.add(g.out_bytes ? kPathStoreBulk : oc % 16 == 0 ? kPathStore16
                        : oc % 2 == 0 ? kPathStore2 : kPathStore1);
    }
    if (per_sm >= 2) g_layer_paths.add(kPathTwoCtas);
    if (g.segs > 1) g_layer_paths.add(kPathSegments);
    if (g.units > launched) g_layer_paths.add(kPathSecondItem);
    if (out_mode == kOutPlain) g_layer_paths.add(kPathOutPlain);
    if (out_mode == kOutStride2) g_layer_paths.add(kPathOutStride2);
    if (res != nullptr) g_layer_paths.add(kPathResidual);
    const int last_band = g.oh - (g.bands - 1) * g.band, last_seg = width - (g.segs - 1) * g.seg_w;
    if (last_band != g.band) g_layer_paths.add(kPathPartialBand);
    if ((g.band * g.seg_w) % kTileQ != 0 || (last_band * g.seg_w) % kTileQ != 0 ||
        (g.band * last_seg) % kTileQ != 0 || (last_band * last_seg) % kTileQ != 0) {
      g_layer_paths.add(kPathPartialTile);
    }
  }
  return err;
}
