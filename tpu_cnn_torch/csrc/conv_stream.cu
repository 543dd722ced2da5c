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
// A darknet graph's convs (YOLOv3's of 128 input channels and more) add, as
// compile-time instantiations of the no-pool mode (Feature): stride 2 (the
// TMA im2col walks the map every 2 pixels), a residual map added after the
// clip (the shortcut), the 2x upsample (each pixel to its 2x2 block), and
// maps inside wider ones (a route's channels: the im2col map's pixel
// stride, the output's pitch). A chain's layers take none of them.
//
// An implicit GEMM: M = output pixels (pre-pool), N = output channels, K =
// k*k taps x ic channels in slices of 128 bytes (one tap, 128 channels: ic
// a multiple of 128). The tile shapes, the schedule and which pixel each M
// row is live in conv_stream_plan.h.
//
// What bounds it on an H100: operations. L4-L8 are 2.82 G MACs a frame
// (L6-L7 2.39 G) against 16 MB of weights and ~0.8 MB of maps in and out,
// 1.455 ms a round of 512 at 989.5 T MAC/s. What stands between a kernel
// and that bound is feeding the tensor cores. A slice of a 192 x 128 tile
// is ~420 ns of MMAs and reads 40 KB from L2: 12.9 KB per M MAC, ~12.8
// TB/s at the full rate, more than the L2 gives. On the card the L2 did
// not bind this design: sharing each weight slice between two CTAs by
// multicast (7.6 KB per M MAC) made it slower. What binds next is shared
// memory: per slice of a 128 x 256 tile the two consumer warpgroups' MMAs
// read 80 KB and the copies write 48 KB, about the 128 bytes a clock an SM
// has over the slice's 1024 clocks of MMAs. The design:
//
// - Warp specialisation. A producer warpgroup (its registers cut with
//   setmaxnreg) keeps a ring of stages full; the consumer warpgroups wait
//   on a stage's full mbarrier, issue wgmma m64nNk32 with A and B from
//   shared memory, and free the stage on its empty mbarrier once the MMAs
//   that read it are done. Nothing in the K loop waits on a block-wide
//   barrier; a slice's MMAs queue behind the previous slice's.
// - TMA for both operands, in the 128-byte swizzle (wgmma's SW128 K-major
//   layout: a 128-byte row per M row or output channel, its 16-byte chunk
//   j at j ^ (row % 8)). B is ops/conv_stream.py's pack_stream, already
//   swizzled, one bulk copy a slice. A from a channels-last map is a TMA
//   im2col load of 64 pixels x 128 channels per consumer warpgroup: it
//   walks the batch's pixels in order, across rows and images, and fills
//   the SAME padding with zeros. A from an NCHW map (L4: the layer kernel
//   writes L3 so) or for the 2x2/2 pool, whose rows are pooling windows,
//   is gathered by the producer warpgroup: it stages a tile's source rows
//   of 128 channels once (4-byte loads from NCHW, transposed to
//   pixel-major; 16-byte loads from channels-last) and builds each tap's
//   swizzled A from them in shared memory. That gather, not the MMAs,
//   paces L4.
// - Larger tiles: 128 x 256 with two consumer warpgroups (m64n256k32),
//   11.4 KB of L2 reads per M MAC; 128 x 128 on the linear layer (oc 125);
//   for the 2x2/1 pool one whole image a tile (192 x 128, three consumer
//   warpgroups of m64n128k32), pooled in shared memory; the 2x2/2 pool
//   keeps a window's four rows in one warp's lanes and pools across them
//   with shuffles.
// - A persistent grid: a CTA an SM walks the tiles N fastest, so an M
//   tile's A is read from L2 by all its N tiles at about the same time and
//   all of a layer's weights (<= 9.44 MB) stay in L2. The producer runs
//   into the next tile while the consumers store this one's outputs.
// - A shortcut's residual (kFeatResidual) comes by TMA as well: a 2-D
//   tiled map over (channels, pixels), a tile's 128 x 256 bytes as two
//   boxes of 128 channels x 128 rows in the 128-byte swizzle, loaded once
//   a tile by the producer after the tile's slice kStages, under the MMAs,
//   into a 32 KB buffer of its own with a full/empty mbarrier pair (230,480
//   bytes of shared memory in all). After their MMAs the consumers read
//   all of a lane's 64 bytes of it (a warp's 8 rows x 8 bytes on 16
//   banks), then add it a column pair at a time, the pair's bias loaded
//   once for both of the lane's rows, the stores predicated. Read instead
//   as 2-byte global loads among the epilogue's stores, each column pair
//   behind a branch with its own bias loads, the residual took the 128 ->
//   256 3x3 conv at 52x52 on an H100 from ~1.07 ms a round of 512 (the
//   same conv without one) to ~1.65 ms.

#include <algorithm>
#include <cstdint>
#include <mutex>

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_runtime.h>

#include "conv_stream_plan.h"
#include "hopper.cuh"
#include "path_counts.cuh"

namespace {

using namespace stream_plan;

constexpr int kGroup = 128;  // threads of a warpgroup
enum Source { kATma, kANchw, kANhwc };  // where a tile's A comes from
// named barriers; kResidualBar + cw: consumer warpgroup cw's own
constexpr int kConsumerBar = 1, kProducerBar = 2, kResidualBar = 3;

template <int MODE>
struct Tile {
  static constexpr int kConsumers = consumers(MODE);
  static constexpr int kThreads = kGroup * (kConsumers + 1);
  static constexpr int kM = tile_m(MODE), kN = tile_n(MODE);
  static constexpr int kABytes = kM * kSliceK, kBBytes = kN * kSliceK;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // stages of the ring: as many as shared memory holds
  static constexpr int kStages = MODE == kLinear ? 6 : 4;
  static constexpr int kEpilogue = kStages * kStageBytes;  // the 2x2/1 pool's bytes
  static constexpr int kTileRow = kN + 4;  // the 2x2/1 pool's rows, a bank apart
  static constexpr int kStaging = kEpilogue + (MODE == kPool1 ? kM * kTileRow : 0);
  // a residual tile (kFeatResidual, A by TMA): kN / kResBoxC boxes of kM
  // rows of 128 bytes, in the 128-byte swizzle, at kStaging
  static constexpr int kResBox = kM * kResBoxC;
  static constexpr __host__ __device__ int barriers(bool gather, bool res = false) {
    return kStaging + (gather ? staging_pixels(MODE) * kSliceK : 0) + (res ? kM * kN : 0);
  }
  // the ring's full and empty mbarriers, then the residual's pair
  static constexpr __host__ __device__ int smem(bool gather, bool res = false) {
    return 1024 + barriers(gather, res) + 2 * kStages * 8 + (res ? 2 * 8 : 0);
  }
};
static_assert(Tile<kPlain>::smem(true) <= 232448, "the wide tile's plan");
static_assert(Tile<kPlain>::smem(false, true) <= 232448, "the wide tile's plan with a residual");
static_assert(Tile<kPool1>::smem(true) <= 232448, "the 2x2/1 pool's plan");
static_assert(Tile<kLinear>::smem(true) <= 232448, "the linear layer's plan");

struct alignas(64) StreamArgs {
  CUtensorMap tmap;  // A's im2col map (kATma)
  const uint8_t* x;
  const int8_t* w;        // pack_stream: (slices, np, 128) bytes, swizzled
  const int32_t* bias;    // (oc,)
  const int32_t* shifts;  // read at `layer`
  void* out;
  int layer;
  Geometry g;
  CUtensorMap rmap;  // the residual's tiled map (kFeatResidual; residual_map)
};

// A layer graph's epilogue and producer additions (conv_stream_forward_ex),
// compile-time bits of the no-pool mode's instantiations; 0 is a chain's
// layer, as yolov2-tiny-voc's: a stride of 1, its outputs at its own pitch.
// kFeatPitch: the stride-1 conv's output inside a wider map, alone (YOLOv7's
// convs writing a concatenation in place); the others store at out_pitch too
enum Feature { kFeatStride2 = 1, kFeatResidual = 2, kFeatUpsample = 4, kFeatPitch = 8 };

// ── Hopper primitives this kernel alone uses ─────────────────────────

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

template <int REGS>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(REGS));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}

// Raises the bytes the phase waits for, without an arrival.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(map) : "memory");
}

// A box of the im2col map: 64 pixels from (x, y, b) on, 128 channels from
// c, each read at (y + dy, x + dx); zeros outside the map.
__device__ __forceinline__ void tma_im2col(void* dst, const CUtensorMap* map, uint64_t* bar,
                                          int c, int x, int y, int b, uint16_t dx,
                                          uint16_t dy) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2], {%7, %8};\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c), "r"(x), "r"(y), "r"(b),
         "h"(dx), "h"(dy)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 1024 bytes between groups of 8 rows; a K step of 32 bytes moves
// the start address within the swizzled row.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w) : "memory");
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// A box of a 2-D tiled map: from channel c, row `row`; zeros past the map.
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map, uint64_t* bar, int c,
                                         int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c), "r"(row)
      : "memory");
}

// d += A (64 x 32 u8) x B (32 x N s8), both from shared memory.
template <int N>
struct Mma;

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
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
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(int (&d)[128], uint64_t da, uint64_t db) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.u8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "%128, %129, p;\n"
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
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
  }
};

__device__ __forceinline__ int clip_shift(int v, int shift) {
  return min(max(v >> shift, 0), 255);  // >> on int is arithmetic (floor)
}

// ── the producer ─────────────────────────────────────────────────────

// Slice `ks` of N tile `nt`'s weights: one bulk copy of pack_stream's rows.
template <int MODE>
__device__ __forceinline__ void load_b(const StreamArgs& a, uint8_t* sb, int ks, int nt,
                                       uint64_t* bar) {
  using T = Tile<MODE>;
  const int8_t* src =
      a.w + (static_cast<size_t>(ks) * a.g.np + static_cast<size_t>(nt) * T::kN) * kSliceK;
  bulk_load(sb, src, T::kBBytes, bar);
}

// Pixels p0 .. p0 + 3 of a run of `len` bytes of one channel plane at
// `p` (= run + p0), zeros outside it: one 4-byte load where the quad lies
// inside the run and is aligned, else bytes. (Plain loads: through the
// read-only path, __ldg, the staging measured ~1.5x slower on the card.)
__device__ __forceinline__ uint32_t load_quad(const uint8_t* p, int p0, int len) {
  if (p0 >= 0 && p0 + 4 <= len && (reinterpret_cast<uintptr_t>(p) & 3) == 0) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (p0 + i >= 0 && p0 + i < len) v |= static_cast<uint32_t>(p[i]) << (8 * i);
  }
  return v;
}

// Where a staged pixel's 16-byte chunk j lies in its 128-byte row: swizzled
// by the pixel so that neither the quads of a row written by a warp nor
// the pixels of a tile's rows read by one fall in the same banks.
__device__ __forceinline__ int staged_chunk(int pix, int j) {
  return j ^ ((pix ^ (pix >> 2)) & 7);
}

// Source rows lo..hi (b * H + y) of channels 128 ch .. + 127 into the
// staging, pixel-major: pixel (L - lo) * W + x a 128-byte row of chunks
// (staged_chunk). From NCHW: 4-byte words of four pixels of four
// channels, transposed by byte permutes; from channels-last: 16-byte
// loads.
template <int SRC>
__device__ __forceinline__ void stage_rows(const StreamArgs& a, uint32_t stg, int lo, int hi,
                                           int ch, int t) {
  const Geometry& g = a.g;
  const int W = g.width, H = g.height, rows = hi - lo + 1;
  if (rows <= 0) return;
  if constexpr (SRC == kANchw) {
    // The rows of one image are one run of bytes in each channel plane, so
    // a tile's rows are at most two runs (the tile may cross an image).
    // Items: a quad of four pixels of a run x a group of four channels,
    // the quads aligned to 4 bytes where the planes are; a warp takes 8
    // quads x 4 groups (its loads: 32 bytes of each of 4 planes; its
    // stores: distinct banks).
    constexpr int kBatch = 4;  // items a thread keeps in flight
    const size_t plane = static_cast<size_t>(H) * W;
    for (int L0 = lo; L0 <= hi;) {
      const int b = L0 / H, y0 = L0 - b * H, L1 = min(hi, (b + 1) * H - 1);
      const int len = (L1 - L0 + 1) * W, pix0 = (L0 - lo) * W;
      const uint8_t* run =
          a.x + (static_cast<size_t>(b) * g.ic + ch * kSliceK) * plane + static_cast<size_t>(y0) * W;
      const int head = (plane & 3) == 0 ? static_cast<int>(reinterpret_cast<uintptr_t>(run) & 3) : 0;
      const int quads = (len + head + 3) >> 2;
      const int items = (quads + 7) / 8 * 8 * 32;
      for (int it0 = t; it0 < items; it0 += kBatch * kGroup) {
        uint32_t w[kBatch][4] = {};
        int p0[kBatch], cg[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int it = it0 + u * kGroup, rest = it >> 5;
          const int q = (rest >> 3) * 8 + (it & 7);
          cg[u] = (rest & 7) * 4 + ((it >> 3) & 3);
          p0[u] = 4 * q - head;
          if (q < quads) {
            const uint8_t* p = run + static_cast<size_t>(4 * cg[u]) * plane + p0[u];
#pragma unroll
            for (int c = 0; c < 4; ++c) w[u][c] = load_quad(p + c * plane, p0[u], len);
          } else {
            p0[u] = len;  // nothing to store
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const uint32_t lo01 = __byte_perm(w[u][0], w[u][1], 0x5140);
          const uint32_t hi01 = __byte_perm(w[u][0], w[u][1], 0x7362);
          const uint32_t lo23 = __byte_perm(w[u][2], w[u][3], 0x5140);
          const uint32_t hi23 = __byte_perm(w[u][2], w[u][3], 0x7362);
          const uint32_t px[4] = {__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                                  __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632)};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (p0[u] + i >= 0 && p0[u] + i < len) {
              const int pix = pix0 + p0[u] + i;
              sts32(stg + pix * kSliceK + (staged_chunk(pix, cg[u] >> 2) << 4) + ((cg[u] & 3) << 2),
                    px[i]);
            }
          }
        }
      }
      L0 = L1 + 1;
    }
  } else {
    const int items = rows * W * 8;
    for (int it = t; it < items; it += kGroup) {
      const int j = it & 7, pix = it >> 3;
      const uint8_t* p = a.x + (static_cast<size_t>(lo) * W + pix) * g.ic + ch * kSliceK + 16 * j;
      sts128(stg + pix * kSliceK + (staged_chunk(pix, j) << 4),
             __ldg(reinterpret_cast<const uint4*>(p)));
    }
  }
}

template <int MODE, int SRC, int FEAT>
__device__ __forceinline__ void produce(const StreamArgs& a, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty) {
  using T = Tile<MODE>;
  const Geometry& g = a.g;
  const int t = threadIdx.x;
  uint32_t cnt = 0;  // slices this CTA has loaded
  auto acquire = [&](uint32_t c) {
    mbar_wait(&empty[c % T::kStages], ((c / T::kStages) & 1) ^ 1);
  };
  if constexpr (SRC == kATma) {
    if (t != 0) return;
    prefetch_tensormap(&a.tmap);
    if constexpr ((FEAT & kFeatResidual) != 0) prefetch_tensormap(&a.rmap);
    [[maybe_unused]] uint32_t tiles = 0;  // tiles this CTA has loaded
    for (long long u = blockIdx.x; u < g.units; u += gridDim.x, ++tiles) {
      long long mt;
      int nt;
      unit_tile(g, u, mt, nt);
      int sb[T::kConsumers], sy[T::kConsumers], sx[T::kConsumers];
#pragma unroll
      for (int j = 0; j < T::kConsumers; ++j) {
        if constexpr ((FEAT & kFeatStride2) != 0) {
          slab_start_out(g, mt, j, sb[j], sy[j], sx[j]);
          sy[j] *= 2;
          sx[j] *= 2;
        } else {
          slab_start(g, mt, j, sb[j], sy[j], sx[j]);
        }
      }
      for (int ks = 0; ks < g.slices; ++ks, ++cnt) {
        const int s = cnt % T::kStages;
        acquire(cnt);
        uint8_t* sa = smem + s * T::kStageBytes;
        mbar_expect_tx(&full[s], T::kABytes + T::kBBytes);
        const int tap = ks / g.chunks, c0 = (ks - tap * g.chunks) * kSliceK;
        const uint16_t dx = static_cast<uint16_t>(tap % g.k), dy = static_cast<uint16_t>(tap / g.k);
#pragma unroll
        for (int j = 0; j < T::kConsumers; ++j) {
          tma_im2col(sa + j * kSlab * kSliceK, &a.tmap, &full[s], c0, sx[j] - g.pad,
                     sy[j] - g.pad, sb[j], dx, dy);
        }
        load_b<MODE>(a, sa + T::kABytes, ks, nt, &full[s]);
        if constexpr ((FEAT & kFeatResidual) != 0) {
          // The tile's residual, once, under its MMAs. Slice kStages was
          // free only once both consumers had released slice 0, so they
          // are past the previous tile's epilogue and res_empty is free.
          if (ks == min(T::kStages, g.slices - 1)) {
            uint64_t* res_full = empty + T::kStages;
            mbar_wait(res_full + 1, (tiles & 1) ^ 1);
            const int boxes = residual_boxes(g, nt);
            mbar_expect_tx(res_full, boxes * T::kResBox);
            for (int i = 0; i < boxes; ++i) {
              int c, row;
              residual_box(g, mt, nt, i, c, row);
              tma_tile(smem + T::kStaging + i * T::kResBox, &a.rmap, res_full, c, row);
            }
          }
        }
      }
    }
  } else {
    constexpr int kRows = (T::kM + kGroup - 1) / kGroup;  // M rows a producer thread builds
    const uint32_t stg = smem_u32(smem + T::kStaging);
    const int W = g.width, H = g.height;
    for (long long u = blockIdx.x; u < g.units; u += gridDim.x) {
      long long mt;
      int nt;
      unit_tile(g, u, mt, nt);
      int rb[kRows], ry[kRows], rx[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        rb[i] = -1;
        if (t + kGroup * i < T::kM) row_pixel(g, mt, t + kGroup * i, rb[i], ry[i], rx[i]);
      }
      int lo, hi;
      tile_source_rows(g, mt, lo, hi);
      for (int ch = 0; ch < g.chunks; ++ch) {
        named_sync(kProducerBar, kGroup);  // every thread is done with the staging
        stage_rows<SRC>(a, stg, lo, hi, ch, t);
        named_sync(kProducerBar, kGroup);
        for (int tap = 0; tap < g.taps; ++tap, ++cnt) {
          const int s = cnt % T::kStages;
          acquire(cnt);
          uint8_t* sa = smem + s * T::kStageBytes;
          if (t == 0) {
            mbar_expect(&full[s], T::kBBytes);
            load_b<MODE>(a, sa + T::kABytes, tap * g.chunks + ch, nt, &full[s]);
          }
          const int dy = tap / g.k - g.pad, dx = tap % g.k - g.pad;
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const int r = t + kGroup * i;
            if (r >= T::kM) break;
            const int yy = ry[i] + dy, xx = rx[i] + dx;
            const bool in = rb[i] >= 0 && static_cast<unsigned>(yy) < static_cast<unsigned>(H) &&
                            static_cast<unsigned>(xx) < static_cast<unsigned>(W);
            const int pix = in ? (rb[i] * H + yy - lo) * W + xx : 0;
            const uint32_t dst = smem_u32(sa) + r * kSliceK;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const uint4 v = in ? lds128(stg + pix * kSliceK + (staged_chunk(pix, j) << 4))
                                 : make_uint4(0u, 0u, 0u, 0u);
              sts128(dst + ((j ^ (r & 7)) << 4), v);
            }
          }
          fence_proxy_async();  // A's stores, before the tensor cores read them
          mbar_arrive(&full[s]);
        }
      }
    }
  }
}

// ── the consumers ────────────────────────────────────────────────────

template <int MODE, int FEAT>
__device__ __forceinline__ void epilogue(const StreamArgs& a, int (&acc)[Tile<MODE>::kN / 2],
                                         long long mt, int nt, int cw, uint8_t* smem) {
  using T = Tile<MODE>;
  constexpr int kJ = T::kN / 8;  // wgmma N groups of 8 columns
  const Geometry& g = a.g;
  const int tid = threadIdx.x, lane = tid & 31, grp = lane >> 2, t4 = lane & 3;
  // acc[4j + e]: row 16 (warp % 4) + grp (+ 8 for e >= 2) of this warpgroup's
  // slab, column 8j + 2 t4 + (e & 1) of the tile
  const int rbase = cw * kSlab + 16 * ((tid >> 5) & 3) + grp;
  const int shift = min(max(__ldg(a.shifts + a.layer), 0), 31);
  const int n0 = nt * T::kN;
  auto bias = [&](int j, int e) {
    const int n = n0 + 8 * j + 2 * t4 + e;
    return n < g.oc ? __ldg(a.bias + n) : 0;
  };
  const long long row0 = mt * T::kM;

  if (MODE == kLinear) {
    int32_t* out = static_cast<int32_t*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      if (row >= g.m_rows) continue;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + 8 * j + 2 * t4 + e;
          if (n < g.oc) out[row * g.oc + n] = acc[4 * j + 2 * h + e] + bias(j, e);
        }
      }
    }
  } else if (MODE == kPlain && (FEAT & kFeatResidual) != 0) {
    // a layer graph's shortcut conv: out_pitch bytes a pixel, the staged
    // residual added after the clip (saturating). Its 64 bytes a lane come
    // from shared memory first: row rbase + 8h of the tile (its index mod
    // 8 is grp), box j / 16, 16-byte chunk (j / 2) % 8 at ((j / 2) % 8) ^
    // grp, byte 8 (j % 2) + 2 t4. Then a column pair's bias is loaded once
    // for both rows, and the stores are predicated: on an H100 a branch a
    // pair, each pair's bias loads waited in turn, held the 128 -> 256 3x3
    // at 52x52 at ~1.55 ms a round of 512 against ~1.05 so.
    uint8_t* out = static_cast<uint8_t*>(a.out);
    uint32_t rv[2][kJ];  // the residual of rows rbase + 8h, columns 8j + 2 t4, + 1
    uint8_t* o[2];
    bool store[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      store[h] = row < g.m_rows;
      o[h] = out + row * g.out_pitch + n0 + 2 * t4;
      const uint32_t line = smem_u32(smem + T::kStaging) + (rbase + 8 * h) * kResBoxC +
                            (grp << 4) + 2 * t4;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        rv[h][j] = lds16((line ^ (((j >> 1) & 7) << 4)) + (j >> 4) * T::kResBox + 8 * (j & 1));
      }
    }
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const int b0 = bias(j, 0), b1 = bias(j, 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p0 = min(clip_shift(acc[4 * j + 2 * h] + b0, shift) +
                           static_cast<int>(rv[h][j] & 0xFFu), 255);
        const int p1 = min(clip_shift(acc[4 * j + 2 * h + 1] + b1, shift) +
                           static_cast<int>(rv[h][j] >> 8), 255);
        if (store[h] && n0 + 8 * j + 2 * t4 + 1 < g.oc) {
          *reinterpret_cast<uint16_t*>(o[h] + 8 * j) = static_cast<uint16_t>(p0 | (p1 << 8));
        }
      }
    }
  } else if (MODE == kPlain && FEAT != 0) {
    // a layer graph's: out_pitch bytes a pixel, or each pixel to its 2x2
    // block of a map of twice the side
    uint8_t* out = static_cast<uint8_t*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      if (row >= g.m_rows) continue;
      long long at = row;  // the output pixel (the upsampled block's top left)
      if constexpr ((FEAT & kFeatUpsample) != 0) {
        const int hw = g.out_h * g.out_w;
        const long long b = row / hw;
        const int p = static_cast<int>(row - b * hw), y = p / g.out_w, x = p - y * g.out_w;
        at = (b * 2 * g.out_h + 2 * y) * 2 * g.out_w + 2 * x;
      }
      uint8_t* o = out + at * g.out_pitch + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        if (n0 + 8 * j + 2 * t4 + 1 >= g.oc) continue;
        const int p0 = clip_shift(acc[4 * j + 2 * h] + bias(j, 0), shift);
        const int p1 = clip_shift(acc[4 * j + 2 * h + 1] + bias(j, 1), shift);
        const uint16_t v = static_cast<uint16_t>(p0 | (p1 << 8));
        *reinterpret_cast<uint16_t*>(o + 8 * j) = v;
        if constexpr ((FEAT & kFeatUpsample) != 0) {
          const long long right = g.out_pitch, down = 2LL * g.out_w * g.out_pitch;
          *reinterpret_cast<uint16_t*>(o + 8 * j + right) = v;
          *reinterpret_cast<uint16_t*>(o + 8 * j + down) = v;
          *reinterpret_cast<uint16_t*>(o + 8 * j + down + right) = v;
        }
      }
    }
  } else if (MODE == kPlain || MODE == kPool2) {
    uint8_t* out = static_cast<uint8_t*>(a.out);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + rbase + 8 * h;
      const bool store = row < g.m_rows && (MODE != kPool2 || (grp & 3) == 0);
      uint8_t* o = out + (MODE == kPool2 ? row >> 2 : row) * g.oc + n0 + 2 * t4;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        int p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int s = acc[4 * j + 2 * h + e];
          if (MODE == kPool2) {  // the window: rows grp ^ 1, grp ^ 2, grp ^ 3
            s = max(s, __shfl_xor_sync(0xffffffffu, s, 4));
            s = max(s, __shfl_xor_sync(0xffffffffu, s, 8));
          }
          p[e] = clip_shift(s + bias(j, e), shift);
        }
        if (store && n0 + 8 * j + 2 * t4 + 1 < g.oc) {
          *reinterpret_cast<uint16_t*>(o + 8 * j) = static_cast<uint16_t>(p[0] | (p[1] << 8));
        }
      }
    }
  } else {  // kPool1: the tile is image mt; pool its clipped bytes in shared memory
    constexpr int kThreads = kGroup * T::kConsumers, kRow = T::kTileRow;
    uint8_t* tile = smem + T::kEpilogue;  // (kM, kN) bytes, rows kRow apart
    named_sync(kConsumerBar, kThreads);   // the previous tile's pool has read it
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int v0 = clip_shift(acc[4 * j + 2 * h] + bias(j, 0), shift);
        const int v1 = clip_shift(acc[4 * j + 2 * h + 1] + bias(j, 1), shift);
        *reinterpret_cast<uint16_t*>(tile + r * kRow + 8 * j + 2 * t4) =
            static_cast<uint16_t>(v0 | (v1 << 8));
      }
    }
    named_sync(kConsumerBar, kThreads);
    if (mt >= g.batch) return;
    const int H = g.height, W = g.width, np = H * W;
    uint8_t* out = static_cast<uint8_t*>(a.out) + static_cast<size_t>(mt) * np * g.oc + n0;
    const int cols = min(T::kN, g.oc - n0);
    // four channels a thread, bytewise maxima of words (oc % 4 == 0; else
    // bytes, the words unaligned in the output)
    const int width = (g.oc & 3) == 0 ? 4 : 1;
    const int per_row = T::kN / width;
    for (int i = tid - kGroup; i < np * per_row; i += kThreads) {
      const int p = i / per_row, c = (i - p * per_row) * width;
      if (c >= cols) continue;
      const int py = p / W, px = p - py * W;
      const uint8_t* q = tile + p * kRow + c;
      const int right = px + 1 < W ? 1 : 0, down = py + 1 < H ? W : 0;
      if (width == 4) {
        auto word = [&](int dp) { return *reinterpret_cast<const uint32_t*>(q + dp * kRow); };
        const uint32_t v = __vmaxu4(__vmaxu4(word(0), word(right)),
                                    __vmaxu4(word(down), word(down + right)));
        *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(p) * g.oc + c) = v;
      } else {
        const int v = max(max(q[0], q[right * kRow]),
                          max(q[down * kRow], q[(down + right) * kRow]));
        out[static_cast<size_t>(p) * g.oc + c] = static_cast<uint8_t>(v);
      }
    }
  }
}

template <int MODE, int FEAT>
__device__ __forceinline__ void consume(const StreamArgs& a, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int cw) {
  using T = Tile<MODE>;
  const Geometry& g = a.g;
  const uint32_t s0 = smem_u32(smem);
  const bool elected = (threadIdx.x & (kGroup - 1)) == 0;
  auto release = [&](uint32_t c) {  // the MMAs that read slice c are done
    if (elected) mbar_arrive(&empty[c % T::kStages]);
  };
  int acc[T::kN / 2];
  uint32_t cnt = 0;    // slices this CTA has consumed
  [[maybe_unused]] uint32_t tiles = 0;  // tiles this CTA has stored
  for (long long u = blockIdx.x; u < g.units; u += gridDim.x, ++tiles) {
    long long mt;
    int nt;
    unit_tile(g, u, mt, nt);
#pragma unroll
    for (int i = 0; i < T::kN / 2; ++i) acc[i] = 0;
    for (int ks = 0; ks < g.slices; ++ks, ++cnt) {
      const int s = cnt % T::kStages;
      mbar_wait(&full[s], (cnt / T::kStages) & 1);
      const uint32_t sa = s0 + s * T::kStageBytes + cw * kSlab * kSliceK;
      const uint32_t sb = s0 + s * T::kStageBytes + T::kABytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSliceK / 32; ++kk) {
        Mma<T::kN>::run(acc, desc_sw128(sa + 32 * kk), desc_sw128(sb + 32 * kk));
      }
      wgmma_commit();
      if (ks > 0) {
        wgmma_wait<1>();
        release(cnt - 1);
      }
    }
    wgmma_wait<0>();
    release(cnt - 1);
    fence_regs(acc);
    if constexpr ((FEAT & kFeatResidual) != 0) {
      mbar_wait(empty + T::kStages, tiles & 1);  // res_full: the tile's residual is in
    }
    epilogue<MODE, FEAT>(a, acc, mt, nt, cw, smem);
    if constexpr ((FEAT & kFeatResidual) != 0) {
      named_sync(kResidualBar + cw, kGroup);  // the warpgroup has read it
      if (elected) mbar_arrive(empty + T::kStages + 1);  // res_empty
    }
  }
}

template <int MODE, int SRC, int FEAT>
__global__ void __launch_bounds__(Tile<MODE>::kThreads, 1)
    conv_stream_kernel(const __grid_constant__ StreamArgs a) {
  using T = Tile<MODE>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  constexpr bool kRes = (FEAT & kFeatResidual) != 0;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::barriers(SRC != kATma, kRes));
  uint64_t* empty = full + T::kStages;  // then res_full, res_empty (kRes)
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(&full[s], SRC == kATma ? 1 : kGroup);
      mbar_init(&empty[s], T::kConsumers);
    }
    if constexpr (kRes) {
      mbar_init(empty + T::kStages, 1);
      mbar_init(empty + T::kStages + 1, T::kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();
  // Registers: the producer gives up what the consumers' accumulators take
  // (the launch gives every thread 65536 / threads; ptxas compiled a
  // consumer of 64 x 256 without spills only with the raise).
  constexpr int kLaunchRegs = (65536 / T::kThreads) & ~7;
  constexpr int kProducerRegs = SRC == kATma ? 40 : 104;
  constexpr int kConsumerRegs =
      (kLaunchRegs + (kLaunchRegs - kProducerRegs) / T::kConsumers) & ~7;
  if (threadIdx.x < kGroup) {
    setmaxnreg_dec<kProducerRegs>();
    produce<MODE, SRC, FEAT>(a, smem, full, empty);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<MODE, FEAT>(a, smem, full, empty,
                  static_cast<int>(threadIdx.x / kGroup) - 1);
  }
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum StreamPath {
  kPathTma, kPathNchw, kPathNhwcGather, kPathPlain, kPathPool2, kPathPool1, kPathLinear,
  kPathK1, kPathPartialN, kPathPartialM, kPathAcrossImages, kPathWide, kPathNarrow, kPathImage,
  kPathSecondTile, kPathUnequal, kPathStride2, kPathResidual, kPathUpsample, kPathOutPitch,
  kPathInPitch, kStreamPaths
};
constexpr const char* kStreamPathNames[kStreamPaths] = {
    "A by TMA im2col from a channels-last map",
    "A gathered from an NCHW map by the producer warps",
    "A gathered from a channels-last map by the producer warps",
    "no pool", "pool 2x2 stride 2 across lanes", "pool 2x2 stride 1 in shared memory",
    "linear s32 out", "1x1 kernel", "a partial N tile", "a partial M tile",
    "a TMA im2col load across an image boundary",
    "tile 128x256, two consumer warpgroups of m64n256k32",
    "tile 128x128 (the linear layer), two consumer warpgroups of m64n128k32",
    "tile 192x128 (one image), three consumer warpgroups of m64n128k32",
    "persistent: a CTA's second tile", "persistent: CTAs with unequal work",
    "stride 2: TMA im2col every 2 pixels",
    "a residual staged in shared memory by TMA, added after the clip",
    "upsampled 2x in the epilogue", "the output inside a wider map (a route's slice)",
    "the input inside a wider map (TMA strides)"};
PathCounts<kStreamPaths> g_stream_paths(kStreamPathNames);

using StreamKernel = void (*)(StreamArgs);

struct Variant {
  StreamKernel fn;
  int threads, smem, index;
};

template <int MODE, int SRC, int FEAT = 0>
Variant variant() {
  return {conv_stream_kernel<MODE, SRC, FEAT>, Tile<MODE>::kThreads,
          Tile<MODE>::smem(SRC != kATma, (FEAT & kFeatResidual) != 0),
          FEAT == 0 ? MODE * 3 + SRC : 11 + FEAT};
}

Variant pick(int mode, int src, int feat) {
  if (feat != 0) {  // a layer graph's no-pool layers, A by TMA (make_geometry_ex)
    switch (feat) {
      case kFeatStride2: return variant<kPlain, kATma, kFeatStride2>();
      case kFeatResidual: return variant<kPlain, kATma, kFeatResidual>();
      case kFeatPitch: return variant<kPlain, kATma, kFeatPitch>();
      default: return variant<kPlain, kATma, kFeatUpsample>();
    }
  }
  switch (mode * 3 + src) {
    case kPlain * 3 + kATma: return variant<kPlain, kATma>();
    case kPlain * 3 + kANchw: return variant<kPlain, kANchw>();
    case kPool2 * 3 + kANchw: return variant<kPool2, kANchw>();
    case kPool2 * 3 + kANhwc: return variant<kPool2, kANhwc>();
    case kPool1 * 3 + kATma: return variant<kPool1, kATma>();
    case kPool1 * 3 + kANchw: return variant<kPool1, kANchw>();
    case kLinear * 3 + kATma: return variant<kLinear, kATma>();
    default: return variant<kLinear, kANchw>();
  }
}

constexpr int kMaxDevices = 64;
std::mutex g_resident_mutex;
int g_resident[kMaxDevices][20] = {};  // CTAs the card holds at once, per variant

// How many CTAs of `v` the card holds at once (its persistent grid).
cudaError_t resident_ctas(const Variant& v, int device, int* n) {
  std::lock_guard<std::mutex> lock(g_resident_mutex);
  int& cached = g_resident[device][v.index];
  if (cached == 0) {
    cudaError_t err =
        cudaFuncSetAttribute(v.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, v.smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, v.fn, v.threads, v.smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached = per_sm * sms;
  }
  *n = cached;
  return cudaSuccess;
}

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A driver function, through the runtime (no -lcuda); null where missing.
template <typename Fn>
Fn driver_entry(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err =
      cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &found);
#endif
  return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<Fn>(p)
                                                                    : nullptr;
}

EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn = driver_entry<EncodeIm2col>("cuTensorMapEncodeIm2col");
  return fn;
}

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = driver_entry<EncodeTiled>("cuTensorMapEncodeTiled");
  return fn;
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
// stride 2; H, W even). Takes ic a multiple of 128, k 1 or 3; where the
// producer warps gather A (an NCHW map, or the 2x2/2 pool) a tile's source
// rows must fit their staging (conv_stream_plan.h; yolov2-tiny-voc's maps
// do). A layer graph's convs (no pool; make_geometry_ex) also take
// `stride` 2, x's pixels `in_pitch` bytes apart (channels-last), out
// (channels-last) `out_pitch` bytes a pixel, `res` the residual map (null:
// none; read by TMA, so 16-byte aligned) `res_pitch` bytes a pixel (a
// multiple of 16), `upsample` 1; x, out and res may lie inside wider maps
// (a route's channels). A chain's layer passes stride 1,
// the pitches ic and oc, no residual, no upsample. Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
extern "C" int conv_stream_forward(const void* x, int nhwc, const void* w, const void* bias,
                                   const void* shifts, int layer, void* out, int batch, int ic,
                                   int oc, int height, int width, int k, int pool, int linear,
                                   int stride, int in_pitch, int out_pitch, const void* res,
                                   int res_pitch, int upsample, int device, void* stream) {
  StreamArgs a;
  Geometry& g = a.g;
  if (res == nullptr) res_pitch = 0;
  if (layer < 0 || device < 0 || device >= kMaxDevices ||
      make_geometry_ex(batch, ic, oc, height, width, k, pool, linear, nhwc, stride, in_pitch,
                       out_pitch, res_pitch, upsample, &g) != 0 ||
      (res != nullptr && res_pitch == 0)) {
    return cudaErrorInvalidValue;
  }
  if ((reinterpret_cast<uintptr_t>(w) & 15) != 0 || (reinterpret_cast<uintptr_t>(x) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 1) != 0) {
    return cudaErrorInvalidValue;
  }
  if (batch == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int src = g.tma ? kATma : nhwc ? kANhwc : kANchw;
  int feat = (g.stride == 2 ? kFeatStride2 : 0) | (res_pitch ? kFeatResidual : 0) |
             (g.upsample ? kFeatUpsample : 0);
  // the plain instantiation stores at oc bytes a pixel: another pitch
  // alone takes the pitched one
  if (feat == 0 && out_pitch != oc) feat = kFeatPitch;
  if ((feat != 0 && feat != kFeatStride2 && feat != kFeatResidual && feat != kFeatUpsample &&
       feat != kFeatPitch) ||
      (feat != 0 && !g.tma)) {
    return cudaErrorInvalidValue;
  }
  const Variant v = pick(g.mode, src, feat);
  a.x = static_cast<const uint8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.bias = static_cast<const int32_t*>(bias);
  a.shifts = static_cast<const int32_t*>(shifts);
  a.out = out;
  a.layer = layer;
  std::fill(reinterpret_cast<char*>(&a.tmap), reinterpret_cast<char*>(&a.tmap + 1), 0);
  std::fill(reinterpret_cast<char*>(&a.rmap), reinterpret_cast<char*>(&a.rmap + 1), 0);
  if (res != nullptr) {  // two boxes of 128 channels x 128 rows a 128 x 256 tile
    unsigned long long dims[2], strides[1];
    if (residual_map(g, reinterpret_cast<uintptr_t>(res), dims, strides) != 0) {
      return cudaErrorInvalidValue;
    }
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t cdims[2] = {dims[0], dims[1]};
    const cuuint64_t cstrides[1] = {strides[0]};
    const cuuint32_t box[2] = {kResBoxC, static_cast<cuuint32_t>(g.tile_m)};
    const cuuint32_t elem[2] = {1, 1};
    if (encode(&a.rmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(res), cdims, cstrides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
        CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  if (g.tma) {
    const EncodeIm2col encode = encode_im2col();
    if (encode == nullptr) return cudaErrorNotSupported;
    unsigned long long dims[4], strides[3];
    int lower[2], upper[2];
    im2col_box(g, dims, strides, lower, upper);
    const cuuint64_t cdims[4] = {dims[0], dims[1], dims[2], dims[3]};
    const cuuint64_t cstrides[3] = {strides[0], strides[1], strides[2]};
    const cuuint32_t s = static_cast<cuuint32_t>(g.stride);
    const cuuint32_t elem[4] = {1, s, s, 1};
    if (encode(&a.tmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(x), cdims, cstrides,
               lower, upper, kSliceK, kSlab, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
      return cudaErrorInvalidValue;
    }
  }
  int resident;
  err = resident_ctas(v, device, &resident);
  if (err != cudaSuccess) return err;
  const long long launched = std::min<long long>(g.units, resident);
  v.fn<<<static_cast<unsigned>(launched), v.threads, v.smem, static_cast<cudaStream_t>(stream)>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    g_stream_paths.add(src == kATma ? kPathTma : src == kANchw ? kPathNchw : kPathNhwcGather);
    g_stream_paths.add(g.mode == kLinear ? kPathLinear : g.mode == kPool2 ? kPathPool2
                       : g.mode == kPool1 ? kPathPool1 : kPathPlain);
    g_stream_paths.add(g.mode == kPool1 ? kPathImage : g.mode == kLinear ? kPathNarrow : kPathWide);
    if (k == 1) g_stream_paths.add(kPathK1);
    if (oc % g.tile_n != 0) g_stream_paths.add(kPathPartialN);
    if (g.m_rows % g.tile_m != 0) g_stream_paths.add(kPathPartialM);
    const int hw = height * width;
    if (g.tma && (g.mode == kPool1 ? hw < g.tile_m : hw % kSlab != 0 && batch > 1)) {
      g_stream_paths.add(kPathAcrossImages);
    }
    if (g.units > launched) g_stream_paths.add(kPathSecondTile);
    if (g.units > launched && g.units % launched != 0) g_stream_paths.add(kPathUnequal);
    if (g.stride == 2) g_stream_paths.add(kPathStride2);
    if (res_pitch) g_stream_paths.add(kPathResidual);
    if (g.upsample) g_stream_paths.add(kPathUpsample);
    if (out_pitch != oc) g_stream_paths.add(kPathOutPitch);
    if (in_pitch != ic) g_stream_paths.add(kPathInPitch);
  }
  return err;
}
