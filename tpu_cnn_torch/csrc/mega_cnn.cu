// Whole-network int8 CNN megakernel for NVIDIA Hopper (sm_90a), on the
// int8 tensor cores.
//
// Replaces the TPU kernel tpu_cnn/ops/pallas_poly.py:cnn_forward_polyphase_pallas
// (body _mega_body): the whole net in one kernel, activations kept on chip.
// Per layer, for uint8 activations and int8 weights:
//
//     SAME conv3x3, integer accumulate -> >> shift[l] (arithmetic)
//     -> clip 0..255 -> 2x2 stride-2 max pool
//
// and, from the final map, whichever of three outputs is requested:
//   feats  (B, oc_L, P*P) uint8        the features, (channel, y*P + x)
//   bins   (B, oc_L*16)   float32      4x4 bin means: sum / (npx*npx) / 255
//   twin   (B, oc_L, P*P) bfloat16     the features again (0..255 is exact)
//
// The input is (B, ic0, S, S) uint8, NCHW: ic0 = 1 for a whole net, and
// the head's output channels when the kernel runs the tail of the chained
// plan (lyr4-wide's L1-L3 read the 16 x 128^2 output of conv_pool_layer.cu).
//
// Design: a persistent grid, one 512-thread CTA per SM (four warpgroups),
// each CTA walking images blockIdx.x, + gridDim.x, ...; every layer an
// exact integer GEMM on the tensor cores, so the contract holds bit for bit.
//   - Shared memory (smem_plan; ops/mega.py's mega_layout mirrors it): two
//     activation regions the layers ping-pong between (layer l writes
//     region l & 1), the image buffer, and the packed weights. Every
//     layer's output but the last is channels-last with a 1-pixel zero
//     halo, each pixel's channels padded to a power of two >= 16 (cpad),
//     the 16-byte chunk index XOR-swizzled with the pixel index (the
//     hardware's 32/64/128-byte swizzle at a 32-, 64- or 128-byte pixel
//     stride); a one-channel map (the image, or a middle layer's output)
//     is one byte a pixel, rows of S bytes rounded up to 4 between a zero
//     row above and below.
//   - One-channel layers (the net's L0) are the layer kernel's recast
//     (conv_layer.cuh): an M row is a 2x2 output quad, K the 4x4 input
//     patch under it (16 real bytes, no padding), N 4 positions x 16
//     channels; mma.sync.m16n8k16 with B in 8 registers
//     (int8_mma.cuh's one_channel_a and one_channel_b, ops/mega.py's
//     pack_one_channel) gives each lane the four positions of its
//     channels: the pool is a register max.
//   - Multi-channel layers are wgmma.mma_async m64nNk32 u8 x s8 -> s32
//     (N = 16, 32 or 64 channels a chunk), A from registers, B from shared
//     memory (hopper.cuh; pack_weights' K-major core matrices). A
//     warpgroup's 64 M rows are four M tiles of 2 pixel rows x 8 columns,
//     one per warp, gathered by ldmatrix.x4 from the swizzled map (the
//     im2col, K = 9 taps x cpad, tap-major); each warp holds rows g and
//     g + 8 of its tile, the upper and lower pixel of a column, so the
//     epilogue shifts, clips and pools in registers with one
//     __shfl_xor_sync and writes pooled u8.
//   - The weights are copied into shared memory by the bulk copy engine
//     behind an mbarrier, once per CTA where they fit beside the regions
//     (lyr3-std: 1,024 + 5,120 + 18,432 bytes); a layer whose weights do
//     not fit is copied per image into shared memory its layer leaves
//     free (lyr4-wide's tail: L2's 18,432 stay, L1's 5,120 go behind the
//     input band, L3's 73,728 behind L3's output).
//   - A one-channel image comes into its buffer as one cp.async.bulk of
//     S^2 bytes behind an mbarrier (rows dense, a zero row above and
//     below; the columns left and right of the image are masked to zero in
//     the A registers), issued for the next image as soon as the current
//     one's L0 has read the buffer, so the copy runs under the current
//     image's L1 and later layers (plain loads for a width not a multiple
//     of 16 or a misaligned batch). One copy, not one a row: 128 row
//     copies kept the issuing warp, and with it the layer's barrier, busy.
//     lyr3-std: 69,696 (L0 out, 66^2 x 16) + 36,992 (L1 out, 34^2 x 32) +
//     16,640 (130 x 128) + 24,576 (weights), 148,112 bytes with each buffer
//     128-byte aligned and slack around them: one CTA per SM.
//   - A multi-channel input (lyr4-wide's tail) is staged channels-last into
//     region 1 in row bands, 30 rows a band (as many as region 1 holds
//     beside L1's weights), by coalesced word loads of 4 pixels x 16
//     channels and a byte transpose; no copy of it overlaps the compute.
//     Its layers run on wgmma like the others.
//
// What bounds it on an H100: its bound is the MACs (lyr3-std moves ~52 KB
// per image for 40 M MACs: 62 us per batch of 1536 at the tensor cores'
// 989 T MAC/s, against ~25 us of HBM). What holds it back is issue and
// latency, not the tensor cores' rate: a CTA has one image at a time and a
// __syncthreads between layers; every wgmma waits for its warpgroup's
// ldmatrix gathers (the im2col reads each input byte 9 or 10 times: ~1 MB
// of shared memory a lyr3-std image) and its epilogue waits for the MMAs.
// The design halves the MMA work of L0 (K 16 of 16 where it was 9 of 32),
// takes B from shared memory (it came from L1/L2 for every work item),
// hides the image copy under the previous image's later layers, and keeps
// every access of shared memory at a 32-bit shared address (the layers
// take byte offsets into `smem`). A second accumulator, to overlap a
// unit's epilogue with the next unit's MMAs, did not pay: at 512 threads a
// thread has 128 registers, and ptxas then serialised the wgmmas and
// spilled (PERF.md). Later work: two images per CTA in flight, the tail's
// bands by bulk copies behind the compute. A measurement build,
// -DMEGA_CNN_PHASE_CLOCKS, adds each CTA's clocks per phase (read by
// mega_cnn_phase_cycles; scripts/mega_phases_torch.py). The
// TPU kernel's phase split, lane rolls, block-diagonal batch packing and
// zero-point staging were Mosaic workarounds and have no counterpart here.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "int8_mma.cuh"
#include "path_counts.cuh"

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxSmemBytes = 232448 - 128;  // a block's opt-in limit on sm_90 less the mbarriers
constexpr int kThreads = 512;          // four warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = kThreads / 128;
constexpr int kAlign = 128;            // every shared-memory buffer's alignment
constexpr int kReadSlack = 16;         // the recast reads 4 bytes around a one-channel map

struct MegaParams {
  const uint8_t* images;                 // (B, ic0, S, S)
  const uint8_t* weights[kMaxLayers];    // per layer, packed by ops/mega.py
  const int32_t* shifts;                 // (L,)
  uint8_t* feats;                        // optional outputs, nullptr = skip
  float* bins;
  __nv_bfloat16* twin;
  int batch;
  int n_layers;
  int size0;
  int ic[kMaxLayers];
  int oc[kMaxLayers];
  int region_off[2];                     // the activation regions
  int in_off, in_pitch;                  // a one-channel layer 0's image buffer
  int band_rows;                         // a multi-channel layer 0's rows per band
  int w_off[kMaxLayers];                 // each layer's weights in shared memory
  int w_bytes[kMaxLayers];
  int resident[kMaxLayers];              // 1: copied once per CTA, 0: per image
  int bulk_in;                           // the image by bulk copies (prefetched)
  int vec_band;                          // a band staged by words (S % 4 == 0, aligned)
};

__host__ __device__ inline int align_up(int x, int a) { return (x + a - 1) / a * a; }

// Bytes of a row of an S-wide one-channel map.
__host__ __device__ inline int pitch1(int s) { return align_up(s, 4); }

// The wgmma N chunk of a layer of oc output channels, and oc padded to it.
__host__ __device__ inline int chunk_n(int oc) { return oc <= 16 ? 16 : oc <= 32 ? 32 : 64; }
__host__ __device__ inline int padded_n(int oc) { return align_up(oc, chunk_n(oc)); }
__host__ __device__ inline int k_steps(int ic) { return (9 * cpad_of(ic) + 31) / 32; }

// Bytes of a layer's packed weights: the recast's 1,024 per 16 channels,
// or the wgmma B of K steps x padded N x 32.
__host__ __device__ inline int weight_bytes(int ic, int oc) {
  return ic == 1 ? 1024 * ((oc + 15) / 16) : k_steps(ic) * padded_n(oc) * 32;
}

// The dynamic shared memory. The layers address it by byte offsets, so
// that every access is a shared-memory one with 32-bit addresses.
extern __shared__ __align__(kAlign) uint8_t smem[];

// ── the output side ──────────────────────────────────────────────────

// Where a layer's pooled output goes: kFinal the final map (NCHW, channel
// planes P x P), kMap a channels-last map with its halo (pb-byte pixels),
// or, pb 1, a one-channel map (row pitch op).
enum OutKind { kFinal, kMap };

__device__ __forceinline__ int clip_shift(int v, int shift) {
  return min(max(v >> shift, 0), 255);  // >> on int is arithmetic (floor)
}

// The pooled values v0, v1 of channels n0 and n0 + 1 at (py, px). For kMap
// `base` is the pixel's offset (po * pb, po its index with the halo) and
// sw its chunk swizzle. Channels past oc hold zero weights, so a padded
// channel of a channels-last map gets 0.
template <int OUT>
__device__ __forceinline__ void store_pair(int out_off, int pb, int op, int P, int oc, int py,
                                           int px, int base, int sw, int n0, int v0, int v1) {
  if (OUT == kFinal) {
    uint8_t* o = smem + out_off + py * P + px;
    if (n0 < oc) o[n0 * P * P] = static_cast<uint8_t>(v0);
    if (n0 + 1 < oc) o[(n0 + 1) * P * P] = static_cast<uint8_t>(v1);
  } else if (pb == 1) {
    if (n0 == 0) smem[out_off + (py + 1) * op + px] = static_cast<uint8_t>(v0);
  } else {
    *reinterpret_cast<uint16_t*>(smem + out_off + base + 16 * ((n0 >> 4) ^ sw) + (n0 & 15)) =
        static_cast<uint16_t>(v0 | (v1 << 8));
  }
}

// ── one-channel layers: the recast ───────────────────────────────────

// The S x S one-channel map at in_off (row pitch ip, a 4-byte multiple;
// row 0 the zero row above the image) -> the pooled P x P output at
// out_off. A warp's unit is one M tile of 16 quads in one quad row, for
// one group of 16 output channels; w_off: pack_one_channel's words. The
// 16-channel map (pb 16, the net's L0) stores its pairs at one lane offset
// and immediate displacements.
template <int OUT>
__device__ __forceinline__ void one_layer(int in_off, int ip, int S, int w_off, int oc,
                                          int shift, int out_off, int pb, int op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int P = S / 2;
  const int mtr = (P + 15) / 16;  // M tiles per quad row
  const int dq = kWarps / mtr, dc = kWarps - dq * mtr;
  const bool map16 = OUT == kMap && pb == 16;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(smem + w_off);
  const int groups = (oc + 15) / 16;
  for (int grp = 0; grp < groups; ++grp) {
    uint32_t b[8];
    one_channel_b<false>(b, w, grp, lane);
    // this warp's M tiles warp, warp + kWarps, ...: quad row qr, tile ci
    int qr = warp / mtr, ci = warp - qr * mtr;
    while (qr < P) {
      const int qc0 = 16 * ci;
      const uint8_t* row = smem + in_off + (2 * qr + t4) * ip;
      uint32_t a[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // past the edge: read, never stored
        const int qa = min(qc0 + g + 8 * h, P - 1);
        a[h] = one_channel_a(row, 2 * qa - 1);
        // the columns left and right of the map are zero: the map has no
        // halo columns (the bytes read there belong to a neighbouring row,
        // or to the slack around the buffers)
        if (qa == 0) a[h] &= 0xffffff00u;
        if (qa == P - 1) a[h] &= 0x00ffffffu;
      }
      int acc[8][4];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0;
        mma_u8s8_k16(acc[t], a[0], a[1], b[t]);
      }
      // N tile 2p + h, column 2 t4 + e: channel 16 grp + 8 h + 2 t4 + e at
      // position p; C rows g and g + 8: quads qc0 + g (+ 8)
      const int po0 = (qr + 1) * (P + 2) + qc0 + g + 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qc = qc0 + g + 8 * r;
        if (qc >= P) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 2 * r + e;
            v[e] = clip_shift(max(max(acc[h][i], acc[2 + h][i]), max(acc[4 + h][i], acc[6 + h][i])),
                              shift);
          }
          if (map16) {
            *reinterpret_cast<uint16_t*>(smem + out_off + 16 * (po0 + 8 * r) + 8 * h + 2 * t4) =
                static_cast<uint16_t>(v[0] | (v[1] << 8));
          } else {
            const int po = po0 + 8 * r;
            store_pair<OUT>(out_off, pb, op, P, oc, qr, qc, po * pb, swz(po, pb >> 4),
                            16 * grp + 8 * h + 2 * t4, v[0], v[1]);
          }
        }
      }
      qr += dq;
      ci += dc;
      if (ci >= mtr) {
        ci -= mtr;
        ++qr;
      }
    }
  }
}

// ── multi-channel layers: wgmma ──────────────────────────────────────

// One contract layer as an implicit GEMM on wgmma. in_off holds
// `2 * n_prow + 2` rows of the S x S input with its halo (pitch S + 2
// pixels, cpad(ic) bytes a pixel; row 0 is the halo or image row above the
// first); the pooled rows go to output rows py0.. . CPC: 16-channel chunks
// per input pixel (1, 2, 4), 0 for cpc_rt (8 or more). NW: the N chunk.
// KG: K steps gathered before their MMAs are issued (a divisor of the
// layer's). A warpgroup's unit is one M block (2 rows x 32 columns, a
// warp's 8 columns each) times one N chunk.
template <int CPC, int NW, int KG, int OUT>
__device__ __forceinline__ void wg_layer(int in_off, int S, int n_prow, int py0, int cpc_rt,
                                         int w_off, int oc, int shift, int out_off, int pb,
                                         int op) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warpgroup's index, uniform to the compiler too: a wgmma in a path
  // it takes for divergent is serialized
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int cpc = CPC > 0 ? CPC : cpc_rt;
  const int cp = 16 * cpc;
  // K steps: 5 for 16 channels (the tenth tap padded), else 9 cpc / 2, a
  // multiple of KG (5, 9, 18 and 36 or more for KG 5, 9, 6 and 4)
  const int n_ks = cpc == 1 ? 5 : 9 * cpc / 2;
  const int pitch = S + 2;
  const int P = S / 2;
  const int ng = padded_n(oc) / 8;
  const int n_chunks = ng * 8 / NW;
  const int ncb = (S + 31) / 32;  // column blocks of 32
  const int dq = kGroups / ncb, dc = kGroups - dq * ncb;
  const int cpp_out = pb >> 4;
  // ldmatrix: this lane addresses row (lane & 7) + (lane & 8) of its warp's
  // M tile (pixel column lane & 7 of the upper or lower row) at K chunk
  // lane >> 4 of the step
  const int ldy = (lane >> 3) & 1, lcol = lane & 7, lh = lane >> 4;
  const uint32_t in_s = smem_u32(smem + in_off);
  const uint32_t w_s = smem_u32(smem + w_off);

  // B of K step s starts s * ng * 256 bytes on: the descriptor's address
  // field (16-byte units) advances by ng * 16 a step
  const int dstep = ng * 16;
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    const uint64_t desc0 = b_desc(w_s, ng, 0, chunk * (NW / 8));
    // this warpgroup's M blocks wg, wg + kGroups, ...: row pair pr, block cb
    int pr = wg / ncb, cb = wg - pr * ncb;
    for (; pr < n_prow; pr += dq) {
      // past the edge: read, never stored
      const int p0 = (2 * pr + ldy) * pitch + min(32 * cb + 8 * wl + lcol, S - 1);
      int acc[NW / 2];
#pragma unroll
      for (int i = 0; i < NW / 2; ++i) acc[i] = 0;
      for (int ks0 = 0; ks0 < n_ks; ks0 += KG) {
        uint32_t a[KG][4];
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          const int ks = ks0 + k;
          int tap, c16;
          if (CPC == 1) {
            tap = min(2 * ks + lh, 8);  // the tenth tap: zero weights
            c16 = 0;
          } else {
            tap = (2 * ks) / cpc;
            c16 = (2 * ks) % cpc + lh;
          }
          const int ky = tap / 3;
          const int p = p0 + ky * pitch + (tap - 3 * ky);
          ldmatrix_x4(a[k], in_s + p * cp + 16 * (c16 ^ swz(p, cpc)));
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KG; ++k) {
          Wgmma<NW>::mma(acc, a[k], desc0 + static_cast<uint64_t>((ks0 + k) * dstep), 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
      }

      // epilogue: rows g (upper) and g + 8 (lower) of columns 2 t4, 2 t4 + 1
      // of each N tile j, then the pixel column g ^ 1 from lane ^ 4
      const int py = py0 + pr;
      const int px = 16 * cb + 4 * wl + (g >> 1);
      const bool store = (g & 1) == 0 && px < P;
      const int po = (py + 1) * (P + 2) + px + 1;
      const int base = OUT == kMap ? po * pb : 0;
      const int sw = OUT == kMap ? swz(po, cpp_out) : 0;
#pragma unroll
      for (int j = 0; j < NW / 8; ++j) {
        int m0 = max(acc[4 * j], acc[4 * j + 2]);
        int m1 = max(acc[4 * j + 1], acc[4 * j + 3]);
        m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if (store) {
          store_pair<OUT>(out_off, pb, op, P, oc, py, px, base, sw, chunk * NW + 8 * j + 2 * t4,
                          clip_shift(m0, shift), clip_shift(m1, shift));
        }
      }
      cb += dc;
      if (cb >= ncb) {
        cb -= ncb;
        ++pr;
      }
    }
  }
}

template <int CPC, int KG, int OUT>
__device__ __forceinline__ void wg_layer_n(int in_off, int S, int n_prow, int py0, int cpc_rt,
                                           int w_off, int oc, int shift, int out_off, int pb,
                                           int op) {
  switch (chunk_n(oc)) {
    case 16:
      wg_layer<CPC, 16, KG, OUT>(in_off, S, n_prow, py0, cpc_rt, w_off, oc, shift, out_off, pb, op);
      break;
    case 32:
      wg_layer<CPC, 32, KG, OUT>(in_off, S, n_prow, py0, cpc_rt, w_off, oc, shift, out_off, pb, op);
      break;
    default:
      wg_layer<CPC, 64, KG, OUT>(in_off, S, n_prow, py0, cpc_rt, w_off, oc, shift, out_off, pb, op);
  }
}

// A multi-channel layer from in_off (pixel bytes cpad_of(ic)).
template <int OUT>
__device__ __forceinline__ void multi_layer(int in_off, int ic, int S, int n_prow, int py0,
                                            int w_off, int oc, int shift, int out_off, int pb,
                                            int op) {
  switch (cpad_of(ic)) {
    case 16:
      wg_layer_n<1, 5, OUT>(in_off, S, n_prow, py0, 1, w_off, oc, shift, out_off, pb, op);
      break;
    case 32:
      wg_layer_n<2, 9, OUT>(in_off, S, n_prow, py0, 2, w_off, oc, shift, out_off, pb, op);
      break;
    case 64:
      wg_layer_n<4, 6, OUT>(in_off, S, n_prow, py0, 4, w_off, oc, shift, out_off, pb, op);
      break;
    default:
      wg_layer_n<0, 4, OUT>(in_off, S, n_prow, py0, cpad_of(ic) >> 4, w_off, oc, shift, out_off,
                            pb, op);
  }
}

// Layer l on its input at in_off (a one-channel map in rows of pitch ip,
// or channels-last), into out_off.
__device__ __forceinline__ void run_layer(bool last, int in_off, int ip, int ic, int S,
                                          int n_prow, int py0, int w_off, int oc, int shift,
                                          int out_off, int pb, int op) {
  if (ic == 1) {
    if (last) {
      one_layer<kFinal>(in_off, ip, S, w_off, oc, shift, out_off, pb, op);
    } else {
      one_layer<kMap>(in_off, ip, S, w_off, oc, shift, out_off, pb, op);
    }
  } else if (last) {
    multi_layer<kFinal>(in_off, ic, S, n_prow, py0, w_off, oc, shift, out_off, pb, op);
  } else {
    multi_layer<kMap>(in_off, ic, S, n_prow, py0, w_off, oc, shift, out_off, pb, op);
  }
}

// ── staging and halos ────────────────────────────────────────────────

// Zero the 1-pixel ring of a (P + 2)^2 channels-last map of pb-byte pixels.
__device__ __forceinline__ void zero_halo(uint8_t* map, int P, int pb) {
  const int pitch = P + 2;
  const int ring = 2 * pitch + 2 * P;
  const int chunks = pb / 16;
  for (int idx = threadIdx.x; idx < ring * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = idx - r * chunks;
    int pixel;
    if (r < pitch) {
      pixel = r;
    } else if (r < 2 * pitch) {
      pixel = (P + 1) * pitch + (r - pitch);
    } else {
      const int k = r - 2 * pitch;
      pixel = (1 + (k >> 1)) * pitch + ((k & 1) ? P + 1 : 0);
    }
    *reinterpret_cast<uint4*>(map + pixel * pb + 16 * c) = make_uint4(0, 0, 0, 0);
  }
}

// Zero the rows above and below a one-channel P x P map (row pitch op);
// the recast masks the columns left and right of it.
__device__ __forceinline__ void zero_halo_one(uint8_t* map, int P, int op) {
  for (int c = threadIdx.x; c < 2 * op; c += blockDim.x) {
    map[c < op ? c : (P + 1) * op + c - op] = 0;
  }
}

// The (S, S) one-channel image into its buffer `buf` (row y at (y + 1) *
// ip) by plain loads: an odd width or a misaligned batch.
__device__ __forceinline__ void stage_one(const uint8_t* __restrict__ img, int S,
                                          uint8_t* __restrict__ buf, int ip) {
  for (int idx = threadIdx.x; idx < S * S; idx += blockDim.x) {
    const int y = idx / S, x = idx - y * S;
    buf[(y + 1) * ip + x] = img[idx];
  }
}

// Band rows (image rows y0 - 1 .. y0 + rows - 2) of the (ic, S, S) NCHW
// image into `band`, channels-last with pb-byte pixels (zero outside the
// image and in the padded channels). vec (S % 4 == 0, a 4-byte aligned
// image): a thread takes 4 pixels x 16 channels, 16 coalesced word loads
// and a 4 x 4 byte transpose per 4 channels (__byte_perm), four 16-byte
// stores; else one pixel's 16 channels byte by byte.
__device__ __forceinline__ void stage_band(const uint8_t* __restrict__ img, int ic, int S,
                                           int y0, int rows, uint8_t* __restrict__ band, int pb,
                                           bool vec) {
  const int pitch = S + 2;
  const int cpp = pb / 16;
  const int plane = S * S;
  if (vec) {
    const int qpr = S / 4;  // 4-pixel groups a row
    for (int idx = threadIdx.x; idx < rows * qpr * cpp; idx += blockDim.x) {
      const int rq = idx / cpp, c16 = idx - rq * cpp;
      const int by = rq / qpr, q = rq - by * qpr;
      const int y = y0 - 1 + by;
      const bool yok = static_cast<unsigned>(y) < static_cast<unsigned>(S);
      const uint32_t* src = reinterpret_cast<const uint32_t*>(
          img + static_cast<size_t>(16 * c16) * plane + (yok ? y : 0) * S + 4 * q);
      uint32_t v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        v[i] = yok && 16 * c16 + i < ic ? __ldg(src + i * (plane / 4)) : 0u;
      }
      uint32_t px[4][4];  // [pixel][4-channel group]
#pragma unroll
      for (int cg = 0; cg < 4; ++cg) {
        const uint32_t t0 = __byte_perm(v[4 * cg], v[4 * cg + 1], 0x5140);
        const uint32_t t1 = __byte_perm(v[4 * cg + 2], v[4 * cg + 3], 0x5140);
        const uint32_t t2 = __byte_perm(v[4 * cg], v[4 * cg + 1], 0x7362);
        const uint32_t t3 = __byte_perm(v[4 * cg + 2], v[4 * cg + 3], 0x7362);
        px[0][cg] = __byte_perm(t0, t1, 0x5410);
        px[1][cg] = __byte_perm(t0, t1, 0x7632);
        px[2][cg] = __byte_perm(t2, t3, 0x5410);
        px[3][cg] = __byte_perm(t2, t3, 0x7632);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = by * pitch + 4 * q + k + 1;
        *reinterpret_cast<uint4*>(band + p * pb + 16 * (c16 ^ swz(p, cpp))) =
            make_uint4(px[k][0], px[k][1], px[k][2], px[k][3]);
      }
    }
    // the halo columns
    for (int idx = threadIdx.x; idx < rows * 2 * cpp; idx += blockDim.x) {
      const int rs = idx / cpp, c16 = idx - rs * cpp;
      const int p = (rs >> 1) * pitch + ((rs & 1) ? S + 1 : 0);
      *reinterpret_cast<uint4*>(band + p * pb + 16 * (c16 ^ swz(p, cpp))) = make_uint4(0, 0, 0, 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < rows * pitch * cpp; idx += blockDim.x) {
    const int pixel = idx / cpp, c16 = idx - pixel * cpp;
    const int by = pixel / pitch;
    const int y = y0 - 1 + by, x = pixel - by * pitch - 1;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (static_cast<unsigned>(y) < static_cast<unsigned>(S) &&
        static_cast<unsigned>(x) < static_cast<unsigned>(S)) {
      const uint8_t* src = img + 16 * c16 * plane + y * S + x;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        if (16 * c16 + i < ic) v[i >> 2] |= static_cast<uint32_t>(src[i * plane]) << (8 * (i & 3));
      }
    }
    *reinterpret_cast<uint4*>(band + pixel * pb + 16 * (c16 ^ swz(pixel, cpp))) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Thread 0: one bulk copy of image b (S rows of S bytes, contiguous on
// both sides) behind the zero row of its buffer.
__device__ __forceinline__ void issue_image(const MegaParams& prm, int b, uint8_t* buf,
                                            uint64_t* bar) {
  const int S = prm.size0;
  mbar_expect_tx(bar, static_cast<uint32_t>(S * S));
  bulk_load(buf + S, prm.images + static_cast<size_t>(b) * S * S, S * S, bar);
}

// The final P x P map of oc channels (NCHW in shared memory) to the
// requested outputs of image b.
__device__ __forceinline__ void write_outputs(const MegaParams& prm,
                                              const uint8_t* __restrict__ cur, int b, int oc,
                                              int P) {
  const int pp = P * P;
  const int total = oc * pp;
  const bool vec = total % 16 == 0;
  if (prm.feats != nullptr) {
    uint8_t* f = prm.feats + static_cast<size_t>(b) * total;
    if (vec) {
      for (int i = threadIdx.x; i < total / 16; i += blockDim.x) {
        reinterpret_cast<uint4*>(f)[i] = reinterpret_cast<const uint4*>(cur)[i];
      }
    } else {
      for (int i = threadIdx.x; i < total; i += blockDim.x) f[i] = cur[i];
    }
  }
  if (prm.twin != nullptr) {
    __nv_bfloat16* t = prm.twin + static_cast<size_t>(b) * total;
    if (vec) {
      for (int i = threadIdx.x; i < total / 8; i += blockDim.x) {
        const uint2 v = reinterpret_cast<const uint2*>(cur)[i];
        uint32_t o[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t word = k < 2 ? v.x : v.y;
          const int sh = 16 * (k & 1);
          const __nv_bfloat16 lo = __float2bfloat16_rn(static_cast<float>((word >> sh) & 0xff));
          const __nv_bfloat16 hi =
              __float2bfloat16_rn(static_cast<float>((word >> (sh + 8)) & 0xff));
          o[k] = static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
                 (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
        }
        reinterpret_cast<uint4*>(t)[i] = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      for (int i = threadIdx.x; i < total; i += blockDim.x) {
        t[i] = __float2bfloat16_rn(static_cast<float>(cur[i]));
      }
    }
  }
  if (prm.bins != nullptr) {
    const int npx = P / 4;
    float* bo = prm.bins + static_cast<size_t>(b) * oc * 16;
    for (int j = threadIdx.x; j < oc * 16; j += blockDim.x) {
      const int o = j >> 4;
      const int by = (j & 15) >> 2;
      const int bx = j & 3;
      const uint8_t* plane = cur + o * pp + (by * npx) * P + bx * npx;
      unsigned sum = 0;
      if (npx % 4 == 0) {  // four bytes a word, summed by one dp4a
        for (int y = 0; y < npx; ++y) {
          const unsigned* r = reinterpret_cast<const unsigned*>(plane + y * P);
          for (int x = 0; x < npx / 4; ++x) sum = __dp4a(r[x], 0x01010101u, sum);
        }
      } else {
        for (int y = 0; y < npx; ++y) {
          for (int x = 0; x < npx; ++x) sum += plane[y * P + x];
        }
      }
      // the same order as the TPU kernel: exact integer sum, / npx^2, / 255
      bo[j] = static_cast<float>(sum) / static_cast<float>(npx * npx) / 255.0f;
    }
  }
}

// ── the kernel ───────────────────────────────────────────────────────

#ifdef MEGA_CNN_PHASE_CLOCKS
// Built with -DMEGA_CNN_PHASE_CLOCKS: thread 0 of each CTA adds the SM
// clocks between the barriers that end its phases (0 the prologue, 1 + l
// layer l, 5 the outputs; 6 of layer 0's and 7 of the layers' are the
// waits for the image and the per-image weights).
__device__ unsigned long long g_phase_cycles[8];
#define MEGA_PHASE(i)                                                              \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      const long long now = clock64();                                             \
      atomicAdd(&g_phase_cycles[i], static_cast<unsigned long long>(now - t_mark)); \
      t_mark = now;                                                                \
    }                                                                              \
  } while (0)
#else
#define MEGA_PHASE(i) \
  do {                \
  } while (0)
#endif

__global__ void __launch_bounds__(kThreads, 1) mega_cnn_kernel(MegaParams prm) {
  __shared__ __align__(8) uint64_t bar_in, bar_w;
  uint8_t* const inbuf = smem + prm.in_off;
  const int n = prm.n_layers;
  const int S0 = prm.size0;
  const bool one0 = prm.ic[0] == 1;
#ifdef MEGA_CNN_PHASE_CLOCKS
  long long t_mark = clock64();
#endif

  if (threadIdx.x == 0) {
    mbar_init(&bar_in, 1);
    mbar_init(&bar_w, 1);
    mbar_init_fence();
  }
  if (one0) {  // the image buffer's halo; the copies write only the image
    for (int i = threadIdx.x; i < ((S0 + 2) * prm.in_pitch + 15) / 16; i += blockDim.x) {
      reinterpret_cast<uint4*>(inbuf)[i] = make_uint4(0, 0, 0, 0);
    }
  }
  fence_proxy_async();
  __syncthreads();
  uint32_t ph_in = 0, ph_w = 0;
  if (threadIdx.x == 0) {
    int bytes = 0;
    for (int l = 0; l < n; ++l) bytes += prm.resident[l] ? prm.w_bytes[l] : 0;
    if (bytes > 0) {
      mbar_expect_tx(&bar_w, static_cast<uint32_t>(bytes));
      for (int l = 0; l < n; ++l) {
        if (prm.resident[l]) bulk_load(smem + prm.w_off[l], prm.weights[l], prm.w_bytes[l], &bar_w);
      }
    }
  }
  if (prm.bulk_in && threadIdx.x == 0) issue_image(prm, blockIdx.x, inbuf, &bar_in);
  bool any_resident = false;
  for (int l = 0; l < n; ++l) any_resident |= prm.resident[l] != 0;
  if (any_resident) {
    mbar_wait(&bar_w, ph_w);
    ph_w ^= 1;
  }
  MEGA_PHASE(0);

  for (int b = blockIdx.x; b < prm.batch; b += gridDim.x) {
    int size = S0;
    for (int l = 0; l < n; ++l) {
      const bool last = l == n - 1;
      const int P = size / 2;
      const int out_off = (l & 1) ? prm.region_off[1] : prm.region_off[0];
      if (!prm.resident[l]) {  // into shared memory this layer leaves free
        if (threadIdx.x == 0) {
          mbar_expect_tx(&bar_w, static_cast<uint32_t>(prm.w_bytes[l]));
          bulk_load(smem + prm.w_off[l], prm.weights[l], prm.w_bytes[l], &bar_w);
        }
        mbar_wait(&bar_w, ph_w);
        ph_w ^= 1;
        MEGA_PHASE(7);
      }
      const int pb = last ? 0 : cpad_of(prm.oc[l]);
      const int op = pitch1(P);
      if (!last) {
        if (pb == 1) {
          zero_halo_one(smem + out_off, P, op);
        } else {
          zero_halo(smem + out_off, P, pb);
        }
      }
      // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1
      const int shift = min(max(prm.shifts[l], 0), 31);
      // the input: the image buffer, row bands staged into region 1 (a
      // multi-channel layer 0), or the previous layer's output
      const bool banded = l == 0 && !one0;
      const int in_off = l == 0 ? (one0 ? prm.in_off : prm.region_off[1])
                                : (l & 1) ? prm.region_off[0] : prm.region_off[1];
      const int ip = l == 0 ? prm.in_pitch : pitch1(size);
      const int rows_step = banded ? prm.band_rows : size;
      if (l == 0 && one0) {
        if (prm.bulk_in) {
          mbar_wait(&bar_in, ph_in);
          ph_in ^= 1;
          MEGA_PHASE(6);
        } else {
          stage_one(prm.images + static_cast<size_t>(b) * S0 * S0, S0, inbuf, prm.in_pitch);
          __syncthreads();
        }
      }
      for (int y0 = 0; y0 < size; y0 += rows_step) {
        const int rows = min(rows_step, size - y0);
        if (banded) {
          if (y0 > 0) __syncthreads();  // the previous band is consumed
          stage_band(prm.images + static_cast<size_t>(b) * prm.ic[0] * S0 * S0, prm.ic[0], size,
                     y0, rows + 2, smem + in_off, cpad_of(prm.ic[0]), prm.vec_band);
          __syncthreads();
        }
        run_layer(last, in_off, ip, prm.ic[l], size, rows / 2, y0 / 2, prm.w_off[l], prm.oc[l],
                  shift, out_off, pb, op);
      }
      fence_proxy_async();
      __syncthreads();
      // the image buffer is read: the next image's copies run under the
      // later layers
      const int next = b + gridDim.x;
      if (l == 0 && prm.bulk_in && threadIdx.x == 0 && next < prm.batch) {
        issue_image(prm, next, inbuf, &bar_in);
      }
      MEGA_PHASE(1 + l);
      size = P;
    }
    write_outputs(prm, smem + ((n - 1) & 1 ? prm.region_off[1] : prm.region_off[0]), b,
                  prm.oc[n - 1], size);
    fence_proxy_async();
    __syncthreads();  // the final map is read before the next image's L0
    MEGA_PHASE(5);
  }
}

// ── the plan ─────────────────────────────────────────────────────────

// Layer l's output map bytes: NCHW for the last layer, else with its halo
// (one byte a pixel in rows of pitch1, or cpad channels a pixel).
long long map_bytes(int oc, int P, bool last) {
  if (last) return static_cast<long long>(oc) * P * P;
  if (oc == 1) return static_cast<long long>(P + 2) * pitch1(P);
  return static_cast<long long>(P + 2) * (P + 2) * cpad_of(oc);
}

// Shared-memory plan for a geometry (ops/mega.py's mega_layout mirrors
// it, held equal through mega_cnn_smem_plan): region 0, region 1, a
// one-channel layer 0's image buffer (S + 2 rows of S bytes rounded up
// to 4), then the weights that stay. A multi-channel layer 0 is staged into region 1 in bands: the whole image when it fits,
// else as many rows as region 1 holds (an even number, at least 2). Every
// layer's weights stay for the CTA's life when all fit; else the largest
// that fit the room left stay, and each other layer's are copied per
// image into a region's bytes past what its layer reads or writes (layer
// 0's behind the band, its rows cut to make room). kAlign bytes come
// before region 0 and kReadSlack end it, for the recast's reads around a
// map. Returns the bytes, 0 if the kernel does not take the geometry.
int smem_plan(int n_layers, int size0, const int* ic, const int* oc, MegaParams* prm) {
  const long long limit = kMaxSmemBytes - kReadSlack;
  if (n_layers < 1 || n_layers > kMaxLayers || size0 <= 0) return 0;
  if (size0 % (1 << n_layers) != 0) return 0;
  // the first layer indexes its input planes in int
  if (ic[0] <= 0 || static_cast<long long>(ic[0]) * size0 * size0 > INT32_MAX) return 0;
  long long out[kMaxLayers], region[2] = {0, 0};
  int size = size0;
  for (int l = 0; l < n_layers; ++l) {
    if (ic[l] <= 0 || oc[l] <= 0) return 0;
    if (l > 0 && ic[l] != oc[l - 1]) return 0;
    out[l] = map_bytes(oc[l], size / 2, l == n_layers - 1);
    region[l & 1] = std::max(region[l & 1], out[l]);
    size /= 2;
  }
  if (region[0] > limit || region[1] > limit) return 0;
  const bool one0 = ic[0] == 1;
  const long long row = static_cast<long long>(size0 + 2) * cpad_of(ic[0]);
  long long in_bytes = 0, rows = size0;
  if (one0) {
    in_bytes = static_cast<long long>(size0 + 2) * pitch1(size0);
  } else if (align_up(static_cast<int>(region[0]), kAlign) +
                 std::max(region[1], (size0 + 2) * row) > limit) {
    rows = std::min<long long>(size0, region[1] / row - 2) & ~1LL;
    if (rows < 2) rows = 2;
  }
  if (!one0) region[1] = std::max(region[1], (rows + 2) * row);
  if (region[0] + region[1] + in_bytes > limit) return 0;
  const long long off0 = kAlign;  // the slack before region 0
  const long long off1 = off0 + align_up(static_cast<int>(region[0]), kAlign);
  const long long off_in = off1 + align_up(static_cast<int>(region[1]), kAlign);
  const long long base = off_in + align_up(static_cast<int>(in_bytes), kAlign);
  if (base > limit) return 0;

  long long wb[kMaxLayers], total = 0;
  for (int l = 0; l < n_layers; ++l) {
    wb[l] = weight_bytes(ic[l], oc[l]);
    total += align_up(static_cast<int>(wb[l]), kAlign);
  }
  int resident[kMaxLayers] = {0, 0, 0, 0};
  long long w_off[kMaxLayers] = {0, 0, 0, 0};
  long long end = base;
  if (base + total <= limit) {
    for (int l = 0; l < n_layers; ++l) {
      resident[l] = 1;
      w_off[l] = end;
      end += align_up(static_cast<int>(wb[l]), kAlign);
    }
  } else {
    // the largest first, while they fit the room left
    for (int k = 0; k < n_layers; ++k) {
      int best = -1;
      for (int l = 0; l < n_layers; ++l) {
        if (!resident[l] && end + wb[l] <= limit && (best < 0 || wb[l] > wb[best])) {
          best = l;
        }
      }
      if (best < 0) break;
      resident[best] = 1;
      w_off[best] = end;
      end += align_up(static_cast<int>(wb[best]), kAlign);
    }
    const long long roff[2] = {off0, off1};
    for (int l = 0; l < n_layers; ++l) {
      if (resident[l]) continue;
      if (l == 0 && !one0) {  // behind the band, in region 1
        const long long r =
            std::min<long long>(rows, ((region[1] - wb[0] - kAlign) / row - 2) & ~1LL);
        if (r < 2) return 0;
        rows = r;
        w_off[0] = off1 + align_up(static_cast<int>((rows + 2) * row), kAlign);
        continue;
      }
      // past the bytes the layer writes, or past those it reads
      const int o = l & 1, i = (l + 1) & 1;
      const long long used_out = align_up(static_cast<int>(out[l]), kAlign);
      const long long used_in = l > 0 ? align_up(static_cast<int>(out[l - 1]), kAlign) : 0;
      if (region[o] - used_out >= wb[l]) {
        w_off[l] = roff[o] + used_out;
      } else if (l > 0 && region[i] - used_in >= wb[l]) {
        w_off[l] = roff[i] + used_in;
      } else {
        return 0;
      }
    }
  }
  prm->region_off[0] = static_cast<int>(off0);
  prm->region_off[1] = static_cast<int>(off1);
  prm->in_off = static_cast<int>(off_in);
  prm->in_pitch = one0 ? pitch1(size0) : 0;
  prm->band_rows = static_cast<int>(rows);
  for (int l = 0; l < kMaxLayers; ++l) {
    prm->w_off[l] = l < n_layers ? static_cast<int>(w_off[l]) : 0;
    prm->w_bytes[l] = l < n_layers ? static_cast<int>(wb[l]) : 0;
    prm->resident[l] = l < n_layers ? resident[l] : 1;
  }
  return static_cast<int>(end + kReadSlack);
}

// The launcher's code paths (path_counts.cuh), in the order of their names.
enum MegaPath {
  kBulkImage, kPlainImage, kBands, kBandBytes, kAllResident, kPerImageWeights, kSecondImage,
  kOneChannelGroups, kOneChannelMiddle, kWgmmaN16, kWgmmaN32, kWgmmaN64, kWgmmaCpGeneric,
  kMegaPaths
};
constexpr const char* kMegaPathNames[kMegaPaths] = {
    "one-channel image by cp.async.bulk behind an mbarrier, prefetched",
    "one-channel image by plain loads", "multi-channel layer 0 in row bands",
    "row bands staged byte by byte",
    "all weights resident in shared memory", "weights copied per image",
    "persistent loop, a CTA's second image", "one-channel layer of more than 16 channels",
    "one-channel layer past layer 0", "wgmma m64n16k32", "wgmma m64n32k32", "wgmma m64n64k32",
    "wgmma layer past 64 input channels"};
PathCounts<kMegaPaths> g_mega_paths(kMegaPathNames);

void count_paths(const MegaParams& prm, int grid) {
  if (prm.ic[0] == 1) {
    g_mega_paths.add(prm.bulk_in ? kBulkImage : kPlainImage);
  } else {
    g_mega_paths.add(kBands);
    if (!prm.vec_band) g_mega_paths.add(kBandBytes);
  }
  bool all = true;
  for (int l = 0; l < prm.n_layers; ++l) all &= prm.resident[l] != 0;
  g_mega_paths.add(all ? kAllResident : kPerImageWeights);
  if (prm.batch > grid) g_mega_paths.add(kSecondImage);
  bool n16 = false, n32 = false, n64 = false, wide = false, groups = false, middle = false;
  for (int l = 0; l < prm.n_layers; ++l) {
    if (prm.ic[l] == 1) {
      groups |= prm.oc[l] > 16;
      middle |= l > 0;
    } else {
      const int nw = chunk_n(prm.oc[l]);
      n16 |= nw == 16;
      n32 |= nw == 32;
      n64 |= nw == 64;
      wide |= cpad_of(prm.ic[l]) > 64;
    }
  }
  if (groups) g_mega_paths.add(kOneChannelGroups);
  if (middle) g_mega_paths.add(kOneChannelMiddle);
  if (n16) g_mega_paths.add(kWgmmaN16);
  if (n32) g_mega_paths.add(kWgmmaN32);
  if (n64) g_mega_paths.add(kWgmmaN64);
  if (wide) g_mega_paths.add(kWgmmaCpGeneric);
}

// The persistent grid for `smem` bytes a CTA on `device`: CTAs per SM x
// SMs. The shared-memory limit is raised to the kernel's most once per
// device, and the answer kept per device and size: a launch then asks the
// runtime nothing but the launch.
cudaError_t grid_size(int device, int smem, int* grid) {
  struct Known {
    int device, smem, grid;
  };
  static std::mutex mu;
  static std::vector<Known> known;
  static std::vector<int> raised;
  std::lock_guard<std::mutex> lock(mu);
  for (const Known& k : known) {
    if (k.device == device && k.smem == smem) {
      *grid = k.grid;
      return cudaSuccess;
    }
  }
  cudaError_t err;
  if (std::find(raised.begin(), raised.end(), device) == raised.end()) {
    err = cudaFuncSetAttribute(mega_cnn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err != cudaSuccess) return err;
    raised.push_back(device);
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mega_cnn_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  known.push_back({device, smem, per_sm * sms});
  *grid = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

extern "C" const char* mega_cnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef MEGA_CNN_PHASE_CLOCKS
// The phase clocks summed over every CTA since the last call (8 entries),
// then zeroed.
extern "C" int mega_cnn_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return err;
  const unsigned long long zero[8] = {};
  return cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
}
#endif

// The shared-memory plan for a geometry, for ops/mega.py's mirror to be
// held against it: plan gets region_off[2], in_off, in_pitch, band_rows,
// then w_off, w_bytes and resident for kMaxLayers layers (17 ints).
// Returns the bytes, 0 if the kernel does not take the geometry.
extern "C" int mega_cnn_smem_plan(int n_layers, int size0, const int* ic, const int* oc,
                                  int* plan) {
  MegaParams prm;
  const int smem = smem_plan(n_layers, size0, ic, oc, &prm);
  if (smem == 0) return 0;
  int* p = plan;
  *p++ = prm.region_off[0];
  *p++ = prm.region_off[1];
  *p++ = prm.in_off;
  *p++ = prm.in_pitch;
  *p++ = prm.band_rows;
  for (int l = 0; l < kMaxLayers; ++l) p[l] = prm.w_off[l];
  for (int l = 0; l < kMaxLayers; ++l) p[kMaxLayers + l] = prm.w_bytes[l];
  for (int l = 0; l < kMaxLayers; ++l) p[2 * kMaxLayers + l] = prm.resident[l];
  return smem;
}

// The launcher's path counts in this process (path_counts.cuh).
extern "C" int mega_cnn_paths(const char** names, unsigned long long* hits, int n) {
  return g_mega_paths.read(names, hits, n);
}

// Launches the megakernel on `stream` of CUDA device `device` for a batch
// of (B, ic[0], size0, size0) u8 inputs. Pointers are device pointers:
// w0..w3 the per-layer weights packed by ops/mega.py's pack_weights,
// 16-byte aligned (w_l for l >= n_layers and unrequested outputs may be
// null); ic/oc are host arrays of n_layers entries. Returns a cudaError_t:
// cudaSuccess, cudaErrorInvalidValue for a geometry the kernel does not
// take, or the launch error. Neither synchronises nor allocates.
extern "C" int mega_cnn_forward(const void* images, const void* w0,
                                const void* w1, const void* w2, const void* w3,
                                const void* shifts, void* feats, void* bins,
                                void* twin, int batch, int n_layers, int size0,
                                const int* ic, const int* oc, int device,
                                void* stream) {
  MegaParams prm;
  const int smem = smem_plan(n_layers, size0, ic, oc, &prm);
  if (smem == 0 || smem > kMaxSmemBytes || batch < 0) return cudaErrorInvalidValue;
  if (bins != nullptr && (size0 >> n_layers) % 4 != 0) return cudaErrorInvalidValue;
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  for (int l = 0; l < n_layers; ++l) {
    if (ws[l] == nullptr || (reinterpret_cast<uintptr_t>(ws[l]) & 15) != 0) {
      return cudaErrorInvalidValue;
    }
  }
  if (batch == 0) return cudaSuccess;
  prm.images = static_cast<const uint8_t*>(images);
  for (int l = 0; l < kMaxLayers; ++l) {
    prm.weights[l] = static_cast<const uint8_t*>(ws[l]);
    prm.ic[l] = l < n_layers ? ic[l] : 0;
    prm.oc[l] = l < n_layers ? oc[l] : 0;
  }
  prm.shifts = static_cast<const int32_t*>(shifts);
  prm.feats = static_cast<uint8_t*>(feats);
  prm.bins = static_cast<float*>(bins);
  prm.twin = static_cast<__nv_bfloat16*>(twin);
  prm.batch = batch;
  prm.n_layers = n_layers;
  prm.size0 = size0;
  // one copy of a 16-byte multiple from a 16-byte aligned batch
  prm.bulk_in = ic[0] == 1 && size0 % 16 == 0 &&
                (reinterpret_cast<uintptr_t>(images) & 15) == 0;
  prm.vec_band = size0 % 4 == 0 && (reinterpret_cast<uintptr_t>(images) & 3) == 0;
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int grid = 0;
  err = grid_size(device, smem, &grid);
  if (err != cudaSuccess) return err;
  grid = static_cast<int>(std::min<long long>(batch, grid));
  mega_cnn_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(prm);
  err = cudaGetLastError();
  if (err == cudaSuccess) count_paths(prm, grid);
  return err;
}
