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
// Design: one CTA per image; every layer is an implicit GEMM on
// mma.sync.m16n8k32 u8 x s8 -> s32 (exact integer sums, so the contract
// holds bit for bit). M is the layer's pre-pool pixels, N its output
// channels, K = 9 taps x the input channels, tap-major.
//   - Activations live in shared memory channels-last with a 1-pixel zero
//     halo, each pixel's channels padded to a power of two >= 16 (cpad), so
//     one 16-byte row is one pixel's 16 channels of one tap: ldmatrix.x4
//     with per-lane row addresses is the im2col, with no bounds checks.
//     The 16-byte chunk index is XOR-swizzled with the pixel index, which
//     keeps the eight rows of one ldmatrix phase on distinct banks at a 32-,
//     64- or 128-byte pixel stride. A one-channel map (the net's input) is
//     kept one byte a pixel and its A fragments are gathered byte by byte:
//     K = the 9 taps padded to 32 with zero weights.
//   - An M tile is 2 rows x 8 columns of pixels (rows 0-7 the upper row), so
//     a 2x2 pooling window lies in one lane's C fragment (rows g, g+8) and
//     its lane ^ 4 neighbour: the epilogue shifts, clips and pools in
//     registers with one __shfl_xor_sync and writes pooled u8, channels-last
//     for the next layer or NCHW for the final map.
//   - Weights come packed by ops/mega.py once per weight set: per K step of
//     32 and N tile of 8, each lane's two B registers as one 8-byte word,
//     read with one coalesced __ldg (L1/L2: every CTA reads the same
//     weights). Padded K rows and N columns hold zero weights, so padded
//     channels and the tenth tap of a 16-channel layer multiply by zero.
//   - Layer 0 reads global memory: its input is staged in row bands into
//     the second shared region (whole for a one-channel image; 32 rows of
//     lyr4-wide's 16 x 128^2 tail input), then runs like the others. The
//     layers ping-pong between the two regions. lyr3-std: 69,696 (L0 out,
//     66^2 x 16) + 36,992 (L1 out, 34^2 x 32) bytes, two CTAs per SM
//     (256 threads each); lyr4-wide's tail: 139,392 + 73,984, one CTA of 512.
//
//   - A warp takes 4 M tiles side by side per work item: one B fragment
//     read feeds 4 MMAs and the 4 chains overlap.
//
// What bounds it on an H100: its bound is the MACs (lyr3-std moves ~52 KB
// per image for 40 M MACs: 62 us per batch of 1536 at the tensor cores'
// 989 T MAC/s, against ~25 us of HBM), and it runs at ~7% of that bound on
// lyr3-std and ~11% on lyr4-wide's tail. What holds it back: one CTA per
// image with a __syncthreads between layers (and per band), 16 warps per SM,
// B fragments read from L1/L2 for every work item (64 bytes per MMA), the
// ldmatrix gathers, and the one-channel first layer, whose byte gathers and
// epilogue cost as much as its 4 MMAs per M tile (K 9 of 32): lyr3-std's L0
// alone takes over half of the net's time. Later work: several images per
// CTA, B in registers across more M tiles, wgmma with TMA-fed tiles. The TPU
// kernel's phase split, lane rolls, block-diagonal batch packing and
// zero-point staging were Mosaic workarounds and have no counterpart here.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 4;
constexpr int kMaxSmemBytes = 232448;  // opt-in limit of one block on sm_90
constexpr int kSmemPerSm = 233472;     // shared memory an SM splits among blocks
constexpr int kSmemPerBlock = 1024;    // reserved by the runtime per block
// M tiles per warp work item: 4 ran both lyr3-std and lyr4-wide's tail
// faster than 2 on an H100, though ptxas then spills ~150 bytes (chip_smoke
// phase 2 prints it); 8 on the one-byte layer gained nothing.
constexpr int kMTiles = 4;
// threads of a CTA when two CTAs fit an SM: 384 leaves 80 registers a
// thread and spills kilobytes, 512 would leave 64
constexpr int kThreadsTwoPerSm = 256;

struct MegaParams {
  const uint8_t* images;               // (B, ic0, S, S)
  const uint2* weights[kMaxLayers];    // per layer, packed by ops/mega.py
  const int32_t* shifts;               // (L,)
  uint8_t* feats;                      // optional outputs, nullptr = skip
  float* bins;
  __nv_bfloat16* twin;
  int n_layers;
  int size0;
  int ic[kMaxLayers];
  int oc[kMaxLayers];
  int region0_bytes;                   // ping-pong split of shared memory
  int band_rows;                       // image rows of layer 0 per band
};

// Bytes one pixel of a c-channel map takes in shared memory.
__host__ __device__ inline int cpad_of(int c) {
  if (c == 1) return 1;
  int p = 16;
  while (p < c) p <<= 1;
  return p;
}

// The 16-byte chunk a pixel's channel chunk c sits at: c ^ swz(pixel).
// cpp = chunks per pixel (1, 2, 4, 8 or more).
__device__ __forceinline__ int swz(int pixel, int cpp) {
  return cpp >= 8 ? (pixel & 7)
       : cpp == 4 ? ((pixel >> 1) & 3)
       : cpp == 2 ? ((pixel >> 2) & 1) : 0;
}

__device__ __forceinline__ void mma_u8s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// One contract layer as an implicit GEMM. `in` holds `2 * n_prow + 2` rows
// of the S x S input with its halo (pitch S + 2 pixels; row 0 is the halo
// or image row above the first); the pooled rows go to out rows py0.. .
// CPP: chunks of 16 channels per input pixel (1, 2, 4), 0 for a one-byte
// pixel, -1 for cpp_rt (8 or more). A warp's work item is kMTiles M tiles
// side by side (one B fragment feeds kMTiles MMAs, and their chains
// overlap) times NT N tiles of 8.
template <int CPP, int NT>
__device__ __forceinline__ void mma_layer(const uint8_t* __restrict__ in, int S,
                                          int n_prow, int py0, int cpp_rt,
                                          const uint2* __restrict__ w, int oc,
                                          int shift, uint8_t* __restrict__ out,
                                          bool final_layer) {
  constexpr int MB = kMTiles;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int pitch = S + 2;
  const int P = S / 2;
  const int cpp = CPP > 0 ? CPP : CPP < 0 ? cpp_rt : 0;
  const int pb_in = CPP == 0 ? 1 : 16 * cpp;
  const int n_ks = CPP == 0 ? 1 : CPP == 1 ? 5 : 9 * cpp / 2;
  const int ntiles = (oc + 7) >> 3;
  const int n_groups = (ntiles + NT - 1) / NT;
  const int ncg = (S + 8 * MB - 1) / (8 * MB);  // groups of MB x 8 columns
  const int n_mt = n_prow * ncg;
  const int g = lane >> 2, t4 = lane & 3;
  const int pb_out = final_layer ? 0 : cpad_of(oc);

  // one-byte input: this lane's taps 4 t4 .. 4 t4 + 3 of K (9 real)
  int toff[4];
  bool tval[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tap = 4 * t4 + j;
    tval[j] = tap < 9;
    toff[j] = tval[j] ? (tap / 3) * pitch + tap % 3 : 0;
  }
  // ldmatrix: this lane addresses row (lane & 7) + (lane & 8) of the M
  // tile (pixel column lane & 7 of its upper or lower row) at K chunk
  // lane >> 4 of the step
  const int ldy = (lane >> 3) & 1, lcol = lane & 7, lh = lane >> 4;
  const uint32_t in_s = static_cast<uint32_t>(__cvta_generic_to_shared(in));

  for (int item = warp; item < n_mt * n_groups; item += n_warps) {
    const int ng = item / n_mt;
    const int mt = item - ng * n_mt;
    const int pr = mt / ncg;
    const int cg0 = (mt - pr * ncg) * MB;  // first column group of 8
    const int t0 = ng * NT;
    int acc[MB][NT][4];
#pragma unroll
    for (int m = 0; m < MB; ++m) {
#pragma unroll
      for (int i = 0; i < NT; ++i) acc[m][i][0] = acc[m][i][1] = acc[m][i][2] = acc[m][i][3] = 0;
    }

    if constexpr (CPP == 0) {
      uint2 b[NT];
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        b[i] = t0 + i < ntiles ? __ldg(w + (t0 + i) * 32 + lane) : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        // past the edge: read, never stored
        const int x = min(8 * (cg0 + m) + g, S - 1);
        const int base = 2 * pr * pitch + x;
        uint32_t a0 = 0, a1 = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t v0 = tval[j] ? in[base + toff[j]] : 0u;
          const uint32_t v1 = tval[j] ? in[base + pitch + toff[j]] : 0u;
          a0 |= v0 << (8 * j);
          a1 |= v1 << (8 * j);
        }
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (t0 + i < ntiles) mma_u8s8(acc[m][i], a0, a1, 0u, 0u, b[i].x, b[i].y);
        }
      }
    } else {
      int p0[MB];
#pragma unroll
      for (int m = 0; m < MB; ++m) {
        p0[m] = (2 * pr + ldy) * pitch + min(8 * (cg0 + m) + lcol, S - 1);
      }
#pragma unroll(CPP == 1 ? 5 : CPP == 2 ? 3 : 2)
      for (int ks = 0; ks < n_ks; ++ks) {
        int tap, c16;
        if (CPP == 1) {
          tap = min(2 * ks + lh, 8);  // the tenth tap: zero weights
          c16 = 0;
        } else {
          tap = (2 * ks) / cpp;
          c16 = (2 * ks) % cpp + lh;
        }
        const int ky = tap / 3;
        const int toffs = ky * pitch + (tap - 3 * ky);
        uint32_t a[MB][4];
#pragma unroll
        for (int m = 0; m < MB; ++m) {
          const int p = p0[m] + toffs;
          ldmatrix_x4(a[m], in_s + p * pb_in + 16 * (c16 ^ swz(p, cpp)));
        }
        const uint2* wk = w + ks * ntiles * 32 + lane;
#pragma unroll
        for (int i = 0; i < NT; ++i) {
          if (t0 + i < ntiles) {
            const uint2 b = __ldg(wk + (t0 + i) * 32);
#pragma unroll
            for (int m = 0; m < MB; ++m) {
              mma_u8s8(acc[m][i], a[m][0], a[m][1], a[m][2], a[m][3], b.x, b.y);
            }
          }
        }
      }
    }

    // epilogue: rows g (upper) and g + 8 (lower) of columns 2 t4, 2 t4 + 1,
    // then the pixel column g ^ 1 from lane ^ 4; >> on int is arithmetic
    const int py = py0 + pr;
#pragma unroll
    for (int m = 0; m < MB; ++m) {
      const int px = 4 * (cg0 + m) + (g >> 1);
      const bool store = (g & 1) == 0 && px < P;
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (t0 + i >= ntiles) continue;  // warp-uniform
        int m0 = max(acc[m][i][0], acc[m][i][2]);
        int m1 = max(acc[m][i][1], acc[m][i][3]);
        m0 = max(m0, __shfl_xor_sync(0xffffffffu, m0, 4));
        m1 = max(m1, __shfl_xor_sync(0xffffffffu, m1, 4));
        if (!store) continue;
        const int n0 = 8 * (t0 + i) + 2 * t4;
        const int v0 = min(max(m0 >> shift, 0), 255);
        const int v1 = min(max(m1 >> shift, 0), 255);
        if (final_layer) {
          if (n0 < oc) out[(n0 * P + py) * P + px] = static_cast<uint8_t>(v0);
          if (n0 + 1 < oc) out[((n0 + 1) * P + py) * P + px] = static_cast<uint8_t>(v1);
        } else {
          const int po = (py + 1) * (P + 2) + px + 1;
          if (pb_out == 1) {
            if (n0 == 0) out[po] = static_cast<uint8_t>(v0);
          } else {
            const int off = po * pb_out + 16 * ((n0 >> 4) ^ swz(po, pb_out >> 4)) + (n0 & 15);
            *reinterpret_cast<uint16_t*>(out + off) = static_cast<uint16_t>(v0 | (v1 << 8));
          }
        }
      }
    }
  }
}

template <int CPP>
__device__ __forceinline__ void mma_layer_nt(const uint8_t* in, int S, int n_prow,
                                             int py0, int cpp_rt, const uint2* w,
                                             int oc, int shift, uint8_t* out,
                                             bool final_layer) {
  if (oc <= 16) {
    mma_layer<CPP, 2>(in, S, n_prow, py0, cpp_rt, w, oc, shift, out, final_layer);
  } else {
    mma_layer<CPP, 4>(in, S, n_prow, py0, cpp_rt, w, oc, shift, out, final_layer);
  }
}

// Layer l from `in` (pixel bytes cpad_of(ic)) into `out`.
__device__ void run_layer(const uint8_t* in, int ic, int S, int n_prow, int py0,
                          const uint2* w, int oc, int shift, uint8_t* out,
                          bool final_layer) {
  const int pb = cpad_of(ic);
  switch (pb) {
    case 1:
      mma_layer_nt<0>(in, S, n_prow, py0, 0, w, oc, shift, out, final_layer);
      break;
    case 16:
      mma_layer_nt<1>(in, S, n_prow, py0, 1, w, oc, shift, out, final_layer);
      break;
    case 32:
      mma_layer_nt<2>(in, S, n_prow, py0, 2, w, oc, shift, out, final_layer);
      break;
    case 64:
      mma_layer_nt<4>(in, S, n_prow, py0, 4, w, oc, shift, out, final_layer);
      break;
    default:
      mma_layer_nt<-1>(in, S, n_prow, py0, pb >> 4, w, oc, shift, out, final_layer);
  }
}

// Zero the 1-pixel ring of a (P + 2)^2 map of pb-byte pixels.
__device__ void zero_halo(uint8_t* map, int P, int pb) {
  const int pitch = P + 2;
  const int ring = 2 * pitch + 2 * P;
  const int chunks = pb >= 16 ? pb / 16 : 1;
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
    if (pb >= 16) {
      *reinterpret_cast<uint4*>(map + pixel * pb + 16 * c) = make_uint4(0, 0, 0, 0);
    } else {
      map[pixel] = 0;
    }
  }
}

// Band rows (image rows y0 - 1 .. y0 + rows - 2) of the (ic, S, S) NCHW
// image into `band`, channels-last with pb-byte pixels (zero outside the
// image and in the padded channels).
__device__ void stage_band(const uint8_t* __restrict__ img, int ic, int S, int y0,
                           int rows, uint8_t* __restrict__ band, int pb) {
  const int pitch = S + 2;
  if (pb == 1 && S % 4 == 0 && (reinterpret_cast<uintptr_t>(img) & 3) == 0) {
    // whole 4-byte words of the image rows (coalesced), then the halo ring
    const int wpr = S / 4;  // words per row
    const uint32_t* src = reinterpret_cast<const uint32_t*>(img);
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * wpr; idx += blockDim.x) {
      const int by = idx / wpr;
      const int y = y0 - 1 + by, xw = idx - by * wpr;
      const uint32_t v = static_cast<unsigned>(y) < static_cast<unsigned>(S)
                             ? __ldg(src + y * wpr + xw) : 0u;
      uint8_t* dst = band + by * pitch + 4 * xw + 1;
      dst[0] = v & 0xff;
      dst[1] = (v >> 8) & 0xff;
      dst[2] = (v >> 16) & 0xff;
      dst[3] = v >> 24;
    }
    for (int by = threadIdx.x; by < rows; by += blockDim.x) {
      band[by * pitch] = 0;
      band[by * pitch + S + 1] = 0;
    }
    return;
  }
  if (pb == 1) {
    for (int idx = threadIdx.x; idx < rows * pitch; idx += blockDim.x) {
      const int by = idx / pitch;
      const int y = y0 - 1 + by, x = idx - by * pitch - 1;
      const bool ok = static_cast<unsigned>(y) < static_cast<unsigned>(S) &&
                      static_cast<unsigned>(x) < static_cast<unsigned>(S);
      band[idx] = ok ? img[y * S + x] : 0;
    }
    return;
  }
  const int cpp = pb / 16;
  const int plane = S * S;
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

template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 512 ? 1 : 2) mega_cnn_kernel(MegaParams prm) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* const region0 = smem;
  uint8_t* const region1 = smem + prm.region0_bytes;
  const int b = blockIdx.x;
  const int n = prm.n_layers;
  int size = prm.size0;

  // layer 0: the input in row bands, staged into region 1
  {
    const uint8_t* img =
        prm.images + static_cast<size_t>(b) * prm.ic[0] * prm.size0 * prm.size0;
    const bool last = n == 1;
    if (!last) zero_halo(region0, size / 2, cpad_of(prm.oc[0]));
    const int shift = min(max(prm.shifts[0], 0), 31);
    for (int y0 = 0; y0 < size; y0 += prm.band_rows) {
      const int rows = min(prm.band_rows, size - y0);
      if (y0 > 0) __syncthreads();  // the previous band is consumed
      stage_band(img, prm.ic[0], size, y0, rows + 2, region1, cpad_of(prm.ic[0]));
      __syncthreads();
      run_layer(region1, prm.ic[0], size, rows / 2, y0 / 2, prm.weights[0],
                prm.oc[0], shift, region0, last);
    }
    __syncthreads();
    size /= 2;
  }
  for (int l = 1; l < n; ++l) {
    const bool last = l == n - 1;
    uint8_t* out = (l & 1) ? region1 : region0;
    if (!last) zero_halo(out, size / 2, cpad_of(prm.oc[l]));
    // a shift of 32 or more is undefined in C++; 31 gives the same 0 / -1
    const int shift = min(max(prm.shifts[l], 0), 31);
    run_layer((l & 1) ? region0 : region1, prm.ic[l], size, size / 2, 0, prm.weights[l],
              prm.oc[l], shift, out, last);
    __syncthreads();
    size /= 2;
  }

  const uint8_t* cur = ((n - 1) & 1) ? region1 : region0;
  const int oc = prm.oc[n - 1];
  const int pp = size * size;
  const int total = oc * pp;
  if (prm.feats != nullptr) {
    uint8_t* f = prm.feats + static_cast<size_t>(b) * total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) f[i] = cur[i];
  }
  if (prm.twin != nullptr) {
    __nv_bfloat16* t = prm.twin + static_cast<size_t>(b) * total;
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      t[i] = __float2bfloat16_rn(static_cast<float>(cur[i]));
    }
  }
  if (prm.bins != nullptr) {
    const int npx = size / 4;
    float* bo = prm.bins + static_cast<size_t>(b) * oc * 16;
    for (int j = threadIdx.x; j < oc * 16; j += blockDim.x) {
      const int o = j >> 4;
      const int by = (j & 15) >> 2;
      const int bx = j & 3;
      const uint8_t* plane = cur + o * pp + (by * npx) * size + bx * npx;
      int sum = 0;
      for (int y = 0; y < npx; ++y) {
        for (int x = 0; x < npx; ++x) sum += plane[y * size + x];
      }
      // the same order as the TPU kernel: exact integer sum, / npx^2, / 255
      bo[j] = static_cast<float>(sum) / static_cast<float>(npx * npx) / 255.0f;
    }
  }
}

// Shared-memory bytes the kernel needs for a geometry (ops/mega.py's
// mega_layout mirrors this): layer l's output goes to region l & 1, as a
// channels-last map with its halo, or NCHW for the final layer; layer 0's
// input bands go to region 1, the whole image when it fits, else as many
// rows as region 1 holds (at least 2). 0 if the kernel does not take the
// geometry.
int smem_bytes(int n_layers, int size0, const int* ic, const int* oc,
               int* region0_bytes, int* band_rows) {
  if (n_layers < 1 || n_layers > kMaxLayers || size0 <= 0) return 0;
  if (size0 % (1 << n_layers) != 0) return 0;
  // the first layer indexes its input planes in int
  if (ic[0] <= 0 || static_cast<long long>(ic[0]) * size0 * size0 > INT32_MAX) return 0;
  long long region[2] = {0, 0};
  int size = size0;
  for (int l = 0; l < n_layers; ++l) {
    if (ic[l] <= 0 || oc[l] <= 0) return 0;
    if (l > 0 && ic[l] != oc[l - 1]) return 0;
    const long long p = size / 2;
    const long long bytes = l == n_layers - 1 ? oc[l] * p * p
                                              : (p + 2) * (p + 2) * cpad_of(oc[l]);
    region[l & 1] = std::max(region[l & 1], bytes);
    size /= 2;
  }
  region[0] = (region[0] + 15) / 16 * 16;
  const long long row = static_cast<long long>(size0 + 2) * cpad_of(ic[0]);
  long long rows;
  if (region[0] + std::max(region[1], (size0 + 2) * row) <= kMaxSmemBytes) {
    rows = size0;
  } else {
    rows = std::min<long long>(size0, region[1] / row - 2) & ~1LL;
    if (rows < 2) rows = 2;
  }
  region[1] = std::max(region[1], (rows + 2) * row);
  if (region[0] + region[1] > INT_MAX) return 0;
  *region0_bytes = static_cast<int>(region[0]);
  *band_rows = static_cast<int>(rows);
  return static_cast<int>(region[0] + region[1]);
}

template <int kThreads>
cudaError_t launch(const MegaParams& prm, int batch, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mega_cnn_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  mega_cnn_kernel<kThreads><<<batch, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* mega_cnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches the megakernel on `stream` of CUDA device `device` for a batch
// of (B, ic[0], size0, size0) u8 inputs. Pointers are device pointers:
// w0..w3 the per-layer weights packed by ops/mega.py's pack_weights (w_l
// for l >= n_layers and unrequested outputs may be null); ic/oc are host
// arrays of n_layers entries. Returns a cudaError_t: cudaSuccess,
// cudaErrorInvalidValue for a geometry the kernel does not take, or the
// launch error. Neither synchronises nor allocates.
extern "C" int mega_cnn_forward(const void* images, const void* w0,
                                const void* w1, const void* w2, const void* w3,
                                const void* shifts, void* feats, void* bins,
                                void* twin, int batch, int n_layers, int size0,
                                const int* ic, const int* oc, int device,
                                void* stream) {
  MegaParams prm;
  const int smem = smem_bytes(n_layers, size0, ic, oc, &prm.region0_bytes,
                              &prm.band_rows);
  if (smem == 0 || smem > kMaxSmemBytes || batch < 0) return cudaErrorInvalidValue;
  if (bins != nullptr && (size0 >> n_layers) % 4 != 0) return cudaErrorInvalidValue;
  if (batch == 0) return cudaSuccess;
  prm.images = static_cast<const uint8_t*>(images);
  const void* ws[kMaxLayers] = {w0, w1, w2, w3};
  for (int l = 0; l < kMaxLayers; ++l) {
    prm.weights[l] = static_cast<const uint2*>(ws[l]);
    prm.ic[l] = l < n_layers ? ic[l] : 0;
    prm.oc[l] = l < n_layers ? oc[l] : 0;
  }
  prm.shifts = static_cast<const int32_t*>(shifts);
  prm.feats = static_cast<uint8_t*>(feats);
  prm.bins = static_cast<float*>(bins);
  prm.twin = static_cast<__nv_bfloat16*>(twin);
  prm.n_layers = n_layers;
  prm.size0 = size0;
  // this library has its own CUDA runtime: select the tensors' device in it
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // two CTAs per SM where their shared memory allows (lyr3-std), else one
  // CTA of twice the warps (lyr4-wide's tail)
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return 2 * (smem + kSmemPerBlock) <= kSmemPerSm
             ? launch<kThreadsTwoPerSm>(prm, batch, smem, s)
             : launch<512>(prm, batch, smem, s);
}
