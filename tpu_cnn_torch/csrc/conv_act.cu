// One contract conv for NVIDIA Hopper (sm_90a), without the pool or with it.
//
// Replaces the TPU kernel tpu_cnn/ops/pallas_int8.py:_conv_mxu (body
// _kernel_body_mxu), the per-layer kernel of the `pallas` and `hybrid`
// backends. For uint8 activations and int8 weights:
//
//     (B, ic, H, W) u8 -> SAME conv3x3 (zero halo), exact int32 accumulate
//     -> >> shift[layer] (arithmetic) -> clip 0..255 -> (B, oc, H, W) u8
//
// conv_act_forward is that function for any rectangle. In the JAX package
// the kernel is only ever followed by the 2x2 pool (XLA glue), so
// conv_act_pool_forward is the function the backends' users see, the pool
// done in registers: (B, oc, H/2, W/2) u8, H and W even. Both are the layer
// kernel of conv_layer.cuh (its design note), unpooled and pooled, on the
// weights packed by ops/mega.py (pack_one_channel for one input channel,
// else pack_fragments). Geometry and the shift (read from the device shift
// vector at index `layer`) are runtime arguments: one build serves every
// layer, and a shift change rebuilds nothing.
//
// What bounds it on an H100: HBM. lyr3-std's three layers move 881 MB per
// batch of 1536 unpooled (0.263 ms) and 352 MB pooled (0.105 ms), against
// 61.6 G MACs (0.062 ms on the int8 tensor cores). The design: implicit
// GEMMs on mma.sync u8 x s8 (the one-channel first layer recast so that
// every K byte is a pixel), cp.async staging that overlaps the MMAs, and
// 16-byte NCHW stores; pooled, the unpooled map never reaches HBM. The
// TPU kernel's zero-point staging (a ^ 0x80 and the 128 * sum(k)
// correction), block-diagonal weight packing, batch-tile VMEM model,
// pad-to-4 batch, lane wrap masks, < 4-row XLA reroute and row bands were
// Mosaic's; none exists here.

#include "conv_layer.cuh"

extern "C" const char* conv_act_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The layer launcher's path counts in this process (path_counts.cuh).
extern "C" int conv_act_paths(const char** names, unsigned long long* hits, int n) {
  return g_layer_paths.read(names, hits, n);
}

// Launches one conv on `stream` of CUDA device `device`: x (B, ic, H, W)
// u8, w the packed weights of an (oc, ic, 3, 3) s8 kernel, shifts a device
// int32 vector read at `layer`, out (B, oc, H, W) u8, all device pointers.
// Returns a cudaError_t: cudaSuccess, cudaErrorInvalidValue for a geometry
// the kernel does not take, or the launch error. Neither synchronises nor
// allocates.
extern "C" int conv_act_forward(const void* x, const void* w, const void* shifts, int layer,
                                void* out, int batch, int ic, int oc, int height, int width,
                                int device, void* stream) {
  return launch_layer<false>(x, w, shifts, layer, out, batch, ic, oc, height, width, device,
                             stream);
}

// The same conv followed by the 2x2 stride-2 max pool: out (B, oc, H/2,
// W/2) u8; H and W even.
extern "C" int conv_act_pool_forward(const void* x, const void* w, const void* shifts,
                                     int layer, void* out, int batch, int ic, int oc,
                                     int height, int width, int device, void* stream) {
  return launch_layer<true>(x, w, shifts, layer, out, batch, ic, oc, height, width, device,
                            stream);
}
