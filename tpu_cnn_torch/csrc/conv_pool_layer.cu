// One contract layer for NVIDIA Hopper (sm_90a): the chained plan's head.
//
// Replaces two TPU kernels that compute the same function:
//   tpu_cnn/ops/pallas_poly.py:conv_pool_layer_poly   (body _single_layer_body)
//   tpu_cnn/ops/pallas_poly.py:conv_pool_layer_phase  (body _phase_layer_body)
// The second only writes the first's output in the phase-split row layout
// of the TPU tail kernel; the Hopper tail (mega_cnn.cu) reads NCHW, so one
// kernel and one layout serve both. For uint8 activations and int8 weights:
//
//     (B, ic, S, S) u8 -> SAME conv3x3, integer accumulate
//     -> >> shift[layer] (arithmetic) -> clip 0..255 -> 2x2 stride-2 max pool
//     -> (B, oc, S/2, S/2) u8
//
// It is the pooled layer kernel of conv_layer.cuh (its design note), on the
// weights packed by ops/mega.py (pack_one_channel for one input channel,
// else pack_fragments). Geometry and the shift (read from the device shift
// vector at index `layer`) are runtime arguments: one build serves every
// layer, and a shift change rebuilds nothing.
//
// What bounds it on an H100: HBM. lyr4-wide's L0 (1 -> 16 at 256^2) reads
// 64 KB and writes 256 KB per image (0.150 ms per batch of 1536) for 9.4 M
// MACs (0.015 ms). The design: the one-channel layer recast so that every
// MMA K byte is a pixel (the 4x4 patch under a 2x2 quad, the four
// positions in one lane's registers, so the pool is a register max),
// cp.async staging that overlaps the MMAs, and 16-byte NCHW stores. The
// TPU kernels' lane chunking (n_sub), 128-lane alignment, >= 4-row rule,
// zero-point staging and phase-split layouts were Mosaic's limits; none
// exists here.

#include "conv_layer.cuh"

extern "C" const char* conv_pool_layer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The layer launcher's path counts in this process (path_counts.cuh).
extern "C" int conv_pool_layer_paths(const char** names, unsigned long long* hits, int n) {
  return g_layer_paths.read(names, hits, n);
}

// Launches one layer on `stream` of CUDA device `device`: x (B, ic, S, S)
// u8, w the packed weights of an (oc, ic, 3, 3) s8 kernel, shifts a device
// int32 vector read at `layer`, out (B, oc, S/2, S/2) u8, all device
// pointers. Returns a cudaError_t: cudaSuccess, cudaErrorInvalidValue for a
// geometry the kernel does not take, or the launch error. Neither
// synchronises nor allocates.
extern "C" int conv_pool_layer_forward(const void* x, const void* w, const void* shifts,
                                       int layer, void* out, int batch, int ic, int oc,
                                       int size, int device, void* stream) {
  return launch_layer<true>(x, w, shifts, layer, out, batch, ic, oc, size, size, device,
                            stream);
}
