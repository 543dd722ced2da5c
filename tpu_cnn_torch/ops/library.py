"""The megakernel and the layer kernel as ``torch.library`` custom ops.

``torch.export`` cannot trace the kernels' wrappers: they launch through
ctypes on ``data_ptr()``. These two ops are the door an exported program
(``apps.export_model``) goes through instead:

  tcnn::mega_cnn(images, kernels, packed, shifts, with_feats, with_bins,
                 with_twin) -> Tensor[]
      one megakernel (``csrc/mega_cnn.cu``, the port of
      ``cnn_forward_polyphase_pallas``): the whole net, or the tail of the
      chained plan, which must fit one CTA (``mega.mega_plan`` 0); the
      requested outputs in (feats, bins, twin) order
  tcnn::conv_pool_layer(x, kernel, packed, shifts, layer) -> Tensor
      one head layer of the chained plan (``csrc/conv_pool_layer.cu``, the
      port of ``conv_pool_layer_poly``/``_phase``)

Each takes the weights both raw (the shapes, and the plain versions) and
as ``mega.pack_plan`` packs them (the kernels read those), and the (L,)
int32 shift vector as a tensor, so that the register semantics survive
export. Each implementation is the existing wrapper, which picks by the
tensors' device: on CUDA tensors it launches the kernel and adds one to
its module's ``launches``, on CPU tensors it runs the plain version
(``mega_reference``, ``conv_pool_reference``) and holds the shifts to
0..31. The fake implementations give the output shapes and dtypes.

The eager engine (``engine.cuda``) calls the wrappers directly, not these
ops. This module imports no ``models``, ``engine`` or ``apps`` module, so
that a host that serves a deployable loads it without the code that
builds the model.
"""

from __future__ import annotations

import torch

from tpu_cnn_torch.ops import conv_pool, mega

DEVICES = ("cpu", "cuda")


@torch.library.custom_op("tcnn::mega_cnn", mutates_args=(), device_types=DEVICES)
def mega_cnn(images: torch.Tensor, kernels: list[torch.Tensor],
             packed: list[torch.Tensor], shifts: torch.Tensor,
             with_feats: bool, with_bins: bool,
             with_twin: bool) -> list[torch.Tensor]:
    cfgs = mega._layer_configs(kernels, images.shape[-1])
    if mega.mega_plan(cfgs) != 0:
        raise ValueError(f"tcnn::mega_cnn runs one megakernel: {cfgs} does "
                         f"not fit one CTA")
    out = mega.cnn_forward_mega(images, kernels, shifts, with_feats=with_feats,
                                with_bins=with_bins, with_twin=with_twin,
                                packed=packed)
    return list(out) if isinstance(out, tuple) else [out]


@mega_cnn.register_fake
def _mega_cnn_fake(images, kernels, packed, shifts, with_feats, with_bins,
                   with_twin):
    b, s = images.shape[0], images.shape[-1]
    oc, p = kernels[-1].shape[0], s >> len(kernels)
    out = []
    if with_feats:
        out.append(images.new_empty((b, oc, p * p), dtype=torch.uint8))
    if with_bins:
        out.append(images.new_empty((b, oc * 16), dtype=torch.float32))
    if with_twin:
        out.append(images.new_empty((b, oc, p * p), dtype=torch.bfloat16))
    return out


@torch.library.custom_op("tcnn::conv_pool_layer", mutates_args=(),
                         device_types=DEVICES)
def conv_pool_layer(x: torch.Tensor, kernel: torch.Tensor,
                    packed: torch.Tensor, shifts: torch.Tensor,
                    layer: int) -> torch.Tensor:
    return conv_pool.conv_pool_layer(x, kernel, shifts, layer, packed=packed)


@conv_pool_layer.register_fake
def _conv_pool_layer_fake(x, kernel, packed, shifts, layer):
    b, _, s, _ = x.shape
    return x.new_empty((b, kernel.shape[0], s // 2, s // 2))
