"""The per-layer backends: the conv kernel, unpooled and pooled, and the
nets built on it.

Port of ``tpu_cnn.ops.pallas_int8``. ``conv_act`` is the port of its one
Pallas kernel, ``_conv_mxu``: a hand-written CUDA kernel,
``csrc/conv_act.cu`` (the layer kernel of ``csrc/conv_layer.cuh`` on
Hopper's int8 tensor cores), that computes

    (B, ic, H, W) u8 -> conv3x3 SAME -> >> shift -> clip 0..255
    -> (B, oc, H, W) u8                  # pre-pool: no pool

for any rectangle. In the JAX package the kernel is only ever followed by
the 2x2 pool, as XLA glue; ``fused_conv_layer`` is that function, and on a
CUDA tensor it launches the same kernel with the pool inside
(``conv_act_pool_forward``), so the unpooled map never reaches device
memory. ``cnn_forward_pallas`` runs every layer through it and
``cnn_forward_hybrid`` only layer 0, the deeper layers being the plain
contract layer (``quant.fixed_point_conv_layer``: unfold + an f32 matmul,
never cuDNN), as in the JAX package. The kernel reads weights packed by
``mega.pack_layer``: made once by their owner (``CUDAEngine``) and passed
as ``packed``, or here on every call.

What is not carried over: the TPU kernel's zero-point staging,
block-diagonal weight packing, batch-tile model, pad-to-4 batch, and the
reroutes of small tiles to an XLA conv or to row bands were Mosaic's. Here
the kernel runs on every layer, lyr4-wide's 1 -> 16 L0 at 256^2 included.

On a CUDA tensor ``conv_act`` and ``fused_conv_layer`` launch the kernel;
on a CPU tensor they run the plain versions, ``conv_act_reference`` and
``maxpool2x2`` of it. Any other device, or a CUDA call the kernel cannot
take, raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tpu_cnn_torch.ops import _build, conv_stream, mega, quant

# kernel launches made by this wrapper in this process
launches = 0


def conv_act_reference(x: torch.Tensor, kernel: torch.Tensor,
                       shifts: torch.Tensor, layer: int, *,
                       compute_dtype: str = "float32") -> torch.Tensor:
    """The kernel's plain version: ``quant.conv3x3_same`` (f32 ``unfold`` +
    matmul, or the int32 tap loop), then ``shift_relu_clamp`` at
    ``shifts[layer]`` -> (B, oc, H, W) u8."""
    acc = quant.conv3x3_same(x, kernel, compute_dtype)
    return quant.shift_relu_clamp(acc, shifts[layer]).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_act")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.conv_act_forward, lib.conv_act_pool_forward):
        fn.argtypes = [p, p, p, i, p, i, i, i, i, i, i, p]
        fn.restype = i
    lib.conv_act_pool_bias_forward.argtypes = [p, p, p, p, i, p, i, i, i, i, i, i, p]
    lib.conv_act_pool_bias_forward.restype = i
    lib.conv_act_layer_smem.argtypes = [i, i, i]
    lib.conv_act_layer_smem.restype = i
    lib.conv_act_error_string.argtypes = [i]
    lib.conv_act_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x, kernel, shifts, layer, packed):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (B, ic, H, W) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    ic = x.shape[1]
    if min(x.shape[2:]) < 1:
        raise ValueError(f"need H, W >= 1, got {tuple(x.shape[2:])}")
    if (kernel.dtype != torch.int8 or kernel.dim() != 4
            or kernel.shape[1] != ic or tuple(kernel.shape[2:]) != (3, 3)):
        raise ValueError(f"kernel must be (oc, {ic}, 3, 3) int8, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise ValueError(f"shifts must be a 1-D int32 vector, got "
                         f"{tuple(shifts.shape)} {shifts.dtype}")
    if not 0 <= layer < shifts.shape[0]:
        raise ValueError(f"layer {layer} outside the {shifts.shape[0]} shifts")
    mega.check_layer_packed(packed, kernel)
    if shifts.device.type == "cpu":
        quant.check_shifts(shifts)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the conv kernel runs on CUDA tensors (the kernel) "
                         f"or CPU tensors (its plain version), not on "
                         f"{x.device}")


def _launch(x, kernel, shifts, layer, packed, pool, bias=None):
    """The kernel on the tensors' CUDA device and current stream, with the
    2x2 pool inside when ``pool`` and the bias added where one is given
    (pooled only)."""
    global launches
    dev = x.device
    if packed is None:
        packed = mega.pack_layer(kernel)
    tensors = (x, packed, shifts) + ((bias,) if bias is not None else ())
    if any(t.device != dev for t in tensors):
        raise ValueError("x, kernel and shifts must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, kernel and shifts must be contiguous")
    b, ic, h, w = x.shape
    oc = kernel.shape[0]
    oh, ow = (h // 2, w // 2) if pool else (h, w)
    out = torch.empty((b, oc, oh, ow), dtype=torch.uint8, device=dev)
    lib = _lib()
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bias is not None:
        name = "conv_act_pool_bias_forward"
        err = lib.conv_act_pool_bias_forward(
            x.data_ptr(), packed.data_ptr(), bias.data_ptr(), shifts.data_ptr(), layer,
            out.data_ptr(), b, ic, oc, h, w, index, stream)
    else:
        name = "conv_act_pool_forward" if pool else "conv_act_forward"
        fn = lib.conv_act_pool_forward if pool else lib.conv_act_forward
        err = fn(x.data_ptr(), packed.data_ptr(), shifts.data_ptr(), layer,
                 out.data_ptr(), b, ic, oc, h, w, index, stream)
    if err != 0:
        raise RuntimeError(f"{name} failed: cudaError {err} "
                           f"({lib.conv_act_error_string(err).decode()})")
    launches += 1
    return out


def conv_act(x: torch.Tensor, kernel: torch.Tensor, shifts: torch.Tensor,
             layer: int, *, packed: torch.Tensor | None = None) -> torch.Tensor:
    """One conv without the pool: (B, ic, H, W) u8, (oc, ic, 3, 3) int8 and
    the (L,) int32 shift vector, of which ``shifts[layer]`` applies (on the
    device, read by the kernel: a shift change rebuilds nothing) ->
    (B, oc, H, W) u8. CUDA tensors launch ``csrc/conv_act.cu``; CPU tensors
    run ``conv_act_reference``. A CPU shift vector is held to 0..31 here; a
    CUDA one where it was built on the host. ``packed``:
    ``mega.pack_layer(kernel)``, or None to pack it here."""
    _check_inputs(x, kernel, shifts, layer, packed)
    if x.device.type == "cpu":
        return conv_act_reference(x, kernel, shifts, layer)
    return _launch(x, kernel, shifts, layer, packed, pool=False)


def layer_smem(ic: int, oc: int, pool: bool = True) -> int:
    """The shared memory of the layer kernel's plan for a layer of ``ic``
    input and ``oc`` output channels, asked of the built library
    (``conv_act_layer_smem``): 0 when no tiling fits a block, and the
    kernel refuses the layer. Builds the library where it is not built."""
    return int(_lib().conv_act_layer_smem(int(ic), int(oc), int(bool(pool))))


def pack_kernel_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, ic, 3, 3) int8 -> the JAX package's (oc, 9*ic) f32 matrix,
    tap-major / ic-minor."""
    oc, ic = kernel.shape[:2]
    return kernel.to(torch.float32).permute(0, 2, 3, 1).reshape(oc, 9 * ic)


def unpack_kernel_matrix(kmat: torch.Tensor, ic: int) -> torch.Tensor:
    """Inverse of :func:`pack_kernel_matrix`: (oc, 9*ic) f32 -> (oc, ic, 3,
    3) int8 (exact: the packed values are small integers)."""
    oc = kmat.shape[0]
    return (kmat.reshape(oc, 3, 3, ic).permute(0, 3, 1, 2)
            .to(torch.int8).contiguous())


def fused_conv_layer(x: torch.Tensor, kernel: torch.Tensor,
                     shifts: torch.Tensor, layer: int, *,
                     packed: torch.Tensor | None = None,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """One contract layer: the conv of ``conv_act``, then the 2x2 max pool.
    (B, ic, H, W) u8 with H and W even -> (B, oc, H/2, W/2) u8. CUDA
    tensors launch ``csrc/conv_act.cu`` with the pool inside; CPU tensors
    run ``maxpool2x2(conv_act_reference(...))``. ``bias``: an (oc,) int32
    vector added to the sums before the shift (a region-head detector's
    layer, ``models.region``; ic >= 2), whose plain version is
    ``conv_stream.region_layer_reference``."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        raise ValueError(f"the pool needs an even H and W, got {h}x{w}")
    _check_inputs(x, kernel, shifts, layer, packed)
    if bias is not None and (bias.dtype != torch.int32
                             or tuple(bias.shape) != (kernel.shape[0],)
                             or kernel.shape[1] < 2):
        raise ValueError(f"bias must be ({kernel.shape[0]},) int32 on a layer of "
                         f"at least two input channels")
    if x.device.type == "cpu":
        if bias is not None:
            return conv_stream.region_layer_reference(x, kernel, bias, shifts, layer,
                                                      2, False)
        return quant.maxpool2x2(conv_act_reference(x, kernel, shifts, layer))
    return _launch(x, kernel, shifts, layer, packed, pool=True, bias=bias)


def _nchw(images: torch.Tensor) -> torch.Tensor:
    """(B, S, S) or (B, S, S, 1) u8 images -> (B, 1, S, S)."""
    if images.dim() == 4 and images.shape[-1] == 1:
        images = images[..., 0]
    if images.dim() != 3:
        raise ValueError(f"images must be (B, S, S) or (B, S, S, 1), got "
                         f"{tuple(images.shape)}")
    return images[:, None]


def _flat(x: torch.Tensor) -> torch.Tensor:
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w)


def _packed_for(packed, kernels):
    if packed is not None and len(packed) != len(kernels):
        raise ValueError(f"packed must hold mega.pack_layer of each of the "
                         f"{len(kernels)} kernels, got {len(packed)}")
    return [None] * len(kernels) if packed is None else packed


def cnn_forward_pallas(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                       shifts: torch.Tensor, *,
                       packed: Sequence[torch.Tensor] | None = None
                       ) -> torch.Tensor:
    """Every layer through ``fused_conv_layer``: (B, S, S) or (B, S, S, 1)
    u8 -> (B, oc, S'*S') u8, the layout of ``quant.cnn_forward``.
    ``packed``: ``mega.pack_layer`` of each kernel, or None to pack them
    on every CUDA call."""
    x = _nchw(images)
    for i, (k, p) in enumerate(zip(kernels, _packed_for(packed, kernels))):
        x = fused_conv_layer(x, k, shifts, i, packed=p)
    return _flat(x)


def cnn_forward_hybrid(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                       shifts: torch.Tensor, *,
                       packed: Sequence[torch.Tensor] | None = None
                       ) -> torch.Tensor:
    """Layer 0 through ``fused_conv_layer`` (the kernel), the deeper layers
    through the plain contract layer, as the JAX package computes them
    outside any Pallas kernel. Same layout as ``cnn_forward_pallas``.
    ``packed``: as there; only layer 0's is read."""
    x = fused_conv_layer(_nchw(images), kernels[0], shifts, 0,
                         packed=_packed_for(packed, kernels)[0])
    for i, k in enumerate(kernels[1:], start=1):
        x = quant.fixed_point_conv_layer(x, k, shifts[i])
    return _flat(x)
