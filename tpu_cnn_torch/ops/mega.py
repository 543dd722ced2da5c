"""The megakernel and the chained plan: wrapper, plan and plain versions.

``cnn_forward_mega`` is the port of ``tpu_cnn.ops.pallas_poly``'s
``cnn_forward_mega``. ``mega_plan`` picks how many head layers run one at a
time (``ops.conv_pool.conv_pool_layer``, the port of the single-layer
Pallas kernels) so that the rest of the net, the tail, fits one CTA of the
megakernel ``csrc/mega_cnn.cu`` (the port of
``cnn_forward_polyphase_pallas``): no head layer for lyr3-std, lyr3-tiny
and lyr2-small, one for lyr4-wide. On a CUDA tensor each stage launches its
hand-written kernel; on a CPU tensor each runs its plain version
(``conv_pool_reference``, ``mega_reference``), built on ``ops.quant``. Any
other device, or a CUDA call a kernel cannot take, raises: nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from tpu_cnn_torch.ops import _build, conv_pool, quant
from tpu_cnn_torch.ops.detect_head import bin_pool

MAX_LAYERS = 4
MAX_SMEM_BYTES = 232448  # one block's opt-in shared memory on sm_90

# kernel launches made by this wrapper in this process
launches = 0


def _layer_configs(kernels: Sequence[torch.Tensor], size: int):
    """((ic, oc, input size), ...) per layer, as ``CNNConfig`` holds them."""
    cfgs = []
    for k in kernels:
        cfgs.append((int(k.shape[1]), int(k.shape[0]), size))
        size //= 2
    return tuple(cfgs)


def mega_smem_bytes(layer_configs) -> int:
    """Dynamic shared memory one CTA needs for a geometry: the layers'
    outputs ping-pong between two regions, each sized for the largest
    output it holds (the kernel's ``smem_bytes``). lyr3-std:
    65,536 (L0 out) + 32,768 (L1 out) = 98,304."""
    region = [0, 0]
    for li, (_ic, oc, size) in enumerate(layer_configs):
        region[li % 2] = max(region[li % 2], oc * (size // 2) ** 2)
    return -(-region[0] // 16) * 16 + region[1]


def mega_plan(layer_configs) -> int | None:
    """The chained plan's number of head layers: the smallest ``n_head``
    whose tail ``layer_configs[n_head:]`` runs in one CTA (at most four
    layers, activations within one block's shared memory). None when no
    tail of at least one layer fits."""
    for n_head in range(len(layer_configs)):
        tail = layer_configs[n_head:]
        if (len(tail) <= MAX_LAYERS
                and mega_smem_bytes(tail) <= MAX_SMEM_BYTES):
            return n_head
    return None


def mega_reference(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                   shifts: torch.Tensor, *, compute_dtype: str = "float32"):
    """The megakernel's plain version on (B, S, S) or (B, ic0, S, S) u8:
    (feats u8 (B, oc, P*P), bins f32 (B, oc*16), twin bf16 (B, oc, P*P))
    from ``ops.quant`` and ``detect_head.bin_pool``."""
    feats = quant.cnn_forward(images, kernels, shifts,
                              compute_dtype=compute_dtype)
    return feats, bin_pool(feats), feats.to(torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mega_cnn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mega_cnn_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p, p, i, p]
    lib.mega_cnn_forward.restype = i
    lib.mega_cnn_error_string.argtypes = [i]
    lib.mega_cnn_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(images, kernels, shifts, with_bins):
    if images.dtype != torch.uint8 or images.dim() not in (3, 4):
        raise ValueError(f"images must be (B, S, S) or (B, ic0, S, S) uint8, "
                         f"got {tuple(images.shape)} {images.dtype}")
    s, s2 = images.shape[-2:]
    n = len(kernels)
    if s != s2 or n < 1 or s % (1 << n):
        raise ValueError(f"need square images with side divisible by 2^L "
                         f"and L >= 1; got {s}x{s2}, L={n}")
    ic = 1 if images.dim() == 3 else images.shape[1]
    for k in kernels:
        if (k.dtype != torch.int8 or k.dim() != 4 or k.shape[1] != ic
                or tuple(k.shape[2:]) != (3, 3)):
            raise ValueError(f"kernels must chain (oc, ic, 3, 3) int8 from "
                             f"the input's channels; at ic={ic} got "
                             f"{tuple(k.shape)} {k.dtype}")
        ic = k.shape[0]
    if shifts.dtype != torch.int32 or tuple(shifts.shape) != (n,):
        raise ValueError(f"shifts must be ({n},) int32, got "
                         f"{tuple(shifts.shape)} {shifts.dtype}")
    if with_bins and (s >> n) % 4:
        raise ValueError(f"bins need a final map divisible by 4, got {s >> n}")


def _launch(images, kernels, shifts, with_feats, with_bins, with_twin):
    """The megakernel on the tensors' CUDA device and current stream: a
    whole net or a tail that fits one CTA."""
    global launches
    dev = images.device
    tensors = [images, shifts, *kernels]
    if any(t.device != dev for t in tensors):
        raise ValueError("images, kernels and shifts must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("images, kernels and shifts must be contiguous")
    b, s = images.shape[0], images.shape[-1]
    oc, p = kernels[-1].shape[0], s >> len(kernels)
    feats = (torch.empty((b, oc, p * p), dtype=torch.uint8, device=dev)
             if with_feats else None)
    bins = (torch.empty((b, oc * 16), dtype=torch.float32, device=dev)
            if with_bins else None)
    twin = (torch.empty((b, oc, p * p), dtype=torch.bfloat16, device=dev)
            if with_twin else None)
    n = len(kernels)
    ws = [k.data_ptr() for k in kernels] + [None] * (MAX_LAYERS - n)
    ic = (ctypes.c_int * n)(*[int(k.shape[1]) for k in kernels])
    ocs = (ctypes.c_int * n)(*[int(k.shape[0]) for k in kernels])
    lib = _lib()
    err = lib.mega_cnn_forward(
        images.data_ptr(), *ws, shifts.data_ptr(),
        feats.data_ptr() if feats is not None else None,
        bins.data_ptr() if bins is not None else None,
        twin.data_ptr() if twin is not None else None,
        b, n, s, ctypes.addressof(ic), ctypes.addressof(ocs),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_cnn_forward failed: cudaError {err} "
                           f"({lib.mega_cnn_error_string(err).decode()})")
    launches += 1
    return feats, bins, twin


def cnn_forward_mega(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                     shifts: torch.Tensor, *, with_feats: bool = True,
                     with_bins: bool = False, with_twin: bool = False):
    """The net on the chained plan: (B, S, S) u8 images (or (B, ic0, S, S)
    NCHW when the first kernel takes ic0 channels), per-layer
    (oc, ic, 3, 3) int8 kernels and (L,) int32 shifts (on the device, read
    by the kernels: a shift change rebuilds nothing) -> the requested
    outputs in (feats, bins, twin) order, a bare tensor when only one is
    requested:

      feats (B, oc_L, P*P) u8, bins (B, oc_L*16) f32 4x4 bin means / 255,
      twin (B, oc_L, P*P) bf16 copy of the features.

    The ``mega_plan`` head layers run through ``conv_pool.conv_pool_layer``
    and the tail through the megakernel: on CUDA tensors
    ``csrc/conv_pool_layer.cu`` then ``csrc/mega_cnn.cu``, on CPU tensors
    ``conv_pool_reference`` then ``mega_reference``. A CPU shift vector is
    held to 0..31 here; a CUDA one where it was built on the host."""
    if not (with_feats or with_bins or with_twin):
        raise ValueError("at least one of with_feats/with_bins/with_twin "
                         "must be requested")
    _check_inputs(images, kernels, shifts, with_bins)
    if shifts.device.type == "cpu":
        quant.check_shifts(shifts)
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnn_forward_mega runs on CUDA tensors (the "
                         f"kernels) or CPU tensors (their plain versions), "
                         f"not on {images.device}")
    cfgs = _layer_configs(kernels, images.shape[-1])
    n_head = mega_plan(cfgs)
    if n_head is None:
        raise ValueError(
            f"no tail of {cfgs} fits one CTA ({MAX_SMEM_BYTES:,} B of shared "
            f"memory, at most {MAX_LAYERS} layers)")
    x = images if images.dim() == 4 else images[:, None]
    for i in range(n_head):
        x = conv_pool.conv_pool_layer(x, kernels[i], shifts, i)
    tail, tail_shifts = kernels[n_head:], shifts[n_head:]
    if x.device.type == "cpu":
        outs = mega_reference(x, tail, tail_shifts)
    else:
        outs = _launch(x, tail, tail_shifts, with_feats, with_bins, with_twin)
    ret = [o for o, want in zip(outs, (with_feats, with_bins, with_twin))
           if want]
    return tuple(ret) if len(ret) > 1 else ret[0]
