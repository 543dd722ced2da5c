"""One contract layer as a kernel: wrapper and plain version.

``conv_pool_layer`` is the port of the JAX package's two single-layer
Pallas kernels, ``pallas_poly.conv_pool_layer_poly`` and
``pallas_poly.conv_pool_layer_phase``: the head layers of the chained plan
(``ops.mega.cnn_forward_mega``). Both compute the same function; the second
only writes it as ``phase_split_nchw(out, h)`` rows for the TPU tail, a
layout the Hopper tail does not use. So one kernel, ``csrc/conv_pool_layer.cu``,
writes NCHW:

    (B, ic, S, S) u8 -> conv3x3 SAME -> >> shift -> clip 0..255
    -> 2x2 max pool -> (B, oc, S/2, S/2) u8

On a CUDA tensor the wrapper launches the kernel; on a CPU tensor it runs
the plain version, ``conv_pool_reference`` (one layer of ``ops.quant``).
Any other device, or a CUDA call the kernel cannot take, raises: nothing
falls back. The kernel is the pooled layer kernel of ``csrc/conv_layer.cuh``
(as is ``int8.fused_conv_layer``'s): it reads the weights packed by
``mega.pack_layer``, made once by the weights' owner or here on each call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build, mega, quant

# kernel launches made by this wrapper in this process
launches = 0


def conv_pool_reference(x: torch.Tensor, kernel: torch.Tensor,
                        shifts: torch.Tensor, layer: int, *,
                        compute_dtype: str = "float32") -> torch.Tensor:
    """The kernel's plain version: ``quant.fixed_point_conv_layer`` at
    ``shifts[layer]`` (f32 ``unfold`` + matmul, or the int32 tap loop)."""
    return quant.fixed_point_conv_layer(x, kernel, shifts[layer],
                                        compute_dtype=compute_dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_pool_layer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_pool_layer_forward.argtypes = [p, p, p, i, p, i, i, i, i, i, p]
    lib.conv_pool_layer_forward.restype = i
    lib.conv_pool_layer_error_string.argtypes = [i]
    lib.conv_pool_layer_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(x, kernel, shifts, layer):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (B, ic, S, S) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    _, ic, s, s2 = x.shape
    if s != s2 or s < 2 or s % 2:
        raise ValueError(f"need square inputs with an even side, got {s}x{s2}")
    if (kernel.dtype != torch.int8 or kernel.dim() != 4
            or kernel.shape[1] != ic or tuple(kernel.shape[2:]) != (3, 3)):
        raise ValueError(f"kernel must be (oc, {ic}, 3, 3) int8, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1:
        raise ValueError(f"shifts must be a 1-D int32 vector, got "
                         f"{tuple(shifts.shape)} {shifts.dtype}")
    if not 0 <= layer < shifts.shape[0]:
        raise ValueError(f"layer {layer} outside the {shifts.shape[0]} shifts")


def _launch(x, kernel, shifts, layer, packed):
    """The kernel on the tensors' CUDA device and current stream."""
    global launches
    dev = x.device
    if packed is None:
        packed = mega.pack_layer(kernel)
    tensors = (x, packed, shifts)
    if any(t.device != dev for t in tensors):
        raise ValueError("x, kernel and shifts must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, kernel and shifts must be contiguous")
    b, ic, s, _ = x.shape
    oc = kernel.shape[0]
    out = torch.empty((b, oc, s // 2, s // 2), dtype=torch.uint8, device=dev)
    lib = _lib()
    err = lib.conv_pool_layer_forward(
        x.data_ptr(), packed.data_ptr(), shifts.data_ptr(), layer,
        out.data_ptr(), b, ic, oc, s,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_pool_layer_forward failed: cudaError {err} "
                           f"({lib.conv_pool_layer_error_string(err).decode()})")
    launches += 1
    return out


def conv_pool_layer(x: torch.Tensor, kernel: torch.Tensor,
                    shifts: torch.Tensor, layer: int, *,
                    packed: torch.Tensor | None = None) -> torch.Tensor:
    """One contract layer: (B, ic, S, S) u8, (oc, ic, 3, 3) int8 and the
    (L,) int32 shift vector, of which ``shifts[layer]`` applies (on the
    device, read by the kernel: a shift change rebuilds nothing) ->
    (B, oc, S/2, S/2) u8. CUDA tensors launch ``csrc/conv_pool_layer.cu``;
    CPU tensors run ``conv_pool_reference``. A CPU shift vector is held to
    0..31 here; a CUDA one where it was built on the host. ``packed``:
    ``mega.pack_layer(kernel)``, or None to pack it here."""
    _check_inputs(x, kernel, shifts, layer)
    mega.check_layer_packed(packed, kernel)
    if shifts.device.type == "cpu":
        quant.check_shifts(shifts)
    if x.device.type == "cpu":
        return conv_pool_reference(x, kernel, shifts, layer)
    if x.device.type == "cuda":
        return _launch(x, kernel, shifts, layer, packed)
    raise ValueError(f"conv_pool_layer runs on CUDA tensors (the kernel) or "
                     f"CPU tensors (its plain version), not on {x.device}")
