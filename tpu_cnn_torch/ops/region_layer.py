"""The region route's layer kernel (``csrc/region_layer.cu``): a pooled 3x3
layer of a region-head detector (``models.region``) with fewer than 128
input channels, yolov2-tiny-voc's L0-L3; and, in a darknet graph (YOLOv3's
L0-L3, L5, L7, L10), the same convs unpooled or at stride 2, with a
residual added after the clip (``region_layer``'s ``out_mode`` and
``residual``).

In those unpooled modes the input and the output may be channels of wider
channels-last maps (YOLOv7's ELAN convs read and write a concatenation in
place: ``region_layer``'s ``out``, and an input a route's slice), on an
instantiation of their own.

A layer ``(ic, oc, size, 3, 2)`` with an int32 bias, on u8 maps:

    sums = SAME 3x3 conv + bias             (exact s32)
    u8 = clip(sums >> shift[layer], 0, 255), then the 2x2 stride-2 max

``region_layer`` launches the kernel on a CUDA tensor: ic 1-127, oc 1-128,
H and W even; the map in NCHW or channels-last memory (any other strides
are read byte by byte), the output (B, oc, H/2, W/2) in channels-last
memory, which the next layer and the streamed kernel (``ops.conv_stream``)
read in 16-byte chunks. On a CPU tensor it runs
``conv_stream.region_layer_reference``. Any other device, or a CUDA call
the kernel cannot take, raises: nothing falls back. The kernel reads
weights packed by ``pack_layer``: made once by their owner
(``RegionEngine``) and passed as ``packed``, or here on every call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.ops.conv_stream import graph_layer_reference, pitch, region_layer_reference

MAX_IC = 127  # 128 input channels and more stream (``conv_stream.streams``)
MAX_OC = 128  # the widest wgmma N the kernel issues
# output modes (csrc/region_layer_plan.h): the 2x2/2 pool (a chain's), the
# unpooled map and the stride-2 conv (a layer graph's)
OUT_MODES = {"pool": 0, "plain": 1, "stride2": 2}

# kernel launches made by this wrapper in this process
launches = 0


def takes(ic: int, oc: int, height: int, width: int, out_mode: str = "pool",
          slice_: bool = False) -> bool:
    """Whether the kernel takes a layer of ``ic`` -> ``oc`` channels on an
    H x W map in ``out_mode`` (``csrc/region_layer_plan.h``'s
    ``make_geometry_ex``: the unpooled modes take oc 18-128, even, and the
    stride-2 one ic 4 or more); ``slice_``: its input or output channels of
    a wider map (the unpooled modes of ic 4 or more)."""
    if out_mode != "pool" and (oc <= 16 or oc % 2 or (out_mode == "stride2" and ic <= 3)):
        return False
    if slice_ and (out_mode == "pool" or ic <= 3):
        return False
    return (out_mode in OUT_MODES and 1 <= ic <= MAX_IC and 1 <= oc <= MAX_OC
            and height >= 2 and width >= 2 and height % 2 == 0 and width % 2 == 0
            and max(height, width) <= 32768 and height * width <= 1 << 28)


def as_3x3(kernel: torch.Tensor) -> torch.Tensor:
    """A 1x1 kernel as the 3x3 one of the same sums (its centre tap; the
    kernel computes 3x3 convs only), a 3x3 one as it is."""
    if tuple(kernel.shape[2:]) == (1, 1):
        return torch.nn.functional.pad(kernel, (1, 1, 1, 1))
    return kernel


def wgmma_n(oc: int) -> int:
    """wgmma's N for ``oc`` output channels (zero weights past oc)."""
    return next(n for n in (16, 32, 64, 128) if oc <= n)


def k_layout(ic: int) -> tuple[int, int]:
    """(bytes of a pixel's K row before padding to 32-byte steps, the
    bytes a tap's channels take in it): the recast's 9 ic bytes, tap-major
    and channel-minor, for 1-3 channels; else 9 taps of ic padded to 16,
    32, 64 or 128 bytes (16: the K row padded to five steps)."""
    if ic <= 3:
        return 9 * ic, ic
    cp = 16
    while cp < ic:
        cp *= 2
    return 9 * cp, cp


def packed_shape(kernel: torch.Tensor) -> tuple[int]:
    """The shape ``pack_layer(kernel)`` gives: (bytes,)."""
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    k, _ = k_layout(ic)
    return (-(-k // 32) * 32 * wgmma_n(oc),)


def pack_layer(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, ic, 3, 3) int8 -> wgmma's B for the kernel, 1-D int8 on the same
    device: B is (K, N), K a pixel's row (``k_layout``: byte tap * cp + c
    holds channel c of tap 3 ky + kx; zero past the weights), padded to
    steps of 32; N = oc padded to ``wgmma_n(oc)``. In ``csrc/hopper.cuh``'s
    no-swizzle K-major layout, core matrices of 8 N rows x 16 K bytes: byte
    ((s * NG + n8) * 2 + h) * 128 + 16 r + j holds B[32 s + 16 h + j][8 n8 +
    r], NG = N / 8. A 1x1 kernel is packed as ``as_3x3``'s."""
    kernel = as_3x3(kernel)
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    if tuple(kernel.shape[2:]) != (3, 3) or not 1 <= ic <= MAX_IC or not 1 <= oc <= MAX_OC:
        raise ValueError(f"the region route's layer kernel takes (1-{MAX_OC}, 1-{MAX_IC}, "
                         f"3, 3) weights, got {tuple(kernel.shape)}")
    k, cp = k_layout(ic)
    n, kp = wgmma_n(oc), -(-k // 32) * 32
    taps = torch.zeros((9, cp, n), dtype=torch.int8, device=kernel.device)
    taps[:, :ic, :oc] = kernel.permute(2, 3, 1, 0).reshape(9, ic, oc)
    b = torch.zeros((kp, n), dtype=torch.int8, device=kernel.device)
    b[:k] = taps.reshape(k, n)
    # (s, h, j, n8, r) -> (s, n8, h, r, j)
    return b.view(kp // 32, 2, 16, n // 8, 8).permute(0, 3, 1, 4, 2).contiguous().view(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("region_layer")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.region_layer_forward.argtypes = [p, i, p, p, p, i, p] + [i] * 5 + [q] * 4 + [i, p] + \
        [i] * 3 + [p]
    lib.region_layer_forward.restype = i
    lib.region_layer_error_string.argtypes = [i]
    lib.region_layer_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, kernel, bias, shifts, layer, packed, out_mode="pool"):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (B, ic, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    b, ic, h, w = (int(v) for v in x.shape)
    ks = tuple(kernel.shape[2:])
    if kernel.dtype != torch.int8 or kernel.dim() != 4 or int(kernel.shape[1]) != ic \
            or not (ks == (3, 3) or ks == (1, 1) and out_mode == "plain"):
        raise ValueError(f"kernel must be (oc, {ic}, 3, 3) int8 (or 1x1, unpooled), got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if not takes(ic, int(kernel.shape[0]), h, w, out_mode):
        raise ValueError(f"the region route's layer kernel takes ic 1-{MAX_IC}, oc "
                         f"1-{MAX_OC} and an even map (unpooled: oc 18-128, even; stride "
                         f"2: ic 4 or more), got ic {ic}, oc {kernel.shape[0]}, {h}x{w}, "
                         f"{out_mode}")
    if bias.dtype != torch.int32 or tuple(bias.shape) != (kernel.shape[0],):
        raise ValueError(f"bias must be ({kernel.shape[0]},) int32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1 or not 0 <= layer < len(shifts):
        raise ValueError("shifts must be a 1-D int32 vector holding `layer`")
    if packed is not None and (packed.dtype != torch.int8 or packed.device != kernel.device
                               or tuple(packed.shape) != packed_shape(kernel)):
        raise ValueError(f"packed must be pack_layer of the kernel, "
                         f"{packed_shape(kernel)} int8 on {kernel.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the region route's layer kernel runs on CUDA tensors (the "
                         f"kernel) or CPU tensors (its plain version), not on {x.device}")


def _layout(x: torch.Tensor) -> int:
    """0 for a contiguous NCHW map, 1 for a contiguous channels-last one, 2
    for other strides (read byte by byte)."""
    if x.is_contiguous():
        return 0
    return 1 if x.is_contiguous(memory_format=torch.channels_last) else 2


def region_layer(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                 shifts: torch.Tensor, layer: int, *,
                 packed: torch.Tensor | None = None, out_mode: str = "pool",
                 residual: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """One layer (the module docstring): (B, ic, H, W) u8 -> (B, oc, H/2,
    W/2) u8, on CUDA in channels-last memory. ``shifts[layer]`` applies
    (read on the device).

    A layer graph's convs take ``out_mode`` "plain" (no pool: (B, oc, H,
    W); a 1x1 kernel too, as its 3x3 ``as_3x3``) or "stride2" (darknet's
    stride-2 3x3 conv: (B, oc, H/2, W/2)), and a ``residual`` map of the
    output's shape, channels-last on CUDA (u8 = min(u8 + residual,
    255)); and, in those modes without a residual, ``out``, the map to
    write (channels of a wider channels-last map on CUDA: a route's
    slice), which is returned, and an input that is channels of a wider
    one."""
    global launches
    _check(x, kernel, bias, shifts, layer, packed, out_mode)
    b, ic, h, w = (int(v) for v in x.shape)
    oc = int(kernel.shape[0])
    oh, ow = (h, w) if out_mode == "plain" else (h // 2, w // 2)
    if residual is not None and (out_mode == "pool" or tuple(residual.shape) != (b, oc, oh, ow)
                                 or residual.dtype != torch.uint8
                                 or residual.device != x.device):
        raise ValueError(f"residual must be ({b}, {oc}, {oh}, {ow}) uint8 on {x.device} "
                         f"of an unpooled mode")
    if out is not None and (out_mode == "pool" or residual is not None
                            or tuple(out.shape) != (b, oc, oh, ow) or out.dtype != torch.uint8
                            or out.device != x.device):
        raise ValueError(f"out must be ({b}, {oc}, {oh}, {ow}) uint8 on {x.device} of an "
                         f"unpooled mode without a residual")
    if x.device.type == "cpu":
        if out_mode == "pool":
            return region_layer_reference(x, kernel, bias, shifts, layer, 2, False)
        made = graph_layer_reference(x, kernel, bias, shifts, layer,
                                     stride=2 if out_mode == "stride2" else 1,
                                     residual=residual)
        if out is None:
            return made
        out.copy_(made)
        return out
    dev = x.device
    if packed is None:
        packed = pack_layer(kernel)
    if any(t.device != dev for t in (packed, bias, shifts)):
        raise ValueError("x, kernel, bias and shifts must be on one device")
    if out is None:
        out = torch.empty((b, oh, ow, oc), dtype=torch.uint8, device=dev).permute(0, 3, 1, 2)
    out_pitch = pitch(out)
    if out_pitch is None:
        raise ValueError("out must be a channels-last map or channels of one")
    if residual is not None and not residual.permute(0, 2, 3, 1).is_contiguous():
        raise ValueError("residual must be in channels-last memory")
    layout, in_pitch = _layout(x), ic
    if layout == 2 and pitch(x) is not None:  # channels of a wider channels-last map
        layout, in_pitch = 1, pitch(x)
    if (in_pitch != ic or out_pitch != oc) and not takes(ic, oc, h, w, out_mode, True):
        raise ValueError(f"the layer kernel reads and writes a wider map's channels in the "
                         f"unpooled modes of ic 4 or more, got ic {ic}, {out_mode}")
    lib = _lib()
    err = lib.region_layer_forward(
        x.data_ptr(), layout, packed.data_ptr(), bias.data_ptr(), shifts.data_ptr(),
        layer, out.data_ptr(), b, ic, oc, h, w, *(int(s) for s in x.stride()),
        OUT_MODES[out_mode], residual.data_ptr() if residual is not None else None,
        in_pitch, out_pitch,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"region_layer_forward failed: cudaError {err} "
                           f"({lib.region_layer_error_string(err).decode()}) at x "
                           f"{tuple(x.shape)}, oc {oc}")
    launches += 1
    return out
