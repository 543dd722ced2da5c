"""The weight-streaming layer kernel (``csrc/conv_stream.cu``) of the
region-head detectors (``models.region``), and the plain version of every
layer of theirs.

A layer ``(ic, oc, size, k, pool)`` with an int32 bias, on u8 maps:

    sums = SAME k x k conv + bias             (exact s32)
    u8 = clip(sums >> shift[layer], 0, 255), then the pool
    (2: 2x2 stride 2; 1: 2x2 stride 1, edges clamped; 0: none)
    the last layer: the s32 sums themselves

``conv_stream`` launches the kernel on a CUDA tensor: ic a multiple of
128, k 1 or 3, any oc (even unless ``last``); the map in NCHW or
channels-last memory (where the kernel gathers A itself, an NCHW map or
the 2x2/2 pool's, a tile's source rows must fit its staging, as
yolov2-tiny-voc's do: ``csrc/conv_stream_plan.h``), the output (B, oc,
OH, OW) in channels-last memory (u8, or s32 for ``last``). On a CPU
tensor it runs
``region_layer_reference`` (the plain reference's ``unfold`` and float64
matrix product: every sum of these networks is an integer below 2**31,
exact in float64). Any other device, or a CUDA call the kernel cannot
take, raises: nothing falls back. The kernel reads
weights packed by ``pack_stream``: made once by their owner (``CUDAEngine``)
and passed as ``packed``, or here on every call.

A darknet graph's convs (YOLOv3) also take a stride of 2, a residual map,
an upsampled output and maps inside wider ones (``conv_stream``'s keyword
arguments; ``graph_layer_reference`` is their plain version).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.reference import yolov2_tiny, yolov3

PACK_N = 256  # a packed slice's rows: oc padded to a multiple of this
SLICE_K = 128  # K bytes of a streamed slice: one tap, 128 channels

# kernel launches made by this wrapper in this process
launches = 0


def region_layer_reference(x: torch.Tensor, kernel: torch.Tensor,
                           bias: torch.Tensor, shifts: torch.Tensor, layer: int,
                           pool: int, last: bool) -> torch.Tensor:
    """The plain version of one layer, on the plain reference's own
    functions (``reference.yolov2_tiny``: ``layer_sums``, ``activate``):
    (B, ic, H, W) u8 -> (B, oc, OH, OW) u8, or the (B, oc, H, W) int32 sums
    where ``last``."""
    sums = yolov2_tiny.layer_sums(x, kernel, bias, int(kernel.shape[-1]))
    if last:
        return sums.to(torch.int32)
    return yolov2_tiny.activate(sums, int(shifts[layer]), pool).to(torch.uint8)


def graph_layer_reference(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                          shifts: torch.Tensor, layer: int, *, stride: int = 1,
                          last: bool = False, residual: torch.Tensor | None = None,
                          upsample: bool = False) -> torch.Tensor:
    """The plain version of one conv of a layer graph, on the plain
    reference's own functions (``reference.yolov3``: ``conv_sums``,
    ``clip_shift``): (B, ic, H, W) u8 -> (B, oc, H / stride, W / stride)
    u8 (+ ``residual``, saturating at 255; 2x upsampled where
    ``upsample``), or the int32 sums where ``last``."""
    sums = yolov3.conv_sums(x, kernel, bias, int(kernel.shape[-1]), stride)
    if last:
        return sums.to(torch.int32)
    out = yolov3.clip_shift(sums, int(shifts[layer]))
    if residual is not None:
        out = torch.clamp(out + residual.to(out.dtype), max=255)
    if upsample:
        out = out.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
    return out.to(torch.uint8)


def pitch(t: torch.Tensor) -> int | None:
    """The bytes from one pixel to the next of a (B, C, H, W) map in
    channels-last memory, or of a run of channels of one (a route's
    slice); None for another layout."""
    b, c, h, w = t.shape
    p = t.stride(3)
    if (t.stride(1) == 1 and p >= c and t.stride(2) == w * p
            and (b == 1 or t.stride(0) == h * w * p)):
        return int(p)
    return None


def streams(spec, last: bool) -> bool:
    """Whether a region-head detector's layer ``(ic, oc, size, k, pool)``
    runs on this kernel (``RegionEngine``'s route): ic a multiple of
    ``SLICE_K``, or a layer the region route's layer kernel does not
    compute (a 1x1, the 2x2 stride-1 pool or none, the linear last layer).
    The others run on that kernel (``region_layer.region_layer``)."""
    ic, _, _, k, pool = spec
    return ic % SLICE_K == 0 or k != 3 or pool != 2 or last


def stream_shape(kernel: torch.Tensor) -> tuple[int]:
    """The shape ``pack_stream(kernel)`` gives: (bytes,)."""
    oc, ic, k, _ = (int(v) for v in kernel.shape)
    return (k * k * ic // SLICE_K * -(-oc // PACK_N) * PACK_N * SLICE_K,)


def pack_stream(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, ic, k, k) int8 -> the streamed B, 1-D int8 on the same device:
    per K slice of 128 bytes (K = tap * ic + c, tap-major), a 128-byte row
    per output channel (oc padded to a multiple of ``PACK_N``, zero past
    oc) in wgmma's 128-byte swizzle, as the kernel's bulk copies land it in
    shared memory: byte (slice * rows + n) * 128 + 16 (j ^ n % 8) + i holds
    B[slice K 16 j + i][channel n]. Any 8-aligned run of rows of a slice is
    one N tile's weights."""
    oc, ic, k, _ = (int(v) for v in kernel.shape)
    if ic % SLICE_K:
        raise ValueError(f"the streamed kernel takes ic a multiple of {SLICE_K}, "
                         f"got {ic}")
    rows, slices = -(-oc // PACK_N) * PACK_N, k * k * ic // SLICE_K
    b = torch.zeros((rows, k * k * ic), dtype=torch.int8, device=kernel.device)
    b[:oc] = kernel.permute(0, 2, 3, 1).reshape(oc, k * k * ic)
    n = torch.arange(rows, device=kernel.device)
    chunk = torch.arange(8, device=kernel.device)[None, :] ^ (n[:, None] % 8)
    # (n, slice, j, i) -> (slice, n, j ^ n % 8, i)
    b = b.view(rows, slices, 8, 16).permute(1, 0, 2, 3)
    return b[:, n[:, None], chunk].contiguous().view(-1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("conv_stream")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.conv_stream_forward.argtypes = [p, i, p, p, p, i, p] + [i] * 11 + [p, i, i, i, p]
    lib.conv_stream_forward.restype = i
    lib.conv_stream_error_string.argtypes = [i]
    lib.conv_stream_error_string.restype = ctypes.c_char_p
    return lib


def _check(x, kernel, bias, shifts, layer, pool, last, packed):
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (B, ic, H, W) uint8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    ic = x.shape[1]
    if (kernel.dtype != torch.int8 or kernel.dim() != 4 or kernel.shape[1] != ic
            or kernel.shape[2] != kernel.shape[3] or kernel.shape[2] not in (1, 3)):
        raise ValueError(f"kernel must be (oc, {ic}, k, k) int8, k 1 or 3, got "
                         f"{tuple(kernel.shape)} {kernel.dtype}")
    if bias.dtype != torch.int32 or tuple(bias.shape) != (kernel.shape[0],):
        raise ValueError(f"bias must be ({kernel.shape[0]},) int32, got "
                         f"{tuple(bias.shape)} {bias.dtype}")
    if shifts.dtype != torch.int32 or shifts.dim() != 1 or not 0 <= layer < len(shifts):
        raise ValueError("shifts must be a 1-D int32 vector holding `layer`")
    if pool not in (0, 1, 2) or (last and pool):
        raise ValueError(f"pool {pool}: need 0, 1 or 2, and none on the last layer")
    if pool == 2 and (x.shape[2] % 2 or x.shape[3] % 2):
        raise ValueError(f"the 2x2/2 pool needs an even map, got {tuple(x.shape[2:])}")
    if packed is not None and (packed.dtype != torch.int8 or packed.device != kernel.device
                               or tuple(packed.shape) != stream_shape(kernel)):
        raise ValueError(f"packed must be pack_stream of the kernel, "
                         f"{stream_shape(kernel)} int8 on {kernel.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the streamed kernel runs on CUDA tensors (the kernel) "
                         f"or CPU tensors (its plain version), not on {x.device}")


def conv_stream(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                shifts: torch.Tensor, layer: int, *, pool: int = 0,
                last: bool = False, packed: torch.Tensor | None = None, stride: int = 1,
                residual: torch.Tensor | None = None, out: torch.Tensor | None = None,
                upsample: bool = False) -> torch.Tensor:
    """One layer (the module docstring): (B, ic, H, W) u8 -> (B, oc, OH, OW)
    u8, or (B, oc, H, W) int32 where ``last``; on CUDA in channels-last
    memory. ``shifts[layer]`` applies (read on the device).

    A layer graph's convs (no pool) also take ``stride`` 2 (a 3x3 conv:
    darknet's out(y, x) = sum in(2 y - 1 + dy, 2 x - 1 + dx)), a
    ``residual`` map of the output's shape (u8 = min(u8 + residual, 255)),
    ``upsample`` (the output 2x upsampled: out(y, x) = conv(y // 2, x //
    2)) and ``out``, the map to write (a run of channels of a wider one: a
    route's slice), which is returned. On CUDA x, residual and out may be
    channels of wider channels-last maps (``pitch``)."""
    global launches
    _check(x, kernel, bias, shifts, layer, pool, last, packed)
    graph = stride != 1 or residual is not None or out is not None or upsample
    if graph and (pool or last and (residual is not None or upsample) or stride not in (1, 2)):
        raise ValueError(f"stride {stride}, residual, upsample and out are a layer graph's: "
                         f"no pool, and no residual or upsample on the linear layer")
    half = pool == 2 or stride == 2
    oh, ow = (x.shape[2] // 2, x.shape[3] // 2) if half else tuple(x.shape[2:])
    shape = (x.shape[0], kernel.shape[0], 2 * oh if upsample else oh, 2 * ow if upsample else ow)
    for name, t in (("residual", residual), ("out", out)):
        want = shape if name == "out" else (*shape[:2], oh, ow)
        if t is not None and (tuple(t.shape) != want or t.device != x.device
                              or t.dtype != (torch.int32 if last and name == "out"
                                             else torch.uint8)):
            raise ValueError(f"{name} must be {want} on {x.device}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if x.device.type == "cpu":
        if not graph:
            return region_layer_reference(x, kernel, bias, shifts, layer, pool, last)
        r = graph_layer_reference(x, kernel, bias, shifts, layer, stride=stride, last=last,
                                  residual=residual, upsample=upsample)
        if out is None:
            return r
        out.copy_(r)
        return out
    dev = x.device
    if packed is None:
        packed = pack_stream(kernel)
    if any(t.device != dev for t in (packed, bias, shifts)):
        raise ValueError("x, kernel, bias and shifts must be on one device")
    b, ic, h, w = (int(v) for v in x.shape)
    oc = int(kernel.shape[0])
    nhwc, in_pitch = (0, ic) if x.is_contiguous() else (1, pitch(x))
    if in_pitch is None:
        raise ValueError("x must be NCHW-contiguous, channels-last, or channels of a "
                         "channels-last map")
    if out is None:
        out = torch.empty((b, *shape[2:], oc), dtype=torch.int32 if last else torch.uint8,
                          device=dev).permute(0, 3, 1, 2)
    out_pitch = pitch(out)
    res_pitch = pitch(residual) if residual is not None else 0
    if out_pitch is None or res_pitch is None:
        raise ValueError("out and residual must be channels-last maps or channels of one")
    lib = _lib()
    err = lib.conv_stream_forward(
        x.data_ptr(), nhwc, packed.data_ptr(), bias.data_ptr(), shifts.data_ptr(), layer,
        out.data_ptr(), b, ic, oc, h, w, int(kernel.shape[2]), pool, int(last), stride,
        in_pitch, out_pitch, residual.data_ptr() if residual is not None else None,
        res_pitch, int(upsample),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv_stream_forward failed: cudaError {err} "
                           f"({lib.conv_stream_error_string(err).decode()}) at "
                           f"x {tuple(x.shape)} pitch {in_pitch}, oc {oc}, k "
                           f"{kernel.shape[2]}, pool {pool}, last {last}, stride {stride}, "
                           f"residual {residual is not None}, upsample {upsample}, out "
                           f"pitch {out_pitch}")
    launches += 1
    return out
