"""The max-pool rows of a darknet layer graph (``models.region``'s
``("maxpool", k, s)``; YOLOv7's), on ``csrc/maxpool.cu``.

    2x2 stride 2:   out(y, x) = max of in(2 y .. 2 y + 1, 2 x .. 2 x + 1)
    k 5, 9, 13 at stride 1: out(y, x) = max of in over (y - k // 2 ..
                    y + k // 2, the same columns), taps outside the map
                    ignored

``maxpool`` launches the kernel on a CUDA tensor: u8 maps of 16-channel
multiples in channels-last memory, or channels of a wider one (a route's
slice, ``conv_stream.pitch``), in and out. One launch pools a map at
every size of ``sizes``: at stride 1 the 5x5 cascaded (9 is 5 twice, 13
three times, the maps being u8 and never below 0), each output written
after its step, so SPPCSPC's three pools read their map once. On a CPU
tensor it runs ``maxpool_reference``, the same cascade in plain torch
(the plain reference, ``reference.yolov7``, pools with ``F.max_pool2d``).
Any other device, or a CUDA call the kernel cannot take, raises: nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.ops.conv_stream import pitch

CASCADE = {5: 1, 9: 2, 13: 3}  # a stride-1 pool's size -> its 5x5 steps

# kernel launches made by this wrapper in this process
launches = 0


def _steps(sizes, stride: int) -> list[int]:
    sizes = [int(k) for k in sizes]
    if stride == 2 and sizes == [2]:
        return [0]
    if stride == 1 and 1 <= len(sizes) <= 3 and all(k in CASCADE for k in sizes):
        return [CASCADE[k] for k in sizes]
    raise ValueError(f"sizes {sizes} at stride {stride}: need (2,) at stride 2, or 1-3 of "
                     f"{tuple(CASCADE)} at stride 1")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("maxpool")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.maxpool_forward.argtypes = [p, q, i, i, i, i, i, i, p, p, p, i, p]
    lib.maxpool_forward.restype = i
    lib.maxpool_error_string.argtypes = [i]
    lib.maxpool_error_string.restype = ctypes.c_char_p
    return lib


def takes(channels: int, height: int, width: int, stride: int) -> bool:
    """Whether the kernel takes a (C, H, W) map at ``stride``: C a multiple
    of 16; at stride 2 an even map; at stride 1 a map whose 16 channels fit
    twice in the cascade's 96 KB of shared memory (H W <= 3,072)."""
    if channels < 16 or channels % 16 or height < 1 or width < 1:
        return False
    if stride == 2:
        return height % 2 == 0 and width % 2 == 0
    return stride == 1 and 2 * height * width * 16 <= 96 * 1024


def _pool5(m: torch.Tensor) -> torch.Tensor:
    """One 5x5 stride-1 step, taps outside the map ignored: the rows' then
    the columns' maxima of the map padded with zeros (the maps are u8)."""
    h, w = m.shape[-2:]
    p = F.pad(m, (2, 2, 2, 2))
    rows = torch.stack([p[..., :, d:d + w] for d in range(5)]).amax(0)
    return torch.stack([rows[..., d:d + h, :] for d in range(5)]).amax(0)


def maxpool_reference(x: torch.Tensor, sizes, stride: int) -> list[torch.Tensor]:
    """The plain version: (B, C, H, W) u8 -> one (B, C, H / stride, W /
    stride) u8 map a size of ``sizes``, the 2x2/2 windows' maxima or the
    5x5 cascade's steps."""
    steps = _steps(sizes, stride)
    m = x.to(torch.int16)
    if stride == 2:
        b, c, h, w = m.shape
        return [m.reshape(b, c, h // 2, 2, w // 2, 2).amax((3, 5)).to(torch.uint8)]
    got = {}
    for s in range(1, max(steps) + 1):
        m = _pool5(m)
        got[s] = m.to(torch.uint8)
    return [got[s] for s in steps]


def maxpool(x: torch.Tensor, sizes, stride: int, *, outs=None) -> list[torch.Tensor]:
    """(B, C, H, W) u8 -> a (B, C, H / stride, W / stride) u8 map a size of
    ``sizes`` (the module docstring), in channels-last memory on CUDA.
    ``outs``: the maps to write (channels of wider ones, a route's slices;
    None: a map of its own), which are returned."""
    global launches
    steps = _steps(sizes, stride)
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W) uint8, got {tuple(x.shape)} {x.dtype}")
    b, c, h, w = (int(v) for v in x.shape)
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"the 2x2/2 pool needs an even map, got {h}x{w}")
    shape = (b, c, h // stride, w // stride)
    outs = list(outs) if outs is not None else [None] * len(steps)
    if len(outs) != len(steps) or any(
            o is not None and (tuple(o.shape) != shape or o.dtype != torch.uint8
                               or o.device != x.device) for o in outs):
        raise ValueError(f"outs must be {len(steps)} {shape} uint8 maps on {x.device}")
    if x.device.type == "cpu":
        got = maxpool_reference(x, sizes, stride)
        return [g if o is None else o.copy_(g) for o, g in zip(outs, got)]
    if x.device.type != "cuda":
        raise ValueError(f"the max-pool kernel runs on CUDA tensors (the kernel) or CPU "
                         f"tensors (its plain version), not on {x.device}")
    if not takes(c, h, w, stride):
        raise ValueError(f"the max-pool kernel takes C a multiple of 16 and (stride 1) H W "
                         f"<= 3,072, got C {c}, {h}x{w}, stride {stride}")
    outs = [o if o is not None else torch.empty((b, *shape[2:], c), dtype=torch.uint8,
                                                 device=x.device).permute(0, 3, 1, 2)
            for o in outs]
    in_pitch = pitch(x)
    out_pitch = [pitch(o) for o in outs]
    if in_pitch is None or None in out_pitch:
        raise ValueError("x and outs must be channels-last maps or channels of one")
    dev = x.device
    lib = _lib()
    n = len(outs)
    err = lib.maxpool_forward(
        x.data_ptr(), in_pitch, b, c, h, w, stride, n,
        (ctypes.c_void_p * n)(*[o.data_ptr() for o in outs]),
        (ctypes.c_longlong * n)(*out_pitch), (ctypes.c_int * n)(*steps),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"maxpool_forward failed: cudaError {err} "
                           f"({lib.maxpool_error_string(err).decode()}) at x {tuple(x.shape)} "
                           f"pitch {in_pitch}, sizes {list(sizes)}, stride {stride}, out "
                           f"pitches {out_pitch}")
    launches += 1
    return outs
