"""Width-changing bitcasts and the packed lane roll.

Port of the TPU hardware probe ``scripts/probe_bitcast.py``, whose one
Pallas kernel (``run``, with the bodies ``k_narrow``, ``k_widen`` and
``k_packed_roll``) asked how Mosaic lays out a width-changing
``pltpu.bitcast`` and whether an int32 lane roll moves packed bytes
together. The three functions, with the layouts the TPU showed:

    narrow_i32_to_i8  (R, L) int32   -> (4R, L) int8,  row 4r+b = byte b of row r
    widen_u8_to_i32   (4R, L) u8/i8  -> (R, L) int32,  the inverse
    packed_roll       (R, L) int32, k -> (R, L) int32, np.roll(x, k, axis=1)

Bytes are little-endian, as on the TPU, the H100 and the x86 host. On a
CUDA tensor each wrapper launches its hand-written kernel
(``csrc/bitcast.cu``); on a CPU tensor it runs the plain version
(``*_reference``, torch views and ``torch.roll``). Any other device, or a
CUDA call the kernel cannot take, raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tpu_cnn_torch.ops import _build

# kernel launches made by this module's wrappers in this process
launches = 0


def narrow_i32_to_i8_reference(x: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 -> (4R, L) int8, row 4r+b holding byte b of row r."""
    r, l = x.shape
    return (x.view(torch.uint8).view(r, l, 4).permute(0, 2, 1)
            .reshape(4 * r, l).view(torch.int8))


def widen_u8_to_i32_reference(x: torch.Tensor) -> torch.Tensor:
    """(4R, L) u8 or int8 -> (R, L) int32: the inverse of the narrow."""
    r4, l = x.shape
    return (x.view(torch.uint8).view(r4 // 4, 4, l).permute(0, 2, 1)
            .reshape(r4 // 4, 4 * l).view(torch.int32))


def packed_roll_reference(x: torch.Tensor, shift: int) -> torch.Tensor:
    """(R, L) int32 rolled by ``shift`` along the row (np.roll's sign)."""
    return torch.roll(x, int(shift), dims=1)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bitcast")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("bitcast_narrow", "bitcast_widen"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, ll, ll, i, p]
        fn.restype = i
    lib.bitcast_roll.argtypes = [p, p, ll, ll, ll, i, p]
    lib.bitcast_roll.restype = i
    lib.bitcast_error_string.argtypes = [i]
    lib.bitcast_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, dtypes, name: str, row_multiple: int = 1) -> None:
    if x.dtype not in dtypes or x.dim() != 2:
        raise ValueError(f"{name} needs a 2-D {' or '.join(map(str, dtypes))} "
                         f"tensor, got {tuple(x.shape)} {x.dtype}")
    rows, cols = x.shape
    if rows < row_multiple or rows % row_multiple or cols < 1:
        raise ValueError(f"{name} needs rows a positive multiple of "
                         f"{row_multiple} and at least one column, got "
                         f"{tuple(x.shape)}")


def _launch(entry: str, x: torch.Tensor, out: torch.Tensor, rows: int,
            cols: int, *extra: int) -> torch.Tensor:
    """One kernel on the tensor's CUDA device and current stream."""
    global launches
    if not x.is_contiguous():
        raise ValueError(f"{entry} needs a contiguous tensor")
    dev = x.device
    lib = _lib()
    err = getattr(lib, entry)(
        x.data_ptr(), out.data_ptr(), rows, cols, *extra,
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: cudaError {err} "
                           f"({lib.bitcast_error_string(err).decode()})")
    launches += 1
    return out


def _device_error(name: str, x: torch.Tensor) -> ValueError:
    return ValueError(f"{name} runs on CUDA tensors (the kernel) or CPU "
                      f"tensors (its plain version), not on {x.device}")


def narrow_i32_to_i8(x: torch.Tensor) -> torch.Tensor:
    """(R, L) int32 -> (4R, L) int8; row 4r+b holds the little-endian byte
    b of row r. CUDA tensors launch ``csrc/bitcast.cu``; CPU tensors run
    ``narrow_i32_to_i8_reference``."""
    _check(x, (torch.int32,), "narrow_i32_to_i8")
    if x.device.type == "cpu":
        return narrow_i32_to_i8_reference(x)
    if x.device.type != "cuda":
        raise _device_error("narrow_i32_to_i8", x)
    rows, cols = x.shape
    out = torch.empty((4 * rows, cols), dtype=torch.int8, device=x.device)
    return _launch("bitcast_narrow", x, out, rows, cols)


def widen_u8_to_i32(x: torch.Tensor) -> torch.Tensor:
    """(4R, L) u8 (or int8, read as its bytes) -> (R, L) int32, word (r, l)
    packed from rows 4r..4r+3 little-endian. CUDA tensors launch
    ``csrc/bitcast.cu``; CPU tensors run ``widen_u8_to_i32_reference``."""
    _check(x, (torch.uint8, torch.int8), "widen_u8_to_i32", row_multiple=4)
    if x.device.type == "cpu":
        return widen_u8_to_i32_reference(x)
    if x.device.type != "cuda":
        raise _device_error("widen_u8_to_i32", x)
    rows, cols = x.shape[0] // 4, x.shape[1]
    out = torch.empty((rows, cols), dtype=torch.int32, device=x.device)
    return _launch("bitcast_widen", x, out, rows, cols)


def packed_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """(R, L) int32 rolled by any integer ``shift`` along the row, as
    ``np.roll(x, shift, axis=1)``: the four bytes of a word move together.
    CUDA tensors launch ``csrc/bitcast.cu``; CPU tensors run
    ``packed_roll_reference``."""
    _check(x, (torch.int32,), "packed_roll")
    if x.device.type == "cpu":
        return packed_roll_reference(x, shift)
    if x.device.type != "cuda":
        raise _device_error("packed_roll", x)
    rows, cols = x.shape
    out = torch.empty_like(x)
    return _launch("bitcast_roll", x, out, rows, cols, int(shift))
