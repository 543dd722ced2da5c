"""Batched camera-frame preprocessing in torch, on the input's device: the
port of ``tpu_cnn.ops.preprocess``.

The reference preprocesses per frame on its ARM CPU: center-crop to square,
cv2.COLOR_BGR2GRAY, area-resize to the model input
(``software/realtime_detect.py:584-591``). Here the same transform runs
batched on whatever device holds the frames: one call takes raw
(B, H, W, 3) uint8 camera frames (or the other input forms below) and
returns (B, out_size, out_size) uint8 model inputs.

Grayscale is OpenCV's exact BT.601 fixed-point luma
(Y = (4899 R + 9617 G + 1868 B + 8192) >> 14, ``ops.luma``), so colour
frames give the same model inputs as the reference pipeline. The resize is
an exact integer block mean when the crop is a multiple of ``out_size``,
nearest sampling otherwise. Bit-identical to the JAX package's function,
the native twin (``native.preprocess``) and the numpy twin
(``apps.realtime.preprocess``).

The JAX function's code has no Pallas kernel under it: these are plain
torch ops. Every intermediate is int32 (torch has no shifts or masks on
uint32): the largest luma sum is 16384 * 255 + 8192.
"""

from __future__ import annotations

import torch

from tpu_cnn_torch.ops.luma import LUMA_B, LUMA_BIAS, LUMA_G, LUMA_R, LUMA_SHIFT

_ORDERS = ("bgr", "rgb")


def _check_order(channel_order: str) -> None:
    if channel_order not in _ORDERS:
        raise ValueError(f"channel_order must be 'bgr' or 'rgb', got {channel_order!r}")


def _luma(c0: torch.Tensor, c1: torch.Tensor, c2: torch.Tensor,
          channel_order: str) -> torch.Tensor:
    """int32 channels 0..2 in ``channel_order`` -> int32 luma."""
    _check_order(channel_order)
    b, g, r = (c0, c1, c2) if channel_order == "bgr" else (c2, c1, c0)
    return (LUMA_R * r + LUMA_G * g + LUMA_B * b + LUMA_BIAS) >> LUMA_SHIFT


def bt601_gray(frames: torch.Tensor, channel_order: str = "bgr") -> torch.Tensor:
    """(..., 3) uint8 colour -> (...) int32 gray (0..255),
    cv2.COLOR_BGR2GRAY-exact. A (..., 4) input's 4th byte is ignored."""
    c = frames[..., :3].to(torch.int32)
    return _luma(c[..., 0], c[..., 1], c[..., 2], channel_order)


def bt601_gray_packed(words: torch.Tensor, channel_order: str = "bgr") -> torch.Tensor:
    """(...) packed BGRX/RGBX pixels -> (...) int32 gray, the same math.

    One little-endian 32-bit word per pixel (byte 0 = channel 0;
    ``ops.luma.pack_bgrx`` packs on the host), as uint32 or int32; the 4th
    byte is ignored. The words are read as int32: after the mask, an
    arithmetic shift gives the same bytes as a logical one."""
    if words.dtype == torch.uint32:
        words = words.view(torch.int32)
    elif words.dtype != torch.int32:
        raise TypeError(f"packed pixels must be uint32 or int32, got {words.dtype}")
    return _luma(words & 0xFF, (words >> 8) & 0xFF, (words >> 16) & 0xFF,
                 channel_order)


def _to_gray(a: torch.Tensor, channel_order: str) -> torch.Tensor:
    """Any input form, cropped -> (B, h, w) int32 gray."""
    if a.ndim == 3 and a.dtype == torch.int32:
        return bt601_gray_packed(a, channel_order)
    if a.ndim == 4:
        return bt601_gray(a, channel_order)
    return a.to(torch.int32)


def preprocess_frames(frames: torch.Tensor, out_size: int = 128, channel_order: str = "bgr",
                      valid_w: int | None = None) -> torch.Tensor:
    """(B, H, W) gray, (B, H, W, 3) colour, (B, H, W, 4) colour + pad byte
    — all uint8 — or (B, H, W) uint32 (or int32) packed BGRX/RGBX, to
    (B, out_size, out_size) uint8 on the same device.

    Center-crop to square (the crop comes first, so the luma runs only on
    the kept pixels), BT.601 grayscale (cv2-exact), then an exact integer
    area mean (``sum // f**2``) when the crop side is a multiple of
    ``out_size``, else nearest sampling at ``idx = arange(out_size) * s //
    out_size`` (clipped to the crop), which upsamples a crop smaller than
    ``out_size``.

    ``valid_w``: the real frame width when the staged row pitch W is wider
    (V4L2 ``bytesperline`` padding); columns beyond it are never read.
    """
    if frames.dtype == torch.uint32:  # torch indexes no uint32: read as int32
        frames = frames.view(torch.int32)
    b, h, w = frames.shape[:3]
    vw = w if valid_w is None else valid_w
    if not 0 < vw <= w:
        raise ValueError(f"valid_w {vw} out of range for staged width {w}")
    s = min(h, vw)
    y0, x0 = (h - s) // 2, (vw - s) // 2
    crop = frames[:, y0:y0 + s, x0:x0 + s]
    if s % out_size == 0:
        f = s // out_size
        gray = _to_gray(crop, channel_order)
        sums = gray.reshape(b, out_size, f, out_size, f).sum(
            dim=(2, 4), dtype=torch.int32)
        return (sums // (f * f)).to(torch.uint8)
    # nearest sampling: select the kept rows and columns first, then the
    # luma on those pixels alone
    idx = (torch.arange(out_size, device=frames.device) * s // out_size).clamp(0, s - 1)
    kept = crop.index_select(1, idx).index_select(2, idx)
    return _to_gray(kept, channel_order).to(torch.uint8)
