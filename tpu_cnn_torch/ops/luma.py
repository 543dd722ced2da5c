"""Canonical BT.601 fixed-point luma constants (cv2.COLOR_BGR2GRAY-exact):
the port's copy of ``tpu_cnn.ops.luma``.

Single source for every grayscale twin of the port: the device path
(``ops.preprocess.bt601_gray``), the host numpy twin
(``apps.realtime.preprocess``), and the native C++ path
(``native/cnn_oracle.cpp`` — cross-language, so its copy is held
bit-identical by the tests rather than imported). numpy only.

Reference transform: ``software/realtime_detect.py:584-591`` (cv2 BGR2GRAY).
"""

from __future__ import annotations

import numpy as np

LUMA_R, LUMA_G, LUMA_B = 4899, 9617, 1868
LUMA_BIAS, LUMA_SHIFT = 8192, 14


def pack_bgrx(frames: np.ndarray) -> np.ndarray:
    """(..., H, W, 3|4) uint8 -> (..., H, W) uint32 packed pixels.

    Host-side packing for the device preprocess's packed input
    (``ops.preprocess.bt601_gray_packed``): little-endian word, byte 0 =
    channel 0. For 4-channel input this is a free reinterpret; 3-channel
    input pays one pad copy."""
    frames = np.asarray(frames, np.uint8)
    if frames.shape[-1] == 3:
        frames = np.concatenate(
            [frames, np.zeros((*frames.shape[:-1], 1), np.uint8)], axis=-1
        )
    elif frames.shape[-1] != 4:
        raise ValueError(f"expected 3 or 4 channels, got {frames.shape[-1]}")
    return np.ascontiguousarray(frames).view(np.uint32)[..., 0]


def bt601_gray_np(frame: np.ndarray, channel_order: str = "bgr") -> np.ndarray:
    """(..., 3) uint8 -> (...) uint8 luma, cv2's fixed-point rounding."""
    c = frame.astype(np.uint32)
    if channel_order == "bgr":
        b, g, r = c[..., 0], c[..., 1], c[..., 2]
    elif channel_order == "rgb":
        r, g, b = c[..., 0], c[..., 1], c[..., 2]
    else:
        raise ValueError(f"channel_order must be 'bgr' or 'rgb', got {channel_order!r}")
    return ((LUMA_R * r + LUMA_G * g + LUMA_B * b + LUMA_BIAS) >> LUMA_SHIFT).astype(
        np.uint8
    )
