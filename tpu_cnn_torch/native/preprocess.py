"""ctypes binding for the native batched frame preprocess
(``tcnn_preprocess`` in ``cnn_oracle.cpp``): the port's copy of
``tpu_cnn.native.preprocess``, built by ``ops._build``.

Host-side twin of the device path (``ops.preprocess.preprocess_frames``)
and of the reference's per-frame ARM preprocess
(``software/realtime_detect.py:584-591``). Used when frames are reduced on
the host (the realtime app's host preprocess, the host-oracle engine);
bit-identical to both twins (``tests/test_torch_preprocess.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np

from tpu_cnn_torch.ops import _build

_lib = None


def _get_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build_host())
        lib.tcnn_preprocess.argtypes = [
            ctypes.c_void_p,  # frames
            ctypes.c_int,  # batch
            ctypes.c_int,  # H
            ctypes.c_int,  # W
            ctypes.c_int,  # channels
            ctypes.c_int,  # bgr
            ctypes.c_int,  # out_size
            ctypes.c_void_p,  # out
        ]
        lib.tcnn_preprocess.restype = ctypes.c_int
        _lib = lib
    return _lib


def preprocess_frames_native(
    frames: np.ndarray, out_size: int = 128, channel_order: str = "bgr"
) -> np.ndarray:
    """(B, H, W[, 3]) uint8 -> (B, out_size, out_size) uint8.

    Center-crop to square, BT.601 grayscale (cv2-exact), exact area mean
    (or nearest sampling for non-divisible crops). OpenMP over the batch.
    """
    if channel_order not in ("bgr", "rgb"):
        raise ValueError(f"channel_order must be 'bgr' or 'rgb', got {channel_order!r}")
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    squeeze = False
    if frames.ndim == 2:  # single gray frame
        frames = frames[None, ..., None]
        squeeze = True
    elif frames.ndim == 3 and frames.shape[-1] == 3:  # single color frame
        frames = frames[None]
        squeeze = True
    elif frames.ndim == 3:  # batch of gray frames
        frames = frames[..., None]
    b, h, w, c = frames.shape
    out = np.empty((b, out_size, out_size), np.uint8)
    rc = _get_lib().tcnn_preprocess(
        frames.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(b), ctypes.c_int(h), ctypes.c_int(w), ctypes.c_int(c),
        ctypes.c_int(1 if channel_order == "bgr" else 0),
        ctypes.c_int(out_size),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    if rc != 0:
        raise RuntimeError(f"tcnn_preprocess failed: rc={rc} "
                           f"(shape {frames.shape}, out_size {out_size})")
    return out[0] if squeeze else out
