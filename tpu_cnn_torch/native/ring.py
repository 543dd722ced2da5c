"""ctypes binding for the native frame ring (``frame_ring.cpp``): the
port's copy of ``tpu_cnn.native.ring``, on the host library ``tcnn_host``
built by ``ops._build``.

The native data-loader between capture and the engine: producer threads
push raw camera frames (the crop/BT.601/resize preprocess runs in C++, off
the GIL), the consumer drains engine-sized batches of preprocessed frames.
Latest-wins overflow (oldest dropped, counted) and a frame-age signal for
the stall watchdog — the batched, native generalisation of the reference's
single-slot capture thread.
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
        lib.tcnn_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.tcnn_ring_create.restype = ctypes.c_void_p
        lib.tcnn_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.tcnn_ring_push.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.tcnn_ring_push.restype = ctypes.c_uint64
        lib.tcnn_ring_pop.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.tcnn_ring_pop.restype = ctypes.c_int
        lib.tcnn_ring_wait.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
        ]
        lib.tcnn_ring_wait.restype = ctypes.c_int
        lib.tcnn_ring_dropped.argtypes = [ctypes.c_void_p]
        lib.tcnn_ring_dropped.restype = ctypes.c_uint64
        lib.tcnn_ring_age_s.argtypes = [ctypes.c_void_p]
        lib.tcnn_ring_age_s.restype = ctypes.c_double
        _lib = lib
    return _lib


class NativeFrameRing:
    """Bounded ring of natively-preprocessed frames.

    ``push(frame)`` accepts (H, W) gray or (H, W, 3) BGR/RGB uint8 and
    returns the frame's sequence number; ``pop_batch(n)`` returns up to n
    preprocessed (out_size, out_size) frames oldest-first; ``wait(n, t)``
    blocks (GIL released) until n frames are queued or t seconds pass.
    """

    def __init__(self, capacity: int = 64, out_size: int = 128,
                 channel_order: str = "bgr"):
        if channel_order not in ("bgr", "rgb"):
            raise ValueError(f"channel_order must be bgr|rgb, got {channel_order!r}")
        self._lib = _get_lib()
        self._bgr = 1 if channel_order == "bgr" else 0
        self.out_size = out_size
        self.capacity = capacity
        self._ring = self._lib.tcnn_ring_create(capacity, out_size)
        if not self._ring:
            raise RuntimeError("tcnn_ring_create failed")

    def push(self, frame: np.ndarray) -> int:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.ndim == 2:
            h, w, c = *frame.shape, 1
        elif frame.ndim == 3 and frame.shape[-1] in (1, 3):
            h, w, c = frame.shape
        else:
            raise ValueError(f"frame must be (H, W) or (H, W, 1|3), got {frame.shape}")
        seq = self._lib.tcnn_ring_push(
            self._ring, frame.ctypes.data_as(ctypes.c_void_p),
            h, w, c, self._bgr,
        )
        if seq == 0:
            raise RuntimeError("tcnn_ring_push failed")
        return int(seq)

    def pop_batch(self, max_frames: int) -> np.ndarray:
        out = np.empty((max_frames, self.out_size, self.out_size), np.uint8)
        n = self._lib.tcnn_ring_pop(
            self._ring, out.ctypes.data_as(ctypes.c_void_p), max_frames
        )
        return out[:n]

    def wait(self, min_frames: int = 1, timeout_s: float = 1.0) -> int:
        return int(self._lib.tcnn_ring_wait(
            self._ring, min_frames, ctypes.c_double(timeout_s)
        ))

    @property
    def dropped(self) -> int:
        return int(self._lib.tcnn_ring_dropped(self._ring))

    def age_s(self) -> float:
        """Seconds since the last push — the stall-watchdog signal."""
        return float(self._lib.tcnn_ring_age_s(self._ring))

    def close(self) -> None:
        if self._ring:
            self._lib.tcnn_ring_destroy(self._ring)
            self._ring = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:
            pass
