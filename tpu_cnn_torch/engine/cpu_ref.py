"""Bit-exact CPU oracle in vectorised numpy, and the host-oracle engine:
the port's copy of ``tpu_cnn.engine.cpu_ref``.

The independent host-side implementation of the fixed-point contract that
every device path of the port is held against. Sliding-window view +
tensordot: a different formulation from the plain torch contract
(``ops.quant``), the kernels and the C++ oracle (``native``), so that a bug
in one cannot hide in all of them.

``CPURefEngine`` is the engine ``--mode cpu`` asks for (``apps.infer.
make_engine``): the C++ oracle, or this module's numpy forward.
"""

from __future__ import annotations

import time
from typing import Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from tpu_cnn_torch.models.cnn import ACCUM_BITS, DEFAULT_SHIFTS


def wrap_accum_np(x: np.ndarray, bits: int = ACCUM_BITS) -> np.ndarray:
    m = 1 << (bits - 1)
    return ((x.astype(np.int64) + m) % (2 * m) - m).astype(np.int32)


def numpy_conv_layer(
    x: np.ndarray,  # (ic, H, W) uint8
    kernel: np.ndarray,  # (oc, ic, 3, 3) int8
    shift: int,
    accum_wrap: bool = False,
) -> np.ndarray:
    """One contract layer on the host. Returns (oc, H/2, W/2) uint8."""
    ic, h, w = x.shape
    xp = np.zeros((ic, h + 2, w + 2), dtype=np.int32)
    xp[:, 1 : h + 1, 1 : w + 1] = x
    # windows: (ic, H, W, 3, 3)
    win = sliding_window_view(xp, (3, 3), axis=(1, 2))
    # conv[o, y, x] = sum_{i, dy, dx} k[o, i, dy, dx] * win[i, y, x, dy, dx]
    conv = np.tensordot(kernel.astype(np.int32), win, axes=([1, 2, 3], [0, 3, 4]))
    if accum_wrap:
        conv = wrap_accum_np(conv)
    act = np.clip(conv >> shift, 0, 255).astype(np.uint8)
    oc = kernel.shape[0]
    return act.reshape(oc, h // 2, 2, w // 2, 2).max(axis=(2, 4))


def numpy_cnn_forward(
    image: np.ndarray,  # (S, S) or flat uint8
    kernels: Sequence[np.ndarray],
    shifts: Sequence[int] = DEFAULT_SHIFTS,
    accum_wrap: bool = False,
    layer_configs=None,  # kept for API compat; geometry comes from the image
) -> np.ndarray:
    """Full forward for one image. Returns (oc, S'*S') uint8 — the same
    (64, 256) layout the reference reads back over AXI-Lite."""
    size = int(round(np.asarray(image).size ** 0.5))
    x = np.asarray(image, dtype=np.uint8).reshape(1, size, size)
    for k, s in zip(kernels, shifts):
        x = numpy_conv_layer(x, k, int(s), accum_wrap=accum_wrap)
    oc, sh, sw = x.shape
    return x.reshape(oc, sh * sw)


class CPURefEngine:
    """Engine-protocol oracle: ``run(gray) -> (features, conv_ms, read_ms)``.

    The host engine of the engine swap (``--mode cpu``), mirroring the
    reference's FPGA/ARM engine duality (``software/realtime_detect.py:
    398-451,556``). Uses the native C++ oracle when it builds and loads,
    numpy otherwise; ``backend`` names the one that runs. It has no fused
    detect: its callers run the host head twins on its features.
    """

    def __init__(
        self,
        kernels: Sequence[np.ndarray],
        shifts: Sequence[int] = DEFAULT_SHIFTS,
        use_native: bool = True,
    ):
        self.kernels = [np.asarray(k, np.int8) for k in kernels]
        self.shifts = [int(s) for s in shifts]
        self._native = None
        if use_native:
            try:
                from tpu_cnn_torch.native import oracle

                self._native = oracle.NativeOracle()
            except Exception:
                self._native = None

    @property
    def backend(self) -> str:
        return "native-c++" if self._native is not None else "numpy"

    def set_shifts(self, *shifts: int) -> None:
        """Runtime shift update — same register semantics as
        ``CUDAEngine.set_shifts`` (reference ``pynq_inference.py:226-229``)."""
        self.shifts = [int(s) for s in shifts]

    def run(self, gray: np.ndarray):
        t0 = time.perf_counter()
        img = np.asarray(gray, dtype=np.uint8).reshape(-1)
        if self._native is not None:
            feat = self._native.infer(img, self.kernels, self.shifts)
        else:
            feat = numpy_cnn_forward(img, self.kernels, self.shifts)
        conv_ms = (time.perf_counter() - t0) * 1e3
        return feat, conv_ms, 0.0

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        images = np.asarray(images, dtype=np.uint8)
        if self._native is not None:
            return self._native.infer_batch(
                images.reshape(len(images), -1), self.kernels, self.shifts
            )
        return np.stack(
            [numpy_cnn_forward(im, self.kernels, self.shifts) for im in images]
        )
