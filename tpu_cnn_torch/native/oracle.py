"""ctypes binding for the native C++ oracle (``cnn_oracle.cpp``): the
port's copy of ``tpu_cnn.native.oracle``, built by ``ops._build``."""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

from tpu_cnn_torch.ops import _build


class NativeOracle:
    """Bit-exact compiled forward pass, independent of the torch and numpy
    paths."""

    def __init__(self):
        lib = ctypes.CDLL(_build.build_host())
        lib.tcnn_forward.argtypes = [
            ctypes.c_void_p,  # images
            ctypes.c_int,  # batch
            ctypes.c_void_p,  # kernels (concat int8)
            ctypes.c_void_p,  # layer_cfg (ic, oc, size) * n
            ctypes.c_int,  # n_layers
            ctypes.c_void_p,  # shifts
            ctypes.c_void_p,  # out
        ]
        lib.tcnn_forward.restype = ctypes.c_int
        lib.tcnn_num_threads.restype = ctypes.c_int
        self._lib = lib

    @property
    def num_threads(self) -> int:
        return int(self._lib.tcnn_num_threads())

    def infer_batch(
        self,
        images: np.ndarray,  # (B, H*W) or (B, H, W) uint8
        kernels: Sequence[np.ndarray],  # per-layer (oc, ic, 3, 3) int8
        shifts: Sequence[int],
    ) -> np.ndarray:
        images = np.ascontiguousarray(images, dtype=np.uint8)
        batch = images.shape[0]
        size0 = int(round((images.size // batch) ** 0.5))
        sizes, s = [], size0
        for _ in kernels:
            sizes.append(s)
            s //= 2
        layer_cfg = np.asarray(
            [[k.shape[1], k.shape[0], sz] for k, sz in zip(kernels, sizes)],
            dtype=np.int32).ravel()
        kern_blob = np.concatenate(
            [np.ascontiguousarray(k, dtype=np.int8).ravel() for k in kernels])
        shifts_arr = np.asarray(list(shifts), dtype=np.int32)
        last_oc = kernels[-1].shape[0]
        last_hw = (sizes[-1] // 2) ** 2
        out = np.empty((batch, last_oc * last_hw), dtype=np.uint8)
        rc = self._lib.tcnn_forward(
            images.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(batch),
            kern_blob.ctypes.data_as(ctypes.c_void_p),
            layer_cfg.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(len(kernels)),
            shifts_arr.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p),
        )
        if rc != 0:
            raise RuntimeError(f"tcnn_forward failed: rc={rc}")
        return out.reshape(batch, last_oc, last_hw)

    def infer(self, image: np.ndarray, kernels: Sequence[np.ndarray],
              shifts: Sequence[int]) -> np.ndarray:
        return self.infer_batch(
            np.asarray(image, np.uint8).reshape(1, -1), kernels, shifts)[0]
