"""weights.bin codec — the hardware weight format: the port's copy of
``tpu_cnn.utils.weights``' codec.

Per layer, output channels are grouped in batches of 16, and within each
(batch, input-channel) pass the 16 cores' 3x3 kernels are stored
consecutively, row-major:

    for ob in range(oc // 16):          # output-channel batch
      for ic in range(in_channels):     # one pass per input channel
        for core in range(16):          # oc = ob*16 + core
          9 bytes: int8 kernel[oc][ic] row-major

The (de)serialisation is one reshape/transpose:
``raw.reshape(ob, ic, 16, 3, 3) -> (ob, 16, ic, 3, 3)``.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from tpu_cnn_torch.models.cnn import LAYER_CONFIGS


def decode_weights(
    blob: bytes | np.ndarray,
    layer_configs: Sequence[tuple[int, int, int]] = LAYER_CONFIGS,
) -> list[np.ndarray]:
    """Decode a weights.bin byte blob into per-layer (oc, ic, 3, 3) int8."""
    raw = np.frombuffer(bytes(blob), dtype=np.int8) if isinstance(
        blob, (bytes, bytearray)
    ) else np.asarray(blob).view(np.int8).ravel()
    expected = sum(oc * ic * 9 for ic, oc, _ in layer_configs)
    if raw.size != expected:
        raise ValueError(f"expected {expected} weight bytes, got {raw.size}")

    kernels = []
    off = 0
    for ic, oc, _ in layer_configs:
        n = oc * ic * 9
        chunk = raw[off : off + n]
        off += n
        # (ob, ic, core, 3, 3) -> (ob, core, ic, 3, 3) -> (oc, ic, 3, 3)
        k = (
            chunk.reshape(oc // 16, ic, 16, 3, 3)
            .transpose(0, 2, 1, 3, 4)
            .reshape(oc, ic, 3, 3)
        )
        kernels.append(np.ascontiguousarray(k))
    return kernels


def encode_weights(kernels: Sequence[np.ndarray]) -> bytes:
    """Inverse of :func:`decode_weights` — per-layer (oc, ic, 3, 3) int8 -> bytes."""
    parts = []
    for k in kernels:
        k = np.asarray(k, dtype=np.int8)
        oc, ic = k.shape[:2]
        if oc % 16:
            raise ValueError("output channels must be a multiple of 16")
        part = (
            k.reshape(oc // 16, 16, ic, 3, 3)
            .transpose(0, 2, 1, 3, 4)
            .reshape(-1)
        )
        parts.append(part)
    return np.concatenate(parts).tobytes()


def load_weights_bin(
    path: str | os.PathLike,
    layer_configs: Sequence[tuple[int, int, int]] = LAYER_CONFIGS,
) -> list[np.ndarray]:
    """Load and decode a weights.bin file (23,184 bytes for the stock net)."""
    blob = np.fromfile(os.fspath(path), dtype=np.int8)
    return decode_weights(blob, layer_configs)


def save_weights_bin(path: str | os.PathLike, kernels: Sequence[np.ndarray]) -> None:
    blob = encode_weights(kernels)
    with open(os.fspath(path), "wb") as f:
        f.write(blob)
