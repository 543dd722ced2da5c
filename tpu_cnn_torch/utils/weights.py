"""weights.bin codec — the hardware weight format — and the export
quantisers: the port's copy of ``tpu_cnn.utils.weights``' codec,
``quantize_global`` and ``quantize_per_layer``.

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

from tpu_cnn_torch.models.cnn import LAYER_CONFIGS, QUANT_MAX


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


def quantize_global(
    float_kernels: Sequence[np.ndarray], quant_max: int = QUANT_MAX
) -> tuple[list[np.ndarray], float]:
    """Quantise float kernels with one global symmetric scale.

    Returns (int8 kernels, scale) with ``scale = quant_max / max|w|``
    (reference ``training/train_cnn.py:133-137,180-189``).
    """
    absmax = max(float(np.abs(np.asarray(k)).max()) for k in float_kernels)
    scale = quant_max / max(absmax, 1e-8)
    q = [
        np.clip(np.round(np.asarray(k, dtype=np.float64) * scale), -quant_max, quant_max).astype(
            np.int8
        )
        for k in float_kernels
    ]
    return q, scale


def quantize_per_layer(
    float_kernels: Sequence[np.ndarray], quant_max: int = QUANT_MAX
) -> tuple[list[np.ndarray], list[float]]:
    """Quantise each layer's kernels with its OWN symmetric scale.

    Beyond-reference export option (``train_cnn --per-layer-scale``): the
    reference's single global scale (``training/train_cnn.py:133-137``)
    lets the layer with the largest |w| squeeze every other layer's int8
    precision. Per-layer scales give each layer the full +-127 grid. The
    runtime contract is unchanged (int8 weights + the per-layer shift
    register absorb any power-of-two gain; heads are refit on dumped
    features), so every engine, kernel and the byte layout stay the same.
    """
    q, scales = [], []
    for k in float_kernels:
        absmax = max(float(np.abs(np.asarray(k)).max()), 1e-8)
        scale = quant_max / absmax
        q.append(
            np.clip(np.round(np.asarray(k, np.float64) * scale),
                    -quant_max, quant_max).astype(np.int8)
        )
        scales.append(scale)
    return q, scales
