"""Host-side (numpy) classifier head: the port's copy of
``tpu_cnn.head.classify``, the twin the device head is held against."""

from __future__ import annotations

import numpy as np


def bin_pool_np(features: np.ndarray, grid: int = 4) -> np.ndarray:
    """(..., C, S*S) uint8 -> (..., C*grid*grid) float32 bin means / 255."""
    *lead, c, ss = features.shape
    s = int(round(ss**0.5))
    npx = s // grid
    fm = features.astype(np.float32).reshape(*lead, c, grid, npx, grid, npx)
    pooled = fm.mean(axis=(-3, -1))  # (..., C, grid, grid)
    return pooled.reshape(*lead, c * grid * grid) / 255.0


def gap_pool_np(features: np.ndarray) -> np.ndarray:
    """(..., C, S*S) uint8 -> (..., C) global average in [0, 255] scale."""
    return features.astype(np.float32).mean(axis=-1)


def pool_for_head(features: np.ndarray, fc_weight: np.ndarray) -> np.ndarray:
    d = fc_weight.shape[1]
    c = features.shape[-2]
    if d == c:
        return gap_pool_np(features)
    if d == c * 16:
        return bin_pool_np(features)
    raise ValueError(f"fc feature dim {d} matches neither GAP ({c}) nor bins ({c * 16})")


def classify_np(
    features: np.ndarray,  # (C, S*S) or (B, C, S*S) uint8
    fc_weight: np.ndarray,
    fc_bias: np.ndarray,
    class_names: list[str] | None = None,
):
    """Single-image API mirroring ``realtime_detect.classify_vec``:
    returns (idx, name, conf, probs); batched input returns arrays."""
    single = features.ndim == 2
    feats = features[None] if single else features
    pooled = pool_for_head(feats, fc_weight)
    logits = pooled @ fc_weight.T + fc_bias
    logits = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(logits)
    probs = e / e.sum(axis=-1, keepdims=True)
    idx = probs.argmax(axis=-1)
    conf = probs[np.arange(len(idx)), idx]
    if single:
        i = int(idx[0])
        name = class_names[i] if class_names else str(i)
        return i, name, float(conf[0]), probs[0]
    return idx, conf, probs


def multi_scores_np(
    pooled: np.ndarray,  # (B, D) or (D,) — pool_for_head output
    multi_w: np.ndarray,  # (num_classes, D) float32
    multi_b: np.ndarray,  # (num_classes,) float32
) -> np.ndarray:
    """Host twin of ``ops.detect_head.multi_scores``: per-class sigmoid
    presence scores from the learned multi-label head
    (``apps.calibrate_multi --fit-head``). Unlike softmax probabilities
    these do not sum to 1, so co-present objects don't suppress each
    other — the score space the calibrated ``multi_thresh.json`` floors
    live in when ``multi_head.npz`` ships with the bundle. Float32
    throughout, same formulation as the device head (parity to ~1 ulp —
    the sigmoid exp is transcendental, so tests compare with a tight
    allclose rather than bit equality)."""
    z = (pooled @ multi_w.T + multi_b).astype(np.float32)
    # exp overflow at very negative z saturates to inf -> sigmoid 0.0,
    # exactly the right value; silence the (benign) RuntimeWarning so
    # eval sweeps don't spam it
    with np.errstate(over="ignore"):
        return (1.0 / (1.0 + np.exp(-z))).astype(np.float32)
