"""Learned box-regression head, host side: the port's copy of
``tpu_cnn.head.bbox``. A (D+1, 4) f32 ``bbox_weight`` (last row = bias)
maps the bin-pooled features to normalised box corners: fitted in closed
form by ``fit_bbox_head`` (``apps.train_bbox``), applied by the host twins
here and on the device by ``ops.detect_head.bbox_regress``."""

from __future__ import annotations

import numpy as np

from tpu_cnn_torch.head.classify import bin_pool_np


def fit_bbox_head(
    pooled: np.ndarray,  # (N, D) bin-pooled features (bin_pool_np scale)
    boxes: np.ndarray,  # (N, 4) pixel boxes (x1, y1, x2, y2)
    img_size: int = 128,
    lam: float = 1.0,
) -> np.ndarray:
    """Closed-form ridge fit -> (D+1, 4) float32, last row = bias."""
    X = np.concatenate(
        [pooled, np.ones((len(pooled), 1), np.float32)], axis=1
    ).astype(np.float32)
    y = np.asarray(boxes, np.float32) / float(img_size - 1)
    a = X.T @ X + lam * np.eye(X.shape[1], dtype=np.float32)
    return np.linalg.solve(a, X.T @ y).astype(np.float32)


def bbox_regress_np(
    pooled: np.ndarray,  # (N, D) or (D,)
    bbox_weight: np.ndarray,  # (D+1, 4)
    img_size: int = 128,
) -> np.ndarray:
    """Host twin of ``ops.detect_head.bbox_regress``: predict, clip to
    [0, 1], scale to pixels, order corners, floor to int32.

    Returns (N, 4) int32, or (4,) for a single feature vector."""
    single = pooled.ndim == 1
    p = np.atleast_2d(pooled).astype(np.float32)
    raw = p @ bbox_weight[:-1] + bbox_weight[-1]
    raw = np.clip(raw, 0.0, 1.0) * float(img_size - 1)
    x1 = np.minimum(raw[:, 0], raw[:, 2])
    x2 = np.maximum(raw[:, 0], raw[:, 2])
    y1 = np.minimum(raw[:, 1], raw[:, 3])
    y2 = np.maximum(raw[:, 1], raw[:, 3])
    out = np.floor(np.stack([x1, y1, x2, y2], axis=1)).astype(np.int32)
    return out[0] if single else out


def bbox_regress_features_np(
    features: np.ndarray,  # (C, S*S) uint8 — raw engine output
    bbox_weight: np.ndarray,
    img_size: int = 128,
) -> tuple[int, int, int, int]:
    """Convenience for single-image host paths (infer/realtime): bin-pool
    then regress."""
    pooled = bin_pool_np(features[None])[0]
    return tuple(int(v) for v in bbox_regress_np(pooled, bbox_weight, img_size))
