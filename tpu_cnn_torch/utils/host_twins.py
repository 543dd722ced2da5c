"""The instance head's host twin, without JAX.

``tpu_cnn.head.cam.cam_instances`` is the numpy oracle of the instance
head, but it imports ``tpu_cnn.ops.detect_head`` (which imports jax) for
one constant, the core percentile. The port's verify CLI and its card
smoke run where jax is never imported, so this module restates the
twin's glue (the two percentile thresholds, the plateau fallback, the
ranking) with the reference's constant pinned here, and reuses the
oracle's own CAM, labelling and growth functions (``_build_cam``,
``connected_labels_np``, ``grow_labels_np``). It takes nothing from the
port's head, so a wrong constant there cannot follow into the twin.
``tests/test_torch_multi.py`` holds it equal to
``tpu_cnn.head.cam.cam_instances`` and its constant equal to both heads'.
"""

from __future__ import annotations

import numpy as np

from tpu_cnn.head import cam as host_cam

# tpu_cnn/ops/detect_head.py CAM_CORE_PERCENTILE: the instance markers
CORE_PERCENTILE = 88.0


def _instances_from_cam_np(cam: np.ndarray, img_size: int, max_instances: int):
    """(s, s) normalised CAM -> (I, 4) int32 boxes, (I,) int32 counts."""
    s = cam.shape[0]
    scale = img_size // s
    thr = max(float(np.percentile(cam, 70)), 0.25)
    mask = cam > thr
    cores = cam > max(float(np.percentile(cam, CORE_PERCENTILE)), thr)
    if not cores.any():  # plateau CAM: plain components of the mask
        cores = mask
    labels = host_cam.grow_labels_np(host_cam.connected_labels_np(cores),
                                     mask).reshape(-1)
    boxes = np.tile(np.array([0, 0, img_size - 1, img_size - 1], np.int32),
                    (max_instances, 1))
    counts = np.zeros(max_instances, dtype=np.int32)
    uniq = [int(v) for v in np.unique(labels) if v != s * s]
    ranked = sorted(uniq, key=lambda v: -(int((labels == v).sum()) * 1024
                                          + (1023 - v)))
    for i, v in enumerate(ranked[:max_instances]):
        px = np.nonzero(labels == v)[0]
        rr, cc = px // s, px % s
        counts[i] = len(px)
        boxes[i] = (int(cc.min()) * scale, int(rr.min()) * scale,
                    min(img_size - 1, (int(cc.max()) + 1) * scale),
                    min(img_size - 1, (int(rr.max()) + 1) * scale))
    return boxes, counts


def cam_instances(features: np.ndarray, fc_weight: np.ndarray,
                  img_size: int = 128, max_instances: int = 2):
    """``tpu_cnn.head.cam.cam_instances`` for (C, S*S) u8 features:
    (boxes (K, I, 4) int32, counts (K, I) int32; count 0 = absent)."""
    k = fc_weight.shape[0]
    boxes = np.zeros((k, max_instances, 4), np.int32)
    counts = np.zeros((k, max_instances), np.int32)
    for cls in range(k):
        cam = host_cam._build_cam(features, fc_weight[cls]).astype(np.float32)
        boxes[cls], counts[cls] = _instances_from_cam_np(cam, img_size,
                                                         max_instances)
    return boxes, counts
