"""Host-side CAM bounding boxes: the port's copy of ``tpu_cnn.head.cam``.

The numpy twins the device head (``ops.detect_head``) is held against:
  * fast:    grid-space threshold with 0.25 floor, x scale coordinates
             (``cam_bbox_fast``; per class: ``cam_bbox_multi``)
  * centroid: CAM mass centroid +- k stddev (``cam_bbox_centroid``)
  * hi-res:  bilinear upscale of the CAM to the image, percentile-70
             threshold with 0.2 floor, 3-px padding (``cam_bbox_hires``,
             the infer CLI's printed box; needs PIL)
  * instances: marker-based watershed components per class
             (``cam_instances``)
"""

from __future__ import annotations

import numpy as np

SATURATION_MEAN = 250.0
# Centroid box profile: box = CAM mass centroid +- K * mass stddev.
# ops.detect_head imports this as the single source of truth.
CAM_CENTROID_K = 1.25
# the instance markers' percentile of the CAM (the JAX package keeps it in
# tpu_cnn/ops/detect_head.py, a module that imports jax; the port's device
# head keeps its own, so a wrong constant there cannot follow into this twin)
CAM_CORE_PERCENTILE = 88.0


def _build_cam(features: np.ndarray, class_weights: np.ndarray, grid: int = 4):
    """(C, S*S) features + (C*grid*grid,) weights -> (S, S) CAM, normalised."""
    c, ss = features.shape
    s = int(round(ss**0.5))
    npx = s // grid
    fm = features.astype(np.float32).reshape(c, s, s)
    w = class_weights.reshape(c, grid, grid)
    w_exp = np.repeat(np.repeat(w, npx, axis=1), npx, axis=2)  # (C, s, s)
    valid = fm.mean(axis=(1, 2)) <= SATURATION_MEAN
    w_exp = w_exp * valid[:, None, None]
    cam = (w_exp * fm).sum(axis=0)
    cam = np.maximum(cam, 0.0)
    if cam.max() > 0:
        cam = cam / cam.max()
    return cam


def cam_bbox_fast(
    features: np.ndarray,  # (C, S*S) uint8
    class_idx: int,
    fc_weight: np.ndarray,  # (num_classes, C*16)
    img_size: int = 128,
) -> tuple[int, int, int, int]:
    """Grid-space CAM bbox (``realtime_detect.bbox_vec`` semantics)."""
    cam = _build_cam(features, fc_weight[class_idx])
    s = cam.shape[0]
    scale = img_size // s
    thr = max(float(np.percentile(cam, 70)), 0.25)
    mask = cam > thr
    if not mask.any():
        return (0, 0, img_size - 1, img_size - 1)
    rows, cols = mask.any(axis=1), mask.any(axis=0)
    r1, r2 = np.where(rows)[0][[0, -1]]
    c1, c2 = np.where(cols)[0][[0, -1]]
    return (
        int(c1 * scale),
        int(r1 * scale),
        int(min(img_size - 1, (c2 + 1) * scale)),
        int(min(img_size - 1, (r2 + 1) * scale)),
    )


def cam_bbox_centroid(
    features: np.ndarray,  # (C, S*S) uint8
    class_idx: int,
    fc_weight: np.ndarray,  # (num_classes, C*16)
    img_size: int = 128,
    k: float = CAM_CENTROID_K,
) -> tuple[int, int, int, int]:
    """Centroid-profile CAM bbox — host twin of
    ``ops.detect_head._bbox_from_cam_centroid`` (f32 math to match device).

    Box = CAM mass centroid +- k * mass stddev per axis, scaled to image
    pixels. Calibrated k=1.25 on a held-out synthetic split
    (scripts/probe_boxes.py): mean IoU 0.407 vs 0.355 for the reference
    threshold box.
    """
    cam = _build_cam(features, fc_weight[class_idx]).astype(np.float32)
    s = cam.shape[0]
    scale = img_size // s
    tot = np.float32(cam.sum())
    if tot <= 0:
        return (0, 0, img_size - 1, img_size - 1)
    coords = np.arange(s, dtype=np.float32)
    row_mass = cam.sum(axis=1, dtype=np.float32)
    col_mass = cam.sum(axis=0, dtype=np.float32)
    cy = float((row_mass * coords).sum() / tot)
    cx = float((col_mass * coords).sum() / tot)
    sy = float(np.sqrt((row_mass * (coords - cy) ** 2).sum() / tot))
    sx = float(np.sqrt((col_mass * (coords - cx) ** 2).sum() / tot))
    eps = 1e-6
    x1 = int(np.floor(max(0.0, cx - k * sx) * scale))
    y1 = int(np.floor(max(0.0, cy - k * sy) * scale))
    x2 = min(img_size - 1, int(np.floor(min(s - eps, cx + k * sx + 1.0) * scale)))
    y2 = min(img_size - 1, int(np.floor(min(s - eps, cy + k * sy + 1.0) * scale)))
    return (x1, y1, x2, y2)


def cam_bbox_multi(
    features: np.ndarray,  # (C, S*S) uint8
    fc_weight: np.ndarray,  # (num_classes, C*16)
    img_size: int = 128,
    box_mode: str = "ref",
) -> np.ndarray:
    """Per-class CAM boxes for every class — (num_classes, 4) int32.

    Host twin of ``ops.detect_head.cam_bbox_multi_f32``: row k is exactly
    the single-class box with the class forced to k, so the twin is the
    single-class twin applied per class. The reference head has no
    multi-object mode (one argmax box, ``software/realtime_detect.py:
    85-116``); this powers the beyond-reference ``--multi`` surface.
    """
    fn = cam_bbox_centroid if box_mode == "centroid" else cam_bbox_fast
    return np.asarray(
        [fn(features, k, fc_weight, img_size=img_size)
         for k in range(fc_weight.shape[0])],
        dtype=np.int32,
    )


def connected_labels_np(mask: np.ndarray) -> np.ndarray:
    """4-connected component labels of one (s, s) boolean mask — host twin
    of ``ops.detect_head._connected_labels``: each masked pixel labelled
    with the MINIMUM flat (row-major) index of its component, background
    = s*s. Row-major BFS seeding guarantees the seed IS the component's
    minimum index, so the integer labels equal the device fixed point
    exactly."""
    s = mask.shape[0]
    labels = np.full((s, s), s * s, dtype=np.int32)
    for seed in range(s * s):
        r, c = divmod(seed, s)
        if not mask[r, c] or labels[r, c] != s * s:
            continue
        stack = [(r, c)]
        labels[r, c] = seed
        while stack:
            y, x = stack.pop()
            for ny, nx in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
                if (0 <= ny < s and 0 <= nx < s and mask[ny, nx]
                        and labels[ny, nx] == s * s):
                    labels[ny, nx] = seed
                    stack.append((ny, nx))
    return labels


def grow_labels_np(labels: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Layer-synchronous marker growth — host twin of
    ``ops.detect_head._grow_labels``: per BFS layer, every unlabeled mask
    pixel adopts the MINIMUM label among its labeled 4-neighbours; labeled
    pixels are frozen. Identical layer rule = identical contested-pixel
    assignment as the device."""
    s = mask.shape[0]
    sent = s * s
    lab = labels.copy()
    while True:
        p = np.pad(lab, 1, constant_values=sent)
        nmin = np.minimum.reduce(
            [p[:-2, 1:-1], p[2:, 1:-1], p[1:-1, :-2], p[1:-1, 2:]]
        )
        new = np.where(mask & (lab == sent) & (nmin != sent), nmin, lab)
        if np.array_equal(new, lab):
            return lab
        lab = new


def _instances_from_cam_np(
    cam: np.ndarray, img_size: int, max_instances: int
) -> tuple[np.ndarray, np.ndarray]:
    """(s, s) normalised CAM -> (I, 4) int32 boxes + (I,) int32 pixel
    counts; host twin of ``ops.detect_head._instances_from_cam``: same
    marker-based watershed (percentile-88 cores grown through the
    percentile-70 mask), same integer ranking key
    count*1024 + (1023 - label)."""
    s = cam.shape[0]
    scale = img_size // s
    thr = max(float(np.percentile(cam, 70)), 0.25)
    mask = cam > thr
    core_thr = max(float(np.percentile(cam, CAM_CORE_PERCENTILE)), thr)
    cores = cam > core_thr
    if not cores.any():  # plateau CAM — degrade to plain components
        cores = mask
    labels = grow_labels_np(connected_labels_np(cores), mask).reshape(-1)
    boxes = np.tile(
        np.array([0, 0, img_size - 1, img_size - 1], np.int32),
        (max_instances, 1),
    )
    counts = np.zeros(max_instances, dtype=np.int32)
    uniq = [int(l) for l in np.unique(labels) if l != s * s]
    key = sorted(uniq, key=lambda l: -(int((labels == l).sum()) * 1024
                                       + (1023 - l)))
    for i, l in enumerate(key[:max_instances]):
        px = np.nonzero(labels == l)[0]
        rr, cc = px // s, px % s
        counts[i] = len(px)
        boxes[i] = (
            int(cc.min()) * scale,
            int(rr.min()) * scale,
            min(img_size - 1, (int(cc.max()) + 1) * scale),
            min(img_size - 1, (int(rr.max()) + 1) * scale),
        )
    return boxes, counts


def cam_instances(
    features: np.ndarray,  # (C, S*S) uint8
    fc_weight: np.ndarray,  # (num_classes, C*16)
    img_size: int = 128,
    max_instances: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-class multi-INSTANCE boxes — host twin of
    ``ops.detect_head.cam_instances_f32``: up to ``max_instances``
    connected components per class CAM, size-desc with top-left tie-break.
    Returns (boxes (K, I, 4) int32, counts (K, I) int32; count 0 =
    absent). The reference head has no such mode; see the device twin's
    docstring for the semantics."""
    k = fc_weight.shape[0]
    boxes = np.zeros((k, max_instances, 4), np.int32)
    counts = np.zeros((k, max_instances), np.int32)
    for cls in range(k):
        cam = _build_cam(features, fc_weight[cls]).astype(np.float32)
        boxes[cls], counts[cls] = _instances_from_cam_np(
            cam, img_size, max_instances
        )
    return boxes, counts


def cam_bbox_hires(
    features: np.ndarray,  # (C, S*S) uint8
    class_idx: int,
    fc_weight: np.ndarray,  # (num_classes, C*16)
    img_size: int = 128,
    pad: int = 3,
):
    """Hi-res CAM bbox (``pynq_inference.Classifier.get_cam_bbox`` semantics).

    Returns (cam_full (img_size, img_size) float32 in [0,1], bbox).
    """
    from PIL import Image

    cam = _build_cam(features, fc_weight[class_idx])
    cam_img = Image.fromarray((cam * 255).astype(np.uint8))
    cam_img = cam_img.resize((img_size, img_size), Image.BILINEAR)
    cam_full = np.asarray(cam_img).astype(np.float32) / 255.0

    thr = max(float(np.percentile(cam_full, 70)), 0.2)
    mask = cam_full > thr
    if mask.any():
        rows, cols = np.any(mask, axis=1), np.any(mask, axis=0)
        y1, y2 = np.where(rows)[0][[0, -1]]
        x1, x2 = np.where(cols)[0][[0, -1]]
        x1 = max(0, int(x1) - pad)
        y1 = max(0, int(y1) - pad)
        x2 = min(img_size - 1, int(x2) + pad)
        y2 = min(img_size - 1, int(y2) + pad)
    else:
        x1, y1, x2, y2 = 0, 0, img_size - 1, img_size - 1
    return cam_full, (x1, y1, x2, y2)
