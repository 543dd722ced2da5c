"""Detection head in plain PyTorch: spatial-bin classifier + CAM box.

Port of the single-box half of ``tpu_cnn.ops.detect_head``. None of these
functions is a kernel in the JAX package (they are XLA ops there), so the
port is plain torch on whatever device the tensors are on. Layouts match
the JAX package: features (B, C, S*S), pooled bins (B, C*16), boxes
(B, 4) int32 as (x1, y1, x2, y2) in image pixels.

The float matmuls here (classifier logits, the CAM contraction, the box
regression) must run in true f32: TF32 drifts by ~1e-3, enough to flip
near-tie predictions and boxes (the JAX package needed
``Precision.HIGHEST`` for the same reason). PyTorch's CUDA matmuls are f32
by default; ``engine.cuda.CUDAEngine`` refuses to start when TF32 matmul
has been switched on.
"""

from __future__ import annotations

import math

import torch

from tpu_cnn.head.cam import CAM_CENTROID_K, SATURATION_MEAN

CAM_THRESHOLD_FLOOR = 0.25
CAM_PERCENTILE = 70.0
GRID = 4


def _fc_logits(pooled: torch.Tensor, fc_weight: torch.Tensor,
               fc_bias: torch.Tensor) -> torch.Tensor:
    """Classifier logits, (B, D) x (K, D)^T + (K,), in f32."""
    return pooled @ fc_weight.T + fc_bias


def bin_pool(features: torch.Tensor, grid: int = GRID) -> torch.Tensor:
    """(B, C, S*S) u8 -> (B, C*grid*grid) f32 bin means / 255: exact
    integer bin sums, then / npx^2, then / 255 — the order the megakernel
    uses, so the two agree bit for bit."""
    b, c, ss = features.shape
    s = math.isqrt(ss)
    npx = s // grid
    fm = features.to(torch.float32).reshape(b, c, grid, npx, grid, npx)
    sums = fm.sum(dim=(3, 5))
    return (sums / float(npx * npx) / 255.0).reshape(b, c * grid * grid)


def gap_pool(features: torch.Tensor) -> torch.Tensor:
    """(B, C, S*S) u8 -> (B, C) global average, [0, 255] scale."""
    return features.to(torch.float32).mean(dim=2)


def _classify_pooled(pooled: torch.Tensor, fc_weight: torch.Tensor,
                     fc_bias: torch.Tensor):
    """(pred (B,) int32, conf (B,) f32, probs (B, K) f32) from pooled
    features."""
    logits = _fc_logits(pooled, fc_weight, fc_bias)
    probs = torch.softmax(logits, dim=-1)
    pred = torch.argmax(logits, dim=-1)
    conf = probs.gather(1, pred[:, None])[:, 0]
    return pred.to(torch.int32), conf, probs


def classify(features: torch.Tensor, fc_weight: torch.Tensor,
             fc_bias: torch.Tensor, head_mode: str = "bins"):
    pooled = bin_pool(features) if head_mode == "bins" else gap_pool(features)
    return _classify_pooled(pooled, fc_weight, fc_bias)


def cam_bbox(features: torch.Tensor, class_idx: torch.Tensor,
             fc_weight: torch.Tensor, img_size: int = 128,
             box_mode: str = "ref") -> torch.Tensor:
    """CAM boxes from u8 features: (B, 4) int32."""
    return cam_bbox_f32(features.to(torch.float32), class_idx, fc_weight,
                        img_size, box_mode=box_mode)


def cam_bbox_f32(features: torch.Tensor, class_idx: torch.Tensor,
                 fc_weight: torch.Tensor, img_size: int = 128,
                 box_mode: str = "ref") -> torch.Tensor:
    """CAM boxes from integer-valued f32 features (B, C, S*S) -> (B, 4)
    int32. ``box_mode`` "ref" is the reference threshold box, "centroid"
    the mass-centroid profile."""
    b, _, ss = features.shape
    s = math.isqrt(ss)
    cam = _normalized_cam_f32(features, class_idx, fc_weight).reshape(b, s, s)
    if box_mode == "centroid":
        return _bbox_from_cam_centroid(cam, img_size)
    return _bbox_from_cam(cam, img_size)


def _normalized_cam_f32(features: torch.Tensor, class_idx: torch.Tensor,
                        fc_weight: torch.Tensor) -> torch.Tensor:
    """The normalised (B, S*S) CAM: per-bin class weights (saturated
    channels, mean > 250, masked out) contracted with the features as one
    CAM per bin column, each pixel keeping its own bin's, then ReLU and
    max-normalisation — the JAX formulation, product for product."""
    b, c, ss = features.shape
    s = math.isqrt(ss)
    npx = s // GRID
    valid = (features.mean(dim=2) <= SATURATION_MEAN).to(torch.float32)
    w = fc_weight[class_idx.long()].reshape(b, c, GRID * GRID) * valid[:, :, None]
    camfull = torch.bmm(w.transpose(1, 2), features)  # (B, J, S*S)
    p = torch.arange(ss, device=features.device)
    binof = (p // s // npx) * GRID + (p % s) // npx
    sel = (binof[None, :] == torch.arange(GRID * GRID, device=features.device)[:, None])
    cam = (camfull * sel.to(torch.float32)[None]).sum(dim=1)  # (B, S*S)
    cam = torch.clamp_min(cam, 0.0)
    cam_max = cam.amax(dim=1, keepdim=True)
    return torch.where(cam_max > 0, cam / torch.clamp_min(cam_max, 1e-30), cam)


def _cam_threshold(flat: torch.Tensor) -> torch.Tensor:
    """(N, S*S) normalised CAMs -> (N,) threshold: percentile-70, floor
    0.25."""
    return torch.clamp_min(_percentile_topk(flat, CAM_PERCENTILE),
                           CAM_THRESHOLD_FLOOR)


def _percentile_topk(x: torch.Tensor, q_pct: float) -> torch.Tensor:
    """Linear-interpolated percentile from the two order statistics it
    needs, with the interpolation fraction computed on the host in f64 and
    applied in f32 (exactly 0.5 for 256 values) — as the JAX head does.
    ``torch.quantile`` interpolates differently and could flip ``cam > thr``
    ties."""
    n = x.shape[-1]
    q = q_pct / 100.0 * (n - 1)
    lo, hi = math.floor(q), math.ceil(q)
    tk = torch.topk(x, n - lo, dim=-1, largest=True, sorted=True).values
    a_lo = tk[..., n - 1 - lo]  # ascending order statistic [lo]
    if hi == lo:
        return a_lo
    a_hi = tk[..., n - 1 - hi]
    frac = torch.tensor(q - lo, dtype=torch.float32, device=x.device)
    return a_lo + (a_hi - a_lo) * frac


def _bbox_from_cam(cam: torch.Tensor, img_size: int,
                   thr: torch.Tensor | None = None) -> torch.Tensor:
    """(B, s, s) normalised CAM -> (B, 4) int32: threshold, extremal
    rows/cols, grid -> image scaling; the full frame when nothing is above
    the threshold."""
    b, s, _ = cam.shape
    scale = img_size // s
    if thr is None:
        thr = _cam_threshold(cam.reshape(b, s * s))
    mask = cam > thr[:, None, None]
    rows = mask.any(dim=2)  # (B, s)
    cols = mask.any(dim=1)
    idx = torch.arange(s, device=cam.device, dtype=torch.int32)
    # first / last true index; rows without any true give s / -1, which the
    # full-frame fallback below replaces
    r1 = torch.where(rows, idx, s).amin(dim=1)
    r2 = torch.where(rows, idx, -1).amax(dim=1)
    c1 = torch.where(cols, idx, s).amin(dim=1)
    c2 = torch.where(cols, idx, -1).amax(dim=1)
    x2 = torch.clamp_max((c2 + 1) * scale, img_size - 1)
    y2 = torch.clamp_max((r2 + 1) * scale, img_size - 1)
    bbox = torch.stack([c1 * scale, r1 * scale, x2, y2], dim=1)
    full = torch.tensor([0, 0, img_size - 1, img_size - 1], dtype=torch.int32,
                        device=cam.device)
    return torch.where(rows.any(dim=1)[:, None], bbox, full[None, :]).to(torch.int32)


def _bbox_from_cam_centroid(cam: torch.Tensor, img_size: int,
                            k: float = CAM_CENTROID_K) -> torch.Tensor:
    """(B, s, s) CAM -> (B, 4) int32 boxes as mass centroid +- k * stddev
    per axis; the full frame for an all-zero CAM."""
    b, s, _ = cam.shape
    scale = img_size // s
    coords = torch.arange(s, dtype=torch.float32, device=cam.device)
    tot = cam.sum(dim=(1, 2))
    safe_tot = torch.clamp_min(tot, 1e-9)
    row_mass = cam.sum(dim=2)  # (B, s), mass per y
    col_mass = cam.sum(dim=1)  # (B, s), mass per x
    cy = (row_mass * coords).sum(dim=1) / safe_tot
    cx = (col_mass * coords).sum(dim=1) / safe_tot
    vy = (row_mass * (coords[None, :] - cy[:, None]) ** 2).sum(dim=1) / safe_tot
    vx = (col_mass * (coords[None, :] - cx[:, None]) ** 2).sum(dim=1) / safe_tot
    sy, sx = torch.sqrt(vy), torch.sqrt(vx)
    eps = 1e-6
    x1 = torch.floor(torch.clamp_min(cx - k * sx, 0.0) * scale)
    y1 = torch.floor(torch.clamp_min(cy - k * sy, 0.0) * scale)
    x2 = torch.floor(torch.clamp_max(cx + k * sx + 1.0, s - eps) * scale)
    y2 = torch.floor(torch.clamp_max(cy + k * sy + 1.0, s - eps) * scale)
    x2 = torch.clamp_max(x2, img_size - 1)
    y2 = torch.clamp_max(y2, img_size - 1)
    bbox = torch.stack([x1, y1, x2, y2], dim=1).to(torch.int32)
    full = torch.tensor([0, 0, img_size - 1, img_size - 1], dtype=torch.int32,
                        device=cam.device)
    return torch.where((tot > 0)[:, None], bbox, full[None, :])


def bbox_regress(pooled: torch.Tensor, bbox_weight: torch.Tensor,
                 img_size: int = 128) -> torch.Tensor:
    """Learned box head (box_mode "reg"): (B, D) pooled bins x (D+1, 4)
    weights (last row the bias) -> (B, 4) int32."""
    raw = pooled @ bbox_weight[:-1] + bbox_weight[-1]
    raw = raw.clamp(0.0, 1.0) * float(img_size - 1)
    x1 = torch.minimum(raw[:, 0], raw[:, 2])
    x2 = torch.maximum(raw[:, 0], raw[:, 2])
    y1 = torch.minimum(raw[:, 1], raw[:, 3])
    y2 = torch.maximum(raw[:, 1], raw[:, 3])
    return torch.floor(torch.stack([x1, y1, x2, y2], dim=1)).to(torch.int32)


def detect_with_pooled(features: torch.Tensor | None, pooled: torch.Tensor,
                       fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                       img_size: int = 128,
                       features_twin: torch.Tensor | None = None,
                       box_mode: str = "ref",
                       bbox_weight: torch.Tensor | None = None):
    """Classify + box when the bin pooling already ran in the megakernel.
    The CAM reads the kernel's bf16 feature twin (upcast to f32 exactly)
    when given, else the u8 features; "reg" reads only the pooled bins.
    Returns (pred, conf, probs, bbox)."""
    pred, conf, probs = _classify_pooled(pooled, fc_weight, fc_bias)
    if box_mode == "reg":
        bbox = bbox_regress(pooled, bbox_weight, img_size)
    elif features_twin is not None:
        bbox = cam_bbox_f32(features_twin.to(torch.float32), pred, fc_weight,
                            img_size, box_mode=box_mode)
    elif features is not None:
        bbox = cam_bbox(features, pred, fc_weight, img_size, box_mode=box_mode)
    else:
        raise ValueError("CAM box modes need features or features_twin")
    return pred, conf, probs, bbox


def detect(features: torch.Tensor, fc_weight: torch.Tensor,
           fc_bias: torch.Tensor, head_mode: str = "bins",
           img_size: int = 128, box_mode: str = "ref",
           bbox_weight: torch.Tensor | None = None):
    """Classify + box from u8 features. Returns (pred, conf, probs, bbox)."""
    pred, conf, probs = classify(features, fc_weight, fc_bias, head_mode)
    if box_mode == "reg":
        bbox = bbox_regress(bin_pool(features), bbox_weight, img_size)
    elif head_mode == "bins":
        bbox = cam_bbox(features, pred, fc_weight, img_size, box_mode=box_mode)
    else:
        # the 64-d GAP head has no spatial weights: the CAM falls back to
        # the unweighted activation map (valid-channel mean)
        uniform_w = torch.ones((fc_weight.shape[0], features.shape[1] * GRID * GRID),
                               dtype=torch.float32, device=features.device)
        bbox = cam_bbox(features, pred, uniform_w, img_size, box_mode=box_mode)
    return pred, conf, probs, bbox
