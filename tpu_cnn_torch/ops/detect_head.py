"""Detection heads in plain PyTorch: spatial-bin classifier, CAM boxes,
the multi-object and instance heads.

Port of ``tpu_cnn.ops.detect_head``. None of these functions is a kernel
in the JAX package (they are XLA ops there), so the port is plain torch on
whatever device the tensors are on. Layouts match the JAX package:
features (B, C, S*S), pooled bins (B, C*16), boxes (B, 4) int32 as (x1,
y1, x2, y2) in image pixels; the multi head's per-class boxes (B, K, 4),
instance boxes (B, K, I, 4) and instance pixel counts (B, K, I).

The float matmuls here (classifier logits, the CAM contraction, the box
regression, the presence scores) must run in true f32: TF32 drifts by
~1e-3, enough to flip near-tie predictions and boxes (the JAX package
needed ``Precision.HIGHEST`` for the same reason). PyTorch's CUDA matmuls
are f32 by default; ``engine.cuda.CUDAEngine`` refuses to start when TF32
matmul has been switched on.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._higher_order_ops import while_loop

from tpu_cnn_torch.head.cam import CAM_CENTROID_K, SATURATION_MEAN

CAM_THRESHOLD_FLOOR = 0.25
CAM_PERCENTILE = 70.0
GRID = 4
# Instance head constants, the JAX package's (calibrated there on
# same-class composite scenes): markers are the connected components of
# cam > percentile-88; components below 6 pixels, or below a quarter of
# the class's largest, are not instances.
CAM_CORE_PERCENTILE = 88.0
INSTANCE_MIN_PIXELS = 6
INSTANCE_MIN_FRAC = 0.25
# The label loops run to a fixed point; testing for it reads a flag back
# to the host, which waits for the device. So they test once per block of
# this many steps: a step at the fixed point changes nothing, so the extra
# steps leave the labels as they are, and a CAM's blobs converge in a few
# blocks at most.
LABEL_BLOCK = 8


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
    return classify_logits(_fc_logits(pooled, fc_weight, fc_bias))


def classify_logits(logits: torch.Tensor):
    """(pred (B,) int32, conf (B,) f32, probs (B, K) f32) from the
    classifier's (B, K) logits."""
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
    # a Python scalar: torch rounds it to the f32 operand's type inside the
    # kernel, with no host-to-device copy (a tensor made from it would be a
    # synchronous copy per call)
    return a_lo + (a_hi - a_lo) * (q - lo)


def _full_frame(img_size: int, device: torch.device) -> torch.Tensor:
    """The box (0, 0, img_size - 1, img_size - 1), int32, filled on the
    device: a tensor from a host list would be a synchronous copy per
    batch."""
    full = torch.full((4,), img_size - 1, dtype=torch.int32, device=device)
    full[:2] = 0
    return full


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
    full = _full_frame(img_size, cam.device)
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
    full = _full_frame(img_size, cam.device)
    return torch.where((tot > 0)[:, None], bbox, full[None, :])


def _multi_cam_stack(features: torch.Tensor,
                     fc_weight: torch.Tensor) -> torch.Tensor:
    """Every class's normalised CAM, stacked: (B*K, s, s). One
    ``_normalized_cam_f32`` call per class, with the single-box path's
    ``bmm`` shapes: a single (B*K)-batch ``bmm`` could take another cuBLAS
    algorithm, sum the 64 products in another order and flip a
    ``cam > thr`` tie against the single-box head."""
    b, _, ss = features.shape
    s = math.isqrt(ss)
    num_classes = fc_weight.shape[0]
    with torch.profiler.record_function("multi_cam_stack"):
        cams = torch.stack([
            _normalized_cam_f32(features, torch.full(
                (b,), k, dtype=torch.int32, device=features.device), fc_weight)
            for k in range(num_classes)], dim=1)  # (B, K, S*S)
    return cams.reshape(b * num_classes, s, s)


def cam_bbox_multi_f32(features: torch.Tensor, fc_weight: torch.Tensor,
                       img_size: int = 128,
                       box_mode: str = "ref") -> torch.Tensor:
    """A CAM box for every class from integer-valued f32 features:
    (B, K, 4) int32. Row k is the box ``cam_bbox_f32`` gives when the
    argmax is k; the box tail runs once over the stacked CAMs."""
    b = features.shape[0]
    stacked = _multi_cam_stack(features, fc_weight)
    if box_mode == "centroid":
        boxes = _bbox_from_cam_centroid(stacked, img_size)
    else:
        boxes = _bbox_from_cam(stacked, img_size)
    return boxes.reshape(b, fc_weight.shape[0], 4)


def _multi_head_shared(f32: torch.Tensor, cam_w: torch.Tensor,
                       img_size: int, box_mode: str, instances: int):
    """Per-class boxes and, with ``instances > 1``, the instances, from ONE
    CAM stack and ONE percentile-70 threshold. Returns ``(boxes,)`` or
    ``(boxes (B, K, 4), inst_boxes (B, K, I, 4), inst_counts (B, K, I))``."""
    b = f32.shape[0]
    num_classes = cam_w.shape[0]
    stacked = _multi_cam_stack(f32, cam_w)
    n, s, _ = stacked.shape
    thr = _cam_threshold(stacked.reshape(n, s * s))
    if box_mode == "centroid":
        boxes = _bbox_from_cam_centroid(stacked, img_size)
    else:
        boxes = _bbox_from_cam(stacked, img_size, thr)
    boxes = boxes.reshape(b, num_classes, 4)
    if instances <= 1:
        return (boxes,)
    inst_boxes, inst_counts = _instances_from_cam(stacked, img_size,
                                                  instances, thr)
    return (boxes, inst_boxes.reshape(b, num_classes, instances, 4),
            inst_counts.reshape(b, num_classes, instances))


def _neighbour_min(lab: torch.Tensor, sent: int) -> torch.Tensor:
    """(N, s, s) int32 -> the minimum of each pixel's four neighbours, the
    outside of the map reading as ``sent``."""
    p = F.pad(lab, (1, 1, 1, 1), value=sent)
    return torch.minimum(torch.minimum(p[:, :-2, 1:-1], p[:, 2:, 1:-1]),
                         torch.minimum(p[:, 1:-1, :-2], p[:, 1:-1, 2:]))


def _to_fixed_point(step, lab: torch.Tensor) -> torch.Tensor:
    """Apply ``step`` until it changes nothing, in blocks of
    ``LABEL_BLOCK`` steps with one host sync per block (the JAX package's
    ``lax.while_loop`` tests after every step on the device).

    While ``torch.export`` traces (``apps.export_model``), the host test
    cannot be captured: there the loop is ``while_loop``, one step per
    iteration until the step changes nothing, as the JAX head's
    ``lax.while_loop``. Both stop at the same fixed point. The body
    returns a clone of the carried labels as the previous ones: a carried
    value returned unchanged is an alias, which the export refuses."""
    if torch.compiler.is_exporting():
        return while_loop(lambda cur, prev: (cur != prev).any(),
                          lambda cur, prev: (step(cur), cur.clone()),
                          (step(lab), lab))[0]
    while True:
        for _ in range(LABEL_BLOCK - 1):
            lab = step(lab)
        new = step(lab)
        if torch.equal(new, lab):
            return new
        lab = new


def _connected_labels(mask: torch.Tensor) -> torch.Tensor:
    """4-connected component labels of (N, s, s) bool masks: each masked
    pixel converges to the minimum flat (row-major) index of its
    component, background pixels hold ``s*s``. Min-label propagation to
    the fixed point, as the JAX package and its host twin
    ``head.cam.connected_labels_np``."""
    n, s, _ = mask.shape
    sent = s * s
    init = torch.where(mask, torch.arange(s * s, dtype=torch.int32,
                                          device=mask.device).reshape(1, s, s),
                       sent)

    def step(lab):
        return torch.where(mask, torch.minimum(lab, _neighbour_min(lab, sent)),
                           sent)

    with torch.profiler.record_function("connected_labels"):
        return _to_fixed_point(step, init)


def _grow_labels(labels: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Layer-synchronous marker growth: unlabelled ``mask`` pixels adopt
    the minimum label among their labelled 4-neighbours, one layer per
    step, labelled pixels frozen, to the fixed point — the rule of the JAX
    package and of ``head.cam.grow_labels_np``."""
    sent = labels.shape[1] * labels.shape[2]

    def step(lab):
        nmin = _neighbour_min(lab, sent)
        return torch.where(mask & (lab == sent) & (nmin != sent), nmin, lab)

    with torch.profiler.record_function("grow_labels"):
        return _to_fixed_point(step, labels)


def _component_stats(labels: torch.Tensor, max_instances: int):
    """Top-``max_instances`` component labels and pixel counts per row of
    (N, P) int32 labels (background P), ranked by the exact int32 key
    ``count * 1024 + (1023 - label)``. Counts are run lengths of the
    sorted labels (first and last position of each run by a forward
    ``cummax`` and a reversed ``cummin``). Returns (labels (N, I) int32,
    -1 when absent; counts (N, I) int32, 0 when absent)."""
    n, p = labels.shape
    if p > 1024:
        # the key encodes the label as (1023 - label): a CAM above 32x32
        # would corrupt it
        raise ValueError(f"_component_stats key packing supports at most "
                         f"1024 pixels (CAM <= 32x32); got {p}")
    dev = labels.device
    r = torch.sort(labels, dim=1).values  # background sorts last
    pos = torch.arange(p, dtype=torch.int32, device=dev)[None, :]
    edge = torch.full((n, 1), -1, dtype=torch.int32, device=dev)
    prev = torch.cat([edge, r[:, :-1]], dim=1)
    nxt = torch.cat([r[:, 1:], edge], dim=1)
    first = torch.cummax(torch.where(r != prev, pos, -1), dim=1).values
    last = torch.cummin(torch.where(r != nxt, pos, p).flip(1), dim=1).values.flip(1)
    runlen = last - first + 1
    key = torch.where((r != prev) & (r != p), runlen * 1024 + (1023 - r), 0)
    keyvals = torch.topk(key, max_instances, dim=1).values
    cnt = keyvals // 1024
    lab = torch.where(cnt > 0, 1023 - keyvals % 1024, -1)
    return lab.to(torch.int32), cnt.to(torch.int32)


def _instances_from_cam(cam: torch.Tensor, img_size: int, max_instances: int,
                        thr: torch.Tensor | None = None):
    """Marker-based watershed instance boxes from the single-box head's
    threshold mask: (N, I, 4) int32 boxes and (N, I) int32 pixel counts,
    by size then smallest label; count 0 marks an absent instance, whose
    box is the full frame. Markers are the components of the
    percentile-88 core mask; a plateau CAM with no core uses the whole
    mask."""
    n, s, _ = cam.shape
    ss = s * s
    scale = img_size // s
    flat = cam.reshape(n, ss)
    if thr is None:
        thr = _cam_threshold(flat)
    mask = cam > thr[:, None, None]
    core_thr = torch.maximum(_percentile_topk(flat, CAM_CORE_PERCENTILE), thr)
    cores = cam > core_thr[:, None, None]
    no_core = ~cores.reshape(n, ss).any(dim=1)
    cores = torch.where(no_core[:, None, None], mask, cores)

    labels = _grow_labels(_connected_labels(cores), mask).reshape(n, ss)
    with torch.profiler.record_function("component_stats"):
        lab_i, cnt_i = _component_stats(labels, max_instances)
        sel = labels[:, None, :] == lab_i[:, :, None]  # (N, I, P)
        pix = torch.arange(ss, dtype=torch.int32, device=cam.device)
        rows = (pix // s)[None, None, :]
        cols = (pix % s)[None, None, :]
        rmin = torch.where(sel, rows, s).amin(dim=2)
        rmax = torch.where(sel, rows, -1).amax(dim=2)
        cmin = torch.where(sel, cols, s).amin(dim=2)
        cmax = torch.where(sel, cols, -1).amax(dim=2)
        x2 = torch.clamp_max((cmax + 1) * scale, img_size - 1)
        y2 = torch.clamp_max((rmax + 1) * scale, img_size - 1)
        boxes = torch.stack([cmin * scale, rmin * scale, x2, y2],
                            dim=2).to(torch.int32)
        full = _full_frame(img_size, cam.device)
        boxes = torch.where((cnt_i > 0)[:, :, None], boxes, full[None, None, :])
    return boxes, cnt_i


def cam_instances_f32(features: torch.Tensor, fc_weight: torch.Tensor,
                      img_size: int = 128, max_instances: int = 2):
    """Up to ``max_instances`` watershed components per class CAM from
    integer-valued f32 features: (boxes (B, K, I, 4) int32, counts
    (B, K, I) int32; count 0 = absent)."""
    b = features.shape[0]
    num_classes = fc_weight.shape[0]
    boxes, counts = _instances_from_cam(_multi_cam_stack(features, fc_weight),
                                        img_size, max_instances)
    return (boxes.reshape(b, num_classes, max_instances, 4),
            counts.reshape(b, num_classes, max_instances))


def multi_scores(pooled: torch.Tensor, mw: torch.Tensor,
                 mb: torch.Tensor) -> torch.Tensor:
    """Multi-label presence scores: independent sigmoids of a learned
    (K, D) head (the bundle's ``multi_head.npz``) on the classifier's own
    pooled features, in f32."""
    return torch.sigmoid(pooled @ mw.T + mb)


def detect_multi_with_pooled(pooled: torch.Tensor,
                             features_twin: torch.Tensor,
                             fc_weight: torch.Tensor, fc_bias: torch.Tensor,
                             img_size: int = 128, box_mode: str = "ref",
                             instances: int = 1, multi_head=None):
    """The multi-object head on the megakernel's bins and bf16 twin:
    (pred, conf, probs, boxes (B, K, 4)); with ``instances > 1`` also
    (inst_boxes, inst_counts); with ``multi_head`` (mw, mb) the presence
    scores as the last output."""
    pred, conf, probs = _classify_pooled(pooled, fc_weight, fc_bias)
    out = (pred, conf, probs) + _multi_head_shared(
        features_twin.to(torch.float32), fc_weight, img_size, box_mode,
        instances)
    if multi_head is not None:
        out += (multi_scores(pooled, *multi_head),)
    return out


def detect_multi(features: torch.Tensor, fc_weight: torch.Tensor,
                 fc_bias: torch.Tensor, head_mode: str = "bins",
                 img_size: int = 128, box_mode: str = "ref",
                 instances: int = 1, multi_head=None,
                 logits: torch.Tensor | None = None):
    """The multi-object head on u8 features; outputs as
    :func:`detect_multi_with_pooled`. The 64-d GAP head has no spatial
    weights: every class shares the unweighted activation-map CAM.
    ``logits``: the classifier's logits where the caller summed them
    itself (the mesh's feature-split head), else from the features."""
    pred, conf, probs = (classify(features, fc_weight, fc_bias, head_mode)
                         if logits is None else classify_logits(logits))
    if head_mode == "bins":
        cam_w = fc_weight
    else:
        cam_w = torch.ones((fc_weight.shape[0], features.shape[1] * GRID * GRID),
                           dtype=torch.float32, device=features.device)
    out = (pred, conf, probs) + _multi_head_shared(
        features.to(torch.float32), cam_w, img_size, box_mode, instances)
    if multi_head is not None:
        pooled = bin_pool(features) if head_mode == "bins" else gap_pool(features)
        out += (multi_scores(pooled, *multi_head),)
    return out


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
           bbox_weight: torch.Tensor | None = None,
           logits: torch.Tensor | None = None):
    """Classify + box from u8 features. Returns (pred, conf, probs, bbox).
    ``logits`` as in :func:`detect_multi`."""
    pred, conf, probs = (classify(features, fc_weight, fc_bias, head_mode)
                         if logits is None else classify_logits(logits))
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
