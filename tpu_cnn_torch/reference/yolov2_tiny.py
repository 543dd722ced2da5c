"""The plain reference of the region-head detectors (``models.region``), in
torch alone: no kernel of the port, nothing of JAX.

Per layer ``(ic, oc, size, k, pool)``: a k x k SAME convolution of u8
activations by int8 weights through ``unfold`` and a float64 matrix
product, plus the int32 bias. Every product and sum of these networks is an
integer below 2**31 and float64 is exact to 2**53, so the sums are exact
on any device. Then clip(floor(sum / 2**shift), 0, 255) and the pool: 2
(2x2 stride 2), 1 (2x2 stride 1, the max over (y..y+1, x..x+1) of what
lies inside the map) or 0. The last layer is linear: t = sum / 2**shift.

The region head, from darknet's equations (``region_layer.c``,
``get_region_detections``; ``box.c``, ``do_nms_sort`` and ``box_iou``), in
float64: box n at cell (i, j) has the darknet index n g^2 + i g + j; x =
(j + sigmoid(tx)) / g, y = (i + sigmoid(ty)) / g, w = a_n^w exp(tw) / g,
h = a_n^h exp(th) / g; class k scores sigmoid(to) softmax(c)_k, kept
above ``thresh`` (else 0); per class, the candidates in order of score
(ties: the lower index first; darknet's ``qsort`` leaves ties unordered),
each kept box zeroing the score of every later box whose IoU with it
exceeds ``nms``; the (box, class) pairs left in order of score (ties: the
lower index, then the lower class), the ``max_det`` first.

Where these networks depart from darknet's ``yolov2-tiny-voc``:

- ReLU in place of leaky ReLU (0.1): the contract's activations are u8;
- batch norm folded into the int8 weights and the int32 bias;
- u8 frames in place of darknet's float input / 255;
- seeded random weights in place of the trained ones;
- the ``max_det`` cap (100: the COCO evaluation's ``maxDets``).

``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn
.allow_tf32`` are switched off where the reference runs on a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def pool(x: torch.Tensor, p: int) -> torch.Tensor:
    """2x2 max pool at stride 2 (p = 2) or 1 (p = 1, edges clamped), or
    none (p = 0)."""
    if p == 2:
        return F.max_pool2d(x, 2)
    if p == 1:  # the window's cells past the edge are the edge's own
        return F.max_pool2d(F.pad(x, (0, 1, 0, 1), mode="replicate"), 2, stride=1)
    return x


def layer_sums(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               k: int, dtype=torch.float64) -> torch.Tensor:
    """(B, ic, H, W) -> (B, oc, H, W) sums of the k x k SAME conv plus the
    bias, in ``dtype`` (float64: exact)."""
    b, _, height, width = h.shape
    cols = F.unfold(h.to(dtype), k, padding=k // 2)
    w = kernel.to(h.device, dtype).reshape(kernel.shape[0], -1)
    sums = torch.matmul(w, cols) + bias.to(h.device, dtype)[:, None]
    return sums.reshape(b, -1, height, width)


def activate(sums: torch.Tensor, shift: int, p: int) -> torch.Tensor:
    """A layer's sums -> its u8 values (in the sums' type):
    clip(floor(sums / 2**shift), 0, 255), then the pool ``p``."""
    return pool(torch.clamp(torch.floor(sums / float(1 << shift)), 0, 255), p)


def forward(frames: torch.Tensor, kernels, biases, shifts, specs, *,
            sums_dtype=None) -> torch.Tensor:
    """(B, C, S, S) u8 -> the last layer's (B, oc, g, g) float64 sums
    (integers, the bias added). ``sums_dtype``: {layer: dtype} of layers
    whose sums are taken in another type (the controls)."""
    if frames.is_cuda:
        no_tf32()
    h = frames.to(torch.float64)
    last = len(specs) - 1
    for i, ((_, _, _, k, p), w, b, s) in enumerate(zip(specs, kernels, biases, shifts)):
        dt = (sums_dtype or {}).get(i, torch.float64)
        sums = layer_sums(h, w, b, k, dt).to(torch.float64)
        if i == last:
            return sums
        h = activate(sums, int(s), p)
    raise ValueError("no layer")


def decode(sums: torch.Tensor, shift: int, anchors, num_classes: int,
           dtype=torch.float64):
    """(B, A*(5+C), g, g) sums of the last layer -> boxes (B, N, 4) (x, y,
    w, h) and scores (B, N, C), N = A g^2 in darknet's order, computed in
    ``dtype``; not yet thresholded."""
    b, _, g, _ = sums.shape
    a = len(anchors)
    t = (sums.to(dtype) / float(1 << int(shift))).reshape(b, a, 5 + num_classes, g, g)
    t = t.permute(0, 1, 3, 4, 2).reshape(b, a * g * g, 5 + num_classes)
    idx = torch.arange(g * g, device=sums.device)
    col = (idx % g).to(dtype).repeat(a)
    row = (idx // g).to(dtype).repeat(a)
    anc = torch.as_tensor(anchors, dtype=dtype, device=sums.device)
    anc = anc.repeat_interleave(g * g, dim=0)
    x = (col + torch.sigmoid(t[..., 0])) / g
    y = (row + torch.sigmoid(t[..., 1])) / g
    w = anc[:, 0] * torch.exp(t[..., 2]) / g
    h = anc[:, 1] * torch.exp(t[..., 3]) / g
    scores = torch.sigmoid(t[..., 4:5]) * torch.softmax(t[..., 5:], dim=-1)
    return torch.stack([x, y, w, h], dim=-1), scores


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """darknet's ``box_iou`` of (..., 4) (x, y, w, h) boxes, broadcast."""
    def overlap(c1, w1, c2, w2):
        left = torch.maximum(c1 - w1 / 2, c2 - w2 / 2)
        right = torch.minimum(c1 + w1 / 2, c2 + w2 / 2)
        return right - left

    ow = overlap(a[..., 0], a[..., 2], b[..., 0], b[..., 2])
    oh = overlap(a[..., 1], a[..., 3], b[..., 1], b[..., 3])
    inter = torch.where((ow < 0) | (oh < 0), torch.zeros_like(ow), ow * oh)
    union = a[..., 2] * a[..., 3] + b[..., 2] * b[..., 3] - inter
    return inter / union


def _order(scores: torch.Tensor) -> torch.Tensor:
    """Per row of (R, N) scores, the indices by score, ties by index."""
    return torch.sort(-scores, dim=-1, stable=True).indices


def nms(boxes: torch.Tensor, scores: torch.Tensor, nms_iou: float) -> torch.Tensor:
    """Per frame and class, greedy NMS (``do_nms_sort``): (B, N, 4) boxes
    and (B, N, C) thresholded scores (0: no candidate) -> the scores left
    (B, N, C)."""
    b, n, c = scores.shape
    sc = scores.permute(0, 2, 1).reshape(b * c, n)
    order = _order(sc)
    width = max(int((sc > 0).sum(dim=1).max()), 1) if sc.numel() else 1
    order = order[:, :width]
    alive = torch.gather(sc, 1, order) > 0
    bx = boxes[:, None].expand(b, c, n, 4).reshape(b * c, n, 4)
    sel = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4))
    over = iou(sel[:, :, None], sel[:, None, :]) > nms_iou  # (R, width, width)
    for i in range(width):
        hit = alive[:, i:i + 1] & over[:, i, i + 1:]
        alive[:, i + 1:] &= ~hit
    kept = torch.zeros_like(sc)
    kept.scatter_(1, order, torch.where(alive, torch.gather(sc, 1, order),
                                        torch.zeros_like(alive, dtype=sc.dtype)))
    return kept.reshape(b, c, n).permute(0, 2, 1)


def top(boxes: torch.Tensor, kept: torch.Tensor, max_det: int):
    """(B, N, 4) boxes and (B, N, C) scores left by NMS -> dets (B, max_det,
    6) (x, y, w, h, score, class; zero past the count) and count (B,)
    int64: the pairs left in order of score, ties by index, then class."""
    b, n, c = kept.shape
    flat = kept.reshape(b, n * c)  # pair p = index * C + class: ties in order
    order = _order(flat)
    s = torch.gather(flat, 1, order)
    count = (s > 0).sum(dim=1).clamp_max(max_det)
    order, s = order[:, :max_det], s[:, :max_det]
    if s.shape[1] < max_det:
        pad = max_det - s.shape[1]
        order = F.pad(order, (0, pad))
        s = F.pad(s, (0, pad))
    box = torch.gather(boxes, 1, (order // c)[..., None].expand(-1, -1, 4))
    cls = (order % c).to(boxes.dtype)
    dets = torch.cat([box, s[..., None], cls[..., None]], dim=-1)
    valid = torch.arange(max_det, device=kept.device)[None] < count[:, None]
    return dets * valid[..., None], count


def detect(frames: torch.Tensor, kernels, biases, shifts, specs, anchors,
           num_classes: int, thresh: float, nms_iou: float, max_det: int, *,
           sums_dtype=None, head_dtype=torch.float64):
    """(B, C, S, S) u8 frames -> boxes (B, N, 4) and thresholded scores
    (B, N, C) in float64 (``decode``'s, those at or below ``thresh`` 0),
    and dets (B, max_det, 6) and count (B,) as the program gives them.
    ``head_dtype``: the type the decode is computed in (the controls)."""
    sums = forward(frames, kernels, biases, shifts, specs, sums_dtype=sums_dtype)
    boxes, scores = decode(sums, shifts[-1], anchors, num_classes, dtype=head_dtype)
    boxes, scores = boxes.to(torch.float64), scores.to(torch.float64)
    scores = torch.where(scores > thresh, scores, torch.zeros_like(scores))
    dets, count = top(boxes, nms(boxes, scores, nms_iou), max_det)
    return boxes, scores, dets, count
