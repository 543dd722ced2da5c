"""The plain reference of YOLOv7 (``models.region.DarknetConfig`` with
``maxpool`` rows, routes of up to six maps and the scaled decode), in torch
alone: no kernel of the port, nothing of JAX. It is the darknet graphs'
reference (``reference.yolov3``: its ``conv_sums`` and ``clip_shift``, the
exact float64 ``unfold`` sums) with two more row kinds' worth of rules:

- ``("maxpool", k, s)``: ``F.max_pool2d`` of the previous row's map, size
  k, stride s, padding (k - 1) // 2 (darknet's [maxpool]: taps outside the
  map never win; 2x2/2 has none, 5, 9 and 13 at stride 1 pad k // 2);
- ``("route", a, b, ..)``: the maps' channels concatenated in order, one
  to six of them;

and the [yolo] heads' decode in either form (``decode``): darknet's (x =
(j + sigmoid(t_x)) / g, w = exp(t_w) a_w / net) or YOLOv7's ``Detect``
(x = (j + 2 sigmoid(t_x) - 0.5) / g, y likewise, w = (2 sigmoid(t_w))**2
a_w / net, h likewise: darknet's ``new_coords=1, scale_x_y=2``), the
objectness o = sigmoid(t_o) above ``thresh``, class scores o sigmoid(t_c)
above it, per-class greedy NMS over every head's boxes and the
``max_det`` best pairs (``reference.yolov2_tiny``'s ``nms`` and ``top``;
the heads in the graph's order, fine to coarse for YOLOv7).

Where this network departs from ``cfg/deploy/yolov7.yaml``:

- ReLU in place of SiLU: the contract's maps are u8;
- batch norm folded into the int8 weights and the int32 bias; ``RepConv``
  in its deploy form (one 3x3 conv); ``IDetect``'s implicit add and
  multiply folded into the three linear 1x1 convs' weights and biases;
- u8 frames in place of the float input / 255;
- seeded random weights in place of the trained ones.

``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn
.allow_tf32`` are switched off where the reference runs on a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_cnn_torch.reference.yolov2_tiny import nms, no_tf32, top
from tpu_cnn_torch.reference.yolov3 import _sources, clip_shift, conv_sums


def maxpool(h: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """darknet's [maxpool] of (B, C, H, W) float maps: size x size windows
    from (stride y - (size - 1) // 2, ...) on, taps outside the map
    ignored -> (B, C, H / stride, W / stride)."""
    return F.max_pool2d(h, size, stride, padding=(size - 1) // 2)


def forward(frames: torch.Tensor, kernels, biases, shifts, rows, *, sums_dtype=None,
            drop_pool=None, keep=None) -> list[torch.Tensor]:
    """(B, C, S, S) u8 -> the heads' (B, 3 (5 + C), g, g) float64 sums
    (integers, the bias added), in the graph's head order. ``sums_dtype``:
    {conv: dtype} of convs whose sums are taken in another type, and
    ``drop_pool``: a stride-1 ``maxpool`` row that passes its map on
    unpooled (the controls). ``keep``: a dict that gets every conv's,
    shortcut's, upsample's and maxpool's output map (row -> float64
    tensor). Each map is let go after the last row that reads it."""
    if frames.is_cuda:
        no_tf32()
    rows = [(str(r[0]), *(int(v) for v in r[1:])) for r in rows]
    src = _sources(rows)
    last = {}
    for r, s in enumerate(src):
        for i in s:
            last[i] = r
    heads_read = {r - 1 for r, row in enumerate(rows) if row[0] == "yolo"}
    maps: dict[int, torch.Tensor] = {}
    heads = []
    conv = 0
    for r, row in enumerate(rows):
        kind = row[0]
        if kind == "conv":
            _, _, _, _, k, stride = row
            h = maps[r - 1] if r else frames.to(torch.float64)
            dt = (sums_dtype or {}).get(conv, torch.float64)
            sums = conv_sums(h, kernels[conv], biases[conv], k, stride, dt).to(torch.float64)
            out = sums if r in heads_read else clip_shift(sums, int(shifts[conv]))
            conv += 1
        elif kind == "shortcut":
            a, b = src[r]
            out = torch.clamp(maps[a] + maps[b], max=255)
        elif kind == "route":
            out = torch.cat([maps[i] for i in src[r]], dim=1)
        elif kind == "upsample":
            out = maps[r - 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif kind == "maxpool":
            out = maps[r - 1] if r == drop_pool else maxpool(maps[r - 1], row[1], row[2])
        else:
            out = maps[r - 1]
            heads.append(out)
        if keep is not None and kind in ("conv", "shortcut", "upsample", "maxpool"):
            keep[r] = out
        maps[r] = out
        for i in src[r]:
            if last.get(i) == r:
                del maps[i]
    return heads


def decode(heads, shifts, anchors, masks, num_classes: int, net: int,
           dtype=torch.float64, mode: str = "scaled"):
    """The heads' sums, the linear convs' ``shifts`` (one a head) -> boxes
    (B, N, 4) (x, y, w, h), objectness (B, N) and raw scores (B, N, C) =
    o sigmoid(c), N the boxes of every head in the graph's order (head by
    head, cell-major, anchor inner), computed in ``dtype``, the boxes by
    ``mode`` ("scaled" or "darknet"); not yet thresholded."""
    boxes, objs, scores = [], [], []
    for t, shift, mask in zip(heads, shifts, masks):
        b, _, g, _ = t.shape
        e = 5 + num_classes
        v = (t.to(dtype) / float(1 << int(shift))).reshape(b, len(mask), e, g * g)
        v = v.permute(0, 3, 1, 2).reshape(b, g * g * len(mask), e)
        cell = torch.arange(g * g, device=t.device).repeat_interleave(len(mask))
        col, row = (cell % g).to(dtype), (cell // g).to(dtype)
        anc = torch.tensor([anchors[m] for m in mask], dtype=dtype,
                           device=t.device).repeat(g * g, 1)
        o = torch.sigmoid(v[..., 4])
        if mode == "scaled":
            sx, sy = 2 * torch.sigmoid(v[..., 0]) - 0.5, 2 * torch.sigmoid(v[..., 1]) - 0.5
            bw = (2 * torch.sigmoid(v[..., 2])) ** 2 * anc[:, 0] / net
            bh = (2 * torch.sigmoid(v[..., 3])) ** 2 * anc[:, 1] / net
        else:
            sx, sy = torch.sigmoid(v[..., 0]), torch.sigmoid(v[..., 1])
            bw = torch.exp(v[..., 2]) * anc[:, 0] / net
            bh = torch.exp(v[..., 3]) * anc[:, 1] / net
        boxes.append(torch.stack([(col + sx) / g, (row + sy) / g, bw, bh], dim=-1))
        objs.append(o)
        scores.append(o[..., None] * torch.sigmoid(v[..., 5:]))
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(scores, 1)


def threshold(obj: torch.Tensor, raw: torch.Tensor, thresh: float) -> torch.Tensor:
    """The scores: a box's pairs only where its objectness passes
    ``thresh``, each kept above ``thresh`` (else 0)."""
    return torch.where((obj[..., None] > thresh) & (raw > thresh), raw, torch.zeros_like(raw))


def linear_convs(rows) -> list[int]:
    """The conv numbers whose sums a ``yolo`` row reads, in head order."""
    convs = [r for r, row in enumerate(rows) if row[0] == "conv"]
    return [convs.index(r - 1) for r, row in enumerate(rows) if row[0] == "yolo"]


def detect(frames: torch.Tensor, kernels, biases, shifts, rows, anchors, masks,
           num_classes: int, thresh: float, nms_iou: float, max_det: int, *,
           mode: str = "scaled", sums_dtype=None, drop_pool=None):
    """(B, C, S, S) u8 frames -> boxes (B, N, 4) and thresholded scores
    (B, N, C) in float64, and dets (B, max_det, 6) and count (B,) as the
    program gives them. ``mode``: the decode; ``sums_dtype`` and
    ``drop_pool``: ``forward``'s (the controls)."""
    heads = forward(frames, kernels, biases, shifts, rows, sums_dtype=sums_dtype,
                    drop_pool=drop_pool)
    net = int(frames.shape[-1])
    boxes, obj, raw = decode(heads, [shifts[i] for i in linear_convs(rows)], anchors, masks,
                             num_classes, net, mode=mode)
    scores = threshold(obj, raw, thresh)
    dets, count = top(boxes, nms(boxes, scores, nms_iou), max_det)
    return boxes, scores, dets, count
