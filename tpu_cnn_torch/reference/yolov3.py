"""The plain reference of the darknet layer graphs with [yolo] heads
(``models.region.DarknetConfig``: YOLOv3), in torch alone: no kernel of the
port, nothing of JAX.

Per row of the graph (darknet's ``cfg/yolov3.cfg`` order):

- ``("conv", ic, oc, size, k, stride)``: a k x k conv of the previous row's
  u8 map (the frames for the first) by int8 weights through ``unfold``
  (padding k // 2, the stride: darknet's im2col, out(y, x) = sum in(s y -
  k // 2 + dy, s x - k // 2 + dx), zero outside the map) and a float64
  matrix product, plus the int32 bias. Every product and sum is an integer
  below 2**31 and float64 is exact to 2**53, so the sums are exact on any
  device. Then clip(floor(sum / 2**shift), 0, 255); a conv that a
  ``yolo`` row reads is linear: its sums, t = sum / 2**shift;
- ``("shortcut", frm)``: min(a + b, 255) of the previous row's map and the
  map ``frm`` rows back;
- ``("route", a[, b])``: the maps' channels concatenated in order;
- ``("upsample", 2)``: out(y, x) = in(y // 2, x // 2);
- ``("yolo", m0, m1, m2)``: a head.

The [yolo] heads, from darknet's equations (``yolo_layer.c``,
``get_yolo_detections``; ``box.c``, ``do_nms_sort`` and ``box_iou``), in
float64: box n of head h (anchor ``masks[h][n]``, in pixels) at cell (i,
j) of its g x g grid, in darknet's order (head by head, cell-major,
anchor inner); objectness o = sigmoid(t_o), a box only where o >
``thresh``; x = (j + sigmoid(t_x)) / g, y = (i + sigmoid(t_y)) / g, w =
exp(t_w) a_w / net, h = exp(t_h) a_h / net (net: the input side); class
k scores o sigmoid(t_ck), kept above ``thresh`` (else 0); per class, over
every head's boxes together, the candidates in order of score (ties: the
lower index first), each kept box zeroing the score of every later box
whose IoU with it exceeds ``nms``; the (box, class) pairs left in order
of score (ties: the lower index, then the lower class), the ``max_det``
first (``reference.yolov2_tiny``'s ``nms`` and ``top``).

Where these networks depart from darknet's ``yolov3``:

- ReLU in place of leaky ReLU (0.1): the contract's activations are u8;
- batch norm folded into the int8 weights and the int32 bias;
- u8 frames in place of darknet's float input / 255;
- the saturating u8 shortcut in place of darknet's float add (the bundle's
  shifts make the two branches' scales agree);
- seeded random weights in place of the trained ones;
- the ``max_det`` cap (100: the COCO evaluation's ``maxDets``).

``torch.backends.cuda.matmul.allow_tf32`` and ``torch.backends.cudnn
.allow_tf32`` are switched off where the reference runs on a card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_cnn_torch.reference.yolov2_tiny import nms, no_tf32, top


def conv_sums(h: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, k: int,
              stride: int, dtype=torch.float64) -> torch.Tensor:
    """(B, ic, H, W) -> (B, oc, H / stride, W / stride) sums of the k x k
    conv (padding k // 2) plus the bias, in ``dtype`` (float64: exact)."""
    b, _, height, width = h.shape
    cols = F.unfold(h.to(dtype), k, padding=k // 2, stride=stride)
    w = kernel.to(h.device, dtype).reshape(kernel.shape[0], -1)
    sums = torch.matmul(w, cols) + bias.to(h.device, dtype)[:, None]
    return sums.reshape(b, -1, height // stride, width // stride)


def clip_shift(sums: torch.Tensor, shift: int) -> torch.Tensor:
    """A conv's sums -> its u8 values (in the sums' type)."""
    return torch.clamp(torch.floor(sums / float(1 << shift)), 0, 255)


def _rows(rows) -> list[tuple]:
    return [(str(r[0]), *(int(v) for v in r[1:])) for r in rows]


def _sources(rows) -> list[tuple[int, ...]]:
    """The rows each row reads (absolute)."""
    out = []
    for r, row in enumerate(rows):
        kind, vals = row[0], row[1:]
        if kind == "shortcut":
            out.append((r - 1, r + vals[0]))
        elif kind == "route":
            out.append(tuple(r + v if v < 0 else v for v in vals))
        else:
            out.append((r - 1,) if r else ())
    return out


def forward(frames: torch.Tensor, kernels, biases, shifts, rows, *, sums_dtype=None,
            drop_shortcut=None, keep=None) -> list[torch.Tensor]:
    """(B, C, S, S) u8 -> the heads' (B, 3 (5 + C), g, g) float64 sums
    (integers, the bias added), in darknet's head order. ``sums_dtype``:
    {conv: dtype} of convs whose sums are taken in another type, and
    ``drop_shortcut``: a shortcut row that passes its previous row's map
    on alone (the controls). ``keep``: a dict that gets every conv's,
    shortcut's and upsample's output map (row -> float64 tensor). Each map
    is let go after the last row that reads it."""
    if frames.is_cuda:
        no_tf32()
    rows = _rows(rows)
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
            out = maps[a] if r == drop_shortcut else torch.clamp(maps[a] + maps[b], max=255)
        elif kind == "route":
            out = torch.cat([maps[i] for i in src[r]], dim=1)
        elif kind == "upsample":
            out = maps[r - 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        else:
            out = maps[r - 1]
            heads.append(out)
        if keep is not None and kind in ("conv", "shortcut", "upsample"):
            keep[r] = out
        maps[r] = out
        for i in src[r]:
            if last.get(i) == r:
                del maps[i]
    return heads


def decode(heads, shifts, anchors, masks, num_classes: int, net: int,
           dtype=torch.float64, softmax: bool = False):
    """The heads' sums, the linear convs' ``shifts`` (one a head) -> boxes
    (B, N, 4) (x, y, w, h), objectness (B, N) and raw scores (B, N, C) =
    o sigmoid(c) (softmax(c) where ``softmax``: a control), N the boxes of
    every head in darknet's order, computed in ``dtype``; not yet
    thresholded."""
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
        boxes.append(torch.stack([(col + torch.sigmoid(v[..., 0])) / g,
                                  (row + torch.sigmoid(v[..., 1])) / g,
                                  torch.exp(v[..., 2]) * anc[:, 0] / net,
                                  torch.exp(v[..., 3]) * anc[:, 1] / net], dim=-1))
        objs.append(o)
        cls = torch.softmax(v[..., 5:], dim=-1) if softmax else torch.sigmoid(v[..., 5:])
        scores.append(o[..., None] * cls)
    return torch.cat(boxes, 1), torch.cat(objs, 1), torch.cat(scores, 1)


def threshold(obj: torch.Tensor, raw: torch.Tensor, thresh: float) -> torch.Tensor:
    """darknet's scores: a box's pairs only where its objectness passes
    ``thresh``, each kept above ``thresh`` (else 0)."""
    return torch.where((obj[..., None] > thresh) & (raw > thresh), raw, torch.zeros_like(raw))


def detect(frames: torch.Tensor, kernels, biases, shifts, rows, anchors, masks,
           num_classes: int, thresh: float, nms_iou: float, max_det: int, *,
           sums_dtype=None, drop_shortcut=None, head_dtype=torch.float64,
           softmax: bool = False):
    """(B, C, S, S) u8 frames -> boxes (B, N, 4) and thresholded scores
    (B, N, C) in float64, and dets (B, max_det, 6) and count (B,) as the
    program gives them. ``head_dtype``: the type the decode is computed in,
    ``softmax``: softmax class scores (the controls)."""
    heads = forward(frames, kernels, biases, shifts, rows, sums_dtype=sums_dtype,
                    drop_shortcut=drop_shortcut)
    linear = [i for i, r in enumerate(_conv_rows(rows)) if r + 1 in _yolo_rows(rows)]
    net = int(frames.shape[-1])
    boxes, obj, raw = decode(heads, [shifts[i] for i in linear], anchors, masks, num_classes,
                             net, dtype=head_dtype, softmax=softmax)
    boxes, obj, raw = boxes.to(torch.float64), obj.to(torch.float64), raw.to(torch.float64)
    scores = threshold(obj, raw, thresh)
    dets, count = top(boxes, nms(boxes, scores, nms_iou), max_det)
    return boxes, scores, dets, count


def _conv_rows(rows) -> list[int]:
    return [r for r, row in enumerate(rows) if row[0] == "conv"]


def _yolo_rows(rows) -> list[int]:
    return [r for r, row in enumerate(rows) if row[0] == "yolo"]
