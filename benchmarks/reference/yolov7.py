"""The plain reference of ``yolov7-640`` and its comparison: the harness's
frozen copy of the program's ``tpu_cnn_torch/reference/yolov7.py`` (its
functions below the line that says so, unchanged), in torch and numpy
alone, on the bundle's own files, with the darknet graphs' sums of
``reference/yolov3.py`` (``conv_sums``, ``clip_shift``: the exact float64
``unfold`` sums) and the region head's comparison machinery of
``reference/yolov2.py`` (``Answer``, ``match``, ``numbers``,
``held_against``: the same rules of a tie, the same five numbers). What
follows is that file's note.

Per row of the graph: a conv is a k x k conv of the previous row's u8
map through ``unfold`` and a float64 matrix product, plus the int32 bias,
then clip(floor(sum / 2**shift), 0, 255), or the linear sums of a conv a
``yolo`` row reads; a route concatenates the channels of one to six maps;
an upsample repeats each pixel over a 2x2 block; a ``maxpool`` row is
``F.max_pool2d`` at size k, stride s, padding (k - 1) // 2 (2x2/2; 5, 9 and
13 at stride 1, SAME). The [yolo] heads in float64, in the graph's order
(fine to coarse): YOLOv7's ``Detect`` decode, x = (j + 2 sigmoid(t_x) -
0.5) / g, y likewise, w = (2 sigmoid(t_w))**2 a_w / net, h likewise;
objectness o = sigmoid(t_o) above ``thresh``, class scores o sigmoid(t_c)
above it (``test.py``'s multi-label candidates), per-class greedy NMS at
``nms`` over every head's boxes (ties by the lower index), the ``max_det``
best pairs (ties by index, then class). Departures from the yaml: ReLU
for SiLU, batch norm, ``RepConv`` and the implicit layers folded, u8
frames for float / 255, seeded weights.

The comparison (``compare``) holds the program's answers, its outputs
read as ``dets`` (B, max_det, 6) (x, y, w, h, score, class) and ``count``
(B,), against the reference's detections of the same frames, exactly as
``reference/yolov2.py``'s does (its note says which pairs near a tie are
left out, and what ``det_miss``, ``det_extra``, ``score_err``,
``box_err`` and ``lost`` are); ``score_keys`` (``reference/yolov3.py``'s)
keys a box by its objectness and class sums across the three heads. One
more kind of pair is left out, as the near ties are: the pairs of a class
with a candidate box narrower or lower than ``TINY_BOX`` (the scaled
decode's (2 sigmoid(t))**2 reaches 1e-7 of the frame where YOLOv3's exp
stays near 1e-4), whose float32 centre, rounded by up to 2**-25, moves
its IoU with its own float64 box below ``MATCH_IOU`` and its overlaps
past ``nms`` either way.

Its controls (``controls``), the reference in the program's place a step
below the configuration's precision or with one fault, each held against
the float64 reference as the program is:

- ``f32_sums``: every conv summed in float32, the step below exact
  integer sums (not exact past 2**24);
- ``darknet_decode``: YOLOv3's box decode in place of the scaled one;
- ``no_pool``: SPPCSPC's pool at 5 left out (its map passed on unpooled
  into the concatenation).
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.lib import spec
from benchmarks.reference.yolov2 import (MATCH_IOU, SCORE_MARGIN, _tensor, Answer,  # noqa: F401
                                         compared, held_against, match, nms, no_tf32,
                                         numbers, top, unsettled)
from benchmarks.reference.yolov3 import _sources, clip_shift, conv_sums, score_keys

NUMBERS = ("det_miss", "det_extra", "score_err", "box_err", "lost")

# ── the program's reference/yolov7.py, unchanged below this line ──
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

# ── the program's reference/yolov7.py, unchanged above this line ──


# 2**-14 of the frame: a float32 centre's rounding (2**-25 near 1) moves a
# box this wide by 2**-11 of itself, and its IoU with itself by twice that,
# past 1 - MATCH_IOU
TINY_BOX = 2.0 ** -14


def tiny_answer(boxes, raw, thresh, nms_iou, max_det, keys) -> Answer:
    """``Answer`` (``reference/yolov2.py``), its ``settled`` classes less
    those with a candidate box narrower or lower than ``TINY_BOX``, and
    ``safe_above`` taken over those settled classes."""
    ans = Answer.__new__(Answer)
    scores = torch.where(raw > thresh, raw, torch.zeros_like(raw))
    kept = nms(boxes, scores, nms_iou)
    ans.dets, ans.count = top(boxes, kept, max_det)
    tiny = ((raw > thresh) & (boxes[..., 2:4].amin(-1) < TINY_BOX)[..., None]).any(dim=1)
    ans.settled = ~unsettled(boxes, raw, thresh, nms_iou, keys) & ~tiny
    b = raw.shape[0]
    near = torch.where(raw > thresh * (1 - SCORE_MARGIN), raw, torch.zeros_like(raw))
    rivals = torch.where(ans.settled[:, None, :], kept, near).reshape(b, -1)
    if rivals.shape[1] > max_det:
        cut = torch.topk(rivals, max_det + 1, dim=1).values[:, -1]
    else:
        cut = torch.zeros(b, dtype=raw.dtype, device=raw.device)
    ans.safe_above = cut / (1 - 2 * SCORE_MARGIN)
    return ans


def no_pool_row(rows) -> int:
    """The first stride-1 ``maxpool`` row: SPPCSPC's pool at 5."""
    return next(r for r, row in enumerate(rows) if row[0] == "maxpool" and int(row[2]) == 1)


CONTROLS = {"f32_sums": {"f32": True},
            "darknet_decode": {"mode": "darknet"},
            "no_pool": {"drop_pool": True}}


class Reference:
    """The reference of one configuration file (``configs/<name>.json``),
    on the bundle's ``region_weights.npz`` (a kernel and bias a conv) and
    ``shifts.json``, on ``device``; a control's changes where given."""

    def __init__(self, config: dict, device, f32=False, mode=None, drop_pool=False):
        no_tf32()
        self.device = torch.device(device)
        self.rows = [tuple([row[0], *(int(v) for v in row[1:])])
                     for row in config["layer_configs"]]
        self.masks = [row[1:] for row in self.rows if row[0] == "yolo"]
        self.shifts = [int(s) for s in config["shifts"]]
        d = spec.bundle_dir(config)
        with open(os.path.join(d, "shifts.json")) as f:
            if [int(s) for s in json.load(f)] != self.shifts:
                raise ValueError(f"{d}/shifts.json disagrees with the configuration")
        n = sum(1 for row in self.rows if row[0] == "conv")
        with np.load(os.path.join(d, "region_weights.npz")) as z:
            self.kernels = [torch.from_numpy(z[f"kernel{i}"].astype(np.int8)).to(self.device)
                            for i in range(n)]
            self.biases = [torch.from_numpy(z[f"bias{i}"].astype(np.int32)).to(self.device)
                           for i in range(n)]
        self.linear = linear_convs(self.rows)
        self.anchors = [tuple(a) for a in config["anchors"]]
        self.classes = int(config["num_classes"])
        self.thresh, self.nms = float(config["thresh"]), float(config["nms"])
        self.max_det = int(config["max_det"])
        self.mode = mode or config["decode"]
        self.sums_dtype = {i: torch.float32 for i in range(n)} if f32 else None
        self.drop = no_pool_row(self.rows) if drop_pool else None

    def _raw(self, frames: torch.Tensor):
        frames = frames.to(self.device)
        heads = forward(frames, self.kernels, self.biases, self.shifts, self.rows,
                        sums_dtype=self.sums_dtype, drop_pool=self.drop)
        boxes, obj, raw = decode(heads, [self.shifts[i] for i in self.linear], self.anchors,
                                 self.masks, self.classes, int(frames.shape[-1]),
                                 mode=self.mode)
        return heads, boxes, obj, raw

    def answer(self, frames: torch.Tensor) -> Answer:
        """The reference's ``Answer`` (``tiny_answer``): a pair's
        objectness test is in its score's (o sigmoid(c) <= o)."""
        heads, boxes, obj, raw = self._raw(frames)
        raw = torch.where(obj[..., None] > self.thresh, raw, torch.zeros_like(raw))
        return tiny_answer(boxes, raw, self.thresh, self.nms, self.max_det,
                           score_keys(heads, self.masks, self.classes))

    def detect(self, frames: torch.Tensor):
        """(dets, count), as the program gives them."""
        _, boxes, obj, raw = self._raw(frames)
        scores = threshold(obj, raw, self.thresh)
        return top(boxes, nms(boxes, scores, self.nms), self.max_det)


def compare(cell, outcome, device) -> dict[str, float]:
    """The comparison's numbers: the float64 reference on the distinct
    frames the program answered, then ``numbers`` over every kept answer,
    its outputs read as dets and count; ``compared`` on standard error."""
    block = int(cell.params["reference_block"])
    dets, count = outcome.answers.outputs
    found = held_against(Reference(cell.config, device), _tensor(outcome.frames), block,
                         (outcome.answers.frame, dets, count))
    print(f"compared {json.dumps(compared(found))}", file=sys.stderr, flush=True)
    return numbers(found, lost=outcome.lost)


def controls(cell, frames, device) -> dict[str, dict[str, float]]:
    """{control: numbers} of each of ``CONTROLS`` on ``frames``: each
    control's own detections held against the float64 reference as the
    program's are (``compared`` on standard error)."""
    frames, block = _tensor(frames), int(cell.params["reference_block"])
    base = Reference(cell.config, device)
    out = {}
    for name, kw in CONTROLS.items():
        ctl = Reference(cell.config, device, **kw)
        dets, count = [], []
        for lo in range(0, frames.shape[0], block):
            d, n = ctl.detect(frames[lo:lo + block])
            dets.append(d.to(torch.float32).cpu().numpy())
            count.append(n.cpu().numpy())
        answers = (np.arange(frames.shape[0]), np.concatenate(dets), np.concatenate(count))
        found = held_against(base, frames, block, answers)
        print(f"compared {name} {json.dumps(compared(found))}", file=sys.stderr, flush=True)
        out[name] = numbers(found)
    return out
