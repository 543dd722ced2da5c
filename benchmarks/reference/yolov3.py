"""The plain reference of ``yolov3-416`` and its comparison: the harness's
frozen copy of the program's ``tpu_cnn_torch/reference/yolov3.py`` (its
functions below the line that says so, unchanged), in torch and numpy
alone, on the bundle's own files, with the region head's comparison
machinery of ``reference/yolov2.py`` (``Answer``, ``match``, ``numbers``,
``held_against``: the same rules of a tie, the same five numbers). What
follows is that file's note.

Per row of the graph (darknet's ``cfg/yolov3.cfg`` order): a conv is a k x
k conv of the previous row's u8 map through ``unfold`` (padding k // 2,
its stride: darknet's im2col) and a float64 matrix product, plus the int32
bias (exact: every sum is an integer below 2**31), then clip(floor(sum /
2**shift), 0, 255), or the linear sums of a conv a ``yolo`` row reads; a
shortcut is min(a + b, 255); a route concatenates channels; an upsample
repeats each pixel over a 2x2 block. The [yolo] heads in float64, from
darknet's equations (``get_yolo_detections``, ``do_nms_sort``,
``box_iou``): boxes head by head, cell-major, anchor inner; objectness o
= sigmoid(t_o) above ``thresh``; x = (j + sigmoid(t_x)) / g, y = (i +
sigmoid(t_y)) / g, w = exp(t_w) a_w / net, h = exp(t_h) a_h / net; class
scores o sigmoid(t_c) above ``thresh``; per-class greedy NMS at ``nms``
over every head's boxes (ties by the lower darknet index); the
``max_det`` best pairs (ties by index, then class). Departures from
darknet: ReLU for leaky ReLU, batch norm folded into weights and bias, u8
frames for float / 255, the saturating u8 shortcut, seeded weights, the
``max_det`` cap.

The comparison (``compare``) holds the program's answers, its outputs
read as ``dets`` (B, max_det, 6) (x, y, w, h, score, class) and ``count``
(B,), against the reference's detections of the same frames, exactly as
``reference/yolov2.py``'s does (its note says which pairs near a tie are
left out, and what ``det_miss``, ``det_extra``, ``score_err``,
``box_err`` and ``lost`` are); ``score_keys`` here keys a box by its
objectness and class sums across the three heads.

Its controls (``controls``), the reference in the program's place a step
below the configuration's precision, with one fault or with another
head, each held against the float64 reference as the program is:

- ``f32_sums``: every conv summed in float32, the step below exact
  integer sums (not exact past 2**24);
- ``no_shortcut``: the last residual block at 52x52 (its shortcut, row 36
  of the cfg: the map the third head's route reads) without its add;
- ``bf16_head``: the [yolo] heads (decode, scores) in bfloat16, the step
  below their float32;
- ``softmax_scores``: softmax class scores (YOLOv2's region head) in
  place of the logistic ones.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.lib import spec
from benchmarks.reference.yolov2 import (_distinct, _tensor, Answer, compared,  # noqa: F401
                                         held_against, match, nms, no_tf32, numbers, top)

NUMBERS = ("det_miss", "det_extra", "score_err", "box_err", "lost")

# ── the program's reference/yolov3.py, unchanged below this line ──
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

# ── the program's reference/yolov3.py, unchanged above this line ──


def score_keys(heads, masks, num_classes: int) -> torch.Tensor:
    """The heads' sums -> (B, N) a key of each box's objectness and class
    sums (a fixed random linear form of them, in float64), N in darknet's
    order: two boxes of one key have the same inputs to their scores."""
    e = 5 + num_classes
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(e - 4))
    keys = []
    for t, mask in zip(heads, masks):
        b, _, g, _ = t.shape
        v = t.to(torch.float64).reshape(b, len(mask), e, g * g).permute(0, 3, 1, 2)
        keys.append(v.reshape(b, g * g * len(mask), e)[..., 4:] @ w.to(v.device))
    return torch.cat(keys, 1)


def no_shortcut_row(rows) -> int:
    """The shortcut row whose map the last head's route reads (row 36 of
    cfg/yolov3.cfg: the last residual block at 52x52)."""
    last_route = [r for r, row in enumerate(rows) if row[0] == "route" and len(row) == 3][-1]
    return int(rows[last_route][2])


CONTROLS = {"f32_sums": {"f32": True},
            "no_shortcut": {"drop_shortcut": True},
            "bf16_head": {"head_dtype": torch.bfloat16},
            "softmax_scores": {"softmax": True}}


class Reference:
    """The reference of one configuration file (``configs/<name>.json``),
    on the bundle's ``region_weights.npz`` (a kernel and bias a conv) and
    ``shifts.json``, on ``device``; a control's changes where given."""

    def __init__(self, config: dict, device, head_dtype=torch.float64, f32=False,
                 drop_shortcut=False, softmax=False):
        no_tf32()
        self.device = torch.device(device)
        self.rows = [tuple([row[0], *(int(v) for v in row[1:])])
                     for row in config["layer_configs"]]
        self.conv_rows = [r for r, row in enumerate(self.rows) if row[0] == "conv"]
        self.heads = [r for r, row in enumerate(self.rows) if row[0] == "yolo"]
        self.masks = [row[1:] for row in self.rows if row[0] == "yolo"]
        self.shifts = [int(s) for s in config["shifts"]]
        d = spec.bundle_dir(config)
        with open(os.path.join(d, "shifts.json")) as f:
            if [int(s) for s in json.load(f)] != self.shifts:
                raise ValueError(f"{d}/shifts.json disagrees with the configuration")
        n = len(self.conv_rows)
        with np.load(os.path.join(d, "region_weights.npz")) as z:
            self.kernels = [torch.from_numpy(z[f"kernel{i}"].astype(np.int8)).to(self.device)
                            for i in range(n)]
            self.biases = [torch.from_numpy(z[f"bias{i}"].astype(np.int32)).to(self.device)
                           for i in range(n)]
        self.linear = [self.conv_rows.index(r - 1) for r in self.heads]
        self.anchors = [tuple(a) for a in config["anchors"]]
        self.classes = int(config["num_classes"])
        self.thresh, self.nms = float(config["thresh"]), float(config["nms"])
        self.max_det = int(config["max_det"])
        self.head_dtype, self.softmax = head_dtype, softmax
        self.sums_dtype = {i: torch.float32 for i in range(n)} if f32 else None
        self.drop = no_shortcut_row(self.rows) if drop_shortcut else None

    def _raw(self, frames: torch.Tensor):
        frames = frames.to(self.device)
        heads = forward(frames, self.kernels, self.biases, self.shifts, self.rows,
                        sums_dtype=self.sums_dtype, drop_shortcut=self.drop)
        boxes, obj, raw = decode(heads, [self.shifts[i] for i in self.linear], self.anchors,
                                 self.masks, self.classes, int(frames.shape[-1]),
                                 dtype=self.head_dtype, softmax=self.softmax)
        return heads, boxes.to(torch.float64), obj.to(torch.float64), raw.to(torch.float64)

    def answer(self, frames: torch.Tensor) -> Answer:
        """The reference's ``Answer`` (``reference/yolov2.py``): a pair's
        objectness test is in its score's (o sigmoid(c) <= o)."""
        heads, boxes, obj, raw = self._raw(frames)
        raw = torch.where(obj[..., None] > self.thresh, raw, torch.zeros_like(raw))
        return Answer(boxes, raw, self.thresh, self.nms, self.max_det,
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
