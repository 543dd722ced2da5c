"""The plain reference of ``yolov2-tiny-voc`` and its comparison: the
harness's frozen copy of the program's ``tpu_cnn_torch/reference/
yolov2_tiny.py`` (its functions below the line that says so, unchanged),
in torch and numpy alone, on the bundle's own files. What follows is that
file's note.

Per layer ``(ic, oc, size, k, pool)``: a k x k SAME convolution of u8
activations by int8 weights through ``unfold`` and a float64 matrix
product, plus the int32 bias (exact: every sum is an integer below 2**31).
Then clip(floor(sum / 2**shift), 0, 255) and the pool: 2 (2x2 stride 2),
1 (2x2 stride 1, the max over (y..y+1, x..x+1) inside the map) or 0. The
last layer is linear: t = sum / 2**shift. The region head in float64,
from darknet's equations (``get_region_detections``, ``do_nms_sort``,
``box_iou``): decode, scores above ``thresh``, per-class greedy NMS at
``nms`` (ties by the lower darknet index), the ``max_det`` best pairs
(ties by index, then class). Departures from darknet: ReLU for leaky ReLU,
batch norm folded into weights and bias, u8 frames for float / 255, seeded
weights, the ``max_det`` cap.

The comparison (``compare``, below the copy) holds the program's
answers, its outputs read as ``dets`` (B, max_det, 6) (x, y, w, h, score,
class) and ``count`` (B,), against the reference's detections of the same
frames. Pairs near a tie are left out on both sides (``Answer``,
``match``): the pairs of a class whose answer a float32 rounding could
move (``unsettled``: a score within ``SCORE_MARGIN`` x ``thresh`` of
``thresh``, two candidates' IoU within ``IOU_MARGIN`` of ``nms``, or two
candidates that may overlap past ``nms`` with scores within
``SCORE_MARGIN`` of each other, unless their scores' inputs are the same:
a seeded net repeats cells of its last layer exactly), and the pairs that such a class, or a
near tie at the ``max_det``-th score, could push past the cut (at or
below ``safe_above``). Its numbers, over every kept answer (identical
answers of one frame compared once and counted each time):

- ``det_miss``: the share of the reference's pairs compared that the
  program lacks (same class, IoU >= ``MATCH_IOU``);
- ``det_extra``: the share of the program's pairs compared that the
  reference lacks;
- ``score_err``, ``box_err``: the largest absolute error of a matched
  pair's score and of its box's coordinates;
- ``lost``: answers that never came.

A run that kept no answer, or compared no pair, reads 1 in the first four.
``compare`` writes to standard error how many of the reference's pairs,
and of the frames, it compared (``compared``).

Its controls (``controls``), the reference in the program's place a step
below the configuration's precision or with one fault, each held against
the float64 reference as the program is:

- ``bf16_head``: the region head (decode, scores) in bfloat16, the step
  below its float32;
- ``f32_sums``: L6 and L7 summed in float32, the step below exact integer
  sums (not exact past 2**24);
- ``shift_off``: L3's shift one more than the configuration's;
- ``no_stride1_pool``: L5 without its 2x2 stride-1 pool.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.lib import spec

NUMBERS = ("det_miss", "det_extra", "score_err", "box_err", "lost")

# ── the program's reference/yolov2_tiny.py, unchanged below this line ──
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

# ── the program's reference/yolov2_tiny.py, unchanged above this line ──


# the comparison's margins of a tie: a score within this share of
# ``thresh``, of another score or of the score at the cut, or an IoU this
# close to ``nms``, may fall either way in float32 against float64 (whose
# errors here are about 1e-7 of a score and of an IoU)
SCORE_MARGIN = 1e-5
IOU_MARGIN = 1e-5
MATCH_IOU = 0.999


def score_keys(sums: torch.Tensor, anchors, num_classes: int) -> torch.Tensor:
    """(B, A*(5+C), g, g) sums of the last layer -> (B, N) a key of each
    box's objectness and class sums (a fixed random linear form of them,
    in float64): two boxes of one key have the same inputs to their
    scores, which any arithmetic then makes equal, and both sides order
    them by index alike."""
    b, _, g, _ = sums.shape
    a, e = len(anchors), 5 + num_classes
    t = sums.to(torch.float64).reshape(b, a, e, g, g).permute(0, 1, 3, 4, 2)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(e - 4)).to(t)
    return t.reshape(b, a * g * g, e)[..., 4:] @ w


def unsettled(boxes: torch.Tensor, raw: torch.Tensor, thresh: float,
              nms_iou: float, keys: torch.Tensor | None = None) -> torch.Tensor:
    """(B, N, 4) boxes and (B, N, C) scores before the threshold -> (B, C)
    whether a class's pairs may differ between float32 and float64: a
    score within ``SCORE_MARGIN`` x ``thresh`` of ``thresh``; or, among
    its candidates, an IoU within ``IOU_MARGIN`` of ``nms_iou``, or two
    whose IoU passes ``nms_iou - IOU_MARGIN`` with scores within
    ``SCORE_MARGIN`` of each other's (NMS may take them in either order),
    unless ``keys`` (``score_keys``) says their scores' inputs are the
    same."""
    b, n, c = raw.shape
    near = ((raw - thresh).abs() <= SCORE_MARGIN * thresh).any(dim=1)
    sc = torch.where(raw > thresh, raw, torch.zeros_like(raw))
    sc = sc.permute(0, 2, 1).reshape(b * c, n)
    width = max(int((sc > 0).sum(dim=1).max()), 1) if sc.numel() else 1
    order = torch.sort(-sc, dim=-1, stable=True).indices[:, :width]
    s = torch.gather(sc, 1, order)
    alive = s > 0
    bx = boxes[:, None].expand(b, c, n, 4).reshape(b * c, n, 4)
    sel = torch.gather(bx, 1, order[..., None].expand(-1, -1, 4))
    m = iou(sel[:, :, None], sel[:, None, :])
    both = alive[:, :, None] & alive[:, None, :]
    both &= ~torch.eye(width, dtype=torch.bool, device=sc.device)
    tie = (m - nms_iou).abs() <= IOU_MARGIN
    swap = (m > nms_iou - IOU_MARGIN) & (
        (s[:, :, None] - s[:, None, :]).abs()
        <= SCORE_MARGIN * torch.maximum(s[:, :, None], s[:, None, :]))
    if keys is not None:
        k = torch.gather(keys[:, None].expand(b, c, n).reshape(b * c, n), 1, order)
        swap &= k[:, :, None] != k[:, None, :]
    return near | (both & (tie | swap)).any(dim=(1, 2)).reshape(b, c)


class Answer:
    """The reference's answer for a block of frames as the comparison
    reads it: ``dets`` (B, max_det, 6) and ``count`` (B,), as the program
    gives them; ``settled`` (B, C), not ``unsettled``; and ``safe_above``
    (B,): a pair of a settled class scoring above it lies within the
    first ``max_det`` on either side. It is the (max_det + 1)-th largest
    score among the pairs a side may rank before it (every pair of a
    settled class left by NMS, every candidate of an unsettled class), over
    1 - 2 ``SCORE_MARGIN``: a pair above it has at most ``max_det`` - 1
    such pairs above it on either side, whichever way the ties fall."""

    def __init__(self, boxes, raw, thresh, nms_iou, max_det, keys=None):
        """``boxes``, ``raw``: ``decode``'s, in float64, before the
        threshold; ``keys``: ``score_keys``."""
        scores = torch.where(raw > thresh, raw, torch.zeros_like(raw))
        kept = nms(boxes, scores, nms_iou)
        self.dets, self.count = top(boxes, kept, max_det)
        self.settled = ~unsettled(boxes, raw, thresh, nms_iou, keys)
        b = raw.shape[0]
        near = torch.where(raw > thresh * (1 - SCORE_MARGIN), raw, torch.zeros_like(raw))
        rivals = torch.where(self.settled[:, None, :], kept, near).reshape(b, -1)
        if rivals.shape[1] > max_det:
            cut = torch.topk(rivals, max_det + 1, dim=1).values[:, -1]
        else:
            cut = torch.zeros(b, dtype=raw.dtype, device=raw.device)
        self.safe_above = cut / (1 - 2 * SCORE_MARGIN)

    def rows(self, idx: torch.Tensor) -> "Answer":
        """The answer of the frames ``idx`` of the block."""
        sub = Answer.__new__(Answer)
        for name in ("dets", "count", "settled", "safe_above"):
            setattr(sub, name, getattr(self, name)[idx])
        return sub


def answer(frames: torch.Tensor, kernels, biases, shifts, specs, anchors,
           num_classes: int, thresh: float, nms_iou: float, max_det: int, *,
           sums_dtype=None, head_dtype=torch.float64) -> Answer:
    """(B, C, S, S) u8 frames -> the reference's ``Answer``: ``forward``,
    ``decode`` in ``head_dtype``, then as ``detect``."""
    sums = forward(frames, kernels, biases, shifts, specs, sums_dtype=sums_dtype)
    boxes, raw = decode(sums, shifts[-1], anchors, num_classes, dtype=head_dtype)
    return Answer(boxes.to(torch.float64), raw.to(torch.float64), thresh, nms_iou,
                  max_det, score_keys(sums, anchors, num_classes))


def match(ref: Answer, dets: np.ndarray, count: np.ndarray) -> dict[str, np.ndarray]:
    """A program's ``dets`` (B, max_det, 6) and ``count`` (B,) against the
    reference's of the same frames, a pair compared where its class is
    ``settled`` and its score above ``safe_above`` -> per frame ``ref_all``
    (the reference's pairs), ``ref_n`` and ``miss`` (those compared, and
    those of them the program lacks: same class, IoU >= ``MATCH_IOU``),
    ``prog_n`` and ``extra`` (the program's compared, and those the
    reference lacks), and ``score_err`` and ``box_err`` (the largest
    absolute errors of matched pairs, 0 where none matched)."""
    rd = ref.dets.cpu().numpy()
    rc = ref.count.cpu().numpy()
    pd = np.asarray(dets, np.float64)
    pc = np.clip(np.asarray(count, np.int64), 0, rd.shape[1])
    b, m, _ = rd.shape
    slots = np.arange(m)[None]
    settled = ref.settled.cpu().numpy()
    floor = ref.safe_above.cpu().numpy()[:, None]
    valid_r = slots < rc[:, None]
    valid_p = slots < pc[:, None]

    def compared(d, valid):
        cls = np.clip(d[..., 5].astype(np.int64), 0, settled.shape[1] - 1)
        return valid & np.take_along_axis(settled, cls, axis=1) & (d[..., 4] > floor)

    rv, pv = compared(rd, valid_r), compared(pd, valid_p)
    a = torch.from_numpy(rd[:, :, None, :4])
    q = torch.from_numpy(pd[:, None, :, :4])
    same = (rd[:, :, None, 5] == pd[:, None, :, 5])
    # a compared pair may match any pair of the other side: one left out
    # there is not a miss
    pair = (iou(a, q).numpy() >= MATCH_IOU) & same & valid_r[:, :, None] & valid_p[:, None, :]
    miss = rv & ~pair.any(axis=2)
    extra = pv & ~pair.any(axis=1)
    both = pair & rv[:, :, None]
    serr = np.where(both, np.abs(rd[:, :, None, 4] - pd[:, None, :, 4]), 0.0)
    berr = np.where(both[..., None], np.abs(rd[:, :, None, :4] - pd[:, None, :, :4]), 0.0)
    return {"ref_all": rc.astype(np.int64), "ref_n": rv.sum(axis=1),
            "miss": miss.sum(axis=1), "prog_n": pv.sum(axis=1),
            "extra": extra.sum(axis=1),
            "score_err": serr.reshape(b, -1).max(axis=1) if m else np.zeros(b),
            "box_err": berr.reshape(b, -1).max(axis=1) if m else np.zeros(b)}


# L6 and L7 are the last layer's two before it; L3's shift (layer 3, or the
# last but one of a shallower net); L5 is the first 2x2 stride-1 pool
CONTROLS = {"bf16_head": {"head_dtype": torch.bfloat16},
            "f32_sums": {"f32_layers": (-3, -2)},
            "shift_off": {"shift_up": 3},
            "no_stride1_pool": {"drop_stride1": True}}


class Reference:
    """The reference of one configuration file (``configs/<name>.json``),
    on the bundle's ``region_weights.npz`` and ``shifts.json``, on
    ``device``; a control's changes where given."""

    def __init__(self, config: dict, device, head_dtype=torch.float64,
                 f32_layers=(), shift_up=None, drop_stride1=False):
        no_tf32()
        self.device = torch.device(device)
        self.specs = [tuple(int(v) for v in row) for row in config["layer_configs"]]
        self.shifts = [int(s) for s in config["shifts"]]
        d = spec.bundle_dir(config)
        with open(os.path.join(d, "shifts.json")) as f:
            if [int(s) for s in json.load(f)] != self.shifts:
                raise ValueError(f"{d}/shifts.json disagrees with the configuration")
        with np.load(os.path.join(d, "region_weights.npz")) as z:
            n = len(self.specs)
            self.kernels = [torch.from_numpy(z[f"kernel{i}"].astype(np.int8)).to(self.device)
                            for i in range(n)]
            self.biases = [torch.from_numpy(z[f"bias{i}"].astype(np.int32)).to(self.device)
                           for i in range(n)]
        n = len(self.specs)
        if shift_up is not None:
            self.shifts[min(shift_up, n - 2)] += 1
        if drop_stride1:
            at = next(i for i, row in enumerate(self.specs) if row[4] == 1)
            self.specs[at] = (*self.specs[at][:4], 0)
        self.anchors = [tuple(a) for a in config["anchors"]]
        self.classes = int(config["num_classes"])
        self.thresh, self.nms = float(config["thresh"]), float(config["nms"])
        self.max_det = int(config["max_det"])
        self.head_dtype = head_dtype
        self.sums_dtype = {i % n: torch.float32 for i in f32_layers}

    def _args(self, frames: torch.Tensor):
        return ((frames.to(self.device), self.kernels, self.biases, self.shifts, self.specs,
                 self.anchors, self.classes, self.thresh, self.nms, self.max_det),
                {"sums_dtype": self.sums_dtype, "head_dtype": self.head_dtype})

    def answer(self, frames: torch.Tensor) -> Answer:
        args, kw = self._args(frames)
        return answer(*args, **kw)

    def detect(self, frames: torch.Tensor):
        """(dets, count), as the program gives them."""
        args, kw = self._args(frames)
        return detect(*args, **kw)[2:]


def _tensor(frames) -> torch.Tensor:
    return torch.from_numpy(frames) if isinstance(frames, np.ndarray) else frames


def _distinct(frame: np.ndarray, dets: np.ndarray, count: np.ndarray):
    """The distinct (frame, answer) rows of the kept answers: their first
    rows and how many answers each stands for."""
    n = len(frame)
    bits = np.ascontiguousarray(dets, np.float32).reshape(n, -1).view(np.uint32)
    mult = np.random.default_rng(0).integers(1, 2**63, size=bits.shape[1],
                                             dtype=np.uint64) | np.uint64(1)
    digest = np.zeros(n, np.uint64)
    for i in range(0, n, 65536):  # in blocks: the kept answers may be many
        digest[i:i + 65536] = (bits[i:i + 65536].astype(np.uint64) * mult).sum(axis=1)
    keys = np.stack([np.asarray(frame, np.uint64), digest,
                     np.asarray(count, np.int64).astype(np.uint64)], axis=1)
    _, first, times = np.unique(keys, axis=0, return_index=True, return_counts=True)
    return first, times


def numbers(found: list[dict], lost: int = 0) -> dict[str, float]:
    """The five numbers from ``match``'s per-answer counts, each with the
    number of answers it stands for (``times``)."""
    if not found:
        return {"det_miss": 1.0, "det_extra": 1.0, "score_err": 1.0, "box_err": 1.0,
                "lost": float(lost)}
    t = np.concatenate([f["times"] for f in found]).astype(np.float64)
    total = {k: np.concatenate([f[k] for f in found]) for k in found[0] if k != "times"}
    ref_n, prog_n = (total["ref_n"] * t).sum(), (total["prog_n"] * t).sum()
    return {"det_miss": float((total["miss"] * t).sum() / ref_n) if ref_n else 1.0,
            "det_extra": float((total["extra"] * t).sum() / prog_n) if prog_n else 1.0,
            "score_err": float(total["score_err"].max()) if ref_n else 1.0,
            "box_err": float(total["box_err"].max()) if ref_n else 1.0,
            "lost": float(lost)}


def compared(found: list[dict]) -> dict[str, float]:
    """How much ``numbers`` rests on, over every kept answer: the
    reference's pairs, those compared and their share, the frames'
    answers, and the share of them with every pair compared."""
    if not found:
        return {"ref_pairs": 0.0, "pairs_compared": 0.0, "pair_share": 0.0,
                "answers": 0.0, "whole_share": 0.0}
    t = np.concatenate([f["times"] for f in found]).astype(np.float64)
    ref_all = np.concatenate([f["ref_all"] for f in found])
    ref_n = np.concatenate([f["ref_n"] for f in found])
    pairs, kept = float((ref_all * t).sum()), float((ref_n * t).sum())
    return {"ref_pairs": pairs, "pairs_compared": kept,
            "pair_share": kept / pairs if pairs else 0.0, "answers": float(t.sum()),
            "whole_share": float((t * (ref_n == ref_all)).sum() / t.sum())}


def held_against(base: Reference, frames: torch.Tensor, block: int, answers):
    """``match`` of answers (frame index, dets, count) against ``base``'s
    detections of ``frames``, ``block`` distinct frames at a time -> the
    list of per-block counts (with ``times``) for ``numbers``."""
    frame, dets, count = answers
    if len(frame) == 0:
        return []
    first, times = _distinct(frame, dets, count)
    order = np.argsort(np.asarray(frame)[first], kind="stable")
    first, times = first[order], times[order]
    fr = np.asarray(frame)[first]
    found = []
    for lo in range(0, frames.shape[0], block):
        sel = (fr >= lo) & (fr < lo + block)
        if not sel.any():
            continue
        ref = base.answer(frames[lo:lo + block])
        rows = first[sel]
        got = match(ref.rows(torch.from_numpy(fr[sel] - lo).to(ref.dets.device)),
                    dets[rows], count[rows])
        got["times"] = times[sel]
        found.append(got)
    return found


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
