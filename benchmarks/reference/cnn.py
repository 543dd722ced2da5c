"""The plain reference of the detector, in plain torch, on the bundle's own
files.

It follows the network of the configuration file: per layer a 3x3
convolution with zero padding of u8 activations by int8 weights, an
arithmetic right shift, a clip to 0..255 and a 2x2 max pool; then the
4x4 bin means of the last map (/ 255), the linear classifier and softmax,
and every class's CAM box: per-bin class weights over the channels whose
mean is at most 250, ReLU, normalised by the maximum, thresholded above
the larger of its 70th percentile (linear interpolation) and 0.25, the
extremal rows and columns scaled to image pixels, the full frame when
nothing is above the threshold.

The convolutions run in float64 through ``unfold`` and a matrix product:
every product and partial sum is an integer below 2**53, so the result is
exact, whatever the device. The head runs in float64 as well. With
``weight_bits=4`` or ``head="bfloat16"`` the same code computes the
lower-precision controls that the comparison has to catch.

It reads ``weights.bin``, ``fc_weight.npy``, ``fc_bias.npy`` and, where
present, ``shifts.json`` from the bundle itself and imports nothing of the
program.

The comparison of the CAM head (``compare``, the reference module of a
configuration that names none) holds the program's answers, its outputs
read as pred, conf, probs and bbox per frame, against the reference's
class probabilities and per-class CAM boxes of the same frames by four
numbers (``numbers``):

- ``pred_gap``: the widest gap by which the reference's probability of the
  class the program picked lies below the reference's best, over every
  answer (0 where the program picked the reference's best class; a near
  tie can read a little above 0 without a wrong answer);
- ``prob_err``: the largest absolute difference between the program's
  probabilities (and conf) and the reference's;
- ``box_miss``: the share of answers whose box differs from the
  reference's box for the class the program picked;
- ``lost``: answers that never came (a request with no response at all).

A run that kept no answer to compare reads 1 in the first three.

Its controls (``controls``, what ``control.py`` prints) are the reference
put in the program's place a step below the configuration's precision:

- ``int4``: the convolutions with the int8 weights rounded to int4 (on the
  int8 scale, ``round(w / 16) * 16`` clipped to -128..112), the step below
  int8;
- ``bf16_head``: the head (bins, classifier, CAM) rounded to bfloat16,
  the step below its float32.

Each control's answers are the argmax class, its probability and its box.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from benchmarks.lib import spec

NUMBERS = ("pred_gap", "prob_err", "box_miss", "lost")
CONTROLS = {"int4": {"weight_bits": 4}, "bf16_head": {"head": "bfloat16"}}
GRID = 4
SATURATION_MEAN = 250.0
CAM_PERCENTILE = 70.0
CAM_FLOOR = 0.25


def decode_weights(raw: np.ndarray, layer_configs) -> list[np.ndarray]:
    """``weights.bin`` bytes -> per layer (oc, ic, 3, 3) int8. Per layer,
    output channels in groups of 16; per (group, input channel) the 16
    kernels of 9 bytes, row-major."""
    raw = np.asarray(raw).view(np.int8).ravel()
    want = sum(oc * ic * 9 for ic, oc, _ in layer_configs)
    if raw.size != want:
        raise ValueError(f"weights.bin holds {raw.size} bytes, want {want}")
    out, off = [], 0
    for ic, oc, _ in layer_configs:
        n = oc * ic * 9
        k = raw[off:off + n].reshape(oc // 16, ic, 16, 3, 3)
        out.append(np.ascontiguousarray(k.transpose(0, 2, 1, 3, 4)
                                        .reshape(oc, ic, 3, 3)))
        off += n
    return out


class Reference:
    """The reference for one configuration file (``configs/<name>.json``).

    ``detect(frames)`` -> (probs (B, K) float64, boxes (B, K, 4) int64): the
    class probabilities and every class's CAM box of each frame."""

    def __init__(self, config: dict, device: torch.device | str,
                 weight_bits: int = 8, head: str = "float64"):
        if weight_bits not in (8, 4):
            raise ValueError(f"weight_bits {weight_bits}: need 8 or 4")
        if head not in ("float64", "bfloat16"):
            raise ValueError(f"head {head!r}: need 'float64' or 'bfloat16'")
        self.layers = [tuple(int(v) for v in lc) for lc in config["layer_configs"]]
        self.img_size = self.layers[0][2]
        self.shifts = [int(s) for s in config["shifts"]]
        self.device = torch.device(device)
        self.head = head
        d = spec.bundle_dir(config)
        kernels = decode_weights(np.fromfile(os.path.join(d, "weights.bin"),
                                             np.int8), self.layers)
        shifts_json = os.path.join(d, "shifts.json")
        if os.path.exists(shifts_json):
            with open(shifts_json) as f:
                if [int(s) for s in json.load(f)] != self.shifts:
                    raise ValueError(f"{shifts_json} disagrees with the "
                                     f"configuration's shifts {self.shifts}")
        if weight_bits == 4:  # int4 weights on the int8 scale
            kernels = [np.clip(np.round(k / 16.0), -8, 7) * 16 for k in kernels]
        self.kernels = [torch.from_numpy(np.asarray(k, np.float64))
                        .reshape(k.shape[0], -1).to(self.device)
                        for k in kernels]
        self.fc_weight = torch.from_numpy(
            np.load(os.path.join(d, "fc_weight.npy")).astype(np.float64)).to(self.device)
        self.fc_bias = torch.from_numpy(
            np.load(os.path.join(d, "fc_bias.npy")).astype(np.float64)).to(self.device)

    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, S, S) u8 -> (B, C, s, s) float64, integer-valued 0..255."""
        h = frames.to(self.device, torch.float64)[:, None]
        for k, shift in zip(self.kernels, self.shifts):
            b, _, height, width = h.shape
            cols = F.unfold(h, 3, padding=1)  # (B, ic*9, H*W)
            conv = torch.matmul(k, cols)  # (B, oc, H*W), exact
            act = torch.clamp(torch.floor(conv / float(1 << shift)), 0, 255)
            h = F.max_pool2d(act.reshape(b, -1, height, width), 2)
        return h

    def _round(self, t: torch.Tensor) -> torch.Tensor:
        """The head's rounding: none in float64; to bfloat16 in the control."""
        if self.head == "bfloat16":
            return t.to(torch.bfloat16).to(torch.float64)
        return t

    def head_of(self, feats: torch.Tensor):
        """(B, C, s, s) features -> (probs (B, K), boxes (B, K, 4))."""
        b, c, s, _ = feats.shape
        npx = s // GRID
        f6 = feats.reshape(b, c, GRID, npx, GRID, npx)
        pooled = f6.sum(dim=(3, 5)).reshape(b, c * GRID * GRID) / (npx * npx) / 255.0
        w = self._round(self.fc_weight)
        logits = self._round(self._round(pooled) @ w.T + self._round(self.fc_bias))
        probs = torch.softmax(logits, dim=-1)
        valid = (feats.mean(dim=(2, 3)) <= SATURATION_MEAN).to(torch.float64)
        wk = w.reshape(-1, c, GRID, GRID)
        cam = torch.einsum("kcgh,bcgxhy->bkgxhy", wk, f6 * valid[:, :, None, None, None, None])
        cam = self._round(cam).reshape(b, -1, s, s).clamp_min(0.0)
        top = cam.amax(dim=(2, 3), keepdim=True)
        cam = torch.where(top > 0, cam / top.clamp_min(1e-300), cam)
        return probs, self._boxes(cam)

    def _boxes(self, cam: torch.Tensor) -> torch.Tensor:
        """(B, K, s, s) normalised CAMs -> (B, K, 4) int64 boxes."""
        b, k, s, _ = cam.shape
        n = s * s
        ordered = cam.reshape(b, k, n).sort(dim=-1).values
        q = CAM_PERCENTILE / 100.0 * (n - 1)
        lo, hi = math.floor(q), math.ceil(q)
        thr = ordered[..., lo] + (ordered[..., hi] - ordered[..., lo]) * (q - lo)
        thr = thr.clamp_min(CAM_FLOOR)
        mask = cam > thr[..., None, None]
        rows, cols = mask.any(dim=3), mask.any(dim=2)  # (B, K, s)
        idx = torch.arange(s, device=cam.device)
        r1 = torch.where(rows, idx, s).amin(dim=-1)
        r2 = torch.where(rows, idx, -1).amax(dim=-1)
        c1 = torch.where(cols, idx, s).amin(dim=-1)
        c2 = torch.where(cols, idx, -1).amax(dim=-1)
        scale = self.img_size // s
        last = self.img_size - 1
        box = torch.stack([c1 * scale, r1 * scale,
                           ((c2 + 1) * scale).clamp_max(last),
                           ((r2 + 1) * scale).clamp_max(last)], dim=-1)
        full = torch.tensor([0, 0, last, last], device=cam.device)
        return torch.where(rows.any(dim=-1)[..., None], box, full)

    def detect(self, frames: torch.Tensor, block: int = 256):
        """(B, S, S) u8 frames -> (probs (B, K) float64, boxes (B, K, 4)
        int64) on the host, ``block`` frames at a time."""
        probs, boxes = [], []
        for i in range(0, frames.shape[0], block):
            p, bx = self.head_of(self.features(frames[i:i + block]))
            probs.append(p.cpu())
            boxes.append(bx.cpu())
        return torch.cat(probs).numpy(), torch.cat(boxes).numpy()


def numbers(ref_probs: np.ndarray, ref_boxes: np.ndarray, frame: np.ndarray,
            pred: np.ndarray, conf: np.ndarray, probs: np.ndarray,
            bbox: np.ndarray, lost: int = 0) -> dict[str, float]:
    """The four numbers over n answers. ``ref_probs`` (U, K) and
    ``ref_boxes`` (U, K, 4) are the reference's per distinct frame;
    ``frame`` (n,) says which distinct frame each answer is for; ``pred``
    (n,), ``conf`` (n,), ``probs`` (n, K) and ``bbox`` (n, 4) are the
    program's answers. With no answer (n = 0) the first three read 1, as
    wrong answers do: a run that compared nothing is not correct."""
    frame = np.asarray(frame, np.int64)
    pred = np.asarray(pred, np.int64)
    n, k = len(frame), ref_probs.shape[1]
    if n == 0:  # nothing compared: every number reads as wrong answers do
        return {"pred_gap": 1.0, "prob_err": 1.0, "box_miss": 1.0,
                "lost": float(lost)}
    valid = (pred >= 0) & (pred < k)
    safe = np.where(valid, pred, 0)
    rp = ref_probs[frame]  # (n, K)
    picked = rp[np.arange(n), safe]
    gap = np.where(valid, rp.max(axis=1) - picked, 1.0)
    err = np.maximum(np.abs(np.asarray(probs, np.float64) - rp).max(axis=1),
                     np.abs(np.asarray(conf, np.float64) - picked))
    err = np.where(valid, err, 1.0)
    want_box = ref_boxes[frame, safe]  # (n, 4)
    miss = ~valid | (np.asarray(bbox, np.int64) != want_box).any(axis=1)
    return {"pred_gap": float(np.nan_to_num(gap, nan=1.0).max()),
            "prob_err": float(np.nan_to_num(err, nan=1.0).max()),
            "box_miss": float(miss.mean()),
            "lost": float(lost)}


def control_answers(ref_probs: np.ndarray, ref_boxes: np.ndarray):
    """A control's own answers from its probabilities and boxes: the
    argmax class, its probability and its box -> (pred, conf, probs,
    bbox)."""
    pred = ref_probs.argmax(axis=1)
    rows = np.arange(len(pred))
    return pred, ref_probs[rows, pred], ref_probs, ref_boxes[rows, pred]


def _tensor(frames) -> torch.Tensor:
    return torch.from_numpy(frames) if isinstance(frames, np.ndarray) else frames


def compare(cell, outcome, device) -> dict[str, float]:
    """The comparison's numbers: the reference on the distinct frames the
    program answered, then ``numbers`` over every kept answer, its outputs
    read as pred, conf, probs and bbox."""
    block = int(cell.params["reference_block"])
    probs, boxes = Reference(cell.config, device).detect(_tensor(outcome.frames), block)
    pred, conf, pr, bbox = outcome.answers.outputs
    return numbers(probs, boxes, outcome.answers.frame, pred, conf, pr, bbox,
                   lost=outcome.lost)


def controls(cell, frames, device) -> dict[str, dict[str, float]]:
    """{control: numbers} of each of ``CONTROLS`` on ``frames``, each held
    against the float64 reference as the program's answers are."""
    frames, block = _tensor(frames), int(cell.params["reference_block"])
    probs, boxes = Reference(cell.config, device).detect(frames, block)
    out = {}
    for name, kw in CONTROLS.items():
        cp, cb = Reference(cell.config, device, **kw).detect(frames, block)
        out[name] = numbers(probs, boxes, np.arange(len(frames)),
                            *control_answers(cp, cb))
    return out
