"""A seeded bundle of a YOLOv2 region-head detector, in the program's layout
(``region_weights.npz``: ``kernel<i>`` (oc, ic, k, k) int8 and ``bias<i>``
(oc,) int32 per layer; ``shifts.json``; ``classes.json``), and
``calibration.json``, which says how it was drawn.

The trained weights are not in the repository, so the weights are drawn
from the seed and sized, layer by layer, on ``CAL_FRAMES`` seeded noise
frames (the frames the cells draw), at the configuration's shifts:

- a layer with a ReLU: w = round(sigma (z + MEAN)), z standard normal,
  clipped to -127..127. sigma makes the sums' spread ``SPREAD`` x 2**shift
  (a u8 output's spread of about ``SPREAD`` steps). The mean (``MEAN``
  sigma) stands for what batch norm folds into a trained layer's weights
  and bias: it lifts the sums of L6 and L7 past 2**24, where a float32 sum
  is no longer exact. Each output channel's int32 bias puts the
  ``ZERO_SHARE`` quantile of its sums at 0, so that about that share of
  the ReLU's outputs is 0;
- the linear last layer: zero-mean weights whose sums spread ``T_SPREAD``
  in t = sum / 2**shift, biases that centre every channel's t at 0, and
  on the objectness channels one more bias, found by bisection, that
  leaves ``CANDIDATES`` (box, class) pairs above the threshold in a frame
  before NMS, on average, as a trained detector leaves a few hundred at
  darknet's ``thresh`` of 0.005.

The sums are exact (float64 of integers below 2**31). ``calibration.json``
holds each layer's sigma, its shares of outputs at 0 and at 255 and the
candidates per frame.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch

from benchmarks.reference import yolov2 as ref

CAL_FRAMES = 2
SPREAD = 96.0
MEAN = 3.0
ZERO_SHARE = 0.35
T_SPREAD = 1.0
CANDIDATES = 300.0


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2**64 - 1), (int(seed) >> 64) & (2**64 - 1),
         zlib.crc32(b"yolov2.bundle")]))


def _candidates(sums, offset: float, shift: int, anchors, classes: int,
                thresh: float) -> float:
    """Pairs above the threshold per frame, with ``offset`` added to every
    objectness t."""
    t = sums.clone()
    e = 5 + classes
    for n in range(len(anchors)):
        t[:, n * e + 4] += offset * float(1 << shift)
    _, scores = ref.decode(t, shift, anchors, classes)
    return float((scores > thresh).sum()) / sums.shape[0]


def make(config: dict, seed: int, path: str) -> None:
    specs = [tuple(int(v) for v in row) for row in config["layer_configs"]]
    shifts = [int(s) for s in config["shifts"]]
    anchors = [tuple(float(v) for v in a) for a in config["anchors"]]
    classes, thresh = int(config["num_classes"]), float(config["thresh"])
    c, s = specs[0][0], specs[0][2]
    rng = _rng(seed)
    h = torch.from_numpy(rng.integers(0, 256, (CAL_FRAMES, c, s, s), dtype=np.uint8))
    h = h.to(torch.float64)
    kernels, biases, layers = [], [], []
    last = len(specs) - 1
    for i, ((ic, oc, _, k, pool), shift) in enumerate(zip(specs, shifts)):
        z = rng.standard_normal((oc, ic, k, k))
        zero = torch.zeros(oc, dtype=torch.int32)
        mean = 0.0 if i == last else MEAN
        spread = float(ref.layer_sums(h, torch.from_numpy(z + mean), zero, k)
                       .std(dim=(0, 2, 3)).mean())
        target = (T_SPREAD if i == last else SPREAD) * float(1 << shift)
        sigma = round(target / spread, 3)
        w = np.clip(np.round(sigma * (z + mean)), -127, 127).astype(np.int8)
        sums = ref.layer_sums(h, torch.from_numpy(w), zero, k)  # exact
        per = sums.permute(1, 0, 2, 3).reshape(oc, -1)
        entry = {"layer": i, "sigma": sigma,
                 "sum_abs_max": float(per.abs().max())}
        if i < last:
            b = -torch.quantile(per, ZERO_SHARE, dim=1).round()
            out = torch.clamp(torch.floor((sums + b[None, :, None, None])
                                          / float(1 << shift)), 0, 255)
            entry.update(zero_share=float((out == 0).double().mean()),
                         max_share=float((out == 255).double().mean()))
            h = ref.pool(out, pool)
        else:
            b = -per.mean(dim=1).round()
            centred = sums + b[None, :, None, None]
            lo, hi = -20.0, 20.0
            for _ in range(60):
                mid = (lo + hi) / 2
                if _candidates(centred, mid, shift, anchors, classes, thresh) < CANDIDATES:
                    lo = mid
                else:
                    hi = mid
            obj = math.ceil(hi * float(1 << shift))  # the count grows with it
            for n in range(len(anchors)):
                b[n * (5 + classes) + 4] += obj
            entry.update(candidates_per_frame=_candidates(
                sums + b[None, :, None, None], 0.0, shift, anchors, classes, thresh))
        kernels.append(w)
        biases.append(b.to(torch.int64).numpy().astype(np.int32))
        layers.append(entry)
    arrays = {f"kernel{i}": k for i, k in enumerate(kernels)}
    arrays.update({f"bias{i}": b for i, b in enumerate(biases)})
    np.savez(os.path.join(path, "region_weights.npz"), **arrays)
    with open(os.path.join(path, "shifts.json"), "w") as f:
        json.dump(shifts, f)
    with open(os.path.join(path, "classes.json"), "w") as f:
        json.dump(list(config["class_names"]), f)
    with open(os.path.join(path, "calibration.json"), "w") as f:
        json.dump({"seed": int(seed), "frames": CAL_FRAMES, "layers": layers}, f, indent=1)
