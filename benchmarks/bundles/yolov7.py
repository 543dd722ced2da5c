"""A seeded bundle of a YOLOv7 detector (a darknet layer graph with
``maxpool`` rows, routes of up to six maps and three [yolo] heads), in the
program's layout (``region_weights.npz``: ``kernel<i>`` (oc, ic, k, k) int8
and ``bias<i>`` (oc,) int32 a conv; ``shifts.json``; ``classes.json``), and
``calibration.json``, which says how it was drawn.

The trained weights are not in the repository, so the weights are drawn
from the seed and sized, conv by conv in the graph's order, on
``CAL_FRAMES`` (16) seeded noise frames, at the configuration's shifts,
with the benchmark's own reference (``reference/yolov7.py``: its exact
float64 sums), as ``bundles/yolov3.py`` draws YOLOv3's (its constants,
its bisection):

- a conv with a ReLU: w = round(sigma (z +- MEAN)), z standard normal, the
  mean's sign drawn a channel, clipped to -127..127; sigma makes the sums'
  spread ``SPREAD`` x 2**shift; each output channel's bias puts the
  ``ZERO_SHARE`` quantile of its sums at 0, so every channel is nonzero
  on most pixels. Where more than ``MAX_SAT`` of a conv's outputs reach
  255, its spread is cut (by bisection) until at most that share does, so
  that no map of a concatenation saturates; where more than ``MAX_ZERO``
  of them are 0, a lower quantile goes to 0. YOLOv7 has no shortcut: a
  concatenation's maps keep their own scales, and the 1x1 after it is
  sized on what it reads;
- the three linear 1x1 convs: as YOLOv3's, zero-mean weights whose sums
  spread ``T_SPREAD`` in t = sum / 2**shift and centred biases (each
  output channel's weights summing to zero, so that what a frame shifts
  in all the channels a head reads moves none of its t), then per
  head an objectness bias leaving that head's share of ``CANDIDATES``
  boxes a frame above the threshold and a class bias leaving ``PAIRS``
  pairs a candidate (YOLOv7's ``test.py`` threshold of 0.001).

``shifts(config, seed)`` finds the shifts that put every ReLU conv's sigma
in ``SIGMA`` (what the configuration states). ``calibration.json`` holds
each conv's sigma and its shares of outputs at 0 and at 255 and of
channels never above 0, and each head's candidates and pairs a frame. It
imports nothing of the program, so that a tree without the configuration
fails on the program's side, after this.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch

from benchmarks.bundles.yolov3 import (CANDIDATES, MAX_SAT, MAX_ZERO, MEAN, PAIRS, SIGMA,
                                       SPREAD, T_SPREAD, ZERO_SHARE, _bisect, _device,
                                       _nearest, _share)

from benchmarks.reference import yolov7 as ref

# frames of the calibration: on 2, as YOLOv3's, a frame's candidates ranged
# 746-1,733 (p10-p90) and a class's pairs to 1,396 on the cell's frames
# (H100, 256 frames); on 16 with the linear weights' sums zero, 865-1,114
# and 306
CAL_FRAMES = 16


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2**64 - 1), (int(seed) >> 64) & (2**64 - 1),
         zlib.crc32(b"yolov7.bundle")]))


def _dead_channels(out: torch.Tensor) -> float:
    """The share of a map's channels that are 0 on every pixel."""
    return float((out.amax(dim=(0, 2, 3)) == 0).double().mean())


def calibrate(config: dict, seed: int, shifts=None) -> tuple[list, list, list, dict]:
    """-> (kernels, biases, shifts, calibration): the weights drawn and
    sized (the module docstring); ``shifts`` None finds each conv's shift
    (its sigma in ``SIGMA``), else takes them."""
    dev = _device()
    if dev.type == "cuda":
        ref.no_tf32()
    rows = [tuple([row[0], *(int(v) for v in row[1:])]) for row in config["layer_configs"]]
    classes, thresh = int(config["num_classes"]), float(config["thresh"])
    heads = [r for r, row in enumerate(rows) if row[0] == "yolo"]
    linear = {r - 1 for r in heads}
    src = ref._sources(rows)
    last = {}
    for r, s in enumerate(src):
        for i in s:
            last[i] = r
    size = rows[0][3]
    rng = _rng(seed)
    x = torch.from_numpy(rng.integers(0, 256, (CAL_FRAMES, rows[0][1], size, size),
                                      dtype=np.uint8)).to(dev, torch.float64)
    boxes_total = sum(3 * (rows[r - 1][3] // rows[r - 1][5]) ** 2 for r in heads)
    maps: dict[int, torch.Tensor] = {}
    kernels, biases, found, layers = [], [], [], []
    conv = 0
    for r, row in enumerate(rows):
        kind = row[0]
        if kind == "conv":
            _, ic, oc, _, k, stride = row
            h = maps[r - 1] if r else x
            is_linear = r in linear
            z = rng.standard_normal((oc, ic, k, k))
            if is_linear:  # a shift common to every channel read moves no t
                z -= z.mean(axis=(1, 2, 3), keepdims=True)
            sign = rng.choice([-1.0, 1.0], size=(oc, 1, 1, 1))
            mean = 0.0 if is_linear else MEAN * sign
            zero = torch.zeros(oc, dtype=torch.int32)
            base = ref.conv_sums(h, torch.from_numpy(z + mean), zero, k, stride)
            spread = float(base.std(dim=(0, 2, 3)).mean())
            full = (T_SPREAD if is_linear else SPREAD) / spread
            if shifts is None:
                shift = max(0, min(31, math.ceil(math.log2(SIGMA[0] / full))))
            else:
                shift = int(shifts[conv])
            entry = {"conv": conv, "row": r}
            drawn = {}

            def draw(scale):
                if scale not in drawn:
                    sigma = round(full * scale * float(1 << shift), 3)
                    w = np.clip(np.round(sigma * (z + mean)), -127, 127).astype(np.int8)
                    drawn.clear()  # one conv's sums at a time
                    drawn[scale] = sigma, w, ref.conv_sums(h, torch.from_numpy(w), zero, k,
                                                           stride)
                return drawn[scale]

            if is_linear:
                sigma, w, sums = draw(1.0)
                per = sums.permute(1, 0, 2, 3).reshape(oc, -1)
                b = -per.mean(dim=1).round()
                out = sums + b.to(sums)[None, :, None, None]
                e = 5 + classes
                g = row[3]
                t = out / float(1 << shift)
                want = CANDIDATES * 3 * g * g / boxes_total
                v = t.reshape(CAL_FRAMES, 3, e, g, g)

                def cands(off):
                    return float((torch.sigmoid(v[:, :, 4] + off) > thresh).sum()) / CAL_FRAMES

                obj = _nearest(cands, want, -30.0, 30.0)
                o = torch.sigmoid(v[:, :, 4] + obj)

                def pairs(off):
                    s = o[:, :, None] * torch.sigmoid(v[:, :, 5:] + off)
                    kept = (s > thresh) & (o[:, :, None] > thresh)
                    return float(kept.sum()) / max(float((o > thresh).sum()), 1.0)

                cls = _nearest(pairs, PAIRS, -30.0, 30.0)
                ob, cb = math.ceil(obj * float(1 << shift)), math.ceil(cls * float(1 << shift))
                for n in range(3):
                    b[n * e + 4] += ob
                    b[n * e + 5:(n + 1) * e] += cb
                out = sums + b.to(sums)[None, :, None, None]
                entry.update(sigma=sigma, linear=True,
                             candidates_per_frame=cands(ob / float(1 << shift)))
                o = torch.sigmoid(v[:, :, 4] + ob / float(1 << shift))
                entry.update(pairs_per_candidate=pairs(cb / float(1 << shift)))
            else:
                def make(scale, q):
                    sigma, w, sums = draw(scale)
                    per = sums.permute(1, 0, 2, 3).reshape(oc, -1)
                    b = -torch.quantile(per, q, dim=1).round()
                    out = ref.clip_shift(sums + b.to(sums)[None, :, None, None], shift)
                    return sigma, w, b, out

                scale, q = 1.0, ZERO_SHARE
                sigma, w, b, out = make(scale, q)
                if _share(out, 255.0) > MAX_SAT:
                    scale = _bisect(lambda s: _share(make(s, q)[3], 255.0) <= MAX_SAT,
                                    0.02, 1.0, 12)
                    sigma, w, b, out = make(scale, q)
                if _share(out, 0.0) > MAX_ZERO:
                    q = _bisect(lambda q: _share(make(scale, q)[3], 0.0) <= MAX_ZERO, 0.0, q, 12)
                    sigma, w, b, out = make(scale, q)
                entry.update(sigma=sigma, zero_share=_share(out, 0.0),
                             max_share=_share(out, 255.0), dead_channels=_dead_channels(out),
                             sum_abs_max=float(draw(scale)[2].abs().max()))
            kernels.append(w)
            biases.append(b.to(torch.int64).cpu().numpy().astype(np.int32))
            found.append(shift)
            layers.append(entry)
            maps[r] = out
            conv += 1
        elif kind == "route":
            maps[r] = torch.cat([maps[i] for i in src[r]], dim=1)
        elif kind == "upsample":
            maps[r] = maps[r - 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        elif kind == "maxpool":
            maps[r] = ref.maxpool(maps[r - 1], row[1], row[2])
        else:
            maps[r] = maps[r - 1]
        for i in src[r]:  # let each map go after its last reader
            if last.get(i) == r:
                maps.pop(i, None)
    return kernels, biases, found, {"seed": int(seed), "frames": CAL_FRAMES, "convs": layers}


def shifts(config: dict, seed: int) -> list[int]:
    """The shifts that put each conv's sigma in ``SIGMA`` (what the
    configuration file states)."""
    return calibrate(config, seed)[2]


def make(config: dict, seed: int, path: str) -> None:
    stated = [int(s) for s in config["shifts"]]
    kernels, biases, _, cal = calibrate(config, seed, stated)
    arrays = {f"kernel{i}": k for i, k in enumerate(kernels)}
    arrays.update({f"bias{i}": b for i, b in enumerate(biases)})
    np.savez(os.path.join(path, "region_weights.npz"), **arrays)
    with open(os.path.join(path, "shifts.json"), "w") as f:
        json.dump(stated, f)
    with open(os.path.join(path, "classes.json"), "w") as f:
        json.dump(list(config["class_names"]), f)
    with open(os.path.join(path, "calibration.json"), "w") as f:
        json.dump(cal, f, indent=1)
