"""A seeded bundle of a YOLOv3 detector (a darknet layer graph with [yolo]
heads), in the program's layout (``region_weights.npz``: ``kernel<i>``
(oc, ic, k, k) int8 and ``bias<i>`` (oc,) int32 a conv; ``shifts.json``;
``classes.json``), and ``calibration.json``, which says how it was drawn.

The trained weights are not in the repository, so the weights are drawn
from the seed and sized, conv by conv in the graph's order, on
``CAL_FRAMES`` seeded noise frames (the frames the cells draw), at the
configuration's shifts, with the benchmark's own reference
(``reference/yolov3.py``: its exact float64 sums):

- a conv with a ReLU: w = round(sigma (z +- MEAN)), z standard normal,
  the mean's sign drawn a channel, clipped to -127..127; sigma makes the
  sums' spread ``SPREAD`` x 2**shift (the mean stands for what batch norm
  folds into a trained conv's weights and bias, and lifts the deep convs'
  sums past 2**24, where a float32 sum is no longer exact; its two signs
  keep a pixel's channels from all falling to 0 together); each output
  channel's bias
  puts the ``ZERO_SHARE`` quantile of its sums at 0. A ReLU branch only
  adds to the u8 residual stream, so a stage's blocks share its headroom:
  the conv that starts a stream (a stride-2 conv whose map the first
  shortcut adds) spreads ``STREAM_SPREAD``, and a conv whose map a
  shortcut adds to the stream puts its ``BRANCH_ZERO`` quantile at 0 and
  takes, by bisection, the largest spread up to ``SPREAD`` that leaves at
  most its share of ``MAX_SAT`` of the shortcut's sums at 255 (block i of
  a stage's n, i / n of it). Where the floor leaves more than ``MAX_ZERO``
  of a conv's outputs at 0, a lower quantile goes to 0 (by bisection);
- the three linear 1x1 convs: zero-mean weights whose sums spread
  ``T_SPREAD`` in t = sum / 2**shift, biases that centre every channel's t
  at 0; then, per head, one more objectness bias found by bisection that
  leaves that head's share (its boxes' share of the frame's) of
  ``CANDIDATES`` boxes a frame above the objectness threshold, and one
  more class bias that leaves ``PAIRS`` (box, class) pairs above it a
  candidate, on average: darknet's ``thresh`` of 0.005 keeps many low
  pairs for the mAP, and they set the head's NMS work.

``shifts(config, seed)`` finds the shifts that put every ReLU conv's sigma
in ``SIGMA``, 12..24 (what the configuration states). ``calibration.json`` holds each
conv's sigma, its shares of outputs at 0 and at 255 (and its shortcut's),
and each head's candidates and pairs a frame. It imports nothing of the
program, so that a tree without the configuration fails on the program's
side, after this.
"""

from __future__ import annotations

import json
import math
import os
import zlib

import numpy as np
import torch

from benchmarks.reference import yolov3 as ref

CAL_FRAMES = 2
SPREAD = 72.0
MEAN = 3.0
ZERO_SHARE = 0.35
STREAM_SPREAD = 24.0
BRANCH_ZERO = 0.45
MAX_ZERO = 0.55
MAX_SAT = 0.03
T_SPREAD = 1.0
CANDIDATES = 1000.0
PAIRS = 3.0
SIGMA = (12.0, 24.0)


def _rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) & (2**64 - 1), (int(seed) >> 64) & (2**64 - 1),
         zlib.crc32(b"yolov3.bundle")]))


def _device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _share(v: torch.Tensor, value: float) -> float:
    return float((v == value).double().mean())


def _bisect(ok, lo: float, hi: float, steps: int = 30) -> float:
    """The largest x in [lo, hi] with ok(x), ok monotone (true below)."""
    if ok(hi):
        return hi
    for _ in range(steps):
        mid = (lo + hi) / 2
        if ok(mid):
            lo = mid
        else:
            hi = mid
    return lo


def _nearest(count, want: float, lo: float, hi: float) -> float:
    """The offset in [lo, hi] whose count (increasing in it) is nearest
    ``want`` by ratio: the last one at or below it or the first one above
    (a seeded net repeats cells exactly, so counts come in steps)."""
    below = _bisect(lambda o: count(o) <= want, lo, hi)
    above = below + (hi - lo) / 2 ** 30
    n_below, n_above = max(count(below), 1e-9), count(above)
    return below if want / n_below <= n_above / want else above


def calibrate(config: dict, seed: int, shifts=None) -> tuple[list, list, list, dict]:
    """-> (kernels, biases, shifts, calibration): the weights drawn and
    sized (the module docstring); ``shifts`` None finds each ReLU conv's
    shift (its sigma in ``SIGMA``) and each linear conv's (its weights'
    sigma the same), else takes them."""
    dev = _device()
    if dev.type == "cuda":
        ref.no_tf32()
    rows = [tuple([row[0], *(int(v) for v in row[1:])]) for row in config["layer_configs"]]
    anchors = [tuple(float(v) for v in a) for a in config["anchors"]]
    classes, thresh = int(config["num_classes"]), float(config["thresh"])
    heads = [r for r, row in enumerate(rows) if row[0] == "yolo"]
    linear = {r - 1 for r in heads}
    src = ref._sources(rows)
    # each shortcut's place in its stage's chain of shortcuts (1..n) and n
    place: dict[int, int] = {}
    for r, row in enumerate(rows):
        if row[0] == "shortcut":
            place[r] = place.get(src[r][1], 0) + 1
    chain = {}
    for r in sorted(place, reverse=True):
        nxt = next((q for q in place if src[q][1] == r), None)
        chain[r] = chain[nxt] if nxt is not None else place[r]
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
            sign = rng.choice([-1.0, 1.0], size=(oc, 1, 1, 1))
            mean = 0.0 if is_linear else MEAN * sign
            zero = torch.zeros(oc, dtype=torch.int32)
            base = ref.conv_sums(h, torch.from_numpy(z + mean), zero, k, stride)
            spread = float(base.std(dim=(0, 2, 3)).mean())
            shortcut = r + 1 < len(rows) and rows[r + 1][0] == "shortcut"
            starts = any(row2[0] == "shortcut" and src[q][1] == r
                         for q, row2 in enumerate(rows))
            # sigma at the full spread, and the shift that puts it in SIGMA
            full = (T_SPREAD if is_linear else STREAM_SPREAD if starts else SPREAD) / spread
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
                head_boxes = 3 * g * g
                want = CANDIDATES * head_boxes / boxes_total
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
                res = maps[src[r + 1][1]] if shortcut else None

                def make(scale, q):
                    sigma, w, sums = draw(scale)
                    per = sums.permute(1, 0, 2, 3).reshape(oc, -1)
                    b = -torch.quantile(per, q, dim=1).round()
                    out = ref.clip_shift(sums + b.to(sums)[None, :, None, None], shift)
                    return sigma, w, b, out

                scale, q = 1.0, ZERO_SHARE
                if res is None:
                    sigma, w, b, out = make(1.0, ZERO_SHARE)
                else:
                    def sat(scale, q):
                        return _share(torch.clamp(make(scale, q)[3] + res, max=255), 255.0)

                    budget = MAX_SAT * place[r + 1] / chain[r + 1]
                    scale = _bisect(lambda s: sat(s, BRANCH_ZERO) <= budget, 0.02, 1.0, 12)
                    q = BRANCH_ZERO
                    sigma, w, b, out = make(scale, BRANCH_ZERO)
                if _share(out, 0.0) > MAX_ZERO:
                    q = _bisect(lambda q: _share(make(scale, q)[3], 0.0) <= MAX_ZERO, 0.0, q, 12)
                    sigma, w, b, out = make(scale, q)
                if res is not None:
                    entry.update(shortcut_zero_share=_share(torch.clamp(out + res, max=255), 0.0),
                                 shortcut_max_share=_share(torch.clamp(out + res, max=255),
                                                           255.0))
                entry.update(sigma=sigma, zero_share=_share(out, 0.0),
                             max_share=_share(out, 255.0),
                             sum_abs_max=float(draw(scale)[2].abs().max()))
            kernels.append(w)
            biases.append(b.to(torch.int64).cpu().numpy().astype(np.int32))
            found.append(shift)
            layers.append(entry)
            maps[r] = out
            conv += 1
        elif kind == "shortcut":
            maps[r] = torch.clamp(maps[src[r][0]] + maps[src[r][1]], max=255)
        elif kind == "route":
            maps[r] = torch.cat([maps[i] for i in src[r]], dim=1)
        elif kind == "upsample":
            maps[r] = maps[r - 1].repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        else:
            maps[r] = maps[r - 1]
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
