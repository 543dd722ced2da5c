"""YOLOv7-640's launches on the card, timed one by one at the offline
cell's batch and summed by kind (each conv by its kernel, its shape and
whether it reads or writes a concatenation's slice; each pool), each kind
against the sum of its launches' own bounds
(``benchmarks/lib/yolo7_counts``: ``conv_bound_ms`` a conv, a pool's
bytes at 3.35 TB/s).

    python scripts/yolo7_conv_times.py [--batch 256] [--rounds 5] [--out FILE]

Runs from the root of a checkout whose ``RegionEngine`` runs YOLOv7 on
cuda:0: the cell's engine on its seeded bundle (``chip_smoke.yolo7_model``),
seeded noise frames, the plan's launches in order with a CUDA event after
each (``yolo3_conv_times.round_ms``: the stream held by a device spin while
the host queues the round, so that each pair of events times one kernel).
Prints the card, a line a kind (launches, median ms a round, bound ms,
share) and the totals by kernel; ``--out`` writes every launch's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from benchmarks.lib import roofline, yolo7_counts  # noqa: E402
from chip_smoke import yolo7_model  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from yolo3_conv_times import round_ms  # noqa: E402


def kind(engine, step, convs) -> str:
    """A launch's kind: its kernel, its shape, its slices."""
    if step.route == "pool":
        return "pool 2x2/2" if step.kwargs["stride"] == 2 else "pool SPP cascade"
    _, _, _, k, stride = convs[step.conv]
    sliced = {r for s in engine._plan for r, into in s.made if into is not None}
    reads = step.src is not None and engine._alias(step.src, engine._nodes) in sliced
    tag = (" reads a slice" if reads else "") + (" writes a slice" if step.into else "")
    if step.route == "layer":
        return "layer kernel" + (" stride 2" if stride == 2 else "") + tag
    if step.kwargs.get("last"):
        return "stream linear 1x1"
    if stride == 2:
        return "stream 3x3 stride 2" + tag
    if step.kwargs.get("upsample"):
        return "stream 1x1 upsample" + tag
    return f"stream {k}x{k}" + tag


def pool_bound_ms(engine, step, batch: int) -> float:
    """A pool launch's least ms: its map in once, its maps out."""
    src = engine._nodes[step.src]
    out = sum(engine._nodes[r].channels * engine._nodes[r].size ** 2 for r, _ in step.outs)
    return roofline.bound(0, (src.channels * src.size ** 2 + out) * batch)[0]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("yolo7_conv_times: torch finds no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    model = yolo7_model()
    rows = model.config.layer_configs
    convs = yolo7_counts.convs(rows)
    engine = CUDAEngine(model, dev, backend="pallas", box_mode="yolo")
    frames = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (args.batch, 3, 640, 640)).astype(np.uint8)).to(dev)
    engine._net(frames)  # builds the kernels, warms the card
    times = [round_ms(engine, frames) for _ in range(args.rounds)]
    launches = []
    for i, step in enumerate(engine._plan):
        bound = (pool_bound_ms(engine, step, args.batch) if step.route == "pool"
                 else yolo7_counts.conv_bound_ms(rows, step.conv, args.batch))
        launches.append({"conv": step.conv, "route": step.route,
                         "kind": kind(engine, step, convs),
                         "shape": convs[step.conv] if step.conv is not None else
                         [step.kwargs["sizes"], step.kwargs["stride"]],
                         "ms": statistics.median(t[i] for t in times), "bound_ms": bound})
    kinds: dict[str, list] = {}
    for launch in launches:
        kinds.setdefault(launch["kind"], []).append(launch)
    for name, group in sorted(kinds.items()):
        ms, bound = sum(g["ms"] for g in group), sum(g["bound_ms"] for g in group)
        print(f"{name}: {len(group)} launches, {ms:.3f} ms a round against {bound:.3f} "
              f"({100 * bound / ms:.1f}%)", flush=True)
    for route in ("layer", "stream", "pool"):
        group = [g for g in launches if g["route"] == route]
        ms, bound = sum(g["ms"] for g in group), sum(g["bound_ms"] for g in group)
        print(f"{route} kernel in all: {ms:.3f} ms a round against {bound:.3f} "
              f"({100 * bound / ms:.1f}%)", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card.strip(), "batch": args.batch, "rounds": args.rounds,
                       "launches": launches}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
