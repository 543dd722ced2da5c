"""YOLOv3-416's conv launches on the card, timed one by one at the offline
cell's batch and summed by kind of conv, each kind against the sum of its
convs' own bounds (``benchmarks/lib/yolo3_counts.conv_bound_ms``).

    python scripts/yolo3_conv_times.py [--batch 512] [--rounds 5] [--out FILE]

Runs from the root of a checkout (any commit whose ``RegionEngine`` has
the graph plan) on cuda:0: the cell's engine on its seeded bundle
(``chip_smoke.yolo3_model``), seeded noise frames, the plan's launches in
order with a CUDA event after each, the stream held by a device spin while
the host queues the round, so that each pair of events times one kernel.
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

from benchmarks.lib import yolo3_counts  # noqa: E402
from chip_smoke import yolo3_model  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402


def kind(step, conv) -> str:
    """A launch's kind: its kernel, and on the streamed one its epilogue."""
    _, _, _, k, stride = conv
    if step.route == "layer":
        return "layer kernel"
    if step.kwargs.get("last"):
        return "stream linear 1x1"
    if stride == 2:
        return "stream 3x3 stride 2"
    if step.kwargs.get("upsample"):
        return "stream 1x1 upsample"
    return f"stream {k}x{k}" + (" residual" if step.residual is not None else "")


def round_ms(engine, frames) -> list[float]:
    """One round of the plan's launches -> each launch's device ms. The
    spin doubles until it outlasts the host's queueing of the round."""
    plan = engine._plan
    cycles = 1 << 26
    while True:
        events = [torch.cuda.Event(enable_timing=True) for _ in range(len(plan) + 1)]
        maps, bufs = {}, {}
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        events[0].record()
        for i, step in enumerate(plan):
            h = frames if step.src is None else engine._map(step.src, maps, bufs)
            maps.update(engine._launch(i, step, h, maps, bufs))
            events[i + 1].record()
        held = not events[0].query()
        torch.cuda.synchronize()
        if held:
            return [a.elapsed_time(b) for a, b in zip(events, events[1:])]
        if cycles >= 1 << 32:
            raise SystemExit("the device spin never outlasted the host's queueing")
        cycles *= 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("yolo3_conv_times: torch finds no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}", flush=True)
    dev = torch.device("cuda", 0)
    model = yolo3_model()
    rows = model.config.layer_configs
    convs = yolo3_counts.convs(rows)
    engine = CUDAEngine(model, dev, backend="pallas", box_mode="yolo")
    frames = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (args.batch, 3, 416, 416)).astype(np.uint8)).to(dev)
    engine._net(frames)  # builds the kernels, warms the card
    times = [round_ms(engine, frames) for _ in range(args.rounds)]
    launches = []
    for i, step in enumerate(engine._plan):
        launches.append({"conv": step.conv, "kind": kind(step, convs[step.conv]),
                         "shape": convs[step.conv],
                         "ms": statistics.median(t[i] for t in times),
                         "bound_ms": yolo3_counts.conv_bound_ms(rows, step.conv, args.batch)})
    kinds: dict[str, list] = {}
    for launch in launches:
        kinds.setdefault(launch["kind"], []).append(launch)
    for name, group in sorted(kinds.items()):
        ms, bound = sum(g["ms"] for g in group), sum(g["bound_ms"] for g in group)
        print(f"{name}: {len(group)} launches, {ms:.3f} ms a round against {bound:.3f} "
              f"({100 * bound / ms:.1f}%)", flush=True)
    for route in ("layer", "stream"):
        group = [g for g in launches if (g["kind"] == "layer kernel") == (route == "layer")]
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
