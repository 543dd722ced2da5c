"""The comparison's control readings: the reference put in the program's
place at a lower precision than the configuration states, on a cell's own
distinct frames at its own size.

    python3 -m benchmarks.control --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed it draws the frames the cell's run would answer, computes
the float64 reference once and two controls, and prints one JSON line per
seed and control with the comparison's numbers (``lib/check``):

- ``int4``: the convolutions with the int8 weights rounded to int4 (on the
  int8 scale, ``round(w / 16) * 16`` clipped to -128..112), the step below
  int8;
- ``bf16_head``: the head (bins, classifier, CAM) rounded to bfloat16,
  the step below its float32.

Each control's answers are the argmax class, its probability and its box.
A limit in a cell file lies below the smallest reading of the controls
for one of its numbers (``PERF.md`` gives the readings). The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from benchmarks.lib import check, spec
from benchmarks.reference.cnn import Reference

CONTROLS = {"int4": {"weight_bits": 4}, "bf16_head": {"head": "bfloat16"}}


def readings(cell: spec.Cell, seed: int, dev: torch.device) -> dict:
    """{control: numbers} on the cell's frames of ``seed``."""
    frames = torch.from_numpy(spec.driver(cell.driver).frames_of(cell, seed))
    block = int(cell.params["reference_block"])
    probs, boxes = Reference(cell.config, spec.ROOT, dev).detect(frames, block)
    out = {}
    for name, kw in CONTROLS.items():
        cp, cb = Reference(cell.config, spec.ROOT, dev, **kw).detect(frames, block)
        out[name] = check.numbers(probs, boxes, np.arange(len(frames)),
                                  *check.control_answers(cp, cb))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    dev = torch.device(args.device)
    for seed in args.seeds:
        for name, found in readings(cell, seed, dev).items():
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "control": name, **found}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
