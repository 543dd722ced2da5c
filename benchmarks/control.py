"""The comparison's control readings: the reference put in the program's
place at a lower precision than the configuration states, on a cell's own
distinct frames at its own size.

    python3 -m benchmarks.control --workload <cell> --seeds 1 2 3 [--device cuda]

For each seed it draws the frames the cell's run would answer (its
driver's ``frames_of``) and prints one JSON line per seed and control with
the comparison's numbers: ``controls`` of the reference module the cell's
configuration names (``reference/<name>.py``; ``reference/cnn.py`` says
which controls it computes). A limit in a cell file lies below the
smallest reading of the controls for one of its numbers (``PERF.md``
gives the readings). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmarks.lib import spec


def readings(cell: spec.Cell, seed: int, dev: torch.device) -> dict:
    """{control: numbers} on the cell's frames of ``seed``."""
    spec.make_bundle(cell.config)
    frames = spec.driver(cell.driver).frames_of(cell, seed)
    return spec.reference(cell.reference).controls(cell, frames, dev)


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
