"""One run of one cell of ``BENCHMARK.json``.

    python3 -m benchmarks.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration, traffic and driver (``lib/spec``), sets
up the program (``tpu_cnn_torch``) and the traffic from ``--seed``,
measures for ``--seconds``, and prints one JSON object as the last line
of standard output: ``correct``, ``attempted``, ``failed``, ``metrics``
(with ``--trace 0`` the cell's end-to-end metrics; with ``--trace 1`` its
per-layer metrics, from a profiled sub-window after the window),
``device`` (with ``--trace 1`` also ``busy_s`` and ``window_s`` of the
profiled window), with ``--trace 1`` ``breakdown``, ``setup_built`` (the
libraries this run built into the program's kernel cache: a checkout's
first run, whose ``setup_s`` holds the build, names them; a warm run's
is empty), and last ``checks``: each number of the comparison that
decides ``correct`` (``compare`` of the reference module the cell's
configuration names, ``reference/<name>.py``) beside its limit, which
also end standard error. The
card's name and power limit, and the set-up's phases, go to earlier
lines of standard error.

It exits with code 2 and prints no result when torch finds no CUDA device
or fewer than the cell asks for, and with code 3 when a module of JAX or
of the JAX package is loaded in its process once the window has closed
and the reference module has compared.
Nothing falls back to the CPU: ``run_cell`` takes the device as a
parameter only for the tests, which drive it on the CPU at small sizes.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmarks.lib import check
from benchmarks.lib import device as devinfo
from benchmarks.lib import spec


def per_layer(cell: spec.Cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for."""
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             dev: torch.device) -> dict:
    """One run -> the result line as a dict (``checks`` last), or a dict
    with ``forbidden`` when a forbidden module was loaded by the time the
    comparison has finished. A seeded bundle is written first, in
    set-up."""
    cached = devinfo.cached_libraries()
    spec.make_bundle(cell.config)
    outcome = spec.driver(cell.driver).run(cell, seed, seconds, trace, dev)
    built = sorted(devinfo.cached_libraries() - cached)
    if built:
        devinfo.log(f"setup: this run built {built} into the kernel cache: its "
                    f"setup_s is a first run's, with the build")
    if trace:
        metrics = per_layer(cell, outcome.ctx)
    else:
        metrics = {m["name"]: {"value": float(outcome.measured[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": outcome.kind, "count": outcome.count,
              "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device, "setup_built": built}
    if trace and outcome.trace is not None:
        device.update(busy_s=outcome.trace["busy_s"],
                      window_s=outcome.trace["window_s"])
        line["breakdown"] = {"device_ops": outcome.trace["device_ops"],
                             "idle_gaps": outcome.trace["idle_gaps"]}
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    found = spec.reference(cell.reference).compare(cell, outcome, dev)
    forbidden = devinfo.forbidden_loaded()  # the window, then the reference
    if forbidden:
        return {"forbidden": forbidden}
    correct, checks = check.judge(found, cell.limits)
    return {"correct": correct, **line, "checks": checks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    devinfo.mark("python and imports")
    cell = spec.cell(args.workload)
    devinfo.use_kernel_cache()
    devinfo.log(f"card: {devinfo.card_line()}")
    devinfo.mark("nvidia-smi")
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        devinfo.log(f"no result: the cell needs {chips} CUDA device(s), torch "
                    f"finds {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    devinfo.mark("cuda check")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    if "forbidden" in result:
        devinfo.log(f"no result: modules of JAX or the JAX package were loaded: "
                    f"{result['forbidden']}")
        return 3
    check.print_checks(result["checks"])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
