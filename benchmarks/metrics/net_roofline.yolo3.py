"""The conv graph's share of its roofline in the offline job on yolov3-416: its least ms a round (`lib/yolo3_counts.stack_bound_ms`: 32.9 G MACs a frame at 989.5 T MAC/s against the frames in, the weights and the heads' int32 sums out) over the device ms a round of the net's kernels (`yolo3_counts.NET_KERNELS`)."""

from __future__ import annotations

from benchmarks.lib import yolo3_counts
from benchmarks.lib.trace import device_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    net_s = device_seconds(trace, lambda n: n in yolo3_counts.NET_KERNELS)
    if net_s <= 0:
        return None
    bound = yolo3_counts.stack_bound_ms(ctx["config"]["layer_configs"],
                                        int(ctx["params"]["batch"]))
    return bound / (net_s * 1e3 / rounds) * 100.0
