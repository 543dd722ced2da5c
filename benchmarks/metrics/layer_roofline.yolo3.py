"""The layer kernel's share of its roofline in the offline job on yolov3-416: the 7 convs of fewer than 128 input channels' (not linear) least ms a round (`lib/yolo3_counts.layer_bound_ms`: each conv's multiply-adds against its maps in and out, its shortcut's map and its weights, summed) over the device ms a round of `conv_layer_kernel` (`yolo3_counts.LAYER_KERNEL`); none where the program has no such kernel."""

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
    kernel_s = device_seconds(trace, lambda n: n == yolo3_counts.LAYER_KERNEL)
    if kernel_s <= 0:
        return None
    bound = yolo3_counts.layer_bound_ms(ctx["config"]["layer_configs"],
                                        int(ctx["params"]["batch"]))
    return bound / (kernel_s * 1e3 / rounds) * 100.0
