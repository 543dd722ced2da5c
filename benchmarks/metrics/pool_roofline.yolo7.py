"""The pooling kernel's share of its roofline in the offline job on yolov7-640: the 8 max-pool rows' least ms a round (`lib/yolo7_counts.pool_bound_ms`: each pooled map read once, every pool's map written, at 3.35 TB/s; 16.7 MB a frame) over the device ms a round of `maxpool_kernel` (`yolo7_counts.POOL_KERNEL`); none where the program has no such kernel."""

from __future__ import annotations

from benchmarks.lib import yolo7_counts
from benchmarks.lib.trace import device_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    kernel_s = device_seconds(trace, lambda n: n == yolo7_counts.POOL_KERNEL)
    if kernel_s <= 0:
        return None
    bound = yolo7_counts.pool_bound_ms(ctx["config"]["layer_configs"],
                                       int(ctx["params"]["batch"]))
    return bound / (kernel_s * 1e3 / rounds) * 100.0
