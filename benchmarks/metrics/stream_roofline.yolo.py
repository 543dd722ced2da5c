"""The weight-streaming kernel's share of its roofline in the offline job on yolov2-tiny-voc: the streamed layers' least ms a round (`lib/yolo_counts.stream_bound_ms`, L4-L8) over the device ms a round of `conv_stream_kernel`; none where the program has no such kernel."""

from __future__ import annotations

from benchmarks.lib import yolo_counts
from benchmarks.lib.trace import device_seconds

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"


def read(ctx):
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    stream_s = device_seconds(trace, lambda n: n == yolo_counts.STREAM_KERNEL)
    if stream_s <= 0:
        return None
    bound = yolo_counts.stream_bound_ms(ctx["config"]["layer_configs"],
                                        int(ctx["params"]["batch"]))
    return bound / (stream_s * 1e3 / rounds) * 100.0
