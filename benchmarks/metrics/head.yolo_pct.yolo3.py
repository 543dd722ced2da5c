"""Share of the offline job's frames on yolov3-416 that the [yolo] head served: 100 x the program's counter head.yolo.frames over the frames of the profiled window's rounds; none where the program records no such counter."""

from __future__ import annotations

from benchmarks.lib import spans

LAYER = "head"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "detect_fps"


def read(ctx):
    rounds = ctx.get("trace_rounds")
    if not rounds:
        return None
    snap = spans.snapshot()
    if snap is None or "head.yolo.frames" not in snap[1]:
        return None
    return 100.0 * snap[1]["head.yolo.frames"] / (rounds * int(ctx["params"]["batch"]))
