"""Max-pool rows pooled on the device path per frame in the offline job on yolov7-640: the program's counter net.pool.maps (one per frame per pool row a launch of the pooling kernel wrote) over the frames of the profiled window's rounds; 8 where every pool ran; none where the program records no such counter."""

from __future__ import annotations

from benchmarks.lib import spans

LAYER = "kernels"
UNIT = "maps/frame"
SOURCE = "program_counter"
MOVES = "detect_fps"


def read(ctx):
    rounds = ctx.get("trace_rounds")
    if not rounds:
        return None
    snap = spans.snapshot()
    if snap is None or "net.pool.maps" not in snap[1]:
        return None
    return snap[1]["net.pool.maps"] / (rounds * int(ctx["params"]["batch"]))
