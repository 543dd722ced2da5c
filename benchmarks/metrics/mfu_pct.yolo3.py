"""The offline job's whole step on yolov3-416: its share of the card's int8 peak, 2 x the graph's multiply-adds a frame (`lib/yolo3_counts`: 32.9 G; the head's few operations left out) x the untraced window's frames/s over 1,979 T op/s."""

from __future__ import annotations

from benchmarks.lib import roofline, yolo3_counts

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "detect_fps"


def read(ctx):
    fps = ctx.get("fps")
    if not fps:
        return None
    ops = 2 * yolo3_counts.macs_per_frame(ctx["config"]["layer_configs"])
    return ops * fps / roofline.PEAK_INT8_OPS * 100.0
