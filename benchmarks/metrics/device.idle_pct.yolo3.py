"""The device's idle share of the profiled window in the offline job on yolov3-416 (`lib/readers.idle_pct`)."""

from benchmarks.lib.readers import idle_pct as read  # noqa: F401

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"
