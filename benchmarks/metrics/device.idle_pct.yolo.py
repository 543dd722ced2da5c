"""The device's idle share of the profiled window in the offline job on yolov2-tiny-voc (`lib/readers.idle_pct`)."""

from benchmarks.lib.readers import idle_pct as read  # noqa: F401

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"
