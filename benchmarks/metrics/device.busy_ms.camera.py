"""Device ms per frame in the camera loop's profiled window (`lib/readers.busy_ms_per_frame`)."""

from benchmarks.lib.readers import busy_ms_per_frame as read  # noqa: F401

LAYER = "device"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "frame_p95_ms"
