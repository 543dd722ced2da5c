"""Device ms per batch of the head, its casts and copies in the offline job on lyr4-wide (`lib/readers.head_device_ms`)."""

from benchmarks.lib.readers import head_device_ms as read  # noqa: F401

LAYER = "head"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "detect_fps.wide"
