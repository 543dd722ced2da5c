"""The conv stack's share of its roofline in the offline job on lyr3-std (`lib/readers.net_roofline_pct`)."""

from benchmarks.lib.readers import net_roofline_pct as read  # noqa: F401

LAYER = "kernels"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "detect_fps"
