"""The offline job's whole step on lyr3-std: its share of the card's int8 peak (`lib/readers.mfu_pct`)."""

from benchmarks.lib.readers import mfu_pct as read  # noqa: F401

LAYER = "whole step"
UNIT = "%"
SOURCE = "host_clock"
MOVES = "detect_fps"
