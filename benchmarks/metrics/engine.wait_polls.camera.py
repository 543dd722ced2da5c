"""The results' event polled per frame in the camera loop: engine.wait.polls (`lib/spans.engine_wait_polls`)."""

from benchmarks.lib.spans import engine_wait_polls as read  # noqa: F401

LAYER = "engine"
UNIT = "polls"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"
