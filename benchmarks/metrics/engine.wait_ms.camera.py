"""Ms per frame waiting for the results' event in the camera loop: engine.wait (`lib/spans.engine_wait_ms`)."""

from benchmarks.lib.spans import engine_wait_ms as read  # noqa: F401

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_p95_ms"
