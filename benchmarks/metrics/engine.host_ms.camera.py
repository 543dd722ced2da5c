"""Host ms per frame in the engine's own code: the self times of engine.detect, engine.to_device, engine.net and engine.to_host (`lib/spans.engine_host_ms`)."""

from benchmarks.lib.spans import engine_host_ms as read  # noqa: F401

LAYER = "engine"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_p95_ms"
