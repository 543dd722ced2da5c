"""Host ms per frame in the camera loop's own code, app.frame's self time (`lib/spans.app_host_ms`)."""

from benchmarks.lib.spans import app_host_ms as read  # noqa: F401

LAYER = "app"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_p95_ms"
