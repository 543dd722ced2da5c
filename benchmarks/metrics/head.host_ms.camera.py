"""Host ms per frame dispatching the head: head.classify, head.cam and head.box (`lib/spans.head_host_ms`)."""

from benchmarks.lib.spans import head_host_ms as read  # noqa: F401

LAYER = "head"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_p95_ms"
