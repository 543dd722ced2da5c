"""Share of the camera loop's frames the fused CAM head served: 100 x the counter head.fused.frames over the profiled window's frames."""

from __future__ import annotations

import importlib.util

from benchmarks.lib import spans

LAYER = "head"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "frame_p95_ms"


def _has_fused_head() -> bool:
    """Whether the program has the fused head (``ops.cam_head``): one
    without it has nothing for this metric to read."""
    try:
        return importlib.util.find_spec("tpu_cnn_torch.ops.cam_head") is not None
    except ImportError:
        return False


def read(ctx):
    frames = ctx.get("trace_frames")
    if not frames:
        return None
    snap = spans.snapshot()
    if snap is None or "app.frame" not in snap[0] or not _has_fused_head():
        return None
    return 100.0 * snap[1].get("head.fused.frames", 0) / frames
