"""What the per-layer metrics of the program's own spans and counters read,
one function each (the camera loop's host time by layer).

The program (``tpu_cnn_torch.utils.profiling``) records its spans and
counters while a ``torch.profiler`` profile runs, so in a ``--trace 1``
run they are the profiled window's: ``spans()`` gives ``{name: (count,
total_s, self_s)}`` and the counters. Each reader divides by
``ctx["trace_frames"]``, the frames completed in that window, and returns
None where there is nothing to read: no profiled window, a program that
records no spans (one older than them), or no ``app.frame`` span.

The spans of a camera frame nest as ``app.frame`` > ``engine.detect`` >
``engine.to_device``, ``engine.net``, ``head.classify``, ``head.cam``,
``head.box``, ``engine.to_host``, ``engine.wait``; so ``app_host_ms``,
``engine_host_ms``, ``head_host_ms`` and ``engine_wait_ms`` add up to
``app.frame``'s total per frame.
"""

from __future__ import annotations

ENGINE_OWN = ("engine.detect", "engine.to_device", "engine.net",
              "engine.to_host")
HEAD = ("head.classify", "head.cam", "head.box")


def snapshot():
    """The program's spans and counters, or None where it records none."""
    try:
        from tpu_cnn_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans()


def _per_frame(ctx):
    """(spans, counters, frames) of the profiled window, or None."""
    frames = ctx.get("trace_frames")
    if not frames:
        return None
    snap = snapshot()
    if snap is None or "app.frame" not in snap[0]:
        return None
    return snap[0], snap[1], frames


def _ms(spans, names, field, frames) -> float:
    """Seconds of ``field`` (1 total, 2 self) of the spans ``names``, in ms
    per frame."""
    return sum(spans[n][field] for n in names if n in spans) * 1e3 / frames


def app_host_ms(ctx):
    """The app's own host ms per frame: ``app.frame``'s self time."""
    got = _per_frame(ctx)
    return None if got is None else _ms(got[0], ("app.frame",), 2, got[2])


def engine_host_ms(ctx):
    """The engine's own host ms per frame: the self times of
    ``engine.detect``, ``engine.to_device``, ``engine.net`` and
    ``engine.to_host``."""
    got = _per_frame(ctx)
    return None if got is None else _ms(got[0], ENGINE_OWN, 2, got[2])


def head_host_ms(ctx):
    """The head's host ms per frame: the totals of ``head.classify``,
    ``head.cam`` and ``head.box``."""
    got = _per_frame(ctx)
    return None if got is None else _ms(got[0], HEAD, 1, got[2])


def engine_wait_ms(ctx):
    """Ms per frame waiting for the results' event: ``engine.wait``."""
    got = _per_frame(ctx)
    return None if got is None else _ms(got[0], ("engine.wait",), 1, got[2])


def engine_wait_polls(ctx):
    """The event's polls per frame: the counter ``engine.wait.polls``."""
    got = _per_frame(ctx)
    return None if got is None else got[1].get("engine.wait.polls", 0) / got[2]
