"""The readers of the program's spans and counters (``lib/spans.py``): the
arithmetic on a synthetic snapshot, None with nothing to read, and the
program's own recorder read through them."""

from __future__ import annotations

import pytest
import torch

from benchmarks.lib import spans, spec

METRICS = {"app.host_ms.camera": 0.05, "engine.host_ms.camera": 0.4,
           "head.host_ms.camera": 1.0, "engine.wait_ms.camera": 0.3,
           "engine.wait_polls.camera": 2.5}
# 4 frames; ms per frame in the comments
SNAPSHOT = ({
    "app.frame": (4, 0.0070, 0.0002),         # self 0.05
    "engine.detect": (4, 0.0068, 0.0004),     # self 0.1
    "engine.to_device": (4, 0.0002, 0.0002),  # 0.05
    "engine.net": (4, 0.0006, 0.0006),        # 0.15
    "head.classify": (4, 0.0012, 0.0012),     # 0.3
    "head.cam": (4, 0.0016, 0.0016),          # 0.4
    "head.box": (4, 0.0012, 0.0012),          # 0.3
    "engine.to_host": (4, 0.0004, 0.0004),    # 0.1
    "engine.wait": (4, 0.0012, 0.0012),       # 0.3
    "other.span": (9, 1.0, 1.0),              # not the camera's
}, {"engine.wait.polls": 10, "other.counter": 3})


def _read(name, ctx):
    return spec.reader(name).read(ctx)


@pytest.mark.parametrize("name", sorted(METRICS))
def test_readers_on_a_synthetic_snapshot(name, monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    assert _read(name, {"trace_frames": 4}) == pytest.approx(METRICS[name])


def test_the_four_host_metrics_add_up_to_the_frame(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAPSHOT)
    ctx = {"trace_frames": 4}
    parts = sum(_read(n, ctx) for n in METRICS if n.endswith("_ms.camera"))
    assert parts == pytest.approx(SNAPSHOT[0]["app.frame"][1] * 1e3 / 4)


@pytest.mark.parametrize("name", sorted(METRICS))
@pytest.mark.parametrize("case", ["no window", "no frames", "older program",
                                  "no frame span"])
def test_readers_with_nothing_to_read(name, case, monkeypatch):
    snap = {"older program": None,
            "no frame span": ({"engine.net": (1, 1.0, 1.0)}, {})}.get(case, SNAPSHOT)
    monkeypatch.setattr(spans, "snapshot", lambda: snap)
    ctx = {"no window": {}, "no frames": {"trace_frames": 0}}.get(
        case, {"trace_frames": 4})
    assert _read(name, ctx) is None


def test_a_program_without_spans_reads_as_none(monkeypatch):
    """A program older than its spans (no ``spans`` in its profiling
    module): the import fails, and the readers read nothing."""
    import tpu_cnn_torch.utils.profiling as program

    monkeypatch.delattr(program, "spans")
    assert spans.snapshot() is None
    assert _read("app.host_ms.camera", {"trace_frames": 4}) is None


def test_the_programs_recorder_through_the_readers():
    from tpu_cnn_torch.utils import profiling as program

    program.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(3):
                with program.span("app.frame"):
                    with program.span("engine.detect"):
                        with program.span("head.cam"):
                            pass
                        with program.span("engine.wait"):
                            program.count("engine.wait.polls", 2)
        ctx = {"trace_frames": 3}
        frame_ms = program.spans()[0]["app.frame"][1] * 1e3 / 3
        parts = sum(_read(n, ctx) for n in METRICS if n.endswith("_ms.camera"))
        assert parts == pytest.approx(frame_ms, rel=1e-9)
        assert _read("engine.wait_polls.camera", ctx) == 2
    finally:
        program.reset_spans()
