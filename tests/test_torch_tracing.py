"""The port's spans and counters (``tpu_cnn_torch.utils.profiling``): off,
nothing is opened, timed, locked or recorded; on, under a
``torch.profiler`` profile, nesting, self time, counters, the decorator
form and per-thread stacks come out right, a span's clock leaves out its
own profiler cost, the spans are the profiler's user annotations, and the
camera loop's frame and the multi head record the span tree their modules
document, as does a region-head detector's detect."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.realtime import detect_frame  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.utils import failguard  # noqa: E402
from tpu_cnn_torch.utils import profiling as P  # noqa: E402
from tpu_cnn_torch.utils.paths import default_artifacts  # noqa: E402

CPU = [torch.profiler.ProfilerActivity.CPU]
# the camera frame's span tree: app.frame > engine.detect > the rest
FRAME_TREE = {"app.frame": None, "engine.detect": "app.frame",
              **{k: "engine.detect" for k in (
                  "engine.to_device", "engine.net", "head.classify",
                  "head.cam", "head.box", "engine.to_host", "engine.wait")}}


@pytest.fixture(autouse=True)
def fresh():
    P.reset_spans()
    yield
    P.reset_spans()


@pytest.fixture(scope="module")
def model():
    return load_model(default_artifacts())


def _profiled():
    return torch.profiler.profile(activities=CPU)


def test_the_guard_is_the_profilers_own_flag():
    """The spans read the flag ``torch.profiler.profile`` sets: a torch
    that stops setting it fails here, not silently in the benchmark."""
    def flag():
        return torch.autograd.profiler._is_profiler_enabled

    assert not flag() and P.span("x") is P._NO_SPAN
    with _profiled():
        assert flag() and isinstance(P.span("x"), P._Span)
    assert not flag() and P.span("x") is P._NO_SPAN


def test_off_opens_no_record_function_reads_no_clock_takes_no_lock(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("touched while no profiler runs")

    class NoLock:
        __enter__ = __exit__ = refuse

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(P.time, "perf_counter_ns", refuse)
    monkeypatch.setattr(P._RECORDER, "_lock", NoLock())
    assert P.span("a") is P.span("b")
    with P.span("a"):
        with P.span("b"):
            pass
    P.count("c", 3)
    assert _double(21) == 42
    monkeypatch.undo()
    assert P.spans() == ({}, {})


@P.spanned("double")
def _double(x):
    """Twice ``x``."""
    return 2 * x


def test_nesting_self_time_and_counters():
    with _profiled():
        with P.span("outer"):
            time.sleep(0.002)
            for _ in range(2):
                with P.span("inner"):
                    time.sleep(0.003)
                    with P.span("leaf"):
                        time.sleep(0.001)
        P.count("polls")
        P.count("polls", 4)
    spans, counters = P.spans()
    assert set(spans) == {"outer", "inner", "leaf"}
    n_out, t_out, s_out = spans["outer"]
    n_in, t_in, s_in = spans["inner"]
    n_leaf, t_leaf, s_leaf = spans["leaf"]
    assert (n_out, n_in, n_leaf) == (1, 2, 2)
    assert t_leaf >= 0.002 and s_leaf == pytest.approx(t_leaf, abs=1e-12)
    assert t_in >= 0.008 and s_in == pytest.approx(t_in - t_leaf, abs=1e-9)
    assert s_in >= 0.006
    assert t_out >= 0.010 and s_out == pytest.approx(t_out - t_in, abs=1e-9)
    assert 0.002 <= s_out < t_out
    assert counters == {"polls": 5}


def test_the_decorator_spans_the_whole_call():
    """``spanned``: the call is one span, named as given, nested like a
    ``with span``; the function keeps its name and docstring, and a raise
    still closes the span."""
    @P.spanned("boom")
    def boom():
        with P.span("inside"):
            raise ValueError("no")

    assert (_double.__name__, _double.__doc__) == ("_double", "Twice ``x``.")
    with _profiled():
        with P.span("outer"):
            assert _double(3) == 6 and _double(4) == 8
        with pytest.raises(ValueError):
            boom()
        assert P._RECORDER.stack() == []
    spans, _ = P.spans()
    assert {k: v[0] for k, v in spans.items()} == {
        "outer": 1, "double": 2, "boom": 1, "inside": 1}
    _, total, own = spans["outer"]
    assert own == pytest.approx(total - spans["double"][1], abs=1e-9)


def test_a_spans_clock_leaves_out_its_own_profiler_cost(monkeypatch):
    """The clock runs inside the span's ``record_function``: a leaf times
    its own work alone, and what entering and leaving a child costs falls
    in its parent's self time."""
    cost = 0.004

    class SlowAnnotation:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            time.sleep(cost)
            return self

        def __exit__(self, *exc):
            time.sleep(cost)
            return False

    with _profiled():
        monkeypatch.setattr(torch.profiler, "record_function", SlowAnnotation)
        with P.span("parent"):
            with P.span("leaf"):
                pass
        monkeypatch.undo()
    spans, _ = P.spans()
    assert spans["leaf"][1] < cost
    _, total, own = spans["parent"]
    assert own >= 2 * cost and total >= 2 * cost
    assert own == pytest.approx(total - spans["leaf"][1], abs=1e-9)


def test_each_thread_keeps_its_own_stack():
    """A span open on another thread is no parent of this thread's spans:
    the batcher's worker and collector run at once."""
    opened, closed = threading.Event(), threading.Event()

    def other():
        with P.span("t.outer"):
            opened.set()
            closed.wait(10)
            with P.span("t.inner"):
                time.sleep(0.002)

    with _profiled():
        t = threading.Thread(target=other)
        t.start()
        assert opened.wait(10)
        with P.span("m.outer"):
            with P.span("m.inner"):
                time.sleep(0.002)
        closed.set()
        t.join(10)
        assert not t.is_alive()
    spans, _ = P.spans()
    assert {k: v[0] for k, v in spans.items()} == {
        "t.outer": 1, "t.inner": 1, "m.outer": 1, "m.inner": 1}
    for side in ("t", "m"):
        _, total, own = spans[f"{side}.outer"]
        assert own == pytest.approx(total - spans[f"{side}.inner"][1], abs=1e-9)


def test_spans_are_user_annotations_inside_the_profiled_block():
    with _profiled() as prof:
        with torch.profiler.record_function("block"):
            with P.span("app.frame"):
                with P.span("engine.net"):
                    torch.ones(8, 8) @ torch.ones(8, 8)
    events = prof.events()
    block = next(e for e in events if e.name == "block")
    mine = [e for e in events if e.name in ("app.frame", "engine.net")]
    assert sorted(e.name for e in mine) == ["app.frame", "engine.net"]
    for e in mine:
        assert getattr(e, "is_user_annotation", False), e.name
        assert block.time_range.start <= e.time_range.start
        assert e.time_range.end <= block.time_range.end
    frame = next(e for e in mine if e.name == "app.frame")
    net = next(e for e in mine if e.name == "engine.net")
    assert frame.time_range.start <= net.time_range.start
    assert net.time_range.end <= frame.time_range.end


def test_a_camera_frame_records_the_documented_tree(model):
    """One fused ``detect_frame`` on a CPU ``CUDAEngine``: every span of the
    frame once, each parent's total its self time plus its children's, so
    the benchmark's four host metrics add up to the frame."""
    engine = CUDAEngine(model, "cpu", backend="mega")
    frame = np.random.RandomState(0).randint(0, 256, (128, 128)).astype(np.uint8)
    want = detect_frame(engine, model, frame, fused=True)
    assert P.spans() == ({}, {}), "nothing is recorded with no profiler"
    with _profiled():
        got = detect_frame(engine, model, frame, fused=True)
    assert (got.idx, got.bbox) == (want.idx, want.bbox)
    spans, counters = P.spans()
    assert {k: v[0] for k, v in spans.items()} == dict.fromkeys(FRAME_TREE, 1)
    assert counters == {}, "the CPU engine waits on no event"
    for parent in ("app.frame", "engine.detect"):
        kids = [k for k, p in FRAME_TREE.items() if p == parent]
        _, total, own = spans[parent]
        assert own >= 0
        assert total == pytest.approx(own + sum(spans[k][1] for k in kids),
                                      abs=1e-9)
    engine_own = sum(spans[k][2] for k in ("engine.detect", "engine.to_device",
                                           "engine.net", "engine.to_host"))
    head = sum(spans[k][1] for k in ("head.classify", "head.cam", "head.box"))
    assert spans["app.frame"][1] == pytest.approx(
        spans["app.frame"][2] + engine_own + head + spans["engine.wait"][1],
        abs=1e-9)


def test_the_regression_box_is_a_head_box_span(model):
    """``box_mode="reg"``: ``bbox_regress`` under ``head.box``, no CAM."""
    engine = CUDAEngine(model, "cpu", backend="mega", box_mode="reg")
    with _profiled():
        engine.detect_batch(np.zeros((2, 128, 128), np.uint8))
    spans, _ = P.spans()
    assert "head.cam" not in spans
    assert spans["head.box"][0] == spans["head.classify"][0] == 1


def test_the_multi_heads_spans_go_through_the_guard(model, monkeypatch):
    """The instance head's four spans keep their names (``chip_smoke.py``
    reads them) and open nothing when no profiler runs."""
    engine = CUDAEngine(model, "cpu", backend="mega")
    images = np.random.RandomState(1).randint(0, 256, (2, 128, 128)).astype(np.uint8)
    names = {"multi_cam_stack", "connected_labels", "grow_labels",
             "component_stats"}

    def refuse(*_a, **_k):
        raise AssertionError("record_function opened with no profiler")

    with monkeypatch.context() as m:
        m.setattr(torch.profiler, "record_function", refuse)
        want = engine.detect_multi_batch(images, instances=2)
    with _profiled() as prof:
        got = engine.detect_multi_batch(images, instances=2)
    np.testing.assert_array_equal(got.inst_boxes, want.inst_boxes)
    spans, _ = P.spans()
    assert names <= set(spans) and spans["engine.detect"][0] == 1
    annotated = {e.name for e in prof.events()
                 if getattr(e, "is_user_annotation", False)}
    assert names <= annotated


def test_wait_event_counts_each_poll():
    class Event:
        def __init__(self, pending):
            self.pending = pending

        def query(self):
            self.pending -= 1
            return self.pending < 0

    failguard.wait_event(Event(2), 5.0)
    assert P.spans() == ({}, {})
    with _profiled():
        failguard.wait_event(Event(2), 5.0)
        failguard.wait_event(Event(0), 5.0)
    assert P.spans()[1] == {"engine.wait.polls": 4}


def test_a_region_detect_records_the_stream_and_head_spans():
    """A CPU detect of the tiny region-head net (``test_torch_yolov2``):
    ``engine.net`` holds ``net.stream`` (the streamed layers), the head is
    ``head.region``, and ``head.region.frames`` counts the batch."""
    from test_torch_yolov2 import _frames, tiny_model

    engine = CUDAEngine(tiny_model(), "cpu", backend="pallas", box_mode="region")
    with _profiled():
        engine.detect_batch(_frames(3))
    spans, counters = P.spans()
    for name in ("engine.detect", "engine.net", "net.stream", "head.region"):
        assert spans[name][0] == 1, name
    assert counters["head.region.frames"] == 3
    assert spans["net.stream"][1] <= spans["engine.net"][1]
    assert spans["engine.net"][2] > 0  # the layer kernel's layers: its own time
