"""Stage timers, EMA FPS, a torch.profiler trace context and the program's
spans and counters: the port's copy of ``tpu_cnn.utils.profiling``, and its
in-process tracing.

``StageTimer`` and ``EmaFps`` are the JAX package's, unchanged (the
reference's wall-clock stage timers and EMA FPS,
``software/realtime_detect.py:324-363,601-602``). ``torch_trace`` takes the
place of its ``jax_trace``: the same contract, with ``torch.profiler``
tracing the host and, where there is one, the CUDA device.

``span`` (``spanned`` as a decorator) and ``count`` mark the program's own
stages. They record only while a ``torch.profiler`` profile runs (the flag
``torch.autograd.profiler._is_profiler_enabled``, which
``torch.profiler.profile`` sets while it records); off, ``span`` hands back
one shared no-op object, and nothing opens a ``record_function``, reads a
clock or takes a lock. On, a span is a ``record_function`` (so it lies on
the profiler's clock beside the device's operations, as a user annotation)
timed on ``time.perf_counter_ns`` inside it; its duration and its self time
(less that of its direct child spans on the same thread) add to its name's
totals. The totals are the process's, a ``StageTimer``'s per-name totals
and counts under one lock, until ``reset_spans()``; ``spans()`` is a
snapshot. Names are ``<layer>.<what>``: ``app.frame``; ``engine.detect``,
``engine.to_device``, ``engine.net``, ``engine.to_host``, ``engine.wait``
and the counter ``engine.wait.polls``; ``head.classify``, ``head.cam``,
``head.box``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


class StageTimer:
    """Accumulating per-stage wall-clock timer."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return (self.totals[name] / n * 1e3) if n else 0.0

    def report(self) -> str:
        return " | ".join(
            f"{k}:{self.mean_ms(k):.2f}ms(x{self.counts[k]})" for k in self.totals
        )


class EmaFps:
    """Exponential-moving-average FPS (alpha matches the reference's 0.8/0.2)."""

    def __init__(self, alpha: float = 0.8):
        self.alpha = alpha
        self.value = 0.0
        self._last = None

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            fps = 1.0 / dt if dt > 0 else 0.0
            self.value = self.alpha * self.value + (1 - self.alpha) * fps
        self._last = now
        return self.value


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def torch_trace(log_dir: str | None):
    """Optional torch.profiler trace around a block (``jax_trace``'s
    counterpart): a None or empty ``log_dir`` does nothing; otherwise the
    host's and, when torch finds a CUDA device, the device's activity is
    written to ``<log_dir>/trace.json`` (Chrome trace format)."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# ── the program's spans and counters ─────────────────────────────


class _NoSpan:
    """What ``span`` hands back when nothing is tracing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    """One span while a profile runs. Its clock runs inside its own
    ``record_function``, so a span times its own work and the profiler's
    cost of entering and leaving a child span falls in the parent's self
    time."""

    __slots__ = ("name", "child_ns", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name
        self.child_ns = 0

    def __enter__(self):
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        _RECORDER.stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self._t0
        stack = _RECORDER.stack()
        stack.pop()
        self._rf.__exit__(*exc)
        if stack:
            stack[-1].child_ns += dt
        _RECORDER.add(self.name, dt, dt - self.child_ns)
        return False


class SpanRecorder(StageTimer):
    """A ``StageTimer``'s per-name totals and counts, with each name's
    self time and the counters, shared by the process's threads under one
    lock; each thread keeps its own stack of open spans."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            super().__init__()
            self.self_s: dict[str, float] = defaultdict(float)
            self.counters: dict[str, int] = defaultdict(int)

    def stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def add(self, name: str, ns: int, self_ns: int) -> None:
        with self._lock:
            self.totals[name] += ns / 1e9
            self.counts[name] += 1
            self.self_s[name] += self_ns / 1e9

    def count(self, name: str, n: int) -> None:
        with self._lock:
            self.counters[name] += n

    def snapshot(self) -> tuple[dict, dict]:
        with self._lock:
            return ({k: (self.counts[k], self.totals[k], self.self_s[k])
                     for k in self.totals}, dict(self.counters))


_RECORDER = SpanRecorder()


def span(name: str):
    """A context manager that records the block as the span ``name`` while
    a profile runs, and does nothing otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call is the span ``name`` (``span``'s form for
    a span that covers a function's body)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _autograd_profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profile runs."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDER.count(name, n)


def spans() -> tuple[dict[str, tuple[int, float, float]], dict[str, int]]:
    """A snapshot: ``{name: (count, total_s, self_s)}`` of the spans, and
    ``{name: n}`` of the counters, since the last ``reset_spans()``."""
    return _RECORDER.snapshot()


def reset_spans() -> None:
    """Clear every span's totals and every counter."""
    _RECORDER.reset()
