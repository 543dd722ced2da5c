"""Stage timers, EMA FPS and a torch.profiler trace context: the port's copy
of ``tpu_cnn.utils.profiling``.

``StageTimer`` and ``EmaFps`` are the JAX package's, unchanged (the
reference's wall-clock stage timers and EMA FPS,
``software/realtime_detect.py:324-363,601-602``). ``torch_trace`` takes the
place of its ``jax_trace``: the same contract, with ``torch.profiler``
tracing the host and, where there is one, the CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


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
