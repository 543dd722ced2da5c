"""A short profiled sub-window and its reduction to numbers.

``Profiled`` wraps ``torch.profiler`` (CPU and CUDA activities, CUPTI's
trace on the card) around a block, with a ``record_function`` span,
``bench.window``, that marks the window in the profiler's own clock. Its
``reduce()`` keeps, from the events in memory (no trace file is written):

- ``window_s``: the window's length;
- ``busy_s``: the union of the device's operations (kernels and copies)
  inside the window;
- ``ops``: per device operation, its seconds and count inside the window;
- ``device_ops``: the ten operations that took most time;
  (``record_function`` spans, which the profiler also shows on the
  device's timeline, are not device operations and are left out);
- ``idle_gaps``: the device's idle time inside the window by what the host
  was doing, the innermost host event at each gap's midpoint (``(python
  between ops)`` where none was running), the ten largest sums.
"""

from __future__ import annotations

import bisect

import torch

WINDOW_SPAN = "bench.window"
# the names of the kernels that compute the conv stack, the net: the
# megakernel (``mega_cnn_kernel``, the whole lyr3-std net or a chain's
# tail) and the layer kernel (``conv_layer_kernel``, lyr4-wide's L0)
NET_KERNELS = ("mega_cnn_kernel", "conv_layer_kernel")


def short_name(name: str) -> str:
    """A device operation's name, a kernel's without its return type,
    namespace and parameter list."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    name = name.split("(", 1)[0].split("<", 1)[0]
    return name.rsplit("::", 1)[-1][:100] if "::" in name else name[:100]


def is_net(name: str) -> bool:
    return any(k in name for k in NET_KERNELS)


class Profiled:
    """``with Profiled() as p: ...`` profiles the block; then
    ``p.reduce()``."""

    def __init__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._span = None

    def __enter__(self):
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        return False

    def reduce(self) -> dict:
        return reduce_events(self._prof.events())


def reduce_events(events) -> dict:
    """The numbers of the module docstring from a profiler's events."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name == WINDOW_SPAN and e.device_type != cuda]
    if not win:
        raise RuntimeError("the profiled window's span is missing")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    dev, host = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name == WINDOW_SPAN or getattr(e, "is_user_annotation", False):
            continue  # spans, also where they show on the device's timeline
        if e.device_type == cuda:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                dev.append((a, b, short_name(e.name)))
        elif b > a:
            host.append((a, b, e.name))
    dev.sort()
    ops: dict[str, list] = {}
    for a, b, name in dev:
        t = ops.setdefault(name, [0.0, 0])
        t[0] += (b - a) / 1e6
        t[1] += 1
    busy_us, gaps, end = 0.0, [], w0
    for a, b, _ in dev:
        if a > end:
            gaps.append((end, a))
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    if w1 > end:
        gaps.append((end, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        label = _host_at(host, starts, (a + b) / 2)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    top = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy_us / 1e6,
            "ops": {k: tuple(v) for k, v in ops.items()},
            "device_ops": [[k, v[0]] for k, v in top[:10]],
            "idle_gaps": sorted(([k, v] for k, v in idle.items()),
                                key=lambda kv: -kv[1])[:10]}


def _host_at(host, starts, t: float, scan: int = 4000) -> str:
    """The innermost host event running at ``t``: of those that started by
    then and had not ended, the latest to start."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - scan), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "(python between ops)"


def device_seconds(reduced: dict, pick) -> float:
    """Seconds of the device operations whose name ``pick`` accepts."""
    return sum(s for name, (s, _) in reduced["ops"].items() if pick(name))
