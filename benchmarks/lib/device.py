"""What a run says about the process and the card it ran on."""

from __future__ import annotations

import os
import subprocess
import sys
import time

from benchmarks.lib import spec

# the program's kernel cache (``tpu_cnn_torch/ops/_build``): a fixed
# directory inside the checkout, handed to the program, so that only a
# checkout's first run of a cell builds
KERNEL_CACHE = os.path.join(spec.ROOT, "build", "tpu_cnn_torch")

# top-level module names that may not be loaded in a measured process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tpu_cnn")


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among the loaded modules, each module
    name compared by its part before the first dot, whole."""
    names = sys.modules if modules is None else modules
    tops = {name.split(".", 1)[0] for name in names}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


def process_age_s() -> float:
    """Seconds since this process was started, from ``/proc/self/stat``
    (10 ms ticks) against the boot-time clock; where that is unreadable,
    since ``time.perf_counter``'s first use here."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])  # field 22: starttime
        hz = os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / hz
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T0


_T0 = time.perf_counter()


def use_kernel_cache() -> None:
    """Hands the program (and any child process) ``KERNEL_CACHE``."""
    os.environ["TPU_CNN_TORCH_BUILD_DIR"] = KERNEL_CACHE


def cached_libraries() -> set[str]:
    """The libraries in the program's kernel cache."""
    try:
        return {f for f in os.listdir(KERNEL_CACHE) if f.endswith(".so")}
    except OSError:
        return set()


_MARKS: list[tuple[str, float]] = []


def mark(phase: str) -> None:
    """Ends the set-up phase ``phase``, at this many seconds since the
    process started."""
    _MARKS.append((phase, process_age_s()))


def setup_line() -> str:
    """The seconds of each set-up phase marked so far (and forgets them)."""
    parts, last = [], 0.0
    for phase, t in _MARKS:
        parts.append(f"{phase} {t - last!r} s")
        last = t
    _MARKS.clear()
    return "setup: " + ", ".join(parts)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
