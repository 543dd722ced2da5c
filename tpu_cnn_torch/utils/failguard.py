"""Bounded waits on the device — the port of ``tpu_cnn.utils.failguard``.

The reference polls a done bit with a timeout and reports where it stuck
(``software/pynq_inference.py:236-251``). Here the done bit is a recorded
``torch.cuda.Event``: poll ``query()`` until a deadline, then raise with
the device's name and what it was doing, instead of hanging a service.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


class DeviceTimeout(TimeoutError):
    """Device work failed to complete within the deadline."""


def wait_event(event: torch.cuda.Event, timeout_s: float | None,
               diagnostics: Callable[[], str] | None = None) -> None:
    """Return once ``event`` has completed; raise :class:`DeviceTimeout`
    after ``timeout_s`` seconds (``None`` waits without a deadline).
    The poll interval doubles from 50 us up to 1 ms."""
    if timeout_s is None:
        event.synchronize()
        return
    deadline = time.monotonic() + timeout_s
    poll_s = 50e-6
    while not event.query():
        if time.monotonic() > deadline:
            try:
                info = f"device={torch.cuda.get_device_name()}"
            except RuntimeError:
                info = "device info unavailable"
            extra = f" | {diagnostics()}" if diagnostics else ""
            raise DeviceTimeout(
                f"device work not done after {timeout_s}s ({info}{extra})")
        time.sleep(poll_s)
        poll_s = min(2 * poll_s, 1e-3)
