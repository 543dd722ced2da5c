"""Bounded waits on the device and the progress watchdog — the port of
``tpu_cnn.utils.failguard``.

The reference polls a done bit with a timeout and reports where it stuck
(``software/pynq_inference.py:236-251``). Here the done bit is a recorded
``torch.cuda.Event``: poll ``query()`` until a deadline, then raise with
the device's name and what it was doing, instead of hanging a service.
``Watchdog`` (pure ``threading``) is a copy of the JAX package's: a
callback fires when no progress lands within ``stall_s``.
"""

from __future__ import annotations

import threading
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


class Watchdog:
    """Progress watchdog: call :meth:`kick` on progress; a monitor callback
    fires if no progress lands within ``stall_s`` (camera-reset analogue)."""

    def __init__(self, stall_s: float, on_stall: Callable[[], None]):
        self.stall_s = stall_s
        self.on_stall = on_stall
        self._timer: threading.Timer | None = None
        self._lock = threading.Lock()
        self._stopped = False

    def kick(self) -> None:
        with self._lock:
            if self._stopped:
                return
            if self._timer is not None:
                self._timer.cancel()
            self._timer = threading.Timer(self.stall_s, self.on_stall)
            self._timer.daemon = True
            self._timer.start()

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            if self._timer is not None:
                self._timer.cancel()
