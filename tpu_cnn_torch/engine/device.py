"""The device layer of the port's engines: ``DeviceEngine``, the base of
``engine.cuda.CUDAEngine`` (the FpgaCNN family, CAM heads) and of
``engine.region.RegionEngine`` (the region-head detectors).

The device is explicit: ``"cuda"`` runs the kernels and raises when there
is no card; ``"cpu"`` runs their plain versions (for tests on machines
without a card). Nothing picks a device on its own. All of the work runs
on the device; only the head's outputs come back to the host, through
pinned buffers and a recorded event.

While a ``torch.profiler`` profile runs, the engine's stages are spans
(``utils.profiling.span``): ``engine.detect`` around ``detect_batch``, and
inside it ``engine.to_device`` (the H2D), the subclass's ``engine.net``
and ``head.*``, ``engine.to_host`` (pinned buffers, copies, event) and
``engine.wait`` (the wait for that event).

The serving protocol (``detect_batch_async`` / ``detect_resolve``)
matches ``tpu_cnn.engine.tpu.TPUEngine``'s, so the port's copy of
``DynamicBatcher`` (``apps.serve``) drives these engines as the JAX one
drives that engine.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_cnn_torch.ops import quant
from tpu_cnn_torch.utils.failguard import wait_event
from tpu_cnn_torch.utils.profiling import span, spanned


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch finds no CUDA device")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is on: the head's "
                "f32 matmuls would run in TF32 and drift from the "
                "reference; switch it off")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class DeviceEngine:
    """Frames to the device, results to the host; nothing here depends on
    the model. A subclass sets ``device``, ``model``, ``net`` (its
    ``shifts`` the device shift vector), ``max_batch``, ``timeout_s``,
    ``backend`` and ``_frame`` (one frame's shape), names its result type
    ``_result`` and supplies ``detect_device``."""

    @spanned("engine.to_device")
    def _to_device(self, images):
        """Raw u8 frames of ``_frame`` (or flat) or a stage_batch handle ->
        (device tensor, B)."""
        if isinstance(images, tuple) and len(images) == 3 and images[0] == "staged":
            return images[1], images[2]
        arr = np.ascontiguousarray(images, dtype=np.uint8).reshape(-1, *self._frame)
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"batch {arr.shape[0]} exceeds max_batch {self.max_batch}")
        return torch.from_numpy(arr).to(self.device), arr.shape[0]

    def _sync(self) -> None:
        """Bounded wait for the work queued so far on the device."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            wait_event(event, self.timeout_s,
                       diagnostics=lambda: f"backend={self.backend}")

    @spanned("engine.to_host")
    def _to_host_async(self, tensors):
        """Start device->host copies into pinned buffers and record an
        event; the handle resolves with :meth:`_fetch`."""
        if self.device.type == "cpu":
            return tuple(tensors), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _fetch(self, handle) -> tuple[np.ndarray, ...]:
        """Bounded wait for a :meth:`_to_host_async` handle -> numpy."""
        host, event = handle
        with span("engine.wait"):
            if event is not None:
                wait_event(event, self.timeout_s,
                           diagnostics=lambda: f"backend={self.backend}")
        return tuple(h.numpy() for h in host)

    # ── public API ────────────────────────────────────────────────────

    def warmup(self, batch: int = 1) -> None:
        """Run the fused detect once at ``batch`` (on CUDA this also builds
        and loads the kernels)."""
        self.detect_batch(np.zeros((batch, *self._frame), np.uint8))

    def set_shifts(self, *shifts: int) -> None:
        """Runtime shift update — register semantics: an in-stream copy
        into the device shift vector the kernel reads. Work already
        dispatched keeps the old shifts; nothing is rebuilt and the host
        does not wait. Each shift must lie in 0..31."""
        if len(shifts) != len(self.model.shifts):
            raise ValueError("one shift per layer required")
        quant.check_shifts(shifts)
        self.model.shifts = np.asarray(shifts, np.int32)
        src = torch.from_numpy(self.model.shifts)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self.net.shifts.copy_(src, non_blocking=True)

    @spanned("engine.detect")
    def detect_batch(self, images):
        """Fused detect: only the head's outputs return to the host."""
        return self.detect_resolve(self.detect_batch_async(images))

    def stage_batch(self, images: np.ndarray) -> tuple:
        """Copy a batch to the device ahead of time; pass the handle to
        :meth:`detect_batch_async` to drive device throughput alone."""
        x, b = self._to_device(images)
        self._sync()
        return ("staged", x, b)

    def detect_batch_async(self, images):
        """Dispatch a fused detect without waiting; returns a handle for
        :meth:`detect_resolve`. Several handles may be in flight. Takes raw
        u8 frames or a :meth:`stage_batch` handle."""
        x, _ = self._to_device(images)
        return self._to_host_async(self.detect_device(x)[2:])

    def detect_resolve(self, handle):
        return self._result(*self._fetch(handle))
