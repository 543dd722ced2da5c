"""The camera loop: one stream detecting frame by frame, a closed loop.

Set-up draws a pool of ``pool`` preprocessed u8 frames from the seed,
builds ``CUDAEngine`` and runs ``warm_frames`` frames through the loop's
detect. The window then runs the camera loop's per-frame detect
(``apps.realtime.detect_frame(..., fused=True)``: ``detect_batch`` of one
frame, the head's outputs read back) on the pool's frames in turn, each as
soon as the last has returned. ``frame_p95_ms`` is the 95th percentile of
the per-frame wall time over every frame of the window. Each frame's
answer is the class, its probability, the probabilities and the box, in
that order.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmarks.lib import device as devinfo
from benchmarks.lib import program, spec, stats, traffic
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.lib.trace import Profiled


def frames_of(cell, seed: int) -> np.ndarray:
    """The camera's pool of preprocessed frames, as ``spec.frame_shape``
    says."""
    channels, size, _ = spec.frame_shape(cell.config)
    return traffic.frames(seed, "camera", int(cell.params["pool"]), size, channels)


class Camera:
    def __init__(self, cell, seed: int, dev: torch.device):
        self.frames = frames_of(cell, seed)
        devinfo.mark("frames")
        self.engine, self.model = program.make_engine(cell.config, dev)
        devinfo.mark("engine")
        self.next = 0
        for _ in range(int(cell.params["warm_frames"])):
            self.step()
        devinfo.mark("warm-up")

    def step(self):
        i = self.next % len(self.frames)
        self.next += 1
        return i, program.detect_frame(self.engine, self.model, self.frames[i])

    def window(self, seconds: float, answers: list | None = None) -> list:
        """Frames for ``seconds``; returns each frame's wall seconds."""
        times = []
        t_end = time.perf_counter() + seconds
        while True:
            t0 = time.perf_counter()
            if t0 >= t_end:
                return times
            i, fr = self.step()
            times.append(time.perf_counter() - t0)
            if answers is not None:
                answers.append((i, fr.idx, fr.conf, np.asarray(fr.probs), fr.bbox))


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device) -> Outcome:
    loop = Camera(cell, seed, dev)
    setup_s = devinfo.process_age_s()
    devinfo.log(devinfo.setup_line())
    got: list = []
    times = loop.window(seconds, got)
    measured = {"setup_s": setup_s,
                "frame_p95_ms": stats.percentile([t * 1e3 for t in times], 95)}
    devinfo.log(f"camera: {len(times)} frames in the window, p50 "
                f"{stats.percentile([t * 1e3 for t in times], 50)!r} ms")
    ctx = {"config": cell.config, "params": cell.params, "frames": len(times)}
    reduced = None
    if trace:
        with Profiled() as prof:
            tw = loop.window(float(cell.params["trace_seconds"]))
        reduced = prof.reduce()
        ctx.update(trace=reduced, trace_frames=len(tw))
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    answers = Answers(
        np.array([g[0] for g in got], np.int64),
        (np.array([g[1] for g in got], np.int64),
         np.array([g[2] for g in got], np.float64),
         np.stack([g[3] for g in got]) if got else np.zeros((0, 1)),
         np.array([list(g[4]) for g in got], np.int64).reshape(-1, 4)))
    return Outcome(
        measured=measured, attempted=len(times), failed=0,
        frames=loop.frames, answers=answers, lost=0,
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu", count=1,
        memory_peak_bytes=int(peak), ctx=ctx, trace=reduced)
