"""The offline batch job: the engine's fused detect round after round over
frames staged on the device.

Set-up draws ``n_pools`` pools of ``batch`` u8 noise frames from the seed
(``shipped_per_pool`` of each pool's frames, on average, the bundle's
shipped test frames, on which the classifier is not saturated),
stages them on the device (as frames decoded on the GPU would be), builds
``CUDAEngine`` and runs one synchronous detect per pool (which builds the
kernels where the cache has none). The window then dispatches
``detect_device`` on the pools in turn, up to ``inflight`` rounds ahead
of the one it waits for, so that the card stays fed while the host
stands still; each round's outputs (every array ``detect_device(...)[2:]``
returns, in its order) are copied into its slot of pinned host buffers
behind an event. When the window's time is up it dispatches nothing
more, waits for every round it dispatched, and reads the clock after
that wait. The rate, reported under each of
the cell's end-to-end metrics in frames/s (``detect_fps``), is every
frame dispatched over that whole time. Results of a seeded sample of the
rounds (one in ``keep_every``, a number prime to ``n_pools`` and to
``inflight``, so that the kept rounds come from every pool and through
every buffer in turn) are kept for the comparison.
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np
import torch

from benchmarks.lib import device as devinfo
from benchmarks.lib import program, spec, stats, traffic
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.lib.trace import Profiled


def frames_of(cell, seed: int) -> np.ndarray:
    """The pools, one after the other: (n_pools * batch, S, S) u8 (or
    (n_pools * batch, C, S, S), as ``spec.frame_shape`` says), noise with
    ``shipped_per_pool`` x ``n_pools`` shipped test frames among it."""
    p = cell.params
    channels, size, _ = spec.frame_shape(cell.config)
    n_pools = int(p["n_pools"])
    frames = traffic.frames(seed, "pools", n_pools * int(p["batch"]), size, channels)
    return traffic.with_shipped(frames, seed, "pools", spec.bundle_dir(cell.config),
                                n_pools * int(p["shipped_per_pool"]))


class Offline:
    def __init__(self, cell, seed: int, dev: torch.device):
        p = cell.params
        self.batch, self.n_pools = int(p["batch"]), int(p["n_pools"])
        self.inflight, self.keep_every = int(p["inflight"]), int(p["keep_every"])
        if math.gcd(self.keep_every, self.n_pools * self.inflight) != 1:
            raise ValueError(f"keep_every {self.keep_every} has a factor in common "
                             f"with n_pools {self.n_pools} or inflight "
                             f"{self.inflight}: the kept rounds would skip pools "
                             f"or buffers")
        self.keep_offset = int(traffic.rng(seed, "keep").integers(self.keep_every))
        self.frames = torch.from_numpy(frames_of(cell, seed)).to(dev)
        self.pools = list(self.frames.split(self.batch))
        devinfo.mark("frames")
        self.engine, _ = program.make_engine(cell.config, dev)
        devinfo.mark("engine")
        self.cuda = dev.type == "cuda"
        outs = [self.engine.detect_device(pool)[2:] for pool in self.pools]
        self.ring = [torch.empty((self.inflight, *t.shape), dtype=t.dtype,
                                 pin_memory=self.cuda) for t in outs[0]]
        self._sync()
        devinfo.mark("warm-up")
        self.round = 0  # rounds dispatched so far, over every window
        self.kept: list[Answers] = []
        self.none_kept = Answers(np.zeros(0, np.int64), tuple(
            np.zeros((0, *r.shape[2:]), r.numpy().dtype) for r in self.ring))

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def _dispatch(self):
        i = self.round
        self.round += 1
        outs = self.engine.detect_device(self.pools[i % self.n_pools])[2:]
        buf = [r[i % self.inflight] for r in self.ring]
        for h, t in zip(buf, outs):
            h.copy_(t, non_blocking=self.cuda)
        event = None
        if self.cuda:
            event = torch.cuda.Event()
            event.record()
        return i, buf, event

    def _resolve(self, item, keep: bool) -> None:
        i, buf, event = item
        if event is not None:
            event.synchronize()
        if keep and i % self.keep_every == self.keep_offset:
            pool = i % self.n_pools
            self.kept.append(Answers(
                np.arange(pool * self.batch, (pool + 1) * self.batch),
                tuple(h.numpy().copy() for h in buf)))

    def window(self, seconds: float, keep: bool = True) -> dict:
        """Rounds dispatched for ``seconds``, then waited for: the rounds
        and frames, and the seconds from the start to the end of that
        wait."""
        queue: collections.deque = collections.deque()
        rounds = 0
        t0 = time.perf_counter()
        t_end = t0 + seconds
        while True:
            if len(queue) == self.inflight:
                self._resolve(queue.popleft(), keep)
            if time.perf_counter() >= t_end:
                break
            queue.append(self._dispatch())
            rounds += 1
        ahead, t_close = len(queue), time.perf_counter()
        while queue:
            self._resolve(queue.popleft(), keep)
        t_done = time.perf_counter()
        devinfo.log(f"window: {rounds} rounds of {self.batch} frames in "
                    f"{t_done - t0!r} s; {ahead} in flight at the close, "
                    f"waited for in {t_done - t_close!r} s")
        return {"rounds": rounds, "frames": rounds * self.batch,
                "seconds": t_done - t0}


def run(cell, seed: int, seconds: float, trace: bool, dev: torch.device) -> Outcome:
    job = Offline(cell, seed, dev)
    setup_s = devinfo.process_age_s()
    devinfo.log(devinfo.setup_line())
    win = job.window(seconds)
    fps = stats.rate(win["frames"], win["seconds"])
    measured = {"setup_s": setup_s}
    measured.update((m["name"], fps) for m in cell.end_to_end
                    if m["unit"] == "frames/s")
    ctx = {"config": cell.config, "params": cell.params, "fps": fps}
    reduced = None
    if trace:
        with Profiled() as prof:
            tw = job.window(float(cell.params["trace_seconds"]), keep=False)
            job._sync()
        reduced = prof.reduce()
        ctx.update(trace=reduced, trace_rounds=tw["rounds"])
    cuda = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = Outcome(
        measured=measured, attempted=win["frames"], failed=0,
        frames=job.frames, answers=Answers.join(job.kept, job.none_kept), lost=0,
        kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
        count=1, memory_peak_bytes=int(peak), ctx=ctx, trace=reduced)
    del job
    return out
