"""Frame-to-frame object tracker for the streaming detection surface: the
port's copy of ``tpu_cnn.head.tracker``.

The reference's realtime loop is frame-independent: every frame's box is
drawn and forgotten (``software/realtime_detect.py:575-615``). A viewer
of a stream wants object PERSISTENCE — the same physical object keeping
one identity (and a de-jittered box) as it moves. This is the classic
SORT-style association step, reduced to what the CAM detector provides
(no velocity model — the 16x16 CAM quantisation dominates motion between
adjacent frames):

  * greedy best-IoU matching of incoming detections to live tracks,
    class-gated (a 'cat' detection never continues a 'bus' track);
  * exponential smoothing of matched boxes and probabilities;
  * hit-count confirmation (a track is only shown after ``min_hits``
    consecutive-ish sightings — suppresses single-frame CAM flicker);
  * age-out after ``max_age`` unseen frames.

Host-side and engine-agnostic: consumes the ``(class_idx, prob, box)``
tuples every detection surface already produces (``detections_above`` /
``instance_detections``), so it composes with --multi and --instances
unchanged. Deterministic: ties in the greedy match are broken by
(track id, detection order).
"""

from __future__ import annotations

import dataclasses


def _iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(0, ix2 - ix1), max(0, iy2 - iy1)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / max(area_a + area_b - inter, 1)


@dataclasses.dataclass
class Track:
    """One tracked object. ``box`` is the smoothed (float) box; render
    with :meth:`ibox`. ``confirmed`` tracks have been matched at least
    ``min_hits`` times; only those are returned by ``Tracker.update``."""

    id: int
    cls: int
    box: tuple[float, float, float, float]
    prob: float
    hits: int = 1
    age: int = 0  # frames since last match
    confirmed: bool = False
    # per-coordinate velocity estimate (px/frame), used only when the
    # tracker runs with velocity=True (constant-velocity association gate)
    vel: tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)

    def ibox(self) -> tuple[int, int, int, int]:
        return tuple(int(round(v)) for v in self.box)

    def predicted(self, lead: int = 1) -> tuple[float, float, float, float]:
        """Where a constant-velocity model expects the box ``lead``
        frames after the last match."""
        return tuple(b + v * lead for b, v in zip(self.box, self.vel))


class Tracker:
    """Greedy class-gated IoU tracker.

    >>> tr = Tracker(min_hits=1)
    >>> tr.update([(2, 0.9, (10, 10, 50, 50))])[0].id
    1
    """

    def __init__(self, iou_floor: float = 0.2, max_age: int = 8,
                 min_hits: int = 2, smooth: float = 0.6,
                 velocity: bool = False, vel_smooth: float = 0.5):
        if not 0.0 < smooth <= 1.0:
            raise ValueError("smooth must be in (0, 1]: the weight of the "
                             "NEW observation")
        self.iou_floor = iou_floor
        self.max_age = max_age
        self.min_hits = min_hits
        self.smooth = smooth
        # velocity=True matches detections against each track's
        # CONSTANT-VELOCITY predicted box instead of its last box — the
        # SORT-style motion gate. Default off: measured on MovingScenes
        # (apps.eval_tracking A/B) — see docs/ROADMAP.md for the verdict.
        self.velocity = velocity
        self.vel_smooth = vel_smooth
        self.tracks: list[Track] = []
        self._next_id = 1
        self.frames = 0

    def update(self, detections) -> list[Track]:
        """Advance one frame with ``[(class_idx, prob, (x1, y1, x2, y2)),
        ...]``; returns the confirmed live tracks (stable order: by id)."""
        self.frames += 1
        # candidate (iou, track_idx, det_idx), best first; ties by
        # (track id, detection order) for determinism. With velocity on,
        # an unmatched track's prediction keeps advancing (age+1 frames
        # since the last match), so a briefly-occluded object is re-found
        # where it SHOULD be, not where it last was.
        ref = ([t.predicted(t.age + 1) for t in self.tracks]
               if self.velocity else [t.box for t in self.tracks])
        cand = sorted(
            ((_iou(ref[ti], d[2]), ti, di)
             for ti, t in enumerate(self.tracks)
             for di, d in enumerate(detections)
             if t.cls == d[0]),
            key=lambda c: (-c[0], self.tracks[c[1]].id, c[2]),
        )
        used_t: set[int] = set()
        used_d: set[int] = set()
        a = self.smooth
        for v, ti, di in cand:
            if v < self.iou_floor:
                break
            if ti in used_t or di in used_d:
                continue
            used_t.add(ti)
            used_d.add(di)
            t = self.tracks[ti]
            _, prob, box = detections[di]
            old = t.box
            t.box = tuple((1 - a) * o + a * n for o, n in zip(t.box, box))
            if self.velocity:
                # per-frame displacement of the SMOOTHED box, spread over
                # the frames since the last match, exponentially smoothed
                b = self.vel_smooth
                dt = max(t.age + 1, 1)
                t.vel = tuple(
                    (1 - b) * v + b * (n - o) / dt
                    for v, o, n in zip(t.vel, old, t.box))
            t.prob = (1 - a) * t.prob + a * prob
            t.hits += 1
            t.age = 0
            if t.hits >= self.min_hits:
                t.confirmed = True
        for ti, t in enumerate(self.tracks):
            if ti not in used_t:
                t.age += 1
        self.tracks = [t for t in self.tracks if t.age <= self.max_age]
        for di, (cls, prob, box) in enumerate(detections):
            if di in used_d:
                continue
            t = Track(self._next_id, int(cls), tuple(float(v) for v in box),
                      float(prob), confirmed=self.min_hits <= 1)
            self._next_id += 1
            self.tracks.append(t)
        return [t for t in sorted(self.tracks, key=lambda t: t.id)
                if t.confirmed and t.age == 0]
