"""Training and evaluation data sources: the port's copy of
``tpu_cnn.train.data``, numpy only.

The reference trains on a 6-class COCO subset (``training/train_cnn.py:46-97``).
Three sources here, in degradation order:

  * ``CocoClassification``   — same COCO single-label protocol (needs
    pycocotools + the dataset on disk; gated).
  * ``ImageFolderDataset``   — <root>/<class_name>/*.jpg|png layout.
  * ``SyntheticShapes``      — procedurally generated class-distinct shapes,
    for hardware/dataset-free training, demos and tests.

All sources yield (image (128, 128) float32 in [0, 1], label int) and batch
via ``batches()`` — plain numpy on the host. The scene generators
(``CompositeScenes``, ``MovingScenes``, ``RealComposites``,
``RealMovingScenes``) are the eval apps' substrates
(``apps.eval_detection``, ``apps.eval_tracking``).
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from tpu_cnn_torch.models.cnn import CLASS_NAMES, IMG_SIZE


class SyntheticShapes:
    """Six procedurally distinct grayscale classes.

    Class geometry is chosen so that spatial-bin pooling genuinely
    discriminates (ring vs bar vs cross ...), exercising the same
    "global-pool loses the donut" property the reference calls out
    (``software/retrain_classifier.py:189-190``).
    """

    def __init__(self, n_per_class: int = 200, seed: int = 0,
                 img_size: int = IMG_SIZE):
        self.img_size = img_size
        self.rng = np.random.RandomState(seed)
        self.samples = [
            (cls, self.rng.randint(0, 2**31 - 1))
            for cls in range(len(CLASS_NAMES))
            for _ in range(n_per_class)
        ]
        self.rng.shuffle(self.samples)
        self.class_names = list(CLASS_NAMES)

    def __len__(self):
        return len(self.samples)

    def render(self, cls: int, seed: int) -> np.ndarray:
        s = self.img_size
        r = np.random.RandomState(seed)
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        cx, cy = r.uniform(0.3, 0.7, 2) * s
        scale = r.uniform(0.15, 0.3) * s
        img = r.normal(30, 8, (s, s)).astype(np.float32)
        d = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
        if cls == 0:  # "airplane": cross / X
            a = r.uniform(0, np.pi)
            u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
            v = -(xx - cx) * np.sin(a) + (yy - cy) * np.cos(a)
            img += 180 * ((np.abs(u) < scale * 0.15) & (np.abs(v) < scale)).astype(np.float32)
            img += 180 * ((np.abs(v) < scale * 0.15) & (np.abs(u) < scale)).astype(np.float32)
        elif cls == 1:  # "cat": two triangles over a blob
            img += 150 * np.exp(-(d / scale) ** 2)
            for sx in (-1, 1):
                tx, ty = cx + sx * scale * 0.6, cy - scale
                img += 120 * ((np.abs(xx - tx) < (yy - ty) * 0.5)
                              & (yy > ty) & (yy < ty + scale * 0.8)).astype(np.float32)
        elif cls == 2:  # "zebra": stripes
            a = r.uniform(0, np.pi)
            u = (xx - cx) * np.cos(a) + (yy - cy) * np.sin(a)
            img += 120 * (np.sin(u / (scale * 0.15)) > 0).astype(np.float32) * (d < scale * 1.5)
        elif cls == 3:  # "bus": filled rectangle
            img += 170 * ((np.abs(xx - cx) < scale * 1.3)
                          & (np.abs(yy - cy) < scale * 0.7)).astype(np.float32)
        elif cls == 4:  # "bicycle": two circles
            for sx in (-1, 1):
                dd = np.sqrt((xx - (cx + sx * scale)) ** 2 + (yy - cy) ** 2)
                img += 160 * (np.abs(dd - scale * 0.6) < scale * 0.1).astype(np.float32)
        else:  # "donut": ring
            img += 180 * (np.abs(d - scale) < scale * 0.3).astype(np.float32)
        return np.clip(img, 0, 255) / 255.0

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        imgs = np.stack([self.render(c, sd) for c, sd in self.samples]).astype(np.float32)
        labels = np.asarray([c for c, _ in self.samples], dtype=np.int32)
        return imgs, labels

    def ground_truth_box(self, cls: int, seed: int) -> tuple[int, int, int, int]:
        """Analytic object bounding box (x1, y1, x2, y2) for a rendered
        sample — the generator's shape placement is deterministic in (cls,
        seed), enabling quantitative detection-IoU evaluation (a capability
        the reference lacks: its CAM boxes were only eyeballed)."""
        s = self.img_size
        r = np.random.RandomState(seed)
        cx, cy = r.uniform(0.3, 0.7, 2) * s
        scale = r.uniform(0.15, 0.3) * s
        if cls == 0:
            half_x = half_y = scale
        elif cls == 1:
            half_x, half_y = scale * 1.1, scale * 1.8  # blob + ears above
            cy -= scale * 0.4
        elif cls == 2:
            half_x = half_y = scale * 1.5
        elif cls == 3:
            half_x, half_y = scale * 1.3, scale * 0.7
        elif cls == 4:
            half_x, half_y = scale * 1.6, scale * 0.7
        else:
            half_x = half_y = scale * 1.3
        x1 = int(np.clip(cx - half_x, 0, s - 1))
        y1 = int(np.clip(cy - half_y, 0, s - 1))
        x2 = int(np.clip(cx + half_x, 0, s - 1))
        y2 = int(np.clip(cy + half_y, 0, s - 1))
        return (x1, y1, x2, y2)

    def arrays_with_boxes(self):
        imgs, labels = self.arrays()
        boxes = np.asarray(
            [self.ground_truth_box(c, sd) for c, sd in self.samples], np.int32
        )
        return imgs, labels, boxes


class CompositeScenes:
    """Multi-object synthetic scenes: ``n_objects`` distinct-class shapes
    per frame, max-composited (shapes are bright additions over the noise
    background, so per-pixel max preserves each object).

    Ground truth is the per-object (class, box) list from the generator's
    analytic placement — the eval substrate for the beyond-reference
    multi-object head (the reference only boxes the argmax class,
    ``software/realtime_detect.py:85-116``). Object placements are
    rejection-sampled to near-disjoint boxes (IoU < ``max_overlap``) so a
    correct detector can separate them.
    """

    def __init__(self, n_scenes: int = 60, seed: int = 0,
                 img_size: int = IMG_SIZE, n_objects: int = 2,
                 max_overlap: float = 0.15, same_class: bool = False):
        from tpu_cnn_torch.apps.eval_detection import iou

        self.img_size = img_size
        self.gen = SyntheticShapes(n_per_class=1, seed=seed, img_size=img_size)
        self.class_names = self.gen.class_names
        rng = np.random.RandomState(seed + 1)
        self.scenes = []  # [(cls, render_seed, box), ...] per scene
        for _ in range(n_scenes):
            # same_class=True is the multi-INSTANCE substrate: all objects
            # in a scene share one class, so only a per-component head
            # (--instances) can separate them — the per-class box merges
            # them into one spanning box by construction.
            if same_class:
                classes = np.full(
                    n_objects, rng.randint(len(self.class_names)))
            else:
                classes = rng.choice(len(self.class_names), n_objects,
                                     replace=False)
            # joint rejection sampling: redraw ALL placements together, so
            # an oversized first object cannot poison the scene; keep the
            # best (most-placed) attempt as a fallback
            best: list = []
            for _attempt in range(256):
                placed: list = []
                for cls in classes:
                    sd = int(rng.randint(0, 2**31 - 1))
                    box = self.gen.ground_truth_box(int(cls), sd)
                    if all(iou(box, b) < max_overlap for _, _, b in placed):
                        placed.append((int(cls), sd, box))
                if len(placed) > len(best):
                    best = placed
                if len(best) == n_objects:
                    break
            self.scenes.append(best)

    def __len__(self):
        return len(self.scenes)

    def arrays(self):
        """Returns (imgs (N, s, s) float32 0..1, truths) where truths[i] is
        the scene's [(class_idx, (x1, y1, x2, y2)), ...]."""
        imgs = np.stack([
            np.max([self.gen.render(cls, sd) for cls, sd, _ in scene], axis=0)
            for scene in self.scenes
        ]).astype(np.float32)
        truths = [[(cls, box) for cls, _, box in scene]
                  for scene in self.scenes]
        return imgs, truths


def _shift_edge(img: np.ndarray, dy: int, dx: int) -> np.ndarray:
    """Integer-translate with edge-replicated padding — the exact
    label-preserving transform ``augment_batch`` trains with, so shifted
    frames stay in-distribution for the detection head."""
    h, w = img.shape
    p = max(abs(dy), abs(dx), 1)
    padded = np.pad(img, p, mode="edge")
    return padded[p + dy: p + dy + h, p + dx: p + dx + w]


class MovingScenes:
    """Multi-object scene SEQUENCES with ground-truth identities — the
    tracking-evaluation substrate: it gives the tracker a sequence
    metric.

    Each sequence renders ``n_objects`` full frames once (via
    :class:`SyntheticShapes`, the same max-composite protocol as
    :class:`CompositeScenes`, so frames are in-distribution for the
    calibrated detection head) and per frame translates each object's
    rendering along a linear constant-velocity trajectory that reflects
    off the image borders (edge-replicated shift — the ``augment_batch``
    transform). Ground truth per frame is ``[(obj_id, class_idx, box),
    ...]`` with a stable ``obj_id`` — exactly what ID-switch /
    fragmentation metrics need. ``same_class=True`` gives every object
    in a sequence one class (the regime where the tracker's class gate
    cannot help and pure box association is tested).

    Translating ONE rendering (rather than re-rendering per frame) keeps
    each object's appearance constant across frames, like a real tracked
    object; objects may legitimately cross mid-sequence — the
    association stress the eval exists to measure.
    """

    def __init__(self, n_seqs: int = 8, n_frames: int = 24, seed: int = 0,
                 img_size: int = IMG_SIZE, n_objects: int = 2,
                 max_overlap: float = 0.15, same_class: bool = False,
                 speed: tuple[float, float] = (1.5, 3.5)):
        from tpu_cnn_torch.apps.eval_detection import iou

        self.img_size = img_size
        self.n_frames = n_frames
        self.gen = SyntheticShapes(n_per_class=1, seed=seed,
                                   img_size=img_size)
        self.class_names = self.gen.class_names
        rng = np.random.RandomState(seed + 1)
        # per sequence: [(cls, render_seed, box, vel_xy), ...]
        self.seqs: list[list] = []
        for _ in range(n_seqs):
            if same_class:
                classes = np.full(n_objects,
                                  rng.randint(len(self.class_names)))
            else:
                classes = rng.choice(len(self.class_names), n_objects,
                                     replace=False)
            best: list = []
            for _attempt in range(256):
                placed: list = []
                for cls in classes:
                    sd = int(rng.randint(0, 2**31 - 1))
                    box = self.gen.ground_truth_box(int(cls), sd)
                    if all(iou(box, b) < max_overlap
                           for _, _, b, _ in placed):
                        ang = rng.uniform(0, 2 * np.pi)
                        spd = rng.uniform(*speed)
                        placed.append((int(cls), sd, box,
                                       (spd * np.cos(ang),
                                        spd * np.sin(ang))))
                if len(placed) > len(best):
                    best = placed
                if len(best) == n_objects:
                    break
            self.seqs.append(best)

    def __len__(self):
        return len(self.seqs)

    def arrays(self):
        """Returns (imgs (n_seqs, n_frames, s, s) float32 0..1, truths)
        where truths[i][t] = [(obj_id, class_idx, (x1, y1, x2, y2)), ...];
        obj_id is stable within a sequence."""
        s, T = self.img_size, self.n_frames
        imgs = np.empty((len(self.seqs), T, s, s), np.float32)
        truths = []
        for i, seq in enumerate(self.seqs):
            # render each object's full frame once; per frame translate it
            objs = []
            for oid, (cls, sd, box, (vx, vy)) in enumerate(seq):
                objs.append((oid, cls, self.gen.render(cls, sd), box,
                             0.0, 0.0, float(vx), float(vy)))
            seq_truth = []
            for t in range(T):
                layers, frame_truth = [], []
                for j, (oid, cls, full, (bx1, by1, bx2, by2),
                        ox, oy, vx, vy) in enumerate(objs):
                    dxi, dyi = int(round(ox)), int(round(oy))
                    # _shift_edge crops the view dy/dx PAST the origin, so
                    # a POSITIVE offset needs a negative shift
                    layers.append(_shift_edge(full, -dyi, -dxi))
                    frame_truth.append((oid, cls,
                                        (bx1 + dxi, by1 + dyi,
                                         bx2 + dxi, by2 + dyi)))
                    # advance; reflect when the object's box would leave
                    # the frame
                    ox, oy = ox + vx, oy + vy
                    if bx1 + ox < 0 or bx2 + ox > s - 1:
                        vx = -vx
                        ox = min(max(ox, -float(bx1)), float(s - 1 - bx2))
                    if by1 + oy < 0 or by2 + oy > s - 1:
                        vy = -vy
                        oy = min(max(oy, -float(by1)), float(s - 1 - by2))
                    objs[j] = (oid, cls, full, (bx1, by1, bx2, by2),
                               ox, oy, vx, vy)
                imgs[i, t] = np.max(layers, axis=0)
                seq_truth.append(frame_truth)
            truths.append(seq_truth)
        return imgs, truths


class RealComposites:
    """Multi-object scenes composited from REAL photograph tiles — the
    eval/calibration substrate that scores the multi-object surface on
    real photograph statistics, not on analytic synthetic shapes alone;
    the reference's defining discipline
    is adapting and scoring the head on what the real pipeline produces
    (``software/dump_fpga_features.py:36-131`` ->
    ``retrain_classifier.py:235-278``).

    Each scene pastes ``n_objects`` down-scaled real tiles
    (``artifacts/realphoto/{train,val}_bins`` — 128x128 grayscale photos,
    class from the filename) onto a noise canvas at rejection-sampled
    near-disjoint positions (same joint-redraw protocol as
    :class:`CompositeScenes`). Ground truth box = the pasted rectangle
    (the tile frames its object, so the box is honest if loose — IoU
    floors, not exact extents, are what the eval scores). The default
    canvas is the synthetic generator's noise background; object
    STATISTICS are real (texture, contrast, intra-class variation), the
    paste seam is the price of having ground truth at all.
    ``background="real"`` swaps the canvas for a blurred real photograph
    (8x8 down/up resample of a random tile): real lighting/texture
    statistics without planting an unlabeled detectable object.
    Constructor contract matches ``CompositeScenes`` so
    ``calibrate_multi.fit_head`` / ``eval_detection`` swap sources via
    ``scenes_cls``.
    """

    def __init__(self, n_scenes: int = 60, seed: int = 0,
                 img_size: int = IMG_SIZE, n_objects: int = 2,
                 max_overlap: float = 0.15, same_class: bool = False,
                 root: str | None = None, background: str = "noise"):
        from tpu_cnn_torch.apps.eval_detection import iou

        if root is None:
            from tpu_cnn_torch.utils.paths import _REPO_ROOT

            root = os.path.join(_REPO_ROOT, "artifacts", "realphoto",
                                "val_bins")
        self.img_size = img_size
        tiles = BinFolderDataset(root, img_size=128)
        imgs, labels = tiles.arrays()
        self.class_names = list(tiles.class_names)
        self._by_class: dict[int, np.ndarray] = {
            c: imgs[labels == c] for c in np.unique(labels)
        }
        n_classes = len(self._by_class)
        rng = np.random.RandomState(seed + 1)
        # pre-draw all scene layouts (tile index, scale, position) with
        # the same joint rejection sampling CompositeScenes uses
        self.scenes = []  # [(cls, tile_idx, size, box), ...] per scene
        for _ in range(n_scenes):
            if same_class:
                classes = np.full(n_objects, rng.randint(n_classes))
            else:
                classes = rng.choice(n_classes, n_objects, replace=False)
            best: list = []
            for _attempt in range(256):
                placed: list = []
                for cls in classes:
                    ti = int(rng.randint(len(self._by_class[int(cls)])))
                    size = int(rng.uniform(0.38, 0.55) * img_size)
                    x1 = int(rng.randint(0, img_size - size))
                    y1 = int(rng.randint(0, img_size - size))
                    box = (x1, y1, x1 + size - 1, y1 + size - 1)
                    if all(iou(box, b) < max_overlap
                           for _, _, _, b in placed):
                        placed.append((int(cls), ti, size, box))
                if len(placed) > len(best):
                    best = placed
                if len(best) == n_objects:
                    break
            self.scenes.append(best)
        if background not in ("noise", "real"):
            raise ValueError(f"background must be noise|real, got "
                             f"{background!r}")
        self.background = background
        self._all_tiles = imgs  # float 0..1, for the real-background canvas
        self._rng_bg = np.random.RandomState(seed + 7)

    def __len__(self):
        return len(self.scenes)

    @staticmethod
    def _resize(tile: np.ndarray, size: int) -> np.ndarray:
        """Area-style resize 128 -> size via bilinear sampling (plain
        numpy — no PIL dependency on the eval path)."""
        s0 = tile.shape[0]
        coords = (np.arange(size, dtype=np.float32) + 0.5) * (s0 / size) - 0.5
        c0 = np.clip(np.floor(coords).astype(np.int32), 0, s0 - 1)
        c1 = np.minimum(c0 + 1, s0 - 1)
        f = np.clip(coords - c0, 0.0, 1.0)
        rows = (tile[c0] * (1 - f)[:, None] + tile[c1] * f[:, None])
        cols = (rows[:, c0] * (1 - f)[None, :] + rows[:, c1] * f[None, :])
        return cols

    def arrays(self):
        """Returns (imgs (N, s, s) float32 0..1, truths) where truths[i]
        is [(class_idx, (x1, y1, x2, y2)), ...]."""
        s = self.img_size
        out = np.empty((len(self.scenes), s, s), np.float32)
        truths = []
        for i, scene in enumerate(self.scenes):
            if self.background == "real":
                # REAL-photo canvas: a random
                # tile blurred by an 8x8 down/up resample — keeps the
                # photograph's lighting/texture statistics while
                # destroying object structure, so the canvas cannot plant
                # an unlabeled detectable object that would corrupt the
                # ground truth (the price a literal photo crop would pay).
                src = self._all_tiles[self._rng_bg.randint(
                    len(self._all_tiles))]
                img = self._resize(self._resize(src, 8), s).astype(
                    np.float32).copy()
            else:
                img = np.clip(
                    self._rng_bg.normal(30, 8, (s, s)).astype(np.float32),
                    0, 255) / 255.0
            truth = []
            for cls, ti, size, (x1, y1, x2, y2) in scene:
                tile = self._by_class[cls][ti]
                img[y1:y2 + 1, x1:x2 + 1] = self._resize(tile, size)
                truth.append((cls, (x1, y1, x2, y2)))
            out[i] = img
            truths.append(truth)
        return out, truths


class RealMovingScenes:
    """Moving multi-object sequences of REAL photograph tiles — the
    tracking substrate of :class:`MovingScenes` with the appearance model
    of :class:`RealComposites`, so tracking is scored on real tiles and
    not only on synthetic shapes. Each sequence draws per-object
    (class, tile, size) once and per frame pastes the SAME down-scaled
    tile at its constant-velocity, border-reflecting position (stable
    appearance, like a real tracked object; later objects occlude earlier
    ones where boxes overlap — honest association stress). Ground truth
    per frame: ``[(obj_id, class_idx, box), ...]`` with stable ids.
    Constructor contract matches ``MovingScenes`` so
    ``eval_tracking.evaluate_tracking`` swaps sources via
    ``scenes_cls``."""

    def __init__(self, n_seqs: int = 8, n_frames: int = 24, seed: int = 0,
                 img_size: int = IMG_SIZE, n_objects: int = 2,
                 max_overlap: float = 0.15, same_class: bool = False,
                 speed: tuple[float, float] = (1.5, 3.5),
                 root: str | None = None, background: str = "noise"):
        from tpu_cnn_torch.apps.eval_detection import iou

        if root is None:
            from tpu_cnn_torch.utils.paths import _REPO_ROOT

            root = os.path.join(_REPO_ROOT, "artifacts", "realphoto",
                                "val_bins")
        self.img_size = img_size
        self.n_frames = n_frames
        tiles = BinFolderDataset(root, img_size=128)
        imgs, labels = tiles.arrays()
        self.class_names = list(tiles.class_names)
        self._by_class = {c: imgs[labels == c] for c in np.unique(labels)}
        self._all_tiles = imgs
        if background not in ("noise", "real"):
            raise ValueError(f"background must be noise|real, got "
                             f"{background!r}")
        self.background = background
        rng = np.random.RandomState(seed + 1)
        s = img_size
        # per sequence: [(cls, tile_idx, size, box, vel_xy), ...]
        self.seqs: list[list] = []
        for _ in range(n_seqs):
            n_classes = len(self._by_class)
            if same_class:
                classes = np.full(n_objects, rng.randint(n_classes))
            else:
                classes = rng.choice(n_classes, n_objects, replace=False)
            best: list = []
            for _attempt in range(256):
                placed: list = []
                for cls in classes:
                    ti = int(rng.randint(len(self._by_class[int(cls)])))
                    size = int(rng.uniform(0.38, 0.55) * s)
                    x1 = int(rng.randint(0, s - size))
                    y1 = int(rng.randint(0, s - size))
                    box = (x1, y1, x1 + size - 1, y1 + size - 1)
                    if all(iou(box, b) < max_overlap
                           for _, _, _, b, _ in placed):
                        ang = rng.uniform(0, 2 * np.pi)
                        spd = rng.uniform(*speed)
                        placed.append((int(cls), ti, size, box,
                                       (spd * np.cos(ang),
                                        spd * np.sin(ang))))
                if len(placed) > len(best):
                    best = placed
                if len(best) == n_objects:
                    break
            self.seqs.append(best)
        self._rng_bg = np.random.RandomState(seed + 7)

    def __len__(self):
        return len(self.seqs)

    def arrays(self):
        """Returns (imgs (n_seqs, n_frames, s, s) float32 0..1, truths)
        with truths[i][t] = [(obj_id, class_idx, (x1, y1, x2, y2)), ...]."""
        s, T = self.img_size, self.n_frames
        imgs = np.empty((len(self.seqs), T, s, s), np.float32)
        truths = []
        for i, seq in enumerate(self.seqs):
            if self.background == "real":
                src = self._all_tiles[self._rng_bg.randint(
                    len(self._all_tiles))]
                canvas = RealComposites._resize(
                    RealComposites._resize(src, 8), s).astype(np.float32)
            else:
                canvas = np.clip(
                    self._rng_bg.normal(30, 8, (s, s)).astype(np.float32),
                    0, 255) / 255.0
            objs = []
            for oid, (cls, ti, size, (x1, y1, x2, y2), (vx, vy)) \
                    in enumerate(seq):
                tile = RealComposites._resize(self._by_class[cls][ti], size)
                objs.append([oid, cls, tile, (x1, y1, x2, y2),
                             0.0, 0.0, float(vx), float(vy)])
            seq_truth = []
            for t in range(T):
                frame = canvas.copy()
                frame_truth = []
                for obj in objs:
                    oid, cls, tile, (bx1, by1, bx2, by2), ox, oy, vx, vy \
                        = obj
                    dxi, dyi = int(round(ox)), int(round(oy))
                    frame[by1 + dyi:by2 + dyi + 1,
                          bx1 + dxi:bx2 + dxi + 1] = tile
                    frame_truth.append((oid, cls,
                                        (bx1 + dxi, by1 + dyi,
                                         bx2 + dxi, by2 + dyi)))
                    ox, oy = ox + vx, oy + vy
                    if bx1 + ox < 0 or bx2 + ox > s - 1:
                        vx = -vx
                        ox = min(max(ox, -float(bx1)), float(s - 1 - bx2))
                    if by1 + oy < 0 or by2 + oy > s - 1:
                        vy = -vy
                        oy = min(max(oy, -float(by1)), float(s - 1 - by2))
                    obj[4:] = [ox, oy, vx, vy]
                imgs[i, t] = frame
                seq_truth.append(frame_truth)
            truths.append(seq_truth)
        return imgs, truths


class ImageFolderDataset:
    """<root>/<class_name>/*.{jpg,png,bmp} single-label layout."""

    def __init__(self, root: str, class_names: list[str] | None = None,
                 img_size: int = IMG_SIZE, max_per_class: int = 0):
        from PIL import Image  # noqa: F401 — fail early if PIL missing

        self.img_size = img_size
        self.class_names = class_names or sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        self.samples = []
        for ci, name in enumerate(self.class_names):
            files = sorted(
                f for f in os.listdir(os.path.join(root, name))
                if f.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
            )
            if max_per_class:
                files = files[:max_per_class]
            self.samples += [(os.path.join(root, name, f), ci) for f in files]

    def __len__(self):
        return len(self.samples)

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        imgs, labels = [], []
        for path, ci in self.samples:
            img = Image.open(path).convert("L").resize((self.img_size, self.img_size))
            imgs.append(np.asarray(img, np.float32) / 255.0)
            labels.append(ci)
        return np.stack(imgs), np.asarray(labels, np.int32)


class BinFolderDataset:
    """Flat directory of raw ``*_class<C>.bin`` images — the reference's own
    test-image export format (``training/train_cnn.py:199-216``), and the
    format of this repo's real-photo validation set
    (``artifacts/realphoto/{train,val}_bins``). Labels come from the
    filename; class names from an adjacent ``classes.json`` when present.
    """

    def __init__(self, root: str, class_names: list[str] | None = None,
                 img_size: int = IMG_SIZE, max_per_class: int = 0):
        import json
        import re

        self.img_size = img_size
        pat = re.compile(r"_class(\d+)\.bin$")
        samples = []
        for f in sorted(os.listdir(root)):
            m = pat.search(f)
            if m:
                samples.append((os.path.join(root, f), int(m.group(1))))
        if not samples:
            raise ValueError(f"no *_class<C>.bin files under {root}")
        if max_per_class:
            counts: dict[int, int] = {}
            kept = []
            for path, ci in samples:
                if counts.get(ci, 0) < max_per_class:
                    counts[ci] = counts.get(ci, 0) + 1
                    kept.append((path, ci))
            samples = kept
        self.samples = samples
        n_classes = max(ci for _, ci in samples) + 1
        if class_names is None:
            cj = os.path.join(root, "classes.json")
            if not os.path.exists(cj):
                cj = os.path.join(os.path.dirname(root.rstrip("/")), "classes.json")
            if os.path.exists(cj):
                with open(cj) as fh:
                    class_names = list(json.load(fh))
        self.class_names = class_names or [f"class{c}" for c in range(n_classes)]

    def __len__(self):
        return len(self.samples)

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        s = self.img_size
        imgs, labels = [], []
        for path, ci in self.samples:
            raw = np.fromfile(path, np.uint8)
            if raw.size != s * s:
                raise ValueError(
                    f"{path}: {raw.size} bytes, expected {s * s} ({s}x{s})"
                )
            imgs.append(raw.reshape(s, s).astype(np.float32) / 255.0)
            labels.append(ci)
        return np.stack(imgs), np.asarray(labels, np.int32)


class _MiniCoco:
    """Minimal pure-JSON reader for COCO detection annotation files,
    implementing the two queries the protocol needs (getImgIds by category,
    loadImgs). Drop-in for environments without pycocotools — the
    annotation format is plain JSON."""

    def __init__(self, ann_file: str):
        import json

        with open(ann_file) as f:
            data = json.load(f)
        self._imgs = {im["id"]: im for im in data.get("images", [])}
        self._cat_to_imgs: dict[int, set] = {}
        for ann in data.get("annotations", []):
            self._cat_to_imgs.setdefault(ann["category_id"], set()).add(
                ann["image_id"]
            )

    def getImgIds(self, catIds):
        ids: set = set()
        for c in catIds:
            ids |= self._cat_to_imgs.get(c, set())
        return sorted(ids)

    def loadImgs(self, img_id):
        return [self._imgs[img_id]]


class CocoClassification:
    """COCO detection annotations -> single-label classification, the
    reference's protocol (``training/train_cnn.py:58-97``). Uses
    pycocotools when installed, else a built-in pure-JSON reader."""

    COCO_CATS = {  # training/train_cnn.py:47-53
        "airplane": 5, "cat": 17, "zebra": 24,
        "bus": 6, "bicycle": 2, "donut": 60,
    }

    def __init__(self, img_dir: str, ann_file: str, max_per_class: int = 0,
                 img_size: int = IMG_SIZE, seed: int = 0):
        try:
            from pycocotools.coco import COCO

            self.coco = COCO(ann_file)
        except ImportError:
            self.coco = _MiniCoco(ann_file)
        self.img_dir = img_dir
        self.img_size = img_size
        self.class_names = list(self.COCO_CATS.keys())
        rng = np.random.RandomState(seed)
        self.samples = []
        for ci, (_, cat_id) in enumerate(self.COCO_CATS.items()):
            ids = list(self.coco.getImgIds(catIds=[cat_id]))
            rng.shuffle(ids)
            if max_per_class:
                ids = ids[:max_per_class]
            self.samples += [(i, ci) for i in ids]
        rng.shuffle(self.samples)

    def __len__(self):
        return len(self.samples)

    def arrays(self) -> tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        imgs, labels = [], []
        for img_id, ci in self.samples:
            info = self.coco.loadImgs(img_id)[0]
            img = Image.open(os.path.join(self.img_dir, info["file_name"]))
            img = img.convert("L").resize((self.img_size, self.img_size))
            imgs.append(np.asarray(img, np.float32) / 255.0)
            labels.append(ci)
        return np.stack(imgs), np.asarray(labels, np.int32)


def soft_composites(images: np.ndarray, labels: np.ndarray, n: int,
                    seed: int = 0, img_size: int | None = None,
                    max_overlap: float = 0.15):
    """2-object soft-label composites built from the TRAINING ARRAYS
    themselves — the co-presence phase-1 lever: a backbone trained only
    on single-label frames never learns to keep two classes' evidence
    alive in one image. Each composite pastes two down-scaled
    tiles of DISTINCT classes onto the noise canvas (the
    RealComposites protocol) and carries the soft target
    (0.5, 0.5) — ``train_cnn`` phase 1 consumes these beside the
    one-hot singles (``--composite-frac``); phase 2 / eval never see
    them. Returns (imgs (n, s, s) f32 0..1, soft (n, K) f32)."""
    from tpu_cnn_torch.apps.eval_detection import iou

    s = img_size or images.shape[1]
    classes = np.unique(labels)
    by_class = {c: images[labels == c] for c in classes}
    k_count = int(labels.max()) + 1
    rng = np.random.RandomState(seed + 11)
    out = np.empty((n, s, s), np.float32)
    soft = np.zeros((n, k_count), np.float32)
    for i in range(n):
        pair = rng.choice(classes, 2, replace=False)
        img = np.clip(rng.normal(30, 8, (s, s)).astype(np.float32),
                      0, 255) / 255.0
        placed: list = []
        for cls in pair:
            tile = by_class[int(cls)][rng.randint(len(by_class[int(cls)]))]
            size = int(rng.uniform(0.38, 0.55) * s)
            for _attempt in range(64):
                x1 = int(rng.randint(0, s - size))
                y1 = int(rng.randint(0, s - size))
                box = (x1, y1, x1 + size - 1, y1 + size - 1)
                if all(iou(box, b) < max_overlap for b in placed):
                    break
            placed.append(box)
            img[y1:y1 + size, x1:x1 + size] = \
                RealComposites._resize(tile, size)
            soft[i, int(cls)] = 0.5
        out[i] = img
    return out, soft


def batches(
    images: np.ndarray,
    labels: np.ndarray,
    batch_size: int,
    rng: np.random.RandomState,
    drop_remainder: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    idx = rng.permutation(len(images))
    end = (len(images) // batch_size) * batch_size if drop_remainder else len(images)
    for s in range(0, end, batch_size):
        sel = idx[s : s + batch_size]
        yield images[sel], labels[sel]


def augment_batch(images: np.ndarray, rng: np.random.RandomState,
                  max_shift: int = 4) -> np.ndarray:
    """Label-preserving train-time augmentation, on the HOST.

    Per image: random horizontal flip + random integer translation up to
    ±``max_shift`` px with edge-replicated padding (no synthetic black
    border enters the quantized input range). Host-side keeps the train
    step's signature unchanged, so it composes with every parallel axis —
    and with multi-host, where each process draws from the same shared-seed
    stream and so augments its slice of the global batch consistently.

    Beyond-reference: the reference trainer uses no augmentation
    (``training/train_cnn.py:226-229`` — grayscale/resize/totensor only);
    this is opt-in via ``train_cnn --augment`` and defaults off.
    """
    out = np.empty_like(images)
    n, h, w = images.shape
    flips = rng.rand(n) < 0.5
    dys = rng.randint(-max_shift, max_shift + 1, n)
    dxs = rng.randint(-max_shift, max_shift + 1, n)
    p = max_shift
    for i in range(n):
        img = images[i, :, ::-1] if flips[i] else images[i]
        padded = np.pad(img, p, mode="edge")
        out[i] = padded[p + dys[i]: p + dys[i] + h,
                        p + dxs[i]: p + dxs[i] + w]
    return out
