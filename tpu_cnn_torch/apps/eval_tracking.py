"""Quantitative tracking evaluation — CLEAR-MOT-style metrics on moving
multi-object scene sequences with ground-truth identities: the port's
``tpu_cnn.apps.eval_tracking``.

``train.data.MovingScenes`` generates sequences whose per-frame ground
truth carries stable object identities; the detector runs once per frame
through the same emission policy the realtime loop uses
(``engine.cuda.detections_above`` / ``instance_detections`` with the
bundle's calibrated floors), and tracker configurations
(``head.tracker.Tracker``) are scored — and A/B'd — on identical cached
detections:

  * recall / precision (frame-level box matches, class-gated greedy IoU),
  * ID switches (a ground-truth object's matched track id changes),
  * fragmentation (interruptions inside an object's tracked span),
  * MOTA = 1 - (misses + false positives + ID switches) / GT boxes,
  * mostly-tracked fraction (objects matched >= 80% of their frames).

The reference has no tracking at all (its realtime loop is
frame-independent, ``software/realtime_detect.py:575-615``).

The detections come from ``apps.infer.make_engine``'s engine: a
``CUDAEngine`` backend's multi detect on ``--device``, or the host twins
on the host oracle's features with ``--mode cpu``.

Usage:
  python -m tpu_cnn_torch.apps.eval_tracking [--mode auto] [--n-seqs 8]
      [--n-frames 24] [--same-class] [--instances N] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_cnn_torch.apps.eval_detection import iou, multi_outputs
from tpu_cnn_torch.head.tracker import Tracker
from tpu_cnn_torch.models.cnn import FpgaCNN


def frame_scores(model: FpgaCNN, mode: str, imgs_u8: np.ndarray,
                 instances: int = 1, device: str = "cuda"):
    """Raw per-frame presence scores + boxes for a (N, s, s) u8 stack —
    the pre-threshold state, so emission policies (per-frame floors vs
    temporally smoothed scores, ``emit_detections``) can be A/B'd on
    identical cached model output. Returns (probs, boxes, inst_boxes,
    inst_counts) with the instance pair None when ``instances`` == 1."""
    from tpu_cnn_torch.apps.infer import make_engine

    engine = make_engine(model, mode, device)
    probs, boxes, inst_boxes, inst_counts = multi_outputs(
        model, engine, imgs_u8, instances=instances if instances > 1 else 1)
    return np.asarray(probs), np.asarray(boxes), inst_boxes, inst_counts


def emit_detections(probs, boxes, inst_boxes, inst_counts, thresh,
                    score_ema: float = 1.0):
    """Cached scores -> per-frame detections through the production
    emission policy. ``score_ema`` < 1 first smooths the presence scores
    along the frame axis (sm[t] = a*p[t] + (1-a)*sm[t-1], sm[0] = p[0])
    — a briefly-dipping score keeps emitting, at the cost of a lag on
    appearance/disappearance. Boxes stay per-frame (the CAM box of the
    CURRENT frame; only the gate is smoothed)."""
    from tpu_cnn_torch.engine.cuda import detections_above, instance_detections

    if score_ema < 1.0:
        sm = np.empty_like(probs)
        sm[0] = probs[0]
        for t in range(1, len(probs)):
            sm[t] = score_ema * probs[t] + (1 - score_ema) * sm[t - 1]
        probs = sm
    out = []
    for i in range(len(probs)):
        if inst_boxes is not None:
            out.append(instance_detections(probs[i], boxes[i],
                                           inst_boxes[i], inst_counts[i],
                                           thresh))
        else:
            out.append(detections_above(probs[i], boxes[i], thresh))
    return out


def frame_detections(model: FpgaCNN, mode: str, imgs_u8: np.ndarray,
                     thresh, instances: int = 1, device: str = "cuda"):
    """Per-frame detections [(cls, prob, box), ...] for a (N, s, s) u8
    stack, through the production emission policy (the same
    ``detections_above`` / ``instance_detections`` + calibrated floors
    that realtime/serve use)."""
    return emit_detections(*frame_scores(model, mode, imgs_u8, instances,
                                         device), thresh)


def score_tracker(seq_dets, seq_truths, make_tracker,
                  match_floor: float = 0.2):
    """Run ``make_tracker()`` over each sequence's cached detections and
    score against ground truth. ``seq_dets[i][t]`` = detections for
    sequence i frame t; ``seq_truths[i][t]`` = [(obj_id, cls, box), ...].
    Returns the metrics dict."""
    total_gt = misses = fps = idsw = frag = 0
    obj_frames: dict[tuple, list] = {}  # (seq, obj_id) -> [matched_id|None]
    for si, (dets_t, truth_t) in enumerate(zip(seq_dets, seq_truths)):
        tracker = make_tracker()
        last_id: dict[int, int] = {}  # obj_id -> last matched track id
        for dets, truth in zip(dets_t, truth_t):
            tracks = tracker.update(dets)
            total_gt += len(truth)
            # class-gated greedy best-IoU matching, ties by (track id,
            # gt order) — same determinism discipline as the tracker
            cand = sorted(
                ((iou(t.ibox(), box), ti, gi)
                 for ti, t in enumerate(tracks)
                 for gi, (oid, cls, box) in enumerate(truth)
                 if t.cls == cls),
                key=lambda c: (-c[0], tracks[c[1]].id, c[2]),
            )
            used_t: set[int] = set()
            used_g: set[int] = set()
            for v, ti, gi in cand:
                if v < match_floor:
                    break
                if ti in used_t or gi in used_g:
                    continue
                used_t.add(ti)
                used_g.add(gi)
                oid = truth[gi][0]
                tid = tracks[ti].id
                if oid in last_id and last_id[oid] != tid:
                    idsw += 1
                last_id[oid] = tid
                obj_frames.setdefault((si, oid), []).append(tid)
            for gi, (oid, _, _) in enumerate(truth):
                if gi not in used_g:
                    misses += 1
                    obj_frames.setdefault((si, oid), []).append(None)
            fps += len(tracks) - len(used_t)
    # fragmentation: interruptions strictly inside an object's span
    mostly_tracked = 0
    for frames in obj_frames.values():
        m = [f is not None for f in frames]
        if any(m):
            first, last = m.index(True), len(m) - 1 - m[::-1].index(True)
            inside = m[first:last + 1]
            frag += sum(1 for a, b in zip(inside, inside[1:])
                        if a and not b)
        if sum(m) >= 0.8 * len(m):
            mostly_tracked += 1
    matched = total_gt - misses
    return {
        "gt_boxes": total_gt,
        "recall": matched / max(total_gt, 1),
        "precision": matched / max(matched + fps, 1),
        "id_switches": idsw,
        "fragmentations": frag,
        "mota": 1.0 - (misses + fps + idsw) / max(total_gt, 1),
        "mostly_tracked": mostly_tracked / max(len(obj_frames), 1),
    }


def evaluate_tracking(model: FpgaCNN, mode: str = "auto", n_seqs: int = 8,
                      n_frames: int = 24, seed: int = 123,
                      same_class: bool = False, instances: int = 1,
                      speed: tuple[float, float] = (1.5, 3.5),
                      thresh=None, configs=None, verbose: bool = True,
                      scenes_cls=None, score_ema: float = 1.0,
                      ema_ab=(), device: str = "cuda"):
    """Score tracker configurations on identical cached detections over
    ``MovingScenes``. ``configs`` is [(name, make_tracker), ...]; default
    compares raw per-frame IDs, the production static-IoU tracker, and
    the constant-velocity variant.

    ``scenes_cls`` swaps the sequence source (``RealMovingScenes`` for
    real-photo tiles). ``score_ema`` < 1 smooths presence scores across
    frames before thresholding (see ``emit_detections``); ``ema_ab`` adds
    extra result rows scoring the PRODUCTION tracker at each listed EMA
    alpha on the same cached scores — the recall-lever A/B."""
    from tpu_cnn_torch.train.data import MovingScenes

    if model.head_mode != "bins":
        raise ValueError("tracking eval needs the spatial-bin head")
    if thresh is None:
        thresh = (model.multi_thresh if model.multi_thresh is not None
                  else 0.15)
    scenes_cls = scenes_cls or MovingScenes
    ds = scenes_cls(n_seqs=n_seqs, n_frames=n_frames, seed=seed,
                    img_size=model.config.img_size,
                    same_class=same_class, speed=speed)
    imgs, truths = ds.arrays()
    n, T, s, _ = imgs.shape
    u8 = np.round(imgs.reshape(n * T, s, s) * 255).astype(np.uint8)
    probs, boxes, ib, ic = frame_scores(model, mode, u8,
                                        instances=instances, device=device)

    def seq_detections(a):
        out = []
        for i in range(n):
            sl = slice(i * T, (i + 1) * T)
            out.append(emit_detections(
                probs[sl], boxes[sl],
                None if ib is None else ib[sl],
                None if ic is None else ic[sl], thresh, score_ema=a))
        return out

    seq_dets = seq_detections(score_ema)

    if configs is None:
        configs = [
            # fresh IDs every frame: what `realtime` WITHOUT --track shows
            ("raw (no tracking)", lambda: Tracker(
                iou_floor=1.1, max_age=0, min_hits=1, smooth=1.0)),
            ("static-IoU (production)", lambda: Tracker()),
            ("constant-velocity", lambda: Tracker(velocity=True)),
        ]
    results = {}
    for name, mk in configs:
        results[name] = score_tracker(seq_dets, truths, mk)
    for a in ema_ab:
        results[f"production + EMA {a:g}"] = score_tracker(
            seq_detections(a), truths, lambda: Tracker())
    if verbose:
        kind = "same-class" if same_class else "distinct-class"
        print(f"  sequences: {n} x {T} frames ({kind}, speed "
              f"{speed[0]:g}-{speed[1]:g} px/frame"
              f"{', instances=%d' % instances if instances > 1 else ''}"
              f"{', score-EMA %g' % score_ema if score_ema < 1 else ''})")
        hdr = (f"  {'config':26s} {'MOTA':>7s} {'recall':>7s} "
               f"{'prec':>7s} {'IDsw':>5s} {'frag':>5s} {'MT':>6s}")
        print(hdr)
        for name, r in results.items():
            print(f"  {name:26s} {r['mota']:7.3f} {r['recall']:7.3f} "
                  f"{r['precision']:7.3f} {r['id_switches']:5d} "
                  f"{r['fragmentations']:5d} {r['mostly_tracked']:6.2f}")
    return results


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns the results dict."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import MODES
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Tracking quality evaluation")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--mode", default="auto", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions (--mode cpu ignores it)")
    p.add_argument("--n-seqs", type=int, default=8)
    p.add_argument("--n-frames", type=int, default=24)
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--same-class", action="store_true",
                   help="all objects in a sequence share one class (the "
                        "class gate can't help; needs --instances > 1 to "
                        "emit per-object boxes)")
    p.add_argument("--instances", type=int, default=1,
                   help="per-class watershed instance boxes feed the "
                        "tracker (realtime --track --instances N)")
    p.add_argument("--speed", default="1.5,3.5",
                   help="object speed range, px/frame (min,max) — the "
                        "fast regime is where a motion model could pay")
    p.add_argument("--real", action="store_true",
                   help="sequences move REAL photograph tiles "
                        "(train.data.RealMovingScenes over val_bins) "
                        "instead of synthetic shapes")
    p.add_argument("--head-prefix", default="",
                   help="evaluate a prefixed head (e.g. real_)")
    p.add_argument("--score-ema", type=float, default=1.0,
                   help="smooth presence scores across frames with this "
                        "alpha before thresholding (1.0 = off)")
    p.add_argument("--ema-ab", default="",
                   help="comma list of EMA alphas to A/B on the "
                        "production tracker (e.g. 0.5,0.3)")
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    print("=" * 60)
    print("  TRACKING QUALITY EVALUATION")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant, args.head_prefix)
    lo, hi = (float(v) for v in args.speed.split(","))
    scenes_cls = None
    if args.real:
        from tpu_cnn_torch.train.data import RealMovingScenes

        scenes_cls = RealMovingScenes
        print("  sequences: REAL photograph tiles (val_bins)")
    ema_ab = tuple(float(a) for a in args.ema_ab.split(",") if a)
    return evaluate_tracking(model, mode=args.mode, n_seqs=args.n_seqs,
                             n_frames=args.n_frames, seed=args.seed,
                             same_class=args.same_class,
                             instances=args.instances, speed=(lo, hi),
                             scenes_cls=scenes_cls, score_ema=args.score_ema,
                             ema_ab=ema_ab, device=args.device)


if __name__ == "__main__":
    main()
