"""Quantitative detection evaluation — classification accuracy + bbox IoU:
the port's ``tpu_cnn.apps.eval_detection``.

The reference reports classification accuracy only (README.md:14); its CAM
boxes were never measured. The synthetic generator knows its shape
placements exactly, so this harness scores the full detector: per-class
accuracy, mean IoU of the CAM box against ground truth, and the IoU
advantage over the trivial full-frame box (what an uninformative CAM
degenerates to). ``--multi`` scores the multi-object head on 2-object
composite scenes (``evaluate_multi``), and with ``--instances N`` or
``--same-class`` the instance head by greedy per-class box matching
(``evaluate_instances``); ``--real`` composites real photograph tiles.

The engine comes from ``apps.infer.make_engine``: a ``CUDAEngine`` backend
on ``--device`` (its fused detect and multi detect), or with ``--mode cpu``
the host oracle, whose features go through the host head twins as in the
JAX CLI; ``--mode mesh`` is ``parallel.MeshEngine`` over ``--device``'s
devices.

Usage:
  python -m tpu_cnn_torch.apps.eval_detection [--n-per-class 30] [--mode auto]
  python -m tpu_cnn_torch.apps.eval_detection --device cpu --mode cpu
  python -m tpu_cnn_torch.apps.eval_detection --multi --instances 2 --same-class
"""

from __future__ import annotations

import argparse

import numpy as np

from tpu_cnn_torch.models.cnn import FpgaCNN
from tpu_cnn_torch.train.data import SyntheticShapes
from tpu_cnn_torch.utils.metrics import accuracy_report


def iou(a, b) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(0, ix2 - ix1), max(0, iy2 - iy1)
    inter = iw * ih
    area_a = (ax2 - ax1) * (ay2 - ay1)
    area_b = (bx2 - bx1) * (by2 - by1)
    return inter / max(area_a + area_b - inter, 1)


def _host_multi(model: FpgaCNN, feats: np.ndarray, box: str = "ref",
                instances: int = 1):
    """The host twins' multi-object outputs for (N, C, P) u8 features, as
    the JAX CLI computes them for an engine without a multi detect:
    (presence scores, per-class boxes, instance boxes, instance counts),
    the instance pair None when ``instances`` == 1."""
    from tpu_cnn_torch.head import cam as cam_host
    from tpu_cnn_torch.head.classify import (classify_np, multi_scores_np,
                                             pool_for_head)

    img_size = model.config.img_size
    if model.multi_head is not None:
        probs = multi_scores_np(pool_for_head(feats, model.fc_weight),
                                *model.multi_head)
    else:
        _, _, probs = classify_np(feats, model.fc_weight, model.fc_bias)
    boxes = np.stack([
        cam_host.cam_bbox_multi(
            feats[i], model.fc_weight, img_size=img_size,
            box_mode="centroid" if box == "centroid" else "ref")
        for i in range(len(feats))
    ])
    if instances == 1:
        return probs, boxes, None, None
    pairs = [cam_host.cam_instances(feats[i], model.fc_weight,
                                    img_size=img_size,
                                    max_instances=instances)
             for i in range(len(feats))]
    return (probs, boxes, np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]))


def multi_outputs(model: FpgaCNN, engine, u8: np.ndarray, box: str = "ref",
                  instances: int = 1):
    """(presence scores, per-class boxes, instance boxes, instance counts)
    for a (N, s, s) u8 stack: the engine's multi detect where it has one,
    else the host twins on its features. The presence scores are the
    bundle's multi-label head when it ships one (the floors live in its
    space), else the softmax probabilities."""
    if hasattr(engine, "detect_multi_batch"):
        res = engine.detect_multi_batch(u8, instances=instances)
        probs = res.scores if res.scores is not None else res.probs
        return probs, res.boxes, res.inst_boxes, res.inst_counts
    return _host_multi(model, engine.run_batch(u8), box, instances)


def evaluate(model: FpgaCNN, mode: str = "auto", n_per_class: int = 30,
             seed: int = 123, verbose: bool = True, box: str = "ref",
             device: str = "cuda"):
    """Returns dict(accuracy, mean_iou, full_frame_iou, per_class).

    ``box``: "ref" scores the reference CAM threshold box; "centroid" the
    tuned centroid profile (``detect_head.CAM_CENTROID_K``); "reg" the
    learned regression head (needs bbox_weight.npy — apps.train_bbox)."""
    from tpu_cnn_torch.apps.infer import make_engine

    if box == "reg" and model.bbox_weight is None:
        raise ValueError(
            "--box reg needs bbox_weight.npy in the artifact bundle — "
            "train one with: python -m tpu_cnn_torch.apps.train_bbox"
        )
    img_size = model.config.img_size
    ds = SyntheticShapes(n_per_class=n_per_class, seed=seed,
                         img_size=img_size)
    imgs, labels, gt_boxes = ds.arrays_with_boxes()
    u8 = np.round(imgs * 255).astype(np.uint8)

    engine = make_engine(model, mode, device, box_mode=box)
    if hasattr(engine, "detect_batch"):
        res = engine.detect_batch(u8)
        preds, boxes = res.pred, res.bbox
    else:
        from tpu_cnn_torch.head import cam as cam_host
        from tpu_cnn_torch.head.classify import bin_pool_np, classify_np

        feats = engine.run_batch(u8)
        preds, _, _ = classify_np(feats, model.fc_weight, model.fc_bias)
        if box == "reg":
            from tpu_cnn_torch.head.bbox import bbox_regress_np

            boxes = bbox_regress_np(bin_pool_np(feats), model.bbox_weight,
                                    model.config.img_size)
        else:
            box_fn = (cam_host.cam_bbox_centroid if box == "centroid"
                      else cam_host.cam_bbox_fast)
            boxes = np.asarray([
                box_fn(feats[i], int(preds[i]), model.fc_weight,
                       img_size=img_size)
                for i in range(len(u8))
            ])

    ious = np.asarray([iou(boxes[i], gt_boxes[i]) for i in range(len(u8))])
    full = (0, 0, img_size - 1, img_size - 1)
    base_ious = np.asarray([iou(full, gt_boxes[i]) for i in range(len(u8))])
    rep = accuracy_report(np.asarray(preds), labels, ds.class_names)
    out = {
        "accuracy": rep["accuracy"],
        "per_class": rep["per_class"],
        "mean_iou": float(ious.mean()),
        "full_frame_iou": float(base_ious.mean()),
        "iou_gain": float(ious.mean() - base_ious.mean()),
    }
    if verbose:
        print(f"  samples: {len(u8)} ({len(ds.class_names)} classes)")
        print(f"  accuracy: {out['accuracy'] * 100:.1f}%")
        for name, acc in out["per_class"].items():
            print(f"    {name:10s}: {acc * 100:.1f}%")
        print(f"  mean CAM-box IoU:   {out['mean_iou']:.3f}")
        print(f"  full-frame baseline: {out['full_frame_iou']:.3f} "
              f"(gain {out['iou_gain']:+.3f})")
    return out


def multi_scenes(model: FpgaCNN, n_scenes: int, seed: int = 123,
                 scenes_cls=None, **kw):
    """The composite scenes the multi evals score: (u8 (N, s, s), truths)
    from ``scenes_cls`` (default ``CompositeScenes``)."""
    from tpu_cnn_torch.train.data import CompositeScenes

    ds = (scenes_cls or CompositeScenes)(
        n_scenes=n_scenes, seed=seed, img_size=model.config.img_size, **kw)
    imgs, truths = ds.arrays()
    return np.round(imgs * 255).astype(np.uint8), truths


def evaluate_multi(model: FpgaCNN, mode: str = "auto", n_scenes: int = 60,
                   seed: int = 123, thresh=0.15, box: str = "ref",
                   verbose: bool = True, scenes_cls=None,
                   device: str = "cuda"):
    """Multi-object evaluation on composite scenes (2 objects/frame).

    Scores the beyond-reference multi head (one CAM box per class above
    ``thresh``): object recall, per-matched-object IoU, false positives per
    frame — against the single-box (argmax) detector, which by construction
    can recover at most one of the objects. Returns the metrics dict.
    ``scenes_cls`` swaps the scene source (``train.data.RealComposites``
    for real-photograph statistics)."""
    from tpu_cnn_torch.apps.infer import make_engine

    if model.head_mode != "bins":
        raise ValueError("multi-object eval needs the spatial-bin head")
    u8, truths = multi_scenes(model, n_scenes, seed, scenes_cls)
    engine = make_engine(model, mode, device, box_mode=box)
    probs, boxes, _, _ = multi_outputs(model, engine, u8, box)

    num_classes = probs.shape[1]
    thr = np.broadcast_to(np.asarray(thresh, np.float64), (num_classes,))
    total = hits = false_pos = argmax_hits = 0
    matched_ious, all_ious = [], []
    for i, truth in enumerate(truths):
        gt = {cls for cls, _ in truth}
        det = {k for k in range(num_classes) if probs[i, k] >= thr[k]}
        false_pos += len(det - gt)
        argmax_hits += int(int(np.argmax(probs[i])) in gt)
        for cls, gt_box in truth:
            total += 1
            if cls in det:
                hits += 1
                v = iou(tuple(boxes[i, cls]), gt_box)
                matched_ious.append(v)
                all_ious.append(v)
            else:
                all_ious.append(0.0)
    out = {
        "scenes": len(truths),
        "objects": total,
        "recall": hits / max(total, 1),
        "false_pos_per_frame": false_pos / max(len(truths), 1),
        "matched_iou": float(np.mean(matched_ious)) if matched_ious else 0.0,
        "overall_iou": float(np.mean(all_ious)) if all_ious else 0.0,
        # the single-box detector's ceiling on the same scenes: one argmax
        # box per frame, so recall is bounded by 1 object/frame
        "single_box_recall_ceiling": argmax_hits / max(total, 1),
    }
    if verbose:
        thr_s = (f"{float(np.ravel(thresh)[0]):.0%}"
                 if np.ndim(thresh) == 0 else "per-class calibrated")
        print(f"  scenes: {out['scenes']} ({total} objects, "
              f"thresh {thr_s})")
        print(f"  object recall:        {out['recall'] * 100:.1f}%")
        print(f"  matched-object IoU:   {out['matched_iou']:.3f}")
        print(f"  overall IoU (miss=0): {out['overall_iou']:.3f}")
        print(f"  false pos / frame:    {out['false_pos_per_frame']:.2f}")
        print(f"  single-box recall ceiling (argmax detector): "
              f"{out['single_box_recall_ceiling'] * 100:.1f}%")
    return out


def evaluate_instances(model: FpgaCNN, mode: str = "auto",
                       n_scenes: int = 60, seed: int = 123, thresh=0.15,
                       instances: int = 2, same_class: bool = False,
                       iou_floors=(0.1, 0.3), min_pixels: int | None = None,
                       min_frac: float | None = None, verbose: bool = True,
                       scenes_cls=None, device: str = "cuda"):
    """Multi-INSTANCE evaluation: per-component boxes greedily matched to
    ground-truth objects of the same class.

    Unlike :func:`evaluate_multi` (which credits a class hit to every GT
    object of that class and scores them all against ONE per-class box),
    this is a real detection metric: each emitted box can recover at most
    one GT object, recall is reported at IoU floors, and every unmatched
    emitted box counts as a false positive. ``same_class=True`` scenes
    put two objects of ONE class in each frame — the regime the per-class
    head cannot separate by construction."""
    from tpu_cnn_torch.apps.infer import make_engine
    from tpu_cnn_torch.ops import detect_head as _dh

    if min_pixels is None:
        min_pixels = _dh.INSTANCE_MIN_PIXELS
    if min_frac is None:
        min_frac = _dh.INSTANCE_MIN_FRAC
    if model.head_mode != "bins":
        raise ValueError("multi-object eval needs the spatial-bin head")
    u8, truths = multi_scenes(model, n_scenes, seed, scenes_cls,
                              same_class=same_class)
    engine = make_engine(model, mode, device)
    probs, boxes, inst_boxes, inst_counts = multi_outputs(
        model, engine, u8, instances=instances)

    num_classes = probs.shape[1]
    thr = np.broadcast_to(np.asarray(thresh, np.float64), (num_classes,))
    total = 0
    matched_ious = []  # best-IoU of each matched (det, gt) pair
    hits_at = {f: 0 for f in iou_floors}
    false_boxes = 0
    for i, truth in enumerate(truths):
        gt_by_cls: dict[int, list] = {}
        for cls, box in truth:
            gt_by_cls.setdefault(cls, []).append(box)
            total += 1
        for k in range(num_classes):
            if probs[i, k] < thr[k]:
                continue
            if inst_boxes is not None:
                floor = max(min_pixels, 1, int(np.ceil(
                    min_frac * int(np.max(inst_counts[i, k])))))
                det = [tuple(int(v) for v in b)
                       for b, c in zip(inst_boxes[i, k], inst_counts[i, k])
                       if c >= floor]
            else:
                det = []
            # <2 surviving instances = the class shows one object; the
            # union box is the better single box (instance_detections
            # applies the same policy)
            if len(det) < 2:
                det = [tuple(int(v) for v in boxes[i, k])]
            gts = list(gt_by_cls.get(k, []))
            # greedy best-IoU matching within the class
            cand = sorted(
                ((iou(d, g), di, gi) for di, d in enumerate(det)
                 for gi, g in enumerate(gts)),
                key=lambda t: -t[0],
            )
            used_d, used_g = set(), set()
            for v, di, gi in cand:
                if di in used_d or gi in used_g:
                    continue
                used_d.add(di)
                used_g.add(gi)
                matched_ious.append(v)
                for f in iou_floors:
                    hits_at[f] += int(v >= f)
            false_boxes += len(det) - len(used_d)
    out = {
        "scenes": len(truths),
        "objects": total,
        "instances": instances,
        "same_class": same_class,
        "matched_iou": float(np.mean(matched_ious)) if matched_ious else 0.0,
        "false_boxes_per_frame": false_boxes / max(len(truths), 1),
    }
    for f in iou_floors:
        out[f"recall@{f}"] = hits_at[f] / max(total, 1)
    if verbose:
        kind = "same-class" if same_class else "distinct-class"
        print(f"  scenes: {out['scenes']} ({total} objects, {kind}, "
              f"{instances} instances/class)")
        for f in iou_floors:
            print(f"  object recall @IoU>={f}: {out[f'recall@{f}'] * 100:.1f}%")
        print(f"  matched-pair IoU:      {out['matched_iou']:.3f}")
        print(f"  false boxes / frame:   {out['false_boxes_per_frame']:.2f}")
    return out


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns the metrics dict."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import MODES
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Detection quality evaluation")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--mode", default="auto", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions (--mode cpu ignores it)")
    p.add_argument("--n-per-class", type=int, default=30)
    p.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"],
                   help="box head: reference CAM threshold, tuned centroid, "
                        "or learned regression (bbox_weight.npy)")
    p.add_argument("--multi", action="store_true",
                   help="multi-object eval on 2-object composite scenes "
                        "(per-class CAM boxes; bins head only)")
    p.add_argument("--multi-thresh", type=float, default=None,
                   help="uniform floor (default: the bundle's calibrated "
                        "multi_thresh.json if present, else 0.15)")
    p.add_argument("--n-scenes", type=int, default=60,
                   help="composite scene count for --multi")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: up to N component boxes per class, "
                        "scored by greedy per-class box matching "
                        "(evaluate_instances)")
    p.add_argument("--same-class", action="store_true",
                   help="with --multi --instances: scenes place 2 objects "
                        "of the SAME class (the per-class head's blind "
                        "spot)")
    p.add_argument("--real", action="store_true",
                   help="with --multi: composite scenes from REAL "
                        "photograph tiles (artifacts/realphoto/val_bins) "
                        "instead of synthetic shapes")
    p.add_argument("--real-root", default=None,
                   help="with --real: tile directory (default the "
                        "held-out val_bins split)")
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)

    print("=" * 60)
    print("  DETECTION QUALITY EVALUATION")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant)
    scenes_cls = None
    if args.real:
        import functools

        from tpu_cnn_torch.train.data import RealComposites

        scenes_cls = (functools.partial(RealComposites, root=args.real_root)
                      if args.real_root else RealComposites)
        print("  scenes: REAL photograph composites "
              f"({args.real_root or 'val_bins'})")
    if args.multi:
        thresh = (args.multi_thresh if args.multi_thresh is not None
                  else (model.multi_thresh
                        if model.multi_thresh is not None else 0.15))
        if args.instances > 1 or args.same_class:
            return evaluate_instances(
                model, mode=args.mode, n_scenes=args.n_scenes, thresh=thresh,
                instances=max(args.instances, 1), same_class=args.same_class,
                scenes_cls=scenes_cls, device=args.device)
        return evaluate_multi(
            model, mode=args.mode, n_scenes=args.n_scenes, thresh=thresh,
            box="centroid" if args.box == "centroid" else "ref",
            scenes_cls=scenes_cls, device=args.device)
    return evaluate(model, mode=args.mode, n_per_class=args.n_per_class,
                    box=args.box, device=args.device)


if __name__ == "__main__":
    main()
