"""Single/batch image inference CLI on the port's engines.

The ``tpu_cnn.apps.infer`` surface: one ``--image`` or a directory sweep of
``test_image_*_classC.bin`` scored against the filename labels, with
``--dump-features`` on a single image. The engine comes from
``make_engine``, the port's engine swap: ``CUDAEngine`` on a device
backend, or the host oracle ``CPURefEngine`` with ``--mode cpu``.
Classification and the printed box come from ``run_inference`` (the host
head on the engine's features), the port's copy of the JAX CLI's. With
``--multi`` each image's "Detections" lines come from the engine's
multi-object detect on the device (``CUDAEngine.detect_multi_batch``;
``--instances N`` adds the watershed instances), in the JAX CLI's format;
on ``--mode cpu`` from the host twins in ``run_inference``, as the JAX
CLI computes them. ``--instances`` without ``--multi`` is ignored, as there.

Usage:
  python -m tpu_cnn_torch.apps.infer --image-dir artifacts/pretrained --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --image X.bin --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --image X.bin --mode cpu --dump-features --no-save
  python -m tpu_cnn_torch.apps.infer --variant lyr4-wide --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --mode pallas --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --multi --instances 2 --device cuda --no-save

``--mode`` (``MODES``, the reference's flag): ``mega`` (default),
``pallas``, ``hybrid`` or ``xla`` run that ``CUDAEngine`` backend on
``--device``; ``auto`` resolves to ``mega`` where the chained plan fits
the geometry, else ``hybrid``; ``cpu`` runs the host oracle and ignores
``--device``; ``mesh`` is ``parallel.MeshEngine`` over every device of
``--device``'s type (one position per device: one on a one-card host, the
CPU with ``--device cpu``).

``--no-save`` skips the annotated JPEG (which needs PIL); raw ``.bin``
images need nothing beyond numpy.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.engine.cpu_ref import CPURefEngine
from tpu_cnn_torch.engine.cuda import (BACKENDS, DEFAULT_MULTI_THRESH, CUDAEngine,
                                       detections_above, instance_detections)
from tpu_cnn_torch.head import cam as cam_host
from tpu_cnn_torch.head import classify as classify_host
from tpu_cnn_torch.head.bbox import bbox_regress_features_np
from tpu_cnn_torch.models.cnn import FpgaCNN
from tpu_cnn_torch.ops import mega
from tpu_cnn_torch.utils import artifacts as art
from tpu_cnn_torch.utils.paths import default_artifacts

# the engine swap's modes: the CUDAEngine backends, "auto", the mesh and
# the host oracle
MODES = ("auto", *BACKENDS, "mesh", "cpu")


def auto_backend(model: FpgaCNN) -> str:
    """``--mode auto``'s backend: "mega" when the chained plan has a tail
    that fits the megakernel for the geometry, else "hybrid"."""
    return ("mega" if mega.mega_plan(model.config.layer_configs) is not None
            else "hybrid")


def make_engine(model: FpgaCNN, mode: str, device: str = "cuda",
                box_mode: str = "ref"):
    """The engine swap (reference ``--mode fpga|arm``,
    ``realtime_detect.py:556``): "cpu" is the host oracle
    (``CPURefEngine``, the native C++ oracle or numpy; ``device`` ignored);
    "mega", "pallas", "hybrid" and "xla" are that ``CUDAEngine`` backend on
    ``device``; "auto" is :func:`auto_backend`'s; "mesh" is
    ``parallel.MeshEngine`` (its own auto backend) over every device of
    ``device``'s type. ``box_mode`` picks the fused CAM box ("ref",
    "centroid", "reg"); the host oracle has no fused head, its callers
    pick the host twin themselves."""
    if mode == "cpu":
        return CPURefEngine(model.kernels, model.shifts)
    if mode == "mesh":
        from tpu_cnn_torch.parallel.mesh import MeshEngine, local_devices, make_mesh

        dev = torch.device(device)
        devices = [dev] if dev.type == "cpu" else local_devices()
        return MeshEngine(model, make_mesh(devices=devices), box_mode=box_mode)
    if mode == "auto":
        mode = auto_backend(model)
    if mode not in BACKENDS:
        raise ValueError(f"unknown mode {mode!r}: need one of {MODES}")
    return CUDAEngine(model, device=device, backend=mode, box_mode=box_mode)


def annotate_and_save(image_flat, bbox, label, out_path, img_size=128):
    """Green bbox + label band, the reference CLI's output format."""
    from PIL import Image, ImageDraw

    gray = image_flat.reshape(img_size, img_size)
    rgb = np.stack([gray, gray, gray], axis=2)
    img = Image.fromarray(rgb, "RGB")
    draw = ImageDraw.Draw(img)
    x1, y1, x2, y2 = bbox
    draw.rectangle([x1, y1, x2, y2], outline=(0, 255, 0), width=2)
    ty = max(0, y1 - 14)
    draw.rectangle([x1, ty, x1 + len(label) * 7, ty + 13], fill=(0, 255, 0))
    draw.text((x1 + 2, ty + 1), label, fill=(0, 0, 0))
    img.save(out_path, quality=95)


# one fixed colour per class index for multi-object overlays
MULTI_COLORS = [
    (0, 255, 0), (255, 160, 0), (80, 160, 255),
    (255, 80, 255), (255, 255, 0), (0, 255, 220),
]


def annotate_multi_and_save(image_flat, detections, class_names, out_path,
                            img_size=128):
    """One labelled box per detection (class_idx, prob, bbox) — the
    multi-object counterpart of :func:`annotate_and_save`."""
    from PIL import Image, ImageDraw

    gray = image_flat.reshape(img_size, img_size)
    rgb = np.stack([gray, gray, gray], axis=2)
    img = Image.fromarray(rgb, "RGB")
    draw = ImageDraw.Draw(img)
    for k, prob, (x1, y1, x2, y2) in detections:
        color = MULTI_COLORS[k % len(MULTI_COLORS)]
        label = f"{class_names[k]} {prob:.0%}"
        draw.rectangle([x1, y1, x2, y2], outline=color, width=2)
        ty = max(0, y1 - 14)
        draw.rectangle([x1, ty, x1 + len(label) * 7, ty + 13], fill=color)
        draw.text((x1 + 2, ty + 1), label, fill=(0, 0, 0))
    img.save(out_path, quality=95)


def run_inference(engine, model, image_path, verbose=True, save_output=True,
                  box: str = "ref", multi_thresh: float | None = None,
                  instances: int = 1):
    """One image through ``engine.run`` and the host head: classification,
    the printed box (``box``: "ref" the hi-res CAM box, "centroid", "reg")
    and, with ``multi_thresh``, the host twins' multi-object detections.
    Returns (class index, name, confidence)."""
    size = model.config.img_size
    image = art.load_image_any(image_path, img_size=size)
    feat, conv_ms, read_ms = engine.run(image)

    idx, name, conf, probs = classify_host.classify_np(
        feat, model.fc_weight, model.fc_bias, model.class_names
    )
    detections = None
    if multi_thresh is not None:
        sc = probs
        if model.multi_head is not None:
            sc = classify_host.multi_scores_np(
                classify_host.pool_for_head(feat, model.fc_weight),
                *model.multi_head)
        boxes_all = cam_host.cam_bbox_multi(
            feat, model.fc_weight, img_size=size,
            box_mode="centroid" if box == "centroid" else "ref",
        )
        if instances > 1:
            inst_boxes, inst_counts = cam_host.cam_instances(
                feat, model.fc_weight, img_size=size,
                max_instances=instances,
            )
            detections = instance_detections(
                sc, boxes_all, inst_boxes, inst_counts, multi_thresh
            )
        else:
            detections = detections_above(sc, boxes_all, multi_thresh)
    if box == "reg":
        bbox = bbox_regress_features_np(feat, model.bbox_weight, img_size=size)
    elif model.head_mode != "bins":
        bbox = (0, 0, size - 1, size - 1)
    elif box == "centroid":
        bbox = cam_host.cam_bbox_centroid(feat, idx, model.fc_weight,
                                          img_size=size)
    else:
        _, bbox = cam_host.cam_bbox_hires(feat, idx, model.fc_weight,
                                          img_size=size)

    if verbose:
        base = os.path.basename(image_path)
        true = art.label_from_filename(image_path)
        suffix = f" (true: class {true})" if true >= 0 else ""
        print(f"\n  Image:      {base}{suffix}")
        print(f"  Prediction: {name} (class {idx})")
        print(f"  Confidence: {conf:.1%}")
        print(f"  BBox:       ({bbox[0]}, {bbox[1]}) -> ({bbox[2]}, {bbox[3]})")
        if detections is not None:
            thr_s = (f"{multi_thresh:.0%}" if np.ndim(multi_thresh) == 0
                     else "per-class calibrated floors")
            print(f"  Detections (prob >= {thr_s}):")
            for k, prob, (x1, y1, x2, y2) in detections:
                print(f"    {model.class_names[k]:10s} {prob:5.1%}  "
                      f"({x1}, {y1}) -> ({x2}, {y2})")
        print(f"  Engine:     {conv_ms:.2f} ms compute + {read_ms:.2f} ms readout")
        top3 = np.argsort(probs)[::-1][:3]
        print("  Top-3:")
        for rank, i in enumerate(top3):
            print(f"    {rank + 1}. {model.class_names[i]}: {probs[i]:.1%}")

    if save_output:
        stem = os.path.splitext(os.path.basename(image_path))[0]
        out_path = os.path.join(
            os.path.dirname(os.path.abspath(image_path)), f"{stem}_result.jpg"
        )
        if detections is not None:
            annotate_multi_and_save(image, detections, model.class_names,
                                    out_path, img_size=size)
        else:
            annotate_and_save(image, bbox, f"{name} {conf:.0%}", out_path,
                              img_size=size)
        if verbose:
            print(f"  Output:     {out_path}")

    return idx, name, conf


def detection_lines(detections, class_names, multi_thresh) -> list[str]:
    """The JAX CLI's "Detections" block for one image's
    [(class_idx, prob, (x1, y1, x2, y2)), ...]."""
    thr_s = (f"{multi_thresh:.0%}" if np.ndim(multi_thresh) == 0
             else "per-class calibrated floors")
    return [f"  Detections (prob >= {thr_s}):"] + [
        f"    {class_names[k]:10s} {prob:5.1%}  ({x1}, {y1}) -> ({x2}, {y2})"
        for k, prob, (x1, y1, x2, y2) in detections]


def parse_detection_blocks(text: str) -> list[tuple[str, list[tuple]]]:
    """Each image's "Detections" block of an infer CLI's output (this one
    or the JAX CLI's), in image order: [(header, [(class name, prob in %,
    box text), ...]), ...]."""
    blocks, lines = [], text.splitlines()
    for i, ln in enumerate(lines):
        if not ln.startswith("  Detections (prob >= "):
            continue
        rows = []
        for row in lines[i + 1:]:
            if not row.startswith("    "):
                break
            name, prob, box = row.split(None, 2)
            rows.append((name, float(prob.rstrip("%")), box.strip()))
        blocks.append((ln, rows))
    return blocks


def _infer_one(engine, model, path, args, multi_thresh):
    """``run_inference`` for the single-box part, then, with ``--multi``,
    the device's multi-object detections of the same image. An engine
    without a multi detect (the host oracle) gets them from the host twins
    inside ``run_inference``, as the JAX CLI does."""
    if args.multi and not hasattr(engine, "detect_multi_batch"):
        return run_inference(engine, model, path, save_output=not args.no_save,
                             box=args.box, multi_thresh=multi_thresh,
                             instances=args.instances)
    idx, name, conf = run_inference(
        engine, model, path, save_output=not args.no_save and not args.multi,
        box=args.box)
    if args.multi:
        image = art.load_image_any(path, img_size=model.config.img_size)
        res = engine.detect_multi_batch(image[None], instances=args.instances)
        dets = res.detections(multi_thresh)[0]
        print("\n".join(detection_lines(dets, model.class_names, multi_thresh)))
        if not args.no_save:
            stem = os.path.splitext(os.path.basename(path))[0]
            out = os.path.join(os.path.dirname(os.path.abspath(path)),
                               f"{stem}_result.jpg")
            annotate_multi_and_save(image, dets, model.class_names, out,
                                    img_size=model.config.img_size)
            print(f"  Output:     {out}")
    return idx, name, conf


def main(argv=None):
    p = argparse.ArgumentParser(description="CNN inference on the CUDA port")
    p.add_argument("--artifacts", default=None,
                   help="dir with weights.bin + fc_*.npy + classes.json "
                        "(default: the repo's pretrained bundle)")
    p.add_argument("--head-prefix", default="")
    p.add_argument("--image", default=None, help="single image (.bin/.jpg/.png)")
    p.add_argument("--image-dir", default=None, help="directory of test_image_*.bin")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions")
    p.add_argument("--mode", default="mega", choices=MODES,
                   help="engine: mega (whole-net kernel), pallas (the conv "
                        "kernel on every layer), hybrid (on layer 0 only), "
                        "xla (plain contract, no kernel), auto (mega where "
                        "it fits, else hybrid), or cpu (the host oracle, "
                        "native C++ or numpy; --device ignored)")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--shifts", default=None,
                   help="comma list, one per layer (default: the bundle's "
                        "shifts.json if present, else the variant ladder)")
    p.add_argument("--dump-features", action="store_true",
                   help="with --image: also save the engine's features as "
                        "<image stem>_features.npy")
    p.add_argument("--variant", default="lyr3-std",
                   help="model geometry from models.registry")
    p.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"])
    p.add_argument("--multi", action="store_true",
                   help="multi-object mode: one CAM box per class above "
                        "--multi-thresh, from the device (bins head only)")
    p.add_argument("--multi-thresh", type=float, default=None,
                   help="uniform floor for --multi detections (default: the "
                        "bundle's calibrated per-class multi_thresh.json if "
                        "present, else 0.15)")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: up to N watershed component boxes per "
                        "class, so two objects of one class get two boxes "
                        "(default 1)")
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    shifts = ([int(s) for s in args.shifts.split(",")]
              if args.shifts is not None else None)

    print("=" * 60)
    print("  CNN — INFERENCE (PyTorch/CUDA port)")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant, args.head_prefix,
                       shifts=shifts)
    if args.box == "reg" and model.bbox_weight is None:
        p.error("--box reg needs bbox_weight.npy in the bundle")
    if args.multi and model.head_mode != "bins":
        p.error("--multi needs the spatial-bin head (a (C, C*16) fc_weight); "
                "the 64-d GAP head has no per-class spatial CAM")
    if args.multi and args.instances < 1:
        p.error("--instances must be >= 1")
    multi_thresh = args.multi_thresh
    if multi_thresh is None:
        multi_thresh = (model.multi_thresh if model.multi_thresh is not None
                        else DEFAULT_MULTI_THRESH)
    engine = make_engine(model, args.mode, args.device, box_mode=args.box)
    print(f"Engine: {type(engine).__name__} ({engine.backend})")
    print(f"Classifier: {len(model.class_names)} classes — {model.class_names} "
          f"[{model.head_mode} head]")

    if args.image:
        _infer_one(engine, model, args.image, args, multi_thresh)
        if args.dump_features:
            feat, *_ = engine.run(art.load_image_any(
                args.image, img_size=model.config.img_size))
            out = os.path.splitext(args.image)[0] + "_features.npy"
            np.save(out, feat)
            print(f"  Features saved: {out}")
        return

    image_dir = args.image_dir or args.artifacts
    images = sorted(glob.glob(os.path.join(image_dir, "test_image_*.bin")))
    if not images:
        print(f"\nNo test images found in {image_dir}")
        return
    print(f"\nClassifying {len(images)} images...")
    correct = total = 0
    t0 = time.time()
    for path in images:
        idx, _name, _conf = _infer_one(engine, model, path, args,
                                       multi_thresh)
        true = art.label_from_filename(path)
        if true >= 0:
            total += 1
            correct += int(idx == true)
    dt = time.time() - t0
    print("\n" + "=" * 60)
    print("  RESULTS")
    print("=" * 60)
    print(f"  Images: {len(images)}  ({dt / max(len(images), 1) * 1e3:.1f} ms/image)")
    if total:
        print(f"  Accuracy: {correct}/{total} = {100 * correct / total:.1f}%")
    print("=" * 60)


if __name__ == "__main__":
    main()
