"""Single/batch image inference CLI on the port's engine.

The ``tpu_cnn.apps.infer`` surface with ``CUDAEngine`` in place of the TPU
engine: one ``--image`` or a directory sweep of ``test_image_*_classC.bin``
scored against the filename labels. Classification and the printed box
come from ``tpu_cnn.apps.infer.run_inference`` (the host head on the
engine's features), unchanged. With ``--multi`` each image's
"Detections" lines come from the engine's multi-object detect on the
device (``CUDAEngine.detect_multi_batch``; ``--instances N`` adds the
watershed instances), in the JAX CLI's format; ``--instances`` without
``--multi`` is ignored, as there.

Usage:
  python -m tpu_cnn_torch.apps.infer --image-dir artifacts/pretrained --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --image X.bin --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --variant lyr4-wide --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --mode pallas --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --multi --instances 2 --device cuda --no-save

``--mode`` picks the engine's backend (``CUDAEngine`` ``BACKENDS``, the
reference's flag name): ``mega`` (default), ``pallas``, ``hybrid`` or
``xla``. It is orthogonal to ``--device``.

``--no-save`` skips the annotated JPEG (which needs PIL); raw ``.bin``
images need nothing beyond numpy.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from tpu_cnn.apps.common import load_model
from tpu_cnn.apps.infer import annotate_multi_and_save, run_inference
from tpu_cnn.utils import artifacts as art
from tpu_cnn.utils.paths import default_artifacts
from tpu_cnn_torch.engine.cuda import BACKENDS, DEFAULT_MULTI_THRESH, CUDAEngine


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
    the device's multi-object detections of the same image."""
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
    p.add_argument("--mode", default="mega", choices=BACKENDS,
                   help="engine backend: mega (whole-net kernel), pallas "
                        "(the conv kernel on every layer), hybrid (on layer "
                        "0 only) or xla (plain contract, no kernel)")
    p.add_argument("--no-save", action="store_true")
    p.add_argument("--shifts", default=None,
                   help="comma list, one per layer (default: the bundle's "
                        "shifts.json if present, else the variant ladder)")
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
    engine = CUDAEngine(model, device=args.device, backend=args.mode,
                        box_mode=args.box)
    print(f"Engine: {type(engine).__name__} ({engine.backend})")
    print(f"Classifier: {len(model.class_names)} classes — {model.class_names} "
          f"[{model.head_mode} head]")

    if args.image:
        _infer_one(engine, model, args.image, args, multi_thresh)
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
