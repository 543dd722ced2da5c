"""Single/batch image inference CLI on the port's engine.

The ``tpu_cnn.apps.infer`` surface with ``CUDAEngine`` in place of the TPU
engine: one ``--image`` or a directory sweep of ``test_image_*_classC.bin``
scored against the filename labels. Classification and the printed box
come from ``tpu_cnn.apps.infer.run_inference`` (the host head on the
engine's features), unchanged.

Usage:
  python -m tpu_cnn_torch.apps.infer --image-dir artifacts/pretrained --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --image X.bin --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --variant lyr4-wide --device cuda --no-save
  python -m tpu_cnn_torch.apps.infer --mode pallas --device cuda --no-save

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

from tpu_cnn.apps.common import load_model
from tpu_cnn.apps.infer import run_inference
from tpu_cnn.utils import artifacts as art
from tpu_cnn.utils.paths import default_artifacts
from tpu_cnn_torch.engine.cuda import BACKENDS, CUDAEngine

NOT_PORTED = "not yet ported (ROADMAP A.7)"


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
    p.add_argument("--multi", action="store_true", help=NOT_PORTED)
    p.add_argument("--instances", type=int, default=1, help=NOT_PORTED)
    args = p.parse_args(argv)
    if args.multi or args.instances != 1:
        p.error(f"--multi/--instances: {NOT_PORTED}")
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
    engine = CUDAEngine(model, device=args.device, backend=args.mode,
                        box_mode=args.box)
    print(f"Engine: {type(engine).__name__} ({engine.backend})")
    print(f"Classifier: {len(model.class_names)} classes — {model.class_names} "
          f"[{model.head_mode} head]")

    if args.image:
        run_inference(engine, model, args.image, save_output=not args.no_save,
                      box=args.box)
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
        idx, _name, _conf = run_inference(engine, model, path,
                                          save_output=not args.no_save,
                                          box=args.box)
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
