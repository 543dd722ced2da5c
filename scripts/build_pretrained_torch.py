"""Build a self-contained pretrained bundle with the PyTorch port — the
port of ``scripts/build_pretrained.py``.

The artifact pipeline with no external dataset: two-phase QAT training on
the procedural shapes set (``SyntheticShapes(seed=7)``), the export of the
weights.bin / fc / classes bundle and labelled test images, then the
dump -> retrain loop that fits the production (6, 1024) spatial-bin head
on the exported test images' features and an extra procedural set
(``SyntheticShapes(n_per_class=60, seed=11)``; lr 0.01, 900 epochs). Every
step is the port's own: ``train.train_cnn.train``, ``apps.dump_features``,
``apps.infer.make_engine``, ``head.classify.bin_pool_np`` and
``apps.retrain_classifier``. The bundle goes to ``build/pretrained_torch/``
by default, never over the shipped ``artifacts/pretrained``.

Run:  python scripts/build_pretrained_torch.py [--epochs 12] [--n-per-class 120]
          [--mode auto] [--device cuda] [--out build/pretrained_torch]
          [--init-from tests/data/jax_init_lyr3-std_seed0.f32]

``--init-from`` starts phase 1 from a carried draw (little-endian f32, the
JAX trainer's parameters flattened in conv0.., fc_w, fc_b order) instead of
the port's own ``init_params`` draw, which differs from ``jax.random``'s.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.apps.dump_features import dump_features  # noqa: E402
from tpu_cnn_torch.apps.infer import make_engine  # noqa: E402
from tpu_cnn_torch.apps.retrain_classifier import (report,  # noqa: E402
                                                   train_linear_classifier)
from tpu_cnn_torch.head.classify import bin_pool_np  # noqa: E402
from tpu_cnn_torch.train import data as D  # noqa: E402
from tpu_cnn_torch.train.train_cnn import TrainConfig, train  # noqa: E402

DEFAULT_OUT = os.path.join(ROOT, "build", "pretrained_torch")


def flat_draw(path: str, cfg: TrainConfig) -> dict[str, np.ndarray]:
    """A carried parameter draw (little-endian f32, conv0.., fc_w, fc_b
    flattened in order) as the trainer's parameter dict for ``cfg``'s
    geometry and its GAP head."""
    shapes = {f"conv{i}": (oc, ic, 3, 3)
              for i, (ic, oc, _) in enumerate(cfg.layer_configs)}
    shapes.update(fc_w=(cfg.num_classes, cfg.layer_configs[-1][1]),
                  fc_b=(cfg.num_classes,))
    flat = np.fromfile(path, "<f4")
    sizes = [int(np.prod(s)) for s in shapes.values()]
    if flat.size != sum(sizes):
        raise ValueError(f"{path}: {flat.size} floats, the geometry needs "
                         f"{sum(sizes)}")
    parts = np.split(flat, np.cumsum(sizes)[:-1])
    return {k: v.reshape(s) for (k, s), v in zip(shapes.items(), parts)}


def build(out: str, epochs: int = 12, n_per_class: int = 120,
          mode: str = "auto", device: str = "cuda", init=None,
          verbose: bool = True) -> float:
    """The pipeline into ``out``; returns the retrained head's accuracy
    (%) on its own training features, as the JAX script reports it."""
    ds = D.SyntheticShapes(n_per_class=n_per_class, seed=7)
    imgs, labels = ds.arrays()
    n_val = len(imgs) // 6
    cfg = TrainConfig(epochs=epochs, batch_size=64, head_epochs=400)

    print("== phase 1+2: QAT training + export ==")
    train(cfg, (imgs[n_val:], labels[n_val:]), (imgs[:n_val], labels[:n_val]),
          out, class_names=ds.class_names, device=device, init=init,
          verbose=verbose)

    print("\n== dump -> retrain: production (6, 1024) spatial-bin head ==")
    model = load_model(out)
    paths = sorted(glob.glob(os.path.join(out, "test_image_*.bin")))
    # widen the head-training set beyond the exported test images
    extra = D.SyntheticShapes(n_per_class=60, seed=11)
    eimgs, elabels = extra.arrays()
    features, flabels, _ = dump_features(model, paths, mode=mode,
                                         verbose=verbose, device=device)
    engine = make_engine(model, mode, device)
    eu8 = np.round(eimgs * 255).astype(np.uint8)
    efeats = np.concatenate(
        [engine.run_batch(eu8[s:s + 64]) for s in range(0, len(eu8), 64)])
    all_feats = np.concatenate([features, efeats])
    all_labels = np.concatenate([flabels, elabels])

    pooled = bin_pool_np(all_feats)
    w, bias = train_linear_classifier(pooled, all_labels, cfg.num_classes,
                                      lr=0.01, epochs=900, verbose=verbose,
                                      device=device)
    acc = report(pooled, all_labels, w, bias, ds.class_names)
    np.save(os.path.join(out, "fc_weight.npy"), w)
    np.save(os.path.join(out, "fc_bias.npy"), bias)
    return acc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--n-per-class", type=int, default=120)
    p.add_argument("--out", default=DEFAULT_OUT)
    p.add_argument("--mode", default="auto", help="engine for the feature dump")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--init-from", default=None,
                   help="start phase 1 from this carried draw (f32 file)")
    args = p.parse_args(argv)
    if os.path.realpath(args.out) == os.path.realpath(
            os.path.join(ROOT, "artifacts", "pretrained")):
        p.error("--out must not be the shipped bundle (artifacts/pretrained), "
                "which the tests read")
    init = flat_draw(args.init_from, TrainConfig()) if args.init_from else None
    t0 = time.perf_counter()
    acc = build(args.out, args.epochs, args.n_per_class, args.mode,
                args.device, init)
    print(f"\nBundle complete in {args.out}/ (head acc {acc:.1f}%, "
          f"{time.perf_counter() - t0:.1f} s on {args.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
