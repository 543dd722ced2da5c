"""Train the learned box-regression head (``--box reg``): the port's
``tpu_cnn.apps.train_bbox``.

The reference localises with CAM thresholding only; this app fits a linear
map from the classifier's own spatial-bin-pooled features to box corners —
the same dump->retrain idiom the reference uses for its classifier
(``software/retrain_classifier.py``), applied to localisation. Training
data: the synthetic generator (it knows its shape placements exactly).

Closed-form ridge regression (``head.bbox.fit_bbox_head``) with the
regulariser picked on an internal validation split; reports held-out mean
IoU against the trivial full-frame baseline, then writes
``bbox_weight.npy`` ((D+1, 4) float32, bias last) into the artifact bundle.

The pooled features come from ``apps.infer.make_engine``'s engine: on a
``CUDAEngine`` its ``run_batch_pooled`` (on ``mega`` the megakernel's
fused bins, the feature map never written), on the host oracle
(``--mode cpu``, the default) ``bin_pool_np`` of its features.

Usage:
  python -m tpu_cnn_torch.apps.train_bbox [--mode cpu] [--n-per-class 80]
  python -m tpu_cnn_torch.apps.train_bbox --mode mega --device cuda
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tpu_cnn_torch.head.bbox import bbox_regress_np, fit_bbox_head
from tpu_cnn_torch.head.classify import bin_pool_np


def _pooled_features(engine, u8):
    if hasattr(engine, "run_batch_pooled"):
        return engine.run_batch_pooled(u8)
    return bin_pool_np(engine.run_batch(u8))


def train(model, mode: str = "cpu", n_per_class: int = 80, seed: int = 7,
          lams=(0.1, 0.3, 1.0, 3.0, 10.0), verbose: bool = True,
          device: str = "cuda"):
    """Fit on a synthetic split (seed), pick lambda on an internal val cut,
    score held-out on the eval_detection split (seed 123). Returns
    (bbox_weight (D+1, 4), held-out mean IoU)."""
    from tpu_cnn_torch.apps.eval_detection import iou
    from tpu_cnn_torch.apps.infer import make_engine
    from tpu_cnn_torch.train.data import SyntheticShapes

    img_size = model.config.img_size
    engine = make_engine(model, mode, device)

    def split(s, n):
        ds = SyntheticShapes(n_per_class=n, seed=s, img_size=img_size)
        imgs, _, gt = ds.arrays_with_boxes()
        u8 = np.round(imgs * 255).astype(np.uint8)
        return _pooled_features(engine, u8), np.asarray(gt, np.float32)

    Xt, Bt = split(seed, n_per_class)
    Xe, Be = split(123, 30)  # the eval_detection split

    rng = np.random.RandomState(0)
    idx = rng.permutation(len(Xt))
    n_val = max(8, len(Xt) // 5)
    vi, ti = idx[:n_val], idx[n_val:]

    def mean_iou(W, X, B):
        P = bbox_regress_np(X, W, img_size)
        return float(np.mean([iou(P[i], B[i]) for i in range(len(B))]))

    best = (None, -1.0, None)
    for lam in lams:
        W = fit_bbox_head(Xt[ti], Bt[ti], img_size, lam=lam)
        v = mean_iou(W, Xt[vi], Bt[vi])
        if verbose:
            print(f"  lam={lam:6.2f}: val IoU {v:.3f}")
        if v > best[1]:
            best = (lam, v, W)
    lam, _, _ = best
    # refit on the full training split with the chosen regulariser
    W = fit_bbox_head(Xt, Bt, img_size, lam=lam)
    held = mean_iou(W, Xe, Be)
    if verbose:
        full = (0, 0, img_size - 1, img_size - 1)
        base = float(np.mean([iou(full, Be[i]) for i in range(len(Be))]))
        print(f"  chosen lam={lam}; held-out mean IoU {held:.3f} "
              f"(full-frame baseline {base:.3f})")
    return W, held


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns (bbox_weight,
    held-out mean IoU)."""
    from tpu_cnn_torch.apps.common import add_variant_arg, load_model
    from tpu_cnn_torch.apps.infer import MODES
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Train the box-regression head")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--output-dir", default=None,
                   help="where to write bbox_weight.npy (default: --artifacts)")
    p.add_argument("--mode", default="cpu", choices=MODES)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the hand-written kernels; cpu their plain "
                        "PyTorch versions (--mode cpu ignores it)")
    p.add_argument("--n-per-class", type=int, default=80)
    p.add_argument("--seed", type=int, default=7)
    add_variant_arg(p)
    args = p.parse_args(argv)
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    out_dir = args.output_dir or args.artifacts

    print("=" * 60)
    print("  BOX-REGRESSION HEAD TRAINING")
    print("=" * 60)
    model = load_model(args.artifacts, args.variant)
    W, held = train(model, mode=args.mode, n_per_class=args.n_per_class,
                    seed=args.seed, device=args.device)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "bbox_weight.npy")
    np.save(out, W.astype(np.float32))
    print(f"Saved: {out} {W.shape} (held-out mean IoU {held:.3f})")
    return W, held


if __name__ == "__main__":
    main()
