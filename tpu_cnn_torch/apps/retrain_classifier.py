"""Classifier retrainer, the dump->retrain loop's second half: the port of
``tpu_cnn.apps.retrain_classifier``.

Trains the (num_classes, 1024) spatial-bin linear head on dumped features.
``--optimizer ref`` (the default) reproduces the reference trainer's
semantics (``software/retrain_classifier.py:24-124``): softmax
cross-entropy with inverse-frequency class weights, full-batch SGD +
momentum 0.9, L2 1e-3, LR halved every 300 epochs, best-validation weights
(checked every 100 epochs), seed-42 80/20 split, as plain tensor ops with
the gradients written out, on ``--device``. ``--optimizer adam`` is the
trainer's Adam head fit (``train.train_cnn.fit_head``).

Usage:
  python -m tpu_cnn_torch.apps.retrain_classifier --features tpu_features.npz
  python -m tpu_cnn_torch.apps.retrain_classifier --features f.npz --optimizer adam --device cpu
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from tpu_cnn_torch.head.classify import bin_pool_np
from tpu_cnn_torch.train.train_cnn import exact_float, resolve_device
from tpu_cnn_torch.utils import artifacts as art


def _train_loop(X_train, y_train, X_val, y_val, sample_w, W, b, lr: float,
                epochs: int, eval_every: int = 100):
    """The reference SGD loop on tensors of one device: returns the best
    (W (D, K), b (K,), val accuracy), -1 when no evaluation ran."""
    n_t = X_train.shape[0]
    reg, momentum = 1e-3, 0.9
    rows = torch.arange(n_t, device=X_train.device)
    vW, vb = torch.zeros_like(W), torch.zeros_like(b)
    best = (-1.0, W.clone(), b.clone())
    for epoch in range(epochs):
        logits = X_train @ W + b
        logits = logits - logits.max(dim=1, keepdim=True).values
        dlogits = torch.softmax(logits, dim=1)
        dlogits[rows, y_train] -= 1.0
        dlogits = dlogits * sample_w[:, None] / n_t
        dW = X_train.T @ dlogits + reg * W
        db = dlogits.sum(dim=0)
        vW = momentum * vW - lr * dW
        vb = momentum * vb - lr * db
        W, b = W + vW, b + vb
        if (epoch + 1) % eval_every == 0:
            acc = float(((X_val @ W + b).argmax(dim=1) == y_val).float().mean())
            if acc > best[0]:
                best = (acc, W.clone(), b.clone())
        if (epoch + 1) % 300 == 0:
            lr = float(np.float32(lr) * np.float32(0.5))
    return best[1], best[2], best[0]


def train_linear_classifier(
    features: np.ndarray,  # (N, D) float32 pooled
    labels: np.ndarray,  # (N,)
    num_classes: int,
    lr: float = 0.01,
    epochs: int = 1000,
    val_split: float = 0.2,
    seed: int = 42,
    verbose: bool = True,
    device="cuda",
):
    """Returns (weight (C, D), bias (C,)), PyTorch convention like the
    reference (``retrain_classifier.py:124``)."""
    dev = resolve_device(device)
    n, d = features.shape
    rng = np.random.RandomState(seed)
    idx = rng.permutation(n)
    n_val = max(1, int(n * val_split))
    val_idx, train_idx = idx[:n_val], idx[n_val:]
    X_train, y_train = features[train_idx], labels[train_idx]
    X_val, y_val = features[val_idx], labels[val_idx]

    counts = np.maximum(np.bincount(y_train, minlength=num_classes), 1).astype(np.float32)
    class_w = (1.0 / counts)
    class_w = class_w / class_w.sum() * num_classes
    sample_w = class_w[y_train]

    W0 = (rng.randn(d, num_classes) * 0.01).astype(np.float32)
    b0 = np.zeros(num_classes, np.float32)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    with exact_float():
        bW, bb, best_acc = _train_loop(
            t(X_train), t(y_train, torch.int64), t(X_val), t(y_val, torch.int64),
            t(sample_w), t(W0), t(b0), float(np.float32(lr)), epochs)
    if verbose:
        print(f"  best val acc: {best_acc * 100:.1f}%")
    return (bW.T.cpu().numpy().astype(np.float32),
            bb.cpu().numpy().astype(np.float32))


def report(pooled, labels, W, bias, class_names):
    """Post-training evaluation: overall accuracy, per-class recall with a
    gauge bar, and a true->predicted count matrix."""
    preds = (pooled @ W.T + bias).argmax(axis=1)
    acc = float((preds == labels).mean()) * 100
    classes = [int(c) for c in np.unique(labels)]
    name_of = {c: (class_names[c] if class_names else f"class{c}")
               for c in classes}
    pad = max(len(n) for n in name_of.values())

    print(f"\n== evaluation on {len(labels)} samples ==")
    print(f"overall accuracy: {acc:.1f}%\n")
    for c in classes:
        hits = preds[labels == c] == c
        r = float(hits.mean()) if hits.size else 0.0
        gauge = "#" * round(r * 24)
        print(f"  {name_of[c].ljust(pad)}  {r * 100:6.1f}%  "
              f"|{gauge:<24}|  n={int(hits.size)}")

    print("\nconfusion (true row -> predicted column):")
    print("  " + " " * pad + "  " + " ".join(f"{name_of[c][:6]:>6}" for c in classes))
    for t in classes:
        counts = [int((preds[labels == t] == p).sum()) for p in classes]
        print(f"  {name_of[t].ljust(pad)}  " + " ".join(f"{n:>6}" for n in counts))
    return acc


def main(argv=None):
    """The JAX CLI's flags plus ``--device``; returns (weight, bias,
    accuracy on the whole dump in %)."""
    from tpu_cnn_torch.utils.paths import default_artifacts

    p = argparse.ArgumentParser(description="Retrain classifier on dumped features")
    p.add_argument("--features", default="tpu_features.npz")
    p.add_argument("--output-dir", default="artifacts/generated")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the head fit runs (cpu only when asked)")
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--epochs", type=int, default=1500)
    p.add_argument("--classes",
                   default=os.path.join(default_artifacts(), "classes.json"),
                   help="class-name override when the feature dump has none")
    p.add_argument("--prefix", default="", help="e.g. 'arm_' -> arm_fc_weight.npy")
    p.add_argument("--optimizer", default="ref", choices=("ref", "adam"),
                   help="ref (default) = the reference trainer's exact "
                        "semantics (SGD momentum 0.9, L2 1e-3, LR "
                        "halving). adam = the trainer's unregularized "
                        "adaptive Adam head fit (beyond-reference) — "
                        "converges where the reference recipe under-fits "
                        "hard feature matrices")
    args = p.parse_args(argv)

    print("=" * 60)
    print("  RETRAIN CLASSIFIER ON DUMPED FEATURES")
    print("=" * 60)
    features, labels, names, shifts = art.load_feature_dump(args.features)
    valid = labels >= 0
    features, labels = features[valid], labels[valid]
    print(f"  Samples: {features.shape[0]}  shifts: {shifts}")

    ch_means = features.astype(float).mean(axis=(0, 2))
    print(f"  Feature range: [{features.min()}, {features.max()}]  "
          f"mean {features.astype(float).mean():.2f}  "
          f"nonzero {(features > 0).mean() * 100:.1f}%  "
          f"active ch {(ch_means > 1.0).sum()}/{features.shape[1]}")

    pooled = bin_pool_np(features)  # (N, 1024) in [0, 1]
    num_classes = int(labels.max()) + 1
    class_names = None
    if os.path.exists(args.classes):
        with open(args.classes) as f:
            class_names = json.load(f)

    if args.optimizer == "adam":
        from tpu_cnn_torch.train.train_cnn import TrainConfig, fit_head

        # --epochs is the per-chunk step count here; fit_head runs up to
        # 10 chunks, keeping the chunk-boundary best-val weights
        print(f"\nTraining linear head (adam, lr={args.lr}, "
              f"{args.epochs}-step chunks, best-val) on "
              f"{pooled.shape} features...")
        cfg = TrainConfig(num_classes=num_classes, head_lr=args.lr,
                          head_epochs=args.epochs)
        W, bias = fit_head(pooled.astype(np.float32), labels, cfg,
                           device=args.device)
    else:
        print(f"\nTraining linear head (ref, lr={args.lr}, "
              f"epochs={args.epochs}) on {pooled.shape} features...")
        W, bias = train_linear_classifier(
            pooled, labels, num_classes, lr=args.lr, epochs=args.epochs,
            device=args.device)
    acc = report(pooled, labels, W, bias, class_names)

    os.makedirs(args.output_dir, exist_ok=True)
    wp = os.path.join(args.output_dir, f"{args.prefix}fc_weight.npy")
    bp = os.path.join(args.output_dir, f"{args.prefix}fc_bias.npy")
    np.save(wp, W)
    np.save(bp, bias)
    print(f"\nSaved: {wp} {W.shape}\n       {bp} {bias.shape}")
    return W, bias, acc


if __name__ == "__main__":
    main()
