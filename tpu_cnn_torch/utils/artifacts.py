"""Artifact bundle I/O: the port's copy of ``tpu_cnn.utils.artifacts``.

A bundle directory holds:
  weights.bin   int8 conv weights (``utils.weights``)
  fc_weight.npy (num_classes, C|C*16) float32
  fc_bias.npy   (num_classes,) float32
  classes.json  class-name list
and optionally bbox_weight.npy, shifts.json, multi_thresh.json and
multi_head.npz; feature dumps are .npz files with features/labels/names/
shifts (``save_feature_dump``). Same formats, byte-compatible.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Sequence

import numpy as np

from tpu_cnn_torch.utils import weights as weights_codec


@dataclasses.dataclass
class ArtifactBundle:
    kernels: list[np.ndarray]  # per-layer (oc, ic, 3, 3) int8
    fc_weight: np.ndarray  # (num_classes, D) float32
    fc_bias: np.ndarray  # (num_classes,) float32
    class_names: list[str]
    # optional learned box-regression head (D+1, 4) f32, last row = bias —
    # beyond-reference: produced by apps.train_bbox, consumed by --box reg
    bbox_weight: np.ndarray | None = None
    # optional per-layer ReLU shifts the bundle's head was trained at
    # (apps.tune_shifts --save). The runtime register analogue of the
    # reference baking 2/4/6 into its scripts: CLI --shifts overrides,
    # absent file falls back to the variant's default ladder.
    shifts: list[int] | None = None
    # optional per-class multi-object detection thresholds
    # (apps.calibrate_multi --save): F1-calibrated floors, one per class.
    # Absent -> the uniform 0.15 default. When multi_head is present the
    # floors live in ITS sigmoid-score space, else in softmax-prob space.
    multi_thresh: list[float] | None = None
    # optional multi-label presence head (apps.calibrate_multi --fit-head):
    # (w (K, D), b (K,)) f32 — independent per-class sigmoids over the
    # same pooled features the classifier reads (ops.detect_head
    # .multi_scores). Replaces softmax probs as the --multi presence
    # score, breaking the sum-to-1 suppression between co-present objects.
    multi_head: tuple[np.ndarray, np.ndarray] | None = None


WEIGHTS_BIN = "weights.bin"
FC_WEIGHT = "fc_weight.npy"
FC_BIAS = "fc_bias.npy"
CLASSES = "classes.json"
BBOX_WEIGHT = "bbox_weight.npy"
SHIFTS_JSON = "shifts.json"
MULTI_THRESH_JSON = "multi_thresh.json"
MULTI_HEAD_NPZ = "multi_head.npz"


def load_bundle(artifact_dir: str | os.PathLike, prefix: str = "",
                layer_configs=None) -> ArtifactBundle:
    """Load a full artifact bundle from a directory.

    ``prefix`` selects an engine-specific head, e.g. ``arm_`` ->
    arm_fc_weight.npy (reference ``software/retrain_classifier.py:139-140``,
    ``software/realtime_detect.py:520-539``). ``layer_configs`` selects a
    non-stock geometry (models.registry variants).
    """
    d = os.fspath(artifact_dir)
    if layer_configs is not None:
        kernels = weights_codec.load_weights_bin(
            os.path.join(d, WEIGHTS_BIN), layer_configs
        )
    else:
        kernels = weights_codec.load_weights_bin(os.path.join(d, WEIGHTS_BIN))
    fc_w = np.load(os.path.join(d, prefix + FC_WEIGHT)).astype(np.float32)
    fc_b = np.load(os.path.join(d, prefix + FC_BIAS)).astype(np.float32)
    classes_path = os.path.join(d, CLASSES)
    if os.path.exists(classes_path):
        with open(classes_path) as f:
            class_names = json.load(f)
    else:
        class_names = [str(i) for i in range(fc_w.shape[0])]
    bbox_path = os.path.join(d, prefix + BBOX_WEIGHT)
    bbox_w = (
        np.load(bbox_path).astype(np.float32)
        if os.path.exists(bbox_path) else None
    )
    # prefix-scoped like every other per-head artifact: a bundle holding
    # several heads (--head-prefix) keeps each head's training shifts
    shifts_path = os.path.join(d, prefix + SHIFTS_JSON)
    shifts = None
    if os.path.exists(shifts_path):
        with open(shifts_path) as f:
            shifts = [int(s) for s in json.load(f)]
    mt_path = os.path.join(d, prefix + MULTI_THRESH_JSON)
    multi_thresh = None
    if os.path.exists(mt_path):
        with open(mt_path) as f:
            multi_thresh = [float(t) for t in json.load(f)]
    mh_path = os.path.join(d, prefix + MULTI_HEAD_NPZ)
    multi_head = None
    if os.path.exists(mh_path):
        mh = np.load(mh_path)
        multi_head = (mh["w"].astype(np.float32),
                      mh["b"].astype(np.float32))
    return ArtifactBundle(kernels, fc_w, fc_b, class_names,
                          bbox_weight=bbox_w, shifts=shifts,
                          multi_thresh=multi_thresh, multi_head=multi_head)


def save_bundle(
    artifact_dir: str | os.PathLike,
    bundle: ArtifactBundle,
    prefix: str = "",
) -> None:
    d = os.fspath(artifact_dir)
    os.makedirs(d, exist_ok=True)
    weights_codec.save_weights_bin(os.path.join(d, WEIGHTS_BIN), bundle.kernels)
    np.save(os.path.join(d, prefix + FC_WEIGHT), bundle.fc_weight.astype(np.float32))
    np.save(os.path.join(d, prefix + FC_BIAS), bundle.fc_bias.astype(np.float32))
    if bundle.bbox_weight is not None:
        np.save(os.path.join(d, prefix + BBOX_WEIGHT),
                bundle.bbox_weight.astype(np.float32))
    if bundle.shifts is not None:
        with open(os.path.join(d, prefix + SHIFTS_JSON), "w") as f:
            json.dump([int(s) for s in bundle.shifts], f)
    if bundle.multi_thresh is not None:
        with open(os.path.join(d, prefix + MULTI_THRESH_JSON), "w") as f:
            json.dump([float(t) for t in bundle.multi_thresh], f)
    if bundle.multi_head is not None:
        np.savez(os.path.join(d, prefix + MULTI_HEAD_NPZ),
                 w=bundle.multi_head[0].astype(np.float32),
                 b=bundle.multi_head[1].astype(np.float32))
    with open(os.path.join(d, CLASSES), "w") as f:
        json.dump(list(bundle.class_names), f)

def save_feature_dump(
    path: str | os.PathLike,
    features: np.ndarray,  # (N, 64, 256) uint8
    labels: np.ndarray,  # (N,) int
    names: Sequence[str],
    shifts: Sequence[int],
) -> None:
    """Write a feature dump .npz identical in schema to the reference
    (``software/dump_fpga_features.py:116-120``)."""
    np.savez(
        os.fspath(path),
        features=np.asarray(features, dtype=np.uint8),
        labels=np.asarray(labels),
        names=list(names),
        shifts=np.asarray(list(shifts)),
    )


def load_feature_dump(path: str | os.PathLike):
    data = np.load(os.fspath(path), allow_pickle=False)
    return (
        data["features"],
        data["labels"],
        [str(n) for n in data["names"]],
        data["shifts"] if "shifts" in data else None,
    )


def load_image_any(image_path: str | os.PathLike, img_size: int = 128) -> np.ndarray:
    """Load a .bin raw image or any PIL-supported format as flat uint8.

    Mirrors ``software/pynq_inference.py:414-425``.
    """
    path = os.fspath(image_path)
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bin":
        img = np.fromfile(path, dtype=np.uint8)
        if img.size != img_size * img_size:
            raise ValueError(f"expected {img_size * img_size} bytes, got {img.size}")
        return img
    from PIL import Image

    img = Image.open(path).convert("L").resize((img_size, img_size))
    return np.asarray(img, dtype=np.uint8).reshape(-1)


def label_from_filename(path: str) -> int:
    """Extract the true class from ``test_image_N_classC.bin`` names, else -1.

    Mirrors ``software/dump_fpga_features.py:66-69``.
    """
    base = os.path.basename(path)
    if "_class" in base:
        try:
            return int(base.split("_class")[1].split(".")[0])
        except ValueError:
            return -1
    return -1
