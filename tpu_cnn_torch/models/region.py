"""Detectors with a region head: darknet's YOLOv2 family on the port's
fixed-point contract.

A layer row is ``(ic, oc, size, k, pool)``: a k x k SAME convolution
(k = 1 or 3) of ``size`` x ``size`` u8 maps with int8 weights and an int32
bias per output channel, then

    u8 = clip(((sum x * w) + b) >> shift, 0, 255)      # every layer but the last
    pool 2 (2x2 stride 2), 1 (2x2 stride 1: the max over (y..y+1, x..x+1)
    of what lies inside the map, darknet's ``[maxpool] size=2 stride=1``)
    or 0 (none)

The last layer is linear: its int32 sums (bias added) go to the region
head, which reads them as t = (sum + b) / 2**shift. The CAM family's rows
``(ic, oc, size)`` mean ``k = 3, pool = 2`` (``layer_spec``).

The region head (darknet's ``[region]`` layer, ``softmax=1``): cell (i, j)
of the g x g grid, anchor n, channels ``n * (5 + C) + [tx, ty, tw, th, to,
c_0 .. c_C-1]``; box x = (j + sigmoid(tx)) / g, y = (i + sigmoid(ty)) / g,
w = a_n^w exp(tw) / g, h = a_n^h exp(th) / g; score of class k =
sigmoid(to) softmax(c)_k, 0 at or below ``thresh``; per-class greedy NMS
at IoU ``nms`` (darknet's ``do_nms_sort``); the ``max_det`` best (box,
class) pairs by score.

``RegionModel`` holds the host (numpy) parameters; ``TorchRegionNet``
the same on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

POOLS = (0, 1, 2)

# darknet's cfg/yolov2-tiny-voc.cfg [region] anchors (grid cells)
VOC_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38), (9.42, 5.11),
               (16.62, 10.52))
VOC_CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car",
               "cat", "chair", "cow", "diningtable", "dog", "horse",
               "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
               "tvmonitor")


def layer_spec(row) -> tuple[int, int, int, int, int]:
    """A layer row -> (ic, oc, size, k, pool); a CAM-family 3-tuple is
    ``k = 3, pool = 2``."""
    row = tuple(int(v) for v in row)
    if len(row) == 3:
        return (*row, 3, 2)
    if len(row) != 5:
        raise ValueError(f"a layer row is (ic, oc, size) or (ic, oc, size, k, "
                         f"pool), got {row}")
    ic, oc, size, k, pool = row
    if k not in (1, 3) or pool not in POOLS or min(ic, oc, size) < 1:
        raise ValueError(f"layer {row}: need k in (1, 3), pool in {POOLS}, "
                         f"positive sizes")
    return row


def out_size(size: int, pool: int) -> int:
    """The side after a layer's pool."""
    return size // 2 if pool == 2 else size


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """A detector's geometry and region head."""

    layer_configs: tuple[tuple[int, ...], ...]
    anchors: tuple[tuple[float, float], ...] = VOC_ANCHORS
    num_classes: int = 20
    thresh: float = 0.005
    nms: float = 0.45
    max_det: int = 100

    def __post_init__(self):
        specs = [layer_spec(r) for r in self.layer_configs]
        for (ic, oc, s, _, p), (ic2, _, s2, _, _) in zip(specs, specs[1:]):
            if ic2 != oc or s2 != out_size(s, p):
                raise ValueError(f"layers do not chain: {specs}")
        if p := specs[-1][4]:
            raise ValueError(f"the last layer takes no pool, got {p}")
        if specs[-1][1] != self.num_anchors * self.entries:
            raise ValueError(f"the last layer has {specs[-1][1]} channels, the "
                             f"region head reads {self.num_anchors} x "
                             f"{self.entries}")

    @property
    def specs(self) -> list[tuple[int, int, int, int, int]]:
        return [layer_spec(r) for r in self.layer_configs]

    @property
    def in_channels(self) -> int:
        return self.specs[0][0]

    @property
    def img_size(self) -> int:
        return self.specs[0][2]

    @property
    def grid(self) -> int:
        return self.specs[-1][2]

    @property
    def num_anchors(self) -> int:
        return len(self.anchors)

    @property
    def entries(self) -> int:
        """Channels per anchor: 4 coordinates, objectness, the classes."""
        return 5 + self.num_classes

    def macs(self) -> int:
        """int8 multiply-adds of one frame."""
        return sum(s * s * oc * ic * k * k for ic, oc, s, k, _ in self.specs)

    def weight_bytes(self) -> int:
        return sum(oc * ic * k * k for ic, oc, _, k, _ in self.specs)


class RegionModel:
    """Host parameters: per layer (oc, ic, k, k) int8 kernels and (oc,)
    int32 biases, one shift per layer, the class names."""

    head_mode = "region"

    def __init__(self, kernels: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                 shifts: Sequence[int], config: RegionConfig,
                 class_names: Sequence[str] | None = None):
        self.config = config
        specs = config.specs
        want = [(oc, ic, k, k) for ic, oc, _, k, _ in specs]
        got = [tuple(k.shape) for k in kernels]
        if got != want:
            raise ValueError(f"kernel shapes {got} != expected {want}")
        if [tuple(b.shape) for b in biases] != [(oc,) for _, oc, _, _, _ in specs]:
            raise ValueError("one int32 bias per output channel required")
        self.kernels = [np.asarray(k, np.int8) for k in kernels]
        self.biases = [np.asarray(b, np.int32) for b in biases]
        self.shifts = np.asarray(list(shifts), np.int32)
        if self.shifts.shape != (len(specs),):
            raise ValueError("one shift per layer required")
        if ((self.shifts < 0) | (self.shifts > 31)).any():
            raise ValueError(f"shifts {self.shifts.tolist()} outside 0..31")
        self.class_names = (list(class_names) if class_names is not None
                            else [str(i) for i in range(config.num_classes)])
        if len(self.class_names) != config.num_classes:
            raise ValueError("one name per class required")


class TorchRegionNet(nn.Module):
    """A ``RegionModel``'s parameters on one device: ``kernels`` int8,
    ``biases`` int32, ``shifts`` int32 and ``anchors`` float32 (A, 2)."""

    def __init__(self, model: RegionModel, device: torch.device | str):
        super().__init__()
        dev = torch.device(device)
        self.config = model.config
        for i, (k, b) in enumerate(zip(model.kernels, model.biases)):
            self.register_buffer(f"kernel{i}", torch.from_numpy(k).to(dev))
            self.register_buffer(f"bias{i}", torch.from_numpy(b).to(dev))
        self.register_buffer("shifts", torch.from_numpy(model.shifts).to(dev))
        self.register_buffer("anchors", torch.tensor(model.config.anchors,
                                                     dtype=torch.float32,
                                                     device=dev))

    @property
    def kernels(self) -> list[torch.Tensor]:
        return [getattr(self, f"kernel{i}")
                for i in range(len(self.config.layer_configs))]

    @property
    def biases(self) -> list[torch.Tensor]:
        return [getattr(self, f"bias{i}")
                for i in range(len(self.config.layer_configs))]
