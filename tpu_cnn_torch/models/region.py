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

A darknet layer graph (``DarknetConfig``: YOLOv3's convs with stride 2,
shortcuts, routes, upsamples and three [yolo] heads; YOLOv7's max-pools
and routes of up to six maps, its heads' scaled decode) is the other
family of rows; its head is ``ops.yolo_head``'s.

``RegionModel`` holds the host (numpy) parameters of either, one kernel,
bias and shift a conv; ``TorchRegionNet`` the same on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tpu_cnn_torch.ops.yolo_head import DECODES

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


# darknet's cfg/yolov3.cfg [yolo] anchors (pixels of the 416 input) and
# each head's mask, coarsest head first; data/coco.names
COCO_ANCHORS = ((10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119),
                (116, 90), (156, 198), (373, 326))
COCO_MASKS = ((6, 7, 8), (3, 4, 5), (0, 1, 2))
COCO_CLASSES = (
    "person", "bicycle", "car", "motorbike", "aeroplane", "bus", "train", "truck",
    "boat", "traffic light", "fire hydrant", "stop sign", "parking meter", "bench",
    "bird", "cat", "dog", "horse", "sheep", "cow", "elephant", "bear", "zebra",
    "giraffe", "backpack", "umbrella", "handbag", "tie", "suitcase", "frisbee", "skis",
    "snowboard", "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork", "knife",
    "spoon", "bowl", "banana", "apple", "sandwich", "orange", "broccoli", "carrot",
    "hot dog", "pizza", "donut", "cake", "chair", "sofa", "pottedplant", "bed",
    "diningtable", "toilet", "tvmonitor", "laptop", "mouse", "remote", "keyboard",
    "cell phone", "microwave", "oven", "toaster", "sink", "refrigerator", "book",
    "clock", "vase", "scissors", "teddy bear", "hair drier", "toothbrush")

ROW_KINDS = ("conv", "shortcut", "route", "upsample", "maxpool", "yolo")
MAX_ROUTE = 6  # the most maps a route concatenates (YOLOv7's ELAN-H blocks)
# (size, stride) of a ``maxpool`` row: YOLOv7's MP downsampling, and the
# SPP pools (9 and 13 are 5 twice and three times: ``ops.maxpool``)
POOL_ROWS = ((2, 2), (5, 1), (9, 1), (13, 1))

# YOLOv7's anchors (cfg/deploy/yolov7.yaml, pixels of the 640 input), its
# heads fine to coarse: P3 (stride 8), P4, P5
YOLOV7_ANCHORS = ((12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146),
                  (142, 110), (192, 243), (459, 401))
YOLOV7_MASKS = ((0, 1, 2), (3, 4, 5), (6, 7, 8))


@dataclasses.dataclass(frozen=True)
class Node:
    """One row of a darknet layer graph, resolved: its kind, the rows it
    reads (absolute indices, in darknet's order), and its output map's
    channels and side."""

    kind: str
    inputs: tuple[int, ...]
    channels: int
    size: int


def yolov3_rows(size: int = 416, classes: int = 80,
                blocks: tuple[int, ...] = (1, 2, 8, 8, 4)) -> tuple[tuple, ...]:
    """darknet's cfg/yolov3.cfg as flat rows (``DarknetConfig``): Darknet-53
    (a 3x3 conv, then five stages of a stride-2 3x3 conv and ``blocks``
    residual blocks of a 1x1 and a 3x3 conv and a shortcut: 1, 2, 8, 8, 4)
    and the three heads, each six convs (1x1 and 3x3 in turn) and a linear
    1x1 to 3 x (5 + classes), and the [yolo] layer, the second and third
    fed by a route back, a 1x1, an upsample and a route concatenating the
    fourth and the third stage's last map (rows 61 and 36 of the cfg)."""
    rows: list[tuple] = []

    def conv(ic, oc, s, k, stride=1):
        rows.append(("conv", ic, oc, s, k, stride))

    conv(3, 32, size, 3)
    s, c = size, 32
    ends = []
    for n in blocks:
        conv(c, 2 * c, s, 3, 2)
        s, c = s // 2, 2 * c
        for _ in range(n):
            conv(c, c // 2, s, 1)
            conv(c // 2, c, s, 3)
            rows.append(("shortcut", -3))
        ends.append(len(rows) - 1)
    out = 3 * (5 + classes)
    for head, (width, skip) in enumerate(((512, None), (256, ends[3]), (128, ends[2]))):
        if head:
            rows.append(("route", -4))
            conv(2 * width, width, s, 1)
            rows.append(("upsample", 2))
            s *= 2
            rows.append(("route", -1, skip))
            c = width + 2 * width
        for _ in range(3):
            conv(c, width, s, 1)
            conv(width, 2 * width, s, 3)
            c = 2 * width
        conv(2 * width, out, s, 1)
        rows.append(("yolo", *COCO_MASKS[head]))
    return tuple(rows)


def yolov7_rows(size: int = 640, classes: int = 80, width: int = 1) -> tuple[tuple, ...]:
    """YOLOv7 (``cfg/deploy/yolov7.yaml`` of github.com/WongKinYiu/yolov7,
    rows 0-104, then ``Detect`` over 102, 103 and 104) as flat darknet rows
    (``DarknetConfig``): the stem, four E-ELAN stages (a 1x1 pair and four
    3x3s, their 4-way concatenation and a 1x1), the MP downsampling blocks
    (a 2x2/2 max-pool and a 1x1 beside a 1x1 and a stride-2 3x3,
    concatenated), SPPCSPC (pools at 5, 9 and 13 concatenated with their
    map), the PAN neck of ELAN-H blocks (6-way concatenations) with two
    upsamples and two MP blocks, the three ``RepConv`` in their deploy form
    (one 3x3) and each head's linear 1x1 to 3 x (5 + classes) and [yolo]
    row, fine to coarse (80, 40 and 20 at 640). A conv that reads a row
    other than the previous one reads it through a one-map route, as
    darknet's cfgs do; a concatenation is a route of its maps in the
    yaml's order. Every width is divided by ``width``, to 32 channels at
    least (the tests' small graphs; the engine's plan takes 1 and 2 only:
    wider cuts leave an upsampling 1x1 on the layer kernel, which takes
    no upsample)."""
    rows: list[tuple] = []
    at: dict[int, int] = {}  # yaml row -> the darknet row of its map
    ch: dict[int, int] = {}
    sz: dict[int, int] = {}

    def add(row) -> int:
        rows.append(tuple(row))
        return len(rows) - 1

    def read(y: int) -> None:
        """Makes yaml row y's map the previous row's."""
        if at[y] != len(rows) - 1:
            add(("route", at[y]))

    def cut(c: int) -> int:
        return c if width == 1 else max(c // width, 32)

    def conv(y, frm, oc, k, stride=1, scale=True):
        oc = cut(oc) if scale else oc
        ic = ch[frm] if frm is not None else 3
        s = sz[frm] if frm is not None else size
        if frm is not None:
            read(frm)
        at[y] = add(("conv", ic, oc, s, k, stride))
        ch[y], sz[y] = oc, s // stride

    def concat(y, srcs):
        at[y] = add(("route", *(at[i] for i in srcs)))
        ch[y], sz[y] = sum(ch[i] for i in srcs), sz[srcs[0]]

    def maxpool(y, frm):
        read(frm)
        at[y] = add(("maxpool", 2, 2))
        ch[y], sz[y] = ch[frm], sz[frm] // 2

    def upsample(y, frm):
        read(frm)
        at[y] = add(("upsample", 2))
        ch[y], sz[y] = ch[frm], 2 * sz[frm]

    def elan(y, c, out, heads=4):
        """Rows y .. y + 7: E-ELAN (``heads`` 4: concat of 4) or ELAN-H
        (6: concat of 6); c the 1x1s' width, out the closing 1x1's."""
        conv(y, y - 1, c, 1)
        conv(y + 1, y - 1, c, 1)
        c3 = c if heads == 4 else c // 2
        for i in range(4):
            conv(y + 2 + i, y + 1 + i, c3, 3)
        picks = [5, 3, 1, 0] if heads == 4 else [5, 4, 3, 2, 1, 0]
        concat(y + 6, [y + p for p in picks])
        conv(y + 7, y + 6, out, 1)

    def mp(y, c, third=None):
        """Rows y .. y + 4: the MP block (its concat also reads ``third``)."""
        maxpool(y, y - 1)
        conv(y + 1, y, c, 1)
        conv(y + 2, y - 1, c, 1)
        conv(y + 3, y + 2, c, 3, 2)
        concat(y + 4, [y + 3, y + 1] + ([third] if third is not None else []))

    conv(0, None, 32, 3)
    conv(1, 0, 64, 3, 2)
    conv(2, 1, 64, 3)
    conv(3, 2, 128, 3, 2)
    elan(4, 64, 256)
    mp(12, 128)
    elan(17, 128, 512)
    mp(25, 256)
    elan(30, 256, 1024)
    mp(38, 512)
    elan(43, 256, 1024)
    # 51: SPPCSPC(512): cv1, cv3, cv4 -> x1; x1 and its pools at 5, 9, 13
    # concatenated; cv5, cv6 -> y1; cv2 of the input -> y2; cv7 of (y1, y2)
    c_ = cut(512)
    conv("cv1", 50, 512, 1)
    conv("cv3", "cv1", 512, 3)
    conv("x1", "cv3", 512, 1)
    pools = []
    for k in (5, 9, 13):
        read("x1")
        pools.append(add(("maxpool", k, 1)))
    add(("route", at["x1"], *pools))
    ch["spp"], sz["spp"] = 4 * c_, sz["x1"]
    at["spp"] = len(rows) - 1
    conv("cv5", "spp", 512, 1)
    conv("y1", "cv5", 512, 3)
    conv("y2", 50, 512, 1)
    concat("y12", ["y1", "y2"])
    conv(51, "y12", 512, 1)
    conv(52, 51, 256, 1)
    upsample(53, 52)
    conv(54, 37, 256, 1)
    concat(55, [54, 53])
    elan(56, 256, 256, heads=6)
    conv(64, 63, 128, 1)
    upsample(65, 64)
    conv(66, 24, 128, 1)
    concat(67, [66, 65])
    elan(68, 128, 128, heads=6)
    mp(76, 128, third=63)
    elan(81, 256, 256, heads=6)
    mp(89, 256, third=51)
    elan(94, 512, 512, heads=6)
    out = 3 * (5 + classes)
    for y, frm, c, mask in ((102, 75, 256, YOLOV7_MASKS[0]), (103, 88, 512, YOLOV7_MASKS[1]),
                            (104, 101, 1024, YOLOV7_MASKS[2])):
        conv(y, frm, c, 3)
        conv(f"det{y}", y, out, 1, scale=False)
        add(("yolo", *mask))
    return tuple(rows)


@dataclasses.dataclass(frozen=True)
class DarknetConfig:
    """A darknet layer graph with [yolo] heads (YOLOv3). One flat row a
    darknet layer, in the cfg's order:

        ("conv", ic, oc, size, k, stride)   a k x k conv (k 1 or 3) of a
            size x size map, SAME padding k // 2, stride 1 or 2 (darknet's
            out(y, x) = sum in(s y - k // 2 + dy, s x - k // 2 + dx)); u8 =
            clip((sum + b) >> shift, 0, 255), or the linear int32 sums of
            a conv that a ``yolo`` row reads
        ("shortcut", frm)      u8 = min(a + b, 255): the previous row's map
                               and the map ``frm`` rows back
        ("route", a[, b, ..])  the maps of rows a, b, .. (1 to
                               ``MAX_ROUTE``), channels concatenated in
                               that order (negative: relative; else
                               absolute)
        ("upsample", 2)        out(y, x) = in(y // 2, x // 2)
        ("maxpool", k, s)      the previous row's map max-pooled, k 2 at s
                               2 (an even map) or k 5, 9 or 13 at s 1:
                               out(y, x) = the max of in over rows s y -
                               (k - 1) // 2 .. + k - 1 and the same
                               columns, taps outside the map ignored
                               (darknet's [maxpool]; PyTorch's
                               MaxPool2d(k, s, k // 2) for the odd k,
                               MaxPool2d(2, 2) for 2)
        ("yolo", m0, m1, m2)   a head reading the previous (linear 1x1)
                               conv's 3 x (5 + classes) channels, anchors
                               m0..m2 of ``anchors`` (pixels)

    A conv reads the previous row's map (the frames for the first). The
    heads' boxes, in darknet's order (head by head, cell-major, anchor
    inner), are decoded (``decode``: "darknet", YOLOv3's x = (j +
    sigmoid(tx)) / g, w = exp(tw) a_w / net; or "scaled", YOLOv7's and
    darknet's ``new_coords=1, scale_x_y=2``: x = (j + 2 sigmoid(tx) - 0.5)
    / g, w = (2 sigmoid(tw))**2 a_w / net), kept where their objectness
    passes ``thresh``, scored o x sigmoid(class), and suppressed per class
    together (``ops.yolo_head``)."""

    layer_configs: tuple[tuple, ...]
    anchors: tuple[tuple[float, float], ...] = COCO_ANCHORS
    num_classes: int = 80
    thresh: float = 0.005
    nms: float = 0.45
    max_det: int = 100
    decode: str = "darknet"

    def __post_init__(self):
        if self.decode not in DECODES:
            raise ValueError(f"decode {self.decode!r}: the [yolo] heads decode as one of "
                             f"{DECODES}")
        self.graph()  # raises on an inconsistent graph

    def graph(self) -> list[Node]:
        """The resolved rows; raises ValueError where the graph is not
        consistent (shapes do not chain, a shortcut's maps differ, a
        route's maps' sides differ or it reads more than ``MAX_ROUTE``, a
        pool is not one of ``POOL_ROWS`` or halves an odd map, a ``yolo``
        row does not follow a linear 1x1 conv of 3 x (5 + classes)
        channels, a row reads past the start)."""
        nodes: list[Node] = []
        prev = None
        for r, row in enumerate(self.layer_configs):
            kind = row[0] if row else None
            vals = tuple(int(v) for v in row[1:])
            if kind not in ROW_KINDS:
                raise ValueError(f"row {r} {row}: the kind must be one of {ROW_KINDS}")

            def at(rel):
                i = r + rel if rel < 0 else rel
                if not 0 <= i < r:
                    raise ValueError(f"row {r} {row}: reads row {i}, not an earlier one")
                return i

            if kind == "conv":
                if len(vals) != 5:
                    raise ValueError(f"row {r} {row}: a conv is (ic, oc, size, k, stride)")
                ic, oc, s, k, stride = vals
                if (k not in (1, 3) or stride not in (1, 2) or min(ic, oc, s) < 1
                        or (stride == 2 and (k != 3 or s % 2))):
                    raise ValueError(f"row {r} {row}: need k 1 or 3, stride 1 or 2 (a 3x3 "
                                     f"on an even map), positive sizes")
                want = (nodes[prev].channels, nodes[prev].size) if prev is not None else None
                if want is not None and (ic, s) != want:
                    raise ValueError(f"row {r} {row}: reads a {want[1]}x{want[1]} map of "
                                     f"{want[0]} channels")
                node = Node("conv", (prev,) if prev is not None else (), oc, s // stride)
            elif kind == "shortcut":
                if len(vals) != 1 or prev is None:
                    raise ValueError(f"row {r} {row}: a shortcut is (frm,) after a row")
                src = at(vals[0])
                if (nodes[src].channels, nodes[src].size) != (nodes[prev].channels,
                                                              nodes[prev].size):
                    raise ValueError(f"row {r} {row}: adds maps of different shapes")
                node = Node("shortcut", (prev, src), nodes[prev].channels, nodes[prev].size)
            elif kind == "route":
                if not 1 <= len(vals) <= MAX_ROUTE:
                    raise ValueError(f"row {r} {row}: a route reads 1 to {MAX_ROUTE} rows")
                srcs = tuple(at(v) for v in vals)
                if len({nodes[i].size for i in srcs}) != 1:
                    raise ValueError(f"row {r} {row}: concatenates maps of different sides")
                node = Node("route", srcs, sum(nodes[i].channels for i in srcs),
                            nodes[srcs[0]].size)
            elif kind == "upsample":
                if vals != (2,) or prev is None:
                    raise ValueError(f"row {r} {row}: an upsample is (2,) after a row")
                node = Node("upsample", (prev,), nodes[prev].channels, 2 * nodes[prev].size)
            elif kind == "maxpool":
                if vals not in POOL_ROWS or prev is None:
                    raise ValueError(f"row {r} {row}: a maxpool is one of (size, stride) "
                                     f"{POOL_ROWS} after a row")
                if vals[1] == 2 and nodes[prev].size % 2:
                    raise ValueError(f"row {r} {row}: a 2x2/2 pool of an odd map "
                                     f"({nodes[prev].size})")
                node = Node("maxpool", (prev,), nodes[prev].channels,
                            nodes[prev].size // vals[1])
            else:
                if len(vals) != 3 or any(not 0 <= m < len(self.anchors) for m in vals):
                    raise ValueError(f"row {r} {row}: a yolo row names 3 of the "
                                     f"{len(self.anchors)} anchors")
                src = self.layer_configs[prev] if prev is not None else None
                if (src is None or src[0] != "conv" or int(src[4]) != 1
                        or int(src[2]) != 3 * self.entries):
                    raise ValueError(f"row {r} {row}: a yolo row follows a 1x1 conv of "
                                     f"3 x {self.entries} channels")
                node = Node("yolo", (prev,), nodes[prev].channels, nodes[prev].size)
            nodes.append(node)
            prev = r
        if len(self.heads) != 3:
            raise ValueError(f"the [yolo] head reads three heads, got {len(self.heads)}")
        return nodes

    @property
    def entries(self) -> int:
        """Channels per anchor: 4 coordinates, objectness, the classes."""
        return 5 + self.num_classes

    @property
    def conv_rows(self) -> list[int]:
        """The rows that are convs, in order: conv i is row conv_rows[i]."""
        return [r for r, row in enumerate(self.layer_configs) if row[0] == "conv"]

    @property
    def heads(self) -> list[int]:
        """The ``yolo`` rows."""
        return [r for r, row in enumerate(self.layer_configs) if row[0] == "yolo"]

    @property
    def masks(self) -> list[tuple[int, ...]]:
        return [tuple(int(v) for v in self.layer_configs[r][1:]) for r in self.heads]

    @property
    def pools(self) -> list[int]:
        """The ``maxpool`` rows."""
        return [r for r, row in enumerate(self.layer_configs) if row[0] == "maxpool"]

    @property
    def linear(self) -> set[int]:
        """The conv rows whose int32 sums a ``yolo`` row reads."""
        return {r - 1 for r in self.heads}

    @property
    def specs(self) -> list[tuple[int, int, int, int, int]]:
        """Per conv: (ic, oc, size, k, stride) (``RegionModel``'s kernel
        shapes read positions 0, 1 and 3)."""
        return [tuple(int(v) for v in self.layer_configs[r][1:]) for r in self.conv_rows]

    @property
    def in_channels(self) -> int:
        return self.specs[0][0]

    @property
    def img_size(self) -> int:
        return self.specs[0][2]

    def macs(self) -> int:
        """int8 multiply-adds of one frame."""
        return sum((s // st) ** 2 * oc * ic * k * k for ic, oc, s, k, st in self.specs)

    def weight_bytes(self) -> int:
        return sum(oc * ic * k * k for ic, oc, _, k, _ in self.specs)


class RegionModel:
    """Host parameters: per layer (oc, ic, k, k) int8 kernels and (oc,)
    int32 biases, one shift per layer, the class names."""

    def __init__(self, kernels: Sequence[np.ndarray], biases: Sequence[np.ndarray],
                 shifts: Sequence[int], config: RegionConfig | DarknetConfig,
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
            raise ValueError("one shift per layer required (a conv layer of a graph)")
        if ((self.shifts < 0) | (self.shifts > 31)).any():
            raise ValueError(f"shifts {self.shifts.tolist()} outside 0..31")
        self.class_names = (list(class_names) if class_names is not None
                            else [str(i) for i in range(config.num_classes)])
        if len(self.class_names) != config.num_classes:
            raise ValueError("one name per class required")

    @property
    def head_mode(self) -> str:
        """"region" (a chain's YOLOv2 region head) or "yolo" (a darknet
        graph's [yolo] heads)."""
        return "yolo" if isinstance(self.config, DarknetConfig) else "region"


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
        return [getattr(self, f"kernel{i}") for i in range(len(self.config.specs))]

    @property
    def biases(self) -> list[torch.Tensor]:
        return [getattr(self, f"bias{i}") for i in range(len(self.config.specs))]
