"""The operations and bytes of a darknet layer graph with [yolo] heads
(YOLOv3), and which device kernels are its net's and its head's, for the
readers of its cells (``metrics/*.yolo3.py``). ``lib/yolo_counts.py`` is
the same yardstick for a chain of rows ``(ic, oc, size, k, pool)``; here
the rows are the graph's (``models.region.DarknetConfig`` in the
program): a ``("conv", ic, oc, size, k, stride)`` row's multiply-adds, its
weights, and the int32 sums of the three linear convs a ``yolo`` row
reads; each conv's bound as a launch of its own, and which kernel runs it.
Shortcuts, routes and upsamples do no multiply-add.
"""

from __future__ import annotations

from benchmarks.lib import roofline

# the net's kernels: the layer kernel (the convs of fewer than 128 input
# channels) and the weight-streaming kernel (the rest); the head's is
# ``HEAD_KERNEL``
LAYER_KERNEL, STREAM_KERNEL = "conv_layer_kernel", "conv_stream_kernel"
NET_KERNELS = (LAYER_KERNEL, STREAM_KERNEL)
HEAD_KERNEL = "yolo_head_kernel"


def convs(layer_configs) -> list[tuple[int, int, int, int, int]]:
    """(ic, oc, size, k, stride) of each conv row, in order."""
    return [tuple(int(v) for v in row[1:]) for row in layer_configs if row[0] == "conv"]


def macs_per_frame(layer_configs) -> int:
    return sum((s // st) ** 2 * oc * ic * k * k for ic, oc, s, k, st in convs(layer_configs))


def weight_bytes(layer_configs) -> int:
    return sum(oc * ic * k * k for ic, oc, _, k, _ in convs(layer_configs))


def frame_bytes(layer_configs) -> int:
    ic, _, s, _, _ = convs(layer_configs)[0]
    return ic * s * s


def sums_bytes(layer_configs) -> int:
    """Per frame, the int32 sums of the convs the ``yolo`` rows read."""
    rows = [tuple(r) for r in layer_configs]
    total = 0
    for r, row in enumerate(rows):
        if row[0] == "yolo":
            _, _, oc, s, _, st = (rows[r - 1][0], *(int(v) for v in rows[r - 1][1:]))
            total += 4 * oc * (s // st) ** 2
    return total


def stack_bound_ms(layer_configs, batch: int) -> float:
    """The whole graph's least ms a round, as one piece of work, whether its
    convs are fused or not: its multiply-adds at 989.5 T MAC/s against the
    frames in, the weights and the heads' int32 sums out at 3.35 TB/s."""
    return roofline.bound(macs_per_frame(layer_configs) * batch,
                          (frame_bytes(layer_configs) + sums_bytes(layer_configs)) * batch
                          + weight_bytes(layer_configs))[0]


def linear_convs(layer_configs) -> set[int]:
    """The conv numbers (in ``convs``'s order) whose int32 sums a ``yolo``
    row reads: the linear convs."""
    rows = [tuple(r) for r in layer_configs]
    conv_of = {r: i for i, r in enumerate(r for r, row in enumerate(rows) if row[0] == "conv")}
    return {conv_of[r - 1] for r, row in enumerate(rows) if row[0] == "yolo"}


def streamed(layer_configs) -> list[int]:
    """The convs the weight-streaming kernel runs, by the program's rule
    (``engine.region.graph_route``; a CPU test holds the two equal): those
    of a multiple of 128 input channels and the linear ones. The rest run on
    the layer kernel."""
    linear = linear_convs(layer_configs)
    return [i for i, (ic, *_rest) in enumerate(convs(layer_configs))
            if ic % 128 == 0 or i in linear]


def conv_bound_ms(layer_configs, i: int, batch: int) -> float:
    """Conv ``i``'s least ms a round as a launch of its own: its
    multiply-adds against its u8 map in, its map out (int32 sums for a
    linear conv; the map before an upsample that its launch may do), the
    map a shortcut after it adds, and its weights."""
    rows = [tuple(r) for r in layer_configs]
    at = [r for r, row in enumerate(rows) if row[0] == "conv"][i]
    ic, oc, s, k, st = convs(layer_configs)[i]
    o = s // st
    out = oc * o * o * (4 if i in linear_convs(layer_configs) else 1)
    res = oc * o * o if at + 1 < len(rows) and rows[at + 1][0] == "shortcut" else 0
    return roofline.bound(o * o * oc * ic * k * k * batch,
                          (ic * s * s + out + res) * batch + oc * ic * k * k)[0]


def stream_bound_ms(layer_configs, batch: int) -> float:
    """The streamed convs' least ms a round: each one's ``conv_bound_ms``,
    summed, as each is a launch of its own."""
    return sum(conv_bound_ms(layer_configs, i, batch) for i in streamed(layer_configs))


def layer_bound_ms(layer_configs, batch: int) -> float:
    """The layer kernel's convs' least ms a round (every conv not
    ``streamed``), summed as ``stream_bound_ms`` is."""
    on_stream = set(streamed(layer_configs))
    return sum(conv_bound_ms(layer_configs, i, batch)
               for i in range(len(convs(layer_configs))) if i not in on_stream)


SECTOR = 32  # bytes: the least the card reads of global memory at once


def head_bound_ms(layer_configs, batch: int, max_det: int, candidates: float) -> float:
    """The head's least ms a round, by the bytes it must move at 3.35 TB/s:
    each box's objectness word (one sector a box: a cell's anchors lie a
    row of 4 (5 + C) bytes apart in the channels-last sums), the rest of
    the row of each of ``candidates`` boxes a frame that pass the
    threshold (its sectors but the objectness word's), and the answers
    written (max_det x 6 float32 and a count a frame)."""
    rows = [tuple(r) for r in layer_configs]
    boxes, row_bytes = 0, 0
    for r, row in enumerate(rows):
        if row[0] == "yolo":
            _, oc, s, _, st = (int(v) for v in rows[r - 1][1:])
            boxes += 3 * (s // st) ** 2
            row_bytes = 4 * oc // 3
    rest = (-(-row_bytes // SECTOR) - 1) * SECTOR
    answers = 4 * (6 * max_det + 1)
    return roofline.bound(0, (boxes * SECTOR + candidates * rest + answers) * batch)[0]


def candidates_per_frame(config) -> float:
    """The boxes a frame that pass the objectness threshold, as the bundle
    maker set them (the configuration's calibration readings, summed over
    the heads)."""
    return float(sum(config["assumed"]["readings_seed416"]["candidates_per_frame"]))
