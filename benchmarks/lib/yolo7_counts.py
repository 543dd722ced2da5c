"""The operations and bytes of YOLOv7 (a darknet layer graph with
``maxpool`` rows and routes of up to six maps), and which device kernels
are its net's and its head's, for the readers of its cell
(``metrics/*.yolo7.py``). The convs, their bounds and the head's are
``lib/yolo3_counts.py``'s, imported as they are (a conv's map is as many
bytes inside a concatenation as outside one); this adds the pools: each
pooling launch's map in and its maps out, and their kernel
(``maxpool_kernel``), which counts as the net's.
"""

from __future__ import annotations

from benchmarks.lib import roofline
from benchmarks.lib.yolo3_counts import (HEAD_KERNEL, LAYER_KERNEL, STREAM_KERNEL,  # noqa: F401
                                         conv_bound_ms, convs, head_bound_ms, layer_bound_ms,
                                         linear_convs, macs_per_frame, stack_bound_ms,
                                         stream_bound_ms, streamed, weight_bytes)

POOL_KERNEL = "maxpool_kernel"
NET_KERNELS = (LAYER_KERNEL, STREAM_KERNEL, POOL_KERNEL)


def _sources(rows) -> list[tuple[int, ...]]:
    out = []
    for r, row in enumerate(rows):
        if row[0] == "route":
            out.append(tuple(r + int(v) if int(v) < 0 else int(v) for v in row[1:]))
        elif row[0] == "shortcut":
            out.append((r - 1, r + int(row[1])))
        else:
            out.append((r - 1,) if r else ())
    return out


def _maps(rows) -> list[tuple[int, int]]:
    """(channels, side) of each row's map."""
    src = _sources(rows)
    shape: list[tuple[int, int]] = []
    for r, row in enumerate(rows):
        if row[0] == "conv":
            _, _, oc, s, _, st = (row[0], *(int(v) for v in row[1:]))
            shape.append((oc, s // st))
        elif row[0] == "route":
            shape.append((sum(shape[i][0] for i in src[r]), shape[src[r][0]][1]))
        elif row[0] == "upsample":
            shape.append((shape[r - 1][0], 2 * shape[r - 1][1]))
        elif row[0] == "maxpool":
            shape.append((shape[r - 1][0], shape[r - 1][1] // int(row[2])))
        else:
            shape.append(shape[r - 1])
    return shape


def _alias(r: int, rows, src) -> int:
    while rows[r][0] == "route" and len(rows[r]) == 2:
        r = src[r][0]
    return r


def pool_bytes(layer_configs) -> int:
    """Per frame, the bytes the pools must move: each pooled map read once
    (the stride-1 pools of one map, SPPCSPC's, are one launch that reads
    it once) and every pool's map written."""
    rows = [tuple(r) for r in layer_configs]
    src, shape = _sources(rows), _maps(rows)
    read: set[tuple[int, int]] = set()  # (source map, stride)
    total = 0
    for r, row in enumerate(rows):
        if row[0] != "maxpool":
            continue
        a = _alias(src[r][0], rows, src)
        c, s = shape[a]
        if (a, int(row[2])) not in read:
            read.add((a, int(row[2])))
            total += c * s * s
        total += shape[r][0] * shape[r][1] ** 2
    return total


def pool_bound_ms(layer_configs, batch: int) -> float:
    """The pools' least ms a round: ``pool_bytes`` at 3.35 TB/s."""
    return roofline.bound(0, pool_bytes(layer_configs) * batch)[0]


def net_bound_ms(layer_configs, batch: int) -> float:
    """The net's least ms a round: the conv graph's as one piece of work
    (``stack_bound_ms``) and the pools' (``pool_bound_ms``)."""
    return stack_bound_ms(layer_configs, batch) + pool_bound_ms(layer_configs, batch)


def candidates_per_frame(config) -> float:
    """The boxes a frame that pass the objectness threshold, as the bundle
    maker set them (the configuration's calibration readings, summed over
    the heads)."""
    return float(sum(config["assumed"]["readings_seed640"]["candidates_per_frame"]))
