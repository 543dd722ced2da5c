"""The operations and bytes of a region-head detector's layers, and which
device kernels are its net's, for the readers of its cells (``metrics/
*.yolo.py``). ``lib/roofline.py``'s counts and ``lib/trace.py``'s
``NET_KERNELS`` are the CAM family's; this is the same yardstick for rows
``(ic, oc, size, k, pool)`` (``models.region`` in the program): a k x k
conv's multiply-adds, the u8 maps in and out (after the pool), the weights
and, for the last layer, its int32 sums out.
"""

from __future__ import annotations

from benchmarks.lib import roofline

# the net's kernels: the layer kernel (L0-L3) and the weight-streaming
# kernel (L4-L8); the region head's is ``HEAD_KERNEL``
STREAM_KERNEL = "conv_stream_kernel"
NET_KERNELS = ("conv_layer_kernel", STREAM_KERNEL)
HEAD_KERNEL = "region_head_kernel"


def out_size(size: int, pool: int) -> int:
    return size // 2 if pool == 2 else size


def layer_macs(row) -> int:
    ic, oc, s, k, _ = (int(v) for v in row)
    return s * s * oc * ic * k * k


def layer_bytes(row, last: bool) -> tuple[int, int, int]:
    """(map in, map out, weights) bytes of one frame's pass of a layer."""
    ic, oc, s, k, pool = (int(v) for v in row)
    o = out_size(s, pool)
    return ic * s * s, oc * o * o * (4 if last else 1), oc * ic * k * k


def macs_per_frame(layer_configs) -> int:
    return sum(layer_macs(r) for r in layer_configs)


def weight_bytes(layer_configs) -> int:
    return sum(layer_bytes(r, False)[2] for r in layer_configs)


def streamed(layer_configs) -> list[int]:
    """The layers the weight-streaming kernel runs (YOLOv2-tiny's L4-L8):
    by the program's rule (``ops.conv_stream.streams``; a CPU test holds
    the two equal), those of a multiple of 128 input channels and those
    the layer kernel does not compute (a 1x1, the 2x2 stride-1 pool or
    none, the last layer)."""
    n = len(layer_configs)
    return [i for i, r in enumerate(layer_configs)
            if int(r[0]) % 128 == 0 or int(r[3]) != 3 or int(r[4]) != 2 or i == n - 1]


def stack_bound_ms(layer_configs, batch: int) -> float:
    """The whole conv stack's least ms a round, as one piece of work: its
    multiply-adds against the frames in, the weights and the last layer's
    int32 sums out."""
    n = len(layer_configs)
    frames_in = layer_bytes(layer_configs[0], n == 1)[0]
    sums_out = layer_bytes(layer_configs[-1], True)[1]
    return roofline.bound(macs_per_frame(layer_configs) * batch,
                          (frames_in + sums_out) * batch
                          + weight_bytes(layer_configs))[0]


def stream_bound_ms(layer_configs, batch: int) -> float:
    """The streamed layers' least ms a round: each layer's ``roofline
    .bound`` (its multiply-adds against its maps in and out and its
    weights), summed, as each is a launch of its own."""
    n = len(layer_configs)
    total = 0.0
    for i in streamed(layer_configs):
        din, dout, w = layer_bytes(layer_configs[i], i == n - 1)
        total += roofline.bound(layer_macs(layer_configs[i]) * batch,
                                (din + dout) * batch + w)[0]
    return total
