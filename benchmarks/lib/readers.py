"""What the per-layer metrics read, one function each. A metric's file
under ``metrics/`` names its layer, unit, source and the end-to-end metric
it moves, and takes its ``read`` from here; each returns None where the
run has nothing for it to read (never 0 for a share of a roofline or a
peak).

``ctx`` is what the cell's driver hands over: ``config`` and ``params``;
``fps`` (an offline window's frames/s); with ``--trace 1`` ``trace``
(``lib/trace.reduce_events``) and ``trace_rounds`` or ``trace_frames``,
what completed inside it.
"""

from __future__ import annotations

from benchmarks.lib import roofline
from benchmarks.lib.trace import device_seconds, is_net


def mfu_pct(ctx):
    """The whole step's share of the int8 peak: the net's int8 operations
    per frame (2 x its multiply-adds; the head's few operations left out)
    x the untraced window's frames/s, over 1,979 T op/s."""
    fps = ctx.get("fps")
    if not fps:
        return None
    ops = 2 * roofline.macs_per_image(ctx["config"]["layer_configs"])
    return ops * fps / roofline.PEAK_INT8_OPS * 100.0


def net_roofline_pct(ctx):
    """The conv stack's least time per batch (``roofline.layers_bound``:
    its multiply-adds against the frames in, the weights and the u8
    feature map out, whatever kernels implement it) over the device time
    per batch of the kernels ``trace.NET_KERNELS`` names."""
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds:
        return None
    net_s = device_seconds(trace, is_net)
    if net_s <= 0:
        return None
    layers = ctx["config"]["layer_configs"]
    bound_ms, _ = roofline.layers_bound(layers, int(ctx["params"]["batch"]),
                                        roofline.feature_map_bytes(layers))
    return bound_ms / (net_s * 1e3 / rounds) * 100.0


def head_device_ms(ctx):
    """Device ms per batch of every kernel and copy that is not the net's:
    the head, its casts and the results' copies to the host."""
    trace, rounds = ctx.get("trace"), ctx.get("trace_rounds")
    if not trace or not rounds or trace["busy_s"] <= 0:
        return None
    return device_seconds(trace, lambda n: not is_net(n)) * 1e3 / rounds


def idle_pct(ctx):
    """The share of the profiled window in which no kernel or copy ran:
    one minus the union of the device's operations over the window."""
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100.0


def busy_ms_per_frame(ctx):
    """The union of the device's kernels and copies per frame completed in
    the profiled window."""
    trace, frames = ctx.get("trace"), ctx.get("trace_frames")
    if not trace or not frames or trace["busy_s"] <= 0:
        return None
    return trace["busy_s"] * 1e3 / frames
