"""Pipeline parallelism over a mesh's ``pipe`` axis (GPipe fill/drain) —
the port of ``tpu_cnn.parallel.pipeline``.

Each mesh position along ``pipe`` owns a contiguous stage of layers;
microbatches flow stage to stage while every stage works on a different
one: at step t, stage s runs microbatch ``t - s`` (bubble fraction
(S-1)/(M+S-1)). The JAX version is one SPMD program (``shard_map``,
``lax.switch`` on the axis index, a ``ppermute`` hop, a ``scan`` over
steps) and needs one uniform (microbatch, H0, W0, Cmax) wire buffer for
it. The port is single-controller: the host walks the schedule and queues
each stage's work on that position's device and CUDA stream, and the hop
is a copy to the next stage's device, ordered by the stream wait of
``Mesh.send``; the activations travel at their own shapes.

Each stage applies the contract layers in plain torch
(``quant.fixed_point_conv_layer``), as the JAX stages run them in XLA, so
the output equals ``quant.cnn_forward`` bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from tpu_cnn_torch.ops import quant
from tpu_cnn_torch.parallel.mesh import Mesh, _grid, take_devices


def make_pipeline_mesh(n_devices: int, *, data_axis: int = 1,
                       devices=None) -> Mesh:
    """A ``pipe`` mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device). With ``data_axis > 1`` the mesh is 2-D
    ``(data, pipe)``: ``data_axis`` independent pipelines of
    ``n_devices // data_axis`` stages each, the batch split across them."""
    devices = take_devices(n_devices, devices)
    if n_devices % data_axis:
        raise ValueError(f"{n_devices} devices not divisible by data={data_axis}")
    if data_axis == 1:
        return Mesh(_grid(devices, (n_devices,)), ("pipe",))
    return Mesh(_grid(devices, (data_axis, n_devices // data_axis)),
                ("data", "pipe"))


def split_stages(n_layers: int, n_stages: int) -> list[tuple[int, int]]:
    """Balanced contiguous [start, end) layer ranges, one per stage; early
    stages take the remainder."""
    if not 1 <= n_stages <= n_layers:
        raise ValueError(f"n_stages {n_stages} must be in [1, {n_layers}]")
    base, rem = divmod(n_layers, n_stages)
    bounds, start = [], 0
    for s in range(n_stages):
        end = start + base + (1 if s < rem else 0)
        bounds.append((start, end))
        start = end
    return bounds


def as_images(images) -> torch.Tensor:
    """(B, H, W) u8, from a tensor or a numpy array, also in the (B, 1, H,
    W) form ``quant.cnn_forward`` takes."""
    x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(images))
    if x.dim() == 4:
        if x.shape[1] != 1:
            raise ValueError(f"4-D images must be (B, 1, H, W), got "
                             f"{tuple(x.shape)}")
        x = x[:, 0]
    if x.dim() != 3 or x.dtype != torch.uint8:
        raise ValueError(f"images must be (B, H, W) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    return x


def per_device(mesh: Mesh, arrays, dtype) -> dict:
    """Each distinct device of the mesh -> the arrays as tensors there."""
    out = {}
    for dev in dict.fromkeys(mesh.devices.flat):
        out[dev] = [torch.as_tensor(np.asarray(
            a.cpu() if isinstance(a, torch.Tensor) else a)).to(dev, dtype)
            for a in arrays]
    return out


def shifts_by_device(mesh: Mesh, shifts) -> dict:
    """The (L,) int32 shift vector on each distinct device."""
    values = (shifts.tolist() if isinstance(shifts, torch.Tensor)
              else [int(v) for v in np.asarray(shifts).ravel()])
    quant.check_shifts(values)
    src = torch.tensor(values, dtype=torch.int32)
    return {dev: src.to(dev) for dev in dict.fromkeys(mesh.devices.flat)}


def finish_on(mesh: Mesh, out: torch.Tensor, positions) -> torch.Tensor:
    """Make ``out``'s device's current stream wait for the positions that
    wrote into it, so the caller may use it at once."""
    if out.is_cuda:
        cur = torch.cuda.current_stream(out.device)
        for pos in positions:
            s = mesh.stream(pos)
            if s is not None and s.device == out.device:
                cur.wait_stream(s)
    return out


def pipelined_forward(mesh: Mesh, kernels: Sequence, *, microbatch: int = 4,
                      stages: Sequence[tuple[int, int]] | None = None,
                      accum_wrap: bool = False,
                      compute_dtype: str = "float32"):
    """Returns ``f(images, shifts) -> (B, C, Hf*Wf) u8`` (on the images'
    device) running the layer stack as a GPipe pipeline over the mesh's
    ``pipe`` axis.

    ``images`` is (B, H, W) or (B, 1, H, W) uint8 with B a multiple of
    ``microbatch`` (times the data-shard count on a 2-D ``(data, pipe)``
    mesh: independent pipelines with the batch split across them); the
    output is ``quant.cnn_forward``'s, bit for bit. ``stages`` overrides
    the balanced contiguous layer split."""
    if mesh.axis_names not in (("pipe",), ("data", "pipe")):
        raise ValueError(
            f"mesh must be ('pipe',) or ('data', 'pipe'), got {mesh.axis_names}")
    n_data = mesh.shape.get("data", 1)
    n_stages = mesh.shape["pipe"]
    n_layers = len(kernels)
    bounds = list(stages) if stages is not None else split_stages(n_layers,
                                                                 n_stages)
    if len(bounds) != n_stages:
        raise ValueError(f"{len(bounds)} stages for a {n_stages}-device pipe")
    mb = int(microbatch)
    ks = per_device(mesh, kernels, torch.int8)
    cf = int(kernels[-1].shape[0])

    def pos_of(d: int, s: int) -> tuple:
        return (d, s) if n_data > 1 else (s,)

    def fn(images, shifts):
        x = as_images(images)
        b, h0, w0 = x.shape
        if b % (n_data * mb):
            raise ValueError(
                f"batch {b} not a multiple of microbatch {mb}"
                + (f" x data shards {n_data}" if n_data > 1 else ""))
        n_micro = b // n_data // mb
        hf, wf = h0 >> n_layers, w0 >> n_layers
        out = torch.empty((b, cf, hf, wf), dtype=torch.uint8, device=x.device)
        sh = shifts_by_device(mesh, shifts)
        last = []
        for d in range(n_data):
            wire = {}  # stage -> its output of the previous step
            for t in range(n_micro + n_stages - 1):
                # the last stage first: each stage takes its input before
                # the stage ahead of it queues this step's work
                for s in reversed(range(n_stages)):
                    m = t - s
                    if not 0 <= m < n_micro:
                        continue
                    pos = pos_of(d, s)
                    dev = mesh.devices[pos]
                    with mesh.on(pos):
                        if s == 0:
                            r0 = (d * n_micro + m) * mb
                            y = x[r0:r0 + mb, None].to(dev, non_blocking=True)
                        else:
                            y = mesh.send(wire.pop(s - 1), pos_of(d, s - 1),
                                          pos)
                        for li in range(*bounds[s]):
                            y = quant.fixed_point_conv_layer(
                                y, ks[dev][li], sh[dev][li],
                                accum_wrap=accum_wrap,
                                compute_dtype=compute_dtype)
                        if s == n_stages - 1:
                            r0 = (d * n_micro + m) * mb
                            out[r0:r0 + mb].copy_(y, non_blocking=True)
                        else:
                            wire[s] = y
            last.append(pos_of(d, n_stages - 1))
        return finish_on(mesh, out, last).reshape(b, cf, hf * wf)

    return fn
