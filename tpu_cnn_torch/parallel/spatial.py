"""Spatial parallelism over a mesh's ``space`` axis (row bands + halo
exchange) — the port of ``tpu_cnn.parallel.spatial``.

Each position along ``space`` owns a contiguous band of image rows; the
3x3 convolution's one-row dependency across band boundaries becomes a halo
exchange: before each layer, every band takes its upper neighbour's last
row and its lower neighbour's first row (zeros at the image's edge, the
contract's SAME padding), runs the contract layer on the extended band and
drops the two boundary output rows before the shift/pool epilogue. Bands
stay even-sized at every layer (``check_spatial_split``), so no 2x2 pool
window straddles two positions. The JAX version exchanges the rows with
two ``ppermute``s inside ``shard_map``; the port copies them to the
neighbour's device, ordered by the stream wait of ``Mesh.send``, and runs
each band on its position's stream.

The band computation is the contract (``quant.conv3x3_same`` +
``quant.conv_epilogue``, the halo rows in place of the zero pad), so the
output equals ``quant.cnn_forward`` bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpu_cnn_torch.ops import quant
from tpu_cnn_torch.parallel.mesh import Mesh, _grid, take_devices
from tpu_cnn_torch.parallel.pipeline import (as_images, finish_on, per_device,
                                             shifts_by_device)


def make_spatial_mesh(n_devices: int, *, data_axis: int = 1,
                      devices=None) -> Mesh:
    """A ``space`` mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device). With ``data_axis > 1`` the mesh is 2-D
    ``(data, space)``: batch shards times row shards."""
    devices = take_devices(n_devices, devices)
    if n_devices % data_axis:
        raise ValueError(f"{n_devices} devices not divisible by data={data_axis}")
    if data_axis == 1:
        return Mesh(_grid(devices, (n_devices,)), ("space",))
    return Mesh(_grid(devices, (data_axis, n_devices // data_axis)),
                ("data", "space"))


def check_spatial_split(h: int, n_layers: int, n_devices: int) -> None:
    """Every layer's per-device row band must be even (pool windows must not
    straddle devices): (h >> i) % (2 * n_devices) == 0 for all layers."""
    for i in range(n_layers):
        if (h >> i) % (2 * n_devices):
            raise ValueError(
                f"H={h}: layer {i} rows {h >> i} not divisible by "
                f"2*{n_devices} — pool windows would straddle devices"
            )


def _halo_conv_layer(x: torch.Tensor, kernel: torch.Tensor,
                     shift: torch.Tensor, *, accum_wrap: bool,
                     compute_dtype: str) -> torch.Tensor:
    """One contract layer on an NCHW row band whose first and last rows are
    halo rows from the neighbouring bands (or zeros at the image edge):
    the layer's own conv and epilogue, with the two halo-context output
    rows sliced off."""
    conv = quant.conv3x3_same(x, kernel, compute_dtype)[:, :, 1:-1]
    return quant.conv_epilogue(conv, shift, accum_wrap=accum_wrap)


def spatial_forward(mesh: Mesh, kernels: Sequence, *,
                    accum_wrap: bool = False,
                    compute_dtype: str = "float32"):
    """Returns ``f(images, shifts) -> (B, C, S'*S') u8`` (on the images'
    device) running the layer stack with image rows split over the mesh's
    ``space`` axis.

    ``images`` is (B, H, W) or (B, 1, H, W) uint8 with every layer's row
    count divisible by ``2 * n_devices`` (``check_spatial_split``); the
    output is ``quant.cnn_forward``'s, bit for bit."""
    if mesh.axis_names not in (("space",), ("data", "space")):
        raise ValueError(
            "mesh must be ('space',) or ('data', 'space'), got "
            f"{mesh.axis_names}")
    n_data = mesh.shape.get("data", 1)
    n_dev = mesh.shape["space"]
    n_layers = len(kernels)
    ks = per_device(mesh, kernels, torch.int8)
    cf = int(kernels[-1].shape[0])

    def pos_of(d: int, s: int) -> tuple:
        return (d, s) if n_data > 1 else (s,)

    def fn(images, shifts):
        x = as_images(images)
        b, h, w = x.shape
        check_spatial_split(h, n_layers, n_dev)
        if b % n_data:
            raise ValueError(f"batch {b} not divisible by data axis {n_data}")
        bb, hl = b // n_data, h // n_dev
        out = torch.empty((b, cf, h >> n_layers, w >> n_layers),
                          dtype=torch.uint8, device=x.device)
        sh = shifts_by_device(mesh, shifts)
        for d in range(n_data):
            pos = [pos_of(d, s) for s in range(n_dev)]
            band = []
            for s, p in enumerate(pos):
                with mesh.on(p):
                    band.append(x[d * bb:(d + 1) * bb, None,
                                  s * hl:(s + 1) * hl].to(mesh.devices[p],
                                                          non_blocking=True))
            for li in range(n_layers):
                ext = []
                for s, p in enumerate(pos):  # the exchange, then the layer
                    with mesh.on(p):
                        x_s = band[s]
                        zero = x_s.new_zeros((bb, x_s.shape[1], 1,
                                              x_s.shape[3]))
                        top = (mesh.send(band[s - 1][:, :, -1:], pos[s - 1], p)
                               if s > 0 else zero)
                        bottom = (mesh.send(band[s + 1][:, :, :1], pos[s + 1],
                                            p) if s < n_dev - 1 else zero)
                        ext.append(torch.cat([top, x_s, bottom], dim=2))
                for s, p in enumerate(pos):
                    dev = mesh.devices[p]
                    with mesh.on(p):
                        band[s] = _halo_conv_layer(
                            ext[s], ks[dev][li], sh[dev][li],
                            accum_wrap=accum_wrap,
                            compute_dtype=compute_dtype)
            hb = band[0].shape[2]
            for s, p in enumerate(pos):
                with mesh.on(p):
                    out[d * bb:(d + 1) * bb, :,
                        s * hb:(s + 1) * hb].copy_(band[s], non_blocking=True)
            finish_on(mesh, out, pos)
        return out.reshape(b, cf, -1)

    return fn
