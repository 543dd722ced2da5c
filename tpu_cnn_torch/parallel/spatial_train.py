"""Spatial-parallel training: autograd through the halo exchange — the port
of ``tpu_cnn.parallel.spatial_train``.

The float phase-1 network (``train.train_cnn.float_forward``) runs with
image rows sharded over the mesh's ``space`` axis: before each conv layer
every band takes its upper neighbour's last row and its lower
neighbour's first row (zeros at the image's edge, the SAME padding), runs
the layer on the extended band without row padding, and the GAP head
becomes a per-band partial sum, summed over ``space`` on the row's first
position and divided by ``hf * wf``. The row hops are ``Mesh.hop``: their
backward carries each halo row's gradient back to the band that sent it,
as the transpose of the JAX ``ppermute`` does, and autograd sums the
replicated weights' gradients over the positions into the one parameter.
Weights stay whole (spatial parallelism shards activations). A 2-D
``(data, space)`` mesh splits the batch too.

The GAP's partial sums add in another order than the plain step's mean,
so the step matches the plain one to f32 rounding, not bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch

from tpu_cnn_torch.parallel.mesh import Home, Mesh
from tpu_cnn_torch.parallel.spatial import check_spatial_split


def spatial_float_logits(mesh: Mesh, layer_configs: Sequence[tuple[int, int, int]]):
    """Returns ``f(params, images, home=None) -> (B, num_classes) f32
    logits`` (on ``home``'s device, by default the images'): the float
    phase-1 network with image rows sharded over the mesh's ``space``
    axis, differentiable. ``images`` is (B, H, W) float32 with every
    layer's row count divisible by ``2 * n_space``
    (``check_spatial_split``)."""
    from tpu_cnn_torch.train.train_cnn import float_layer

    if mesh.axis_names not in (("space",), ("data", "space")):
        raise ValueError(
            f"mesh must be ('space',) or ('data', 'space'), got {mesh.axis_names}")
    n_data = mesh.shape.get("data", 1)
    n_dev = mesh.shape["space"]
    n_layers = len(layer_configs)

    def pos_of(d: int, s: int) -> tuple:
        return (d, s) if n_data > 1 else (s,)

    def fn(params, images: torch.Tensor, home: Home | None = None) -> torch.Tensor:
        home = home or Home.of(images.device)
        b, h, w = images.shape
        check_spatial_split(h, n_layers, n_dev)
        if b % n_data:
            raise ValueError(f"batch {b} not divisible by data axis {n_data}")
        bb, hl = b // n_data, h // n_dev
        hf, wf = h >> n_layers, w >> n_layers
        out = []
        for d in range(n_data):
            pos = [pos_of(d, s) for s in range(n_dev)]
            band, ks = [], []
            for s, p in enumerate(pos):
                with mesh.on(p):
                    ks.append([mesh.hop(params[f"conv{li}"], home, p)
                               for li in range(n_layers)])
                    band.append(mesh.hop(images[d * bb:(d + 1) * bb,
                                                s * hl:(s + 1) * hl], home, p)[:, None])
            for li in range(n_layers):
                ext = []
                for s, p in enumerate(pos):  # the exchange, then the layer
                    with mesh.on(p):
                        x = band[s]
                        zero = x.new_zeros((bb, x.shape[1], 1, x.shape[3]))
                        top = (mesh.hop(band[s - 1][:, :, -1:], pos[s - 1], p)
                               if s > 0 else zero)
                        bottom = (mesh.hop(band[s + 1][:, :, :1], pos[s + 1], p)
                                  if s < n_dev - 1 else zero)
                        ext.append(torch.cat([top, x, bottom], dim=2))
                for s, p in enumerate(pos):
                    with mesh.on(p):
                        band[s] = float_layer(ext[s], ks[s][li], padding=(0, 1))
            parts = []
            for s, p in enumerate(pos):
                with mesh.on(p):
                    parts.append(band[s].sum(dim=(2, 3)))
            first = pos[0]
            with mesh.on(first):
                total = parts[0]
                for s in range(1, n_dev):
                    total = total + mesh.hop(parts[s], pos[s], first)
                feats = total / (hf * wf)  # GAP over the whole image
                logits = (feats @ mesh.hop(params["fc_w"], home, first).T
                          + mesh.hop(params["fc_b"], home, first))
            out.append(mesh.hop(logits, first, home))
        return torch.cat(out)

    return fn


def make_spatial_train_step(cfg, optimizer, mesh: Mesh):
    """``train_cnn.make_train_step``'s step with image rows sharded over
    the mesh's ``space`` axis for forward and backward (optionally
    composed with ``data``): ``step(net, opt_state, images, labels) ->
    (loss, acc)``, integer labels."""
    from tpu_cnn_torch.train.train_cnn import twin_step

    return twin_step(optimizer, mesh, spatial_float_logits(mesh, cfg.layer_configs))
