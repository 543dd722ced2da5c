"""Pipeline-parallel training: autograd through the GPipe schedule — the
port of ``tpu_cnn.parallel.pipeline_train``.

``parallel/pipeline.py`` runs the quantized inference contract as a GPipe
pipeline; this module is the training-side twin for the float phase-1
network (``train.train_cnn.float_forward``). As in JAX there is no
hand-written backward schedule: the host walks the same fill/drain
schedule as the serving pipeline, each stage's layers run on its
position's device and stream, the hop between stages is
``Mesh.hop`` (whose backward carries the cotangent back to the stage
that sent the activation, the transpose of the JAX ``ppermute``), and
``loss.backward()`` differentiates straight through it.

Layout: each stage's conv kernels are sent to that stage's position once
per step; ``fc_w``/``fc_b`` only to the last stage, the only one that
uses them. A 2-D ``(data, pipe)`` mesh runs independent pipelines with
the batch split across them. The JAX twin packs the stages into one
zero-padded stack for its SPMD program; the port runs each stage's real
channels, so nothing is padded, and autograd sums each weight's gradient
over the stages' positions into the one parameter.

``remat=True`` wraps each stage in ``torch.utils.checkpoint.checkpoint``
(non-reentrant), the counterpart of ``jax.checkpoint``: the backward
recomputes the stage's conv intermediates from its wire input instead of
keeping them for every microbatch; the results are unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.checkpoint import checkpoint

from tpu_cnn_torch.parallel.mesh import Home, Mesh
from tpu_cnn_torch.parallel.pipeline import split_stages


def pipelined_float_logits(mesh: Mesh, layer_configs: Sequence[tuple[int, int, int]],
                           *, microbatch: int = 4,
                           stages: Sequence[tuple[int, int]] | None = None,
                           remat: bool = False):
    """Returns ``f(params, images, home=None) -> (B, num_classes) f32
    logits`` (on ``home``'s device, by default the images'): the float
    phase-1 network as a GPipe pipeline over the mesh's ``pipe`` axis,
    differentiable. ``params`` is the trainer's dict (``conv{i}``,
    ``fc_w``, ``fc_b``); ``images`` is (B, H, W) float32 with B a multiple
    of ``microbatch`` times the data-shard count."""
    from tpu_cnn_torch.train.train_cnn import float_layer

    if mesh.axis_names not in (("pipe",), ("data", "pipe")):
        raise ValueError(
            f"mesh must be ('pipe',) or ('data', 'pipe'), got {mesh.axis_names}")
    n_data = mesh.shape.get("data", 1)
    n_stages = mesh.shape["pipe"]
    n_layers = len(layer_configs)
    bounds = list(stages) if stages is not None else split_stages(n_layers,
                                                                 n_stages)
    if len(bounds) != n_stages:
        raise ValueError(f"{len(bounds)} stages for a {n_stages}-device pipe")
    mb = int(microbatch)

    def pos_of(d: int, s: int) -> tuple:
        return (d, s) if n_data > 1 else (s,)

    def names(s: int) -> list[str]:
        start, end = bounds[s]
        return ([f"conv{li}" for li in range(start, end)]
                + (["fc_w", "fc_b"] if end == n_layers else []))

    def stage(s: int):
        start, end = bounds[s]

        def f(x, *weights):
            w = dict(zip(names(s), weights))
            for li in range(start, end):
                x = float_layer(x, w[f"conv{li}"])
            if end == n_layers:  # the last stage: GAP -> linear head
                return x.mean(dim=(2, 3)) @ w["fc_w"].T + w["fc_b"]
            return x

        if not remat:
            return f
        return lambda x, *weights: checkpoint(f, x, *weights,
                                              use_reentrant=False)

    fns = [stage(s) for s in range(n_stages)]

    def fn(params, images: torch.Tensor, home: Home | None = None) -> torch.Tensor:
        home = home or Home.of(images.device)
        b = images.shape[0]
        if b % (n_data * mb):
            raise ValueError(
                f"batch {b} not a multiple of microbatch {mb}"
                + (f" x data shards {n_data}" if n_data > 1 else ""))
        n_micro = b // n_data // mb
        w = {}
        for d in range(n_data):  # each stage's weights on its position
            for s in range(n_stages):
                pos = pos_of(d, s)
                with mesh.on(pos):
                    w[pos] = [mesh.hop(params[k], home, pos) for k in names(s)]
        logits = {}
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
                    with mesh.on(pos):
                        if s == 0:
                            r0 = (d * n_micro + m) * mb
                            x = mesh.hop(images[r0:r0 + mb], home, pos)[:, None]
                        else:
                            x = mesh.hop(wire.pop(s - 1), pos_of(d, s - 1), pos)
                        y = fns[s](x, *w[pos])
                        if s == n_stages - 1:
                            logits[d, m] = y
                        else:
                            wire[s] = y
        last = [pos_of(d, n_stages - 1) for d in range(n_data)]
        return torch.cat([mesh.hop(logits[d, m], last[d], home)
                          for d in range(n_data) for m in range(n_micro)])

    return fn


def make_pipeline_train_step(cfg, optimizer, mesh: Mesh, *,
                             microbatch: int = 4, remat: bool = False):
    """``train_cnn.make_train_step``'s step with forward and backward run
    as a GPipe pipeline over the mesh's ``pipe`` axis (optionally composed
    with ``data``): ``step(net, opt_state, images, labels) -> (loss,
    acc)``, integer labels."""
    from tpu_cnn_torch.train.train_cnn import twin_step

    return twin_step(optimizer, mesh, pipelined_float_logits(
        mesh, cfg.layer_configs, microbatch=microbatch, remat=remat))
