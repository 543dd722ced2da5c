"""Two-phase QAT training: the port of ``tpu_cnn.train.train_cnn`` to PyTorch.

Phase 1 (float): train the conv backbone + GAP linear head (``TrainNet``)
with Adam + cosine LR, keeping the best-validation state (reference
``train_cnn.py:259-301``).

Phase 2 (QAT head): freeze the backbone, quantise its weights with the
global (or per-layer) symmetric scale, extract bit-accurate fixed-point
features through the contract's plain version with the 24-bit wrap
(``ops.quant.cnn_forward``, reference ``train_cnn.py:101-116,303-334``),
then fit the linear head on those features.

Export: weights.bin + fc_weight/bias.npy + classes.json + shifts.json +
test_image_*.bin, byte-compatible with the reference bundle
(``train_cnn.py:336-354``).

Every entry point takes an explicit device ("cuda" unless the caller asks
for "cpu"). Phase 1 is float work, which the JAX trainer runs in XLA and
not in Pallas: its convs are ``F.conv2d`` and its head a matmul, forward
and backward, with TF32 off and deterministic cuDNN (``exact_float``). Phase 2 runs the contract's
plain int32 version on the trainer's device, not the CUDA kernels: they
implement no 24-bit wrap.

The train step runs on a mesh of positions (``parallel.mesh.Mesh``) as the
JAX trainer's does: the (data, model) step and ZeRO-1 here, the GPipe
pipeline (``parallel.pipeline_train``) and the row-sharded step
(``parallel.spatial_train``); one process per host joins the others over
gloo (``parallel.multihost``), and a checkpoint path that is not a
``.npz`` is the sharded checkpoint directory (``train.checkpoint_sharded``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import signal
import threading
from collections import deque

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_cnn_torch.models.cnn import (
    CLASS_NAMES,
    DEFAULT_SHIFTS,
    LAYER_CONFIGS,
    NUM_CLASSES,
    QUANT_MAX,
)
from tpu_cnn_torch.ops import quant
from tpu_cnn_torch.parallel.mesh import Home, Mesh, RowShards
from tpu_cnn_torch.utils import artifacts as art
from tpu_cnn_torch.utils import weights as weights_codec

Params = dict[str, torch.Tensor]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class TrainConfig:
    layer_configs: tuple = LAYER_CONFIGS
    num_classes: int = NUM_CLASSES
    shifts: tuple = DEFAULT_SHIFTS
    epochs: int = 30
    batch_size: int = 64
    lr: float = 1e-3
    # 600 full-batch Adam steps is convergence-marginal on hard feature
    # matrices (the JAX trainer's measurement on the augmented realphoto
    # backbone); 3000 converges robustly at these head sizes.
    head_epochs: int = 3000
    head_lr: float = 0.01
    seed: int = 0
    # quantise each conv layer with its own symmetric scale instead of the
    # reference's single global one (utils.weights.quantize_per_layer).
    # Runtime contract unchanged.
    per_layer_scale: bool = False


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; "cuda" raises where torch finds no
    card, so no entry point falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but torch finds no CUDA device")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


@contextlib.contextmanager
def exact_float():
    """Full-f32 convs and matmuls and deterministic cuDNN algorithms inside
    the scope, the previous flags restored after it.

    TF32 off is the counterpart of the JAX trainer's ``Precision.HIGHEST``:
    PyTorch lets cuDNN run an f32 conv as TF32 by default, and a backbone
    trained under that noise quantises badly
    (``tpu_cnn.train.train_cnn.float_forward``'s note: 64.8% against 94.8%
    held out on a TPU). Deterministic cuDNN makes a run repeat itself, as
    the JAX trainer's do: with cuDNN's default backward, three runs of the
    real-photo recipe from one initial draw scored 82.9-95.9% held out on
    an H100 (PERF.md). The flags are not flipped for good: the contract's
    f32 path refuses to run while TF32 matmuls are on, and the apps run
    after a training call."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    old = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic)
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    cudnn.deterministic = True
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = old


class TrainNet(nn.Module):
    """The phase-1 float net. Its parameters carry the JAX package's names
    and layouts: ``conv{i}`` (oc, ic, 3, 3) (torch's OIHW), ``fc_w``
    (K, C) and ``fc_b`` (K,)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t))

    @property
    def n_layers(self) -> int:
        return sum(1 for name, _ in self.named_parameters()
                   if name.startswith("conv"))

    def params(self) -> Params:
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor,
                compute_dtype: str = "float32") -> torch.Tensor:
        return float_forward(self.params(), images, self.n_layers, compute_dtype)


def init_params(cfg: TrainConfig, generator: torch.Generator) -> TrainNet:
    """He-normal conv kernels, an ``N(0, 1/C)`` fc and a zero bias, as the
    JAX ``init_params`` (``train_cnn.py:70-85``), drawn on the host from
    ``generator`` so that one seed gives one net on every device. The
    stream is torch's, not ``jax.random``'s: a seed draws other numbers
    than the JAX trainer's, so the tests carry parameters across with
    :func:`params_from_numpy` instead of comparing initialisations."""
    t = {}
    for i, (ic, oc, _) in enumerate(cfg.layer_configs):
        t[f"conv{i}"] = (torch.randn((oc, ic, 3, 3), generator=generator)
                         * math.sqrt(2.0 / (ic * 9)))
    c_last = cfg.layer_configs[-1][1]
    t["fc_w"] = (torch.randn((cfg.num_classes, c_last), generator=generator)
                 * math.sqrt(1.0 / c_last))
    t["fc_b"] = torch.zeros((cfg.num_classes,))
    return TrainNet(t)


def params_from_numpy(arrays: dict[str, np.ndarray], device="cpu") -> TrainNet:
    """A ``TrainNet`` holding the JAX trainer's parameter dict (numpy)."""
    convs = sorted((k for k in arrays if k.startswith("conv")),
                   key=lambda k: int(k[4:]))
    return TrainNet({k: torch.tensor(np.asarray(arrays[k], np.float32),
                                     device=device)
                     for k in (*convs, "fc_w", "fc_b")})


def params_to_numpy(net: TrainNet) -> dict[str, np.ndarray]:
    """The JAX trainer's parameter dict (numpy) of a ``TrainNet``."""
    return {k: v.detach().cpu().numpy() for k, v in net.named_parameters()}


def float_layer(x: torch.Tensor, k: torch.Tensor, padding=1) -> torch.Tensor:
    """One float phase-1 layer: conv3x3 -> relu -> 2x2 max pool. The pool
    is a max over a reshape, whose gradient splits evenly between equal
    values, as the JAX trainer's does (``F.max_pool2d`` would send it all
    to one of them, and after the ReLU many values tie at zero)."""
    # a float conv, as the JAX trainer's lax.conv_general_dilated: the rule
    # that the plain versions never call conv2d (ROADMAP C.3) binds the
    # exact integer contract, not this float trainer
    x = F.relu(F.conv2d(x, k, padding=padding))
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def float_forward(params: Params, images: torch.Tensor, n_layers: int,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Float phase-1 network: conv3x3 (SAME) -> relu -> 2x2 max pool, x N
    -> GAP -> linear. ``images``: (B, S, S) float32 in [0, 1].

    ``compute_dtype="bfloat16"`` is the mixed-precision mode (``--bf16``):
    the parameters stay f32 (master weights), the conv inputs and kernels
    are cast to bf16, activations travel bf16 between layers, and the GAP
    and linear head run f32. Run it under :func:`exact_float` for f32 on a
    card."""
    cdt = DTYPES[compute_dtype]
    x = images[:, None].to(cdt)
    for i in range(n_layers):
        x = float_layer(x, params[f"conv{i}"].to(cdt))
    feats = x.to(torch.float32).mean(dim=(2, 3))  # GAP (B, C)
    return feats @ params["fc_w"].T + params["fc_b"]


def fake_quant_convs(params: Params, n_layers: int,
                     per_layer: bool = False) -> Params:
    """Straight-through fake quantisation of the conv kernels to the exact
    export grid (one global symmetric scale, or one per layer; the
    ``QUANT_MAX`` clip), as ``w + (wq - w).detach()``: the forward sees the
    dequantised int8 weights the engines run, the backward passes the
    gradient straight through the rounding (``train_cnn --qat``)."""
    convs = [params[f"conv{i}"] for i in range(n_layers)]
    out = dict(params)
    with torch.no_grad():
        absmax_all = torch.stack([c.abs().max() for c in convs]).max().clamp_min(1e-8)
    for i, w in enumerate(convs):
        with torch.no_grad():
            absmax = w.abs().max().clamp_min(1e-8) if per_layer else absmax_all
            scale = absmax.new_tensor(QUANT_MAX) / absmax
            wq = torch.clamp(torch.round(w * scale), -QUANT_MAX, QUANT_MAX) / scale
        out[f"conv{i}"] = w + (wq - w).detach()
    return out


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            n_layers: int, compute_dtype: str = "float32", qat: bool = False,
            qat_per_layer: bool = False, soft_bce: bool = False):
    """(mean loss, train accuracy) of a batch (:func:`logits_loss`)."""
    if qat:
        params = fake_quant_convs(params, n_layers, qat_per_layer)
    return logits_loss(float_forward(params, images, n_layers, compute_dtype),
                       labels, soft_bce)


def logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                soft_bce: bool = False):
    """(mean loss, accuracy) of a batch's logits. Integer labels: softmax
    cross-entropy. Dense (B, K) targets (singles one-hot and the
    ``--composite-frac`` composites): softmax cross-entropy, or per-class
    sigmoid BCE under ``soft_bce``. Under ``soft_bce`` a row counts as a
    hit when the predicted class is present in it: multi-hot 1/1 rows have
    no dominant class, so the JAX trainer's ``labels.argmax`` scores noise
    there. The loss is the JAX trainer's in every case."""
    pred = logits.argmax(-1)
    if labels.dim() == 2:
        if soft_bce:
            loss = F.binary_cross_entropy_with_logits(logits, labels)
            acc = (labels.gather(1, pred[:, None])[:, 0] > 0).float().mean()
        else:
            loss = -(labels * F.log_softmax(logits, -1)).sum(-1).mean()
            acc = (pred == labels.argmax(-1)).float().mean()
    else:
        loss = F.cross_entropy(logits, labels.long())
        acc = (pred == labels).float().mean()
    return loss, acc


class AdamCosine:
    """The JAX trainer's optimiser on tensors, updating the parameters in
    place: ``optax.chain(scale_by_adam(), scale_by_schedule(
    cosine_decay_schedule(1.0, decay_steps)), scale(-lr))`` (b1 0.9, b2
    0.999, eps 1e-8 outside the square root), wrapped in
    ``optax.MultiSteps(every_k)`` for ``every_k > 1``: one update per
    ``every_k`` calls, on the running mean of their gradients, the schedule
    counting updates. ``decay_steps=None`` holds the scale at 1, which is
    ``optax.adam(lr)`` (the head fits). The arithmetic follows optax's op
    for op in f32, so equal gradients give equal parameters to f32
    rounding.

    The state is a dict of tensors and step counts; ``leaves`` lists it in
    the order of the JAX optimiser state's pytree leaves (the checkpoint
    format)."""

    def __init__(self, lr: float, decay_steps: int | None = None,
                 every_k: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if decay_steps is not None and decay_steps <= 0:
            raise ValueError(f"decay_steps must be positive, got {decay_steps}")
        self.lr, self.decay_steps, self.every_k = lr, decay_steps, max(1, every_k)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> dict:
        def zeros():
            return {k: torch.zeros_like(p) for k, p in params.items()}

        state = {"count": 0, "mu": zeros(), "nu": zeros(), "sched_count": 0}
        if self.every_k > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    def schedule(self, count: int) -> float:
        """The cosine multiplier at update ``count``, in f32 as optax's."""
        if self.decay_steps is None:
            return 1.0
        f = np.float32
        c = f(min(count, self.decay_steps))
        return float(f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(self.decay_steps))))

    @torch.no_grad()
    def update(self, params: Params, grads: Params, state: dict) -> None:
        if self.every_k > 1:
            n = state["mini_step"]
            for k, g in grads.items():
                acc = state["acc"][k]
                acc.copy_(acc + (g - acc) / (n + 1))
            if n < self.every_k - 1:
                state["mini_step"] = n + 1
                return
            state["mini_step"] = 0
            state["gradient_step"] += 1
            grads = state["acc"]
        t = state["count"] + 1
        # host scalars, rounded to f32 as optax's are: a device scalar
        # would cost a host-to-device copy per step
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(t))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(t))
        scale = self.schedule(state["sched_count"])
        keys = list(params)
        ps, gs = [params[k] for k in keys], [grads[k] for k in keys]
        mus, nus = [state["mu"][k] for k in keys], [state["nu"][k] for k in keys]
        # optax's (1 - b) * g + b * m, each product rounded, over every
        # parameter in one multi-tensor launch per op
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1 - self.b1))
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                                    1 - self.b2))
        den = torch._foreach_sqrt(torch._foreach_div(nus, bc2))
        torch._foreach_add_(den, self.eps)
        u = torch._foreach_div(torch._foreach_div(mus, bc1), den)
        torch._foreach_mul_(u, scale)
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_(ps, u)
        state["count"] = t
        state["sched_count"] += 1
        if self.every_k > 1:
            torch._foreach_zero_(list(state["acc"].values()))

    def leaves(self, state: dict) -> list:
        """The state in the JAX optimiser state's leaf order: [MultiSteps'
        mini_step, gradient_step,] Adam's count, mu and nu (parameters by
        name), the schedule's count[, the accumulated gradients]. A ZeRO-1
        leaf (``RowShards``) comes out whole, which only a process holding
        every block can give."""
        names = sorted(state["mu"])

        def count(n):
            return np.asarray(n, np.int32)

        def whole(t):
            if not isinstance(t, RowShards):
                return t
            if not t.local:
                raise ValueError(
                    "this process holds only its blocks of a ZeRO-1 moment; "
                    "a single-file .npz snapshot cannot hold it — use a "
                    "sharded checkpoint DIR (each host writes its shards)")
            return torch.cat([p.detach().cpu() for p in t.parts])

        inner = ([count(state["count"])] + [whole(state["mu"][k]) for k in names]
                 + [whole(state["nu"][k]) for k in names]
                 + [count(state["sched_count"])])
        if self.every_k == 1:
            return inner
        return ([count(state["mini_step"]), count(state["gradient_step"])] + inner
                + [whole(state["acc"][k]) for k in names])

    def from_leaves(self, leaves: list, like: dict) -> dict:
        """The inverse of :meth:`leaves`: a state shaped as ``like``, on
        its tensors' devices (a ``RowShards`` leaf of ``like`` as its
        blocks of the loaded array)."""
        names = sorted(like["mu"])
        it = iter(leaves)
        state = {}
        if self.every_k > 1:
            state["mini_step"], state["gradient_step"] = int(next(it)), int(next(it))

        def tensors(group):
            out = {}
            for k in names:
                a = torch.as_tensor(np.asarray(next(it)), dtype=torch.float32)
                t = like[group][k]
                if isinstance(t, RowShards):
                    out[k] = dataclasses.replace(t, parts=[
                        a[t.rows(i)].to(p.device).clone()
                        for i, p in enumerate(t.parts)])
                else:
                    out[k] = a.to(t.device).clone()
            return out

        state["count"] = int(next(it))
        state["mu"], state["nu"] = tensors("mu"), tensors("nu")
        state["sched_count"] = int(next(it))
        if self.every_k > 1:
            state["acc"] = tensors("acc")
        return state


def param_shard(name: str, p: torch.Tensor, m: int, j: int) -> torch.Tensor:
    """Model-axis position ``j``'s block of parameter ``name`` (of ``m``):
    a conv's output channels and ``fc_w``'s feature columns are split,
    ``fc_b`` is whole. The counterpart of the JAX trainer's
    ``param_shardings``."""
    if name.startswith("conv"):
        n = p.shape[0] // m
        return p[j * n:(j + 1) * n]
    if name == "fc_w":
        n = p.shape[1] // m
        return p[:, j * n:(j + 1) * n]
    return p


def zero1_constrain(opt_state: dict, mesh: Mesh) -> dict:
    """ZeRO-1, the counterpart of the JAX trainer's ``_zero1_constrain``:
    every Adam moment (and ``--grad-accum`` accumulator) leaf whose leading
    dim is > 1 and divides by the data positions of every process is held
    as ``RowShards``, this process's blocks on its data positions; scalars
    and indivisible leaves stay whole. In place; returns ``opt_state``."""
    from tpu_cnn_torch.parallel import multihost as mh

    n_data = mesh.shape["data"]
    n_blocks = n_data * mh.process_count()
    first = n_data * mh.process_index()
    positions = [(d,) + (0,) * (len(mesh.axis_names) - 1) for d in range(n_data)]
    for group in ("mu", "nu", "acc"):
        for k, t in opt_state.get(group, {}).items():
            if (isinstance(t, RowShards) or t.dim() < 1 or t.shape[0] <= 1
                    or t.shape[0] % n_blocks):
                continue
            rows = t.shape[0] // n_blocks
            parts = []
            for i, pos in enumerate(positions):
                with mesh.on(pos):
                    blk = t[(first + i) * rows:(first + i + 1) * rows]
                    parts.append(blk.to(mesh.devices[pos], copy=True))
            opt_state[group][k] = RowShards(parts, positions, first, n_blocks)
    return opt_state


def _zero1_update(optimizer: AdamCosine, mesh: Mesh, params: Params,
                  grads: Params, state: dict, home: Home) -> None:
    """The optimiser update of a ZeRO-1 state: each data position updates
    its blocks of the sharded moments and the parameter rows they cover,
    the whole leaves are updated once, and the updated blocks are
    gathered into the parameters (from the other processes too)."""
    from tpu_cnn_torch.parallel import multihost as mh

    sharded = [k for k in params if isinstance(state["mu"][k], RowShards)]
    whole = [k for k in params if k not in sharded]
    counters = {c: state[c] for c in ("count", "sched_count", "mini_step",
                                      "gradient_step") if c in state}
    groups = [g for g in ("mu", "nu", "acc") if g in state]
    after = counters
    if sharded:
        lead = state["mu"][sharded[0]]
        for i, pos in enumerate(lead.positions):
            sub = dict(counters, **{g: {k: state[g][k].parts[i] for k in sharded}
                                    for g in groups})
            p_blk, target = {}, {}
            with mesh.on(pos):
                for k in sharded:
                    rows = state["mu"][k].rows(i)
                    target[k] = params[k].detach()[rows]
                    p_blk[k] = mesh.send(target[k], home, pos)
                optimizer.update(p_blk, {k: mesh.send(grads[k][state["mu"][k].rows(i)],
                                                      home, pos) for k in sharded},
                                 sub)
            for k in sharded:  # gather: a block held apart is copied back
                if p_blk[k].data_ptr() != target[k].data_ptr():
                    target[k].copy_(mesh.send(p_blk[k], pos, home))
            after = sub
    if whole:
        sub = dict(counters, **{g: {k: state[g][k] for k in whole} for g in groups})
        optimizer.update({k: params[k] for k in whole},
                         {k: grads[k] for k in whole}, sub)
        after = sub
    mesh.join(home)
    for c in counters:
        state[c] = after[c]
    if sharded and mh.process_count() > 1:
        mh.allgather_blocks_([params[k].detach() for k in sharded],
                             [state["mu"][k] for k in sharded])


def _data_model_loss(mesh: Mesh, params: Params, images: torch.Tensor,
                       labels: torch.Tensor, n_layers: int, cdt, soft_bce: bool,
                       home: Home):
    """(loss, accuracy) of the batch on a (data, model) mesh: the batch in
    equal row blocks, one per data row; on each position its model block
    of every conv's output channels, the activations gathered over the
    row after each layer but the last, and its block of ``fc_w``'s
    feature columns, the row's partial logits summed on its first
    position. The loss and accuracy are the whole batch's: each block's
    weighted by its share."""
    n_data, m = mesh.devices.shape
    b = images.shape[0]
    if b % n_data:
        raise ValueError(f"batch {b} not divisible by data axis {n_data}")
    rows = b // n_data
    x, w = {}, {}
    for pos in mesh.positions():
        d, j = pos
        with mesh.on(pos):
            w[pos] = {k: mesh.hop(param_shard(k, v, m, j), home, pos)
                      for k, v in params.items()}
            x[pos] = mesh.hop(images[d * rows:(d + 1) * rows], home, pos)[:, None].to(cdt)
    for li in range(n_layers):
        y = {}
        for pos in x:
            with mesh.on(pos):
                y[pos] = float_layer(x[pos], w[pos][f"conv{li}"].to(cdt))
        if m == 1 or li == n_layers - 1:
            x = y
            continue
        x = {}
        for dst in y:  # the all-gather over the model axis
            with mesh.on(dst):
                x[dst] = torch.cat([mesh.hop(y[(dst[0], j)], (dst[0], j), dst)
                                    for j in range(m)], dim=1)
    loss = acc = None
    for d in range(n_data):
        row = [(d, j) for j in range(m)]
        parts = {}
        for pos in row:
            with mesh.on(pos):
                feats = x[pos].to(torch.float32).mean(dim=(2, 3))
                parts[pos] = feats @ w[pos]["fc_w"].T
        first = row[0]
        with mesh.on(first):
            logits = parts[first]
            for pos in row[1:]:
                logits = logits + mesh.hop(parts[pos], pos, first)
            l_d, a_d = logits_loss(logits + w[first]["fc_b"],
                                   mesh.send(labels[d * rows:(d + 1) * rows],
                                             home, first), soft_bce)
        l_d, a_d = mesh.hop(l_d, first, home) / n_data, mesh.send(a_d, first, home) / n_data
        loss, acc = (l_d, a_d) if loss is None else (loss + l_d, acc + a_d)
    return loss, acc


def make_train_step(cfg: TrainConfig, optimizer: AdamCosine,
                    mesh: Mesh | None = None, *, microbatch: int = 4,
                    remat: bool = False, zero1: bool = False,
                    compute_dtype: str = "float32", qat: bool = False,
                    qat_per_layer: bool | None = None, soft_bce: bool = False):
    """``step(net, opt_state, images, labels) -> (loss, acc)``: one
    training step (forward, backward, optimiser update, with TF32 off),
    updating ``net`` and ``opt_state`` in place; loss and accuracy stay
    on ``net``'s device.

    Without a mesh the plain step. With a ``data``/``model`` mesh the
    batch is split over ``data`` and the conv output channels and fc
    feature dim over ``model`` (:func:`param_shard`), the gradient being
    the whole batch's, and under multi-host all-reduced over every
    process. With a ``pipe`` mesh (``make_pipeline_mesh``) forward and
    backward run as a GPipe pipeline with stage-held weights
    (``parallel.pipeline_train``); with a ``space`` mesh
    (``make_spatial_mesh``) image rows are sharded with a halo exchange
    (``parallel.spatial_train``). ``zero1=True`` (pure-dp mesh only)
    holds the optimiser state in data-position blocks
    (:func:`zero1_constrain`). ``compute_dtype="bfloat16"`` runs the conv
    math in bf16 with f32 master weights (``float_forward``)."""
    axes = () if mesh is None else mesh.axis_names
    if compute_dtype != "float32" and ("pipe" in axes or "space" in axes):
        raise ValueError(
            "bf16 compute is supported on the plain / data / model train "
            "steps; the pipe/space twins run f32")
    if qat and ("pipe" in axes or "space" in axes):
        raise ValueError(
            "qat=True (STE fake-quant) is supported on the plain / data / "
            "model train steps; the pipe/space twins run plain float")
    if "pipe" in axes:
        from tpu_cnn_torch.parallel.pipeline_train import make_pipeline_train_step

        return make_pipeline_train_step(cfg, optimizer, mesh,
                                        microbatch=microbatch, remat=remat)
    if "space" in axes:
        from tpu_cnn_torch.parallel.spatial_train import make_spatial_train_step

        return make_spatial_train_step(cfg, optimizer, mesh)
    if zero1 and (mesh is None or "data" not in axes
                  or mesh.shape.get("model", 1) != 1):
        raise ValueError(
            "zero1=True needs a pure data-parallel mesh (model axis 1) — "
            "moments follow the data axis, which conflicts with "
            "model-sharded params")
    n_layers = len(cfg.layer_configs)
    per_layer = cfg.per_layer_scale if qat_per_layer is None else qat_per_layer
    cdt = DTYPES[compute_dtype]
    if mesh is not None:
        if axes != ("data", "model"):
            raise ValueError(f"mesh must be ('data', 'model'), got {axes}")
        m = mesh.shape["model"]
        if any(oc % m for _, oc, _ in cfg.layer_configs):
            raise ValueError(f"model axis {m} must divide every layer's "
                             f"output channels {[oc for _, oc, _ in cfg.layer_configs]}")

    def step(net: TrainNet, opt_state: dict, images: torch.Tensor,
             labels: torch.Tensor):
        params = net.params()
        with exact_float():
            for p in params.values():
                p.grad = None
            # the mesh reads the parameters through home-stream ops, so
            # that their gradients accumulate on the home stream
            used = (fake_quant_convs(params, n_layers, per_layer) if qat
                    else {k: v.view_as(v) for k, v in params.items()})
            if mesh is None:
                loss, acc = logits_loss(float_forward(used, images, n_layers,
                                                      compute_dtype), labels, soft_bce)
                loss.backward()
                optimizer.update(params, {k: p.grad for k, p in params.items()},
                                 opt_state)
                return loss.detach(), acc
            from tpu_cnn_torch.parallel import multihost as mh

            home = Home.of(images.device)
            loss, acc = _data_model_loss(mesh, used, images, labels, n_layers,
                                           cdt, soft_bce, home)
            loss.backward()
            mesh.join(home)
            grads = {k: p.grad for k, p in params.items()}
            loss = loss.detach()
            if mh.process_count() > 1:  # the gradient over every process
                mh.allreduce_mean_([*grads.values(), loss, acc])
            if zero1:
                _zero1_update(optimizer, mesh, params, grads,
                              zero1_constrain(opt_state, mesh), home)
            else:
                optimizer.update(params, grads, opt_state)
        return loss, acc

    return step


def twin_step(optimizer: AdamCosine, mesh: Mesh, logits_fn):
    """The train step of the pipe and space twins: ``logits_fn(params,
    images, home)`` differentiated by autograd through the mesh's hops,
    integer labels only (as the JAX twins' loss), then the plain optimiser
    update. Returns ``step(net, opt_state, images, labels) -> (loss,
    acc)``."""

    def step(net: TrainNet, opt_state: dict, images: torch.Tensor,
             labels: torch.Tensor):
        if labels.dim() != 1:
            raise ValueError(
                "the pipe/space train steps take integer labels only, as "
                "the JAX twins do: dense --composite-frac targets have no "
                "pipelined or row-sharded step")
        params = net.params()
        home = Home.of(images.device)
        with exact_float():
            for p in params.values():
                p.grad = None
            # read through home-stream ops: the gradients accumulate there
            logits = logits_fn({k: v.view_as(v) for k, v in params.items()},
                               images, home)
            loss, acc = logits_loss(logits, labels)
            loss.backward()
            mesh.join(home)
            optimizer.update(params, {k: p.grad for k, p in params.items()},
                             opt_state)
        return loss.detach(), acc

    return step


def quantized_kernels(params: Params, cfg: TrainConfig):
    """int8 conv kernels + scale(s): the reference's single global
    symmetric scale, or per-layer scales when cfg.per_layer_scale."""
    floats = [params[f"conv{i}"].detach().cpu().numpy()
              for i in range(len(cfg.layer_configs))]
    if cfg.per_layer_scale:
        return weights_codec.quantize_per_layer(floats, QUANT_MAX)
    return weights_codec.quantize_global(floats, QUANT_MAX)


def extract_qat_features(params: Params, images: np.ndarray, cfg: TrainConfig,
                         batch_size: int = 256, device=None) -> np.ndarray:
    """Bit-accurate fixed-point GAP features (B, C_last) float32 in [0, 255]:
    the reference's phase-2 feature extractor (``train_cnn.py:154-170``),
    the contract's plain int32 version with the 24-bit wrap on ``device``
    (default: the parameters'). Not the CUDA kernels: they implement no
    wrap, and it is not always a no-op (lyr4-wide's L3 sums 576 products
    of up to 255 * 127, past 2^24)."""
    q_kernels, _ = quantized_kernels(params, cfg)
    dev = torch.device(device) if device is not None else params["conv0"].device
    kernels = [torch.as_tensor(k, device=dev) for k in q_kernels]
    shifts = torch.tensor(cfg.shifts, dtype=torch.int32)
    out = []
    for s in range(0, len(images), batch_size):
        chunk = images[s : s + batch_size]
        x_u8 = torch.as_tensor(np.round(chunk * 255.0).astype(np.uint8), device=dev)
        feats = quant.cnn_forward(x_u8, kernels, shifts, accum_wrap=True,
                                  compute_dtype="int32")
        out.append(feats.to(torch.float32).mean(dim=2).cpu().numpy())
    return (np.concatenate(out) if out
            else np.zeros((0, cfg.layer_configs[-1][1]), np.float32))


def fit_head(features: np.ndarray, labels: np.ndarray, cfg: TrainConfig,
             val_frac: float = 0.15, verbose: bool = True,
             max_chunks: int = 10, device="cuda"):
    """Adam-fit the linear head on frozen features (``train_cnn.py:320-334``)
    on ``device``: full-batch steps in chunks of ``cfg.head_epochs``, going
    on (up to ``max_chunks``) while the train CE still falls by 1e-4 a
    chunk (patience 2), and returning the chunk-boundary weights with the
    best internal-val accuracy. The gradient is written out (softmax minus
    one-hot over N), so a step is a handful of launches."""
    dev = resolve_device(device)
    n = len(features)
    rng = np.random.RandomState(cfg.seed)
    idx = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    vi, ti = idx[:n_val], idx[n_val:]

    def on_dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    X, y = on_dev(features[ti], torch.float32), on_dev(labels[ti], torch.int64)
    Xv, yv = on_dev(features[vi], torch.float32), on_dev(labels[vi], torch.int64)
    onehot_n = F.one_hot(y, cfg.num_classes).to(torch.float32)
    d = features.shape[1]
    p = {"w": torch.zeros((cfg.num_classes, d), device=dev),
         "b": torch.zeros((cfg.num_classes,), device=dev)}
    opt = AdamCosine(cfg.head_lr)
    state = opt.init(p)

    def train_loss():
        return F.cross_entropy(X @ p["w"].T + p["b"], y)

    def acc(Xs, ys):
        return float(((Xs @ p["w"].T + p["b"]).argmax(-1) == ys).float().mean())

    prev, flat = float("inf"), 0
    best = (-1.0, None)
    with exact_float():
        for _ in range(max(1, max_chunks)):
            for _ in range(cfg.head_epochs):
                g = (torch.softmax(X @ p["w"].T + p["b"], -1) - onehot_n) / len(X)
                opt.update(p, {"w": g.T @ X, "b": g.sum(0)}, state)
            va = acc(Xv, yv)
            if va > best[0]:
                best = (va, {k: v.clone() for k, v in p.items()})
            # stop on the loss, not the accuracy: argmax accuracy sits on
            # long plateaus while CE still descends
            cur = float(train_loss())
            flat = flat + 1 if prev - cur < 1e-4 else 0
            if flat >= 2:
                break
            prev = cur
        p = best[1]
        if verbose:
            print(f"  head: train {acc(X, y) * 100:.1f}%  "
                  f"val {acc(Xv, yv) * 100:.1f}%")
    return p["w"].cpu().numpy(), p["b"].cpu().numpy()


def export_test_images(images: np.ndarray, labels: np.ndarray, out_dir: str,
                       num_per_class: int = 10, num_classes: int = NUM_CLASSES):
    """Raw 128x128 .bin exports named test_image_N_classC.bin
    (``train_cnn.py:199-216``)."""
    os.makedirs(out_dir, exist_ok=True)
    counts: dict[int, int] = {}
    exported = 0
    for img, label in zip(images, labels):
        c = int(label)
        if counts.get(c, 0) >= num_per_class:
            continue
        counts[c] = counts.get(c, 0) + 1
        raw = np.round(img * 255.0).astype(np.uint8)
        raw.tofile(os.path.join(out_dir, f"test_image_{exported}_class{c}.bin"))
        exported += 1
        if all(counts.get(j, 0) >= num_per_class for j in range(num_classes)):
            break
    return exported


def _lookahead(it, depth: int = 2):
    """Pull ``depth`` items ahead of the consumer."""
    q: deque = deque()
    for item in it:
        q.append(item)
        if len(q) >= depth:
            yield q.popleft()
    while q:
        yield q.popleft()


def _prefetch_to_device(host_batches, device: torch.device, depth: int = 2):
    """Stage host batches on ``device`` ``depth`` ahead of consumption: on a
    card, pinned host tensors copied with ``non_blocking=True``, so the
    copy of batch k+1 overlaps step k. Integer labels travel as int64,
    dense targets as float32. (The JAX trainer casts every label array to
    int32 here, which zeroes the 0.5/0.5 targets of ``--composite-loss
    ce``; the port keeps them.)"""
    pin = device.type == "cuda"

    def staged():
        for bi, bl in host_batches:
            ti = torch.from_numpy(np.ascontiguousarray(bi, np.float32))
            tl = torch.from_numpy(np.ascontiguousarray(
                bl, np.float32 if np.ndim(bl) == 2 else np.int64))
            if pin:
                ti, tl = ti.pin_memory(), tl.pin_memory()
            yield ti.to(device, non_blocking=True), tl.to(device, non_blocking=True)

    return _lookahead(staged(), depth)


def train(cfg: TrainConfig, train_data, val_data, out_dir: str,
          class_names=None, mesh: Mesh | None = None, verbose: bool = True,
          checkpoint_path: str | None = None, resume: bool = False,
          microbatch: int = 4, remat: bool = False, zero1: bool = False,
          compute_dtype: str = "float32", grad_accum: int = 1,
          augment: bool = False, qat: bool = False, aux_data=None,
          aux_bce: bool = False, device="cuda", init=None):
    """Full two-phase pipeline on ``device``. ``train_data``/``val_data``
    are (images (N, S, S) f32 [0,1], labels (N,)) tuples. Returns the
    exported ArtifactBundle, or None when SIGTERM stopped phase 1.

    ``mesh``, ``microbatch``, ``remat`` and ``zero1`` pick the train step
    (:func:`make_train_step`); the parameters live on ``device``, the
    mesh's positions hold their blocks during a step.

    ``aux_data`` = (images (M, S, S) f32, soft_targets (M, K) f32): extra
    phase-1-only frames with dense soft targets (``data.soft_composites``),
    mixed with one-hot singles under softmax CE; ``aux_bce=True`` switches
    every phase-1 frame to per-class sigmoid BCE and binarises the
    composite targets to multi-hot 1/1. Phase 2, best-val selection and
    export see only the clean single-label data. The pipe and space steps
    take integer labels only, so they refuse ``aux_data``.

    ``init``: phase 1's starting parameters as a ``params_to_numpy`` dict
    (the JAX trainer's draw, say), in place of ``init_params``' draw.

    Multi-host (more than one process joined by
    ``parallel.multihost.init_multihost``): ``mesh`` is this process's
    data-only mesh, every process walks the same batches and feeds its
    slice of each (``global_batches``), the step all-reduces the gradient;
    only the primary prints, writes ``.npz`` snapshots and exports, while
    every process computes the bundle.

    SIGTERM (from the main thread) finishes the current epoch, writes the
    checkpoint and returns None for a later ``resume`` (under multi-host
    every process stops after the same epoch); the previous handler is
    restored on the way out. A ``.npz`` checkpoint holds the parameters,
    the optimiser state, the best-val state and the permutation and
    augmentation RNG; any other path is the sharded checkpoint directory
    (``checkpoint_sharded``), which holds the same. A resumed run continues
    the unbroken one (exactly, on the CPU)."""
    from tpu_cnn_torch.parallel import multihost as mh
    from tpu_cnn_torch.train import checkpoint as ckpt
    from tpu_cnn_torch.train.data import augment_batch, batches

    dev = resolve_device(device)
    class_names = list(class_names or CLASS_NAMES[: cfg.num_classes])
    imgs_t, labels_t = train_data
    imgs_v, labels_v = val_data
    imgs_p1, labels_p1 = imgs_t, labels_t
    axes = () if mesh is None else mesh.axis_names
    if aux_data is not None and ("pipe" in axes or "space" in axes):
        raise ValueError(
            "dense composite targets (--composite-frac) have no pipelined or "
            "row-sharded step: the pipe/space twins take integer labels only")
    if aux_data is not None:
        aux_imgs, aux_soft = aux_data
        aux_soft = np.asarray(aux_soft, np.float32)
        if aux_bce:
            aux_soft = (aux_soft > 0).astype(np.float32)
        onehot = np.eye(cfg.num_classes, dtype=np.float32)[
            np.asarray(labels_t, int)]
        imgs_p1 = np.concatenate([imgs_t, np.asarray(aux_imgs, np.float32)])
        labels_p1 = np.concatenate([onehot, aux_soft])

    # multi-host: the step and mesh are this process's; the feeding and
    # the host-side singletons (prints, .npz snapshots, export) differ
    multihost = mh.process_count() > 1
    if multihost:
        if (mesh is None or "data" not in axes or mesh.shape.get("model", 1) != 1
                or "pipe" in axes or "space" in axes):
            raise ValueError(
                "multi-host training currently rides pure data parallelism "
                "— pass a data-only mesh (model/pipe/space axes are "
                "single-process features for now)")
        # every rank decides on the gathered counts, so all refuse together
        counts = mh._all_gather_ints([mesh.size])[:, 0]
        if cfg.batch_size % int(counts.sum()):
            raise ValueError(
                f"batch_size {cfg.batch_size} must divide by the GLOBAL "
                f"device count {int(counts.sum())} (the data axis spans every "
                "chip of every host)")
        # global_batches slices equal per-process shares: refuse an uneven
        # topology up front instead of mis-sharding at step 1
        if int(counts.min()) != int(counts.max()):
            raise ValueError(
                "multi-host training needs a homogeneous topology (equal "
                f"local device counts per host; saw {counts.tolist()})")
        if zero1 and checkpoint_path and checkpoint_path.endswith(".npz"):
            raise ValueError(
                "multi-host + --zero1 shards the optimizer state across "
                "hosts; a single-file .npz snapshot cannot hold it — use "
                "a sharded checkpoint DIR (each host writes its shards)")
        verbose = verbose and mh.is_primary()

    net = (init_params(cfg, torch.Generator().manual_seed(cfg.seed))
           if init is None else params_from_numpy(init)).to(dev)
    # the schedule steps once per optimiser update, so the cosine spans
    # epochs * updates_per_epoch; with accumulation an update is grad_accum
    # steps
    steps_per_epoch = max(1, len(imgs_p1) // cfg.batch_size)
    updates_per_epoch = max(1, steps_per_epoch // max(1, grad_accum))
    optimizer = AdamCosine(cfg.lr, max(cfg.epochs, 1) * updates_per_epoch,
                           every_k=grad_accum)
    opt_state = optimizer.init(net.params())
    step = make_train_step(cfg, optimizer, mesh, microbatch=microbatch,
                           remat=remat, zero1=zero1, compute_dtype=compute_dtype,
                           qat=qat, soft_bce=aux_bce)
    if zero1:  # the template a sharded restore fills in place
        zero1_constrain(opt_state, mesh)
    n_layers = len(cfg.layer_configs)

    @torch.no_grad()
    def eval_acc(params, images, labels):
        # best-val selection measures the net that deploys: under --qat
        # the fake-quantised one
        p = fake_quant_convs(params, n_layers, cfg.per_layer_scale) if qat else params
        return (float_forward(p, images, n_layers).argmax(-1) == labels).float().mean()

    rng = np.random.RandomState(cfg.seed)
    best_acc = -1.0
    best_params = {k: v.detach().clone() for k, v in net.params().items()}
    start_epoch = 1
    preempted = threading.Event()
    old_sigterm = None
    if threading.current_thread() is threading.main_thread():
        old_sigterm = signal.signal(signal.SIGTERM,
                                    lambda signum, frame: preempted.set())
    sharded_ckpt = None
    try:
        # .npz -> single-file snapshot; any other path -> the sharded
        # checkpoint directory (asynchronous, per shard, with retention)
        if checkpoint_path and not checkpoint_path.endswith(".npz"):
            from tpu_cnn_torch.train.checkpoint_sharded import ShardedCheckpointer

            sharded_ckpt = ShardedCheckpointer(checkpoint_path)
        with exact_float():
            if resume and checkpoint_path:
                restored = None
                if sharded_ckpt is not None and sharded_ckpt.latest() is not None:
                    restored = sharded_ckpt.restore(net.params(), opt_state, rng=rng)
                    params_r, opt_state = restored[0], restored[1]
                elif sharded_ckpt is None and os.path.exists(checkpoint_path):
                    restored = ckpt.load_checkpoint(
                        checkpoint_path, net.params(),
                        optimizer.leaves(opt_state), rng=rng)
                    params_r = restored[0]
                    opt_state = optimizer.from_leaves(restored[1], opt_state)
                if restored is not None:
                    done_epoch, best_acc = restored[2], restored[3]
                    with torch.no_grad():
                        for k, p in net.params().items():
                            p.copy_(torch.as_tensor(params_r[k]))
                    best_params = {k: torch.as_tensor(v).to(dev)
                                   for k, v in restored[4].items()}
                    start_epoch = done_epoch + 1
                    if verbose:
                        kind = " (sharded)" if sharded_ckpt is not None else ""
                        print(f"Resumed from {checkpoint_path}{kind} at epoch "
                              f"{done_epoch} (best val {best_acc * 100:.1f}%)")
            if multihost:
                # resume consensus: only the primary writes .npz snapshots,
                # so a per-host disk can show the file to some ranks only;
                # divergent start epochs would hang the per-step collectives
                seen = mh._all_gather_ints([start_epoch])[:, 0]
                if int(seen.min()) != int(seen.max()):
                    raise RuntimeError(
                        "resume desync: ranks disagree on the checkpoint state "
                        f"(start epochs {sorted(set(seen.tolist()))}) — put the "
                        "checkpoint on storage visible to every host (or copy it "
                        "to each) before --resume")
            if verbose:
                aux_n = len(imgs_p1) - len(imgs_t)
                print(f"Phase 1: float training ({cfg.epochs} epochs, "
                      f"{len(imgs_t)} train"
                      + (f" + {aux_n} soft composites" if aux_n else "")
                      + f" / {len(imgs_v)} val) on {dev}")
            # the val set is fixed: staged once, not once per epoch
            imgs_v_d = torch.as_tensor(np.asarray(imgs_v, np.float32), device=dev)
            labels_v_d = torch.as_tensor(np.asarray(labels_v, np.int64), device=dev)
            epoch = start_epoch - 1  # stays if SIGTERM lands before an epoch
            for epoch in range(start_epoch, cfg.epochs + 1):
                losses, accs = [], []
                host_stream = batches(imgs_p1, labels_p1, cfg.batch_size, rng)
                if augment:
                    # the permutation's rng: phase 2 and eval see clean
                    # images, and under multi-host every process augments
                    # the whole global batch before slicing, in lockstep
                    host_stream = ((augment_batch(bi, rng), bl)
                                   for bi, bl in host_stream)
                if multihost:
                    host_stream = mh.global_batches(mesh, host_stream)
                for bi, bl in _prefetch_to_device(host_stream, dev):
                    loss, acc = step(net, opt_state, bi, bl)
                    # metrics stay on the device: one fetch per epoch
                    losses.append(loss)
                    accs.append(acc)
                losses = torch.stack(losses).cpu().numpy() if losses else np.zeros(0)
                accs = torch.stack(accs).cpu().numpy() if accs else np.zeros(0)
                vacc = float(eval_acc(net.params(), imgs_v_d, labels_v_d))
                if vacc > best_acc:
                    best_acc = vacc
                    best_params = {k: v.detach().clone()
                                   for k, v in net.params().items()}
                if sharded_ckpt is not None:
                    sharded_ckpt.save(epoch, net.params(), opt_state, best_acc,
                                      best_params, rng=rng)
                elif checkpoint_path and (not multihost or mh.is_primary()):
                    ckpt.save_checkpoint(checkpoint_path, net.params(),
                                         optimizer.leaves(opt_state), epoch,
                                         best_acc, best_params, rng=rng)
                if verbose:
                    print(f"  epoch {epoch:3d}: loss {np.mean(losses):.3f}  "
                          f"train {np.mean(accs) * 100:.1f}%  "
                          f"val {vacc * 100:.1f}%")
                # under multi-host a rank that stopped alone would hang the
                # others' next collective: every rank stops if any was told
                if multihost and mh.consensus_max(int(preempted.is_set())):
                    preempted.set()
                if preempted.is_set():
                    break
    finally:
        # always restore the previous SIGTERM disposition: an exception in
        # the epoch loop must not leave the process swallowing the signal
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
    if sharded_ckpt is not None:
        sharded_ckpt.close()
    if preempted.is_set():
        if verbose:
            where = checkpoint_path or "(no --checkpoint given!)"
            print(f"SIGTERM: stopped after epoch {epoch}, state in {where} "
                  f"— re-run with --resume to continue")
        return None
    if verbose:
        print(f"  best val acc: {best_acc * 100:.1f}%")
        print("Phase 2: head on bit-accurate quantized features")

    feats_t = extract_qat_features(best_params, imgs_t, cfg, device=dev)
    fc_w, fc_b = fit_head(feats_t, np.asarray(labels_t), cfg, verbose=verbose,
                          device=dev)
    q_kernels, scale = quantized_kernels(best_params, cfg)
    # the training shifts persist: the QAT features (and so the head) are
    # only valid at the register setting they were trained at
    bundle = art.ArtifactBundle(q_kernels, fc_w, fc_b, class_names,
                                shifts=[int(s) for s in cfg.shifts])
    if multihost and not mh.is_primary():
        return bundle  # every process computes it; one process writes it
    art.save_bundle(out_dir, bundle)
    n_exp = export_test_images(imgs_v, labels_v, out_dir,
                               num_per_class=10, num_classes=cfg.num_classes)
    if verbose:
        nbytes = sum(k.size for k in q_kernels)
        scale_s = (", ".join(f"{s:.2f}" for s in scale)
                   if isinstance(scale, list) else f"{scale:.2f}")
        print(f"Exported: weights.bin ({nbytes} B, scale={scale_s}), "
              f"fc {fc_w.shape}, {n_exp} test images -> {out_dir}/")
    return bundle


def main(argv=None):
    """The JAX CLI's flags plus ``--device``, which is where both phases
    run and where the mesh's positions are: ``cuda`` the first D x M
    visible cards (a larger mesh is refused), ``cpu`` that many virtual
    positions on the CPU."""
    p = argparse.ArgumentParser(
        description="Train the FPGA-contract CNN (PyTorch/CUDA port)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where both phases run (cuda: the card; cpu only "
                        "when asked)")
    p.add_argument("--synthetic", action="store_true",
                   help="train on the procedural shapes dataset")
    p.add_argument("--image-folder", default=None,
                   help="<root>/<class>/* image-folder dataset")
    p.add_argument("--bin-folder", default=None,
                   help="flat dir of raw *_class<C>.bin images "
                        "(the reference's test-image format)")
    p.add_argument("--val-bin-folder", default=None,
                   help="held-out bin dir (with --bin-folder); otherwise a "
                        "1/6 split of the training set is held out")
    p.add_argument("--train-images", default=None, help="COCO train image dir")
    p.add_argument("--train-ann", default=None, help="COCO train annotations")
    p.add_argument("--val-images", default=None)
    p.add_argument("--val-ann", default=None)
    p.add_argument("--max-per-class", type=int, default=5000)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--seed", type=int, default=0,
                   help="init/permutation/augment/composite RNG seed (the "
                        "reference trainer is single-seed, "
                        "training/train_cnn.py:259)")
    p.add_argument("--output-dir", default="artifacts/generated")
    p.add_argument("--checkpoint", default=None,
                   help="per-epoch checkpoints: a *.npz path for a "
                        "single-file host snapshot, any other path for a "
                        "sharded checkpoint DIR (asynchronous per-shard "
                        "saves, keeps the last 2 epochs — pairs with "
                        "--zero1/--mesh sharded state)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--variant", default="lyr3-std",
                   help="model variant from models.registry (geometry)")
    p.add_argument("--shifts", default=None,
                   help="comma list of per-layer ReLU shifts to train the "
                        "QAT phase at (default: the variant ladder). "
                        "Exported to the bundle's shifts.json.")
    p.add_argument("--mesh", default=None, metavar="DxM",
                   help="train over a device mesh: 'DATAxMODEL' position "
                        "counts (e.g. '4x2': batch sharded over 4, conv "
                        "oc + fc feature dim over 2) or a plain count for "
                        "pure data parallelism. Uses the first DATA*MODEL "
                        "positions of --device.")
    p.add_argument("--pipeline", default=None, metavar="[DxS|S]",
                   help="train as a GPipe pipeline over S stage positions "
                        "(forward and backward pipelined, stage-held "
                        "weights; gradients equal the plain step's). 'DxS' "
                        "composes with data parallelism: D independent "
                        "pipelines, batch sharded across them.")
    p.add_argument("--microbatch", type=int, default=4,
                   help="pipeline microbatch size (with --pipeline); "
                        "batch-size must be a multiple of D x this")
    p.add_argument("--bf16", action="store_true",
                   help="mixed precision: bf16 conv math with f32 master "
                        "weights and an f32 head")
    p.add_argument("--grad-accum", type=int, default=1, metavar="K",
                   help="accumulate K gradients per optimizer update "
                        "(optax.MultiSteps' mean): K x the effective batch "
                        "without K x the memory")
    p.add_argument("--zero1", action="store_true",
                   help="with --mesh D (pure dp): shard the optimizer "
                        "state over the data axis (ZeRO-1) — each position "
                        "holds and updates 1/D of the Adam moments, the "
                        "updated parameter blocks are gathered")
    p.add_argument("--remat", action="store_true",
                   help="with --pipeline: rematerialise stage activations "
                        "in the backward (torch.utils.checkpoint per "
                        "stage), one extra stage forward for less live "
                        "activation memory")
    p.add_argument("--spatial", default=None, metavar="[DxN|N]",
                   help="train with image rows sharded over N positions "
                        "(a halo row exchange per conv layer, forward and "
                        "backward). 'DxN' composes with data parallelism. "
                        "Every layer's row count must divide by 2xN.")
    p.add_argument("--per-layer-scale", action="store_true",
                   help="quantize each conv layer with its OWN symmetric "
                        "scale at export (beyond-reference; the reference "
                        "uses one global scale, which lets the largest-|w| "
                        "layer squeeze every other layer's int8 precision "
                        "— the shift register absorbs the gain, so the "
                        "runtime contract is unchanged)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware phase 1: conv kernels are STE "
                        "fake-quantized to the exact export int8 grid "
                        "every step, so training optimizes the deployed "
                        "precision (the reference quantizes post-hoc)")
    p.add_argument("--augment", action="store_true",
                   help="train-time augmentation (host-side random h-flip "
                        "+ ±4 px edge-padded translation per image; "
                        "phase-2 QAT features stay clean). The reference "
                        "trainer has no augmentation — opt-in.")
    p.add_argument("--composite-frac", type=float, default=0.0,
                   help="phase-1 co-presence lever: add this fraction of "
                        "the training set as 2-object soft-label "
                        "composites (data.soft_composites — 0.5/0.5 "
                        "targets; phase 2 and eval stay single-label).")
    p.add_argument("--composite-loss", default="ce", choices=("ce", "bce"),
                   help="phase-1 loss when --composite-frac > 0: 'ce' "
                        "splits softmax mass 0.5/0.5 across a composite's "
                        "two classes; 'bce' scores every class as an "
                        "independent sigmoid presence (multi-hot 1/1 "
                        "composites) and applies to EVERY phase-1 frame, "
                        "the one-hot singles included")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-host training: process 0's address for the "
                        "gloo process group. Run the same command on "
                        "every host with its own --process-id.")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total number of host processes in the job")
    p.add_argument("--process-id", type=int,
                   default=int(os.environ.get("TPU_CNN_PROCESS_ID", "0")),
                   help="this host's rank (env TPU_CNN_PROCESS_ID)")
    args = p.parse_args(argv)

    from tpu_cnn_torch.parallel import multihost as mh
    from tpu_cnn_torch.parallel.mesh import make_mesh, take_devices

    dev = resolve_device(args.device)
    if args.num_processes > 1:
        if not args.coordinator:
            p.error("--num-processes > 1 needs --coordinator HOST:PORT")
        if args.pipeline or args.spatial:
            p.error("multi-host rides pure data parallelism — "
                    "--pipeline/--spatial are single-process features")
        mh.init_multihost(args.coordinator, args.num_processes, args.process_id)
    # the positions a mesh may take: the visible cards (this process's,
    # under multi-host), or any count of virtual CPU positions
    n_local = len(mh.owned_devices()) if dev.type == "cuda" else 1
    if args.num_processes > 1:
        print(f"process {args.process_id}/{args.num_processes}: {n_local} "
              f"local / {n_local * args.num_processes} global devices")

    def positions(n: int) -> list:
        """This process's share of an n-position mesh."""
        if n % args.num_processes:
            raise ValueError(f"{n} mesh positions do not split equally over "
                             f"{args.num_processes} processes")
        n //= args.num_processes
        if dev.type == "cpu":
            return [dev] * n
        return take_devices(n, mh.owned_devices())

    from tpu_cnn_torch.models.registry import default_shifts, get_config

    vcfg = get_config(args.variant)
    train_shifts = (tuple(int(s) for s in args.shifts.split(","))
                    if args.shifts else tuple(default_shifts(vcfg)))
    if len(train_shifts) != len(vcfg.layer_configs):
        p.error(f"--shifts needs {len(vcfg.layer_configs)} values")
    cfg = TrainConfig(
        layer_configs=vcfg.layer_configs,
        shifts=train_shifts,
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        seed=args.seed, per_layer_scale=args.per_layer_scale,
    )
    from tpu_cnn_torch.train import data as D

    img_size = cfg.layer_configs[0][2]
    explicit_val = None
    if args.bin_folder:
        ds = D.BinFolderDataset(args.bin_folder, img_size=img_size,
                                max_per_class=args.max_per_class)
        imgs, labels = ds.arrays()
        names = ds.class_names
        if args.val_bin_folder:
            vds = D.BinFolderDataset(args.val_bin_folder, class_names=names,
                                     img_size=img_size)
            explicit_val = vds.arrays()
    elif args.image_folder:
        ds = D.ImageFolderDataset(args.image_folder, img_size=img_size,
                                  max_per_class=args.max_per_class)
        imgs, labels = ds.arrays()
        names = ds.class_names
    elif args.train_images and args.train_ann:
        ds = D.CocoClassification(args.train_images, args.train_ann,
                                  img_size=img_size,
                                  max_per_class=args.max_per_class)
        imgs, labels = ds.arrays()
        names = ds.class_names
    else:
        if not args.synthetic:
            print("No dataset given — using --synthetic shapes.")
        ds = D.SyntheticShapes(n_per_class=max(50, args.max_per_class // 25),
                               img_size=img_size)
        imgs, labels = ds.arrays()
        names = ds.class_names

    if explicit_val is not None:
        train_split, val_split = (imgs, labels), explicit_val
    else:
        n_val = max(len(imgs) // 6, cfg.num_classes)
        train_split = (imgs[n_val:], labels[n_val:])
        val_split = (imgs[:n_val], labels[:n_val])

    mesh = None
    if sum(bool(v) for v in (args.mesh, args.pipeline, args.spatial)) > 1:
        p.error("--mesh, --pipeline, and --spatial are mutually exclusive")
    if args.num_processes > 1 and not args.mesh:
        # default: pure dp over every position of every process
        args.mesh = str(n_local * args.num_processes)
    if args.mesh:
        if "x" in args.mesh:
            d, m = (int(v) for v in args.mesh.lower().split("x"))
        else:
            d, m = int(args.mesh), 1
        mesh = make_mesh(d * m // args.num_processes, model_axis=m,
                         devices=positions(d * m))
        if cfg.batch_size % d:
            p.error(f"--batch-size {cfg.batch_size} must be a multiple of "
                    f"the data axis ({d})")
        print(f"Mesh: {d} data x {m} model over {d * m} devices")
    elif args.pipeline:
        from tpu_cnn_torch.parallel.pipeline import make_pipeline_mesh

        if "x" in args.pipeline:
            d, s = (int(v) for v in args.pipeline.lower().split("x"))
        else:
            d, s = 1, int(args.pipeline)
        mesh = make_pipeline_mesh(d * s, data_axis=d, devices=positions(d * s))
        if cfg.batch_size % (d * args.microbatch):
            p.error(f"--batch-size {cfg.batch_size} must be a multiple of "
                    f"data axis x microbatch ({d} x {args.microbatch})")
        print(f"Pipeline: {d} data x {s} stages over {d * s} devices "
              f"(microbatch {args.microbatch})")
    elif args.spatial:
        from tpu_cnn_torch.parallel.spatial import (check_spatial_split,
                                                    make_spatial_mesh)

        if "x" in args.spatial:
            d, s = (int(v) for v in args.spatial.lower().split("x"))
        else:
            d, s = 1, int(args.spatial)
        check_spatial_split(img_size, len(cfg.layer_configs), s)
        mesh = make_spatial_mesh(d * s, data_axis=d, devices=positions(d * s))
        if cfg.batch_size % d:
            p.error(f"--batch-size {cfg.batch_size} must be a multiple of "
                    f"the data axis ({d})")
        print(f"Spatial: {d} data x {s} row shards over {d * s} devices")

    aux = None
    if args.composite_frac > 0:
        n_aux = int(round(args.composite_frac * len(train_split[0])))
        aux = D.soft_composites(train_split[0], train_split[1], n_aux,
                                seed=cfg.seed, img_size=img_size)
        print(f"Composites: {n_aux} 2-object soft-label frames "
              f"(--composite-frac {args.composite_frac:g})")
    bundle = train(cfg, train_split, val_split, args.output_dir,
                   class_names=names, mesh=mesh,
                   checkpoint_path=args.checkpoint, resume=args.resume,
                   microbatch=args.microbatch, remat=args.remat, zero1=args.zero1,
                   compute_dtype="bfloat16" if args.bf16 else "float32",
                   grad_accum=args.grad_accum, augment=args.augment, qat=args.qat,
                   aux_data=aux, aux_bce=args.composite_loss == "bce", device=dev)
    mh.shutdown_multihost()
    return bundle


if __name__ == "__main__":
    main()
