"""Sharded inference over a mesh of devices — the port of
``tpu_cnn.parallel.mesh``.

The JAX package shards over a ``jax.sharding.Mesh`` with two axes:

  * ``data``  — frames split across devices (the production axis);
  * ``model`` — conv kernels split by output channel, the activations
    all-gathered after each layer, the fc head's feature dimension split
    (its partial logits summed).

Torch has no SPMD compiler, so the port is single-controller, as JAX is:
one process queues every position's work on that position's device, and
on its own CUDA stream, so that positions on one card overlap. A
:class:`Mesh` is a numpy grid of ``torch.device``s; one device may repeat
(the virtual positions of the tests, ``[torch.device("cpu")] * 8``, and of
a one-card run, ``[torch.device("cuda", 0)] * k``). A batch on the mesh is
a :class:`Sharded`: equal row blocks, one per data row (replicated over
``model``) or one per position (``all_axes``, the megakernel's pure batch
sharding). Results come back through one pinned host array per output,
each position copying its rows behind its own event (:func:`gather_async`,
:func:`fetch`).

Backends per shard, as in the JAX package:

  * ``mega`` — the production path on every position: ``CUDAEngine``'s
    megakernel path (``ops.mega``: ``csrc/mega_cnn.cu``, with
    ``csrc/conv_pool_layer.cu`` for the chained plan's head layers) and
    the fused head, pure batch sharding over every axis flattened; on a CPU
    position the kernels' plain versions;
  * ``xla`` — the plain contract (``ops.quant``) with the ``model`` split,
    as ``CUDAEngine(backend="xla")`` runs it: the JAX path there is XLA,
    not a Pallas kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from tpu_cnn_torch.engine.cuda import CUDAEngine, DetectResult, MultiDetectResult
from tpu_cnn_torch.models.cnn import CNNConfig, FpgaCNN
from tpu_cnn_torch.ops import detect_head, mega, quant
from tpu_cnn_torch.utils.failguard import wait_event

TIMEOUT_S = 300.0  # the bounded wait for a position's work, as CUDAEngine's


class Mesh:
    """A grid of ``torch.device``s with named axes: the port's stand-in for
    ``jax.sharding.Mesh``. ``devices`` is the numpy grid, ``shape`` maps
    each axis name to its size. Each position on a card gets its own CUDA
    stream (:meth:`on`)."""

    def __init__(self, devices, axis_names: Sequence[str]):
        grid = np.asarray(devices, dtype=object)
        self.devices = grid
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-D device grid needs "
                             f"{grid.ndim} axis names, got {self.axis_names}")
        self._streams: dict[tuple, torch.cuda.Stream] = {}

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def is_cuda(self) -> bool:
        return any(d.type == "cuda" for d in self.devices.flat)

    def positions(self) -> list[tuple]:
        """Every position, in mesh (row-major) order."""
        return list(np.ndindex(*self.devices.shape))

    def stream(self, pos: tuple) -> torch.cuda.Stream | None:
        """The position's CUDA stream (made at first use); None on the
        CPU."""
        dev = self.devices[pos]
        if dev.type != "cuda":
            return None
        if pos not in self._streams:
            self._streams[pos] = torch.cuda.Stream(device=dev)
        return self._streams[pos]

    @contextlib.contextmanager
    def on(self, pos: tuple):
        """Queue the block's work on ``pos``'s stream, after what the
        device's current stream holds so far (weights, shift updates)."""
        s = self.stream(pos)
        if s is None:
            yield
            return
        s.wait_stream(torch.cuda.current_stream(s.device))
        with torch.cuda.stream(s):
            yield

    def _place(self, p) -> tuple[torch.device, torch.cuda.Stream | None]:
        """The device and stream of a position, or of a :class:`Home`."""
        if isinstance(p, Home):
            return p.device, p.stream
        return self.devices[p], self.stream(p)

    def send(self, t: torch.Tensor, src, dst) -> torch.Tensor:
        """``t``, made on ``src``'s stream, for use on ``dst``'s (call it
        inside ``on(dst)``): ``dst`` waits for ``src``'s work so far, and
        ``t`` moves to ``dst``'s device. ``src`` and ``dst`` are positions
        or a :class:`Home`."""
        dev, s_dst = self._place(dst)
        s_src = self._place(src)[1]
        if s_src is not None and s_dst is not None and s_src != s_dst:
            s_dst.wait_stream(s_src)
            if t.device == dev:
                t.record_stream(s_dst)
            else:  # src's later work waits for the copy out of its memory
                out = t.to(dev, non_blocking=True)
                s_src.wait_stream(s_dst)
                return out
        return t.to(dev, non_blocking=True)

    def hop(self, t: torch.Tensor, src, dst) -> torch.Tensor:
        """:meth:`send` as a differentiable op: the backward sends the
        gradient from ``dst`` back to ``src``, ``src``'s stream waiting for
        ``dst``'s (the transpose of the JAX package's ``ppermute`` hop).
        Autograd runs the backward on the forward's stream, ``dst``'s."""
        if not t.requires_grad:
            return self.send(t, src, dst)
        return _Hop.apply(t, self, src, dst)

    def join(self, home: Home) -> None:
        """``home``'s stream waits for the work queued so far on every
        position."""
        if home.stream is None:
            return
        for pos in self.positions():
            s = self.stream(pos)
            if s is not None and s != home.stream:
                home.stream.wait_stream(s)

    def synchronize(self, timeout_s: float | None = TIMEOUT_S) -> None:
        """Bounded wait for the work queued so far on every position."""
        for pos in self.positions():
            s = self.stream(pos)
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
                wait_event(ev, timeout_s, diagnostics=lambda: f"mesh {pos}")


@dataclasses.dataclass(frozen=True, eq=False)
class Home:
    """The caller's place beside a mesh: a device and the stream that was
    current there when a step began (None on the CPU). Inside
    ``Mesh.on(pos)`` the current stream is the position's, so a step takes
    its home first."""

    device: torch.device
    stream: torch.cuda.Stream | None

    @classmethod
    def of(cls, device) -> "Home":
        device = torch.device(device)
        return cls(device, torch.cuda.current_stream(device)
                   if device.type == "cuda" else None)


class _Hop(torch.autograd.Function):
    """``Mesh.send`` forward, the reverse send backward."""

    @staticmethod
    def forward(ctx, t, mesh, src, dst):
        ctx.mesh, ctx.src, ctx.dst = mesh, src, dst
        out = mesh.send(t, src, dst)
        return t.view_as(t) if out is t else out

    @staticmethod
    def backward(ctx, g):
        out = ctx.mesh.send(g, ctx.dst, ctx.src)
        return out, None, None, None


@dataclasses.dataclass
class RowShards:
    """A tensor held as equal row blocks on a mesh's data positions (the
    ZeRO-1 layout): ``parts[i]`` is row block ``first + i`` of
    ``n_blocks``, held on ``positions[i]``'s device. Under multi-host the
    other blocks belong to the other processes."""

    parts: list
    positions: list
    first: int
    n_blocks: int

    @property
    def shape(self) -> tuple:
        rows, *rest = self.parts[0].shape
        return (rows * self.n_blocks, *rest)

    @property
    def local(self) -> bool:
        """Whether this process holds every block."""
        return len(self.parts) == self.n_blocks

    def rows(self, i: int) -> slice:
        """The rows of ``parts[i]`` in the whole tensor."""
        n = self.parts[0].shape[0]
        return slice((self.first + i) * n, (self.first + i + 1) * n)


def _grid(devices: Sequence[torch.device], shape: tuple) -> np.ndarray:
    flat = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        flat[i] = torch.device(d)
    return flat.reshape(shape)


def local_devices() -> list[torch.device]:
    """Every CUDA device this process sees; raises when there is none (no
    silent CPU mesh: pass ``devices=`` for one)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "torch finds no CUDA device: pass devices= for a mesh of "
            "virtual positions, e.g. [torch.device('cpu')] * 8")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def take_devices(n_devices: int | None, devices) -> list[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: every CUDA
    device), refusing a mesh larger than the list."""
    devices = local_devices() if devices is None else [torch.device(d)
                                                       for d in devices]
    n = len(devices) if n_devices is None else n_devices
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return devices[:n]


def make_mesh(n_devices: int | None = None, model_axis: int = 1,
              devices=None) -> Mesh:
    """A (data, model) mesh over the first ``n_devices`` of ``devices``
    (default: every CUDA device). ``model_axis`` > 1 carves that many
    positions into the model axis (it must divide the count); the rest go
    to data parallelism. ``devices`` may repeat one device."""
    devices = take_devices(n_devices, devices)
    n = len(devices)
    if n % model_axis:
        raise ValueError(f"model_axis {model_axis} must divide {n}")
    return Mesh(_grid(devices, (n // model_axis, model_axis)),
                ("data", "model"))


# ── batches on the mesh ────────────────────────────────────────────────


@dataclasses.dataclass
class Sharded:
    """A batch laid out on a mesh in equal row blocks: ``parts[pos]`` is
    what position ``pos`` holds on its device (a tuple of tensors, one per
    output), absent where the position holds nothing. ``all_axes``: one
    block per position in mesh order; else one per data row, replicated
    over the other axes."""

    mesh: Mesh
    parts: dict
    rows: int
    all_axes: bool

    @property
    def n_blocks(self) -> int:
        return self.mesh.size if self.all_axes else self.mesh.devices.shape[0]

    @property
    def batch(self) -> int:
        return self.rows * self.n_blocks

    def block(self, pos: tuple) -> int:
        if self.all_axes:
            return int(np.ravel_multi_index(pos, self.mesh.devices.shape))
        return pos[0]

    def blocks(self) -> list[tuple[int, tuple]]:
        """(block, the first position holding it), in block order."""
        first = {}
        for pos in self.parts:
            first.setdefault(self.block(pos), pos)
        return sorted(first.items())


def shard_batch(mesh: Mesh, images, all_axes: bool = False) -> Sharded:
    """Place a batch on the mesh: split over the data axis (replicated over
    ``model``) or, with ``all_axes``, over every axis flattened. A host
    batch goes through one pinned copy, each position's rows then moving
    to its device on its own stream. The batch must split evenly."""
    n_blocks = mesh.size if all_axes else mesh.devices.shape[0]
    if isinstance(images, torch.Tensor):
        src = images
    else:
        src = torch.from_numpy(np.ascontiguousarray(images))
    if src.shape[0] % n_blocks:
        raise ValueError(f"batch {src.shape[0]} does not split into "
                         f"{n_blocks} equal blocks")
    if src.device.type == "cpu" and mesh.is_cuda:
        src = src.pin_memory()
    rows = src.shape[0] // n_blocks
    out = Sharded(mesh, {}, rows, all_axes)
    for pos in mesh.positions():
        b0 = out.block(pos) * rows
        with mesh.on(pos):
            out.parts[pos] = (src[b0:b0 + rows].to(mesh.devices[pos],
                                                   non_blocking=True),)
    return out


@dataclasses.dataclass
class Pending:
    """Results on their way to the host: one pinned array per output, the
    copy events of the positions that fill them, the rows asked for, and
    the device outputs (``shards``) the copies read."""

    host: tuple
    events: list
    b: int
    shards: Sharded


def gather_async(out: Sharded, b: int | None = None) -> Pending:
    """Start copying ``out``'s blocks into one host array per output
    (pinned when the mesh has a card), each block on its position's
    stream behind an event."""
    blocks = out.blocks()
    first = out.parts[blocks[0][1]]
    pin = out.mesh.is_cuda
    host = tuple(torch.empty((out.batch, *t.shape[1:]), dtype=t.dtype,
                             pin_memory=pin) for t in first)
    events = []
    for blk, pos in blocks:
        r0 = blk * out.rows
        with out.mesh.on(pos):
            for h, t in zip(host, out.parts[pos]):
                h[r0:r0 + out.rows].copy_(t, non_blocking=True)
            s = out.mesh.stream(pos)
            if s is not None:
                ev = torch.cuda.Event()
                ev.record(s)
                events.append(ev)
    return Pending(host, events, out.batch if b is None else b, out)


def fetch(pending: Pending, timeout_s: float | None = TIMEOUT_S) -> tuple:
    """Bounded wait for a :func:`gather_async` -> numpy arrays, the first
    ``b`` rows of each."""
    for ev in pending.events:
        wait_event(ev, timeout_s, diagnostics=lambda: "mesh gather")
    return tuple(h.numpy()[:pending.b] for h in pending.host)


def to_host(out: Sharded):
    """A sharded result as numpy: one array, or a tuple for several
    outputs (the port's ``np.asarray`` of a sharded ``jax.Array``)."""
    res = fetch(gather_async(out))
    return res[0] if len(res) == 1 else res


# ── the per-shard programs ─────────────────────────────────────────────


def _model_of(kernels, fc_weight=None, fc_bias=None, img_size: int = 128,
              bbox_weight=None, multi_head=None, head_mode: str = "bins"):
    """An ``FpgaCNN`` holding the functional API's arrays (zero shifts: the
    calls pass theirs; a zero bins head where none is given)."""
    ks = [np.asarray(k.cpu() if isinstance(k, torch.Tensor) else k, np.int8)
          for k in kernels]
    cfgs, size = [], img_size
    for k in ks:
        cfgs.append((k.shape[1], k.shape[0], size))
        size //= 2
    config = CNNConfig(layer_configs=tuple(cfgs))

    def host(a):
        return None if a is None else np.asarray(
            a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)

    if fc_weight is None:
        fc_weight = np.zeros((6, config.feature_dim_bins), np.float32)
        fc_bias = np.zeros(6, np.float32)
    model = FpgaCNN(ks, host(fc_weight), host(fc_bias), shifts=[0] * len(ks),
                    config=config, bbox_weight=host(bbox_weight),
                    multi_head=(None if multi_head is None
                                else tuple(host(a) for a in multi_head)))
    if model.head_mode != head_mode:
        raise ValueError(f"head_mode {head_mode!r} but the fc weight "
                         f"{model.fc_weight.shape} is the {model.head_mode} "
                         f"head's")
    return model


def _shift_list(shifts) -> list[int]:
    values = (shifts.tolist() if isinstance(shifts, torch.Tensor)
              else [int(v) for v in np.asarray(shifts).ravel()])
    quant.check_shifts(values)
    return values


class _MegaProgram:
    """The ``mega`` backend: one ``CUDAEngine(backend="mega")`` per
    distinct device of the mesh (positions on one device share its packed
    weights), each position running the engine's megakernel path and fused
    head on its own rows and stream."""

    def __init__(self, mesh: Mesh, model, box_mode: str, compact: bool):
        self.mesh = mesh
        self.engines = {}
        for dev in dict.fromkeys(mesh.devices.flat):
            eng = CUDAEngine(model, dev, backend="mega", box_mode=box_mode)
            eng.compact_multi = eng.compact_multi and compact
            self.engines[dev] = eng

    def set_shifts(self, shifts) -> None:
        for eng in self.engines.values():
            eng.set_shifts(*shifts)

    @property
    def launches(self) -> int:
        return sum(e.launches for e in self.engines.values())

    def run(self, sb: Sharded, kind: str, instances: int = 1) -> Sharded:
        out = Sharded(self.mesh, {}, sb.rows, sb.all_axes)
        for pos, (x,) in sb.parts.items():
            eng = self.engines[self.mesh.devices[pos]]
            with self.mesh.on(pos):
                if kind == "features":
                    out.parts[pos] = (eng._features(x),)
                elif kind == "detect":
                    out.parts[pos] = eng.detect_device(x)[2:]
                else:
                    out.parts[pos] = eng._detect_multi_device(x, instances)
        return out


class _XlaProgram:
    """The ``xla`` backend: the plain contract with the ``model`` split.
    Position (i, j) holds output-channel slice j of every layer's kernel
    and the fc columns of feature slice j; after each layer the slices are
    all-gathered across the data row; the classifier's partial logits are
    summed on the row's first position, which runs the rest of the head
    on the gathered features."""

    def __init__(self, mesh: Mesh, model, box_mode: str,
                 compute_dtype: str = "float32"):
        if mesh.axis_names != ("data", "model"):
            raise ValueError(f"the xla backend needs a ('data', 'model') "
                             f"mesh, got {mesh.axis_names}")
        m = mesh.shape["model"]
        for _ic, oc, _s in model.config.layer_configs:
            if oc % m:
                raise ValueError(f"model axis {m} must divide every layer's "
                                 f"output channels, got {oc}")
        self.mesh, self.model, self.m = mesh, model, m
        self.box_mode, self.compute_dtype = box_mode, compute_dtype
        self.head_mode = model.head_mode
        c = model.config.out_channels
        per_c = 16 if self.head_mode == "bins" else 1

        def put(a, dev, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(dev)

        self.kernels, self.fc_cols, self.dev = {}, {}, {}
        for pos in mesh.positions():
            dev = mesh.devices[pos]
            j = pos[1]
            self.kernels[pos] = [
                put(k[j * (k.shape[0] // m):(j + 1) * (k.shape[0] // m)], dev,
                    np.int8) for k in model.kernels]
            cs = c // m
            self.fc_cols[pos] = put(
                model.fc_weight[:, j * cs * per_c:(j + 1) * cs * per_c], dev,
                np.float32)
        for dev in dict.fromkeys(mesh.devices.flat):
            mh = model.multi_head
            self.dev[dev] = {
                "shifts": put(model.shifts, dev, np.int32),
                "fc_weight": put(model.fc_weight, dev, np.float32),
                "fc_bias": put(model.fc_bias, dev, np.float32),
                "bbox_weight": (None if model.bbox_weight is None
                                else put(model.bbox_weight, dev, np.float32)),
                "multi_head": (None if mh is None else
                               tuple(put(a, dev, np.float32) for a in mh))}
        self.launches = 0  # the plain contract launches no kernel

    def set_shifts(self, shifts) -> None:
        src = torch.tensor(list(shifts), dtype=torch.int32)
        for d in self.dev.values():
            d["shifts"].copy_(src.pin_memory() if d["shifts"].is_cuda else src,
                              non_blocking=True)

    def _features(self, sb: Sharded) -> dict:
        """Every position's gathered (rows, C, h, w) features."""
        mesh, rows_of = self.mesh, {}
        for pos in sb.parts:
            rows_of.setdefault(pos[0], []).append(pos)
        x = {pos: sb.parts[pos][0][:, None] for pos in sb.parts}
        for li in range(len(self.model.kernels)):
            y = {}
            for pos, xp in x.items():
                with mesh.on(pos):
                    y[pos] = quant.fixed_point_conv_layer(
                        xp, self.kernels[pos][li],
                        self.dev[mesh.devices[pos]]["shifts"][li],
                        compute_dtype=self.compute_dtype)
            if self.m == 1:
                x = y
                continue
            x = {}
            for row in rows_of.values():  # all-gather over the model axis
                for dst in row:
                    with mesh.on(dst):
                        x[dst] = torch.cat([mesh.send(y[src], src, dst)
                                            for src in row], dim=1)
        return x

    def _logits(self, feats: dict, row: list) -> torch.Tensor:
        """The classifier's logits on ``row[0]``: each position's partial
        product over its feature slice, summed there, plus the bias."""
        mesh, c = self.mesh, self.model.config.out_channels
        cs = c // self.m
        parts = {}
        for pos in row:
            f = feats[pos]
            sl = f[:, pos[1] * cs:(pos[1] + 1) * cs]
            b, _, h, w = sl.shape
            sl = sl.reshape(b, cs, h * w)
            with mesh.on(pos):
                pooled = (detect_head.bin_pool(sl) if self.head_mode == "bins"
                          else detect_head.gap_pool(sl))
                parts[pos] = pooled @ self.fc_cols[pos].T
        first = row[0]
        with mesh.on(first):
            total = mesh.send(parts[first], first, first)
            for pos in row[1:]:
                total = total + mesh.send(parts[pos], pos, first)
            return total + self.dev[mesh.devices[first]]["fc_bias"]

    def run(self, sb: Sharded, kind: str, instances: int = 1) -> Sharded:
        feats = self._features(sb)
        out = Sharded(self.mesh, {}, sb.rows, sb.all_axes)
        if kind == "features":
            for pos, f in feats.items():
                out.parts[pos] = (f.reshape(f.shape[0], f.shape[1], -1),)
            return out
        rows_of = {}
        for pos in feats:
            rows_of.setdefault(pos[0], []).append(pos)
        img = self.model.config.img_size
        for row in rows_of.values():
            logits = self._logits(feats, row)
            first = row[0]
            d = self.dev[self.mesh.devices[first]]
            with self.mesh.on(first):
                f = feats[first]
                f = f.reshape(f.shape[0], f.shape[1], -1)
                if kind == "detect":
                    out.parts[first] = detect_head.detect(
                        f, d["fc_weight"], d["fc_bias"], self.head_mode, img,
                        box_mode=self.box_mode, bbox_weight=d["bbox_weight"],
                        logits=logits)
                else:
                    box_mode = ("centroid" if self.box_mode == "centroid"
                                else "ref")
                    out.parts[first] = detect_head.detect_multi(
                        f, d["fc_weight"], d["fc_bias"], self.head_mode, img,
                        box_mode=box_mode, instances=instances,
                        multi_head=d["multi_head"], logits=logits)
        return out


class ShardedFn:
    """A sharded program as a function ``f(images, shifts=None) ->
    Sharded``: ``images`` a host batch (sharded here) or a
    :class:`Sharded`; ``shifts``, when given, are written into every
    device's shift register first. The program is built at the first call
    when the image size was not known up front."""

    def __init__(self, mesh: Mesh, build, kind: str, all_axes: bool,
                 instances: int = 1, img_size: int | None = None):
        self.mesh, self._build, self.kind = mesh, build, kind
        self.all_axes, self.instances = all_axes, instances
        self._programs = {}
        if img_size is not None:
            self.program(img_size)

    def program(self, img_size: int):
        if img_size not in self._programs:
            self._programs[img_size] = self._build(img_size)
        return self._programs[img_size]

    def __call__(self, images, shifts=None) -> Sharded:
        sb = (images if isinstance(images, Sharded)
              else shard_batch(self.mesh, images, self.all_axes))
        x = next(iter(sb.parts.values()))[0]
        prog = self.program(int(x.shape[-1]))
        if shifts is not None:
            prog.set_shifts(_shift_list(shifts))
        return prog.run(sb, self.kind, self.instances)


def sharded_forward(mesh: Mesh, kernels, *, compute_dtype: str = "float32"):
    """``f(images, shifts) -> Sharded (B, C, S'*S') u8``: the plain
    contract data-parallel over the mesh, conv kernels split by output
    channel over ``model``."""
    return ShardedFn(mesh, lambda s: _XlaProgram(
        mesh, _model_of(kernels, img_size=s), "ref", compute_dtype),
        "features", all_axes=False)


def sharded_detect(mesh: Mesh, kernels, fc_weight, fc_bias,
                   head_mode: str = "bins", img_size: int = 128,
                   box_mode: str = "ref", bbox_weight=None, *,
                   compute_dtype: str = "float32"):
    """``f(images, shifts) -> Sharded (pred, conf, probs, bbox)``: the
    plain contract and head, the fc feature dimension split over
    ``model``."""
    return ShardedFn(mesh, lambda s: _XlaProgram(
        mesh, _model_of(kernels, fc_weight, fc_bias, s, bbox_weight,
                        head_mode=head_mode), box_mode, compute_dtype),
        "detect", all_axes=False, img_size=img_size)


def sharded_detect_multi(mesh: Mesh, kernels, fc_weight, fc_bias,
                         head_mode: str = "bins", img_size: int = 128,
                         box_mode: str = "ref", instances: int = 1,
                         multi_head=None, *, compute_dtype: str = "float32"):
    """The multi-object head on the ``xla`` path (fc feature dimension over
    ``model``, like :func:`sharded_detect`): (pred, conf, probs, boxes[,
    inst_boxes, inst_counts][, scores])."""
    return ShardedFn(mesh, lambda s: _XlaProgram(
        mesh, _model_of(kernels, fc_weight, fc_bias, s,
                        multi_head=multi_head, head_mode=head_mode),
        box_mode, compute_dtype), "multi", all_axes=False,
        instances=instances, img_size=img_size)


def sharded_forward_mega(mesh: Mesh, kernels):
    """``f(images, shifts) -> Sharded (B, C, S'*S') u8``: the megakernel
    path (the chained plan) on every position, pure batch sharding over
    every axis flattened."""
    return ShardedFn(mesh, lambda s: _MegaProgram(
        mesh, _model_of(kernels, img_size=s), "ref", compact=False),
        "features", all_axes=True)


def sharded_detect_mega(mesh: Mesh, kernels, fc_weight, fc_bias,
                        head_mode: str = "bins", img_size: int = 128,
                        box_mode: str = "ref", bbox_weight=None):
    """The megakernel and the fused head on every position (the bins
    pooled in the kernel, as on one device): ``f(images, shifts) ->
    Sharded (pred, conf, probs, bbox)``."""
    return ShardedFn(mesh, lambda s: _MegaProgram(
        mesh, _model_of(kernels, fc_weight, fc_bias, s, bbox_weight,
                        head_mode=head_mode), box_mode, compact=False),
        "detect", all_axes=True, img_size=img_size)


def sharded_detect_multi_mega(mesh: Mesh, kernels, fc_weight, fc_bias,
                              head_mode: str = "bins", img_size: int = 128,
                              box_mode: str = "ref", instances: int = 1,
                              multi_head=None):
    """The multi-object head on the megakernel's bins and twin on every
    position: (pred, conf, probs, boxes[, inst_boxes, inst_counts][,
    scores]), the presence scores LAST."""
    return ShardedFn(mesh, lambda s: _MegaProgram(
        mesh, _model_of(kernels, fc_weight, fc_bias, s,
                        multi_head=multi_head, head_mode=head_mode),
        box_mode, compact=False), "multi", all_axes=True,
        instances=instances, img_size=img_size)


# ── the engine ─────────────────────────────────────────────────────────


class MeshEngine:
    """The engine protocol over a mesh: ``run_batch`` / ``detect_batch`` /
    ``detect_batch_async`` like ``CUDAEngine``, data-parallel over every
    position. ``backend``: 'mega' (the megakernel path on every position),
    'xla' (the plain contract with the model split) or 'auto' (mega where
    ``mega.mega_plan`` fits the geometry, else xla). The apps' ``--mode
    mesh``."""

    def __init__(self, model, mesh: Mesh | None = None, model_axis: int = 1,
                 backend: str = "auto", box_mode: str = "ref"):
        self.model = model
        self.box_mode = box_mode
        if box_mode == "reg" and model.bbox_weight is None:
            raise ValueError(
                "box_mode='reg' needs a bbox_weight.npy in the artifact "
                "bundle — train one with: python -m "
                "tpu_cnn_torch.apps.train_bbox")
        self.mesh = mesh or make_mesh(model_axis=model_axis)
        if backend == "auto":
            backend = ("mega" if mega.mega_plan(model.config.layer_configs)
                       is not None else "xla")
        if backend == "mega":
            self._prog = _MegaProgram(self.mesh, model, box_mode, compact=True)
        elif backend == "xla":
            self._prog = _XlaProgram(self.mesh, model, box_mode)
        else:
            raise ValueError(f"unknown mesh backend {backend!r}: need 'auto', "
                             f"'mega' or 'xla'")
        self._backend_kind = backend
        self.backend = f"mesh[{self.mesh.devices.shape}]:{backend}"
        # the megakernel's batch tile is 4: pad global batches so that every
        # shard gets an identical, tile-aligned shape (as the JAX engine)
        shard_tile = 4 if backend == "mega" else 1
        self._batch_mult = self.mesh.size * shard_tile
        self._all_axes = backend == "mega"  # pure DP: shard over every axis
        self.max_batch = 4096  # the serving protocol's attribute

    @property
    def launches(self) -> int:
        """Kernel launches made by this engine's shards."""
        return self._prog.launches

    def _pad(self, images):
        s = self.model.config.img_size
        images = np.ascontiguousarray(images, dtype=np.uint8).reshape(-1, s, s)
        b = images.shape[0]
        m = self._batch_mult
        pb = max(m, -(-b // m) * m)
        if pb != b:
            images = np.concatenate(
                [images, np.zeros((pb - b, s, s), np.uint8)])
        return images, b

    def _staged(self, images) -> tuple[Sharded, int]:
        if isinstance(images, tuple) and len(images) == 3 and images[0] == "staged":
            return images[1], images[2]
        images, b = self._pad(images)
        return shard_batch(self.mesh, images, self._all_axes), b

    def _dispatch(self, images, kind: str, instances: int = 1) -> Pending:
        sb, b = self._staged(images)
        return gather_async(self._prog.run(sb, kind, instances), b)

    def warmup(self, batch: int = 1, multi: bool = False,
               instances: int = 1) -> None:
        s = self.model.config.img_size
        img = np.zeros((max(batch, self._batch_mult), s, s), np.uint8)
        self.detect_batch(img)
        if multi:
            self.detect_multi_batch(img, instances=instances)

    def set_shifts(self, *shifts: int) -> None:
        if len(shifts) != len(self.model.config.layer_configs):
            raise ValueError("one shift per layer required")
        quant.check_shifts(shifts)
        self.model.shifts = np.asarray(shifts, np.int32)
        self._prog.set_shifts(list(shifts))

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        return fetch(self._dispatch(images, "features"))[0]

    def run_sharded(self, sb: Sharded, kind: str = "features",
                    instances: int = 1) -> Sharded:
        """The program on an already sharded batch (``MultiHostEngine``)."""
        return self._prog.run(sb, kind, instances)

    def detect_batch(self, images) -> DetectResult:
        return self.detect_resolve(self.detect_batch_async(images))

    def stage_batch(self, images: np.ndarray) -> tuple:
        """Pad and shard a batch onto the mesh ahead of dispatch."""
        sb, b = self._staged(images)
        self.mesh.synchronize()
        return ("staged", sb, b)

    def detect_batch_async(self, images) -> Pending:
        """Dispatch without waiting (several batches may be in flight);
        resolve with :meth:`detect_resolve`. Takes raw u8 images or a
        :meth:`stage_batch` handle."""
        return self._dispatch(images, "detect")

    def detect_resolve(self, handle: Pending) -> DetectResult:
        return DetectResult(*fetch(handle))

    def run(self, gray: np.ndarray):
        t0 = time.perf_counter()
        feats = self.run_batch(np.asarray(gray)[None])[0]
        return feats, (time.perf_counter() - t0) * 1e3, 0.0

    # ── multi-object head (one CAM box per class) ────────────────────

    def detect_multi_batch(self, images, instances: int = 1) -> MultiDetectResult:
        return self.detect_multi_resolve(
            self.detect_multi_batch_async(images, instances=instances))

    def detect_multi_batch_async(self, images, instances: int = 1) -> Pending:
        if instances < 1:
            raise ValueError(f"instances must be >= 1, got {instances}")
        return self._dispatch(images, "multi", instances)

    def detect_multi_resolve(self, handle: Pending) -> MultiDetectResult:
        out = list(fetch(handle))
        scores = out.pop() if self.model.multi_head is not None else None
        out[3:] = [a.astype(np.int32) for a in out[3:]]  # compact wire dtypes
        return MultiDetectResult(*out, scores=scores)
