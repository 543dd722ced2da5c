"""RegionEngine — a region-head detector (``models.region.RegionModel``)
on one CUDA device: a chain of layers with YOLOv2's region head
(``RegionConfig``), or a darknet layer graph with [yolo] heads
(``DarknetConfig``: YOLOv3).

The engine runs a plan of conv launches, set once (``_plan``). Each conv
runs on the port's layer kernels, routed by its geometry
(``region_routes``, ``graph_route``): a 3x3 conv (or, in a graph, a 1x1
one as its 3x3) of fewer than 128 input channels, not linear, on the
region route's layer kernel (``ops.region_layer``: any ic from 1 to 127,
oc up to 128, an even map; channels-last maps out; pooled in a chain,
unpooled or stride 2 in a graph), the rest on the weight-streaming kernel
(``ops.conv_stream``, each run of them inside the span ``net.stream``).
A chain is a graph without shortcuts or routes, its layers' launches as
they always were.

A graph's other rows run inside the convs' launches (``net.graph.ops``
counts the shortcuts, upsamples and concatenating routes of a batch): a
shortcut in the epilogue of the conv before it (its residual, where
nothing else reads that conv's own map), an upsample in the epilogue of
the 1x1 conv before it, a route by its maps' convs writing their channels
of the concatenated map in place, and a one-map route is the map itself. A
graph that needs any of them as a pass of its own raises: nothing falls
back.

Then the head's kernel: the region head (``ops.region_head``, span
``head.region``, counter ``head.region.frames``) or the [yolo] heads'
(``ops.yolo_head``, span ``head.yolo``, counter ``head.yolo.frames``).
``detect_device`` takes (B, C, S, S) u8 frames and returns ``(None, None,
dets, count)``; ``detect_batch`` a ``RegionResult``; ``region_maps`` every
launch's output. The device plumbing is ``engine.device``'s.
``engine.cuda.CUDAEngine`` hands a ``RegionModel`` to this class.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from tpu_cnn_torch.engine.device import DeviceEngine, _check_device
from tpu_cnn_torch.models.region import DarknetConfig, TorchRegionNet
from tpu_cnn_torch.ops import conv_stream, region_head, region_layer, yolo_head
from tpu_cnn_torch.utils.profiling import count, span


@dataclasses.dataclass
class RegionResult:
    """A region-head detector's answers."""

    dets: np.ndarray  # (B, max_det, 6) float32 (x, y, w, h, score, class)
    count: np.ndarray  # (B,) int32


@dataclasses.dataclass
class Launch:
    """One conv's launch in the engine's plan."""

    conv: int  # the conv's index: its kernel, bias and shift
    route: str  # "layer" or "stream"
    src: int | None  # the row whose map it reads (None: the frames)
    writes: int  # the row whose map it makes: its own, or the shortcut's or upsample's it takes in
    kwargs: dict  # the kernel wrapper's options
    residual: int | None = None  # the row whose map it adds (a shortcut taken in)
    into: tuple[int, int] | None = None  # (route row, first channel): writes its slice


def graph_route(spec, last: bool) -> str:
    """A graph conv's kernel: the layer kernel for a conv of fewer than
    ``conv_stream.SLICE_K`` input channels that is not linear (a 1x1 as its
    3x3), else the streamed one."""
    return "layer" if spec[0] % conv_stream.SLICE_K != 0 and not last else "stream"


def region_routes(specs) -> list[str]:
    """Each layer's kernel in a region-head detector of rows ``specs``:
    "stream" where ``conv_stream.streams`` says so, else "layer" (the
    region route's layer kernel, ``ops.region_layer``)."""
    return ["stream" if conv_stream.streams(spec, i == len(specs) - 1) else "layer"
            for i, spec in enumerate(specs)]


class RegionEngine(DeviceEngine):
    """Batched detection for a ``RegionModel`` on ``device``: the plan of
    launches, each conv's route and its packed weights are set once (the
    weights never change)."""

    _result = RegionResult

    def __init__(self, model, device, max_batch=4096, timeout_s: float | None = 300.0):
        self.device = _check_device(device)
        self.model, self.max_batch, self.timeout_s = model, max_batch, timeout_s
        self.net = TorchRegionNet(model, self.device)
        self._cfg = cfg = model.config
        self._frame = (cfg.in_channels, cfg.img_size, cfg.img_size)
        self._graph = isinstance(cfg, DarknetConfig)
        self._nodes = cfg.graph() if self._graph else None
        cuda = self.device.type == "cuda"
        self._plan = self._graph_plan(cuda) if self._graph else self._chain_plan(cuda)
        # A chain lets each map go once the next layer has read it (a round
        # holds two maps, as it always has). A graph keeps a round's maps
        # to its end: on an H100 yolov3-416's offline rate was 0.4-1.3%
        # higher so in each of 5 pairs of runs, at 22.3 GB of maps against
        # 4.9 when each went after its last reader.
        self._drops = [[] for _ in self._plan]
        if not self._graph:
            for k in range(1, len(self._plan)):
                self._drops[k].append(k - 1)
        self._packed = []
        for step in self._plan:
            kernel = self.net.kernels[step.conv]
            self._packed.append(None if not cuda else region_layer.pack_layer(kernel)
                                if step.route == "layer" else conv_stream.pack_stream(kernel))
        self.backend = "pallas-region-cuda" if cuda else "pallas-region-reference-cpu"

    def _chain_plan(self, cuda: bool) -> list[Launch]:
        """A chain's launches: each layer reads the one before it; pooled
        layers of the layer kernel first, then the streamed ones."""
        cfg = self._cfg
        n = len(cfg.specs)
        plan = []
        for i, (route, spec) in enumerate(zip(region_routes(cfg.specs), cfg.specs)):
            if route == "layer" and cuda and not region_layer.takes(*spec[:3], spec[2]):
                raise ValueError(f"layer {i} {spec}: the region route's layer kernel "
                                 f"takes at most {region_layer.MAX_OC} output channels, "
                                 f"and the streamed kernel input channels in multiples "
                                 f"of {conv_stream.SLICE_K}")
            kwargs = {} if route == "layer" else {"pool": spec[4], "last": i == n - 1}
            plan.append(Launch(i, route, i - 1 if i else None, i, kwargs))
        routes = [s.route for s in plan]
        if "stream" in routes and "layer" in routes[routes.index("stream"):]:
            raise ValueError(f"routes {routes}: the layer kernel's layers must come "
                             f"before the streamed ones")
        return plan

    def _graph_plan(self, cuda: bool) -> list[Launch]:
        """A darknet graph's launches (the module docstring): each conv's
        route, the shortcut or upsample it takes in, and the concatenated
        map it writes into; raises where a row would need a pass of its
        own."""
        cfg = self._cfg
        rows, nodes = cfg.layer_configs, self._nodes
        readers: dict[int, list[int]] = {}
        for r, node in enumerate(nodes):
            for i in node.inputs:
                readers.setdefault(i, []).append(r)
        done: set[int] = set()  # rows whose maps a launch makes
        plan = []
        for conv, r in enumerate(cfg.conv_rows):
            spec = cfg.specs[conv]
            last = r in cfg.linear
            nxt = r + 1 if r + 1 < len(rows) else None
            alone = readers.get(r, []) == [nxt]
            fuse = (nxt is not None and alone and not last
                    and rows[nxt][0] in ("shortcut", "upsample"))
            writes = nxt if fuse else r
            residual = nodes[nxt].inputs[1] if fuse and rows[nxt][0] == "shortcut" else None
            upsample = fuse and rows[nxt][0] == "upsample"
            into = None
            for q in readers.get(writes, []):
                if rows[q][0] == "route" and len(nodes[q].inputs) == 2:
                    off = 0
                    for i in nodes[q].inputs:
                        if i == writes:
                            break
                        off += nodes[i].channels
                    into = (q, off)
            route = graph_route(spec, last)
            if route == "layer":
                mode = "stride2" if spec[4] == 2 else "plain"
                if cuda and (upsample or into is not None
                             or not region_layer.takes(spec[0], spec[1], spec[2], spec[2], mode)):
                    raise ValueError(f"conv {conv} (row {r}) {spec}: the layer kernel takes "
                                     f"no upsample, no route's slice, oc 18-128 even")
                kwargs = {"out_mode": mode}
            else:
                kwargs = {"last": last}
                if spec[4] == 2:
                    kwargs["stride"] = 2
                if upsample:
                    kwargs["upsample"] = True
            src = nodes[r].inputs[0] if nodes[r].inputs else None
            plan.append(Launch(conv, route, src, writes, kwargs, residual, into))
            done.add(writes)
        for r, (row, node) in enumerate(zip(rows, nodes)):
            kind = row[0]
            if kind in ("shortcut", "upsample") and r not in done:
                raise ValueError(f"row {r} {tuple(row)}: a {kind} that no conv's launch "
                                 f"takes in (the conv before it has other readers)")
            if kind == "route" and len(node.inputs) == 2:
                for i in node.inputs:
                    writer = next((s for s in plan if s.writes == self._alias(i, nodes)), None)
                    if writer is None or writer.into is None or writer.into[0] != r:
                        raise ValueError(f"row {r} {tuple(row)}: map {i} is not written "
                                         f"into the concatenation by its conv")
        self._graph_ops = sum(1 for row, node in zip(rows, nodes)
                              if row[0] in ("shortcut", "upsample")
                              or row[0] == "route" and len(node.inputs) == 2)
        return plan

    @staticmethod
    def _alias(r: int, nodes) -> int:
        """The row whose map row ``r``'s is: a one-map route's source."""
        while nodes[r].kind == "route" and len(nodes[r].inputs) == 1:
            r = nodes[r].inputs[0]
        return r

    def _launch(self, i: int, step: Launch, h: torch.Tensor, maps: dict,
                bufs: dict) -> torch.Tensor:
        """Launch ``step`` on ``h`` -> the map it makes."""
        net = self.net
        kernel, bias = net.kernels[step.conv], net.biases[step.conv]
        kwargs = dict(step.kwargs)
        if step.residual is not None:
            kwargs["residual"] = self._map(step.residual, maps, bufs)
        out = None
        if step.into is not None:
            q, off = step.into
            if q not in bufs:
                node = self._nodes[q]
                b = h.shape[0]
                if self.device.type == "cuda":
                    buf = torch.empty((b, node.size, node.size, node.channels),
                                      dtype=torch.uint8, device=self.device).permute(0, 3, 1, 2)
                else:
                    buf = torch.empty((b, node.channels, node.size, node.size),
                                      dtype=torch.uint8)
                bufs[q] = buf
            c = self._nodes[step.writes].channels
            out = bufs[q][:, off:off + c]
        if step.route == "layer":
            made = region_layer.region_layer(h, kernel, bias, net.shifts, step.conv,
                                             packed=self._packed[i], **kwargs)
            if out is not None:  # the CPU's plain version only (_graph_plan)
                out.copy_(made)
                made = out
            return made
        if out is not None:
            kwargs["out"] = out
        return conv_stream.conv_stream(h, kernel, bias, net.shifts, step.conv,
                                       packed=self._packed[i], **kwargs)

    @property
    def _routes(self) -> list[tuple[str, torch.Tensor | None]]:
        """Each launch's route and packed weights, in order."""
        return list(zip((s.route for s in self._plan), self._packed))

    def _map(self, r: int, maps: dict, bufs: dict) -> torch.Tensor:
        """Row ``r``'s map: a one-map route's source's, a concatenating
        route's buffer, else the map its launch made."""
        if not self._graph:
            return maps[r]
        r = self._alias(r, self._nodes)
        return bufs[r] if r in bufs else maps[r]

    def _net(self, x: torch.Tensor, keep: dict | None = None):
        """(B, C, S, S) u8 on the device -> the last layer's int32 sums (a
        chain) or the heads' (a graph, in darknet's head order); each
        launch's output put in ``keep`` under the row it makes, where one
        is given."""
        maps: dict[int, torch.Tensor] = {}
        bufs: dict[int, torch.Tensor] = {}
        with span("engine.net"):
            i = 0
            while i < len(self._plan):
                stream = self._plan[i].route == "stream"
                j = i
                while j < len(self._plan) and (self._plan[j].route == "stream") == stream:
                    j += 1
                with span("net.stream") if stream else contextlib.nullcontext():
                    for k in range(i, j):
                        step = self._plan[k]
                        h = x if step.src is None else self._map(step.src, maps, bufs)
                        out = self._launch(k, step, h, maps, bufs)
                        maps[step.writes] = out
                        if keep is not None:
                            keep[step.writes] = out
                        for r in self._drops[k]:
                            maps.pop(r, None)
                            bufs.pop(r, None)
                i = j
        if not self._graph:
            return maps[self._plan[-1].writes]
        count("net.graph.ops", self._graph_ops * int(x.shape[0]))
        return [self._map(r - 1, maps, bufs) for r in self._cfg.heads]

    def region_maps(self, x: torch.Tensor):
        """The launches on (B, C, S, S) u8 frames on the device, as
        ``detect_device`` makes them -> every launch's output (u8 maps, the
        linear layers' int32 sums; on a card in the kernels' own memory
        formats): a chain's as a list a layer, a graph's as a dict by the
        row each makes (a conv's, or the shortcut's or upsample's it takes
        in; a route's slice a view of the concatenated map)."""
        keep: dict[int, torch.Tensor] = {}
        self._net(x, keep)
        return keep if self._graph else [keep[i] for i in range(len(self._plan))]

    def detect_device(self, x: torch.Tensor):
        """(B, C, S, S) u8 frames on the device -> (None, None, dets,
        count) on the device, nothing copied to the host."""
        net, cfg = self.net, self._cfg
        h = self._net(x)
        if self._graph:
            layers = [cfg.conv_rows.index(r - 1) for r in cfg.heads]
            with span("head.yolo"):
                dets, cnt = yolo_head.yolo_detect(
                    h, net.shifts, layers, cfg.anchors, cfg.masks, cfg.num_classes,
                    cfg.img_size, cfg.thresh, cfg.nms, cfg.max_det)
            count("head.yolo.frames", int(x.shape[0]))
            return None, None, dets, cnt
        with span("head.region"):
            dets, cnt = region_head.region_detect(
                h, net.shifts, len(cfg.layer_configs) - 1, net.anchors, cfg.num_classes,
                cfg.thresh, cfg.nms, cfg.max_det)
        count("head.region.frames", int(x.shape[0]))
        return None, None, dets, cnt
