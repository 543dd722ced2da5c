"""RegionEngine — a region-head detector (``models.region.RegionModel``)
on one CUDA device.

Every layer runs on the port's layer kernels, routed by its geometry
(``region_routes``): a pooled 3x3 layer of fewer than 128 input channels,
not the last, on the region route's layer kernel (``ops.region_layer``:
any ic from 1 to 127, oc up to 128, an even map; channels-last maps out),
the rest on the weight-streaming kernel (``ops.conv_stream``, inside the
span ``net.stream``); then the region head's kernel (``ops.region_head``, span
``head.region``, counter ``head.region.frames``). ``detect_device`` takes
(B, C, S, S) u8 frames and returns ``(None, None, dets, count)``;
``detect_batch`` a ``RegionResult``; ``region_maps`` every layer's output.
The device plumbing is ``engine.device``'s. ``engine.cuda.CUDAEngine``
hands a ``RegionModel`` to this class.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_cnn_torch.engine.device import DeviceEngine, _check_device
from tpu_cnn_torch.models.region import TorchRegionNet
from tpu_cnn_torch.ops import conv_stream, region_head, region_layer
from tpu_cnn_torch.utils.profiling import count, span


@dataclasses.dataclass
class RegionResult:
    """A region-head detector's answers."""

    dets: np.ndarray  # (B, max_det, 6) float32 (x, y, w, h, score, class)
    count: np.ndarray  # (B,) int32


def region_routes(specs) -> list[str]:
    """Each layer's kernel in a region-head detector of rows ``specs``:
    "stream" where ``conv_stream.streams`` says so, else "layer" (the
    region route's layer kernel, ``ops.region_layer``)."""
    return ["stream" if conv_stream.streams(spec, i == len(specs) - 1) else "layer"
            for i, spec in enumerate(specs)]


class RegionEngine(DeviceEngine):
    """Batched detection for a ``RegionModel`` on ``device``: each layer's
    route and packed weights are set once (the weights never change)."""

    _result = RegionResult

    def __init__(self, model, device, max_batch=4096, timeout_s: float | None = 300.0):
        self.device = _check_device(device)
        self.model, self.max_batch, self.timeout_s = model, max_batch, timeout_s
        self.net = TorchRegionNet(model, self.device)
        self._cfg = cfg = model.config
        self._frame = (cfg.in_channels, cfg.img_size, cfg.img_size)
        cuda = self.device.type == "cuda"
        self._routes = []
        for i, (route, spec, kernel) in enumerate(zip(region_routes(cfg.specs), cfg.specs,
                                                       self.net.kernels)):
            if route == "layer" and cuda and not region_layer.takes(*spec[:3], spec[2]):
                raise ValueError(f"layer {i} {spec}: the region route's layer kernel "
                                 f"takes at most {region_layer.MAX_OC} output channels, "
                                 f"and the streamed kernel input channels in multiples "
                                 f"of {conv_stream.SLICE_K}")
            packed = (None if not cuda else region_layer.pack_layer(kernel) if route == "layer"
                      else conv_stream.pack_stream(kernel))
            self._routes.append((route, packed))
        routes = [r for r, _ in self._routes]
        self._n_layer = routes.index("stream")
        if "layer" in routes[self._n_layer:]:
            raise ValueError(f"routes {routes}: the layer kernel's layers must come "
                             f"before the streamed ones")
        self.backend = "pallas-region-cuda" if cuda else "pallas-region-reference-cpu"

    def _net(self, x: torch.Tensor, maps: list | None = None) -> torch.Tensor:
        """(B, C, S, S) u8 on the device -> the last layer's int32 sums,
        each layer's output appended to ``maps`` where one is given."""
        net, cfg = self.net, self._cfg
        n = len(cfg.layer_configs)
        keep = maps.append if maps is not None else (lambda _: None)
        with span("engine.net"):
            h = x
            for i in range(self._n_layer):
                h = region_layer.region_layer(h, net.kernels[i], net.biases[i], net.shifts, i,
                                              packed=self._routes[i][1])
                keep(h)
            with span("net.stream"):
                for i in range(self._n_layer, n):
                    h = conv_stream.conv_stream(
                        h, net.kernels[i], net.biases[i], net.shifts, i,
                        pool=cfg.specs[i][4], last=i == n - 1,
                        packed=self._routes[i][1])
                    keep(h)
        return h

    def region_maps(self, x: torch.Tensor) -> list[torch.Tensor]:
        """The layers on (B, C, S, S) u8 frames on the device, as
        ``detect_device`` launches them -> every layer's output (u8 maps,
        the last layer's int32 sums; on a card in the kernels' own memory
        formats)."""
        maps = []
        self._net(x, maps)
        return maps

    def detect_device(self, x: torch.Tensor):
        """(B, C, S, S) u8 frames on the device -> (None, None, dets,
        count) on the device, nothing copied to the host."""
        net, cfg = self.net, self._cfg
        h = self._net(x)
        with span("head.region"):
            dets, cnt = region_head.region_detect(
                h, net.shifts, len(cfg.layer_configs) - 1, net.anchors, cfg.num_classes,
                cfg.thresh, cfg.nms, cfg.max_det)
        count("head.region.frames", int(x.shape[0]))
        return None, None, dets, cnt
