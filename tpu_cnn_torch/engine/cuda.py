"""CUDAEngine — batched fused detection on one CUDA device.

Port of ``tpu_cnn.engine.tpu.TPUEngine``: the single-box detect and the
multi-object / instance detect (``detect_multi_batch``), with its backends
under their names, so that the apps' ``--mode`` flag carries over:

  - ``"mega"`` (the default): the net on the chained plan
    (``ops.mega.cnn_forward_mega``: the ``mega_plan`` head layers one
    kernel each, then the megakernel with its fused bin pooling and bf16
    feature twin), then the head: with the bins head and the "ref" box
    one more kernel (``ops.cam_head``, ``csrc/cam_head.cu``), else the
    plain-torch head (``ops.detect_head``);
  - ``"pallas"``: every layer on the conv kernel ``ops.int8.conv_act``
    (``cnn_forward_pallas``), then ``detect_head.detect`` on the features;
  - ``"hybrid"``: layer 0 on that kernel, the deeper layers plain
    (``cnn_forward_hybrid``), then ``detect``;
  - ``"xla"``: the plain contract ``ops.quant.cnn_forward`` (f32 or int32,
    ``compute_dtype``), then ``detect``. It launches no kernel.

A region-head detector (``models.region.RegionModel``, ``box_mode``
"region") runs on ``"pallas"`` alone, every layer on the port's layer
kernels, routed by its geometry (``region_routes``): a pooled 3x3 layer of
fewer than 128 input channels, not the last, on the layer kernel with its
bias (``int8.fused_conv_layer``; on a card its weights must fit a block by
the library's own plan), the rest on the weight-streaming kernel
(``ops.conv_stream``, inside the span ``net.stream``); then the region
head's kernel (``ops.region_head``, span ``head.region``, counter
``head.region.frames``). ``detect_device`` takes (B, C, S, S) u8 frames
and returns ``(None, None, dets, count)``; ``region_maps`` every layer's
output.

The engine picks no backend on its own (``apps.infer.make_engine`` resolves
``--mode auto``). All of it runs on the device; only
the head's outputs come back to the host, through pinned buffers and a
recorded event (the multi head's boxes as u8 and its instance counts as
int16 on that copy, restored to int32 on the host).

``MultiDetectResult`` is the JAX engine module's, copied; its filters
``presence_scores``, ``detections_above`` and ``instance_detections``
(copies too) live in ``head.detections``, which the deployable's loader
reads without this module, and are importable from here as before.

The device is explicit: ``"cuda"`` runs the kernels and raises when there
is no card; ``"cpu"`` runs their plain versions (for tests on machines
without a card). Nothing picks a device on its own.

While a ``torch.profiler`` profile runs, the engine's stages are spans
(``utils.profiling.span``): ``engine.detect`` around ``detect_batch`` and
``detect_multi_batch``, and inside it ``engine.to_device`` (the H2D),
``engine.net`` (the net's launches), the head's ``head.*``,
``engine.to_host`` (pinned buffers, copies, event) and ``engine.wait``
(the wait for that event).

Engine protocol (``run(gray) -> (features, conv_ms, read_ms)``) and the
serving protocol (``detect_batch_async`` / ``detect_resolve``) match
``TPUEngine``, so the port's copies of ``run_inference`` (``apps.infer``)
and ``DynamicBatcher`` (``apps.serve``) drive it as the JAX ones drive
that engine.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_cnn_torch.head.detections import (DEFAULT_MULTI_THRESH,  # noqa: F401
                                           detections_above,
                                           instance_detections,
                                           presence_scores)
from tpu_cnn_torch.models.cnn import FpgaCNN, TorchFpgaCNN
from tpu_cnn_torch.models.region import RegionModel, TorchRegionNet
from tpu_cnn_torch.ops import (cam_head, conv_stream, detect_head, int8, mega, quant,
                               region_head)
from tpu_cnn_torch.utils.failguard import wait_event
from tpu_cnn_torch.utils.profiling import count, span, spanned


@dataclasses.dataclass
class DetectResult:
    """The fields of ``tpu_cnn.engine.tpu.DetectResult``."""

    pred: np.ndarray  # (B,) int32
    conf: np.ndarray  # (B,) float32
    probs: np.ndarray  # (B, num_classes) float32
    bbox: np.ndarray  # (B, 4) int32 (x1, y1, x2, y2)


@dataclasses.dataclass
class MultiDetectResult:
    """The fields of ``tpu_cnn.engine.tpu.MultiDetectResult``: the argmax
    fields, every class's CAM box, and the instance outputs and presence
    scores where asked for and shipped."""

    pred: np.ndarray  # (B,) int32
    conf: np.ndarray  # (B,) float32
    probs: np.ndarray  # (B, num_classes) float32
    boxes: np.ndarray  # (B, num_classes, 4) int32 (x1, y1, x2, y2)
    inst_boxes: np.ndarray | None = None  # (B, num_classes, I, 4) int32
    inst_counts: np.ndarray | None = None  # (B, num_classes, I) int32
    scores: np.ndarray | None = None  # (B, num_classes) f32 presence scores

    def detections(self, threshold=DEFAULT_MULTI_THRESH,
                   min_pixels: int | None = None):
        """Per image: :func:`instance_detections` when the instance outputs
        are present, else :func:`detections_above`, on
        :func:`presence_scores`."""
        sc = presence_scores(self)
        if self.inst_boxes is not None:
            return [instance_detections(sc[b], self.boxes[b],
                                        self.inst_boxes[b],
                                        self.inst_counts[b], threshold,
                                        min_pixels)
                    for b in range(sc.shape[0])]
        return [detections_above(sc[b], self.boxes[b], threshold)
                for b in range(sc.shape[0])]


@dataclasses.dataclass
class RegionResult:
    """A region-head detector's answers."""

    dets: np.ndarray  # (B, max_det, 6) float32 (x, y, w, h, score, class)
    count: np.ndarray  # (B,) int32


BACKENDS = ("mega", "pallas", "hybrid", "xla")


def _check_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but torch finds no CUDA "
                               "device")
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError(
                "torch.backends.cuda.matmul.allow_tf32 is on: the head's "
                "f32 matmuls would run in TF32 and drift from the "
                "reference; switch it off")
    elif dev.type != "cpu":
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def region_routes(specs) -> list[str]:
    """Each layer's kernel in a region-head detector of rows ``specs``:
    "stream" where ``conv_stream.streams`` says so, else "layer" (the
    layer kernel with the bias)."""
    return ["stream" if conv_stream.streams(spec, i == len(specs) - 1) else "layer"
            for i, spec in enumerate(specs)]


class CUDAEngine:
    """Batched inference for the FpgaCNN contract on ``device``.

    ``backend``: one of ``BACKENDS`` (module docstring); ``compute_dtype``
    ("float32" or "int32") applies to "xla". ``box_mode``: "ref" (reference
    CAM threshold box), "centroid" (CAM mass-centroid box) or "reg" (learned
    regression on the pooled bins; needs the bundle's bbox_weight; the
    multi head falls back to "ref"). The multi head's device->host copy
    carries u8 boxes and int16 counts whenever the image size is at most
    256 (``compact_multi``). The model's shifts must lie in 0..31. A
    ``RegionModel`` takes ``backend`` "pallas" and ``box_mode`` "region"
    (the module docstring), and nothing else does."""

    def __init__(self, model: FpgaCNN | RegionModel, device: torch.device | str,
                 backend: str = "mega", compute_dtype: str = "float32",
                 max_batch: int = 4096, timeout_s: float | None = 300.0,
                 box_mode: str = "ref"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: need one of "
                             f"{BACKENDS}")
        self._region = None
        if isinstance(model, RegionModel):
            self._init_region(model, device, backend, max_batch, timeout_s, box_mode)
            return
        if compute_dtype not in ("float32", "int32"):
            raise ValueError(f"compute_dtype {compute_dtype!r}: need "
                             f"'float32' or 'int32'")
        quant.check_shifts(model.shifts)
        self.device = _check_device(device)
        if box_mode not in ("ref", "centroid", "reg"):
            raise ValueError(f"unknown box_mode {box_mode!r}")
        if box_mode == "reg" and model.bbox_weight is None:
            raise ValueError("box_mode='reg' needs a bbox_weight.npy in the "
                             "artifact bundle")
        cfgs = model.config.layer_configs
        self.model = model
        self.max_batch = max_batch
        self.timeout_s = timeout_s
        self.box_mode = box_mode
        self.compute_dtype = compute_dtype
        self.compact_multi = model.config.img_size <= 256
        self._backend = backend
        self.net = TorchFpgaCNN.from_fpga_cnn(model, self.device)
        # the kernels' weights, packed once for every backend that launches
        # them: the engine's kernels never change (set_shifts changes only
        # the shift vector)
        ks = self.net.kernels
        self._packed = (
            mega.pack_plan(ks, model.config.img_size) if backend == "mega"
            else [mega.pack_layer(k) for k in ks] if backend == "pallas"
            else [mega.pack_layer(ks[0]), *[None] * (len(ks) - 1)]
            if backend == "hybrid" else None)
        # kernels one pass of the net launches
        if backend == "mega":
            n_head = mega.mega_plan(cfgs)
            if n_head is None:
                raise ValueError(f"no tail of {cfgs} fits the megakernel")
            self._kernels_per_pass = n_head + 1  # the head layers + the tail
            name = f"chain{n_head}" if n_head else "mega"
        else:
            self._kernels_per_pass = {"pallas": len(cfgs), "hybrid": 1,
                                      "xla": 0}[backend]
            name = backend
        if self.device.type == "cpu":
            self.backend = ("reference-cpu" if backend == "mega"
                            else f"{backend}-reference-cpu")
        else:
            self.backend = f"{name}-cuda"
        self.launches = 0  # kernel launches made by this engine

    def _init_region(self, model, device, backend, max_batch, timeout_s, box_mode):
        """A region-head detector's engine: each layer's route and packed
        weights (packed once: the weights never change)."""
        if backend != "pallas":
            raise ValueError(f"a region-head detector runs on the 'pallas' backend "
                             f"(every layer on the port's layer kernels), not "
                             f"{backend!r}")
        if box_mode != "region":
            raise ValueError(f"a region-head detector takes box_mode 'region', not "
                             f"{box_mode!r}")
        self.device = _check_device(device)
        self.model, self.max_batch, self.timeout_s = model, max_batch, timeout_s
        self.box_mode, self._backend = box_mode, backend
        self.net = TorchRegionNet(model, self.device)
        specs = model.config.specs
        cuda = self.device.type == "cuda"
        self._routes = []
        for i, (route, spec, kernel) in enumerate(zip(region_routes(specs), specs,
                                                       self.net.kernels)):
            if route == "layer" and cuda and not int8.layer_smem(spec[0], spec[1]):
                raise ValueError(f"layer {i} {spec}: its weights fit no block of the "
                                 f"layer kernel, and the streamed kernel takes input "
                                 f"channels in multiples of {conv_stream.SLICE_K}")
            packed = None
            if cuda:
                packed = (mega.pack_layer(kernel) if route == "layer"
                          else conv_stream.pack_stream(kernel))
            self._routes.append((route, packed))
        routes = [r for r, _ in self._routes]
        self._n_layer = routes.index("stream")
        if "layer" in routes[self._n_layer:]:
            raise ValueError(f"routes {routes}: the layer kernel's layers must come "
                             f"before the streamed ones")
        self._region = model.config
        self.backend = "pallas-region-cuda" if cuda else "pallas-region-reference-cpu"
        self.launches = 0

    @property
    def mode(self) -> str:
        """The backend this engine runs, by its ``BACKENDS`` name."""
        return self._backend

    def _region_net(self, x: torch.Tensor, maps: list | None = None) -> torch.Tensor:
        """(B, C, S, S) u8 on the device -> the last layer's int32 sums,
        each layer's output appended to ``maps`` where one is given."""
        net, cfg = self.net, self._region
        n = len(cfg.layer_configs)
        keep = maps.append if maps is not None else (lambda _: None)
        with span("engine.net"):
            h = x
            for i in range(self._n_layer):
                h = int8.fused_conv_layer(h, net.kernels[i], net.shifts, i,
                                          packed=self._routes[i][1], bias=net.biases[i])
                keep(h)
            with span("net.stream"):
                for i in range(self._n_layer, n):
                    h = conv_stream.conv_stream(
                        h, net.kernels[i], net.biases[i], net.shifts, i,
                        pool=cfg.specs[i][4], last=i == n - 1,
                        packed=self._routes[i][1])
                    keep(h)
        if x.is_cuda:
            self.launches += n
        return h

    def region_maps(self, x: torch.Tensor) -> list[torch.Tensor]:
        """A region-head detector's layers on (B, C, S, S) u8 frames on the
        device, as ``detect_device`` launches them -> every layer's output
        (u8 maps, the last layer's int32 sums; on a card in the kernels'
        own memory formats)."""
        if self._region is None:
            raise ValueError("region_maps runs a region-head detector's layers")
        maps = []
        self._region_net(x, maps)
        return maps

    def _region_detect(self, x: torch.Tensor):
        """(B, C, S, S) u8 on the device -> (dets, count) on the device."""
        net, cfg = self.net, self._region
        h = self._region_net(x)
        with span("head.region"):
            dets, cnt = region_head.region_detect(
                h, net.shifts, len(cfg.layer_configs) - 1, net.anchors, cfg.num_classes,
                cfg.thresh, cfg.nms, cfg.max_det)
        count("head.region.frames", int(x.shape[0]))
        if x.is_cuda:
            self.launches += 1
        return dets, cnt

    # ── device work ───────────────────────────────────────────────────

    @spanned("engine.to_device")
    def _to_device(self, images):
        """Raw (B, S, S) / flat u8 images or a stage_batch handle ->
        (device tensor, B)."""
        if isinstance(images, tuple) and len(images) == 3 and images[0] == "staged":
            return images[1], images[2]
        s = self.model.config.img_size
        shape = (-1, self._region.in_channels, s, s) if self._region else (-1, s, s)
        arr = np.ascontiguousarray(images, dtype=np.uint8).reshape(shape)
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"batch {arr.shape[0]} exceeds max_batch "
                             f"{self.max_batch}")
        return torch.from_numpy(arr).to(self.device), arr.shape[0]

    def _mega(self, x: torch.Tensor, **outputs) -> list[torch.Tensor]:
        with span("engine.net"):
            out = mega.cnn_forward_mega(x, self.net.kernels, self.net.shifts,
                                        packed=self._packed, **outputs)
        if x.is_cuda:
            self.launches += self._kernels_per_pass
        return list(out) if isinstance(out, tuple) else [out]

    def _features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S) u8 on the device -> (B, C, S'*S') u8 features on the
        engine's backend."""
        if self._backend == "mega":
            return self._mega(x, with_feats=True)[0]
        ks, sh = self.net.kernels, self.net.shifts
        with span("engine.net"):
            if self._backend == "pallas":
                feats = int8.cnn_forward_pallas(x, ks, sh, packed=self._packed)
            elif self._backend == "hybrid":
                feats = int8.cnn_forward_hybrid(x, ks, sh, packed=self._packed)
            else:
                feats = quant.cnn_forward(x, ks, sh,
                                          compute_dtype=self.compute_dtype)
        if x.is_cuda:
            self.launches += self._kernels_per_pass
        return feats

    def detect_device(self, x: torch.Tensor, with_feats: bool = False):
        """The fused detect on device-resident tensors: (B, S, S) u8 images
        on the engine's device -> (feats or None, pooled or None, pred,
        conf, probs, bbox) on the device, nothing copied to the host (the
        bench times this path, and the mesh runs it per position).

        Bins head: one kernel emits the bins (classifier, "reg" box) and,
        for the CAM box modes, the bf16 twin; the u8 features are written
        only when asked for. With the "ref" box, the head is one more
        kernel (``ops.cam_head``), else the plain-torch head. GAP head: the classifier needs global means,
        so the kernel writes the u8 features and the head pools them.
        Other backends: the features, then ``detect_head.detect`` on them
        (the JAX engine's unfused branch); the bins are pooled apart only
        when the features are asked for too (the parity gate's path).

        A region-head detector: (B, C, S, S) u8 frames -> (None, None,
        dets, count) (the module docstring)."""
        if self._region is not None:
            if with_feats:
                raise ValueError("a region-head detector has no CAM features")
            return (None, None, *self._region_detect(x))
        net, img = self.net, self.model.config.img_size
        if self._backend != "mega":
            feats = self._features(x)
            pred, conf, probs, bbox = detect_head.detect(
                feats, net.fc_weight, net.fc_bias, self.model.head_mode, img,
                box_mode=self.box_mode, bbox_weight=net.bbox_weight)
            if not with_feats:
                return None, None, pred, conf, probs, bbox
            return feats, detect_head.bin_pool(feats), pred, conf, probs, bbox
        if self.model.head_mode == "bins":
            with_twin = self.box_mode != "reg"
            outs = self._mega(x, with_feats=with_feats, with_bins=True,
                              with_twin=with_twin)
            feats = outs.pop(0) if with_feats else None
            pooled = outs.pop(0)
            twin = outs.pop(0) if with_twin else None
            if self.box_mode == "ref":
                pred, conf, probs, bbox = cam_head.detect_pooled_fused(
                    pooled, twin, net.fc_weight, net.fc_bias, img)
                if x.is_cuda:
                    self.launches += 1
            else:
                pred, conf, probs, bbox = detect_head.detect_with_pooled(
                    None, pooled, net.fc_weight, net.fc_bias, img,
                    features_twin=twin, box_mode=self.box_mode,
                    bbox_weight=net.bbox_weight)
        else:
            feats, pooled = self._mega(x, with_feats=True, with_bins=True)
            pred, conf, probs, bbox = detect_head.detect(
                feats, net.fc_weight, net.fc_bias, "gap", img,
                box_mode=self.box_mode, bbox_weight=net.bbox_weight)
        return feats, pooled, pred, conf, probs, bbox

    def _detect_multi_device(self, x: torch.Tensor, instances: int):
        """The multi head's outputs on the device: (pred, conf, probs,
        boxes[, inst_boxes, inst_counts][, scores]).

        Bins head on "mega": the kernel's bins and bf16 twin only (no u8
        features), then ``detect_multi_with_pooled``. Other backends and
        the GAP head: the features, then ``detect_multi``."""
        net, img = self.net, self.model.config.img_size
        box_mode = "centroid" if self.box_mode == "centroid" else "ref"
        if self._backend == "mega" and self.model.head_mode == "bins":
            pooled, twin = self._mega(x, with_feats=False, with_bins=True,
                                      with_twin=True)
            out = detect_head.detect_multi_with_pooled(
                pooled, twin, net.fc_weight, net.fc_bias, img,
                box_mode=box_mode, instances=instances,
                multi_head=net.multi_head)
        else:
            out = detect_head.detect_multi(
                self._features(x), net.fc_weight, net.fc_bias,
                self.model.head_mode, img, box_mode=box_mode,
                instances=instances, multi_head=net.multi_head)
        if self.compact_multi:  # u8 boxes, int16 counts on the wire
            out = list(out)
            out[3] = out[3].to(torch.uint8)
            if instances > 1:
                out[4] = out[4].to(torch.uint8)
                out[5] = out[5].to(torch.int16)
        return tuple(out)

    def _sync(self) -> None:
        """Bounded wait for the work queued so far on the device."""
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.device))
            wait_event(event, self.timeout_s,
                       diagnostics=lambda: f"backend={self.backend}")

    @spanned("engine.to_host")
    def _to_host_async(self, tensors):
        """Start device->host copies into pinned buffers and record an
        event; the handle resolves with :meth:`_fetch`."""
        if self.device.type == "cpu":
            return tuple(tensors), None
        host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in tensors)
        for h, t in zip(host, tensors):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return host, event

    def _fetch(self, handle) -> tuple[np.ndarray, ...]:
        """Bounded wait for a :meth:`_to_host_async` handle -> numpy."""
        host, event = handle
        with span("engine.wait"):
            if event is not None:
                wait_event(event, self.timeout_s,
                           diagnostics=lambda: f"backend={self.backend}")
        return tuple(h.numpy() for h in host)

    # ── public API ────────────────────────────────────────────────────

    def warmup(self, batch: int = 1, multi: bool = False,
               instances: int = 1) -> None:
        """Run the fused detect once at ``batch``, and the multi detect too
        when ``multi`` (on CUDA this also builds and loads the kernels)."""
        s = self.model.config.img_size
        zeros = np.zeros((batch, self._region.in_channels, s, s) if self._region
                         else (batch, s, s), np.uint8)
        self.detect_batch(zeros)
        if multi:
            self.detect_multi_batch(zeros, instances=instances)

    def set_shifts(self, *shifts: int) -> None:
        """Runtime shift update — register semantics: an in-stream copy
        into the device shift vector the kernel reads. Work already
        dispatched keeps the old shifts; nothing is rebuilt and the host
        does not wait. Each shift must lie in 0..31."""
        if len(shifts) != len(self.model.config.layer_configs):
            raise ValueError("one shift per layer required")
        quant.check_shifts(shifts)
        self.model.shifts = np.asarray(shifts, np.int32)
        src = torch.from_numpy(self.model.shifts)
        if self.device.type == "cuda":
            src = src.pin_memory()
        self.net.shifts.copy_(src, non_blocking=True)

    def run(self, gray: np.ndarray):
        """Engine protocol: one image -> ((C, S'*S') u8, conv_ms, read_ms)."""
        x, _ = self._to_device(gray)
        t0 = time.perf_counter()
        feats = self._features(x)
        self._sync()
        conv_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        host = feats[0].cpu().numpy()
        read_ms = (time.perf_counter() - t1) * 1e3
        return host, conv_ms, read_ms

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        """(B, S, S) u8 -> (B, C, S'*S') u8 features."""
        x, _ = self._to_device(images)
        return self._fetch(self._to_host_async((self._features(x),)))[0]

    def run_batch_pooled(self, images: np.ndarray) -> np.ndarray:
        """(B, S, S) u8 -> (B, C*16) f32 bin-pooled features: on "mega"
        from the kernel's fused bins (the feature map is never written),
        else ``bin_pool`` of the features."""
        x, _ = self._to_device(images)
        if self._backend == "mega":
            out = self._mega(x, with_feats=False, with_bins=True)
        else:
            out = (detect_head.bin_pool(self._features(x)),)
        return self._fetch(self._to_host_async(out))[0]

    @spanned("engine.detect")
    def detect_batch(self, images) -> DetectResult:
        """Fused detect: only predictions and boxes return to the host."""
        return self.detect_resolve(self.detect_batch_async(images))

    def stage_batch(self, images: np.ndarray) -> tuple:
        """Copy a batch to the device ahead of time; pass the handle to
        :meth:`detect_batch_async` to drive device throughput alone."""
        x, b = self._to_device(images)
        self._sync()
        return ("staged", x, b)

    def detect_batch_async(self, images):
        """Dispatch a fused detect without waiting; returns a handle for
        :meth:`detect_resolve`. Several handles may be in flight. Takes raw
        (B, S, S) u8 images or a :meth:`stage_batch` handle."""
        x, _ = self._to_device(images)
        return self._to_host_async(self.detect_device(x)[2:])

    def detect_resolve(self, handle) -> DetectResult | RegionResult:
        return (RegionResult if self._region is not None else DetectResult)(
            *self._fetch(handle))

    @spanned("engine.detect")
    def detect_multi_batch(self, images, instances: int = 1) -> MultiDetectResult:
        """Multi-object detect: the classifier and every class's own CAM
        box; with ``instances > 1`` also up to that many watershed
        component boxes per class; with the bundle's presence head the
        scores. Filter with :meth:`MultiDetectResult.detections`."""
        return self.detect_multi_resolve(
            self.detect_multi_batch_async(images, instances=instances))

    def detect_multi_batch_async(self, images, instances: int = 1):
        """Dispatch :meth:`detect_multi_batch` without waiting for the
        results (the instance loops wait once per block of label steps);
        takes raw images or a :meth:`stage_batch` handle. Resolve with
        :meth:`detect_multi_resolve`."""
        if instances < 1:
            raise ValueError(f"instances must be >= 1, got {instances}")
        x, _ = self._to_device(images)
        return self._to_host_async(self._detect_multi_device(x, instances))

    def detect_multi_resolve(self, handle) -> MultiDetectResult:
        out = list(self._fetch(handle))
        scores = out.pop() if self.net.multi_head is not None else None
        if self.compact_multi:  # restore the wire dtypes to int32
            out[3:] = [a.astype(np.int32) for a in out[3:]]
        return MultiDetectResult(*out, scores=scores)

    def detect_with_features(self, images) -> tuple[np.ndarray, ...]:
        """The fused detect path with the u8 features written as well:
        (feats, pooled, pred, conf, probs, bbox) — what the parity gate
        (``bench_gate.run_parity_gate``) checks."""
        x, _ = self._to_device(images)
        return self._fetch(self._to_host_async(self.detect_device(x, with_feats=True)))

    def features_device(self, images_dev: torch.Tensor) -> torch.Tensor:
        """Device-resident features for pipelines that keep data on the
        device."""
        return self._features(images_dev)
