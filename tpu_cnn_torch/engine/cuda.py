"""CUDAEngine — batched fused detection of the FpgaCNN family on one CUDA
device.

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

The engine picks no backend on its own (``apps.infer.make_engine`` resolves
``--mode auto``). The device plumbing, its spans and the serving protocol
are ``engine.device``'s; this class adds ``engine.detect`` around
``detect_multi_batch``, whose boxes cross to the host as u8 and instance
counts as int16, restored to int32 on the host. The engine protocol
(``run(gray) -> (features, conv_ms, read_ms)``) matches ``TPUEngine``'s, so
the port's copy of ``run_inference`` (``apps.infer``) drives it as the JAX
one drives that engine.

A region-head detector is ``engine.region.RegionEngine``'s:
``CUDAEngine(model, ...)`` on one returns that engine.

``MultiDetectResult`` is the JAX engine module's, copied; its filters
``presence_scores``, ``detections_above`` and ``instance_detections``
(copies too) live in ``head.detections``, which the deployable's loader
reads without this module, and are importable from here as before.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from tpu_cnn_torch.engine.device import DeviceEngine, _check_device
from tpu_cnn_torch.engine.region import (RegionEngine, RegionResult,  # noqa: F401
                                         region_routes)
from tpu_cnn_torch.head.detections import (DEFAULT_MULTI_THRESH,  # noqa: F401
                                           detections_above,
                                           instance_detections,
                                           presence_scores)
from tpu_cnn_torch.models.cnn import FpgaCNN, TorchFpgaCNN
from tpu_cnn_torch.models.region import RegionModel
from tpu_cnn_torch.ops import cam_head, detect_head, int8, mega, quant
from tpu_cnn_torch.utils.profiling import span, spanned


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


BACKENDS = ("mega", "pallas", "hybrid", "xla")


class CUDAEngine(DeviceEngine):
    """Batched inference for the FpgaCNN contract on ``device``.

    ``backend``: one of ``BACKENDS`` (module docstring); ``compute_dtype``
    ("float32" or "int32") applies to "xla". ``box_mode``: "ref" (reference
    CAM threshold box), "centroid" (CAM mass-centroid box) or "reg" (learned
    regression on the pooled bins; needs the bundle's bbox_weight; the
    multi head falls back to "ref"). The multi head's device->host copy
    carries u8 boxes and int16 counts whenever the image size is at most
    256 (``compact_multi``). The model's shifts must lie in 0..31. A
    region-head model gets a ``RegionEngine`` (module docstring)."""

    _result = DetectResult

    def __new__(cls, model: FpgaCNN | RegionModel, device, backend="mega",
                compute_dtype="float32", max_batch=4096, timeout_s=300.0, box_mode="ref"):
        # the benchmark builds every configuration through CUDAEngine
        if not isinstance(model, RegionModel):
            return super().__new__(cls)
        if backend != "pallas":
            raise ValueError(f"a region-head detector runs on the 'pallas' backend "
                             f"(every layer on the port's layer kernels), not "
                             f"{backend!r}")
        want = model.head_mode  # "region" (a chain) or "yolo" (a darknet graph)
        if box_mode != want:
            raise ValueError(f"this region-head detector takes box_mode {want!r}, not "
                             f"{box_mode!r}")
        return RegionEngine(model, device, max_batch, timeout_s)

    def __init__(self, model: FpgaCNN, device: torch.device | str,
                 backend: str = "mega", compute_dtype: str = "float32",
                 max_batch: int = 4096, timeout_s: float | None = 300.0,
                 box_mode: str = "ref"):
        if backend not in BACKENDS:
            raise ValueError(f"unknown backend {backend!r}: need one of "
                             f"{BACKENDS}")
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
        s = model.config.img_size
        self.model, self.max_batch, self.timeout_s = model, max_batch, timeout_s
        self.box_mode, self.compute_dtype = box_mode, compute_dtype
        self.compact_multi = s <= 256
        self._backend = backend
        self._frame = (s, s)
        self.net = TorchFpgaCNN.from_fpga_cnn(model, self.device)
        # the kernels' weights, packed once for every backend that launches
        # them: the engine's kernels never change (set_shifts changes only
        # the shift vector)
        ks = self.net.kernels
        self._packed = (
            mega.pack_plan(ks, s) if backend == "mega"
            else [mega.pack_layer(k) for k in ks] if backend == "pallas"
            else [mega.pack_layer(ks[0]), *[None] * (len(ks) - 1)]
            if backend == "hybrid" else None)
        n_head = mega.mega_plan(cfgs) if backend == "mega" else 0
        if n_head is None:
            raise ValueError(f"no tail of {cfgs} fits the megakernel")
        name = f"chain{n_head}" if n_head else backend
        self.backend = (f"{name}-cuda" if self.device.type == "cuda" else "reference-cpu"
                        if backend == "mega" else f"{backend}-reference-cpu")

    @property
    def mode(self) -> str:
        """The backend this engine runs, by its ``BACKENDS`` name."""
        return self._backend

    # ── device work ───────────────────────────────────────────────────

    def _mega(self, x: torch.Tensor, **outputs) -> list[torch.Tensor]:
        with span("engine.net"):
            out = mega.cnn_forward_mega(x, self.net.kernels, self.net.shifts,
                                        packed=self._packed, **outputs)
        return list(out) if isinstance(out, tuple) else [out]

    def features_device(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S) u8 on the device -> (B, C, S'*S') u8 features on the
        engine's backend, left on the device."""
        if self._backend == "mega":
            return self._mega(x, with_feats=True)[0]
        ks, sh = self.net.kernels, self.net.shifts
        with span("engine.net"):
            if self._backend == "pallas":
                return int8.cnn_forward_pallas(x, ks, sh, packed=self._packed)
            if self._backend == "hybrid":
                return int8.cnn_forward_hybrid(x, ks, sh, packed=self._packed)
            return quant.cnn_forward(x, ks, sh, compute_dtype=self.compute_dtype)

    def detect_device(self, x: torch.Tensor, with_feats: bool = False):
        """The fused detect on device-resident tensors: (B, S, S) u8 images
        on the engine's device -> (feats or None, pooled or None, pred,
        conf, probs, bbox) on the device, nothing copied to the host (the
        bench times this path, and the mesh runs it per position).

        Bins head: one kernel emits the bins (classifier, "reg" box) and,
        for the CAM box modes, the bf16 twin; the u8 features are written
        only when asked for. With the "ref" box, the head is one more
        kernel (``ops.cam_head``), else the plain-torch head. GAP head: the
        classifier needs global means, so the kernel writes the u8 features
        and the head pools them.
        Other backends: the features, then ``detect_head.detect`` on them
        (the JAX engine's unfused branch); the bins are pooled apart only
        when the features are asked for too (the parity gate's path)."""
        net, img = self.net, self.model.config.img_size
        if self._backend != "mega":
            feats = self.features_device(x)
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

    def detect_multi_device(self, x: torch.Tensor, instances: int):
        """The multi head's outputs on the device (the counterpart of
        :meth:`detect_device`): (pred, conf, probs, boxes[, inst_boxes,
        inst_counts][, scores]).

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
                self.features_device(x), net.fc_weight, net.fc_bias,
                self.model.head_mode, img, box_mode=box_mode,
                instances=instances, multi_head=net.multi_head)
        if self.compact_multi:  # u8 boxes, int16 counts on the wire
            out = list(out)
            out[3] = out[3].to(torch.uint8)
            if instances > 1:
                out[4] = out[4].to(torch.uint8)
                out[5] = out[5].to(torch.int16)
        return tuple(out)

    # ── public API ────────────────────────────────────────────────────

    def warmup(self, batch: int = 1, multi: bool = False,
               instances: int = 1) -> None:
        """Run the fused detect once at ``batch``, and the multi detect too
        when ``multi`` (on CUDA this also builds and loads the kernels)."""
        super().warmup(batch)
        if multi:
            self.detect_multi_batch(np.zeros((batch, *self._frame), np.uint8),
                                    instances=instances)

    def run(self, gray: np.ndarray):
        """Engine protocol: one image -> ((C, S'*S') u8, conv_ms, read_ms)."""
        x, _ = self._to_device(gray)
        t0 = time.perf_counter()
        feats = self.features_device(x)
        self._sync()
        conv_ms = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        host = feats[0].cpu().numpy()
        read_ms = (time.perf_counter() - t1) * 1e3
        return host, conv_ms, read_ms

    def run_batch(self, images: np.ndarray) -> np.ndarray:
        """(B, S, S) u8 -> (B, C, S'*S') u8 features."""
        x, _ = self._to_device(images)
        return self._fetch(self._to_host_async((self.features_device(x),)))[0]

    def run_batch_pooled(self, images: np.ndarray) -> np.ndarray:
        """(B, S, S) u8 -> (B, C*16) f32 bin-pooled features: on "mega"
        from the kernel's fused bins (the feature map is never written),
        else ``bin_pool`` of the features."""
        x, _ = self._to_device(images)
        if self._backend == "mega":
            out = self._mega(x, with_feats=False, with_bins=True)
        else:
            out = (detect_head.bin_pool(self.features_device(x)),)
        return self._fetch(self._to_host_async(out))[0]

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
        return self._to_host_async(self.detect_multi_device(x, instances))

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
