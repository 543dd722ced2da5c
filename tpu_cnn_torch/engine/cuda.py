"""CUDAEngine — batched fused detection on one CUDA device.

Port of ``tpu_cnn.engine.tpu.TPUEngine``: the single-box detect and the
multi-object / instance detect (``detect_multi_batch``), with its backends
under their names, so that the apps' ``--mode`` flag carries over:

  - ``"mega"`` (the default): the net on the chained plan
    (``ops.mega.cnn_forward_mega``: the ``mega_plan`` head layers one
    kernel each, then the megakernel with its fused bin pooling and bf16
    feature twin), then the plain-torch head (``ops.detect_head``);
  - ``"pallas"``: every layer on the conv kernel ``ops.int8.conv_act``
    (``cnn_forward_pallas``), then ``detect_head.detect`` on the features;
  - ``"hybrid"``: layer 0 on that kernel, the deeper layers plain
    (``cnn_forward_hybrid``), then ``detect``;
  - ``"xla"``: the plain contract ``ops.quant.cnn_forward`` (f32 or int32,
    ``compute_dtype``), then ``detect``. It launches no kernel.

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
from tpu_cnn_torch.ops import detect_head, int8, mega, quant
from tpu_cnn_torch.utils.failguard import wait_event


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


class CUDAEngine:
    """Batched inference for the FpgaCNN contract on ``device``.

    ``backend``: one of ``BACKENDS`` (module docstring); ``compute_dtype``
    ("float32" or "int32") applies to "xla". ``box_mode``: "ref" (reference
    CAM threshold box), "centroid" (CAM mass-centroid box) or "reg" (learned
    regression on the pooled bins; needs the bundle's bbox_weight; the
    multi head falls back to "ref"). The multi head's device->host copy
    carries u8 boxes and int16 counts whenever the image size is at most
    256 (``compact_multi``). The model's shifts must lie in 0..31."""

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
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("device='cuda' but torch finds no CUDA "
                                   "device")
            if torch.backends.cuda.matmul.allow_tf32:
                raise RuntimeError(
                    "torch.backends.cuda.matmul.allow_tf32 is on: the head's "
                    "f32 matmuls would run in TF32 and drift from the "
                    "reference; switch it off")
        elif self.device.type != "cpu":
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
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

    @property
    def mode(self) -> str:
        """The backend this engine runs, by its ``BACKENDS`` name."""
        return self._backend

    # ── device work ───────────────────────────────────────────────────

    def _to_device(self, images):
        """Raw (B, S, S) / flat u8 images or a stage_batch handle ->
        (device tensor, B)."""
        if isinstance(images, tuple) and len(images) == 3 and images[0] == "staged":
            return images[1], images[2]
        s = self.model.config.img_size
        arr = np.ascontiguousarray(images, dtype=np.uint8).reshape(-1, s, s)
        if arr.shape[0] > self.max_batch:
            raise ValueError(f"batch {arr.shape[0]} exceeds max_batch "
                             f"{self.max_batch}")
        return torch.from_numpy(arr).to(self.device), arr.shape[0]

    def _mega(self, x: torch.Tensor, **outputs) -> list[torch.Tensor]:
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
        only when asked for. GAP head: the classifier needs global means,
        so the kernel writes the u8 features and the head pools them.
        Other backends: the features, then ``detect_head.detect`` on them
        (the JAX engine's unfused branch); the bins are pooled apart only
        when the features are asked for too (the parity gate's path)."""
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
        zeros = np.zeros((batch, s, s), np.uint8)
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
        _, _, pred, conf, probs, bbox = self.detect_device(x)
        return self._to_host_async((pred, conf, probs, bbox))

    def detect_resolve(self, handle) -> DetectResult:
        return DetectResult(*self._fetch(handle))

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
