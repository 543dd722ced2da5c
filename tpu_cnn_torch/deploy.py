"""The deployable's loader: ``DeployedDetector`` on a ``.tcnnx`` container
that ``apps.export_model`` wrote.

The container is the JAX package's zip: ``manifest.json`` with the JAX
manifest's keys (classes, default shifts, batch buckets, the multi
program's flags, the calibrated floors and the instance emission policy)
plus ``"runtime": "torch.export"`` and ``torch_version`` in place of
``jax_version``, and one ``torch.export``ed program per platform and batch
bucket, ``<platform>/detect_b<b>.pt2`` (and ``detect_multi_b<b>.pt2`` with
``--multi``): static shapes, the weights as constants, the (L,) int32
shifts a runtime argument.

One difference from the JAX container: StableHLO embeds the Mosaic
kernels, while a ``torch.export`` program calls the port's kernels as the
custom ops ``tcnn::mega_cnn`` and ``tcnn::conv_pool_layer``
(``ops.library``). So a ``mega`` container carries the built kernel
libraries (``kernel_libraries`` in the manifest), which the loader copies
into the build cache before the programs load
(:func:`install_kernel_libraries`): the serving host needs
``tpu_cnn_torch.ops`` but no CUDA toolkit, nor the code that builds the
model (this module imports no ``models``, ``engine`` or ``apps``
module). A library whose digest is not what ``ops._build`` computes for
the ``csrc/`` beside this module is left out, and that kernel is built
from ``csrc/`` at first use as before; so is every kernel of a container
written before the key existed.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import zipfile

import numpy as np
import torch

from tpu_cnn_torch.head.detections import (DEFAULT_MULTI_THRESH,
                                           detections_above,
                                           instance_detections)
from tpu_cnn_torch.ops import _build
from tpu_cnn_torch.ops import library  # noqa: F401  (registers tcnn::*)
from tpu_cnn_torch.ops.quant import check_shifts

MANIFEST = "manifest.json"
FORMAT_VERSION = 2  # one program per batch bucket, as the JAX format 2
RUNTIME = "torch.export"


def program_name(platform: str, batch: int, multi: bool = False) -> str:
    """The container's member for one platform's program at one bucket."""
    return f"{platform}/detect{'_multi' if multi else ''}_b{batch}.pt2"


def install_kernel_libraries(z: zipfile.ZipFile, manifest: dict) -> list[str]:
    """Copy each kernel library the manifest lists into the build cache,
    where the cache lacks it and its arch and source digest are what
    ``ops._build`` would build from the ``csrc/`` here. Returns the names
    copied."""
    copied = []
    for entry in manifest.get("kernel_libraries", []):
        if (entry["arch"] != _build.ARCH
                or entry["digest"] != _build.kernel_digest(entry["name"])):
            continue
        dst = _build.kernel_library(entry["name"])
        if os.path.exists(dst):
            continue
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(dst))
        with os.fdopen(fd, "wb") as f:
            f.write(z.read(entry["file"]))
        os.replace(tmp, dst)  # atomic: a concurrent loader sees all or none
        copied.append(entry["name"])
    return copied


class DeployedDetector:
    """A loaded .tcnnx deployable: ``detect(images[, shifts])`` on
    ``device``. Pads or chunks any batch to the smallest exported bucket
    that fits (each program has one static batch shape)."""

    def __init__(self, blob: bytes, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            self.manifest = m = json.loads(z.read(MANIFEST))
            if m.get("runtime") != RUNTIME:
                raise ValueError(
                    "this .tcnnx holds no torch.export programs (its manifest "
                    f"has runtime {m.get('runtime')!r}; a container without "
                    "that key holds the JAX package's StableHLO programs, "
                    "which tpu_cnn.apps.export_model loads): re-export it "
                    "with tpu_cnn_torch.apps.export_model")
            if m.get("format") != FORMAT_VERSION:
                raise ValueError(f"unsupported .tcnnx format {m.get('format')}")
            platform = self.device.type
            if platform not in m["platforms"]:
                raise ValueError(
                    f"this .tcnnx was exported for {m['platforms']}, not "
                    f"{platform}: re-export with --platforms {platform}")
            if platform == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError("device 'cuda' but torch finds no CUDA "
                                       "device: the cuda programs hold CUDA "
                                       "constants")
                if torch.backends.cuda.matmul.allow_tf32:
                    raise RuntimeError(
                        "torch.backends.cuda.matmul.allow_tf32 is on: the "
                        "exported head's f32 matmuls would run in TF32 and "
                        "drift from the reference; switch it off")
            self.installed = install_kernel_libraries(z, m)
            self._calls = self._programs(z, platform, False)
            self._multi_calls = (self._programs(z, platform, True)
                                 if m.get("multi") else {})

    def _programs(self, z: zipfile.ZipFile, platform: str, multi: bool) -> dict:
        calls = {}
        for b in self.manifest["batches"]:
            ep = torch.export.load(io.BytesIO(z.read(program_name(platform, b,
                                                                  multi))))
            calls[b] = ep.module()
        return calls

    @classmethod
    def load(cls, path: str,
             device: str | torch.device = "cuda") -> "DeployedDetector":
        with open(path, "rb") as f:
            return cls(f.read(), device)

    def _run_chunked(self, calls: dict, images: np.ndarray, shifts):
        images = np.asarray(images, np.uint8)
        if shifts is None:
            shifts = self.manifest["default_shifts"]
        check_shifts(shifts)
        sj = torch.tensor(shifts, dtype=torch.int32, device=self.device)
        buckets = sorted(calls)
        outs = []
        c0 = 0
        with torch.no_grad():
            while c0 < len(images):
                remaining = len(images) - c0
                # smallest bucket that fits the remainder; largest for chunking
                eb = next((b for b in buckets if b >= remaining), buckets[-1])
                chunk = images[c0:c0 + eb]
                b = len(chunk)
                if b < eb:
                    chunk = np.concatenate(
                        [chunk, np.zeros((eb - b, *chunk.shape[1:]), np.uint8)])
                res = calls[eb](torch.from_numpy(chunk).to(self.device), sj)
                outs.append([r[:b].cpu().numpy() for r in res])
                c0 += b
        return tuple(np.concatenate([o[i] for o in outs])
                     for i in range(len(outs[0])))

    def detect(self, images: np.ndarray, shifts=None):
        """(B, S, S) u8 -> (pred, conf, probs, bbox) numpy arrays."""
        return self._run_chunked(self._calls, images, shifts)

    def detect_multi(self, images: np.ndarray, shifts=None):
        """(B, S, S) u8 -> (pred, conf, probs, boxes (B, K, 4)) — only in
        containers exported with --multi (``manifest["multi"]``). When the
        container was exported with --instances N, two extra arrays
        (inst_boxes (B, K, N, 4), inst_counts (B, K, N)) follow; when the
        bundle shipped a multi-label presence head, its scores ride as
        the LAST array (``manifest["multi_head"]``)."""
        if not self._multi_calls:
            raise ValueError(
                "this .tcnnx has no multi-object program — re-export with "
                "apps.export_model --multi")
        return self._run_chunked(self._multi_calls, images, shifts)

    def detections(self, images: np.ndarray, shifts=None, threshold=None):
        """Filtered per-image detections [(class_idx, score, (x1, y1, x2,
        y2)), ...] — the deployment twin of
        ``MultiDetectResult.detections``. The calibrated floors, presence
        score space and instance emission policy all travel in the
        manifest, so a serving host without the artifact bundle reproduces
        the live engine's filtered output."""
        m = self.manifest
        out = self.detect_multi(images, shifts)
        scores = None
        if m.get("multi_head"):
            scores, out = out[-1], out[:-1]
        pred, conf, probs, boxes = out[:4]
        inst = out[4:] if len(out) > 4 else None
        sc = scores if scores is not None else probs
        if threshold is None:
            threshold = (m["multi_thresh"] if m.get("multi_thresh")
                         is not None else DEFAULT_MULTI_THRESH)
        if inst is not None and m.get("instances", 1) > 1:
            return [
                instance_detections(
                    sc[i], boxes[i], inst[0][i], inst[1][i], threshold,
                    min_pixels=m.get("instance_min_pixels"),
                    min_frac=m.get("instance_min_frac"))
                for i in range(len(sc))
            ]
        return [detections_above(sc[i], boxes[i], threshold)
                for i in range(len(sc))]
