"""Deployable export and load on the port: the fused detect program as one
``.tcnnx`` file.

The port of ``tpu_cnn.apps.export_model``. The reference ships its
datapath as a compiled artifact that a loader programs at run time; the
JAX package exports its fused detect as StableHLO; the port exports it
with ``torch.export``: the chained plan (``tcnn::conv_pool_layer`` for the
``mega_plan`` head layers, then ``tcnn::mega_cnn``, the custom ops of
``ops.library``) or the plain contract (``xla``), then the plain-torch
head, the weights folded in as constants and the per-layer shifts left a
runtime (L,) int32 argument: the register semantics survive export. The
instance head's label loops export as ``while_loop``
(``ops.detect_head._to_fixed_point``).

The container (``tpu_cnn_torch.deploy``, where ``DeployedDetector``
lives) is the JAX package's zip and manifest, plus ``"runtime":
"torch.export"`` and ``torch_version`` in place of ``jax_version``, with
one program per platform and batch bucket, ``<platform>/detect_b<b>.pt2``.
StableHLO embeds the Mosaic kernels; a ``torch.export`` program calls
the port's kernels through their custom ops, so a ``mega`` container also
carries the built ``sm_90a`` libraries of the kernels its programs call,
under ``kernels/sm_90a/``, listed in the manifest's ``kernel_libraries``
(name, member, source digest, arch). The loader puts them in the build
cache, so that the serving host needs ``tpu_cnn_torch.ops`` but no CUDA
toolkit, nor the code that builds the model. ``mega`` exports for ``cuda`` only (the JAX
package's "the megakernel lowers for TPU only"); ``xla`` exports for
``cpu`` too.

Usage:
  python -m tpu_cnn_torch.apps.export_model --output model.tcnnx --batch 8,1536
  python -m tpu_cnn_torch.apps.export_model --output m.tcnnx --backend xla \\
      --platforms cuda,cpu
  python -m tpu_cnn_torch.apps.export_model --load model.tcnnx [--image x.bin ...]
  python -m tpu_cnn_torch.apps.export_model --load m.tcnnx --device cpu
"""

from __future__ import annotations

import argparse
import io
import json
import os
import zipfile

import numpy as np
import torch
from torch import nn

from tpu_cnn_torch.apps.common import add_variant_arg, load_model
from tpu_cnn_torch.deploy import (FORMAT_VERSION, MANIFEST, RUNTIME,
                                  DeployedDetector, program_name)
from tpu_cnn_torch.models.cnn import params_from_numpy
from tpu_cnn_torch.ops import _build, detect_head, library, mega, quant  # noqa: F401
from tpu_cnn_torch.utils.paths import default_artifacts

__all__ = ["DeployedDetector", "build_detect_fn", "build_detect_multi_fn",
           "export_bundle", "main"]


class DetectProgram(nn.Module):
    """The fused detect as a module for ``torch.export``: (images (B, S, S)
    u8, shifts (L,) int32) -> (pred, conf, probs, bbox), or with ``multi``
    the multi-object head's outputs (``CUDAEngine``'s
    ``detect_device`` and ``detect_multi_device``, op for op, on the
    custom ops for ``mega``). The weights, and for ``mega`` their
    ``pack_plan``, are buffers on ``device``."""

    def __init__(self, model, backend: str, box_mode: str, device,
                 multi: bool = False, instances: int = 1):
        super().__init__()
        if backend not in ("mega", "xla"):
            raise ValueError(f"backend must be 'mega' or 'xla', got {backend!r}")
        if box_mode == "reg" and model.bbox_weight is None:
            raise ValueError("box_mode 'reg' needs the bundle's bbox_weight")
        self.backend = backend
        self.box_mode = box_mode
        self.multi = multi
        self.instances = instances
        self.head_mode = model.head_mode
        self.img_size = model.config.img_size
        params = params_from_numpy(model.kernels, model.fc_weight,
                                   model.fc_bias, model.shifts,
                                   model.bbox_weight, model.multi_head,
                                   device=device)
        self.n_layers = len(params["kernels"])
        for i, k in enumerate(params["kernels"]):
            self.register_buffer(f"kernel{i}", k)
        for name in ("fc_weight", "fc_bias", "bbox_weight", "mw", "mb"):
            self.register_buffer(name, params[name])
        self.n_head = 0
        if backend == "mega":
            cfgs = model.config.layer_configs
            self.n_head = mega.mega_plan(cfgs)
            if self.n_head is None:
                raise ValueError(f"no tail of {cfgs} fits the megakernel")
            for i, p in enumerate(mega.pack_plan(params["kernels"],
                                                 self.img_size)):
                self.register_buffer(f"packed{i}", p)

    def _kernels(self) -> list[torch.Tensor]:
        return [getattr(self, f"kernel{i}") for i in range(self.n_layers)]

    def _mega(self, images, shifts, feats=False, bins=False, twin=False):
        """The chained plan on the custom ops: the head layers on
        ``tcnn::conv_pool_layer``, the tail on ``tcnn::mega_cnn``."""
        ks = self._kernels()
        pk = [getattr(self, f"packed{i}") for i in range(self.n_layers)]
        n = self.n_head
        x = images[:, None] if n else images
        for i in range(n):
            x = torch.ops.tcnn.conv_pool_layer(x, ks[i], pk[i], shifts, i)
        return torch.ops.tcnn.mega_cnn(x, ks[n:], pk[n:], shifts[n:], feats,
                                       bins, twin)

    def _features(self, images, shifts):
        if self.backend == "mega":
            return self._mega(images, shifts, feats=True)[0]
        return quant.cnn_forward(images, self._kernels(), shifts)

    def forward(self, images: torch.Tensor, shifts: torch.Tensor):
        if self.multi:
            return self._detect_multi(images, shifts)
        fcw, fcb, img = self.fc_weight, self.fc_bias, self.img_size
        if self.backend == "mega" and self.head_mode == "bins":
            with_twin = self.box_mode != "reg"
            outs = self._mega(images, shifts, bins=True, twin=with_twin)
            return detect_head.detect_with_pooled(
                None, outs[0], fcw, fcb, img,
                features_twin=outs[1] if with_twin else None,
                box_mode=self.box_mode, bbox_weight=self.bbox_weight)
        if self.backend == "mega":  # the GAP head pools the u8 features
            feats = self._mega(images, shifts, feats=True, bins=True)[0]
        else:
            feats = self._features(images, shifts)
        return detect_head.detect(feats, fcw, fcb, self.head_mode, img,
                                  box_mode=self.box_mode,
                                  bbox_weight=self.bbox_weight)

    def _detect_multi(self, images, shifts):
        box_mode = "centroid" if self.box_mode == "centroid" else "ref"
        mh = (self.mw, self.mb) if self.mw is not None else None
        if self.backend == "mega" and self.head_mode == "bins":
            pooled, twin = self._mega(images, shifts, bins=True, twin=True)
            return detect_head.detect_multi_with_pooled(
                pooled, twin, self.fc_weight, self.fc_bias, self.img_size,
                box_mode=box_mode, instances=self.instances, multi_head=mh)
        return detect_head.detect_multi(
            self._features(images, shifts), self.fc_weight, self.fc_bias,
            self.head_mode, self.img_size, box_mode=box_mode,
            instances=self.instances, multi_head=mh)


def build_detect_fn(model, backend: str, box_mode: str,
                    device="cuda") -> DetectProgram:
    """The fused detect (images, shifts) -> (pred, conf, probs, bbox) with
    the weights on ``device``: ``mega`` (the chained plan on the custom
    ops) or ``xla`` (the plain contract)."""
    return DetectProgram(model, backend, box_mode, device)


def build_detect_multi_fn(model, backend: str, box_mode: str,
                          instances: int = 1, device="cuda") -> DetectProgram:
    """The multi-object head (images, shifts) -> (pred, conf, probs, boxes
    (B, K, 4)), the exportable twin of ``CUDAEngine.detect_multi_batch``
    ('reg' engines export the 'ref' CAM profile). ``instances > 1`` bakes
    the watershed instance head in (two more outputs); a bundle with
    ``multi_head.npz`` bakes the presence head in (its scores LAST)."""
    return DetectProgram(model, backend, box_mode, device, multi=True,
                         instances=instances)


def _export(program: DetectProgram, batch: int, device) -> bytes:
    s = program.img_size
    args = (torch.zeros((batch, s, s), dtype=torch.uint8, device=device),
            torch.zeros((program.n_layers,), dtype=torch.int32, device=device))
    buf = io.BytesIO()
    torch.export.save(torch.export.export(program, args, strict=False), buf)
    return buf.getvalue()


def kernel_names(model, backend: str) -> list[str]:
    """The kernels an exported program calls: on ``mega`` the layer kernel
    for the chained plan's head layers, if any, then the megakernel."""
    if backend != "mega":
        return []
    n_head = mega.mega_plan(model.config.layer_configs)
    return (["conv_pool_layer"] if n_head else []) + ["mega_cnn"]


def kernel_libraries(names) -> list[tuple[dict, bytes]]:
    """(manifest entry, library bytes) of each kernel, built here if the
    cache lacks it: the entry names the kernel, its member in the
    container, its ``_build.kernel_digest`` and the arch."""
    out = []
    for name in names:
        path = _build.build(name)[0]
        with open(path, "rb") as f:
            blob = f.read()
        out.append(({"name": name, "digest": _build.kernel_digest(name),
                     "arch": _build.ARCH,
                     "file": f"kernels/{_build.ARCH}/{os.path.basename(path)}"},
                    blob))
    return out


def export_bundle(model, batch=1536, backend: str = "mega",
                  box_mode: str = "ref", platforms=("cuda",),
                  multi: bool = False, instances: int = 1) -> bytes:
    """Export the fused detect program for ``platforms`` (``cuda``,
    ``cpu``). ``batch`` may be an int or a sequence of bucket sizes: each
    bucket is its own program, and the loader picks the smallest bucket
    that fits a request. Returns the .tcnnx container bytes."""
    platforms = tuple(platforms)
    if backend == "mega" and any(p != "cuda" for p in platforms):
        raise ValueError("the megakernel exports for CUDA only; use --backend "
                         f"xla for platforms {platforms}")
    if any(p not in ("cuda", "cpu") for p in platforms):
        raise ValueError(f"platforms must be cuda and/or cpu, got {platforms}")
    if "cuda" in platforms and not torch.cuda.is_available():
        raise RuntimeError("platform 'cuda' but torch finds no CUDA device")
    batches = sorted({int(b) for b in
                      (batch if hasattr(batch, "__iter__") else [batch])})
    programs = {}
    for platform in platforms:
        progs = {False: build_detect_fn(model, backend, box_mode, platform)}
        if multi:
            progs[True] = build_detect_multi_fn(model, backend, box_mode,
                                                instances, platform)
        for is_multi, prog in progs.items():
            for b in batches:
                programs[program_name(platform, b, is_multi)] = _export(
                    prog, b, platform)
    libraries = kernel_libraries(kernel_names(model, backend))
    manifest = {
        "format": FORMAT_VERSION,
        "runtime": RUNTIME,
        "platforms": list(platforms),
        "backend": backend,
        "box_mode": box_mode,
        "batches": batches,
        "img_size": model.config.img_size,
        "n_layers": len(model.kernels),
        "classes": list(model.class_names),
        "default_shifts": [int(v) for v in model.shifts],
        "multi": bool(multi),
        "instances": int(instances) if multi else 1,
        "multi_thresh": ([float(t) for t in model.multi_thresh]
                         if model.multi_thresh is not None else None),
        # whether the multi program's LAST output is the presence scores
        # (the space multi_thresh is calibrated in)
        "multi_head": bool(multi and model.multi_head is not None),
        # the instance emission policy's floors, so that the deployable
        # reproduces the live engine's filtered detections without the
        # bundle on the serving host
        "instance_min_pixels": detect_head.INSTANCE_MIN_PIXELS,
        "instance_min_frac": detect_head.INSTANCE_MIN_FRAC,
        "torch_version": torch.__version__,
        # the built kernels the programs call, for a host without nvcc
        "kernel_libraries": [entry for entry, _ in libraries],
    }
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(MANIFEST, json.dumps(manifest, indent=1))
        for name, blob in programs.items():
            z.writestr(name, blob)
        for entry, blob in libraries:
            z.writestr(entry["file"], blob)
    return buf.getvalue()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export/load the fused detect program as a deployable")
    p.add_argument("--artifacts", default=None)
    p.add_argument("--head-prefix", default="")
    p.add_argument("--output", default=None, help="write a .tcnnx deployable")
    p.add_argument("--load", default=None, help="load + smoke-run a .tcnnx")
    p.add_argument("--image", action="append", default=[],
                   help="with --load: run these images (.bin/.png/...)")
    p.add_argument("--batch", default="8,1536",
                   help="comma list of batch buckets, one program each; the "
                        "loader picks the smallest bucket that fits a request")
    p.add_argument("--backend", default="mega", choices=["mega", "xla"])
    p.add_argument("--box", default="ref", choices=["ref", "centroid", "reg"])
    p.add_argument("--multi", action="store_true",
                   help="also export the multi-object program (one CAM box "
                        "per class; DeployedDetector.detect_multi / "
                        "serve --deployable --multi)")
    p.add_argument("--instances", type=int, default=1,
                   help="with --multi: bake the watershed instance head "
                        "into the multi program (up to N component boxes "
                        "per class)")
    p.add_argument("--platforms", default="cuda",
                   help="comma list (cuda[,cpu]; mega is cuda-only)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="with --load: the device to run the programs on")
    add_variant_arg(p)
    args = p.parse_args(argv)

    if args.load:
        det = DeployedDetector.load(args.load, args.device)
        m = det.manifest
        print(f"  {args.load}: format {m['format']} ({m['runtime']})"
              + (" +multi" if m.get("multi") else "") + f", platforms "
              f"{m['platforms']}, backend {m['backend']}, "
              f"batch buckets {m['batches']}, "
              f"{m['img_size']}x{m['img_size']}, classes {m['classes']}, "
              f"shifts {m['default_shifts']} (runtime-overridable)")
        if args.image:
            from tpu_cnn_torch.utils.artifacts import load_image_any

            imgs = np.stack([
                load_image_any(pth, m["img_size"]).reshape(m["img_size"],
                                                           m["img_size"])
                for pth in args.image])
            pred, conf, probs, bbox = det.detect(imgs)
            for i, pth in enumerate(args.image):
                print(f"  {os.path.basename(pth)}: "
                      f"{m['classes'][int(pred[i])]} "
                      f"({conf[i] * 100:.1f}%)  box {bbox[i].tolist()}")
        return 0

    if not args.output:
        p.error("need --output (export) or --load (inspect/run)")
    args.artifacts = args.artifacts or default_artifacts(args.variant)
    model = load_model(args.artifacts, args.variant, args.head_prefix)
    platforms = tuple(s.strip() for s in args.platforms.split(","))
    batches = [int(v) for v in str(args.batch).split(",")]
    if args.instances > 1 and not args.multi:
        p.error("--instances needs --multi")
    blob = export_bundle(model, batches, args.backend, args.box, platforms,
                         multi=args.multi, instances=args.instances)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"  exported {args.output}: {len(blob):,} bytes "
          f"({args.backend} backend, batch {args.batch}, platforms "
          f"{list(platforms)}) — run with --load on a "
          f"{'/'.join(platforms)} host")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
