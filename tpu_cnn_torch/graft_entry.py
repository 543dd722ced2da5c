"""The repo's own entry points without JAX: the port of ``__graft_entry__.py``
(``entry``, ``:8-40``, and its ``__main__``, ``:388-402``).

    python -m tpu_cnn_torch.graft_entry    # on the card

:func:`entry` is the single-chip check: the production fused detect with
the shipped lyr3-std bundle, on the path the bench measures
(``bench.production_path``: ``CUDAEngine(backend="mega")``'s device path,
the megakernel then the plain-torch head), and the 8 example frames of
``__graft_entry__.entry``. :func:`main` runs it on the card and prints the
output shapes, then the mesh's dry runs (``parallel.dryrun``, the port of
``__graft_entry__.dryrun_multichip``) on 8 positions of ``cuda:0``, where
the JAX module uses 8 virtual CPU devices: one card proves the meshed
paths' semantics, not their scaling.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from tpu_cnn_torch import bench
from tpu_cnn_torch.apps.common import load_model
from tpu_cnn_torch.engine.cuda import CUDAEngine
from tpu_cnn_torch.parallel.dryrun import dryrun_mesh, dryrun_train
from tpu_cnn_torch.utils.paths import default_artifacts

N_DEVICES = 8  # the dry runs' positions, as __graft_entry__'s


def entry(device: torch.device | str = "cuda"):
    """(fn, (images,)): ``fn`` maps (B, 128, 128) u8 images on ``device``
    to (pred, conf, probs, bbox) on the device through the bench's
    production path; ``images`` are ``__graft_entry__.entry``'s 8 frames
    (``RandomState(0)``), on ``device``."""
    engine = CUDAEngine(load_model(default_artifacts()), device, backend="mega")
    path = bench.production_path(engine)

    def fn(images: torch.Tensor):
        return path(images)[2:]

    rs = np.random.RandomState(0)
    images = torch.from_numpy(
        rs.randint(0, 256, size=(8, 128, 128)).astype(np.uint8)).to(engine.device)
    return fn, (images,)


def main(device: torch.device | str = "cuda:0") -> int:
    """``__graft_entry__.py``'s ``__main__`` on ``device`` (the card
    unless a caller asks for the CPU): :func:`entry`'s output shapes,
    then ``dryrun_mesh`` and ``dryrun_train`` on ``N_DEVICES`` positions
    of it. Exits 1 with no CUDA device when asked for one."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("graft_entry: torch finds no CUDA device", file=sys.stderr)
        return 1
    fn, args = entry(device)
    print("entry:", tuple(tuple(t.shape) for t in fn(*args)))
    positions = [device] * N_DEVICES
    for name, shape in dryrun_mesh(N_DEVICES, positions).items():
        print(f"  {name}: ok on mesh {shape}")
    for name, line in dryrun_train(N_DEVICES, positions).items():
        print(f"  {name}: ok on mesh {line}")
    print(f"dryrun_mesh({N_DEVICES}), dryrun_train({N_DEVICES}) on {device}: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
