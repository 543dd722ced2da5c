"""The mesh's serving dry run — the port of the inference checks of
``__graft_entry__.dryrun_multichip``.

On an ``n_devices`` mesh (``devices``: a list that may repeat one device,
default every CUDA device), with the shipped lyr3-std bundle, each meshed
path must reproduce the single-device path on the first device: the
``xla`` fused detect over the (data, model) mesh; the megakernel's fused
detect (predictions and boxes equal, probabilities within 1e-4); the
multi-object head with the shipped presence head (every class's box, the
argmax row against the single-box boxes, the scores); the instance head
(boxes and counts equal); the GPipe pipeline and the row-sharded spatial
forward (bit-equal to the sequential contract). Any divergence raises
``AssertionError``.

    python -m tpu_cnn_torch.parallel.dryrun --devices 4           # one card, 4 positions
    python -m tpu_cnn_torch.parallel.dryrun --devices 8 --cpu     # 8 CPU positions
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_cnn_torch.models.cnn import DEFAULT_SHIFTS
from tpu_cnn_torch.ops import detect_head, mega, quant
from tpu_cnn_torch.parallel.mesh import (make_mesh, sharded_detect,
                                         sharded_detect_mega,
                                         sharded_detect_multi_mega,
                                         take_devices, to_host)
from tpu_cnn_torch.parallel.pipeline import make_pipeline_mesh, pipelined_forward
from tpu_cnn_torch.parallel.spatial import (check_spatial_split,
                                            make_spatial_mesh, spatial_forward)
from tpu_cnn_torch.utils import artifacts as art
from tpu_cnn_torch.utils.paths import default_artifacts

SCORE_TOL = 1e-4  # probabilities and presence scores: 1024-term f32 dots


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def dryrun_mesh(n_devices: int, devices=None, seed: int = 0) -> dict:
    """Run the checks (module docstring); returns what was checked, by
    name, with the mesh shapes used."""
    devices = take_devices(n_devices, devices)
    dev0 = devices[0]
    rs = np.random.RandomState(seed)
    bundle = art.load_bundle(default_artifacts())
    kernels = [np.asarray(k, np.int8) for k in bundle.kernels]
    fc_w, fc_b, mh = bundle.fc_weight, bundle.fc_bias, bundle.multi_head
    shifts = (bundle.shifts if bundle.shifts is not None
              else np.asarray(DEFAULT_SHIFTS, np.int32))
    done = {}

    model_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, model_axis=model_axis, devices=devices)
    detect = sharded_detect(mesh, kernels, fc_w, fc_b, "bins", 128)
    imgs = rs.randint(0, 256, size=(2 * n_devices, 128, 128)).astype(np.uint8)
    pred, conf, probs, bbox = to_host(detect(imgs, shifts))
    _require(pred.shape == (2 * n_devices,) and bbox.shape == (2 * n_devices, 4)
             and np.all((conf > 0) & (conf <= 1)), "meshed xla detect shapes")
    done["xla detect"] = mesh.devices.shape

    # the megakernel under the mesh against the single-device path
    imgs = rs.randint(0, 256, size=(4 * n_devices, 128, 128)).astype(np.uint8)
    x1 = torch.from_numpy(imgs).to(dev0)
    k1 = [torch.from_numpy(k).to(dev0) for k in kernels]
    s1 = torch.from_numpy(np.asarray(shifts, np.int32)).to(dev0)
    w1, b1 = torch.from_numpy(fc_w).to(dev0), torch.from_numpy(fc_b).to(dev0)
    pooled1, twin1 = mega.cnn_forward_mega(x1, k1, s1, with_feats=False,
                                           with_bins=True, with_twin=True)
    single = [t.cpu().numpy() for t in detect_head.detect_with_pooled(
        None, pooled1, w1, b1, 128, features_twin=twin1)]
    got = to_host(sharded_detect_mega(mesh, kernels, fc_w, fc_b, "bins",
                                      128)(imgs, shifts))
    _require(np.array_equal(got[0], single[0]),
             "meshed megakernel predictions diverge from the single device")
    _require(np.array_equal(got[3], single[3]),
             "meshed megakernel boxes diverge from the single device")
    _require(np.allclose(got[2], single[2], rtol=0, atol=SCORE_TOL),
             "meshed megakernel probabilities diverge from the single device")
    done["mega detect"] = mesh.devices.shape

    # the multi-object head with the shipped presence head, and instances
    mh1 = None if mh is None else tuple(torch.from_numpy(a).to(dev0)
                                        for a in mh)
    for instances in (1, 2):
        want = [t.cpu().numpy() for t in detect_head.detect_multi_with_pooled(
            pooled1, twin1, w1, b1, 128, instances=instances, multi_head=mh1)]
        got = to_host(sharded_detect_multi_mega(
            mesh, kernels, fc_w, fc_b, "bins", 128, instances=instances,
            multi_head=mh)(imgs, shifts))
        _require(len(got) == len(want), "meshed multi head: output count")
        _require(np.array_equal(got[3], want[3]),
                 f"meshed multi-object boxes diverge (instances {instances})")
        _require(np.array_equal(got[3][np.arange(len(imgs)), got[0]],
                                single[3]),
                 "the multi head's argmax-class box diverges from the "
                 "single-box path")
        if instances > 1:
            _require(np.array_equal(got[4], want[4])
                     and np.array_equal(got[5], want[5]),
                     "meshed instance boxes/counts diverge from the single "
                     "device")
        if mh is not None:
            _require(np.allclose(got[-1], want[-1], rtol=0, atol=SCORE_TOL),
                     "meshed presence scores diverge from the single device")
        done[f"multi detect, instances {instances}"] = mesh.devices.shape

    # pipeline and spatial: bit-equal to the sequential contract
    seq = quant.cnn_forward(x1, k1, s1).cpu().numpy()
    n_stages = min(len(kernels), n_devices)
    pipe_mesh = make_pipeline_mesh(n_stages, devices=devices)
    pp = pipelined_forward(pipe_mesh, kernels, microbatch=2)(x1, shifts)
    _require(np.array_equal(pp.cpu().numpy(), seq),
             "pipelined forward diverges from the sequential layer chain")
    done["pipeline"] = pipe_mesh.devices.shape
    n_space = n_devices
    while n_space > 1:
        try:
            check_spatial_split(imgs.shape[1], len(kernels), n_space)
            break
        except ValueError:
            n_space //= 2
    sp_mesh = make_spatial_mesh(n_space, devices=devices)
    sp = spatial_forward(sp_mesh, kernels)(x1, shifts)
    _require(np.array_equal(sp.cpu().numpy(), seq),
             "row-sharded spatial forward diverges from the sequential "
             "layer chain")
    done["spatial"] = sp_mesh.devices.shape
    return done


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--devices", type=int, default=4,
                   help="mesh positions (repeating one device if needed)")
    p.add_argument("--cpu", action="store_true",
                   help="positions on the CPU (the kernels' plain versions)")
    args = p.parse_args(argv)
    if args.cpu:
        base = [torch.device("cpu")]
    else:
        base = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
        if not base:
            p.error("torch finds no CUDA device (use --cpu)")
    devices = [base[i % len(base)] for i in range(args.devices)]
    for name, shape in dryrun_mesh(args.devices, devices).items():
        print(f"  {name}: ok on mesh {shape}")
    print("dryrun_mesh: every meshed path equals the single-device path")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
