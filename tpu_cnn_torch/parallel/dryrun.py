"""The mesh's dry run — the port of ``__graft_entry__.dryrun_multichip``:
its serving checks (:func:`dryrun_mesh`) and its training checks
(:func:`dryrun_train`).

On an ``n_devices`` mesh (``devices``: a list that may repeat one device,
default every CUDA device), with the shipped lyr3-std bundle, each meshed
path must reproduce the single-device path on the first device: the
``xla`` fused detect over the (data, model) mesh; the megakernel's fused
detect (predictions and boxes equal, probabilities within 1e-4); the
multi-object head with the shipped presence head (every class's box, the
argmax row against the single-box boxes, the scores); the instance head
(boxes and counts equal); the GPipe pipeline and the row-sharded spatial
forward (bit-equal to the sequential contract). The training checks, at
lyr3-tiny (32x32, 1->16->32->64), each against the plain train step from
the same parameters and batch: the dp x tp step gives a finite loss; the
ZeRO-1 step holds every divisible Adam moment as one block per data
position and equals the plain step; the pipelined and the row-sharded
steps equal the plain step. Equal means the loss within ``LOSS_ATOL``;
every gradient within ``GRAD_RTOL`` and ``GRAD_ATOL`` times its largest
element (``tests/test_torch_train.py``'s tolerance for the port's f32
gradients against JAX's); and every updated parameter within
``STEP_ATOL`` of its device type (on the CPU JAX's dry run's 1e-6, on a
card train_parity's 1e-4: cuDNN picks its algorithm by the batch's
shape, so a data block's gradient rounds otherwise than the whole
batch's), except where the plain gradient is rounding noise (within the
gradient tolerance of zero). There Adam's first step, ``lr * g / (|g| +
1e-8)``, turns a noise of 1e-8 into a step of up to ``lr`` of either
sign, so those elements are held under two steps only (on an H100, ZeRO-1
on 4 positions moved 277 of conv2's 18,432 parameters up to 6.0e-4 from
the plain step's, each of them one whose gradient is rounding noise).
Any divergence raises ``AssertionError``.

    python -m tpu_cnn_torch.parallel.dryrun --devices 4           # one card, 4 positions
    python -m tpu_cnn_torch.parallel.dryrun --devices 8 --cpu     # 8 CPU positions
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_cnn_torch.models.cnn import DEFAULT_SHIFTS
from tpu_cnn_torch.ops import detect_head, mega, quant
from tpu_cnn_torch.parallel.mesh import (RowShards, make_mesh, sharded_detect,
                                         sharded_detect_mega,
                                         sharded_detect_multi_mega,
                                         take_devices, to_host)
from tpu_cnn_torch.parallel.pipeline import make_pipeline_mesh, pipelined_forward
from tpu_cnn_torch.parallel.spatial import (check_spatial_split,
                                            make_spatial_mesh, spatial_forward)
from tpu_cnn_torch.utils import artifacts as art
from tpu_cnn_torch.utils.paths import default_artifacts

SCORE_TOL = 1e-4  # probabilities and presence scores: 1024-term f32 dots
LOSS_ATOL = 1e-5  # a train step's loss against the plain step's
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6  # its gradients (atol x their max)
STEP_ATOL = {"cpu": 1e-6, "cuda": 1e-4}  # its updated parameters
TRAIN_LAYERS = ((1, 16, 32), (16, 32, 16), (32, 64, 8))  # lyr3-tiny


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


def _one_step(cfg, mesh, images, labels, init, **kw):
    """One train step from ``init`` (numpy parameters) on the first
    position's device: (loss, updated parameters, gradients, optimiser
    state)."""
    from tpu_cnn_torch.train import train_cnn as T

    dev = images.device
    net = T.params_from_numpy(init, device=dev)
    opt = T.AdamCosine(cfg.lr)
    state = opt.init(net.params())
    loss, _ = T.make_train_step(cfg, opt, mesh, **kw)(net, state, images, labels)
    grads = {k: p.grad.cpu().numpy() for k, p in net.params().items()}
    return float(loss), T.params_to_numpy(net), grads, state


def steps_agree(tag: str, got, want, lr: float, atol: float) -> str:
    """Raise unless step ``got`` (loss, params, grads) matches ``want``
    with parameters within ``atol`` (module docstring); returns the worst
    differences, for the report."""
    _require(abs(got[0] - want[0]) <= LOSS_ATOL,
             f"{tag}: loss {got[0]!r} against the plain step's {want[0]!r}")
    g_rel = worst = moved = 0.0
    noise = 0
    for k, w in want[1].items():
        g, g_want = got[2][k], want[2][k]
        g_max = float(np.abs(g_want).max())
        _require(np.allclose(g, g_want, rtol=GRAD_RTOL, atol=GRAD_ATOL * g_max),
                 f"{tag}: {k}'s gradient off by up to {np.abs(g - g_want).max()!r}")
        g_rel = max(g_rel, float(np.abs(g - g_want).max()) / g_max)
        diff = np.abs(got[1][k] - w)
        off = diff > atol
        rounding = np.abs(g_want) <= GRAD_ATOL * g_max
        _require(not (off & ~rounding).any() and diff.max() < 2 * lr,
                 f"{tag}: {k} off by up to {diff.max()!r} on "
                 f"{int((off & ~rounding).sum())} elements of a real gradient")
        worst = max(worst, float(diff[~rounding].max(initial=0.0)))
        moved = max(moved, float(diff[off].max(initial=0.0)))
        noise += int(off.sum())
    return (f"loss off {abs(got[0] - want[0]):.1e}, gradients within "
            f"{g_rel:.1e} of their largest, params within {worst:.1e}; "
            f"{noise} of a rounding-noise gradient moved past {atol} (up to "
            f"{moved:.1e})")


def dryrun_train(n_devices: int, devices=None, seed: int = 0) -> dict:
    """The training checks (module docstring) on ``n_devices`` positions
    of ``devices``; returns a line per check, by name."""
    from tpu_cnn_torch.train import train_cnn as T

    devices = take_devices(n_devices, devices)
    dev0 = devices[0]
    atol = STEP_ATOL[dev0.type]
    cfg = T.TrainConfig(layer_configs=TRAIN_LAYERS, batch_size=2 * n_devices)
    rs = np.random.RandomState(seed)
    init = T.params_to_numpy(T.init_params(cfg, torch.Generator().manual_seed(seed)))

    def batch(n):
        return (torch.from_numpy(rs.rand(n, 32, 32).astype(np.float32)).to(dev0),
                torch.from_numpy(rs.randint(0, cfg.num_classes, n)).to(dev0))

    done = {}
    model_axis = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_devices, model_axis=model_axis, devices=devices)
    images, labels = batch(cfg.batch_size)
    loss = _one_step(cfg, mesh, images, labels, init)[0]
    _require(np.isfinite(loss), "the dp x tp train step gave a non-finite loss")
    done["dp x tp step"] = f"{mesh.devices.shape}: loss {loss:.4f}"

    plain = _one_step(cfg, None, images, labels, init)
    mesh_dp = make_mesh(n_devices, devices=devices)
    zero1 = _one_step(cfg, mesh_dp, images, labels, init, zero1=True)
    mu = zero1[3]["mu"]["conv0"]
    _require(isinstance(mu, RowShards) and len(mu.parts) == n_devices
             and mu.parts[0].shape[0] == 16 // n_devices,
             "zero1 moments are not held as one block per data position")
    done["zero1 step"] = (f"{mesh_dp.devices.shape}: conv0's moments in "
                          f"{len(mu.parts)} blocks; "
                          + steps_agree("zero1", zero1, plain, cfg.lr, atol))

    n_stages = min(len(TRAIN_LAYERS), n_devices)
    cfg_pp = T.TrainConfig(layer_configs=TRAIN_LAYERS,
                           batch_size=4 * max(1, n_devices // n_stages))
    images, labels = batch(cfg_pp.batch_size)
    plain = _one_step(cfg_pp, None, images, labels, init)
    pipe = make_pipeline_mesh(n_stages, devices=devices)
    got = _one_step(cfg_pp, pipe, images, labels, init, microbatch=2)
    done["pipelined step"] = (f"{pipe.devices.shape}: "
                              + steps_agree("pipeline", got, plain, cfg.lr, atol))
    n_space = n_devices
    while n_space > 1:
        try:
            check_spatial_split(32, len(TRAIN_LAYERS), n_space)
            break
        except ValueError:
            n_space //= 2
    space = make_spatial_mesh(n_space, devices=devices)
    got = _one_step(cfg_pp, space, images, labels, init)
    done["row-sharded step"] = (f"{space.devices.shape}: "
                                + steps_agree("spatial", got, plain, cfg.lr, atol))
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
    for name, line in dryrun_train(args.devices, devices).items():
        print(f"  {name}: ok on mesh {line}")
    print("dryrun_train: every meshed train step equals the plain step")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
