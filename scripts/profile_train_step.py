"""Where the PyTorch port's train step spends the card's time: a
torch.profiler table (device time by op) of lyr3-std phase-1 steps at
batch 1024, f32 and bf16, with the card's name and power limit.

    python scripts/profile_train_step.py [--steps 5] [--rows 14]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None):
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_cnn_torch.train import train_cnn as T

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--rows", type=int, default=14)
    p.add_argument("--batch", type=int, default=1024)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_train_step: torch finds no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    cfg = T.TrainConfig(batch_size=args.batch)
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.rand(args.batch, 128, 128).astype(np.float32), device="cuda")
    y = torch.as_tensor(rs.randint(0, cfg.num_classes, args.batch), device="cuda")
    for dtype in ("float32", "bfloat16"):
        net = T.init_params(cfg, torch.Generator().manual_seed(0)).to("cuda")
        opt = T.AdamCosine(cfg.lr, 100)
        state = opt.init(net.params())
        step = T.make_train_step(cfg, opt, compute_dtype=dtype)
        for _ in range(3):
            step(net, state, x, y)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.steps):
                step(net, state, x, y)
            torch.cuda.synchronize()
        events = prof.key_averages()
        # the device's own rows (kernels, copies): an op's row repeats them
        total = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"== {dtype}, batch {args.batch}: {total / args.steps:.2f} ms of "
              f"device time per step ({args.steps} steps)")
        print(events.table(sort_by="self_cuda_time_total", row_limit=args.rows))


if __name__ == "__main__":
    main()
