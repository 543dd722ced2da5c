"""Where the megakernel's time goes, phase by phase, on the card.

    python scripts/mega_phases_torch.py

Run from the root of a checkout: it imports that checkout's
``tpu_cnn_torch``, so that two checkouts can be timed in turns on one card,
each on its own kernel (a kernel built without the phase clocks is timed
only).

Builds ``csrc/mega_cnn.cu`` with ``-DMEGA_CNN_PHASE_CLOCKS`` (a library of
its own name in the build cache: the flags enter its digest), so that
thread 0 of every CTA adds the SM clocks between the barriers that end its
phases: the prologue (resident weights, first image), each layer, the
outputs, and apart from them the waits for the prefetched image and for
weights copied per image. Runs lyr3-std's whole net and lyr4-wide's L1-L3
tail on seeded noise with the shipped weights and the detect outputs (bins
and twin), ten launches each after one warm-up, and prints each phase's
clocks per CTA per launch and its share, then one JSON line. Also times
each launch with CUDA events, at a batch of 1536 (the bench's pool). Needs
a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PHASES = ("prologue", "L0", "L1", "L2", "L3", "outputs", "image wait", "weight wait")
LAUNCHES = 10
BATCH = 1536
FLAGS = "-DMEGA_CNN_PHASE_CLOCKS"


def main() -> None:
    os.environ["TPU_CNN_TORCH_EXTRA_NVCCFLAGS"] = FLAGS  # before the library loads

    import numpy as np
    import torch

    sys.path.insert(0, os.getcwd())
    from tpu_cnn_torch.apps.kernel_cases import ARTIFACTS, bundle_of
    from tpu_cnn_torch.ops import mega
    from tpu_cnn_torch.utils import artifacts as art

    if not torch.cuda.is_available():
        sys.exit("mega_phases: torch finds no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rs = np.random.RandomState(0)
    b = BATCH
    k3 = [torch.from_numpy(k).to(dev) for k in art.load_bundle(ARTIFACTS["lyr3-std"]).kernels]
    k4 = [torch.from_numpy(k).to(dev) for k in bundle_of("lyr4-wide").kernels[1:]]
    cases = {
        "lyr3-std": (torch.from_numpy(rs.randint(0, 256, (b, 128, 128)).astype(np.uint8)).to(dev),
                     k3, (2, 4, 6)),
        "lyr4-wide tail": (torch.from_numpy(
            rs.randint(0, 256, (b, 16, 128, 128)).astype(np.uint8)).to(dev), k4, (5, 5, 7)),
    }
    read = getattr(mega._lib(), "mega_cnn_phase_cycles", None)
    if read is not None:
        read.argtypes = [ctypes.c_void_p]
        read.restype = ctypes.c_int
    buf = (ctypes.c_ulonglong * len(PHASES))()
    out = {"card": card, "flags": FLAGS, "batch": b, "sms": sms}
    for name, (x, ks, sh) in cases.items():
        shifts = torch.tensor(sh, dtype=torch.int32, device=dev)
        packed = mega.pack_plan(ks, x.shape[-1]) if x.dim() == 3 else [
            mega.pack_weights(k) for k in ks]

        def call():
            return mega.cnn_forward_mega(x, ks, shifts, with_feats=False, with_bins=True,
                                         with_twin=True, packed=packed)

        call()
        torch.cuda.synchronize()
        if read is not None and read(buf) != 0:
            sys.exit("mega_phases: reading the phase clocks failed")
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            call()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / LAUNCHES
        out[name] = {"ms": ms}
        if read is None:
            print(f"[{name}] batch {b}: {ms!r} ms a launch (no phase clocks in this "
                  f"checkout's kernel)", flush=True)
            continue
        read(buf)
        grid = min(b, sms)  # one CTA per SM at these geometries
        cycles = [v / LAUNCHES / grid for v in buf]
        total = sum(cycles)
        print(f"[{name}] batch {b}: {ms!r} ms a launch; clocks per CTA per launch: "
              + ", ".join(f"{p} {c:.0f} ({c / total:.1%})" for p, c in zip(PHASES, cycles)),
              flush=True)
        out[name]["cycles_per_cta"] = dict(zip(PHASES, cycles))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
