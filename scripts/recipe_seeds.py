"""The README's real-photo recipe at several --seed values, through the CLIs
of the PyTorch port or of the JAX package: train_cnn --bin-folder
train_bins --val-bin-folder val_bins --augment (30 epochs), then the
held-out accuracy of the phase-2 GAP head (infer on val_bins), then
dump_features on train_bins, retrain_classifier --optimizer adam and the
held-out accuracy of the retrained bins head. One line per seed.

    python scripts/recipe_seeds.py --impl port --device cuda 0 1 2   # the port on a card
    python scripts/recipe_seeds.py --impl port --device cuda --jax-draw 0
    python scripts/recipe_seeds.py --impl jax 0 1 2                   # the JAX package, its default backend

``--jax-draw`` (port only) starts phase 1 from the JAX trainer's
lyr3-std --seed 0 initial parameters (``chip_smoke.jax_seed0_draw``)
instead of the port's own draw; --seed then drives the permutation and
augmentation streams only. The port runs --mode mega on a card and the
host oracle (--mode cpu) on the CPU; the JAX package runs --mode cpu.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
REALPHOTO = os.path.join(REPO, "artifacts", "realphoto")


def _accuracy(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return next(ln.strip() for ln in out.getvalue().splitlines() if "Accuracy:" in ln)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("seeds", nargs="+")
    p.add_argument("--impl", choices=("port", "jax"), required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="the port's device")
    p.add_argument("--jax-draw", action="store_true")
    p.add_argument("--out", default=os.path.join(REPO, "build", "recipe_seeds"))
    args = p.parse_args(argv)
    if args.impl == "port":
        from tpu_cnn_torch.apps import dump_features, infer, retrain_classifier
        from tpu_cnn_torch.train import train_cnn

        extra = ["--device", args.device]
        mode = ["--mode", "mega" if args.device == "cuda" else "cpu"]
        if args.jax_draw:
            from chip_smoke import jax_seed0_draw

            draw = jax_seed0_draw()
            train_cnn.init_params = lambda cfg, generator: train_cnn.params_from_numpy(draw)
    else:
        if args.jax_draw:
            p.error("--jax-draw is the port's option")
        from tpu_cnn.apps import dump_features, infer, retrain_classifier
        from tpu_cnn.train import train_cnn

        extra, mode = [], ["--mode", "cpu"]
    for seed in args.seeds:
        out = os.path.join(args.out, f"{args.impl}_seed{seed}")
        shutil.rmtree(out, ignore_errors=True)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            train_cnn.main(["--bin-folder", os.path.join(REALPHOTO, "train_bins"),
                            "--val-bin-folder", os.path.join(REALPHOTO, "val_bins"),
                            "--augment", "--seed", seed, "--output-dir", out] + extra)
        wall = time.perf_counter() - t0
        held_out = mode + ["--artifacts", out, "--image-dir",
                           os.path.join(REALPHOTO, "val_bins"), "--no-save"] + extra
        gap = _accuracy(infer.main, held_out)
        feats = os.path.join(out, "features.npz")
        with contextlib.redirect_stdout(io.StringIO()):
            dump_features.main(mode + ["--artifacts", out, "--image-dir",
                                       os.path.join(REALPHOTO, "train_bins"),
                                       "--output", feats] + extra)
            retrain_classifier.main(["--features", feats, "--optimizer", "adam",
                                     "--output-dir", out, "--classes",
                                     os.path.join(out, "classes.json")] + extra)
        bins = _accuracy(infer.main, held_out)
        print(f"{args.impl} seed {seed}{' (JAX draw)' if args.jax_draw else ''}: "
              f"train_cnn {wall:.1f} s; held out, GAP head {gap}; retrained "
              f"bins head {bins}", flush=True)


if __name__ == "__main__":
    main()
