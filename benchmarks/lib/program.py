"""The system under test, as a cell's configuration names it.

The only module of the harness, with the drivers that call what these
return, that imports the program, ``tpu_cnn_torch``: the engine and the
camera loop's per-frame detect, on the bundle and backend of the
configuration file.
"""

from __future__ import annotations

import numpy as np

from benchmarks.lib import spec


def load_model(config: dict):
    """The program's model from the configuration's bundle
    (``spec.bundle_dir``), at the configuration's shifts (refused where
    the program would run others)."""
    from tpu_cnn_torch.apps.common import load_model as program_load

    model = program_load(spec.bundle_dir(config), config["variant"])
    if [int(s) for s in model.shifts] != [int(s) for s in config["shifts"]]:
        raise ValueError(f"the program loads shifts {list(model.shifts)}, the "
                         f"configuration states {config['shifts']}")
    got = [list(lc) for lc in model.config.layer_configs]
    if got != [list(lc) for lc in config["layer_configs"]]:
        raise ValueError(f"the program's layers {got} are not the "
                         f"configuration's {config['layer_configs']}")
    return model


def make_engine(config: dict, device):
    """``CUDAEngine`` on the configuration's backend and box mode."""
    from tpu_cnn_torch.engine.cuda import CUDAEngine

    model = load_model(config)
    return CUDAEngine(model, device, backend=config["backend"],
                      box_mode=config["box_mode"]), model


def detect_frame(engine, model, frame: np.ndarray):
    """The camera loop's per-frame detect, fused (``apps.realtime``)."""
    from tpu_cnn_torch.apps.realtime import detect_frame as program_detect

    return program_detect(engine, model, frame, fused=True)
