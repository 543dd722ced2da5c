"""The plain reference against the program's plain CPU path, and the
controls against the cells' limits (on the CPU, at a size a test run can
hold; ``test_controls_at_cell_size`` repeats it on the card at the cells'
own sizes)."""

from __future__ import annotations

import glob
import os

import numpy as np
import pytest
import torch

from benchmarks.control import readings
from benchmarks.lib import check, spec, traffic
from benchmarks.reference.cnn import CONTROLS, Reference, control_answers, numbers
from benchmarks.tests.tiny import tiny_config
from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward
from tpu_cnn_torch.ops import detect_head

SHIPPED = ["lyr3-std", "lyr4-wide"]


def _shipped_frames(config, n_noise: int) -> np.ndarray:
    size = config["img_size"]
    files = sorted(glob.glob(os.path.join(spec.ROOT, config["bundle"], "test_image_*.bin")))
    real = np.stack([np.fromfile(f, np.uint8).reshape(size, size) for f in files[:8]])
    return np.concatenate([real, traffic.frames(1, "test", n_noise, size)])


def _program(config, frames):
    from benchmarks.lib import program

    engine, model = program.make_engine(config, torch.device("cpu"))
    out = engine.detect_device(torch.from_numpy(frames))[2:]
    return model, [o.numpy() for o in out]


@pytest.mark.parametrize("name", SHIPPED)
def test_reference_matches_the_program_on_shipped_bundles(name):
    config = spec.load_json(spec.config_path(name))
    frames = _shipped_frames(config, 4 if name == "lyr3-std" else 2)
    probs, boxes = Reference(config, "cpu").detect(torch.from_numpy(frames), 8)
    model, (pred, conf, pr, bbox) = _program(config, frames)
    found = numbers(probs, boxes, np.arange(len(frames)), pred, conf, pr, bbox)
    assert found["pred_gap"] == 0.0 and found["box_miss"] == 0.0
    assert found["prob_err"] < 1e-5
    # the features, against the program's own numpy oracle, bit for bit
    ref = Reference(config, "cpu")
    feats = ref.features(torch.from_numpy(frames[:2])).numpy()
    for i in range(2):
        want = numpy_cnn_forward(frames[i], model.kernels, model.shifts)
        assert np.array_equal(feats[i].reshape(want.shape), want)


def test_reference_matches_the_program_on_a_tiny_net(tmp_path):
    config = tiny_config(tmp_path)
    frames = traffic.frames(2, "test", 12, config["img_size"])
    probs, boxes = Reference(config, "cpu").detect(torch.from_numpy(frames), 5)
    _, (pred, conf, pr, bbox) = _program(config, frames)
    found = numbers(probs, boxes, np.arange(len(frames)), pred, conf, pr, bbox)
    assert found["pred_gap"] == 0.0 and found["box_miss"] == 0.0
    assert found["prob_err"] < 1e-5
    # every class's box, against the program's head on the same features
    feats = Reference(config, "cpu").features(torch.from_numpy(frames))
    f32 = feats.reshape(len(frames), feats.shape[1], -1).to(torch.float32)
    w = torch.from_numpy(np.load(os.path.join(config["bundle"], "fc_weight.npy")))
    for k in range(w.shape[0]):
        got = detect_head.cam_bbox_f32(f32, torch.full((len(frames),), k), w,
                                       config["img_size"]).numpy()
        assert np.array_equal(got, boxes[:, k])


@pytest.mark.parametrize("name", SHIPPED)
def test_controls_fail_the_cells_limits(name):
    """Each control fails at least one number under every cell of its
    configuration, on shipped and noise frames."""
    config = spec.load_json(spec.config_path(name))
    frames = torch.from_numpy(_shipped_frames(config, 8 if name == "lyr3-std" else 2))
    probs, boxes = Reference(config, "cpu").detect(frames, 8)
    cells = [spec.cell(w["name"]) for w in spec.benchmark()["workloads"]
             if w["config"] == name]
    assert cells
    for control, kw in CONTROLS.items():
        cp, cb = Reference(config, "cpu", **kw).detect(frames, 8)
        found = numbers(probs, boxes, np.arange(len(frames)),
                        *control_answers(cp, cb))
        for cell in cells:
            assert not check.judge(found, cell.limits)[0], (control, cell.name, found)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the controls at the cells' own sizes")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_controls_at_cell_size(card, cell):
    c = spec.cell(cell)
    for seed in (101, 102, 103):
        for control, found in readings(c, seed, card).items():
            assert not check.judge(found, c.limits)[0], (control, seed, found)
