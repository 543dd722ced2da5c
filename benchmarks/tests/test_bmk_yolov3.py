"""yolov3-416's files of the harness: the seeded bundle maker
(``bundles/yolov3.py``), the frozen reference and its comparison
(``reference/yolov3.py``), the counts (``lib/yolo3_counts.py``) and the
readers of its cell, on the CPU at a tiny graph with every row kind of
YOLOv3 (a 64 px input, a residual block a stage, four classes); the
controls at the cell's own size are read on the card
(``python3 -m benchmarks.control --workload yolov3-416.offline``)."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmarks.bundles import yolov3 as maker
from benchmarks.lib import check, spec, traffic, yolo3_counts
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.reference import yolov3 as ref

CLASSES = 4
# the cfg's anchors, scaled from its 416 pixels to the tiny graph's 64
ANCHORS = [[w * 64 / 416, h * 64 / 416] for w, h in (
    (10, 13), (16, 30), (33, 23), (30, 61), (62, 45), (59, 119), (116, 90), (156, 198),
    (373, 326))]


def _rows():
    from tpu_cnn_torch.models.region import yolov3_rows

    return [list(r) for r in yolov3_rows(64, CLASSES, (1, 1, 1, 1, 1))]


def tiny_config(tmp_path, seed: int = 5) -> dict:
    """The cell's configuration at a tiny graph (the program's registry gets
    it as ``yolo3-tiny-test``), its shifts found by the maker, with a seeded
    bundle written into ``tmp_path``."""
    base = spec.load_json(spec.config_path("yolov3-416"))
    config = {**base, "name": "yolo3-tiny-test", "variant": "yolo3-tiny-test",
              "input": [3, 64, 64], "layer_configs": _rows(), "num_classes": CLASSES,
              "class_names": ["a", "b", "c", "d"], "anchors": ANCHORS,
              "bundle": os.path.join(str(tmp_path), "bundle")}
    config["shifts"] = maker.shifts(config, seed)
    os.makedirs(config["bundle"], exist_ok=True)
    maker.make(config, seed, config["bundle"])
    return config


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    from tpu_cnn_torch.models import registry
    from tpu_cnn_torch.models.region import DarknetConfig

    config = tiny_config(tmp_path_factory.mktemp("yolo3"))
    registry.DETECTORS["yolo3-tiny-test"] = DarknetConfig(
        tuple(map(tuple, config["layer_configs"])), tuple(map(tuple, ANCHORS)),
        num_classes=CLASSES)
    yield config
    registry.DETECTORS.pop("yolo3-tiny-test")


def _cell(config, **params):
    c = spec.cell("yolov3-416.offline")
    c.config = config
    c.params.update(reference_block=4, **params)
    return c


def _frames(n: int, seed: int = 3) -> np.ndarray:
    return traffic.frames(seed, "test", n, 64, 3)


def _program(config, frames):
    from benchmarks.lib import program

    engine, _ = program.make_engine(config, torch.device("cpu"))
    return [o.numpy() for o in engine.detect_device(torch.from_numpy(frames))[2:]]


def _outcome(frames, answers) -> Outcome:
    return Outcome(measured={}, attempted=len(frames), failed=0, frames=frames,
                   answers=answers, lost=0, kind="cpu", count=1, memory_peak_bytes=0,
                   ctx={}, trace=None)


# ── the configuration and the bundle ─────────────────────────────────


def test_the_configuration_states_the_published_graph():
    config = spec.load_json(spec.config_path("yolov3-416"))
    rows = config["layer_configs"]
    assert len(rows) == 107 and config["reduced"] == [] and config["input"] == [3, 416, 416]
    assert [r[0] for r in rows].count("conv") == 75 == len(config["shifts"])
    assert config["macs_per_frame"] == yolo3_counts.macs_per_frame(rows) == 32_932_037_632
    assert config["weight_bytes"] == yolo3_counts.weight_bytes(rows) == 61_895_776
    assert len(config["anchors"]) == 9 and config["masks"] == [[6, 7, 8], [3, 4, 5], [0, 1, 2]]
    assert len(config["class_names"]) == config["num_classes"] == 80
    assert (config["thresh"], config["nms"], config["max_det"]) == (0.005, 0.45, 100)
    assert config["box_mode"] == "yolo" and config["reference"] == "yolov3"
    assert config["bundle"] == {"maker": "yolov3", "seed": 416}
    from tpu_cnn_torch.models.registry import get_config

    assert [list(r) for r in get_config("yolov3-416").layer_configs] == rows


def test_the_bundle_maker_at_a_tiny_graph(tiny):
    with open(os.path.join(tiny["bundle"], "calibration.json")) as f:
        cal = json.load(f)
    convs = cal["convs"]
    assert len(convs) == 39 and cal["frames"] == maker.CAL_FRAMES
    relu = [c for c in convs if not c.get("linear")]
    # no conv and no shortcut's sum more than 5% at 255 or 60% at 0 (the
    # 2x2 maps' 8 values a channel round the shares: a little slack)
    assert max(c["zero_share"] for c in relu) <= maker.MAX_ZERO + 0.01
    assert max(c["max_share"] for c in relu) <= 0.05
    assert max(c["shortcut_max_share"] for c in relu if "shortcut_max_share" in c) <= 0.05
    lin = [c for c in convs if c.get("linear")]
    assert [c["row"] for c in lin] == [27, 39, 51]
    assert all(abs(c["pairs_per_candidate"] - maker.PAIRS) < 0.5 for c in lin)
    with np.load(os.path.join(tiny["bundle"], "region_weights.npz")) as z:
        assert z["kernel0"].dtype == np.int8 and z["bias0"].dtype == np.int32
        assert z["kernel2"].shape == (32, 64, 1, 1) and z["kernel22"].shape == (27, 1024, 1, 1)
    # the same seed draws the same bundle; the stated shifts are the found ones
    k2, b2, sh2, _ = maker.calibrate(tiny, 5, tiny["shifts"])
    assert sh2 == tiny["shifts"]
    with np.load(os.path.join(tiny["bundle"], "region_weights.npz")) as z:
        assert all(np.array_equal(z[f"kernel{i}"], k) for i, k in enumerate(k2))


# ── the reference and its comparison ─────────────────────────────────


def test_the_reference_is_the_programs_own():
    """The frozen copy's functions are the program's reference's, line for
    line."""
    with open(os.path.join(spec.ROOT, "tpu_cnn_torch", "reference", "yolov3.py")) as f:
        program = f.read()
    with open(spec.reference_path("yolov3")) as f:
        frozen = f.read()
    body = program[program.index("def conv_sums"):].strip()
    start = frozen.index("unchanged below this line ──") + len("unchanged below this line ──")
    end = frozen.index("# ── the program's reference/yolov3.py, unchanged above")
    assert frozen[start:end].strip() == body


def test_the_program_passes_and_a_wrong_answer_fails(tiny):
    frames = _frames(6)
    dets, count = _program(tiny, frames)
    cell = _cell(tiny)
    answers = Answers(np.arange(6).repeat(2), (dets.repeat(2, axis=0), count.repeat(2)))
    found = ref.compare(cell, _outcome(frames, answers), "cpu")
    assert set(found) == set(ref.NUMBERS)
    assert check.judge(found, cell.limits)[0], found
    assert found["det_miss"] == 0.0 and found["score_err"] < 1e-6
    wrong = dets.copy()
    wrong[:, :, 0] += 0.01  # every box moved
    found = ref.compare(cell, _outcome(frames, Answers(np.arange(6), (wrong, count))), "cpu")
    assert found["det_miss"] > 0.5 and not check.judge(found, cell.limits)[0]


def test_the_controls_fail_the_cells_limits(tiny):
    """``no_shortcut``, ``bf16_head`` and ``softmax_scores`` fail at the tiny
    size; ``f32_sums`` cannot here (every sum stays below 2**24, where
    float32 is exact)."""
    found = ref.controls(_cell(tiny), _frames(4), "cpu")
    assert sorted(found) == sorted(ref.CONTROLS)
    limits = spec.cell("yolov3-416.offline").limits
    for name in ("no_shortcut", "bf16_head", "softmax_scores"):
        assert not check.judge(found[name], limits)[0], (name, found[name])
    assert found["f32_sums"]["det_miss"] == 0.0


def test_the_dropped_shortcut_is_the_last_52x52_blocks():
    rows = [tuple(r) for r in spec.load_json(spec.config_path("yolov3-416"))["layer_configs"]]
    assert ref.no_shortcut_row(rows) == 36 and rows[36] == ("shortcut", -3)


def test_the_keys_are_equal_for_equal_inputs_only():
    g = torch.Generator().manual_seed(0)
    heads = [torch.randint(-2**20, 2**20, (2, 3 * 9, s, s), generator=g).double()
             for s in (1, 2, 3)]
    heads[2][0, 4:9, 1, 2] = heads[2][0, 4:9, 0, 0]  # anchor 0: cell (1, 2) repeats (0, 0)
    heads[2][0, 0:4, 1, 2] += 7  # the box's own coordinates may differ
    keys = ref.score_keys(heads, [(0, 1, 2)] * 3, 4)
    assert keys.shape == (2, 3 * (1 + 4 + 9))
    base = 3 * (1 + 4)
    assert keys[0, base + 3 * 5] == keys[0, base]  # cell 5 = (1, 2), anchor 0
    assert len(set(keys[0].tolist())) == 41 and len(set(keys[1].tolist())) == 42


def test_the_reference_and_bundle_import_nothing_of_the_program():
    from benchmarks.tests import test_bmk_imports as imports

    assert spec.reference_path("yolov3") in set(imports._sources(spec.BENCH_DIR))
    for path in (spec.reference_path("yolov3"), spec.bundle_maker_path("yolov3"),
                 os.path.join(spec.BENCH_DIR, "lib", "yolo3_counts.py")):
        assert "tpu_cnn_torch" not in imports._imports(path), path


# ── the counts and the readers ───────────────────────────────────────


def test_the_counts():
    rows = spec.load_json(spec.config_path("yolov3-416"))["layer_configs"]
    assert yolo3_counts.frame_bytes(rows) == 3 * 416 * 416
    assert yolo3_counts.sums_bytes(rows) == 4 * 255 * 3549
    # 16.86 T MACs a round at 989.5 T MAC/s; 1.85 GB of sums at 3.35 TB/s
    assert yolo3_counts.stack_bound_ms(rows, 512) == pytest.approx(
        32_932_037_632 * 512 / 989.5e12 * 1e3)
    # by the bytes the head must move: a sector a box, the candidates' rows
    # but their objectness sector, the answers; far under the sums' 1.85 GB
    config = spec.load_json(spec.config_path("yolov3-416"))
    assert yolo3_counts.candidates_per_frame(config) == pytest.approx(1001.0)
    assert yolo3_counts.head_bound_ms(rows, 512, 100, 1001.0) == pytest.approx(
        (10647 * 32 + 1001.0 * 320 + 2404) * 512 / 3.35e12 * 1e3)
    assert yolo3_counts.head_bound_ms(rows, 512, 100, 1001.0) < 0.2 * (
        4 * 255 * 3549 * 512 / 3.35e12 * 1e3)
    # each conv's bound: L0 (3->32 at 416) by its bytes, a 3x3 at 13 with
    # 1024 channels by its MACs; a conv before a shortcut reads its map too
    assert yolo3_counts.conv_bound_ms(rows, 0, 512) == pytest.approx(
        ((3 + 32) * 416 * 416 * 512 + 32 * 27) / 3.35e12 * 1e3)
    assert yolo3_counts.conv_bound_ms(rows, 71, 512) == pytest.approx(
        13 * 13 * 1024 * 512 * 9 * 512 / 989.5e12 * 1e3)
    assert yolo3_counts.conv_bound_ms(rows, 3, 512) == pytest.approx(
        ((32 + 2 * 64) * 208 * 208 * 512 + 64 * 32 * 9) / 3.35e12 * 1e3)
    assert len(yolo3_counts.streamed(rows)) == 68
    assert yolo3_counts.LAYER_KERNEL == "conv_layer_kernel"
    assert yolo3_counts.STREAM_KERNEL == "conv_stream_kernel"
    assert set(yolo3_counts.NET_KERNELS) == {"conv_layer_kernel", "conv_stream_kernel"}
    assert yolo3_counts.HEAD_KERNEL == "yolo_head_kernel"


def test_the_readers_on_a_synthetic_trace():
    rows = spec.load_json(spec.config_path("yolov3-416"))["layer_configs"]
    trace = {"ops": {"conv_layer_kernel": (0.02, 14), "conv_stream_kernel": (0.12, 136),
                     "yolo_head_kernel": (0.003, 2), "Memcpy DtoH ": (0.0002, 4)},
             "busy_s": 0.1432, "window_s": 0.144}
    config = spec.load_json(spec.config_path("yolov3-416"))
    ctx = {"config": config, "params": {"batch": 512},
           "trace": trace, "trace_rounds": 2, "fps": 7000.0}
    read = {n: spec.reader(n).read(ctx) for n in (
        "mfu_pct.yolo3", "net_roofline.yolo3", "yolo_head_roofline.yolo3",
        "head.device_ms.yolo3", "device.idle_pct.yolo3", "stream_roofline.yolo3",
        "layer_roofline.yolo3")}
    assert read["mfu_pct.yolo3"] == pytest.approx(2 * 32_932_037_632 * 7e3 / 1979e12 * 100)
    assert read["net_roofline.yolo3"] == pytest.approx(
        yolo3_counts.stack_bound_ms(rows, 512) / 70.0 * 100)
    assert read["yolo_head_roofline.yolo3"] == pytest.approx(
        yolo3_counts.head_bound_ms(rows, 512, 100, 1001.0) / 1.5 * 100)
    assert read["stream_roofline.yolo3"] == pytest.approx(
        yolo3_counts.stream_bound_ms(rows, 512) / 60.0 * 100)
    assert read["layer_roofline.yolo3"] == pytest.approx(
        yolo3_counts.layer_bound_ms(rows, 512) / 10.0 * 100)
    assert read["head.device_ms.yolo3"] == pytest.approx(1.6)
    assert read["device.idle_pct.yolo3"] == pytest.approx((1 - 0.1432 / 0.144) * 100)
    assert all(0 < read[n] <= 100 for n in read if n.endswith(("roofline.yolo3", "pct.yolo3")))
    assert spec.reader("net_roofline.yolo3").read({**ctx, "trace": None}) is None


@pytest.mark.parametrize("name, kernel", [
    ("yolo_head_roofline.yolo3", "yolo_head_kernel"),
    ("stream_roofline.yolo3", "conv_stream_kernel"),
    ("layer_roofline.yolo3", "conv_layer_kernel"),
])
def test_a_kernel_share_reads_nothing_without_its_kernel(name, kernel):
    """A program that launches no such kernel (the parent): nothing to read."""
    config = spec.load_json(spec.config_path("yolov3-416"))
    ops = {"conv_layer_kernel": (0.02, 14), "conv_stream_kernel": (0.12, 136),
           "yolo_head_kernel": (0.003, 2)}
    ctx = {"config": config, "params": {"batch": 512}, "trace_rounds": 2, "fps": 7000.0,
           "trace": {"ops": ops, "busy_s": 0.1432, "window_s": 0.144}}
    assert spec.reader(name).read(ctx) is not None
    ops.pop(kernel)
    assert spec.reader(name).read(ctx) is None


@pytest.mark.parametrize("name, counters, want", [
    ("head.yolo_pct.yolo3", {"head.yolo.frames": 1024}, 100.0),
    ("head.yolo_pct.yolo3", {"head.yolo.frames": 512}, 50.0),
    ("head.yolo_pct.yolo3", {"head.region.frames": 1024}, None),
    ("head.yolo_pct.yolo3", {}, None),
])
def test_the_counter_readers(monkeypatch, name, counters, want):
    from benchmarks.lib import spans

    monkeypatch.setattr(spans, "snapshot", lambda: ({}, counters))
    got = spec.reader(name).read({"trace_rounds": 2, "params": {"batch": 512}})
    assert got == (pytest.approx(want) if want is not None else None)
    assert spec.reader(name).read({"params": {"batch": 512}}) is None


def test_the_programs_counters_through_the_readers(tiny):
    """A CPU detect of the tiny graph under a profile: the reader reads the
    program's own counter: every frame through the [yolo] head."""
    from benchmarks.lib import program
    from tpu_cnn_torch.utils import profiling

    engine, _ = program.make_engine(tiny, torch.device("cpu"))
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            engine.detect_device(torch.from_numpy(_frames(4)))
        ctx = {"trace_rounds": 1, "params": {"batch": 4}}
        got = spec.reader("head.yolo_pct.yolo3").read(ctx)
    finally:
        profiling.reset_spans()
    assert got == pytest.approx(100.0)
    assert math.isfinite(got)
