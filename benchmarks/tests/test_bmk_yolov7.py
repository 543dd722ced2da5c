"""yolov7-640's files of the harness: the seeded bundle maker
(``bundles/yolov7.py``), the frozen reference and its comparison
(``reference/yolov7.py``), the counts (``lib/yolo7_counts.py``) and the
readers of its cell, on the CPU at a tiny graph with every row kind of
YOLOv7 (a 64 px input, every width divided by 2 to 32 channels at least,
four classes); the controls at the cell's own size are read on the card
(``python3 -m benchmarks.control --workload yolov7-640.offline``)."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmarks.bundles import yolov7 as maker
from benchmarks.lib import check, spec, traffic, yolo7_counts
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.reference import yolov7 as ref

CLASSES = 4
# the yaml's anchors, scaled from its 640 pixels to the tiny graph's 64
ANCHORS = [[w / 10, h / 10] for w, h in (
    (12, 16), (19, 36), (40, 28), (36, 75), (76, 55), (72, 146), (142, 110), (192, 243),
    (459, 401))]


def _rows():
    from tpu_cnn_torch.models.region import yolov7_rows

    return [list(r) for r in yolov7_rows(64, CLASSES, width=2)]


def tiny_config(tmp_path, seed: int = 5) -> dict:
    """The cell's configuration at a tiny graph (the program's registry gets
    it as ``yolo7-tiny-test``), its shifts found by the maker, with a seeded
    bundle written into ``tmp_path``."""
    base = spec.load_json(spec.config_path("yolov7-640"))
    config = {**base, "name": "yolo7-tiny-test", "variant": "yolo7-tiny-test",
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

    config = tiny_config(tmp_path_factory.mktemp("yolo7"))
    registry.DETECTORS["yolo7-tiny-test"] = DarknetConfig(
        tuple(map(tuple, config["layer_configs"])), tuple(map(tuple, ANCHORS)),
        num_classes=CLASSES, thresh=config["thresh"], nms=config["nms"],
        max_det=config["max_det"], decode=config["decode"])
    yield config
    registry.DETECTORS.pop("yolo7-tiny-test")


def _cell(config, **params):
    c = spec.cell("yolov7-640.offline")
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
    config = spec.load_json(spec.config_path("yolov7-640"))
    rows = config["layer_configs"]
    assert config["reduced"] == [] and config["input"] == [3, 640, 640]
    assert [r[0] for r in rows].count("conv") == 92 == len(config["shifts"])
    assert [r[0] for r in rows].count("maxpool") == 8
    assert config["macs_per_frame"] == yolo7_counts.macs_per_frame(rows) == 52_255_539_200
    assert config["weight_bytes"] == yolo7_counts.weight_bytes(rows) == 36_881_504
    assert config["masks"] == [[0, 1, 2], [3, 4, 5], [6, 7, 8]] and len(config["anchors"]) == 9
    assert len(config["class_names"]) == config["num_classes"] == 80
    assert (config["thresh"], config["nms"], config["max_det"]) == (0.001, 0.65, 300)
    assert config["decode"] == "scaled" and config["reference"] == "yolov7"
    assert config["box_mode"] == "yolo" and config["bundle"] == {"maker": "yolov7", "seed": 640}
    assert config["source"] == "https://arxiv.org/abs/2207.02696"
    assert "cfg/deploy/yolov7.yaml" in config["source_part"]
    from tpu_cnn_torch.models.registry import get_config

    cfg = get_config("yolov7-640")
    assert [list(r) for r in cfg.layer_configs] == rows
    assert [list(a) for a in cfg.anchors] == config["anchors"]
    assert (cfg.thresh, cfg.nms, cfg.max_det, cfg.decode) == (0.001, 0.65, 300, "scaled")


def test_the_bundle_maker_at_a_tiny_graph(tiny):
    with open(os.path.join(tiny["bundle"], "calibration.json")) as f:
        cal = json.load(f)
    convs = cal["convs"]
    assert len(convs) == 92 and cal["frames"] == maker.CAL_FRAMES
    relu = [c for c in convs if not c.get("linear")]
    # no map more than 3% at 255 (a little slack at the 2x2 maps) or 55% at
    # 0, and no channel of any map dead
    assert max(c["zero_share"] for c in relu) <= maker.MAX_ZERO + 0.01
    assert max(c["max_share"] for c in relu) <= maker.MAX_SAT + 0.01
    assert max(c["dead_channels"] for c in relu) <= 0.5
    lin = [c for c in convs if c.get("linear")]
    assert len(lin) == 3
    assert all(abs(c["pairs_per_candidate"] - maker.PAIRS) < 0.5 for c in lin)
    with np.load(os.path.join(tiny["bundle"], "region_weights.npz")) as z:
        assert z["kernel0"].dtype == np.int8 and z["bias0"].dtype == np.int32
    # the same seed draws the same bundle; the stated shifts are the found ones
    k2, _, sh2, _ = maker.calibrate(tiny, 5, tiny["shifts"])
    assert sh2 == tiny["shifts"]
    with np.load(os.path.join(tiny["bundle"], "region_weights.npz")) as z:
        assert all(np.array_equal(z[f"kernel{i}"], k) for i, k in enumerate(k2))


# ── the reference and its comparison ─────────────────────────────────


def test_the_reference_is_the_programs_own():
    """The frozen copy's functions are the program's reference's, line for
    line."""
    with open(os.path.join(spec.ROOT, "tpu_cnn_torch", "reference", "yolov7.py")) as f:
        program = f.read()
    with open(spec.reference_path("yolov7")) as f:
        frozen = f.read()
    body = program[program.index("def maxpool"):].strip()
    start = frozen.index("unchanged below this line ──") + len("unchanged below this line ──")
    end = frozen.index("# ── the program's reference/yolov7.py, unchanged above")
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
    """``darknet_decode`` fails at the tiny size; ``f32_sums`` cannot here
    (every sum stays below 2**24, where float32 is exact), nor ``no_pool``
    (SPPCSPC's map is 2x2 here, each channel the same on every pixel of
    noise frames, so its pools change nothing); both fail at the cell's
    size on the card."""
    found = ref.controls(_cell(tiny), _frames(4), "cpu")
    assert sorted(found) == sorted(ref.CONTROLS)
    limits = spec.cell("yolov7-640.offline").limits
    assert not check.judge(found["darknet_decode"], limits)[0], found["darknet_decode"]
    assert found["f32_sums"]["det_miss"] == 0.0


def test_the_dropped_pool_is_sppcspcs_first():
    rows = [tuple(r) for r in spec.load_json(spec.config_path("yolov7-640"))["layer_configs"]]
    r = ref.no_pool_row(rows)
    assert rows[r] == ("maxpool", 5, 1)
    assert [row for row in rows if row[0] == "maxpool"].index(rows[r]) == 3


def test_the_reference_and_bundle_import_nothing_of_the_program():
    from benchmarks.tests import test_bmk_imports as imports

    assert spec.reference_path("yolov7") in set(imports._sources(spec.BENCH_DIR))
    for path in (spec.reference_path("yolov7"), spec.bundle_maker_path("yolov7"),
                 os.path.join(spec.BENCH_DIR, "lib", "yolo7_counts.py")):
        assert "tpu_cnn_torch" not in imports._imports(path), path


# ── the counts and the readers ───────────────────────────────────────


def test_the_counts():
    config = spec.load_json(spec.config_path("yolov7-640"))
    rows = config["layer_configs"]
    # the five MP pools read 12.7 MB a frame and write 3.2 MB; SPPCSPC's
    # cascade reads its 20x20x512 map once and writes three
    mp_in = 256 * 160 ** 2 + 512 * 80 ** 2 + 1024 * 40 ** 2 + 128 * 80 ** 2 + 256 * 40 ** 2
    assert yolo7_counts.pool_bytes(rows) == mp_in + mp_in // 4 + 4 * 512 * 20 ** 2
    assert yolo7_counts.pool_bound_ms(rows, 256) == pytest.approx(
        yolo7_counts.pool_bytes(rows) * 256 / 3.35e12 * 1e3)
    assert yolo7_counts.stack_bound_ms(rows, 256) == pytest.approx(
        52_255_539_200 * 256 / 989.5e12 * 1e3)
    assert yolo7_counts.net_bound_ms(rows, 256) == pytest.approx(
        yolo7_counts.stack_bound_ms(rows, 256) + yolo7_counts.pool_bound_ms(rows, 256))
    assert yolo7_counts.candidates_per_frame(config) == pytest.approx(
        sum(config["assumed"]["readings_seed640"]["candidates_per_frame"]))
    assert len(yolo7_counts.streamed(rows)) == 81
    assert sorted(yolo7_counts.linear_convs(rows)) == [87, 89, 91]
    assert set(yolo7_counts.NET_KERNELS) == {"conv_layer_kernel", "conv_stream_kernel",
                                             "maxpool_kernel"}
    assert yolo7_counts.HEAD_KERNEL == "yolo_head_kernel"


def _ctx(ops, fps=4000.0):
    config = spec.load_json(spec.config_path("yolov7-640"))
    return {"config": config, "params": {"batch": 256}, "trace_rounds": 2, "fps": fps,
            "trace": {"ops": ops, "busy_s": 0.1432, "window_s": 0.144}}


OPS = {"conv_layer_kernel": (0.02, 22), "conv_stream_kernel": (0.1, 162),
       "maxpool_kernel": (0.004, 12), "yolo_head_kernel": (0.003, 2),
       "Memcpy DtoH ": (0.0002, 4)}


def test_the_readers_on_a_synthetic_trace():
    ctx = _ctx(dict(OPS))
    rows = ctx["config"]["layer_configs"]
    read = {n: spec.reader(n).read(ctx) for n in (
        "mfu_pct.yolo7", "net_roofline.yolo7", "stream_roofline.yolo7", "layer_roofline.yolo7",
        "pool_roofline.yolo7", "yolo_head_roofline.yolo7", "head.device_ms.yolo7",
        "device.idle_pct.yolo7")}
    assert read["mfu_pct.yolo7"] == pytest.approx(2 * 52_255_539_200 * 4e3 / 1979e12 * 100)
    assert read["net_roofline.yolo7"] == pytest.approx(
        yolo7_counts.net_bound_ms(rows, 256) / 62.0 * 100)
    assert read["stream_roofline.yolo7"] == pytest.approx(
        yolo7_counts.stream_bound_ms(rows, 256) / 50.0 * 100)
    assert read["layer_roofline.yolo7"] == pytest.approx(
        yolo7_counts.layer_bound_ms(rows, 256) / 10.0 * 100)
    assert read["pool_roofline.yolo7"] == pytest.approx(
        yolo7_counts.pool_bound_ms(rows, 256) / 2.0 * 100)
    cands = yolo7_counts.candidates_per_frame(ctx["config"])
    assert read["yolo_head_roofline.yolo7"] == pytest.approx(
        yolo7_counts.head_bound_ms(rows, 256, 300, cands) / 1.5 * 100)
    # the head's kernel and the copies, not the pools: (0.003 + 0.0002) s over 2 rounds
    assert read["head.device_ms.yolo7"] == pytest.approx(1.6)
    assert read["device.idle_pct.yolo7"] == pytest.approx((1 - 0.1432 / 0.144) * 100)
    assert all(0 < read[n] <= 100 for n in read)
    assert spec.reader("net_roofline.yolo7").read({**ctx, "trace": None}) is None
    assert spec.reader("head.device_ms.yolo7").read({**ctx, "trace": None}) is None


@pytest.mark.parametrize("name, kernel", [
    ("yolo_head_roofline.yolo7", "yolo_head_kernel"),
    ("stream_roofline.yolo7", "conv_stream_kernel"),
    ("layer_roofline.yolo7", "conv_layer_kernel"),
    ("pool_roofline.yolo7", "maxpool_kernel"),
])
def test_a_kernel_share_reads_nothing_without_its_kernel(name, kernel):
    """A program that launches no such kernel (the parent): nothing to read."""
    ops = dict(OPS)
    assert spec.reader(name).read(_ctx(ops)) is not None
    ops.pop(kernel)
    assert spec.reader(name).read(_ctx(ops)) is None


@pytest.mark.parametrize("name, counters, want", [
    ("head.yolo_pct.yolo7", {"head.yolo.frames": 512}, 100.0),
    ("head.yolo_pct.yolo7", {"head.region.frames": 512}, None),
    ("net.pool_maps.yolo7", {"net.pool.maps": 8 * 512}, 8.0),
    ("net.pool_maps.yolo7", {"net.pool.maps": 3 * 512}, 3.0),
    ("net.pool_maps.yolo7", {"head.yolo.frames": 512}, None),
    ("net.pool_maps.yolo7", {}, None),
])
def test_the_counter_readers(monkeypatch, name, counters, want):
    from benchmarks.lib import spans

    monkeypatch.setattr(spans, "snapshot", lambda: ({}, counters))
    got = spec.reader(name).read({"trace_rounds": 2, "params": {"batch": 256}})
    assert got == (pytest.approx(want) if want is not None else None)
    assert spec.reader(name).read({"params": {"batch": 256}}) is None


def test_the_programs_counters_through_the_readers(tiny):
    """A CPU detect of the tiny graph under a profile: the readers read the
    program's own counters: every frame through the [yolo] head, 8 pools a
    frame."""
    from benchmarks.lib import program
    from tpu_cnn_torch.utils import profiling

    engine, _ = program.make_engine(tiny, torch.device("cpu"))
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            engine.detect_device(torch.from_numpy(_frames(4)))
        ctx = {"trace_rounds": 1, "params": {"batch": 4}}
        got = spec.reader("head.yolo_pct.yolo7").read(ctx)
        pools = spec.reader("net.pool_maps.yolo7").read(ctx)
    finally:
        profiling.reset_spans()
    assert got == pytest.approx(100.0) and math.isfinite(got)
    assert pools == pytest.approx(8.0)
