"""yolov2-tiny-voc's files of the harness: the seeded bundle maker
(``bundles/yolov2.py``), the frozen reference and its comparison
(``reference/yolov2.py``), the operation counts (``lib/yolo_counts.py``)
and its readers, on the CPU at a tiny geometry with the same layer kinds;
the controls at the cell's own size are ``test_bmk_reference
.test_controls_at_cell_size``'s, on the card."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from benchmarks.bundles import yolov2 as maker
from benchmarks.lib import check, spec, traffic, yolo_counts
from benchmarks.lib.outcome import Answers, Outcome
from benchmarks.reference import yolov2 as ref

LAYERS = [[3, 8, 28, 3, 2], [8, 16, 14, 3, 2], [16, 32, 7, 3, 1], [32, 32, 7, 3, 0],
          [32, 16, 7, 1, 0]]
# MACs and weight bytes per layer of yolov2-tiny-voc, from its darknet cfg
TABLE = [(74_760_192, 432), (199_360_512, 4_608), (199_360_512, 18_432),
         (199_360_512, 73_728), (199_360_512, 294_912), (199_360_512, 1_179_648),
         (797_442_048, 4_718_592), (1_594_884_096, 9_437_184), (21_632_000, 128_000)]


def tiny_config(tmp_path, seed: int = 7) -> dict:
    """The cell's configuration at a tiny geometry (the program's registry
    gets it as ``yolo-tiny-test``), with a seeded bundle written into
    ``tmp_path``."""
    base = spec.load_json(spec.config_path("yolov2-tiny-voc"))
    config = {**base, "name": "yolo-tiny-test", "variant": "yolo-tiny-test",
              "input": [3, 28, 28], "layer_configs": LAYERS, "shifts": [7, 10, 11, 12, 12],
              "anchors": [[1.0, 1.5], [3.0, 2.0]], "num_classes": 3,
              "class_names": ["a", "b", "c"], "max_det": 10,
              "bundle": os.path.join(str(tmp_path), "bundle")}
    os.makedirs(config["bundle"], exist_ok=True)
    maker.make(config, seed, config["bundle"])
    return config


@pytest.fixture
def tiny(tmp_path, monkeypatch):
    from tpu_cnn_torch.models import registry
    from tpu_cnn_torch.models.region import RegionConfig

    monkeypatch.setattr(maker, "CANDIDATES", 30.0)  # of 98 boxes x 3 classes
    config = tiny_config(tmp_path)
    monkeypatch.setitem(registry.DETECTORS, "yolo-tiny-test", RegionConfig(
        layer_configs=tuple(map(tuple, LAYERS)), anchors=((1.0, 1.5), (3.0, 2.0)),
        num_classes=3, max_det=10))
    return config


def _cell(config, **params):
    c = spec.cell("yolov2-tiny-voc.offline")
    c.config = config
    c.params.update(reference_block=4, **params)
    return c


def _frames(n: int, seed: int = 3) -> np.ndarray:
    return traffic.frames(seed, "test", n, 28, 3)


def _program(config, frames):
    from benchmarks.lib import program

    engine, _ = program.make_engine(config, torch.device("cpu"))
    return [o.numpy() for o in engine.detect_device(torch.from_numpy(frames))[2:]]


def _outcome(frames, answers) -> Outcome:
    return Outcome(measured={}, attempted=len(frames), failed=0, frames=frames,
                   answers=answers, lost=0, kind="cpu", count=1, memory_peak_bytes=0,
                   ctx={}, trace=None)


# ── the bundle maker ─────────────────────────────────────────────────


def test_the_maker_is_deterministic_per_seed(tmp_path, monkeypatch):
    monkeypatch.setattr(maker, "CANDIDATES", 30.0)
    files = {}
    for tag, seed in (("a", 7), ("b", 7), ("c", 8)):
        config = tiny_config(tmp_path / tag, seed)
        files[tag] = {f: open(os.path.join(config["bundle"], f), "rb").read()
                      for f in sorted(os.listdir(config["bundle"]))}
    assert files["a"] == files["b"]
    assert files["a"]["region_weights.npz"] != files["c"]["region_weights.npz"]
    assert sorted(files["a"]) == ["calibration.json", "classes.json", "region_weights.npz",
                                  "shifts.json"]


def test_the_maker_sizes_each_layer(tiny):
    cal = json.load(open(os.path.join(tiny["bundle"], "calibration.json")))
    relu = cal["layers"][:-1]
    assert all(abs(layer["zero_share"] - maker.ZERO_SHARE) < 0.05 for layer in relu)
    assert all(layer["max_share"] < 0.2 for layer in relu)
    # the least objectness bias that leaves at least the target (the
    # count steps over the two calibration frames' ties)
    assert 30.0 <= cal["layers"][-1]["candidates_per_frame"] <= 60.0
    with np.load(os.path.join(tiny["bundle"], "region_weights.npz")) as z:
        assert z["kernel0"].dtype == np.int8 and z["bias0"].dtype == np.int32
        assert z["kernel4"].shape == (16, 32, 1, 1)


# ── the reference and its comparison ─────────────────────────────────


def test_the_reference_is_the_programs_own(tiny):
    """The frozen copy's functions are the program's reference's, line for
    line, and the two give the same detections."""
    with open(os.path.join(spec.ROOT, "tpu_cnn_torch", "reference", "yolov2_tiny.py")) as f:
        program = f.read()
    with open(spec.reference_path("yolov2")) as f:
        frozen = f.read()
    body = program[program.index("def no_tf32"):].strip()
    start = frozen.index("unchanged below this line ──") + len("unchanged below this line ──")
    end = frozen.index("# ── the program's reference/yolov2_tiny.py, unchanged above")
    assert frozen[start:end].strip() == body


def test_the_program_passes_and_a_wrong_answer_fails(tiny):
    frames = _frames(12)
    dets, count = _program(tiny, frames)
    cell = _cell(tiny)
    answers = Answers(np.arange(12).repeat(2), (dets.repeat(2, axis=0), count.repeat(2)))
    found = ref.compare(cell, _outcome(frames, answers), "cpu")
    assert set(found) == set(ref.NUMBERS)
    assert check.judge(found, cell.limits)[0], found
    assert found["det_miss"] == 0.0 and found["score_err"] < 1e-6
    wrong = dets.copy()
    wrong[:, :, 0] += 0.01  # every box moved
    answers = Answers(np.arange(12), (wrong, count))
    found = ref.compare(cell, _outcome(frames, answers), "cpu")
    assert found["det_miss"] > 0.5 and not check.judge(found, cell.limits)[0]


def _reference_answer(config, frames):
    return ref.Reference(config, "cpu").answer(torch.from_numpy(frames))


def test_the_comparison_counts_a_wrong_detection(tiny):
    frames = _frames(6)
    dets, count = _program(tiny, frames)
    want = _reference_answer(tiny, frames)
    found = ref.match(want, dets, count)
    assert found["miss"].sum() == 0 and found["extra"].sum() == 0
    f = int(np.argmax(found["ref_n"]))
    slot = int(np.argmax(dets[f, :, 4] > want.safe_above[f].item()))
    wrong = dets.copy()
    wrong[f, slot, 5] = (wrong[f, slot, 5] + 1) % 3  # another class
    found = ref.match(want, wrong, count)
    assert found["miss"][f] >= 1


def test_only_the_pairs_a_tie_could_move_are_left_out():
    """A class with two candidates at an IoU within the margin of ``nms``
    is left out, the other class is not; at the cut only the pairs a tie
    there could push out are left out, not the frame."""
    boxes = torch.tensor([[[0.5, 0.5, 0.2, 0.2], [0.5, 0.5, 0.2, 0.2],
                           [0.2, 0.2, 0.1, 0.1], [0.8, 0.8, 0.1, 0.1]]], dtype=torch.float64)
    # boxes 0 and 1: IoU 1, far from 0.45; box 4 at IoU 0.45 with box 2
    side = 0.1 * 0.45 ** 0.5  # a square inside box 2, centred alike
    boxes = torch.cat([boxes, torch.tensor([[[0.2, 0.2, side, side]]], dtype=torch.float64)],
                      dim=1)
    raw = torch.tensor([[[0.9, 0.0], [0.8, 0.0], [0.0, 0.7], [0.6, 0.5], [0.0, 0.6]]],
                       dtype=torch.float64)
    assert ref.unsettled(boxes, raw, 0.005, 0.45).tolist() == [[False, True]]
    a = ref.Answer(boxes, raw, 0.005, 0.45, 10)
    assert a.settled.tolist() == [[True, False]] and a.safe_above.item() == 0.0
    # a cut at 2 pairs: the rivals are class 0's pairs left (0.9, 0.6) and
    # class 1's candidates (0.7, 0.6, 0.5): the third largest is 0.6
    a = ref.Answer(boxes, raw, 0.005, 0.45, 2)
    assert a.safe_above.item() == pytest.approx(0.6 / (1 - 2 * ref.SCORE_MARGIN))
    dets, count = ref.top(boxes, ref.nms(boxes, torch.where(raw > 0.005, raw, 0 * raw), 0.45),
                          2)
    found = ref.match(a, dets.numpy(), count.numpy())
    assert found["ref_all"].tolist() == [2] and found["ref_n"].tolist() == [1]  # the 0.9
    # two nearly equal scores of one class on overlapping boxes: unsettled
    raw2 = torch.tensor([[[0.9, 0.0], [0.9 * (1 - 1e-7), 0.0], [0.0, 0.0], [0.0, 0.0],
                          [0.0, 0.0]]], dtype=torch.float64)
    assert ref.unsettled(boxes, raw2, 0.005, 0.45).tolist() == [[True, False]]
    # equal scores from the same inputs (one key): both sides order them by
    # index, so the class is settled; from other inputs it is not
    raw2[0, 1, 0] = 0.9
    same = torch.tensor([[1.0, 1.0, 2.0, 3.0, 4.0]], dtype=torch.float64)
    assert ref.unsettled(boxes, raw2, 0.005, 0.45, same).tolist() == [[False, False]]
    assert ref.unsettled(boxes, raw2, 0.005, 0.45, same + torch.arange(5.0)).tolist() == [
        [True, False]]


def test_the_keys_are_equal_for_equal_inputs_only():
    anchors = [(1.0, 1.0), (2.0, 2.0)]
    sums = torch.randint(-2**20, 2**20, (2, 2 * 8, 3, 3), dtype=torch.int64).double()
    sums[0, 4:8, 1, 2] = sums[0, 4:8, 0, 0]  # anchor 0: cell (1, 2) repeats (0, 0)
    sums[0, 0:4, 1, 2] += 7  # the box's own coordinates may differ
    keys = ref.score_keys(sums, anchors, 3)
    assert keys.shape == (2, 18)
    assert keys[0, 5] == keys[0, 0]  # box n g^2 + i g + j
    assert len(set(keys[0].tolist())) == 17 and len(set(keys[1].tolist())) == 18


def test_the_comparison_reports_what_it_compared(tiny, capsys):
    frames = _frames(8)
    dets, count = _program(tiny, frames)
    cell = _cell(tiny)
    ref.compare(cell, _outcome(frames, Answers(np.arange(8).repeat(2), (dets.repeat(2, axis=0),
                                                                     count.repeat(2)))), "cpu")
    line = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("compared ")]
    got = json.loads(line[-1][len("compared "):])
    assert got["answers"] == 16.0 and got["ref_pairs"] == 2 * float(count.sum())
    # the tiny net's scores crowd its threshold: a share of its pairs only
    assert 0.0 < got["pair_share"] <= 1.0 and 0.0 <= got["whole_share"] <= 1.0
    assert got["pairs_compared"] == got["pair_share"] * got["ref_pairs"]
    assert ref.compared([])["pair_share"] == 0.0


def test_a_number_without_a_limit_fails_and_no_answer_fails(tiny):
    frames = _frames(4)
    dets, count = _program(tiny, frames)
    cell = _cell(tiny)
    found = ref.compare(cell, _outcome(frames, Answers(np.arange(4), (dets, count))), "cpu")
    for dropped in ref.NUMBERS:
        limits = {k: v for k, v in cell.limits.items() if k != dropped}
        ok, checks = check.judge(found, limits)
        assert not ok and checks[dropped]["limit"] is None
    empty = Answers(np.zeros(0, np.int64), (dets[:0], count[:0]))
    found = ref.compare(cell, _outcome(frames, empty), "cpu")
    assert found["det_miss"] == found["det_extra"] == 1.0
    assert not check.judge(found, cell.limits)[0]


def test_the_controls_fail_the_cells_limits(tiny):
    """Three controls fail at the tiny size; ``f32_sums`` cannot here (its
    sums stay below 2**24, where float32 is exact) and is held to the
    limits at the cell's size on the card."""
    found = ref.controls(_cell(tiny), _frames(8), "cpu")
    assert sorted(found) == sorted(ref.CONTROLS)
    limits = spec.cell("yolov2-tiny-voc.offline").limits
    for name in ("bf16_head", "shift_off", "no_stride1_pool"):
        assert not check.judge(found[name], limits)[0], (name, found[name])
    assert found["f32_sums"]["det_miss"] == 0.0


def test_the_reference_file_is_scanned_for_imports():
    from benchmarks.tests import test_bmk_imports as imports

    assert spec.reference_path("yolov2") in set(imports._sources(spec.BENCH_DIR))
    assert "tpu_cnn_torch" not in imports._imports(spec.reference_path("yolov2"))
    assert "tpu_cnn_torch" not in imports._imports(spec.bundle_maker_path("yolov2"))


# ── the counts and the readers ───────────────────────────────────────


def test_the_counts_equal_the_table():
    layers = spec.load_json(spec.config_path("yolov2-tiny-voc"))["layer_configs"]
    assert [(yolo_counts.layer_macs(r), yolo_counts.layer_bytes(r, False)[2])
            for r in layers] == TABLE
    assert yolo_counts.macs_per_frame(layers) == 3_485_520_896
    assert yolo_counts.weight_bytes(layers) == 15_855_536
    assert yolo_counts.streamed(layers) == [4, 5, 6, 7, 8]
    # 1.785 T MACs a round at 989.5 T MAC/s
    assert yolo_counts.stack_bound_ms(layers, 512) == pytest.approx(1.8035, abs=1e-3)
    assert yolo_counts.layer_bytes(layers[-1], True)[1] == 13 * 13 * 125 * 4
    assert yolo_counts.layer_bytes(layers[5], False)[1] == 512 * 13 * 13


@pytest.mark.parametrize("layers", [LAYERS, "yolov2-tiny-voc"])
def test_the_streamed_layers_are_the_programs_routes(layers):
    """The layers ``stream_roofline.yolo`` counts are those the program's
    engine sends to the streamed kernel."""
    from tpu_cnn_torch.engine.cuda import region_routes

    if isinstance(layers, str):
        layers = spec.load_json(spec.config_path(layers))["layer_configs"]
    routes = region_routes([tuple(r) for r in layers])
    assert yolo_counts.streamed(layers) == [i for i, r in enumerate(routes) if r == "stream"]


def test_the_readers_on_a_synthetic_trace():
    layers = spec.load_json(spec.config_path("yolov2-tiny-voc"))["layer_configs"]
    trace = {"ops": {"conv_layer_kernel": (0.02, 4), "conv_stream_kernel": (0.03, 10),
                     "region_head_kernel": (0.001, 2), "Memcpy DtoH ": (0.0002, 4)},
             "busy_s": 0.0512, "window_s": 0.052}
    ctx = {"config": {"layer_configs": layers}, "params": {"batch": 512},
           "trace": trace, "trace_rounds": 2, "fps": 40000.0}
    read = {n: spec.reader(n).read(ctx) for n in (
        "mfu_pct.yolo", "net_roofline.yolo", "stream_roofline.yolo", "head.device_ms.yolo",
        "device.idle_pct.yolo")}
    assert read["mfu_pct.yolo"] == pytest.approx(2 * 3_485_520_896 * 4e4 / 1979e12 * 100)
    assert read["net_roofline.yolo"] == pytest.approx(
        yolo_counts.stack_bound_ms(layers, 512) / 25.0 * 100)
    assert read["stream_roofline.yolo"] == pytest.approx(
        yolo_counts.stream_bound_ms(layers, 512) / 15.0 * 100)
    assert read["head.device_ms.yolo"] == pytest.approx(0.6)
    assert read["device.idle_pct.yolo"] == pytest.approx((1 - 0.0512 / 0.052) * 100)
    # a program without the streamed kernel: that share reads nothing
    trace["ops"].pop("conv_stream_kernel")
    assert spec.reader("stream_roofline.yolo").read(ctx) is None
    assert spec.reader("net_roofline.yolo").read({**ctx, "trace": None}) is None


def test_the_region_heads_share_reads_its_counter(monkeypatch):
    """``head.region_pct.yolo``: the program's counter ``head.region.frames``
    over the frames of the profiled window's rounds; none without the
    counter (a program without the region head) or without a window."""
    from benchmarks.lib import spans

    def read(ctx):
        return spec.reader("head.region_pct.yolo").read(ctx)

    ctx = {"trace_rounds": 3, "params": {"batch": 512}}
    monkeypatch.setattr(spans, "snapshot", lambda: ({}, {"head.region.frames": 1536}))
    assert read(ctx) == pytest.approx(100.0)
    monkeypatch.setattr(spans, "snapshot", lambda: ({}, {"head.region.frames": 768}))
    assert read(ctx) == pytest.approx(50.0)
    assert read({"params": {"batch": 512}}) is None
    monkeypatch.setattr(spans, "snapshot", lambda: ({"app.frame": (1, 1.0, 1.0)}, {}))
    assert read(ctx) is None
    monkeypatch.setattr(spans, "snapshot", lambda: None)
    assert read(ctx) is None


def test_the_programs_counter_through_the_reader(tiny):
    """A CPU detect of the tiny net under a profile: the reader reads the
    program's own counter as 100% of a round's frames."""
    from benchmarks.lib import program
    from tpu_cnn_torch.utils import profiling

    engine, _ = program.make_engine(tiny, torch.device("cpu"))
    profiling.reset_spans()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            engine.detect_device(torch.from_numpy(_frames(4)))
        got = spec.reader("head.region_pct.yolo").read(
            {"trace_rounds": 1, "params": {"batch": 4}})
    finally:
        profiling.reset_spans()
    assert got == pytest.approx(100.0)
