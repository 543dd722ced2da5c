"""YOLOv7 on the port (``models.region.yolov7_rows``, ``DarknetConfig``'s
``maxpool`` rows, routes of up to six maps and the scaled decode;
``engine.region.RegionEngine``'s graph plan; ``ops.maxpool``;
``ops.yolo_head``'s scaled mode), on the CPU.

``yolov7_rows(640)`` holds the yaml's counts; the graph's checks refuse
the new broken cases; a YOLOv7-shaped graph at 64 px (every width divided
by 2, to 32 channels at least, so that the plan is the one the card would
run: the 1x1s before the upsamples keep 128 input channels and the
streamed kernel; four classes) with a seeded, calibrated
bundle (``benchmarks/bundles/yolov7.py``) runs through the engine's CPU
path and is held to the plain reference (``reference/yolov7.py``): every
launch's map bit for bit, the answers within float32's error; the plain
pooling op and its cascade equal ``F.max_pool2d``; the scaled decode
equals the reference's in both head orders; the plan for the full
YOLOv7-640 writes every concatenation's every channel once, puts every
conv on the kernel its geometry routes it to and every pool on the
pooling kernel. The kernels themselves run on the card only
(``chip_smoke.py``'s yolov7 section, ``apps.kernel_cases``)."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import torch.nn.functional as F  # noqa: E402

from benchmarks.bundles import yolov7 as maker  # noqa: E402
from benchmarks.lib import yolo7_counts  # noqa: E402
from benchmarks.reference import yolov7 as bench_ref  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.engine.region import RegionEngine  # noqa: E402
from tpu_cnn_torch.models.region import (YOLOV7_ANCHORS, YOLOV7_MASKS,  # noqa: E402
                                         DarknetConfig, RegionModel, yolov7_rows)
from tpu_cnn_torch.models.registry import get_config  # noqa: E402
from tpu_cnn_torch.ops import maxpool, yolo_head  # noqa: E402
from tpu_cnn_torch.reference import yolov2_tiny, yolov7 as ref  # noqa: E402
from tpu_cnn_torch.utils import profiling  # noqa: E402

CLASSES = 4
SMALL = DarknetConfig(yolov7_rows(64, CLASSES, width=2), YOLOV7_ANCHORS, num_classes=CLASSES,
                      thresh=0.001, nms=0.65, max_det=300, decode="scaled")
FULL = get_config("yolov7-640")


def _conf(cfg):
    return {"layer_configs": [list(r) for r in cfg.layer_configs],
            "anchors": [list(a) for a in cfg.anchors], "num_classes": cfg.num_classes,
            "thresh": cfg.thresh}


@pytest.fixture(scope="module")
def small():
    """The small graph's calibrated model and 3 seeded frames."""
    kernels, biases, shifts, cal = maker.calibrate(_conf(SMALL), 11)
    model = RegionModel(kernels, biases, shifts, SMALL)
    frames = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 3, 64, 64),
                                                                 dtype=np.uint8))
    return model, frames, cal


def _ref_args(model):
    return ([torch.from_numpy(k) for k in model.kernels],
            [torch.from_numpy(b) for b in model.biases], [int(s) for s in model.shifts])


def _zero_model(cfg):
    kernels = [np.zeros((oc, ic, k, k), np.int8) for ic, oc, _, k, _ in cfg.specs]
    biases = [np.zeros(oc, np.int32) for _, oc, _, _, _ in cfg.specs]
    return RegionModel(kernels, biases, [8] * len(cfg.specs), cfg)


# ── the configuration ────────────────────────────────────────────────


def test_yolov7_640_is_the_yaml():
    rows = FULL.layer_configs
    kinds = [r[0] for r in rows]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "conv": 92, "route": 38, "maxpool": 8, "upsample": 2, "yolo": 3}
    assert FULL.macs() == 52_255_539_200 and FULL.weight_bytes() == 36_881_504
    nodes = FULL.graph()
    assert [nodes[r].size for r in FULL.heads] == [80, 40, 20]
    assert sum(3 * nodes[r].size ** 2 for r in FULL.heads) == 25200
    assert FULL.masks == list(YOLOV7_MASKS) and FULL.anchors == YOLOV7_ANCHORS
    assert [rows[r][1:] for r in FULL.pools] == [(2, 2)] * 3 + [(5, 1), (9, 1), (13, 1)] + \
        [(2, 2)] * 2
    # the concatenations: 4 of E-ELAN's 4 maps, 4 of ELAN-H's 6, 5 MP
    # blocks' (two of three maps, across scales), 2 after the upsamples,
    # SPPCSPC's 2
    widths = sorted(len(r) - 1 for r in rows if r[0] == "route" and len(r) > 2)
    assert widths == [2] * 6 + [3] * 2 + [4] * 5 + [6] * 4
    assert (FULL.num_classes, FULL.thresh, FULL.nms, FULL.max_det, FULL.decode) == (
        80, 0.001, 0.65, 300, "scaled")
    assert [(nodes[r].channels, nodes[r].size) for r in FULL.conv_rows[:4]] == [
        (32, 640), (64, 320), (64, 320), (128, 160)]
    # SPPCSPC's 2,048-channel concatenation and its 1x1
    spp = next(r for r in range(len(rows)) if rows[r][0] == "route"
               and any(rows[i][0] == "maxpool" for i in nodes[r].inputs))
    assert nodes[spp].channels == 2048 and rows[spp + 1] == ("conv", 2048, 512, 20, 1, 1)


@pytest.mark.parametrize("rows, why", [
    ((("conv", 3, 8, 10, 3, 2), ("maxpool", 2, 2)), "odd map"),
    ((("conv", 3, 8, 8, 3, 1), ("maxpool", 3, 1)), "maxpool is one of"),
    ((("conv", 3, 8, 8, 3, 1), ("maxpool", 5, 2)), "maxpool is one of"),
    ((("conv", 3, 8, 8, 3, 1),) + (("route", 0),) * 6 + (("route", 0, 1, 2, 3, 4, 5, 6),),
     "1 to 6"),
    ((("conv", 3, 8, 8, 3, 1), ("maxpool", 2, 2), ("route", 0, 1)), "different sides"),
])
def test_the_graph_checks_refuse_a_broken_graph(rows, why):
    with pytest.raises(ValueError, match=why):
        DarknetConfig(rows, num_classes=4)


def test_the_graph_refuses_an_unknown_decode():
    with pytest.raises(ValueError, match="decode"):
        DarknetConfig(SMALL.layer_configs, YOLOV7_ANCHORS, num_classes=CLASSES,
                      decode="anchor_free")


# ── the plain versions on the CPU ────────────────────────────────────


def test_the_engine_holds_the_reference_bit_for_bit(small):
    model, frames, _ = small
    eng = CUDAEngine(model, "cpu", backend="pallas", box_mode="yolo")
    assert isinstance(eng, RegionEngine)
    maps = eng.region_maps(frames)
    keep = {}
    kernels, biases, shifts = _ref_args(model)
    ref.forward(frames, kernels, biases, shifts, SMALL.layer_configs, keep=keep)
    assert set(maps) <= set(keep) and len(maps) == len(SMALL.conv_rows) + len(SMALL.pools)
    for r, m in maps.items():
        assert torch.equal(m.to(torch.float64), keep[r]), r
    alive = [0 < float(m.double().mean()) < 255 for r, m in maps.items()
             if r not in SMALL.linear]
    assert sum(alive) >= 0.9 * len(alive)
    _, _, dets, count = eng.detect_device(frames)
    # the engine's head is the plain float32 head on the reference's sums
    heads = ref.forward(frames, kernels, biases, shifts, SMALL.layer_configs)
    layers = ref.linear_convs(SMALL.layer_configs)
    pdets, pcount = yolo_head.yolo_detect_reference(
        [h.to(torch.int32) for h in heads], model.shifts, layers, SMALL.anchors, SMALL.masks,
        CLASSES, 64, SMALL.thresh, SMALL.nms, SMALL.max_det, "scaled")
    assert torch.equal(count, pcount) and torch.equal(dets, pdets)
    # and the float64 reference's answer, as the cell's comparison reads it
    # (near ties and sub-float32 boxes left out): every pair compared found
    boxes, obj, raw = ref.decode(heads, [shifts[i] for i in layers], SMALL.anchors,
                                 SMALL.masks, CLASSES, 64)
    raw = torch.where(obj[..., None] > SMALL.thresh, raw, torch.zeros_like(raw))
    want = bench_ref.tiny_answer(boxes, raw, SMALL.thresh, SMALL.nms, SMALL.max_det,
                                 bench_ref.score_keys(heads, SMALL.masks, CLASSES))
    assert torch.equal(count.to(torch.int64), want.count)
    got = bench_ref.match(want, dets.numpy(), count.numpy())
    assert got["ref_n"].sum() > 100  # of 900: at 4 classes a tiny box leaves out a quarter
    assert got["miss"].sum() == 0 and got["extra"].sum() == 0
    assert got["score_err"].max() < 1e-6 and got["box_err"].max() < 1e-5


def test_the_engine_counts_its_pools_and_graph_rows(small):
    model, frames, _ = small
    eng = CUDAEngine(model, "cpu", backend="pallas", box_mode="yolo")
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.detect_device(frames)
    spans, counters = profiling.spans()
    # 8 pools, 2 upsamples and 17 concatenating routes a frame
    assert counters["net.graph.ops"] == 27 * 3
    assert counters["net.pool.maps"] == 8 * 3
    assert counters["head.yolo.frames"] == 3
    assert spans["net.pool"][0] == 6  # SPPCSPC's three pools in one launch
    assert {"engine.net", "net.stream", "net.pool", "head.yolo"} <= set(spans)


# (batch, channels, side, sizes, stride)
POOL_CASES = [(2, 16, 8, (2,), 2), (3, 32, 20, (5, 9, 13), 1), (1, 48, 7, (9,), 1),
              (2, 16, 3, (13, 5), 1), (1, 16, 1, (5,), 1)]


@pytest.mark.parametrize("case", POOL_CASES)
def test_the_plain_pools_are_f_max_pool2d(case):
    b, c, s, sizes, stride = case
    g = torch.Generator().manual_seed(s)
    x = torch.randint(0, 256, (b, c, s, s), generator=g, dtype=torch.uint8)
    got = maxpool.maxpool(x, sizes, stride)
    for k, m in zip(sizes, got):
        want = F.max_pool2d(x.double(), k, stride, (k - 1) // 2).to(torch.uint8)
        assert m.dtype == torch.uint8 and torch.equal(m, want), k
        assert torch.equal(ref.maxpool(x.double(), k, stride).to(torch.uint8), want)


def test_the_pool_writes_its_slices():
    g = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (2, 32, 6, 6), generator=g, dtype=torch.uint8)
    buf = torch.full((2, 128, 6, 6), 77, dtype=torch.uint8)
    outs = [buf[:, 32:64], buf[:, 64:96], buf[:, 96:128]]
    got = maxpool.maxpool(x, (5, 9, 13), 1, outs=outs)
    assert [o.data_ptr() for o in got] == [o.data_ptr() for o in outs]
    assert torch.equal(buf[:, 96:], F.max_pool2d(x.double(), 13, 1, 6).to(torch.uint8))
    assert int((buf[:, :32] != 77).sum()) == 0


@pytest.mark.parametrize("sizes, stride", [((3,), 1), ((2,), 1), ((5,), 2), ((5, 9, 13, 5), 1)])
def test_the_pool_refuses_what_no_kernel_takes(sizes, stride):
    with pytest.raises(ValueError, match="sizes"):
        maxpool.maxpool(torch.zeros((1, 16, 4, 4), dtype=torch.uint8), sizes, stride)
    assert not maxpool.takes(24, 8, 8, 2) and not maxpool.takes(16, 7, 8, 2)
    assert maxpool.takes(512, 20, 20, 1) and not maxpool.takes(16, 64, 64, 1)


def _sums(b, grids, seed=0):
    g = torch.Generator().manual_seed(seed)
    out = []
    for gg in grids:
        t = torch.randn((b, 3, 5 + CLASSES, gg, gg), generator=g) * 1.5
        t[:, :, 4] -= 2.0
        out.append((t * 2 ** 10).round().to(torch.int32).reshape(b, -1, gg, gg))
    return out


@pytest.mark.parametrize("grids", [(8, 4, 2), (2, 4, 8)])
def test_the_scaled_decode_holds_the_references(grids):
    sums = _sums(2, grids)
    masks = YOLOV7_MASKS if grids[0] == 8 else YOLOV7_MASKS[::-1]
    shifts = torch.tensor([10, 10, 10], dtype=torch.int32)
    boxes, obj, cls = yolo_head.decode_reference(sums, shifts, [0, 1, 2], YOLOV7_ANCHORS,
                                                 masks, CLASSES, 64, "scaled")
    rboxes, robj, rraw = ref.decode(sums, [10, 10, 10], YOLOV7_ANCHORS, masks, CLASSES, 64)
    assert float((boxes.double() - rboxes).abs().max()) < 1e-6 * float(rboxes.abs().max())
    assert float((obj.double() - robj).abs().max()) < 1e-6
    # x = (j + 2 sigmoid(tx) - 0.5) / g, w = (2 sigmoid(tw))**2 a_w / net
    t = sums[0][0].reshape(3, 5 + CLASSES, grids[0], grids[0])[0, :, 0, 1].double() / 2 ** 10
    a = YOLOV7_ANCHORS[masks[0][0]]
    assert float(rboxes[0, 3, 0]) == pytest.approx((1 + 2 * torch.sigmoid(t[0]) - 0.5) / grids[0])
    assert float(rboxes[0, 3, 2]) == pytest.approx((2 * torch.sigmoid(t[2])) ** 2 * a[0] / 64)
    dets, count = yolo_head.yolo_detect(sums, shifts, [0, 1, 2], YOLOV7_ANCHORS, masks,
                                        CLASSES, 64, 0.001, 0.65, 300, "scaled")
    scores = ref.threshold(robj, rraw, 0.001)
    rdets, rcount = yolov2_tiny.top(rboxes, yolov2_tiny.nms(rboxes, scores, 0.65), 300)
    assert torch.equal(count.to(torch.int64), rcount) and int(count.min()) > 0
    assert torch.equal(dets[..., 5], rdets[..., 5].to(torch.float32))
    assert float((dets.double() - rdets).abs().max()) < 1e-5 * float(rdets.abs().max())


def test_the_head_takes_300_pairs_only_when_scaled():
    sums = _sums(1, (8, 4, 2))
    shifts = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="max_det"):
        yolo_head.yolo_detect(sums, shifts, [0, 1, 2], YOLOV7_ANCHORS, YOLOV7_MASKS, CLASSES,
                              64, 0.001, 0.65, 300)
    with pytest.raises(ValueError, match="max_det"):
        yolo_head.yolo_detect(sums, shifts, [0, 1, 2], YOLOV7_ANCHORS, YOLOV7_MASKS, CLASSES,
                              64, 0.001, 0.65, 400, "scaled")
    with pytest.raises(ValueError, match="decode"):
        yolo_head.yolo_detect(sums, shifts, [0, 1, 2], YOLOV7_ANCHORS, YOLOV7_MASKS, CLASSES,
                              64, 0.001, 0.65, 10, "anchor_free")


# ── the plan of the full YOLOv7-640 ──────────────────────────────────


@pytest.fixture(scope="module")
def full_plan():
    eng = RegionEngine(_zero_model(FULL), "cpu")
    return eng, eng._plan  # the card's plan: the CPU's is the same


def test_the_full_plan_routes_every_conv_and_pool(full_plan):
    eng, plan = full_plan
    convs = [s for s in plan if s.route != "pool"]
    assert len(convs) == 92 and eng._graph_ops == 27
    assert sorted(s.conv for s in convs) == list(range(92))
    layer = [s.conv for s in convs if s.route == "layer"]
    assert layer == [0, 1, 2, 3, 6, 7, 8, 9, 62, 63, 64]  # rows 0-3, 6-9 and 71-73
    assert [plan[[s.conv for s in plan].index(i)].kwargs["out_mode"] for i in layer] == [
        "plain", "stride2", "plain", "stride2"] + ["plain"] * 7
    pools = [s for s in plan if s.route == "pool"]
    assert [(s.kwargs["sizes"], s.kwargs["stride"]) for s in pools] == [
        ((2,), 2)] * 3 + [((5, 9, 13), 1)] + [((2,), 2)] * 2
    assert [r for s in pools for r, _ in s.outs] == FULL.pools
    assert [s.conv for s in convs if s.kwargs.get("upsample")] == [48, 57]
    assert [s.conv for s in convs if s.kwargs.get("last")] == [87, 89, 91]
    assert all(s.residual is None for s in convs)
    rows = [list(r) for r in FULL.layer_configs]
    assert yolo7_counts.streamed(rows) == [s.conv for s in convs if s.route == "stream"]


def test_the_full_plan_writes_every_concatenation_once(full_plan):
    """Every channel of every concatenation written by exactly one launch
    (57 convs' own maps, 2 upsampled maps, SPPCSPC's 3 pools), and no
    conv, pool or concatenation a pass of its own."""
    eng, plan = full_plan
    nodes = eng._nodes
    hits = {q: np.zeros(n.channels, np.int32) for q, n in enumerate(nodes)
            if n.kind == "route" and len(n.inputs) > 1}
    writes = [m for s in plan for m in s.made]
    for row, into in writes:
        if into is not None:
            q, off = into
            hits[q][off:off + nodes[row].channels] += 1
    assert len(hits) == 17 and all((h == 1).all() for h in hits.values())
    convs = [s for s in plan if s.route != "pool"]
    assert sum(s.into is not None and not s.kwargs.get("upsample") for s in convs) == 57
    sliced = {r for r, into in writes if into is not None}
    reads = [s for s in plan if s.src is not None and eng._alias(s.src, nodes) in sliced]
    assert [s.conv for s in reads if s.route == "layer"] == [6, 8, 62, 63, 64]
    assert sum(1 for s in plan if s.route == "pool" and eng._alias(s.src, nodes) in sliced) == 1


def test_the_plan_refuses_a_map_in_two_concatenations():
    rows = (("conv", 3, 32, 8, 3, 1), ("conv", 32, 32, 8, 3, 1), ("route", 0, 1),
            ("route", 1, 0), ("conv", 64, 255, 8, 1, 1), ("yolo", 0, 1, 2),
            ("route", 3), ("conv", 64, 27, 8, 1, 1), ("yolo", 0, 1, 2),
            ("route", 3), ("conv", 64, 27, 8, 1, 1), ("yolo", 0, 1, 2))
    cfg = DarknetConfig(tuple(r if r[0] != "conv" or r[2] != 255 else ("conv", 64, 27, 8, 1, 1)
                              for r in rows), num_classes=4)
    with pytest.raises(ValueError, match="another concatenation"):
        RegionEngine(_zero_model(cfg), "cpu")
