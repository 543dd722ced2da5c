"""YOLOv3 on the port (``models.region.DarknetConfig``, ``engine.region
.RegionEngine``'s layer graph, ``ops.yolo_head``), on the CPU.

A small YOLOv3-shaped graph (a 64 px input, one residual block a stage,
four classes, but every row kind: stride-2 convs, shortcuts, both kinds of
route, upsamples and three heads) with a seeded, calibrated bundle
(``benchmarks/bundles/yolov3.py``) runs through the engine's CPU path and
is held to the plain reference (``reference/yolov3.py``): every launch's
map bit for bit, the answers within float32's error. The [yolo] head's
plain version is held to the reference's head, ties included; the graph's
checks refuse broken graphs; the new modes of both kernels' plans
(``csrc/region_layer_plan.h``: the unpooled and stride-2 outputs;
``csrc/conv_stream_plan.h``: stride 2, pitches, residual, upsample) are
built by g++ behind a C shim and checked; the engine's plan for the full
YOLOv3-416 puts every conv on the kernel its geometry routes it to,
with every shortcut, upsample and route inside a conv's launch. The
kernels themselves run on the card only (``chip_smoke.py``'s yolov3
section, ``apps.kernel_cases``)."""

import ctypes
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from benchmarks.bundles import yolov3 as maker  # noqa: E402
from benchmarks.lib import yolo3_counts  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402
from tpu_cnn_torch.engine.region import RegionEngine  # noqa: E402
from tpu_cnn_torch.models.region import (COCO_ANCHORS, COCO_MASKS, DarknetConfig,  # noqa: E402
                                         RegionModel, yolov3_rows)
from tpu_cnn_torch.models.registry import get_config  # noqa: E402
from tpu_cnn_torch.ops import _build, conv_stream, region_layer, yolo_head  # noqa: E402
from tpu_cnn_torch.reference import yolov2_tiny, yolov3 as ref  # noqa: E402
from tpu_cnn_torch.utils import profiling  # noqa: E402

CLASSES = 4
SMALL = DarknetConfig(yolov3_rows(64, CLASSES, (1, 1, 1, 1, 1)), num_classes=CLASSES)
FULL = get_config("yolov3-416")


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


# ── the configuration ────────────────────────────────────────────────


def test_yolov3_416_is_darknets_cfg():
    rows = FULL.layer_configs
    kinds = [r[0] for r in rows]
    assert len(rows) == 107
    assert {k: kinds.count(k) for k in set(kinds)} == {
        "conv": 75, "shortcut": 23, "route": 4, "upsample": 2, "yolo": 3}
    assert rows[0] == ("conv", 3, 32, 416, 3, 1) and rows[1] == ("conv", 32, 64, 416, 3, 2)
    assert rows[83] == ("route", -4) and rows[86] == ("route", -1, 61)
    assert rows[98] == ("route", -1, 36) and rows[85] == ("upsample", 2)
    assert [rows[r] for r in FULL.heads] == [("yolo", 6, 7, 8), ("yolo", 3, 4, 5),
                                             ("yolo", 0, 1, 2)]
    assert FULL.anchors == COCO_ANCHORS and FULL.masks == [tuple(m) for m in COCO_MASKS]
    assert (FULL.num_classes, FULL.thresh, FULL.nms, FULL.max_det) == (80, 0.005, 0.45, 100)
    nodes = FULL.graph()
    assert [(nodes[r].channels, nodes[r].size) for r in (61, 36, 86, 98)] == [
        (512, 26), (256, 52), (768, 26), (384, 52)]
    assert sum(3 * nodes[r].size ** 2 for r in FULL.heads) == 10647


def test_counts_at_the_configurations_rows():
    assert FULL.macs() == 32932037632 and FULL.weight_bytes() == 61895776
    rows = [list(r) for r in FULL.layer_configs]
    assert yolo3_counts.macs_per_frame(rows) == 32932037632
    assert yolo3_counts.weight_bytes(rows) == 61895776
    assert yolo3_counts.sums_bytes(rows) == 4 * 255 * (13 ** 2 + 26 ** 2 + 52 ** 2)
    assert yolo3_counts.stack_bound_ms(rows, 512) == pytest.approx(17.04, abs=0.01)
    # a sector of each of 10,647 boxes, the other 10 sectors of each of 1,000
    # candidates' 340-byte rows, the answers
    assert yolo3_counts.head_bound_ms(rows, 512, 100, 1000) == pytest.approx(
        (10647 * 32 + 1000 * 320 + 2404) * 512 / 3.35e12 * 1e3)
    # the per-conv bounds summed: 45.4 us a frame against the MACs' 33.3
    per_conv = yolo3_counts.stream_bound_ms(rows, 512) + yolo3_counts.layer_bound_ms(rows, 512)
    assert per_conv / 512 * 1e3 == pytest.approx(45.4, abs=0.05)
    assert yolo3_counts.macs_per_frame(rows) / 989.5e12 * 1e6 == pytest.approx(33.3, abs=0.05)


@pytest.mark.parametrize("rows, why", [
    ((("conv", 3, 8, 8, 3, 1), ("conv", 16, 8, 8, 3, 1)), "reads"),
    ((("conv", 3, 8, 8, 3, 1), ("conv", 8, 16, 8, 3, 2), ("shortcut", -2)), "different shapes"),
    ((("conv", 3, 8, 8, 3, 1), ("conv", 8, 8, 8, 3, 2), ("route", -1, 0)), "different sides"),
    ((("conv", 3, 27, 8, 3, 1), ("yolo", 0, 1, 2)), "1x1 conv"),
    ((("conv", 3, 8, 8, 3, 1), ("shortcut", -5)), "not an earlier one"),
    ((("conv", 3, 8, 8, 3, 1), ("avgpool", 2)), "kind"),
    ((("conv", 3, 8, 7, 3, 2),), "even map"),
    ((("conv", 3, 27, 8, 1, 1), ("yolo", 0, 1, 2)), "three heads"),
])
def test_the_graph_checks_refuse_a_broken_graph(rows, why):
    with pytest.raises(ValueError, match=why):
        DarknetConfig(rows, num_classes=4)


# ── the plain versions on the CPU ────────────────────────────────────


def test_the_engine_holds_the_reference_bit_for_bit(small):
    model, frames, _ = small
    eng = CUDAEngine(model, "cpu", backend="pallas", box_mode="yolo")
    assert isinstance(eng, RegionEngine)
    maps = eng.region_maps(frames)
    keep = {}
    kernels, biases, shifts = _ref_args(model)
    ref.forward(frames, kernels, biases, shifts, SMALL.layer_configs, keep=keep)
    assert set(maps) <= set(keep) and len(maps) == len(SMALL.conv_rows)
    for r, m in maps.items():
        assert torch.equal(m.to(torch.float64), keep[r]), r
    # the maps are alive, neither all 0 nor all 255 (but at 2x2, where two
    # calibration frames leave a channel's bias to 8 sums)
    alive = [0 < float(m.double().mean()) < 255 for r, m in maps.items()
             if r not in SMALL.linear]
    assert sum(alive) >= 0.9 * len(alive)
    _, _, dets, count = eng.detect_device(frames)
    _, _, rdets, rcount = ref.detect(frames, kernels, biases, shifts, SMALL.layer_configs,
                                     SMALL.anchors, SMALL.masks, CLASSES, SMALL.thresh,
                                     SMALL.nms, SMALL.max_det)
    assert torch.equal(count.to(torch.int64), rcount)
    assert float((dets.double() - rdets).abs().max()) < 1e-4 * float(rdets.abs().max())


def test_the_engine_counts_its_graph_rows(small):
    model, frames, _ = small
    eng = CUDAEngine(model, "cpu", backend="pallas", box_mode="yolo")
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        eng.detect_device(frames)
    spans, counters = profiling.spans()
    # 5 shortcuts, 2 upsamples and 2 concatenating routes a frame
    assert counters["net.graph.ops"] == 9 * 3
    assert counters["head.yolo.frames"] == 3
    assert {"engine.net", "net.stream", "head.yolo"} <= set(spans)


def test_the_region_engine_refuses_the_wrong_box_mode(small):
    model, _, _ = small
    with pytest.raises(ValueError, match="box_mode 'yolo'"):
        CUDAEngine(model, "cpu", backend="pallas", box_mode="region")


def test_the_full_plan_routes_every_conv_and_fuses_every_row():
    rng = np.random.default_rng(0)
    kernels = [np.zeros((oc, ic, k, k), np.int8) for ic, oc, _, k, _ in FULL.specs]
    biases = [np.zeros(oc, np.int32) for _, oc, _, _, _ in FULL.specs]
    model = RegionModel(kernels, biases, rng.integers(5, 15, 75), FULL)
    eng = RegionEngine(model, "cpu")
    plan = eng._plan  # the card's plan: the CPU's is the same
    assert len(plan) == 75 and eng._graph_ops == 27
    layer = [s.conv for s in plan if s.route == "layer"]
    assert layer == [0, 1, 2, 3, 4, 6, 8]  # rows 0, 1, 2, 3, 5, 7 and 10
    assert [plan[i].kwargs["out_mode"] for i in layer] == [
        "plain", "stride2", "plain", "plain", "stride2", "plain", "plain"]
    assert sum(s.residual is not None for s in plan) == 23
    assert [s.conv for s in plan if s.kwargs.get("stride") == 2] == [9, 26, 43]
    assert [s.conv for s in plan if s.kwargs.get("upsample")] == [59, 67]
    assert {s.conv: s.into for s in plan if s.into} == {
        25: (98, 128), 42: (86, 256), 59: (86, 0), 67: (98, 0)}
    assert [s.conv for s in plan if s.kwargs.get("last")] == [58, 66, 74]
    # the benchmark's counts route the convs as the program does
    rows = [list(r) for r in FULL.layer_configs]
    assert yolo3_counts.streamed(rows) == [s.conv for s in plan if s.route == "stream"]
    assert sorted(yolo3_counts.linear_convs(rows)) == [58, 66, 74]


def test_the_chain_keeps_its_launches():
    """yolov2-tiny-voc's plan: L0-L3 pooled on the layer kernel, L4-L8 on
    the streamed one with their pools, the last linear, as always."""
    cfg = get_config("yolov2-tiny-voc")
    kernels = [np.zeros((oc, ic, k, k), np.int8) for ic, oc, _, k, _ in cfg.specs]
    biases = [np.zeros(oc, np.int32) for _, oc, _, _, _ in cfg.specs]
    eng = RegionEngine(RegionModel(kernels, biases, [8] * 9, cfg), "cpu")
    assert [(s.conv, s.route, s.src, s.writes, s.kwargs) for s in eng._plan] == [
        (0, "layer", None, 0, {}), (1, "layer", 0, 1, {}), (2, "layer", 1, 2, {}),
        (3, "layer", 2, 3, {}), (4, "stream", 3, 4, {"pool": 2, "last": False}),
        (5, "stream", 4, 5, {"pool": 1, "last": False}),
        (6, "stream", 5, 6, {"pool": 0, "last": False}),
        (7, "stream", 6, 7, {"pool": 0, "last": False}),
        (8, "stream", 7, 8, {"pool": 0, "last": True})]


def _ties_sums(b=2, grids=(2, 4, 8), seed=0):
    """Seeded sums of three heads with repeated cells: equal scores whose
    order only the index settles."""
    g = torch.Generator().manual_seed(seed)
    sums = []
    for gg in grids:
        t = torch.randn((b, 3, 5 + CLASSES, gg, gg), generator=g) * 1.5
        t[:, :, 4] -= 2.0
        t[..., 1::2] = t[..., ::2][..., : gg // 2]  # every other column repeats its left one
        sums.append((t * 2 ** 10).round().to(torch.int32).reshape(b, -1, gg, gg))
    return sums


@pytest.mark.parametrize("max_det", [100, 7])
def test_the_plain_head_holds_the_references_head(max_det):
    sums = _ties_sums()
    shifts = torch.tensor([10, 10, 10], dtype=torch.int32)
    dets, count = yolo_head.yolo_detect(sums, shifts, [0, 1, 2], COCO_ANCHORS, COCO_MASKS,
                                        CLASSES, 64, 0.005, 0.45, max_det)
    boxes, obj, raw = ref.decode(sums, [10, 10, 10], COCO_ANCHORS, COCO_MASKS, CLASSES, 64)
    scores = ref.threshold(obj, raw, 0.005)
    rdets, rcount = yolov2_tiny.top(boxes, yolov2_tiny.nms(boxes, scores, 0.45), max_det)
    assert torch.equal(count.to(torch.int64), rcount) and int(count.min()) > 0
    # the same pairs in the same order (ties by index, then class)
    assert torch.equal(dets[..., 5], rdets[..., 5].to(torch.float32))
    assert float((dets.double() - rdets).abs().max()) < 1e-5 * float(rdets.abs().max())


def test_the_head_refuses_what_no_kernel_takes():
    sums = _ties_sums()
    with pytest.raises(ValueError, match="three heads"):
        yolo_head.yolo_detect(sums[:2], torch.zeros(3, dtype=torch.int32), [0, 1],
                              COCO_ANCHORS, COCO_MASKS[:2], CLASSES, 64, 0.005, 0.45, 10)
    with pytest.raises(ValueError, match="max_det"):
        yolo_head.yolo_detect(sums, torch.zeros(3, dtype=torch.int32), [0, 1, 2],
                              COCO_ANCHORS, COCO_MASKS, CLASSES, 64, 0.005, 0.45, 300)


def test_the_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros((1, 32, 8, 8), dtype=torch.uint8)
    w = torch.zeros((16, 32, 3, 3), dtype=torch.int8)
    b = torch.zeros(16, dtype=torch.int32)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="unpooled"):  # oc 16 unpooled
        region_layer.region_layer(x, w, b, s, 0, out_mode="plain")
    assert not region_layer.takes(3, 32, 8, 8, "stride2")  # the recast has no stride 2
    assert region_layer.takes(64, 128, 104, 104, "stride2")
    x = torch.zeros((1, 128, 8, 8), dtype=torch.uint8)
    w = torch.zeros((256, 128, 3, 3), dtype=torch.int8)
    b = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="layer graph"):
        conv_stream.conv_stream(x, w, b, s, 0, pool=2, stride=2)
    with pytest.raises(ValueError, match="residual must be"):
        conv_stream.conv_stream(x, w, b, s, 0, residual=torch.zeros((1, 256, 4, 4),
                                                                   dtype=torch.uint8))


def test_the_plain_layers_write_a_routes_slice():
    g = torch.Generator().manual_seed(1)
    x = torch.randint(0, 256, (2, 128, 4, 4), generator=g, dtype=torch.uint8)
    w = torch.randint(-5, 6, (64, 128, 1, 1), generator=g, dtype=torch.int8)
    b = torch.randint(-500, 500, (64,), generator=g, dtype=torch.int32)
    s = torch.tensor([6], dtype=torch.int32)
    buf = torch.zeros((2, 96, 8, 8), dtype=torch.uint8)
    got = conv_stream.conv_stream(x, w, b, s, 0, upsample=True, out=buf[:, :64])
    want = ref.clip_shift(ref.conv_sums(x, w, b, 1, 1), 6)
    want = want.repeat_interleave(2, 2).repeat_interleave(2, 3).to(torch.uint8)
    assert got.data_ptr() == buf.data_ptr() and torch.equal(buf[:, :64], want)
    assert int(buf[:, 64:].abs().sum()) == 0


# ── the plans' new modes (g++) ───────────────────────────────────────

_SHIM = r"""
#include "conv_stream_plan.h"
#include "region_layer_plan.h"
// Each output pixel of a layer kernel's layer in an unpooled mode, counted
// once per M row that stores it; 1 where a tap of a stored row reads past
// the staged rows or columns.
extern "C" int layer_cover(int batch, int ic, int oc, int h, int w, int mode, int* hits) {
  region_plan::Geometry g;
  if (region_plan::make_geometry_ex(batch, ic, oc, h, w, 1, 1, mode, &g)) return 2;
  int oh, ow;
  region_plan::out_map(g, oh, ow);
  for (long long u = 0; u < g.units; ++u) {
    int b, band, seg, prows, sw, x0, q;
    region_plan::unit_item(g, u, b, band, seg);
    region_plan::item_shape(g, band, seg, prows, sw, x0, q);
    for (int tile = 0; tile < region_plan::item_tiles(g, band, seg); ++tile) {
      for (int r = 0; r < 64; ++r) {
        int y, x;
        region_plan::tile_out_pixel(g, band, seg, tile, r, y, x);
        if (y < 0) continue;
        ++hits[(static_cast<long long>(b) * oh + y) * ow + x];
        const int s = mode == region_plan::kOutStride2 ? 2 : 1;
        for (int d = 0; d < 3; ++d) {
          const int srow = s * y - 1 + d - (2 * band * g.band - 1);
          const int scol = s * x - 1 + d - (x0 - g.lead);
          if (srow < 0 || srow >= 2 * prows + 2 || scol < 0 || scol >= g.lead + sw + 1) return 1;
        }
      }
    }
  }
  return 0;
}
// The streamed kernel's geometry of a layer graph's conv.
extern "C" int stream_geometry(int batch, int ic, int oc, int h, int w, int k, int linear,
                               int stride, int in_pitch, int out_pitch, int res_pitch,
                               int upsample, long long* o) {
  stream_plan::Geometry g;
  if (stream_plan::make_geometry_ex(batch, ic, oc, h, w, k, 0, linear, 1, stride, in_pitch,
                                    out_pitch, res_pitch, upsample, &g)) return 1;
  unsigned long long dims[4], strides[3];
  int lower[2], upper[2];
  stream_plan::im2col_box(g, dims, strides, lower, upper);
  const long long v[] = {g.stride, g.out_h, g.out_w, g.rows_per_image, g.m_rows, g.m_tiles,
                         g.units, g.mode, (long long)strides[0], (long long)strides[1],
                         (long long)strides[2], lower[0], upper[0]};
  for (int i = 0; i < 13; ++i) o[i] = v[i];
  return 0;
}
// Where each slab of a stride-2 layer starts (output pixel b, y, x).
extern "C" int stream_slabs(int batch, int ic, int oc, int h, int w, int* o) {
  stream_plan::Geometry g;
  if (stream_plan::make_geometry_ex(batch, ic, oc, h, w, 3, 0, 0, 1, 2, ic, oc, 0, 0, &g)) return 1;
  for (long long mt = 0; mt < g.m_tiles; ++mt) {
    for (int j = 0; j < 2; ++j) {
      int b, y, x;
      stream_plan::slab_start_out(g, mt, j, b, y, x);
      int* r = o + 3 * (2 * mt + j);
      r[0] = b; r[1] = y; r[2] = x;
    }
  }
  return 0;
}
// The residual's tensor map of a layer graph's conv (dims, pitch) and each
// residual byte (row, channel) counted once per tile box that brings it; 1
// where a box strays from its tile or lies wholly past oc, 2 where the conv
// or the map at `base` is refused.
extern "C" int stream_residual(int batch, int ic, int oc, int h, int w, int k, int res_pitch,
                               unsigned long long base, long long* map, int* hits) {
  stream_plan::Geometry g;
  if (stream_plan::make_geometry_ex(batch, ic, oc, h, w, k, 0, 0, 1, 1, ic, oc, res_pitch, 0,
                                    &g)) return 2;
  unsigned long long dims[2], strides[1];
  if (stream_plan::residual_map(g, base, dims, strides)) return 2;
  map[0] = (long long)dims[0]; map[1] = (long long)dims[1]; map[2] = (long long)strides[0];
  for (long long u = 0; u < g.units; ++u) {
    long long mt;
    int nt;
    stream_plan::unit_tile(g, u, mt, nt);
    for (int i = 0; i < stream_plan::residual_boxes(g, nt); ++i) {
      int c, row;
      stream_plan::residual_box(g, mt, nt, i, c, row);
      if (c < nt * g.tile_n || c + stream_plan::kResBoxC > (nt + 1) * g.tile_n || c >= oc ||
          row != mt * g.tile_m) return 1;
      for (long long r = row; r < row + g.tile_m && r < (long long)dims[1]; ++r) {
        for (int ch = c; ch < c + stream_plan::kResBoxC && ch < (int)dims[0]; ++ch) {
          ++hits[r * oc + ch];
        }
      }
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def plans(tmp_path_factory):
    d = tmp_path_factory.mktemp("yolov3_plans")
    src, lib = d / "shim.cpp", d / "shim.so"
    src.write_text(_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    str(src), "-o", str(lib)], check=True)
    so = ctypes.CDLL(str(lib))
    i, p = ctypes.c_int, ctypes.c_void_p
    so.layer_cover.argtypes = [i] * 6 + [p]
    so.stream_geometry.argtypes = [i] * 12 + [p]
    so.stream_slabs.argtypes = [i] * 5 + [p]
    so.stream_residual.argtypes = [i] * 7 + [ctypes.c_ulonglong, p, p]
    return so


# (batch, ic, oc, H, W, mode): YOLOv3's layer-kernel convs, and edges (odd
# output rows of a band, segments, ic 16 and 127)
LAYER_CASES = [
    (2, 3, 32, 416, 416, 1), (2, 32, 64, 416, 416, 2), (2, 64, 32, 208, 208, 1),
    (2, 32, 64, 208, 208, 1), (2, 64, 128, 208, 208, 2), (2, 64, 128, 104, 104, 1),
    (3, 16, 48, 30, 30, 1), (2, 127, 64, 22, 22, 2), (1, 64, 128, 26, 26, 2),
    (2, 32, 64, 4096, 8, 2), (1, 16, 32, 6, 8192, 1),
]


@pytest.mark.parametrize("case", LAYER_CASES)
def test_the_layer_plan_stores_every_output_pixel_once(plans, case):
    b, ic, oc, h, w, mode = case
    oh, ow = (h, w) if mode == 1 else (h // 2, w // 2)
    hits = np.zeros(b * oh * ow, np.int32)
    assert plans.layer_cover(b, ic, oc, h, w, mode, hits.ctypes.data) == 0
    assert (hits == 1).all()


def test_the_layer_plan_refuses_the_unpooled_modes_edges(plans):
    hits = np.zeros(64 * 64, np.int32)
    assert plans.layer_cover(1, 32, 16, 8, 8, 1, hits.ctypes.data) == 2  # oc 16
    assert plans.layer_cover(1, 32, 33, 8, 8, 1, hits.ctypes.data) == 2  # odd oc
    assert plans.layer_cover(1, 3, 32, 8, 8, 2, hits.ctypes.data) == 2  # the recast


@pytest.mark.parametrize("case, want", [
    # L12, L37 and L62 (stride 2; L62 reads layer 61's map inside L86's)
    ((512, 128, 256, 104, 104, 3, 0, 2, 128, 256, 0, 0),
     (2, 52, 52, 2704, 512 * 2704, 512 * 2704 // 128, 512 * 2704 // 128, 0, 128)),
    ((512, 512, 1024, 26, 26, 3, 0, 2, 768, 1024, 0, 0),
     (2, 13, 13, 169, 512 * 169, -(-512 * 169 // 128), 4 * -(-512 * 169 // 128), 0, 768)),
    # L60 (residual, into L86's channels 256..767), L84 (upsample into 0..255)
    ((512, 256, 512, 26, 26, 3, 0, 1, 256, 768, 512, 0),
     (1, 26, 26, 676, 512 * 676, 512 * 676 // 128, 2 * 512 * 676 // 128, 0, 256)),
    ((512, 512, 256, 13, 13, 1, 0, 1, 512, 768, 0, 1),
     (1, 13, 13, 169, 512 * 169, -(-512 * 169 // 128), -(-512 * 169 // 128), 0, 512)),
    # the linear layer of 255 channels: two N tiles of 128
    ((512, 1024, 255, 13, 13, 1, 1, 1, 1024, 255, 0, 0),
     (1, 13, 13, 169, 512 * 169, -(-512 * 169 // 128), 2 * -(-512 * 169 // 128), 3, 1024)),
])
def test_the_stream_plan_of_a_graphs_convs(plans, case, want):
    o = np.zeros(13, np.int64)
    assert plans.stream_geometry(*case, o.ctypes.data) == 0
    assert tuple(o[:9]) == want
    b, ic, oc, h, w, k = case[:6]
    assert tuple(o[9:11]) == (case[8] * w, case[8] * w * h)  # the pixels' pitch
    assert (o[11], o[12]) == (-(k // 2), k // 2 - (k - 1))


@pytest.mark.parametrize("case", [
    (2, 128, 256, 104, 104, 3, 0, 2, 128, 256, 0, 1),  # stride 2 and upsample
    (2, 128, 256, 103, 103, 3, 0, 2, 128, 256, 0, 0),  # stride 2 on an odd map
    (2, 128, 256, 104, 104, 1, 0, 2, 128, 256, 0, 0),  # stride 2 of a 1x1
    (2, 128, 256, 26, 26, 3, 0, 1, 136, 256, 0, 0),  # a pitch not of 16 bytes
    (2, 128, 256, 26, 26, 3, 0, 1, 128, 255, 0, 0),  # an odd output pitch
    (2, 128, 256, 26, 26, 3, 0, 1, 128, 256, 256, 1),  # residual and upsample
    (2, 128, 255, 26, 26, 1, 1, 1, 128, 512, 0, 0),  # the linear layer at a pitch
    (2, 128, 256, 26, 26, 3, 0, 1, 128, 256, 264, 0),  # a residual pitch not of 16 bytes
    (2, 128, 256, 26, 26, 3, 0, 1, 128, 256, 258, 0),  # nor of 16 bytes, though even
    # a residual whose last rows pass a 32-bit coordinate
    (2 ** 21, 128, 256, 32, 32, 3, 0, 1, 128, 256, 256, 0),
])
def test_the_stream_plan_refuses(plans, case):
    assert plans.stream_geometry(*case, np.zeros(13, np.int64).ctypes.data) == 1


def test_the_stream_plan_takes_a_huge_map_without_a_residual(plans):
    o = np.zeros(13, np.int64)
    assert plans.stream_geometry(2 ** 21, 128, 256, 32, 32, 3, 0, 1, 128, 256, 0, 0,
                                 o.ctypes.data) == 0
    assert o[4] == 2 ** 31


# (batch, ic, oc, H, W, k, residual pitch): L74's shape at batch 3 (507
# rows: the last M tile partial), oc 128 (one box of a tile's two), a
# pitch past oc, a last N tile of one box, one of two boxes the second
# partial
RESIDUAL_CASES = [(3, 512, 1024, 13, 13, 3, 1024), (2, 128, 128, 10, 10, 3, 128),
                  (2, 256, 256, 26, 26, 3, 288), (1, 128, 384, 12, 12, 1, 384),
                  (1, 128, 200, 8, 8, 3, 208)]


@pytest.mark.parametrize("case", RESIDUAL_CASES)
def test_the_residual_boxes_bring_every_byte_once(plans, case):
    b, ic, oc, h, w, k, rp = case
    hits = np.zeros(b * h * w * oc, np.int32)
    m = np.zeros(3, np.int64)
    assert plans.stream_residual(b, ic, oc, h, w, k, rp, 4096, m.ctypes.data,
                                 hits.ctypes.data) == 0
    assert tuple(m) == (oc, b * h * w, rp)
    assert (hits == 1).all()


@pytest.mark.parametrize("base, pitch, ok", [
    (4096, 256, True), (4096 + 16, 272, True), (4096 + 8, 272, False), (4096 + 2, 256, False),
    (4096, 264, False)])
def test_the_residual_map_refuses_what_tma_cannot_read(plans, base, pitch, ok):
    hits = np.zeros(2 * 26 * 26 * 256, np.int32)
    m = np.zeros(3, np.int64)
    got = plans.stream_residual(2, 128, 256, 26, 26, 3, pitch, base, m.ctypes.data,
                                hits.ctypes.data)
    assert got == (0 if ok else 2)


def test_the_stream_plans_stride2_slabs_walk_the_output(plans):
    b, ic, oc, h = 3, 128, 256, 26
    o = np.zeros(3 * 2 * (-(-b * 169 // 128)), np.int32)
    assert plans.stream_slabs(b, ic, oc, h, h, o.ctypes.data) == 0
    for s, (bb, y, x) in enumerate(o.reshape(-1, 3)):
        q = 64 * s
        assert (bb, y, x) == (q // 169, q % 169 // 13, q % 13)
