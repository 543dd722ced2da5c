"""The region route's layer kernel (``tpu_cnn_torch.ops.region_layer``,
``csrc/region_layer.cu``): a region-head detector's pooled 3x3 layers of
fewer than 128 input channels, yolov2-tiny-voc's L0-L3.

On the CPU: the kernel's plan (``csrc/region_layer_plan.h``, built alone
by g++ behind a C shim) at yolov2-tiny-voc's widths and batches and at
the edges (its persistent schedule covers every pooled pixel once, each
tile's M rows are its pixels and hold whole pooling windows, the staging
holds every tap of every row, halo included, and the refusals agree with
the wrapper's ``takes``); ``pack_layer`` against a numpy packing written
from its docstring; the wrapper's plain version and its refusals; the
engine's routes. The kernel has no CPU or interpret mode: the tests marked
``cuda`` hold it to ``conv_stream.region_layer_reference`` bit for bit on
the card (``python -m pytest -m cuda tests/test_torch_region_layer.py``)
and skip elsewhere."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.apps import kernel_cases as kc  # noqa: E402
from tpu_cnn_torch.engine.region import RegionEngine, region_routes  # noqa: E402
from tpu_cnn_torch.models.region import RegionConfig, RegionModel  # noqa: E402
from tpu_cnn_torch.models.registry import get_config  # noqa: E402
from tpu_cnn_torch.ops import _build, conv_stream, region_head, region_layer  # noqa: E402

YOLO = get_config("yolov2-tiny-voc")

# ── the plan (csrc/region_layer_plan.h, built by g++) ─────────────────

_SHIM = r"""
#include "region_layer_plan.h"
using namespace region_plan;
#define LAYER int batch, int ic, int oc, int h, int w, int layout, int aligned
#define GEOMETRY Geometry g; if (make_geometry(batch, ic, oc, h, w, layout, aligned, &g)) return 1;
extern "C" int plan_geometry(LAYER, long long* o) {
  GEOMETRY
  const long long v[] = {g.mode, g.load, g.n, g.cp, g.steps, g.band, g.bands, g.seg_w, g.segs,
                         g.lead, g.cols, g.rows, g.smem, g.units, g.w_bytes,
                         k_group(g.mode, g.cp),
                         g.stage_bytes, g.raw_bytes, g.off_bias, g.off_raw, g.off_stage,
                         g.stages, g.out_bytes, g.off_out};
  for (int i = 0; i < 24; ++i) o[i] = v[i];
  return 0;
}
extern "C" int plan_items(LAYER, int* o) {
  GEOMETRY
  for (long long u = 0; u < g.units; ++u) {
    int b, band, seg, prows, sw, x0, q;
    unit_item(g, u, b, band, seg);
    item_shape(g, band, seg, prows, sw, x0, q);
    int* r = o + 8 * u;
    r[0] = b; r[1] = band; r[2] = seg; r[3] = prows; r[4] = sw; r[5] = x0; r[6] = q;
    r[7] = item_tiles(g, band, seg);
  }
  return 0;
}
extern "C" int plan_tile(LAYER, int band, int seg, int tile, int* o) {
  GEOMETRY
  for (int r = 0; r < 64; ++r) tile_row(g, band, seg, tile, r, o[2 * r], o[2 * r + 1]);
  return 0;
}
extern "C" int plan_taps(LAYER, int band, int seg, int y, int x, int* o) {
  GEOMETRY
  for (int t = 0; t < 9; ++t) {
    int sr, sc, sy, sx;
    staged_at(g, band, seg, y, x, t / 3, t % 3, sr, sc);
    o[4 * t] = sr; o[4 * t + 1] = sc;
    staged_source(g, band, seg, sr, sc, sy, sx);
    o[4 * t + 2] = sy; o[4 * t + 3] = sx;
  }
  return 0;
}
"""

KEYS = ("mode", "load", "n", "cp", "steps", "band", "bands", "seg_w", "segs", "lead", "cols",
        "rows", "smem", "units", "w_bytes", "kg", "stage_bytes", "raw_bytes",
        "off_bias", "off_raw", "off_stage", "stages", "out_bytes", "off_out")


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """The plan header built alone by g++ behind a C shim, bound by ctypes."""
    d = tmp_path_factory.mktemp("region_plan")
    src, lib = d / "plan.cpp", d / "libplan.so"
    src.write_text(_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    assert os.path.exists(lib)
    return ctypes.CDLL(str(lib))


def _args(layer):
    return [ctypes.c_int(int(v)) for v in layer]


def _geometry(plan, layer):
    o = (ctypes.c_longlong * len(KEYS))()
    if plan.plan_geometry(*_args(layer), o):
        return None
    return dict(zip(KEYS, o))


def _items(plan, layer, g):
    o = (ctypes.c_int * (8 * g["units"]))()
    assert plan.plan_items(*_args(layer), o) == 0
    return np.array(o).reshape(-1, 8)


def _tile(plan, layer, band, seg, tile):
    o = (ctypes.c_int * 128)()
    assert plan.plan_tile(*_args(layer), ctypes.c_int(band), ctypes.c_int(seg),
                          ctypes.c_int(tile), o) == 0
    return np.array(o).reshape(64, 2)


# (batch, ic, oc, h, w, layout, aligned): yolov2-tiny-voc's L0-L3 as the
# engine hands them over (frames NCHW, then channels-last maps) at 416 and
# 320, at the cases' and the cell's batches; the edges: one channel, an
# odd ic, other strides, a misaligned map, and a band in column segments
YOLO_LAYERS = [(3, 16, 416, 0), (16, 32, 208, 1), (32, 64, 104, 1), (64, 128, 52, 1)]
YOLO_320 = [(3, 16, 320, 0), (16, 32, 160, 1), (32, 64, 80, 1), (64, 128, 40, 1)]
PLAN_LAYERS = [(b, ic, oc, s, s, lay, 1) for b in (1, 3, 512)
               for ic, oc, s, lay in YOLO_LAYERS] + [
    (3, ic, oc, s, s, lay, 1) for ic, oc, s, lay in YOLO_320] + [
    (2, 64, 128, 26, 26, 1, 1), (3, 1, 8, 28, 28, 0, 1), (3, 5, 7, 14, 14, 0, 1),
    (2, 5, 24, 14, 22, 1, 1), (2, 48, 48, 26, 20, 1, 1), (2, 16, 32, 30, 30, 2, 1),
    (2, 3, 16, 64, 64, 0, 0), (1, 127, 128, 6, 416, 1, 1), (2, 100, 100, 12, 12, 1, 1)]


def _pooled_pixels(plan, layer, g):
    """Every pooled pixel the schedule stores: (b, py, px) for each tile row
    that holds a window's top-left pixel."""
    seen = []
    for b, band, seg, _, _, _, _, tiles in _items(plan, layer, g):
        for tile in range(tiles):
            rows = _tile(plan, layer, band, seg, tile)
            for r in range(64):
                y, x = rows[r]
                if y >= 0 and r % 16 < 8 and x % 2 == 0:
                    seen.append((b, y // 2, x // 2))
    return seen


@pytest.mark.parametrize("layer", [lay for lay in PLAN_LAYERS if lay[0] < 512])
def test_the_schedule_covers_every_pooled_pixel_once(plan, layer):
    """The work units give every (image, band, segment) once, and their
    tiles every pooled pixel of the batch once."""
    g = _geometry(plan, layer)
    assert g is not None
    batch, _, _, h, w, _, _ = layer
    items = _items(plan, layer, g)
    keys = {tuple(r[:3]) for r in items}
    assert len(keys) == g["units"] == batch * g["bands"] * g["segs"]
    seen = _pooled_pixels(plan, layer, g)
    assert len(seen) == len(set(seen)) == batch * (h // 2) * (w // 2)


@pytest.mark.parametrize("layer", [lay for lay in PLAN_LAYERS if lay[0] == 512])
def test_the_schedule_covers_a_round_of_512(plan, layer):
    """At the cell's batch: every (image, band, segment) once, in order, the
    bands of an image covering its pooled rows and the segments its
    columns; an image's tiles (the first and the last image) every pooled
    pixel once."""
    g = _geometry(plan, layer)
    batch, _, _, h, w, _, _ = layer
    items = _items(plan, layer, g)
    assert len(items) == g["units"] == batch * g["bands"] * g["segs"]
    assert (items[:, 0] == np.repeat(np.arange(batch), g["bands"] * g["segs"])).all()
    per = items[: g["bands"] * g["segs"]]
    assert per[:, 3][:: g["segs"]].sum() == h // 2 and per[:, 4][: g["segs"]].sum() == w
    for first in (0, (batch - 1) * g["bands"] * g["segs"]):
        seen = []
        for b, band, seg, _, _, _, _, tiles in items[first:first + g["bands"] * g["segs"]]:
            for tile in range(tiles):
                rows = _tile(plan, layer, band, seg, tile)
                seen += [(y // 2, x // 2) for r, (y, x) in enumerate(rows)
                         if y >= 0 and r % 16 < 8 and x % 2 == 0]
        assert len(seen) == len(set(seen)) == (h // 2) * (w // 2)


@pytest.mark.parametrize("layer", PLAN_LAYERS)
def test_every_tiles_rows_are_its_pixels_and_windows(plan, layer):
    """M row g (upper) and g + 8 (lower) of a warp are one column of a
    pooling window's two rows, and rows g, g ^ 1 its two columns: each
    window lies in one tile, a lane's rows and lane ^ 4's."""
    g = _geometry(plan, layer)
    items = _items(plan, layer, g)
    picks = items if len(items) <= 12 else items[[0, 1, len(items) // 2, -1]]
    for _, band, seg, prows, sw, x0, q, tiles in picks:
        for tile in range(tiles):
            rows = _tile(plan, layer, band, seg, tile)
            for r in range(64):
                y, x = rows[r]
                p = 32 * tile + 8 * (r // 16) + r % 8
                if p >= q:
                    assert (y, x) == (-1, -1)
                    continue
                pr = p // sw
                assert (y, x) == (2 * (band * g["band"] + pr) + (r % 16) // 8, x0 + p - pr * sw)
                if r % 16 < 8 and x % 2 == 0:  # the window's top-left
                    assert tuple(rows[r ^ 1]) == (y, x + 1)
                    assert tuple(rows[r + 8]) == (y + 1, x)
                    assert tuple(rows[(r ^ 1) + 8]) == (y + 1, x + 1)


@pytest.mark.parametrize("layer", PLAN_LAYERS)
def test_the_staging_holds_every_tap_halo_included(plan, layer):
    """Every tap of every M row of an item reads a staged pixel inside the
    staging (its rows and columns), holding the source pixel the tap
    needs, or zeros where that lies outside the image (the SAME halo)."""
    g = _geometry(plan, layer)
    _, _, _, h, w, _, _ = layer
    items = _items(plan, layer, g)
    picks = items if len(items) <= 6 else items[[0, len(items) // 2, -1]]
    o = (ctypes.c_int * 36)()
    for _, band, seg, prows, sw, x0, q, tiles in picks:
        for tile in range(tiles):
            for y, x in _tile(plan, layer, band, seg, tile):
                if y < 0:
                    continue
                assert plan.plan_taps(*_args(layer), ctypes.c_int(band), ctypes.c_int(seg),
                                      ctypes.c_int(y), ctypes.c_int(x), o) == 0
                for t, (sr, sc, sy, sx) in enumerate(np.array(o).reshape(9, 4)):
                    assert 0 <= sr < 2 * prows + 2 and 0 <= sc < g["lead"] + sw + 1
                    assert sc < g["cols"] and sr < g["rows"]
                    yy, xx = y + t // 3 - 1, x + t % 3 - 1
                    inside = 0 <= yy < h and 0 <= xx < w
                    assert (sy, sx) == ((yy, xx) if inside else (-1, -1))


@pytest.mark.parametrize("layer", PLAN_LAYERS)
def test_the_plan_fits_and_takes_the_fast_paths(plan, layer):
    """Shared memory within a CTA's share of the SM (three CTAs at N 16
    and 32, two at 64, one at 128);
    yolov2-tiny-voc's L0 on the
    planes and the recast, L1-L3 on 16-byte copies of channels-last maps,
    one segment each."""
    g = _geometry(plan, layer)
    _, ic, oc, h, w, lay, aligned = layer
    # the regions in order, each holding what the kernel puts there: the
    # weights, the bias, two raw buffers of three planes' staged rows, the
    # staging (one behind raw planes, else two) of every staged pixel, an
    # item's pooled output where it leaves by bulk copy (N 16 and 32, oc %
    # 16 == 0)
    pix = 4 if g["mode"] == 0 else g["cp"]
    assert g["off_bias"] >= g["w_bytes"] and g["off_raw"] >= g["off_bias"] + 4 * g["n"]
    assert g["raw_bytes"] >= (3 * g["rows"] * w if g["load"] == 0 else 0)
    assert g["off_stage"] == g["off_raw"] + 2 * g["raw_bytes"]
    assert g["stage_bytes"] >= g["rows"] * g["cols"] * pix and g["stage_bytes"] % 128 == 0
    assert g["stages"] == (1 if g["load"] == 0 else 2)
    assert g["off_out"] == g["off_stage"] + g["stages"] * g["stage_bytes"]
    assert g["out_bytes"] == (-(-g["band"] * g["seg_w"] // 2 * oc // 128) * 128
                              if oc % 16 == 0 and g["n"] <= 32 else 0)
    assert g["smem"] == g["off_out"] + g["out_bytes"]
    ctas = {16: 3, 32: 3, 64: 2, 128: 1}[g["n"]]
    assert g["smem"] <= (232448 if ctas == 1 else 233472 // ctas - 1024)
    assert g["n"] >= oc
    assert g["steps"] % g["kg"] == 0 and g["w_bytes"] == g["steps"] * 32 * g["n"]
    assert g["band"] * g["seg_w"] <= 2048 or g["band"] == 1
    if (ic, oc, h, lay) in YOLO_LAYERS + YOLO_320:
        assert g["segs"] == 1 and g["seg_w"] == w
        assert (g["mode"], g["load"]) == ((0, 0) if ic == 3 else (1, 1))
        assert g["steps"] == {3: 1, 16: 5, 32: 9, 64: 18}[ic]
    if not aligned or lay == 2:
        assert g["load"] == 2


@pytest.mark.parametrize("layer", [
    (2, 3, 16, 27, 28, 0, 1),    # odd H
    (2, 3, 16, 28, 27, 0, 1),    # odd W
    (2, 128, 16, 28, 28, 1, 1),  # ic 128: the streamed kernel's
    (2, 0, 16, 28, 28, 1, 1),    # no channel
    (2, 16, 129, 28, 28, 1, 1),  # oc past the widest N
    (2, 16, 0, 28, 28, 1, 1),    # no output channel
    (-1, 16, 16, 28, 28, 1, 1),  # a negative batch
])
def test_the_plan_refuses(plan, layer):
    assert _geometry(plan, layer) is None
    _, ic, oc, h, w, _, _ = layer
    assert not region_layer.takes(ic, oc, h, w) or layer[0] < 0


def test_takes_is_the_plans_rule(plan):
    """The wrapper's ``takes`` and the plan refuse the same geometries."""
    for ic in (1, 2, 3, 4, 17, 64, 127, 128):
        for oc in (1, 7, 16, 100, 128, 129):
            for h, w in ((2, 2), (4, 6), (5, 6), (6, 5), (26, 26), (416, 416)):
                assert region_layer.takes(ic, oc, h, w) == (
                    _geometry(plan, (1, ic, oc, h, w, 1, 1)) is not None), (ic, oc, h, w)


# ── the packing and the wrapper on the CPU ────────────────────────────


def _numpy_pack(kernel):
    """``pack_layer``'s docstring, byte by byte in numpy."""
    oc, ic = kernel.shape[:2]
    n = next(v for v in (16, 32, 64, 128) if oc <= v)
    if ic <= 3:
        krow, cp = 9 * ic, ic
    else:
        cp = 16
        while cp < ic:
            cp *= 2
        krow = 9 * cp
    kp = -(-krow // 32) * 32
    bmat = np.zeros((kp, n), np.int8)
    for k in range(krow):
        tap, c = divmod(k, cp)
        if c < ic:
            bmat[k, :oc] = kernel[:, c, tap // 3, tap % 3]
    out = np.zeros(kp * n, np.int8)
    ng = n // 8
    for s in range(kp // 32):
        for n8 in range(ng):
            for h in range(2):
                for r in range(8):
                    for j in range(16):
                        out[((s * ng + n8) * 2 + h) * 128 + 16 * r + j] = \
                            bmat[32 * s + 16 * h + j, 8 * n8 + r]
    return out


@pytest.mark.parametrize("oc,ic", [(16, 3), (32, 16), (64, 32), (128, 64), (8, 1), (7, 5),
                                   (24, 2), (100, 100), (128, 127)])
def test_the_packing_against_numpy(oc, ic):
    kernel = np.random.RandomState(oc * 131 + ic).randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
    got = region_layer.pack_layer(torch.from_numpy(kernel))
    assert tuple(got.shape) == region_layer.packed_shape(torch.from_numpy(kernel))
    assert np.array_equal(got.numpy(), _numpy_pack(kernel))


def test_the_plain_version_on_the_cpu():
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.randint(0, 256, (2, 5, 10, 12)).astype(np.uint8))
    k = torch.from_numpy(rs.randint(-40, 41, (7, 5, 3, 3)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-5000, 5000, 7).astype(np.int32))
    shifts = torch.tensor([2, 6], dtype=torch.int32)
    got = region_layer.region_layer(x, k, b, shifts, 1)
    assert torch.equal(got, conv_stream.region_layer_reference(x, k, b, shifts, 1, 2, False))
    assert tuple(got.shape) == (2, 7, 5, 6)
    packed = region_layer.pack_layer(k)
    assert torch.equal(region_layer.region_layer(x, k, b, shifts, 1, packed=packed), got)


@pytest.mark.parametrize("case", ["odd map", "ic 128", "oc 129", "int32 x", "5x5 kernel",
                                  "bias shape", "packed shape", "layer past shifts"])
def test_the_wrapper_refuses(case):
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randint(0, 256, (1, 4, 8, 8)).astype(np.uint8))
    k = torch.from_numpy(rs.randint(-8, 9, (8, 4, 3, 3)).astype(np.int8))
    b = torch.zeros(8, dtype=torch.int32)
    shifts = torch.tensor([3], dtype=torch.int32)
    kw = {}
    if case == "odd map":
        x = x[:, :, :7]
    elif case == "ic 128":
        x = torch.zeros((1, 128, 8, 8), dtype=torch.uint8)
        k = torch.zeros((8, 128, 3, 3), dtype=torch.int8)
    elif case == "oc 129":
        k = torch.zeros((129, 4, 3, 3), dtype=torch.int8)
        b = torch.zeros(129, dtype=torch.int32)
    elif case == "int32 x":
        x = x.to(torch.int32)
    elif case == "5x5 kernel":
        k = torch.zeros((8, 4, 5, 5), dtype=torch.int8)
    elif case == "bias shape":
        b = torch.zeros(7, dtype=torch.int32)
    elif case == "packed shape":
        kw["packed"] = torch.zeros(16, dtype=torch.int8)
    else:
        shifts = torch.tensor([], dtype=torch.int32)
    with pytest.raises(ValueError):
        region_layer.region_layer(x, k, b, shifts, 0, **kw)


# ── the engine's routes ──────────────────────────────────────────────


def test_the_engine_runs_l0_l3_on_the_new_kernel(monkeypatch):
    """yolov2-tiny-voc's routes: L0-L3 "layer" (``region_layer``), L4-L8
    "stream"; the engine's net calls ``region_layer.region_layer`` for
    each "layer" layer, in order, and ``conv_stream`` for the rest."""
    routes = region_routes(YOLO.specs)
    assert routes == ["layer"] * 4 + ["stream"] * 5
    calls = []
    real_layer, real_stream = region_layer.region_layer, conv_stream.conv_stream
    monkeypatch.setattr(region_layer, "region_layer",
                        lambda x, k, b, s, i, **kw: calls.append(("layer", i))
                        or real_layer(x, k, b, s, i, **kw))
    monkeypatch.setattr(conv_stream, "conv_stream",
                        lambda x, k, b, s, i, **kw: calls.append(("stream", i))
                        or real_stream(x, k, b, s, i, **kw))
    cfg = RegionConfig(layer_configs=((3, 16, 32, 3, 2), (16, 32, 16, 3, 2),
                                      (32, 128, 8, 3, 2), (128, 16, 4, 1, 0)),
                       anchors=((1.0, 1.0), (2.0, 2.0)), num_classes=3, max_det=5)
    model = _seeded_model(cfg, 0)
    engine = RegionEngine(model, "cpu")
    engine.region_maps(torch.zeros((1, 3, 32, 32), dtype=torch.uint8))
    assert calls == [("layer", 0), ("layer", 1), ("layer", 2), ("stream", 3)]
    assert [r for r, _ in engine._routes] == ["layer"] * 3 + ["stream"]


def _seeded_model(cfg, seed, shift=4):
    rs = np.random.RandomState(seed)
    kernels, biases, shifts = [], [], []
    for ic, oc, _, k, _ in cfg.specs:
        kernel, bias, s = kc._region_weights(rs, ic, oc, k)
        kernels.append(kernel)
        biases.append(bias)
        shifts.append(s)
    shifts[-1] = shift
    return RegionModel(kernels, biases, shifts, cfg)


# ── on the card: the kernel ───────────────────────────────────────────


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the region route's layer kernel has "
                    "no CPU or interpret mode (on the card: python -m pytest -m cuda "
                    "tests/test_torch_region_layer.py)")
    return torch.device("cuda")


def _card_case(dev, rs, batch, ic, oc, s, layout, layer=0, block=32):
    """The kernel against the plain layer on one seeded map: bit for bit,
    its output channels-last."""
    kernel, bias, shift = kc._region_weights(rs, ic, oc, 3)
    x = torch.from_numpy(rs.randint(0, 256, (batch, ic, s, s)).astype(np.uint8)).to(dev)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    kt, bt = torch.from_numpy(kernel).to(dev), torch.from_numpy(bias).to(dev)
    shifts = torch.tensor([0] * layer + [shift], dtype=torch.int32, device=dev)
    got = region_layer.region_layer(x, kt, bt, shifts, layer)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert tuple(got.shape) == (batch, oc, s // 2, s // 2)
    for lo in range(0, batch, block):
        want = conv_stream.region_layer_reference(x[lo:lo + block], kt, bt, shifts, layer, 2,
                                                  False)
        assert torch.equal(got[lo:lo + block], want), (ic, oc, s, lo)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5, 512])
@pytest.mark.parametrize("i", range(4))
def test_yolo_layers_bit_for_bit_on_card(cuda_device, i, batch):
    """L0-L3 of yolov2-tiny-voc as the engine hands them over (frames NCHW,
    then channels-last maps), at batches 1, 5 and the cell's 512."""
    ic, oc, s, _, _ = YOLO.specs[i]
    _card_case(cuda_device, np.random.RandomState(100 * i + batch), batch, ic, oc, s,
               "nchw" if i == 0 else "channels_last", layer=i)


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(4))
def test_yolo_rows_at_320_on_card(cuda_device, i):
    """A second frame size: yolov2-tiny-voc's rows at 320x320 (L1-L3 read
    maps 160, 80 and 40 wide)."""
    ic, oc, s, _, _ = YOLO.specs[i]
    s = s * 320 // 416
    _card_case(cuda_device, np.random.RandomState(7 + i), 6, ic, oc, s,
               "nchw" if i == 0 else "channels_last", layer=i)


@pytest.mark.cuda
@pytest.mark.parametrize("ic,oc,s,layout", [(1, 8, 28, "nchw"), (5, 7, 14, "nchw"),
                                             (5, 24, 22, "channels_last"),
                                             (127, 128, 12, "channels_last"),
                                             (48, 48, 26, "channels_last"),
                                             (16, 32, 30, "nchw")])
def test_other_channel_counts_on_card(cuda_device, ic, oc, s, layout):
    """One channel, odd channel counts, past 64 and 16-channel maps in
    NCHW: the same kernel, bit for bit."""
    _card_case(cuda_device, np.random.RandomState(ic * oc + s), 3, ic, oc, s, layout)


@pytest.mark.cuda
def test_one_and_odd_channels_through_the_engine_on_card(cuda_device):
    """A region model whose L0 takes one channel and L1 five, through
    ``RegionEngine``'s route: every map bit-equal to the plain layer on
    the one before, the detections the plain head's."""
    cfg = RegionConfig(layer_configs=((1, 5, 32, 3, 2), (5, 128, 16, 3, 2),
                                      (128, 16, 8, 1, 0)),
                       anchors=((1.0, 1.0), (2.0, 2.0)), num_classes=3, max_det=5)
    model = _seeded_model(cfg, 1)
    engine = RegionEngine(model, cuda_device)
    assert [r for r, _ in engine._routes] == ["layer", "layer", "stream"]
    frames = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (9, 1, 32, 32)).astype(np.uint8)).to(cuda_device)
    _maps_and_dets_agree(engine, model, frames)


def _maps_and_dets_agree(engine, model, frames, block=64):
    net, cfg = engine.net, model.config
    maps = engine.region_maps(frames)
    for i, (spec, got) in enumerate(zip(cfg.specs, maps)):
        x = frames if i == 0 else maps[i - 1]
        for lo in range(0, frames.shape[0], block):
            want = conv_stream.region_layer_reference(
                x[lo:lo + block], net.kernels[i], net.biases[i], net.shifts, i, spec[4],
                i == len(cfg.specs) - 1)
            assert torch.equal(got[lo:lo + block], want), (i, lo)
    _, _, dets, count = engine.detect_device(frames)
    want = region_head.region_detect_reference(
        maps[-1], net.shifts, len(cfg.specs) - 1, net.anchors, cfg.num_classes, cfg.thresh,
        cfg.nms, cfg.max_det)
    kc.region_dets_agree((dets, count), want, cfg.nms)


@pytest.mark.cuda
def test_the_engine_on_yolov2_tiny_voc_on_card(cuda_device):
    """yolov2-tiny-voc (seeded weights): ``region_maps`` equal to the plain
    layers, L4 (the streamed kernel on L3's channels-last map) included,
    and the dets and counts the reference's."""
    model = kc.yolo_model(11)
    engine = RegionEngine(model, cuda_device)
    frames = torch.from_numpy(np.random.RandomState(12).randint(
        0, 256, (24, 3, 416, 416)).astype(np.uint8)).to(cuda_device)
    maps = engine.region_maps(frames)
    assert all(m.is_contiguous(memory_format=torch.channels_last) for m in maps[:4])
    del maps
    _maps_and_dets_agree(engine, model, frames, block=8)
