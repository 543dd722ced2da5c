"""The region-head detectors (``models.region``; yolov2-tiny-voc in
``registry.DETECTORS``) on the CPU: the engine's plain path against the
plain reference ``tpu_cnn_torch/reference/yolov2_tiny.py`` on a tiny net
with every layer kind of yolov2-tiny-voc (3 input channels, kernels 3 and
1, pools 2x2/2, 2x2/1 and none, biases, an odd last map, the region
head), the pools and the 1x1 layer on their own, NMS against a naive
O(n^2) ``do_nms_sort`` (ties included), the streamed kernel's packing, the
bundle, and the registry's geometry. The kernels themselves are held to
these plain versions on the card (``apps.kernel_cases``)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine, RegionResult, region_routes  # noqa: E402
from tpu_cnn_torch.engine.region import RegionEngine  # noqa: E402
from tpu_cnn_torch.models import registry  # noqa: E402
from tpu_cnn_torch.models.cnn import CNNConfig  # noqa: E402
from tpu_cnn_torch.models.region import (RegionConfig, RegionModel,  # noqa: E402
                                         layer_spec)
from tpu_cnn_torch.ops import conv_stream, int8, quant, region_head  # noqa: E402
from tpu_cnn_torch.reference import yolov2_tiny as ref  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402
from tpu_cnn_torch.utils.paths import default_artifacts  # noqa: E402

# 3x28x28 -> 14 -> 7 (2x2/2 twice), 7x7 with the 2x2/1 pool, an unpooled
# 3x3, a 1x1 to 2 anchors x (5 + 3 classes): the 7x7 grid
TINY = RegionConfig(layer_configs=((3, 8, 28, 3, 2), (8, 16, 14, 3, 2), (16, 32, 7, 3, 1),
                                   (32, 32, 7, 3, 0), (32, 16, 7, 1, 0)),
                    anchors=((1.0, 1.5), (3.0, 2.0)), num_classes=3, max_det=10)
SHIFTS = (7, 10, 11, 12, 12)


def _layer_weights(rs, h, spec, shift, last):
    """A seeded kernel and bias whose sums of ``h`` spread about 64 steps
    of the output, its 35th percentile at 0 (the bundle maker's recipe,
    shorter); the last layer's t spread about 1, centred, its objectness
    at -1."""
    ic, oc, _, k, _ = spec
    z = rs.standard_normal((oc, ic, k, k)) + (0.0 if last else 1.0)
    zero = torch.zeros(oc, dtype=torch.int32)
    spread = float(ref.layer_sums(h, torch.from_numpy(z), zero, k).std(dim=(0, 2, 3)).mean())
    sigma = (1.0 if last else 64.0) * 2 ** shift / spread
    w = np.clip(np.round(sigma * z), -127, 127).astype(np.int8)
    sums = ref.layer_sums(h, torch.from_numpy(w), zero, k).permute(1, 0, 2, 3).reshape(oc, -1)
    b = (-torch.quantile(sums, 0.5 if last else 0.35, dim=1)).round().numpy().astype(np.int32)
    if last:
        b[4::8] -= 2 ** shift
    return w, b


def tiny_model(seed: int = 0, config: RegionConfig = TINY, shifts=SHIFTS) -> RegionModel:
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randint(0, 256, (2, 3, 28, 28)).astype(np.float64))
    kernels, biases = [], []
    for i, (spec, s) in enumerate(zip(config.specs, shifts)):
        last = i == len(config.specs) - 1
        w, b = _layer_weights(rs, h, spec, s, last)
        kernels.append(w)
        biases.append(b)
        if not last:
            sums = ref.layer_sums(h, torch.from_numpy(w), torch.from_numpy(b), spec[3])
            h = ref.pool(torch.clamp(torch.floor(sums / 2 ** s), 0, 255), spec[4])
    return RegionModel(kernels, biases, shifts, config, ["a", "b", "c"])


def _frames(n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, 28, 28)).astype(np.uint8)


def _reference(model, frames):
    cfg = model.config
    return ref.detect(torch.from_numpy(frames), [torch.from_numpy(k) for k in model.kernels],
                      [torch.from_numpy(b) for b in model.biases], list(model.shifts),
                      cfg.specs, cfg.anchors, cfg.num_classes, cfg.thresh, cfg.nms,
                      cfg.max_det)


@pytest.fixture(scope="module")
def model():
    return tiny_model()


# ── the registry and the layer rows ──────────────────────────────────


def test_the_registry_geometry():
    cfg = registry.get_config("yolov2-tiny-voc")
    assert cfg.macs() == 3_485_520_896
    assert cfg.weight_bytes() == 15_855_536
    assert (cfg.in_channels, cfg.img_size, cfg.grid) == (3, 416, 13)
    assert [s[3:] for s in cfg.specs] == [(3, 2)] * 5 + [(3, 1), (3, 0), (3, 0), (1, 0)]
    assert cfg.specs[-1][1] == cfg.num_anchors * cfg.entries == 125
    assert "yolov2-tiny-voc" not in registry.REGISTRY  # the JAX package's copy
    with pytest.raises(KeyError, match="unknown model variant"):
        registry.get_config("yolov2-tiny-coco")


def test_the_old_rows_mean_a_3x3_and_the_2x2_pool():
    assert layer_spec((1, 16, 128)) == (1, 16, 128, 3, 2)
    assert layer_spec([16, 32, 64, 1, 0]) == (16, 32, 64, 1, 0)
    cam = registry.get_config("lyr3-std")
    assert isinstance(cam, CNNConfig) and cam.layer_configs[0] == (1, 16, 128)
    mixed = RegionConfig(layer_configs=((3, 8, 16), (8, 16, 8, 1, 0)),
                         anchors=((1.0, 1.0), (2.0, 2.0)), num_classes=3)
    assert mixed.specs == [(3, 8, 16, 3, 2), (8, 16, 8, 1, 0)]
    assert mixed.macs() == 16 * 16 * 8 * 3 * 9 + 8 * 8 * 16 * 8


@pytest.mark.parametrize("rows", [((3, 8, 16, 3, 2), (8, 16, 16, 1, 0)),  # no chain
                                  ((3, 16, 8, 3, 1),),  # a pool on the last
                                  ((3, 8, 8, 2, 0),),  # k 2
                                  ((3, 17, 8, 1, 0),)])  # not A x (5 + C)
def test_a_config_refuses_what_does_not_chain(rows):
    with pytest.raises(ValueError):
        RegionConfig(layer_configs=rows, anchors=((1.0, 1.0), (2.0, 2.0)), num_classes=3)


# ── the layers' plain versions ───────────────────────────────────────


def test_the_stride_1_pool_at_the_right_and_bottom_edges():
    x = (torch.arange(2 * 3 * 5 * 5, dtype=torch.int64).reshape(2, 3, 5, 5) % 17).double()
    got = ref.pool(x, 1)
    want = torch.empty_like(x)
    for y in range(5):
        for c in range(5):
            want[..., y, c] = x[..., y:y + 2, c:c + 2].amax(dim=(-2, -1))
    assert torch.equal(got, want)
    assert torch.equal(got[..., -1, -1], x[..., -1, -1])  # the corner is its own
    # the right column pools down the column alone, the bottom row along it
    assert torch.equal(got[..., :-1, -1], x[..., :-1, -1].maximum(x[..., 1:, -1]))
    assert torch.equal(got[..., -1, :-1], x[..., -1, :-1].maximum(x[..., -1, 1:]))
    even = x[..., :4, :4]
    assert torch.equal(ref.pool(even, 2), quant.maxpool2x2(even))
    assert torch.equal(ref.pool(x, 0), x)


def test_the_1x1_layer():
    rs = np.random.RandomState(4)
    x = torch.from_numpy(rs.randint(0, 256, (3, 16, 5, 5)).astype(np.uint8))
    k = torch.from_numpy(rs.randint(-128, 128, (7, 16, 1, 1)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-2**20, 2**20, 7).astype(np.int32))
    shifts = torch.tensor([3, 9], dtype=torch.int32)
    sums = torch.einsum("bihw,oi->bohw", x.long(), k[:, :, 0, 0].long()) + b.long()[:, None, None]
    got = conv_stream.conv_stream(x, k, b, shifts, 1, last=True)
    assert got.dtype == torch.int32 and torch.equal(got.long(), sums)
    got = conv_stream.conv_stream(x, k, b, shifts, 1)
    assert torch.equal(got, torch.clamp(torch.div(sums, 2 ** 9, rounding_mode="floor"),
                                        0, 255).to(torch.uint8))


def test_the_layer_kernels_bias_path_on_the_cpu():
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randint(0, 256, (2, 3, 10, 12)).astype(np.uint8))
    k = torch.from_numpy(rs.randint(-40, 41, (8, 3, 3, 3)).astype(np.int8))
    b = torch.from_numpy(rs.randint(-5000, 5000, 8).astype(np.int32))
    shifts = torch.tensor([6], dtype=torch.int32)
    got = int8.fused_conv_layer(x, k, shifts, 0, bias=b)
    want = ref.pool(torch.clamp(torch.floor(ref.layer_sums(x, k, b, 3) / 64), 0, 255), 2)
    assert torch.equal(got, want.to(torch.uint8))
    # no bias: the contract layer as before
    assert torch.equal(int8.fused_conv_layer(x, k, shifts, 0),
                       int8.fused_conv_layer(x, k, shifts, 0, bias=torch.zeros_like(b)))
    with pytest.raises(ValueError):  # the one-channel path takes no bias
        int8.fused_conv_layer(x[:, :1], k[:, :1], shifts, 0, bias=b)


@pytest.mark.parametrize("oc,ic,k", [(256, 128, 3), (125, 1024, 1), (130, 256, 3)])
def test_the_streamed_packing(oc, ic, k):
    """``pack_stream``'s bytes hold B[slice K][channel] where its docstring
    says (a 128-byte row per channel, its 16-byte chunks in the 128-byte
    swizzle), zero past oc."""
    kernel = torch.from_numpy(np.random.RandomState(oc).randint(
        -128, 128, (oc, ic, k, k)).astype(np.int8))
    packed = conv_stream.pack_stream(kernel)
    assert tuple(packed.shape) == conv_stream.stream_shape(kernel)
    rows, slices = -(-oc // 256) * 256, k * k * ic // 128
    p = packed.view(slices, rows, 8, 16)
    b = torch.empty((rows, slices, 8, 16), dtype=torch.int8)
    for n in range(rows):
        for j in range(8):
            b[n, :, j] = p[:, n, j ^ n % 8]
    b = b.reshape(rows, k * k * ic)
    assert torch.equal(b[:oc], kernel.permute(0, 2, 3, 1).reshape(oc, -1))
    assert not b[oc:].any()
    with pytest.raises(ValueError):
        conv_stream.pack_stream(kernel[:, :64])


# ── the streamed kernel's plan (csrc/conv_stream_plan.h, built by g++) ──

_PLAN_SHIM = r"""
#include "conv_stream_plan.h"
using namespace stream_plan;
#define LAYER int batch, int ic, int oc, int h, int w, int k, int pool, int linear, int nhwc
#define GEOMETRY Geometry g; if (make_geometry(batch, ic, oc, h, w, k, pool, linear, nhwc, &g)) return 1;
extern "C" int plan_geometry(LAYER, long long* o) {
  GEOMETRY
  const long long v[] = {g.tile_m, g.tile_n, g.n_tiles, g.np, g.m_rows, g.m_tiles, g.units,
                         g.staging_rows, g.tma, g.slices, g.pad, staging_pixels(g.mode)};
  for (int i = 0; i < 12; ++i) o[i] = v[i];
  return 0;
}
extern "C" int plan_rows(LAYER, long long mt, int* o) {
  GEOMETRY
  for (int r = 0; r < g.tile_m; ++r) row_pixel(g, mt, r, o[3 * r], o[3 * r + 1], o[3 * r + 2]);
  return 0;
}
extern "C" int plan_slabs(LAYER, long long mt, int* o) {
  GEOMETRY
  for (int j = 0; j < consumers(g.mode); ++j) slab_start(g, mt, j, o[3 * j], o[3 * j + 1], o[3 * j + 2]);
  return 0;
}
extern "C" int plan_source_rows(LAYER, long long mt, int* o) {
  GEOMETRY
  tile_source_rows(g, mt, o[0], o[1]);
  return 0;
}
extern "C" int plan_units(LAYER, long long* o) {
  GEOMETRY
  for (long long u = 0; u < g.units; ++u) {
    int nt;
    unit_tile(g, u, o[2 * u], nt);
    o[2 * u + 1] = nt;
  }
  return 0;
}
extern "C" int plan_box(LAYER, unsigned long long* dims, unsigned long long* strides,
                        int* lower, int* upper) {
  GEOMETRY
  im2col_box(g, dims, strides, lower, upper);
  return 0;
}
"""


@pytest.fixture(scope="module")
def plan(tmp_path_factory):
    """The plan header built alone by g++ behind a C shim, bound by ctypes."""
    import ctypes
    import os
    import subprocess

    from tpu_cnn_torch.ops import _build

    d = tmp_path_factory.mktemp("plan")
    src, lib = d / "plan.cpp", d / "libplan.so"
    src.write_text(_PLAN_SHIM)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-I", _build.CSRC_DIR,
                    "-o", str(lib), str(src)], check=True, capture_output=True)
    assert os.path.exists(lib)
    return ctypes.CDLL(str(lib))


def _plan_call(plan, fn, layer, *args):
    import ctypes
    return getattr(plan, fn)(*(ctypes.c_int(v) for v in layer), *args)


def _geometry(plan, layer):
    import ctypes
    o = (ctypes.c_longlong * 12)()
    if _plan_call(plan, "plan_geometry", layer, o):
        return None
    keys = ("tile_m", "tile_n", "n_tiles", "np", "m_rows", "m_tiles", "units",
            "staging_rows", "tma", "slices", "pad", "staging_pixels")
    return dict(zip(keys, o))


# (batch, ic, oc, h, w, k, pool, linear, nhwc): yolov2-tiny-voc's L4-L8 as
# the engine hands them over, each also in the other memory format, at the
# cells' and the cases' batches; the kernel cases' edges
YOLO_STREAMED = [(128, 256, 26, 3, 2, 0), (256, 512, 13, 3, 1, 0), (512, 1024, 13, 3, 0, 0),
                 (1024, 1024, 13, 3, 0, 0), (1024, 125, 13, 1, 0, 1)]
PLAN_LAYERS = [(b, ic, oc, s, s, k, pool, lin, nhwc)
               for b in (1, 37, 512) for ic, oc, s, k, pool, lin in YOLO_STREAMED
               for nhwc in (0, 1)] + [
    (3, 128, 130, 26, 26, 3, 2, 0, 0), (3, 128, 130, 13, 13, 3, 1, 0, 1),
    (3, 128, 130, 13, 13, 3, 0, 0, 1), (2, 128, 64, 6, 10, 3, 2, 0, 1)]


@pytest.mark.parametrize("layer", [
    (2, 64, 32, 13, 13, 3, 0, 0, 1),     # ic not a multiple of 128
    (2, 128, 32, 13, 13, 5, 0, 0, 1),    # k 5
    (2, 128, 32, 13, 13, 3, 2, 0, 1),    # the 2x2/2 pool on an odd map
    (2, 128, 32, 14, 14, 3, 1, 0, 1),    # the 2x2/1 pool past one tile's 192 rows
    (2, 128, 32, 13, 13, 3, 1, 1, 1),    # a pool on the linear layer
    (2, 128, 31, 13, 13, 3, 0, 0, 1),    # an odd oc of u8 outputs
    (2, 128, 32, 52, 52, 3, 0, 0, 0),    # an NCHW tile's source rows past the staging
    (2, 128, 32, 52, 52, 3, 2, 0, 1),    # the same for the 2x2/2 pool's gather
])
def test_the_streamed_plan_refuses(plan, layer):
    """A geometry the kernel does not take is refused by the plan (the
    launcher then returns cudaErrorInvalidValue, and the wrapper raises)."""
    assert _geometry(plan, layer) is None


def test_the_streamed_plan_takes_a_wide_channels_last_map(plan):
    """A channels-last map goes by TMA, which stages nothing: any width."""
    g = _geometry(plan, (2, 128, 32, 52, 52, 3, 0, 0, 1))
    assert g is not None and g["tma"] and g["staging_rows"] == 0


@pytest.mark.parametrize("layer", PLAN_LAYERS)
def test_the_streamed_schedule_covers_every_tile_once(plan, layer):
    """The work units of the persistent grid give every (M tile, N tile)
    once, N fastest."""
    import ctypes
    g = _geometry(plan, layer)
    assert g is not None
    assert g["units"] == g["m_tiles"] * g["n_tiles"]
    o = (ctypes.c_longlong * (2 * g["units"]))()
    assert _plan_call(plan, "plan_units", layer, o) == 0
    tiles = np.array(o, dtype=np.int64).reshape(g["units"], 2)
    want = np.stack(np.meshgrid(np.arange(g["m_tiles"]), np.arange(g["n_tiles"]),
                                indexing="ij"), axis=-1).reshape(-1, 2)
    assert (tiles == want).all()
    assert g["tile_n"] * g["n_tiles"] >= layer[2] and g["np"] % 256 == 0
    assert g["np"] >= g["tile_n"] * g["n_tiles"]


def _rows(plan, layer, g, mt):
    import ctypes
    o = (ctypes.c_int * (3 * g["tile_m"]))()
    assert _plan_call(plan, "plan_rows", layer, ctypes.c_longlong(mt), o) == 0
    return np.array(o).reshape(-1, 3)


def _tiles(g):
    """Every M tile of a small grid, else its first, last and a few."""
    n = g["m_tiles"]
    return range(n + 1) if n <= 40 else sorted({0, 1, n // 2, n - 2, n - 1, n})


def _want_rows(layer, g, mt):
    """Which pixel each M row of tile ``mt`` is, from the kernel's
    contract: the batch's pixels in order, pooling windows of four rows in
    order for the 2x2/2 pool, one image a tile for the 2x2/1 pool."""
    batch, _, _, h, w, _, pool, _, _ = layer
    out = np.full((g["tile_m"], 3), -1)
    for r in range(g["tile_m"]):
        if pool == 1:
            if mt < batch and r < h * w:
                out[r] = (mt, r // w, r % w)
            continue
        row = mt * g["tile_m"] + r
        if row >= g["m_rows"]:
            continue
        if pool == 2:
            q, sub = divmod(row, 4)
            b, p = divmod(q, (h // 2) * (w // 2))
            out[r] = (b, 2 * (p // (w // 2)) + sub // 2, 2 * (p % (w // 2)) + sub % 2)
        else:
            b, p = divmod(row, h * w)
            out[r] = (b, p // w, p % w)
    return out


@pytest.mark.parametrize("layer", PLAN_LAYERS)
def test_the_rows_of_a_tile_are_its_pixels(plan, layer):
    g = _geometry(plan, layer)
    for mt in _tiles(g):
        assert (_rows(plan, layer, g, mt) == _want_rows(layer, g, mt)).all(), mt


@pytest.mark.parametrize("layer", [lay for lay in PLAN_LAYERS if lay[-1] and lay[6] != 2])
def test_the_im2col_loads_walk_the_rows_pixels(plan, layer):
    """Each slab's TMA im2col load, walked as the copy walks its bounding
    box (its W positions, then H, then the next image), reads row by row
    the pixel the epilogue stores there; the map's tensor geometry."""
    import ctypes
    batch, ic, _, h, w, k, _, _, _ = layer
    g = _geometry(plan, layer)
    assert g["tma"] == 1
    dims, strides = (ctypes.c_ulonglong * 4)(), (ctypes.c_ulonglong * 3)()
    lower, upper = (ctypes.c_int * 2)(), (ctypes.c_int * 2)()
    assert _plan_call(plan, "plan_box", layer, dims, strides, lower, upper) == 0
    assert list(dims) == [ic, w, h, batch]
    assert list(strides) == [ic, w * ic, h * w * ic]
    pad = k // 2
    assert list(lower) == [-pad, -pad]
    # the box spans W x H base positions: a tap's offsets 0 .. k-1 reach the halo
    assert (w - 1 + upper[0]) - lower[0] + 1 == w and (h - 1 + upper[1]) - lower[1] + 1 == h
    slabs = g["tile_m"] // 64
    for mt in _tiles(g):
        o = (ctypes.c_int * (3 * slabs))()
        assert _plan_call(plan, "plan_slabs", layer, ctypes.c_longlong(mt), o) == 0
        want = _want_rows(layer, g, mt)
        for j, (b, y, x) in enumerate(np.array(o).reshape(-1, 3)):
            for i in range(64):  # the copy's walk from the slab's start
                r = 64 * j + i
                if want[r][0] >= 0:
                    assert (b, y, x) == tuple(want[r]), (mt, j, i)
                x += 1
                if x == w:
                    x, y = 0, y + 1
                if y == h:
                    y, b = 0, b + 1


@pytest.mark.parametrize("layer", [lay for lay in PLAN_LAYERS if not (lay[-1] and lay[6] != 2)])
def test_the_staged_rows_hold_every_tap_of_a_tile(plan, layer):
    """Where the producer warps gather A, a tile's staged source rows hold
    every in-map pixel any tap of its rows reads, and fit the staging."""
    import ctypes
    _, _, _, h, w, k, _, _, _ = layer
    g = _geometry(plan, layer)
    assert not g["tma"] and g["staging_rows"] * w <= g["staging_pixels"]
    pad = k // 2
    for mt in _tiles(g):
        o = (ctypes.c_int * 2)()
        assert _plan_call(plan, "plan_source_rows", layer, ctypes.c_longlong(mt), o) == 0
        lo, hi = o
        assert hi - lo + 1 <= g["staging_rows"]
        for b, y, x in _rows(plan, layer, g, mt):
            if b < 0:
                continue
            for dy in range(-pad, pad + 1):
                if 0 <= y + dy < h:
                    assert lo <= b * h + y + dy <= hi, (mt, b, y, dy)


# ── the region head ──────────────────────────────────────────────────


def naive_nms_sort(boxes, scores, nms):
    """darknet's ``do_nms_sort`` as written, on lists: per class the
    candidates sorted by score (ties by index), each surviving one zeroing
    the later ones whose ``box_iou`` exceeds ``nms``."""
    scores = [list(s) for s in scores]
    n, c = len(scores), len(scores[0])

    def iou(a, b):
        def overlap(c1, w1, c2, w2):
            return min(c1 + w1 / 2, c2 + w2 / 2) - max(c1 - w1 / 2, c2 - w2 / 2)
        w = overlap(a[0], a[2], b[0], b[2])
        h = overlap(a[1], a[3], b[1], b[3])
        inter = 0.0 if w < 0 or h < 0 else w * h
        return inter / (a[2] * a[3] + b[2] * b[3] - inter)

    for k in range(c):
        order = sorted(range(n), key=lambda i: (-scores[i][k], i))
        for a, i in enumerate(order):
            if scores[i][k] == 0:
                continue
            for j in order[a + 1:]:
                if iou(boxes[i], boxes[j]) > nms:
                    scores[j][k] = 0.0
    return scores


def _nms_case(seed, n=40, c=3):
    rs = np.random.RandomState(seed)
    boxes = np.concatenate([rs.uniform(0.3, 0.7, (n, 2)), rs.uniform(0.05, 0.4, (n, 2))],
                           axis=1)
    scores = rs.choice([0.0, 0.01, 0.02, 0.3, 0.5, 0.9], size=(n, c))  # many ties
    boxes[5] = boxes[3]  # identical boxes, one score
    scores[5] = scores[3]
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_against_a_naive_do_nms_sort_with_ties(seed):
    boxes, scores = _nms_case(seed)
    want = np.asarray(naive_nms_sort(boxes.tolist(), scores.tolist(), 0.45))
    got = region_head.nms_reference(torch.from_numpy(boxes)[None].float(),
                                    torch.from_numpy(scores)[None].float(), 0.45)[0]
    assert np.array_equal(got.numpy() > 0, want > 0)
    kept = ref.nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.45)
    assert np.array_equal(kept[0].numpy(), want)


def test_the_top_pairs_in_order_of_score_then_index_then_class():
    boxes = torch.rand(1, 4, 4)
    kept = torch.tensor([[[0.5, 0.0], [0.5, 0.9], [0.0, 0.5], [0.1, 0.0]]])
    dets, count = region_head.top_reference(boxes, kept, 4)
    assert count.tolist() == [4]
    assert dets[0, :, 4].tolist() == pytest.approx([0.9, 0.5, 0.5, 0.5])
    # pair (index 1, class 1); then ties by index: (0, 0), (1, 0), (2, 1)
    assert dets[0, :, 5].tolist() == [1.0, 0.0, 0.0, 1.0]
    assert torch.equal(dets[0, 1, :4], boxes[0, 0]) and torch.equal(dets[0, 3, :4], boxes[0, 2])
    dets, count = region_head.top_reference(boxes, kept, 7)  # zero past the count
    assert count.tolist() == [5] and not dets[0, 5:].any()


def test_the_heads_agreement_lets_only_near_ties_through():
    """``kernel_cases.region_dets_agree``: a reorder of near-equal scores
    and a swap at the cut pass; a wrong class or box fails."""
    from tpu_cnn_torch.apps.kernel_cases import region_dets_agree

    want = torch.tensor([[[0.1, 0.1, 0.05, 0.05, 0.9, 0.0],
                          [0.5, 0.5, 0.05, 0.05, 0.4, 1.0],
                          [0.8, 0.8, 0.05, 0.05, 0.3, 2.0],
                          [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]]])
    count = torch.tensor([3], dtype=torch.int32)
    assert region_dets_agree((want.clone(), count), (want, count), 0.45) == (0, 0, 0.0)
    got = want.clone()
    got[0, 1, 4] = got[0, 2, 4] = 0.35  # a near tie, ordered the other way
    w2 = want.clone()
    w2[0, 1, 4] = w2[0, 2, 4] = 0.35 + 1e-7
    got[0, [1, 2]] = got[0, [2, 1]]
    moved, tied, err = region_dets_agree((got, count), (w2, count), 0.45)
    assert (moved, tied) == (1, 0) and 0 < err < 2e-7  # float32 of 1e-7
    cut = want.clone()
    cut[0, 2] = torch.tensor([0.2, 0.7, 0.05, 0.05, 0.3 + 1e-7, 1.0])  # another pair at the cut
    assert region_dets_agree((cut, count), (want, count), 0.45)[1] == 2
    for row, col, value in ((1, 5, 2.0), (0, 0, 0.3)):  # another class; a moved box
        bad = want.clone()
        bad[0, row, col] = value
        with pytest.raises(RuntimeError, match="no counterpart"):
            region_dets_agree((bad, count), (want, count), 0.45)
    with pytest.raises(RuntimeError, match="counts differ"):
        region_dets_agree((want, count), (want, count - 1), 0.45)


# ── the engine's plain path against the reference ────────────────────


def test_the_last_layers_sums_bit_for_bit(model):
    frames = _frames(4)
    engine = CUDAEngine(model, "cpu", backend="pallas", box_mode="region")
    maps = engine.region_maps(torch.from_numpy(frames))
    specs = model.config.specs
    want = ref.forward(torch.from_numpy(frames), [torch.from_numpy(k) for k in model.kernels],
                       [torch.from_numpy(b) for b in model.biases], list(model.shifts), specs)
    assert maps[-1].dtype == torch.int32 and torch.equal(maps[-1].double(), want)
    assert [r for r, _ in engine._routes] == ["layer", "layer"] + ["stream"] * 3


def test_the_region_maps_are_each_layer_on_the_last(model):
    """``region_maps``: one output a layer, each the plain layer of the one
    before, u8 but the last; the detect runs the same layers."""
    frames = torch.from_numpy(_frames(3))
    engine = CUDAEngine(model, "cpu", backend="pallas", box_mode="region")
    maps = engine.region_maps(frames)
    net, specs = engine.net, model.config.specs
    assert len(maps) == len(specs)
    for i, (spec, got) in enumerate(zip(specs, maps)):
        x = frames if i == 0 else maps[i - 1]
        last = i == len(specs) - 1
        assert got.dtype == (torch.int32 if last else torch.uint8)
        assert torch.equal(got, conv_stream.region_layer_reference(
            x, net.kernels[i], net.biases[i], net.shifts, i, spec[4], last))
    want = region_head.region_detect_reference(
        maps[-1], net.shifts, len(specs) - 1, net.anchors, model.config.num_classes,
        model.config.thresh, model.config.nms, model.config.max_det)
    got = engine.detect_device(frames)[2:]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not hasattr(CUDAEngine(load_model(default_artifacts()), "cpu"), "region_maps")


@pytest.mark.parametrize("variant,routes", [
    ("yolov2-tiny-voc", ["layer"] * 4 + ["stream"] * 5),
    ("tiny", ["layer"] * 2 + ["stream"] * 3)])
def test_the_routes_follow_the_streamed_kernels_rule(variant, routes):
    """A pooled 3x3 layer of fewer than 128 input channels, not the last,
    runs on the layer kernel; every other layer on the streamed one."""
    cfg = TINY if variant == "tiny" else registry.get_config(variant)
    assert region_routes(cfg.specs) == routes
    assert [conv_stream.streams(s, i == len(cfg.specs) - 1)
            for i, s in enumerate(cfg.specs)] == [r == "stream" for r in routes]


def test_the_engine_equals_the_reference(model):
    frames = _frames(12)
    engine = CUDAEngine(model, "cpu", backend="pallas", box_mode="region")
    # the region model's own engine, without the CAM family's API
    assert isinstance(engine, RegionEngine)
    for name in ("run_batch", "detect_multi_batch", "features_device"):
        assert not hasattr(engine, name), name
    got = engine.detect_batch(frames)
    assert isinstance(got, RegionResult)
    assert got.dets.shape == (12, 10, 6) and got.dets.dtype == np.float32
    assert got.count.dtype == np.int32
    _, _, want_dets, want_count = _reference(model, frames)
    assert np.array_equal(got.count, want_count.numpy())
    assert got.count.sum() > 40  # the comparison sees detections
    want = want_dets.numpy()
    # the same pairs in the same order: classes equal, the float32 head's
    # boxes and scores within its rounding of the float64 reference's
    assert np.array_equal(got.dets[..., 5], want[..., 5])
    assert np.abs(got.dets[..., 4] - want[..., 4]).max() < 1e-6
    assert np.abs(got.dets[..., :4] - want[..., :4]).max() < 1e-5
    # detect_device hands back (None, None, dets, count)
    out = engine.detect_device(torch.from_numpy(frames))
    assert out[:2] == (None, None)
    assert np.array_equal(out[3].numpy(), got.count)


@pytest.mark.parametrize("backend,box_mode", [("mega", "region"), ("pallas", "ref"),
                                              ("xla", "region")])
def test_the_engine_refuses_another_backend_or_box(model, backend, box_mode):
    with pytest.raises(ValueError):
        CUDAEngine(model, "cpu", backend=backend, box_mode=box_mode)


def test_a_cam_model_refuses_the_region_box():
    with pytest.raises(ValueError, match="box_mode"):
        CUDAEngine(load_model(default_artifacts()), "cpu", backend="pallas", box_mode="region")


# ── the bundle ───────────────────────────────────────────────────────


def test_the_bundle_round_trip_and_load_model(model, tmp_path, monkeypatch):
    art.save_region_bundle(tmp_path, model.kernels, model.biases, model.shifts,
                           model.class_names)
    monkeypatch.setitem(registry.DETECTORS, "tiny-region", TINY)
    back = load_model(str(tmp_path), "tiny-region")
    assert isinstance(back, RegionModel)
    assert list(back.shifts) == list(SHIFTS) and back.class_names == ["a", "b", "c"]
    assert [list(r) for r in back.config.layer_configs] == [list(r) for r in TINY.layer_configs]
    for a, b in zip(back.kernels + back.biases, model.kernels + model.biases):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert list(load_model(str(tmp_path), "tiny-region", shifts=[1] * 5).shifts) == [1] * 5
    with open(tmp_path / "shifts.json", "w") as f:
        json.dump([1, 2], f)
    with pytest.raises(ValueError, match="one shift per layer"):
        load_model(str(tmp_path), "tiny-region")
