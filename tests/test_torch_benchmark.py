"""The port's benchmark app (``tpu_cnn_torch.apps.benchmark``) on the CPU:
every flag runs with ``--device cpu`` at a tiny batch and ``--runs 1``
(the kernels' plain versions stand in for them), the MAC count and the
``--per-layer`` rows' geometry and path equal the JAX app's, the items
not ported yet exit 2, a failing mode exits 1, and the roofline states
the card's peaks. No time measured here means anything: the tests check
what runs and what is printed, not speed."""

import os

import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import benchmark as j_bench  # noqa: E402
from tpu_cnn.apps import common as j_common  # noqa: E402
from tpu_cnn_torch.apps import benchmark  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.utils import roofline  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")
CPU = ["--device", "cpu", "--runs", "1"]

FLAGS = {
    "default (auto)": (["--batch", "3"], "auto"),
    "every mode": (["--batch", "3", "--modes", "auto,mega,pallas,hybrid,xla,cpu"],
                   "cpu"),
    "features": (["--batch", "3", "--features", "--modes", "mega,pallas,cpu"], "mega"),
    "multi": (["--batch", "3", "--multi", "--modes", "mega,pallas"], "pallas"),
    "multi instances": (["--batch", "3", "--multi", "--instances", "2",
                         "--modes", "mega"], "mega"),
    "lyr4-wide": (["--batch", "2", "--variant", "lyr4-wide", "--modes", "mega"],
                  "mega"),
    "per-layer pallas": (["--batch", "2", "--per-layer", "--modes", "pallas"],
                         "per_layer"),
    "per-layer mega": (["--batch", "2", "--per-layer", "--modes", "mega"],
                       "mega_fused_us"),
    "per-layer auto": (["--batch", "2", "--per-layer", "--modes", "auto"],
                       "mega_fused_us"),
    "roofline": (["--batch", "2", "--roofline"], "roofline"),
    "roofline lyr4-wide": (["--batch", "1", "--roofline", "--variant",
                            "lyr4-wide"], "roofline"),
    "latency": (["--latency", "--latency-batches", "1,3", "--modes", "mega"],
                "latency"),
    "camera packed": (["--batch", "2", "--camera-pipeline", "--cam-res",
                       "320x240"], "camera_pipeline"),
    "camera bgr": (["--batch", "2", "--camera-pipeline", "--cam-channels", "3",
                    "--cam-res", "200x150", "--modes", "pallas"], "camera_pipeline"),
    "camera pitch": (["--batch", "2", "--camera-pipeline", "--cam-pitch", "656"],
                     "camera_pipeline"),
}


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_every_flag_runs_on_the_cpu(name, capsys):
    argv, key = FLAGS[name]
    res = benchmark.main(CPU + argv)
    out = capsys.readouterr().out
    assert "M MACs" in out and "FAILED" not in out
    assert key in res and res[key]
    if key in ("auto", "cpu", "mega", "pallas", "camera_pipeline"):
        assert res[key] > 0
    if "--cam-pitch" in argv:
        assert "640x480x4@656" in out


def test_trace_dir_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "trace"
    res = benchmark.main(CPU + ["--batch", "2", "--camera-pipeline", "--cam-res",
                                "256x128", "--trace-dir", str(out)])
    assert res["camera_pipeline"] > 0
    assert "traceEvents" in (out / "trace.json").read_text()


@pytest.mark.parametrize("variant,art", [("lyr3-std", ART), ("lyr4-wide", ART4)])
def test_macs_per_image_equals_the_jax_app(variant, art):
    cfgs = load_model(art, variant).config.layer_configs
    assert roofline.macs_per_image(cfgs) == j_bench.macs_per_image(cfgs)
    assert roofline.macs_per_image() == j_bench.macs_per_image() == 40108032


@pytest.mark.parametrize("variant,mode", [("lyr3-std", "pallas"),
                                          ("lyr3-std", "hybrid"),
                                          ("lyr3-std", "xla"),
                                          ("lyr4-wide", "auto")])
def test_per_layer_rows_equal_the_jax_apps(variant, mode):
    art = ART if variant == "lyr3-std" else ART4
    ours = benchmark.bench_per_layer(load_model(art, variant), mode, 1, 1,
                                     device="cpu")
    theirs = j_bench.bench_per_layer(j_common.load_model(art, variant), mode, 1, 1)
    keys = ("layer", "ic", "oc", "size", "kind")
    assert [tuple(r[k] for k in keys) for r in ours] == \
        [tuple(r[k] for k in keys) for r in theirs]
    assert all(r["ms"] > 0 and r["us_per_img"] > 0 for r in ours)


@pytest.mark.parametrize("argv,item", [(["--modes", "mesh,cpu"], "mesh")])
def test_unported_items_exit_2_naming_what_they_wait_for(argv, item, capsys):
    """Nothing is unported any more: ``--modes mesh`` (once refused) times
    ``MeshEngine`` beside the host oracle, and both rows print."""
    res = benchmark.main(CPU + ["--batch", "4", "--runs", "1"] + argv)
    out = capsys.readouterr().out
    assert res[item] > 0 and res["cpu"] > 0
    assert f"  {item}" in out and "FAILED" not in out


@pytest.mark.parametrize("threads", [1, 3])
def test_host_ingest_counts_every_frame(threads, capsys):
    """``--host-ingest`` runs the native frame ring (host work only): the
    frames consumed plus those dropped are the frames pushed, as in the
    JAX app's loop."""
    fps, dropped = benchmark.bench_host_ingest(8, 3, 96, 64, threads,
                                               out_size=32)
    assert fps > 0 and 0 <= dropped <= 8 * 3
    res = benchmark.main(CPU + ["--host-ingest", "--batch", "4", "--runs", "2",
                                "--cam-res", "64x48",
                                "--ingest-threads", str(threads)])
    assert res["host_ingest"] > 0 and res["dropped"] >= 0
    assert "frames/s" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--latency", "--modes", "mesh"],  # as the JAX app: engines of one device
    ["--latency", "--modes", "cpu"],
    ["--camera-pipeline", "--modes", "cpu"],
    ["--camera-pipeline", "--cam-pitch", "600"],
    ["--multi", "--features"],
    ["--multi", "--roofline"],
])
def test_refused_combinations_exit_2(argv):
    with pytest.raises(SystemExit) as e:
        benchmark.main(CPU + ["--batch", "2"] + argv)
    assert e.value.code == 2


def test_a_failing_mode_exits_non_zero(capsys, monkeypatch):
    """The JAX app prints FAILED and goes on with exit 0; the port prints
    the same line, runs the other modes, then exits 1."""
    with pytest.raises(SystemExit) as e:
        benchmark.main(CPU + ["--batch", "2", "--multi", "--modes", "cpu,mega"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "cpu: FAILED (--multi needs an engine with detect_multi_batch" in out
    assert "BEST: mega" in out

    def broken(*a, **k):
        raise RuntimeError("kernel refused")

    monkeypatch.setattr(benchmark, "bench_engine", broken)
    with pytest.raises(SystemExit) as e:
        benchmark.main(CPU + ["--batch", "2", "--modes", "mega"])
    assert e.value.code == 1
    assert "mega: FAILED (kernel refused)" in capsys.readouterr().out


def test_roofline_states_the_cards_peaks(capsys):
    res = benchmark.main(CPU + ["--batch", "2", "--roofline"])["roofline"]
    out = capsys.readouterr().out
    assert "H100" in out and "989.5 T MAC/s" in out and "3.35 TB/s" in out
    assert "v5e" not in out and "VMEM" not in out and "MXU" not in out
    assert res["macs_per_img"] == 40108032
    assert res["bytes_per_img"] == 128 * 128 + roofline.detect_out_bytes(
        load_model(ART).config.layer_configs)
    assert 0 < res["share"] < 1 and res["bound_by"] == "operations"


def test_roofline_helpers():
    cfgs = load_model(ART).config.layer_configs
    ms, by = roofline.bound(roofline.PEAK_INT8_MACS / 1e3, 0)
    assert ms == pytest.approx(1.0) and by == "operations"
    ms, by = roofline.bound(0, roofline.PEAK_HBM_BYTES)
    assert ms == pytest.approx(1e3) and by == "bytes"
    assert roofline.detect_out_bytes(cfgs) == 64 * 16 * 16 * 2 + 64 * 16 * 4
    net = roofline.layers_bound(cfgs, 1536, roofline.detect_out_bytes(cfgs))
    assert net[1] == "operations" and net[0] == pytest.approx(
        40108032 * 1536 / roofline.PEAK_INT8_MACS * 1e3)
    pooled = roofline.layers_bound(cfgs, 1536, 0, calls="pooled")
    unpooled = roofline.layers_bound(cfgs, 1536, 0, calls="unpooled")
    assert pooled[0] < unpooled[0] and pooled[1] == "mixed"


def test_no_tpu_figure_in_the_app():
    """The JAX app's TPU numbers (the v5e MXU peak, its HBM rate, the
    VMEM traffic model) stay out of the port's app."""
    src = open(benchmark.__file__).read()
    for word in ("v5e", "197e12", "819", "VMEM", "MXU", "relay"):
        assert word not in src, word


@pytest.mark.cuda
def test_benchmark_on_the_card(capsys):
    """On the card: the default mode, per-layer pallas and the roofline at a
    small batch, each launching its kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (python -m pytest -m cuda "
                    "tests/test_torch_benchmark.py)")
    from tpu_cnn_torch.ops import int8, mega

    mega.launches = int8.launches = 0
    assert benchmark.main(["--batch", "64", "--runs", "2", "--modes", "mega"])["mega"] > 0
    assert mega.launches > 0 and int8.launches == 0
    rows = benchmark.main(["--batch", "64", "--runs", "2", "--per-layer",
                           "--modes", "pallas"])["per_layer"]
    assert [r["kind"] for r in rows] == ["pallas"] * 3 + ["xla"] and int8.launches > 0
    assert 0 < benchmark.main(["--batch", "64", "--runs", "2",
                               "--roofline"])["roofline"]["share"] < 1
    assert "FAILED" not in capsys.readouterr().out
