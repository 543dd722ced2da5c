"""The port's headline bench (``tpu_cnn_torch.bench``) and the repo's own
entry points (``tpu_cnn_torch.graft_entry``) on the CPU, against
``bench.py`` and ``__graft_entry__.py``.

On the CPU the engine runs the kernels' plain versions; the JAX path runs
its Pallas megakernel in interpret mode, as ``tests/test_bench_gate.py``
runs it. Tolerances: features, predictions and boxes equal; fused bins
within 1e-5 (the gate's: exact integer sums, the /16/255 scaling may
differ by an ulp); probabilities and confidences within 1e-4 (the gate's:
1024-term f32 dots summed in another order). No time measured here means
anything: the tests check what runs, what is compared and what is
printed. The bench on the card: ``python -m pytest -m cuda
tests/test_torch_bench.py``."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__ as j_graft  # noqa: E402
from tpu_cnn.models.cnn import DEFAULT_SHIFTS as J_SHIFTS  # noqa: E402
from tpu_cnn.ops import detect_head as j_head  # noqa: E402
from tpu_cnn.ops import pallas_poly  # noqa: E402
from tpu_cnn.utils import artifacts as j_art  # noqa: E402
from tpu_cnn_torch import bench, bench_gate, graft_entry  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.engine.cuda import CUDAEngine  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
SMALL = dict(batch=8, n_pools=4, rounds=2, passes=1, n_real=2, n_noise=2)
KEYS = ["metric", "value", "unit", "vs_baseline"]  # bench.py's line


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: under the suite's parallel workers torch's
    default pool beside JAX turns seconds into minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def engine():
    return CUDAEngine(load_model(ART), device="cpu", backend="mega")


@pytest.fixture(scope="module")
def gate():
    return bench_gate.load_gate_images(ART, n_real=2, n_noise=2)


def _jax_production_path(images):
    """bench.py's production_path (``bench.py:120-132``)."""
    bundle = j_art.load_bundle(ART)
    kernels = [jnp.asarray(k) for k in bundle.kernels]
    feats, pooled, twin = pallas_poly.cnn_forward_polyphase_pallas(
        images, kernels, jnp.asarray(J_SHIFTS, jnp.int32), with_bins=True,
        with_twin=True)
    pred, conf, probs, bbox = j_head.detect_with_pooled(
        feats, pooled, jnp.asarray(bundle.fc_weight),
        jnp.asarray(bundle.fc_bias), 128, features_twin=twin)
    return feats, pooled, pred, conf, probs, bbox


def test_production_path_equals_the_jax_path(engine, gate):
    got = [t.numpy() for t in bench.production_path(engine)(torch.from_numpy(gate))]
    want = [np.asarray(a) for a in jax.jit(_jax_production_path)(jnp.asarray(gate))]
    feats, pooled, pred, conf, probs, bbox = got
    np.testing.assert_array_equal(feats, want[0])
    np.testing.assert_allclose(pooled, want[1], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(pred, want[2])
    np.testing.assert_allclose(conf, want[3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(probs, want[4], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(bbox, want[5])
    timed = [t.numpy() for t in bench.timed_path(engine)(torch.from_numpy(gate))]
    for g, w in zip(timed, (pred, conf, bbox)):
        np.testing.assert_array_equal(g, w)


def _flip_feature_bit(o):
    o[0][0, 0, 0] ^= 1  # one flipped bit


def _bin_off_by_one_count(o):
    o[1][0, 0] += 1.0 / 4080.0  # one bin off by one feature count


def _shift_predictions(o):
    o[2][:] = (o[2] + 1) % 6


def _shift_boxes(o):
    o[5][:] += 8


@pytest.mark.parametrize("corrupt,msg", [
    (None, None), (_flip_feature_bit, "features"),
    (_bin_off_by_one_count, "bin pooling"), (_shift_predictions, "predictions"),
    (_shift_boxes, "bbox")])
def test_gate_on_the_bench_path(engine, gate, corrupt, msg):
    """The gate passes on the bench's own path and trips on each
    corruption."""
    path = bench.production_path(engine)

    def production(images):
        out = [t.clone() for t in path(torch.from_numpy(images))]
        if corrupt is not None:
            corrupt(out)
        return out

    err = bench_gate.run_parity_gate(production, engine.model, gate)
    if msg is None:
        assert err is None, err
    else:
        assert err is not None and msg in err, err


def test_pools_are_bench_py_draws():
    """After the same RandomState(0), the pools are bench.py's draws
    (``bench.py:145-148``; its expression is checked to stand there)."""
    expr = "rs.randint(0, 256, size=(batch, 128, 128)).astype(np.uint8)"
    with open(os.path.join(REPO, "bench.py")) as f:
        assert expr in f.read()
    batch, rs = 8, np.random.RandomState(0)
    want = [eval(expr) for _ in range(4)]
    got = bench.draw_pools(np.random.RandomState(0), batch)
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (8, 128, 128)
        np.testing.assert_array_equal(g, w)


def _pipeline(engine, resolve):
    detect = bench.timed_path(engine)
    pools = [torch.from_numpy(a) for a in bench.draw_pools(np.random.RandomState(0), 8)]
    want = tuple(t.numpy().copy() for t in detect(pools[0]))
    dispatch = bench.pipelined(detect, detect(pools[0]), 2)
    fps, results = bench.measure(dispatch, resolve, pools, 8, rounds=2)
    return fps, results, want


def test_measured_loop_materialises_every_round(engine):
    fps, results, want = _pipeline(engine, bench.wait_copies)
    assert fps > 0 and len(results) == 2
    for res in results:
        assert [a.shape for a in res] == [(8,), (8,), (8, 4)]
    for g, w in zip(results[0], want):
        np.testing.assert_array_equal(g, w)


def _read_early(handle):
    """A resolve that reads the host buffers without waiting for the
    copies."""
    return tuple(h.numpy() for h in handle[0])


def test_reading_copies_before_their_wait_fails_the_check(engine, monkeypatch):
    _, results, want = _pipeline(engine, _read_early)
    assert not np.array_equal(results[0][0], want[0])
    assert (results[0][0] == bench.SENTINEL).all()
    monkeypatch.setattr(bench, "wait_copies", _read_early)
    out = bench.run("cpu", ART, **SMALL)
    assert "timed results differ from the synchronous call" in out["error"]


def test_run_at_a_small_size_on_the_cpu(capsys):
    out = bench.run("cpu", ART, **SMALL)
    assert list(out) == KEYS and out["value"] > 0
    assert out["vs_baseline"] == round(out["value"] / bench.BASELINE_FPS, 1)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[0].startswith("gate: passed on 4 images")
    detail = json.loads(err[-1])
    assert len(detail["passes_fps"]) == 1
    assert detail["launches"] == {"mega_cnn": 0, "cam_head": 0}


_RUN = bench.run


def _small_run(device):
    """``main``'s call of ``run``, made on the CPU at a small size."""
    return _RUN("cpu", ART, **SMALL)


def test_main_prints_one_line_with_bench_py_keys(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run", _small_run)
    assert bench.main() == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and list(json.loads(lines[0])) == KEYS


def test_main_gate_failure_prints_the_error_line(monkeypatch, capsys):
    path = bench.production_path

    def corrupted(engine):
        def run(images):
            out = [t.clone() for t in path(engine)(images)]
            _flip_feature_bit(out)
            return out
        return run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run", _small_run)
    monkeypatch.setattr(bench, "production_path", corrupted)
    assert bench.main() == 1
    lines = capsys.readouterr().out.splitlines()
    line = json.loads(lines[0])
    assert len(lines) == 1 and list(line) == KEYS + ["error"]
    assert line["value"] == 0.0 and "features" in line["error"]


def test_the_module_without_a_card_exits_non_zero():
    """``python -m tpu_cnn_torch.bench`` with no CUDA device: exit 1, the
    error line, no FPS."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the bench would measure it")
    proc = subprocess.run([sys.executable, "-m", "tpu_cnn_torch.bench"], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1
    line = json.loads(proc.stdout)
    assert line["value"] == 0.0 and "no CUDA device" in line["error"]


def test_graft_entry_equals_the_jax_entry():
    fn, (images,) = graft_entry.entry(device="cpu")
    j_fn, (j_images,) = j_graft.entry()
    assert images.device.type == "cpu"
    np.testing.assert_array_equal(images.numpy(), np.asarray(j_images))
    pred, conf, probs, bbox = (t.numpy() for t in fn(images))
    assert pred.shape == (8,) and bbox.shape == (8, 4)
    j_pred, j_conf, j_probs, j_bbox = (np.asarray(a) for a in jax.jit(j_fn)(j_images))
    np.testing.assert_array_equal(pred, j_pred)
    np.testing.assert_array_equal(bbox, j_bbox)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=1e-4)
    np.testing.assert_allclose(conf, j_conf, rtol=0, atol=1e-4)


def test_graft_entry_main_on_cpu_positions(capsys):
    """``__graft_entry__``'s __main__ on 8 CPU positions: the entry's
    shapes, then both dry runs."""
    assert graft_entry.main("cpu") == 0
    out = capsys.readouterr().out
    assert "entry: ((8,), (8,), (8, 6), (8, 4))" in out
    assert "dryrun_mesh(8), dryrun_train(8) on cpu: OK" in out


@pytest.mark.cuda
def test_bench_on_the_card():
    """The bench at a small size on the card: the gate, the pipelined
    passes, every timed round equal to its synchronous call, K1 and the CAM
    head launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the bench measures the "
                    "CUDA megakernel, which has no CPU or interpret mode (on "
                    "the card: python -m pytest -m cuda tests/test_torch_bench.py)")
    from tpu_cnn_torch.ops import cam_head, mega

    before = mega.launches, cam_head.launches
    out = bench.run("cuda", ART, batch=64, rounds=8, passes=2)
    assert "error" not in out and out["value"] > 0, out
    # the gate, the warm-up, the passes: K1 and the head once each a call
    assert mega.launches - before[0] == 1 + 4 + 2 * 8
    assert cam_head.launches - before[1] == 1 + 4 + 2 * 8
