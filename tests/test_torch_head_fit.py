"""The port's head-fitting tools against the JAX package's, on the CPU:
``retrain_classifier`` (``train_linear_classifier``, ``report``, the CLI
with ``--optimizer ref|adam``), ``tune_shifts``, ``calibrate_multi`` and
the benchmark's ``--train``; and two tests for the card.

Tolerances, stated up front:

- ``train_linear_classifier`` (full-batch SGD, explicit gradients): W and
  b within 1e-5, the best val accuracy equal. The ``--optimizer adam``
  CLI: within ``1e-4 * max|W| + 1e-5`` (the trainer's ``fit_head``).
- ``tune_shifts --mode cpu``: the result table equal (the same host
  oracle's features, each candidate's head fit within 1e-5).
- ``calibrate_multi``: the softmax floors equal. With ``--fit-head`` the
  floors equal, the reports (selection, val F1, held-out P/R/F1) equal and
  the sigmoid head within ``1e-4 * max|W|``: after 800 Adam steps at lr
  0.05 the real-photo bundle's weights reach ~34, where one f32 ulp is
  ~4e-6 and the two implementations' rounding has added up to ~1.3e-4. On
  the shipped lyr3-std bundle the selected fit (fc warm start, wd 3e-5)
  reaches, past step 400, the near-zero cancelling gradients that Adam's
  normalisation turns into full ``lr`` steps of either sign: its weights
  part from 1e-5 (step 400) to 2.6e-2 (step 800), its held-out scores by
  up to 1.4e-2, and one floor's first-best grid point moves by one step.
  So that bundle's protocol is held at 400 steps a fit, on both sides.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import calibrate_multi as j_cal  # noqa: E402
from tpu_cnn.apps import common as j_common  # noqa: E402
from tpu_cnn.apps import retrain_classifier as j_retrain  # noqa: E402
from tpu_cnn.apps import tune_shifts as j_tune  # noqa: E402
from tpu_cnn_torch.apps import benchmark, calibrate_multi, retrain_classifier  # noqa: E402
from tpu_cnn_torch.apps import tune_shifts  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import CPURefEngine  # noqa: E402
from tpu_cnn_torch.head.classify import bin_pool_np  # noqa: E402
from tpu_cnn_torch.train.data import BinFolderDataset, SyntheticShapes, batches  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
QAT = os.path.join(REPO, "artifacts", "realphoto", "bundle-qat")
TRAIN_BINS = os.path.join(REPO, "artifacts", "realphoto", "train_bins")
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this file's tests: they run long loops of
    small torch ops beside JAX, and under the suite's parallel workers
    torch's default pool (one thread per core in every worker) turns
    seconds into minutes. The results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dump(tmp_path_factory):
    """A feature dump of 12 real-photo train tiles per class through the
    real-photo bundle (the host oracle): the recipe's retrain input."""
    m = load_model(QAT)
    imgs, labels = BinFolderDataset(TRAIN_BINS, max_per_class=12).arrays()
    feats = CPURefEngine(m.kernels, m.shifts).run_batch(
        np.round(imgs * 255).astype(np.uint8))
    path = str(tmp_path_factory.mktemp("dump") / "f.npz")
    art.save_feature_dump(path, feats, labels, [f"t{i}" for i in range(len(labels))],
                          m.shifts)
    return path, feats, labels


@pytest.mark.parametrize("epochs,lr", [(300, 0.01), (1000, 0.03)])
def test_train_linear_classifier_matches_jax(epochs, lr, dump, capsys):
    _, feats, labels = dump
    x = bin_pool_np(feats)
    w, b = retrain_classifier.train_linear_classifier(x, labels, 6, lr=lr,
                                                      epochs=epochs, device="cpu")
    ours = capsys.readouterr().out
    jw, jb = j_retrain.train_linear_classifier(x, labels, 6, lr=lr, epochs=epochs)
    theirs = capsys.readouterr().out
    assert w.shape == (6, 1024) and w.dtype == np.float32
    np.testing.assert_allclose(w, jw, rtol=0, atol=1e-5)
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-5)
    assert "best val acc:" in ours and ours == theirs


@pytest.mark.parametrize("optimizer", ["ref", "adam"])
def test_retrain_cli_matches_jax(optimizer, dump, tmp_path, capsys):
    path, _, _ = dump
    argv = ["--features", path, "--optimizer", optimizer, "--epochs", "300",
            "--prefix", "arm_", "--classes", os.path.join(QAT, "classes.json")]
    w, b, acc = retrain_classifier.main(argv + CPU + ["--output-dir", str(tmp_path / "t")])
    ours = capsys.readouterr().out
    j_retrain.main(argv + ["--output-dir", str(tmp_path / "j")])
    theirs = capsys.readouterr().out
    jw = np.load(tmp_path / "j" / "arm_fc_weight.npy")
    jb = np.load(tmp_path / "j" / "arm_fc_bias.npy")
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "arm_fc_weight.npy"), w)
    tol = 1e-5 if optimizer == "ref" else 1e-4 * np.abs(jw).max() + 1e-5
    np.testing.assert_allclose(w, jw, rtol=0, atol=tol)
    np.testing.assert_allclose(b, jb, rtol=0, atol=tol)
    report = ours[ours.index("== evaluation"):ours.index("Saved:")]
    assert report == theirs[theirs.index("== evaluation"):theirs.index("Saved:")]
    assert f"overall accuracy: {acc:.1f}%" in ours
    assert "active ch" in ours and "Samples: 72" in ours


def test_tune_shifts_table_equals_jax(capsys):
    best, results = tune_shifts.tune(load_model(ART), "cpu", n_per_class=8,
                                     device="cpu")
    ours = capsys.readouterr().out
    jbest, jresults = j_tune.tune(j_common.load_model(ART), "cpu", n_per_class=8)
    theirs = capsys.readouterr().out
    assert len(results) == 27 and best == jbest
    assert results == jresults
    assert ours == theirs and "BEST: shifts" in ours


def test_tune_shifts_cli_saves_and_mega_agrees(tmp_path, capsys):
    d = _prefixed_copy(tmp_path, "x_")
    best, _ = tune_shifts.main(["--artifacts", str(d), "--mode", "mega",
                                "--radius", "0", "--n-per-class", "4",
                                "--head-prefix", "x_", "--save"] + CPU)
    assert json.load(open(d / "x_shifts.json")) == list(best) == [2, 4, 6]
    cpu_best, cpu_res = tune_shifts.tune(load_model(ART), "cpu", n_per_class=4,
                                         radius=0, verbose=False, device="cpu")
    mega_best, mega_res = tune_shifts.tune(load_model(ART), "mega", n_per_class=4,
                                           radius=0, verbose=False, device="cpu")
    assert mega_res == cpu_res
    mesh_best, mesh_res = tune_shifts.tune(load_model(ART), "mesh", n_per_class=4,
                                           radius=0, verbose=False, device="cpu")
    assert mesh_res == cpu_res and mesh_best == cpu_best


@pytest.mark.parametrize("seed", range(4))
def test_coord_descent_equals_the_original(seed):
    """The port's vectorised sweep against the JAX tool's Python one, on
    scores quantised to 0.01 (ties on the grid everywhere), same-class
    duplicates in the truths, and an init."""
    rs = np.random.RandomState(seed)
    n, k = 60, 6
    scores = np.round(rs.rand(n, k), 2).astype(np.float32 if seed % 2 else np.float64)
    truths = [[(int(c), (0, 0, 1, 1)) for c in rs.randint(0, k, rs.randint(0, 4))]
              for _ in range(n)]
    grid = np.arange(0.05, 0.95 + 1e-9, 0.01)
    init = None if seed < 2 else np.full(k, 0.15)
    got = calibrate_multi.coord_descent(scores, truths, grid, init=init)
    want = j_cal.coord_descent(scores, truths, grid, init=init)
    np.testing.assert_array_equal(got, want)
    assert calibrate_multi.prf(scores, truths, got) == j_cal.prf(scores, truths, want)
    assert (calibrate_multi.per_class_prf(scores, truths, got)
            == j_cal.per_class_prf(scores, truths, want))


@pytest.mark.parametrize("mode", ["cpu", "mega"])
def test_calibrate_floors_equal_jax(mode, capsys):
    thr, rep = calibrate_multi.calibrate(load_model(ART), mode, n_scenes=20,
                                         device="cpu")
    ours = capsys.readouterr().out
    jthr, jrep = j_cal.calibrate(j_common.load_model(ART), "cpu", n_scenes=20)
    theirs = capsys.readouterr().out
    np.testing.assert_array_equal(thr, jthr)
    assert rep == jrep and ours == theirs


@pytest.fixture(scope="module")
def singles():
    """Fewer single-object frames than the tool's 60 + 15 per class."""
    return (SyntheticShapes(n_per_class=10, seed=888).arrays(),
            SyntheticShapes(n_per_class=4, seed=444).arrays())


@pytest.mark.parametrize("bundle,steps", [(QAT, 800), (ART, 400)])
def test_fit_head_matches_jax(bundle, steps, singles, monkeypatch):
    import functools

    for module in (calibrate_multi, j_cal):
        monkeypatch.setattr(module, "_train_sigmoid_head", functools.partial(
            module._train_sigmoid_head, steps=steps))
    (w, b), thr, rep = calibrate_multi.fit_head(
        load_model(bundle), "cpu", n_scenes=24, verbose=False, singles=singles,
        device="cpu")
    (jw, jb), jthr, jrep = j_cal.fit_head(
        j_common.load_model(bundle), "cpu", n_scenes=24, verbose=False,
        singles=singles)
    assert rep == jrep
    assert w.shape == jw.shape == (6, 1024) and w.dtype == np.float32
    np.testing.assert_array_equal(thr, jthr)
    tol = 1e-4 * np.abs(jw).max()
    np.testing.assert_allclose(w, jw, rtol=0, atol=tol)
    np.testing.assert_allclose(b, jb, rtol=0, atol=tol)


def _prefixed_copy(tmp_path, prefix):
    import shutil

    d = tmp_path / "bundle"
    shutil.copytree(ART, d)
    for name in ("fc_weight.npy", "fc_bias.npy"):
        shutil.copy(d / name, d / (prefix + name))
    return d


def test_calibrate_cli_saves_floors_and_head(tmp_path, capsys, monkeypatch):
    d = _prefixed_copy(tmp_path, "p_")
    thr, rep = calibrate_multi.main(["--artifacts", str(d), "--mode", "mega",
                                     "--n-scenes", "12", "--save"] + CPU)
    # --mode mesh (MeshEngine over the CPU) calibrates what mega does
    mesh_thr, mesh_rep = calibrate_multi.main(
        ["--artifacts", str(d), "--mode", "mesh", "--n-scenes", "12"] + CPU)
    np.testing.assert_allclose(mesh_thr, thr, rtol=0, atol=1e-3)
    assert json.load(open(d / "multi_thresh.json")) == [round(float(t), 4)
                                                        for t in thr]
    assert "calibrated   (held-out)" in capsys.readouterr().out
    real = []
    orig = calibrate_multi.fit_head

    def small(model, **kw):  # the CLI's protocol on fewer frames
        real.append(kw["scenes_cls"] is not None)
        imgs, labels = kw["singles"][0]
        vimgs, vlabels = kw["singles"][1]
        kw["singles"] = ((imgs[::20], labels[::20]), (vimgs[::20], vlabels[::20]))
        return orig(model, n_scenes=24, **kw)

    monkeypatch.setattr(calibrate_multi, "fit_head", small)
    thr, rep, (w, b) = calibrate_multi.main(
        ["--artifacts", str(d), "--mode", "cpu", "--fit-head", "--real",
         "--head-prefix", "p_", "--save"] + CPU)
    out = capsys.readouterr().out
    assert real == [True] and "REAL photograph composites" in out
    saved = np.load(d / "p_multi_head.npz")
    np.testing.assert_array_equal(saved["w"], w)
    assert json.load(open(d / "p_multi_thresh.json")) == [round(float(t), 4)
                                                          for t in thr]
    assert "multi-label head (held-out)" in out



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_benchmark_train_runs(dtype, capsys):
    res = benchmark.main(["--train", "--batch", "4", "--runs", "2",
                          "--train-dtype", dtype] + CPU)
    out = capsys.readouterr().out
    assert res["train_img_per_s"] > 0
    assert f"train step ({dtype}, batch 4, 2-step chain, cpu)" in out
    assert "Total: 40.1M MACs/image" in out and "MFU" in out


def test_the_tools_refuse_a_missing_card(dump, monkeypatch):
    path, feats, labels = dump
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        retrain_classifier.main(["--features", path, "--output-dir", "/nonexistent"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune_shifts.tune(load_model(ART), "cpu", n_per_class=2, radius=0,
                         verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calibrate_multi.calibrate(load_model(ART), "mega", n_scenes=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        benchmark.main(["--train", "--batch", "2", "--runs", "1"])


@pytest.mark.cuda
def test_train_on_the_card_follows_the_cpu():
    """2 epochs of lyr3-tiny on the card against the CPU from one draw: the
    per-epoch losses within 1e-3 relative (cuDNN's backward is not
    deterministic), the TF32 flags as before, and bf16 finite and falling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_cnn_torch.train import train_cnn as T

    imgs, labels = SyntheticShapes(n_per_class=20, img_size=32).arrays()
    cfg = T.TrainConfig(layer_configs=((1, 16, 32), (16, 32, 16), (32, 64, 8)),
                        epochs=2, batch_size=16)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    runs = {}
    for dev, dtype in (("cuda", "float32"), ("cpu", "float32"), ("cuda", "bfloat16")):
        net = T.init_params(cfg, torch.Generator().manual_seed(0)).to(dev)
        opt = T.AdamCosine(cfg.lr, 10)
        state = opt.init(net.params())
        step = T.make_train_step(cfg, opt, compute_dtype=dtype)
        rs = np.random.RandomState(0)
        losses = []
        for _ in range(2):
            for bi, bl in T._prefetch_to_device(batches(imgs, labels, 16, rs),
                                                torch.device(dev)):
                losses.append(float(step(net, state, bi, bl)[0]))
        runs[(dev, dtype)] = np.asarray(losses)
    np.testing.assert_allclose(runs[("cuda", "float32")], runs[("cpu", "float32")],
                               rtol=1e-3)
    bf16 = runs[("cuda", "bfloat16")]
    assert np.isfinite(bf16).all() and bf16[-3:].mean() < bf16[:3].mean()
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == flags


@pytest.mark.cuda
def test_head_fits_on_the_card_equal_the_cpu(dump):
    """train_linear_classifier and the sigmoid head on the card against the
    CPU: within 1e-4 (the same f32 arithmetic, other summation orders)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, feats, labels = dump
    x = bin_pool_np(feats)
    got = retrain_classifier.train_linear_classifier(x, labels, 6, epochs=300,
                                                     device="cuda", verbose=False)
    want = retrain_classifier.train_linear_classifier(x, labels, 6, epochs=300,
                                                      device="cpu", verbose=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    y = np.eye(6, dtype=np.float32)[labels]
    init = (np.zeros((6, 1024), np.float32), np.zeros(6, np.float32))
    got = calibrate_multi._train_sigmoid_head(x, y, init, 1e-3, steps=100,
                                              device="cuda")
    want = calibrate_multi._train_sigmoid_head(x, y, init, 1e-3, steps=100,
                                               device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
