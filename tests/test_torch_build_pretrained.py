"""``scripts/build_pretrained_torch.py`` (the port of
``scripts/build_pretrained.py``) at a tiny size on the CPU: two epochs on
16 procedural images per class, phase 1 started from the JAX trainer's
carried lyr3-std draw (``tests/data/jax_init_lyr3-std_seed0.f32``), the
dump -> retrain of the (6, 1024) head on the host oracle's features.

The bundle loads in both packages (``tpu_cnn.models.cnn.FpgaCNN
.from_artifacts`` and the port's ``load_model``); its phase 1 and export
hold to the JAX trainer's from the same draw on the same data (the val
accuracy lines equal, weights.bin within one step on at most 0.1% of the
weights, as the trainer's own parity tests hold it); the CLI refuses to
write over the shipped bundle.

Tolerances: the val lines and the class names exact; weights.bin as above."""

import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.models.cnn import FpgaCNN as JFpgaCNN  # noqa: E402
from tpu_cnn.train import data as JD  # noqa: E402
from tpu_cnn.train import train_cnn as J  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRAW = os.path.join(REPO, "tests", "data", "jax_init_lyr3-std_seed0.f32")
EPOCHS, N_PER_CLASS = 2, 16


def _script():
    spec = importlib.util.spec_from_file_location(
        "build_pretrained_torch",
        os.path.join(REPO, "scripts", "build_pretrained_torch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _val_lines(text):
    return [ln.split("val")[-1].strip() for ln in text.splitlines()
            if ln.strip().startswith("epoch")]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port bundle dir, its stdout, head accuracy, JAX bundle dir, JAX
    stdout): the script from the carried draw, and the JAX trainer from
    the same draw on the same split."""
    import contextlib
    import io

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    script = _script()
    draw = script.flat_draw(DRAW, script.TrainConfig())
    ours = str(tmp_path_factory.mktemp("port"))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            acc = script.build(ours, EPOCHS, N_PER_CLASS, mode="cpu",
                               device="cpu", init=draw)
    finally:
        torch.set_num_threads(n)
    theirs = str(tmp_path_factory.mktemp("jax"))
    ds = JD.SyntheticShapes(n_per_class=N_PER_CLASS, seed=7)
    imgs, labels = ds.arrays()
    n_val = len(imgs) // 6
    jbuf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(jbuf):
        mp.setattr(J, "init_params", lambda cfg, key: {
            k: jnp.asarray(v) for k, v in draw.items()})
        J.train(J.TrainConfig(epochs=EPOCHS, batch_size=64, head_epochs=400),
                (imgs[n_val:], labels[n_val:]), (imgs[:n_val], labels[:n_val]),
                theirs, class_names=ds.class_names)
    return ours, buf.getvalue(), acc, theirs, jbuf.getvalue()


def test_tiny_bundle_loads_in_both_packages(runs):
    ours, text, acc, _, _ = runs
    j_model = JFpgaCNN.from_artifacts(ours)
    model = load_model(ours)
    assert model.fc_weight.shape == j_model.fc_weight.shape == (6, 1024)
    assert model.head_mode == j_model.head_mode == "bins"
    for a, b in zip(model.kernels, j_model.kernels):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(model.fc_weight, j_model.fc_weight)
    assert model.class_names == list(j_model.class_names)
    assert 0.0 <= acc <= 100.0 and f"{acc:.1f}%" in text
    assert len([f for f in os.listdir(ours) if f.startswith("test_image_")]) > 0


def test_phase1_from_the_carried_jax_draw_matches_jax(runs):
    ours, text, _, theirs, jtext = runs
    assert _val_lines(text) == _val_lines(jtext) and len(_val_lines(text)) == EPOCHS
    a = np.fromfile(os.path.join(ours, "weights.bin"), np.int8).astype(int)
    b = np.fromfile(os.path.join(theirs, "weights.bin"), np.int8).astype(int)
    assert a.shape == b.shape
    off = a != b
    assert np.abs(a - b).max() <= 1 and off.mean() <= 1e-3, off.sum()


def test_cli_refuses_the_shipped_bundle_and_a_wrong_draw(tmp_path):
    script = _script()
    with pytest.raises(SystemExit) as e:
        script.main(["--out", os.path.join(REPO, "artifacts", "pretrained"),
                     "--device", "cpu"])
    assert e.value.code == 2
    assert script.DEFAULT_OUT == os.path.join(REPO, "build", "pretrained_torch")
    bad = tmp_path / "short.f32"
    np.zeros(10, "<f4").tofile(bad)
    with pytest.raises(ValueError, match="10 floats"):
        script.flat_draw(str(bad), script.TrainConfig())
