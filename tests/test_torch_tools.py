"""The port's offline tools on the CPU: ``dump_features`` and
``train_bbox`` against the JAX CLIs' outputs, and ``doctor``.

Tolerances: the feature dumps are bit-equal (u8 features, labels, names,
shifts). ``train_bbox --mode cpu`` writes the JAX CLI's bbox_weight.npy
exactly (the same numpy on the same host oracle's features). On
``--mode mega`` the pooled features are the megakernel's bins (here its
plain version, ``bin_pool`` in torch), which agree with ``bin_pool_np``
within 1e-6, so the ridge fit is held within 1e-3 absolute (the weights
are O(1); the solve amplifies a 1e-7 input change by the normal
matrix's conditioning) and the held-out IoU within 1e-3."""

import glob
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import dump_features as j_dump  # noqa: E402
from tpu_cnn.apps import train_bbox as j_train_bbox  # noqa: E402
from tpu_cnn_torch.apps import doctor, dump_features, train_bbox  # noqa: E402
from tpu_cnn_torch.apps.common import load_model  # noqa: E402
from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn_torch.utils import artifacts as art  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    """12 shipped lyr3-std test images and one unreadable one (the
    per-image skip)."""
    d = tmp_path_factory.mktemp("images")
    for p in sorted(glob.glob(os.path.join(ART, "test_image_*.bin")))[:12]:
        shutil.copy(p, d)
    (d / "test_image_99_class2.bin").write_bytes(b"\x00" * 100)
    return str(d)


def _dump(main, out, argv):
    main(argv + ["--output", str(out)])
    return art.load_feature_dump(out)


@pytest.mark.parametrize("mode,argv", [
    ("cpu", []), ("mega", []), ("pallas", ["--batch-size", "5"]),
    ("cpu", ["--shifts", "1,3,5"]), ("mega", ["--s0", "3"])])
def test_dump_features_equals_the_jax_cli(mode, argv, image_dir, tmp_path, capsys):
    common = ["--artifacts", ART, "--image-dir", image_dir] + argv
    ours = _dump(dump_features.main, tmp_path / "ours.npz",
                 common + ["--mode", mode, "--device", "cpu"])
    theirs = _dump(j_dump.main, tmp_path / "theirs.npz", common + ["--mode", "cpu"])
    out = capsys.readouterr().out
    assert "SKIP test_image_99_class2.bin" in out
    feats, labels, names, shifts = ours
    assert feats.dtype == np.uint8 and feats.shape == (12, 64, 256)
    np.testing.assert_array_equal(feats, theirs[0])
    np.testing.assert_array_equal(labels, theirs[1])
    assert names == theirs[2] and len(names) == 12
    np.testing.assert_array_equal(shifts, theirs[3])
    m = load_model(ART, shifts=[int(s) for s in shifts])
    np.testing.assert_array_equal(
        feats[0], numpy_cnn_forward(np.fromfile(os.path.join(image_dir, names[0]),
                                                np.uint8), m.kernels, m.shifts))


def test_dump_features_lyr4_wide_and_no_images(tmp_path, capsys):
    d = tmp_path / "imgs"
    d.mkdir()
    for p in sorted(glob.glob(os.path.join(ART4, "test_image_*.bin")))[:2]:
        shutil.copy(p, d)
    argv = ["--variant", "lyr4-wide", "--artifacts", ART4, "--image-dir", str(d)]
    ours = _dump(dump_features.main, tmp_path / "o.npz",
                 argv + ["--mode", "mega", "--device", "cpu"])
    theirs = _dump(j_dump.main, tmp_path / "t.npz", argv + ["--mode", "cpu"])
    np.testing.assert_array_equal(ours[0], theirs[0])
    assert ours[0].shape == (2, 128, 256)
    dump_features.main(["--image-dir", str(tmp_path / "nothing"), "--mode", "cpu"])
    assert "No test images found" in capsys.readouterr().out


@pytest.fixture(scope="module")
def bbox_runs(tmp_path_factory):
    """train_bbox at 10 images per class: the JAX CLI and the port's on
    --mode cpu and --mode mega (--device cpu)."""
    runs = {}
    for name, main, extra in (("jax", j_train_bbox.main, ["--mode", "cpu"]),
                              ("cpu", train_bbox.main, ["--mode", "cpu"]),
                              ("mega", train_bbox.main,
                               ["--mode", "mega", "--device", "cpu"])):
        out = tmp_path_factory.mktemp(name)
        main(["--artifacts", ART, "--output-dir", str(out),
              "--n-per-class", "10"] + extra)
        runs[name] = np.load(out / "bbox_weight.npy")
    return runs


def test_train_bbox_cpu_writes_the_jax_clis_weights(bbox_runs):
    assert bbox_runs["cpu"].dtype == np.float32
    assert bbox_runs["cpu"].shape == (1025, 4)
    np.testing.assert_array_equal(bbox_runs["cpu"], bbox_runs["jax"])


def test_train_bbox_mega_within_the_bins_tolerance(bbox_runs):
    np.testing.assert_allclose(bbox_runs["mega"], bbox_runs["jax"], rtol=0,
                               atol=1e-3)


def test_train_returns_the_held_out_iou():
    from tpu_cnn.apps import common as j_common

    got = train_bbox.train(load_model(ART), "mega", n_per_class=4,
                           verbose=False, device="cpu")
    want = j_train_bbox.train(j_common.load_model(ART), "cpu", n_per_class=4,
                              verbose=False)
    assert abs(got[1] - want[1]) <= 1e-3 and got[1] > 0.3
    # --mode mesh: MeshEngine's features through the host bin pool
    mesh = train_bbox.train(load_model(ART), "mesh", n_per_class=4,
                            verbose=False, device="cpu")
    np.testing.assert_allclose(mesh[0], got[0], rtol=0, atol=1e-3)
    assert abs(mesh[1] - want[1]) <= 1e-3


def test_doctor_host_only_passes(capsys):
    assert doctor.main(["--host-only"]) == 0
    out = capsys.readouterr().out
    assert "all checks passed" in out
    assert "numpy == native C++ (bit-exact)" in out
    assert out.count("[ok]   bundle ") == 4
    assert "device dispatch" not in out


def test_doctor_fails_on_a_bad_bundle_and_without_a_card(capsys, monkeypatch):
    assert doctor.main(["--host-only", "--artifacts", "/nonexistent-bundle"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] bundle nonexistent-bundle" in out and "1 check(s) FAILED" in out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert doctor.main(["--artifacts", ART + ":lyr3-std"]) == 1
    out = capsys.readouterr().out
    assert "[FAIL] runtime" in out and "no CUDA device" in out
    assert "[skip] device dispatch" in out


@pytest.mark.cuda
def test_doctor_on_the_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    assert doctor.main([]) == 0
    out = capsys.readouterr().out
    assert "platform=gpu" in out and torch.cuda.get_device_name(0) in out
    assert "[ok]   device dispatch" in out
