"""The port's detection evaluation (``tpu_cnn_torch.apps.eval_detection``)
on the CPU, held against the JAX app's functions with ``mode="cpu"`` (the
JAX package's host oracle and host twins) on the same seeded scenes.

The port runs ``--mode cpu`` (its own host oracle and twins) and ``--mode
mega`` on ``--device cpu``, where the megakernel's plain version stands
in for the kernel, and ``pallas`` once. Tolerance: every metric equal,
except ``--box reg`` on ``mega``: its boxes floor a regression of the
fused bins, which agree with ``bin_pool_np`` within 1e-6 on the card, so
its mean IoU is held within 1e-3 (equal here, where both are numpy and
torch on the CPU)."""

import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import common as j_common  # noqa: E402
from tpu_cnn.apps import eval_detection as j_eval  # noqa: E402
from tpu_cnn.train import data as j_data  # noqa: E402
from tpu_cnn_torch.apps import common, eval_detection  # noqa: E402
from tpu_cnn_torch.train import data  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")
ART4 = os.path.join(REPO, "artifacts", "pretrained-lyr4")


@pytest.fixture(scope="module")
def models():
    return common.load_model(ART), j_common.load_model(ART)


@pytest.mark.parametrize("box,mode", [("ref", "cpu"), ("ref", "mega"),
                                      ("centroid", "cpu"), ("centroid", "mega"),
                                      ("reg", "cpu"), ("ref", "pallas")])
def test_evaluate_equals_the_jax_app(models, box, mode):
    ours, theirs = models
    got = eval_detection.evaluate(ours, mode, n_per_class=5, box=box,
                                  verbose=False, device="cpu")
    want = j_eval.evaluate(theirs, "cpu", n_per_class=5, box=box,
                           verbose=False)
    assert got == want
    assert 0 <= got["mean_iou"] <= 1 and set(got["per_class"]) == set(
        ours.class_names)


def test_evaluate_reg_on_mega_within_the_bins_tolerance(models):
    ours, theirs = models
    got = eval_detection.evaluate(ours, "mega", n_per_class=5, box="reg",
                                  verbose=False, device="cpu")
    want = j_eval.evaluate(theirs, "cpu", n_per_class=5, box="reg",
                           verbose=False)
    assert got["accuracy"] == want["accuracy"]
    assert abs(got["mean_iou"] - want["mean_iou"]) <= 1e-3


@pytest.mark.parametrize("mode", ["cpu", "mega"])
@pytest.mark.parametrize("scenes", ["synthetic", "real"])
def test_evaluate_multi_equals_the_jax_app(models, mode, scenes):
    ours, theirs = models
    kw = {}, {}
    if scenes == "real":
        kw = {"scenes_cls": data.RealComposites}, {"scenes_cls": j_data.RealComposites}
    got = eval_detection.evaluate_multi(ours, mode, n_scenes=8,
                                        thresh=ours.multi_thresh, verbose=False,
                                        device="cpu", **kw[0])
    want = j_eval.evaluate_multi(theirs, "cpu", n_scenes=8,
                                 thresh=theirs.multi_thresh, verbose=False,
                                 **kw[1])
    assert got == want and got["objects"] == 16


@pytest.mark.parametrize("mode", ["cpu", "mega"])
@pytest.mark.parametrize("same_class,instances", [(True, 2), (False, 3),
                                                  (True, 1)])
def test_evaluate_instances_equals_the_jax_app(models, mode, same_class,
                                               instances):
    ours, theirs = models
    got = eval_detection.evaluate_instances(
        ours, mode, n_scenes=8, thresh=ours.multi_thresh, instances=instances,
        same_class=same_class, verbose=False, device="cpu")
    want = j_eval.evaluate_instances(
        theirs, "cpu", n_scenes=8, thresh=theirs.multi_thresh,
        instances=instances, same_class=same_class, verbose=False)
    assert got == want


def test_evaluate_multi_box_centroid_and_a_uniform_floor(models):
    ours, theirs = models
    got = eval_detection.evaluate_multi(ours, "mega", n_scenes=6, thresh=0.3,
                                        box="centroid", verbose=False,
                                        device="cpu")
    want = j_eval.evaluate_multi(theirs, "cpu", n_scenes=6, thresh=0.3,
                                 box="centroid", verbose=False)
    assert got == want


def _metric_lines(text):
    keep = ("  samples:", "  accuracy:", "    ", "  mean CAM-box IoU:",
            "  full-frame baseline:", "  scenes:", "  object recall",
            "  matched", "  overall IoU", "  false ", "  single-box")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("mode", ["cpu", "mega"])
def test_cli_prints_what_the_jax_cli_prints(mode, capsys):
    """The acceptance command: ``eval_detection --device cpu --mode cpu``
    (and ``--mode mega``) at its default sizes prints the accuracy and
    IoU lines of the JAX CLI's ``--mode cpu``."""
    got = eval_detection.main(["--device", "cpu", "--mode", mode])
    ours = capsys.readouterr().out
    j_eval.main(["--mode", "cpu"])
    theirs = capsys.readouterr().out
    assert _metric_lines(ours) == _metric_lines(theirs)
    assert len(_metric_lines(ours)) == 10 and got["accuracy"] > 0.5


@pytest.mark.parametrize("argv", [
    ["--multi", "--n-scenes", "6"],
    ["--multi", "--n-scenes", "6", "--instances", "2", "--same-class"],
    ["--multi", "--n-scenes", "6", "--real", "--multi-thresh", "0.2"],
    ["--multi", "--n-scenes", "6", "--real", "--real-root",
     os.path.join(REPO, "artifacts", "realphoto", "train_bins")],
    ["--box", "centroid", "--n-per-class", "4"],
])
def test_cli_flags_print_what_the_jax_cli_prints(argv, capsys):
    eval_detection.main(["--device", "cpu", "--mode", "mega"] + argv)
    ours = capsys.readouterr().out
    j_eval.main(["--mode", "cpu"] + argv)
    theirs = capsys.readouterr().out
    assert _metric_lines(ours) == _metric_lines(theirs) and _metric_lines(ours)


def test_cli_lyr4_wide(capsys):
    """lyr4-wide (256^2, the chained plan's plain versions on the CPU)."""
    argv = ["--variant", "lyr4-wide", "--artifacts", ART4, "--n-per-class", "2"]
    eval_detection.main(["--device", "cpu", "--mode", "mega"] + argv)
    ours = capsys.readouterr().out
    j_eval.main(["--mode", "cpu"] + argv)
    assert _metric_lines(ours) == _metric_lines(capsys.readouterr().out)


def test_cli_refuses_mesh_and_a_missing_reg_head(tmp_path, models, capsys):
    """``--mode mesh`` runs since the mesh was ported (``MeshEngine`` on
    the CPU): the metric lines of ``--mode cpu``; a missing reg head is
    still refused."""
    argv = ["--device", "cpu", "--n-per-class", "2"]
    eval_detection.main(argv + ["--mode", "mesh"])
    mesh_out = capsys.readouterr().out
    eval_detection.main(argv + ["--mode", "cpu"])
    assert _metric_lines(mesh_out) == _metric_lines(capsys.readouterr().out)
    assert _metric_lines(mesh_out)
    ours, _ = models
    ours.bbox_weight, saved = None, ours.bbox_weight
    try:
        with pytest.raises(ValueError, match="train_bbox"):
            eval_detection.evaluate(ours, "cpu", n_per_class=1, box="reg",
                                    device="cpu")
    finally:
        ours.bbox_weight = saved


def test_multi_outputs_host_twins_equal_the_engine(models):
    """``multi_outputs`` on the host oracle (the host twins) and on a
    ``CUDAEngine`` on the CPU give the same scores, boxes and instances
    on one scene set."""
    from tpu_cnn_torch.apps.infer import make_engine

    ours, _ = models
    u8, _ = eval_detection.multi_scenes(ours, 4, same_class=True)
    host = eval_detection.multi_outputs(ours, make_engine(ours, "cpu"), u8,
                                        instances=2)
    dev = eval_detection.multi_outputs(ours, make_engine(ours, "mega", "cpu"),
                                       u8, instances=2)
    np.testing.assert_allclose(host[0], dev[0], rtol=0, atol=1e-4)
    for a, b in zip(host[1:], dev[1:]):
        np.testing.assert_array_equal(a, b)
