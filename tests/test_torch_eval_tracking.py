"""The port's tracking evaluation (``tpu_cnn_torch.apps.eval_tracking``) on
the CPU, held against the JAX app's with ``mode="cpu"`` on the same seeded
sequences: 2 sequences of 8 frames, the port on ``--mode cpu`` and on
``--mode mega`` (the megakernel's plain version on ``--device cpu``).
Tolerance: every metric of every tracker configuration equal; the cached
presence scores within 1e-4 (f32 dot products in another order), boxes
and instances equal."""

import os

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn.apps import common as j_common  # noqa: E402
from tpu_cnn.apps import eval_tracking as j_track  # noqa: E402
from tpu_cnn.train import data as j_data  # noqa: E402
from tpu_cnn_torch.apps import common, eval_tracking  # noqa: E402
from tpu_cnn_torch.train import data  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ART = os.path.join(REPO, "artifacts", "pretrained")


@pytest.fixture(scope="module")
def models():
    return common.load_model(ART), j_common.load_model(ART)


CASES = {
    "distinct-class": {},
    "same-class instances 2": {"same_class": True, "instances": 2},
    "fast, instances 3": {"speed": (4.0, 6.0), "instances": 3},
    "score EMA 0.5 + A/B": {"score_ema": 0.5, "ema_ab": (0.3,)},
    "real tiles": "real",
}


@pytest.mark.parametrize("mode", ["cpu", "mega"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_evaluate_tracking_equals_the_jax_app(models, mode, case):
    ours, theirs = models
    kw = CASES[case]
    if kw == "real":
        kw_ours = {"scenes_cls": data.RealMovingScenes}
        kw_theirs = {"scenes_cls": j_data.RealMovingScenes}
    else:
        kw_ours = kw_theirs = kw
    got = eval_tracking.evaluate_tracking(ours, mode, n_seqs=2, n_frames=8,
                                          verbose=False, device="cpu",
                                          **kw_ours)
    want = j_track.evaluate_tracking(theirs, "cpu", n_seqs=2, n_frames=8,
                                     verbose=False, **kw_theirs)
    assert got == want
    assert all(r["gt_boxes"] == 32 for r in got.values())


@pytest.mark.parametrize("instances", [1, 2])
def test_frame_scores_and_detections(models, instances):
    ours, theirs = models
    seqs = j_data.MovingScenes(n_seqs=1, n_frames=6, seed=5, same_class=True)
    imgs, _ = seqs.arrays()
    u8 = np.round(imgs[0] * 255).astype(np.uint8)
    got = eval_tracking.frame_scores(ours, "mega", u8, instances, device="cpu")
    want = j_track.frame_scores(theirs, "cpu", u8, instances)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2:], want[2:]):
        assert (a is None) == (b is None) == (instances == 1)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    dets = eval_tracking.frame_detections(ours, "cpu", u8, 0.2, instances,
                                          device="cpu")
    assert dets == j_track.frame_detections(theirs, "cpu", u8, 0.2, instances)


def test_score_tracker_equals_the_jax_app():
    from tpu_cnn.head.tracker import Tracker as JTracker
    from tpu_cnn_torch.head.tracker import Tracker

    rs = np.random.RandomState(9)
    truths, dets = [], []
    for _ in range(2):
        t_seq, d_seq = [], []
        for t in range(10):
            box = (10 + 3 * t, 20, 40 + 3 * t, 50)
            t_seq.append([(0, 2, box)])
            d_seq.append([(2, 0.8, tuple(int(v + rs.randint(-2, 3)) for v in box))]
                         if rs.rand() < 0.8 else [])
        truths.append(t_seq)
        dets.append(d_seq)
    for kw in ({}, {"velocity": True}, {"iou_floor": 1.1, "max_age": 0,
                                        "min_hits": 1, "smooth": 1.0}):
        assert (eval_tracking.score_tracker(dets, truths, lambda: Tracker(**kw))
                == j_track.score_tracker(dets, truths, lambda: JTracker(**kw)))


def test_cli_prints_what_the_jax_cli_prints(capsys):
    argv = ["--n-seqs", "2", "--n-frames", "6", "--instances", "2",
            "--same-class", "--ema-ab", "0.5"]
    res = eval_tracking.main(["--device", "cpu", "--mode", "mega"] + argv)
    ours = capsys.readouterr().out
    j_track.main(["--mode", "cpu"] + argv)
    theirs = capsys.readouterr().out
    rows = [ln for ln in ours.splitlines() if ln.startswith("  ")]
    assert rows == [ln for ln in theirs.splitlines() if ln.startswith("  ")]
    assert len(res) == 4 and len(rows) == 7  # title, sequences, header, 4 rows


def test_cli_real_head_prefix_and_mesh(capsys):
    argv = ["--n-seqs", "1", "--n-frames", "4", "--real", "--head-prefix",
            "real_", "--score-ema", "0.6"]
    eval_tracking.main(["--device", "cpu", "--mode", "cpu"] + argv)
    ours = capsys.readouterr().out
    j_track.main(["--mode", "cpu"] + argv)
    assert ours.splitlines()[3:] == capsys.readouterr().out.splitlines()[3:]
    # --mode mesh (MeshEngine on the CPU) runs and prints --mode cpu's rows
    argv = ["--device", "cpu", "--n-seqs", "1", "--n-frames", "4"]
    eval_tracking.main(argv + ["--mode", "mesh"])
    mesh_rows = capsys.readouterr().out.splitlines()[3:]
    eval_tracking.main(argv + ["--mode", "cpu"])
    assert mesh_rows == capsys.readouterr().out.splitlines()[3:]
