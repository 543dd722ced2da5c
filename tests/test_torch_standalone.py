"""The port stands alone: no module of ``tpu_cnn_torch`` and not
``chip_smoke.py`` imports the JAX package ``tpu_cnn``, ``jax`` or JAX's
optimiser and checkpoint libraries ``optax`` and ``orbax``, at the top or
inside a function, and the port's modules and CLIs run in a process that
refuses those imports.

The tests themselves import ``tpu_cnn``: holding the port's copies against
their originals is their job (``test_torch_copies.py``)."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, fs in os.walk(os.path.join(REPO, "tpu_cnn_torch"))
    for f in fs if f.endswith(".py")) + ["chip_smoke.py",
                                         "scripts/bench_serving_torch.py",
                                         "scripts/build_pretrained_torch.py",
                                         "scripts/mega_phases_torch.py",
                                         "scripts/yolo3_conv_times.py",
                                         "scripts/yolo7_conv_times.py"]
REFUSED = ("jax", "tpu_cnn", "optax", "orbax")
VERDICT = "VERDICT: DESIGN IS BIT-ACCURATE across all backends"


def _refused(name: str) -> bool:
    return any(name == r or name.startswith(r + ".") for r in REFUSED)


def _imports(path: str) -> list[str]:
    """Every module an ``import`` or ``from ... import`` in the file names,
    wherever the statement stands (relative imports resolve inside the
    port)."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
            names += [f"{node.module}.{a.name}" for a in node.names]
    return names


def test_the_scan_sees_the_port():
    assert len(PORT_FILES) >= 30
    assert "tpu_cnn_torch/ops/mega.py" in PORT_FILES
    assert _imports("tpu_cnn_torch/ops/_build.py")  # it does parse imports
    assert not _refused("tpu_cnn_torch.ops") and _refused("tpu_cnn.ops")
    assert _refused("jax.numpy") and not _refused("jaxlib_free")
    assert _refused("optax") and _refused("orbax.checkpoint")


@pytest.mark.parametrize("path", PORT_FILES)
def test_no_import_of_the_jax_package(path):
    bad = [n for n in _imports(path) if _refused(n)]
    assert not bad, f"{path} imports {bad}"


_REFUSING_PROCESS = r"""
import importlib, io, json, pkgutil, runpy, sys
from contextlib import redirect_stdout

REFUSED = ("jax", "tpu_cnn", "optax", "orbax")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if any(name == r or name.startswith(r + ".") for r in REFUSED):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
OUT = sys.argv[1]
import tpu_cnn_torch
names = [m.name for m in pkgutil.walk_packages(tpu_cnn_torch.__path__,
                                                 "tpu_cnn_torch.")]
for n in names:
    importlib.import_module(n)
runs = {}
for argv in (["tpu_cnn_torch.apps.verify", "--device", "cpu",
              "--variant", "lyr3-tiny"],
             ["tpu_cnn_torch.apps.infer", "--image",
              "artifacts/pretrained/test_image_0_class3.bin", "--device",
              "cpu", "--no-save"],
             ["tpu_cnn_torch.apps.realtime", "--mode", "cpu", "--source",
              "synthetic", "--frames", "3", "--no-serve", "--multi",
              "--track"],
             ["tpu_cnn_torch.apps.eval_detection", "--device", "cpu",
              "--mode", "mega", "--n-per-class", "2"],
             ["tpu_cnn_torch.apps.benchmark", "--device", "cpu", "--batch",
              "2", "--runs", "1", "--modes", "mega,cpu"],
             ["tpu_cnn_torch.train.train_cnn", "--device", "cpu",
              "--synthetic", "--variant", "lyr3-tiny", "--epochs", "1",
              "--max-per-class", "50", "--output-dir", OUT],
             ["tpu_cnn_torch.apps.benchmark", "--host-ingest", "--device", "cpu",
              "--batch", "4", "--runs", "2", "--cam-res", "64x48"],
             ["tpu_cnn_torch.apps.export_model", "--backend", "xla",
              "--platforms", "cpu", "--batch", "2", "--output",
              OUT + "/m.tcnnx"],
             ["tpu_cnn_torch.apps.export_model", "--load", OUT + "/m.tcnnx",
              "--device", "cpu", "--image",
              "artifacts/pretrained/test_image_0_class3.bin"],
             ["scripts/bench_serving_torch.py", "--device", "cpu", "--mode",
              "mega", "--duration", "0.3", "--conc", "2", "--max-batch", "4"],
             ["tpu_cnn_torch.parallel.dryrun", "--devices", "4", "--cpu"],
             ["tpu_cnn_torch.apps.infer", "--mode", "mesh", "--device", "cpu",
              "--no-save"],
             ["scripts/build_pretrained_torch.py", "--device", "cpu", "--mode",
              "cpu", "--epochs", "1", "--n-per-class", "16", "--out",
              OUT + "/pre"]):
    out = io.StringIO()
    sys.argv = [argv[0]] + argv[1:]
    code = 0
    with redirect_stdout(out):
        try:
            if argv[0].endswith(".py"):
                runpy.run_path(argv[0], run_name="__main__")
            else:
                runpy.run_module(argv[0], run_name="__main__", alter_sys=True)
        except SystemExit as e:
            code = e.code or 0
    runs[argv[0] if argv[0] not in runs else " ".join(argv[:2])] = (
        code, out.getvalue())
runs["bundle"] = sorted(__import__("os").listdir(OUT))
loaded = sorted(m for m in sys.modules
                if any(m == r or m.startswith(r + ".") for r in REFUSED))
print(json.dumps({"modules": names, "runs": runs, "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def refusing_run(tmp_path_factory):
    """One process that refuses ``tpu_cnn``, ``jax``, ``optax`` and
    ``orbax``: imports every
    port module, then runs the port's CLIs as ``python -m`` (the trainer
    into a temporary bundle directory)."""
    # one thread, as the suite pins torch in every file: the process runs
    # beside the other workers, and unpinned it slows past its timeout
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = str(tmp_path_factory.mktemp("trained"))
    proc = subprocess.run([sys.executable, "-c", _REFUSING_PROCESS, out],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def test_every_module_imports_with_the_jax_package_refused(refusing_run):
    names = refusing_run["modules"]
    assert len(names) >= 30, names
    for n in ("tpu_cnn_torch.head.cam", "tpu_cnn_torch.native.oracle",
              "tpu_cnn_torch.engine.cpu_ref", "tpu_cnn_torch.apps.common",
              "tpu_cnn_torch.models.registry", "tpu_cnn_torch.utils.weights",
              "tpu_cnn_torch.ops.luma", "tpu_cnn_torch.ops.preprocess",
              "tpu_cnn_torch.native.preprocess", "tpu_cnn_torch.head.tracker",
              "tpu_cnn_torch.utils.profiling", "tpu_cnn_torch.apps.realtime"):
        assert n in names
    assert refusing_run["loaded"] == []


def test_verify_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.apps.verify"]
    assert code == 0, out
    assert VERDICT in out
    assert "numpy vs native    : BIT-EXACT" in out


def test_the_scan_sees_the_new_modules():
    for path in ("tpu_cnn_torch/ops/luma.py", "tpu_cnn_torch/ops/preprocess.py",
                 "tpu_cnn_torch/native/preprocess.py",
                 "tpu_cnn_torch/head/tracker.py",
                 "tpu_cnn_torch/utils/profiling.py",
                 "tpu_cnn_torch/apps/realtime.py"):
        assert path in PORT_FILES


def test_realtime_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.apps.realtime"]
    assert code == 0, out
    assert "Engine: CPURefEngine:native-c++" in out
    assert "Host preprocess: native-c++" in out and "Done. 3 frames." in out


def test_the_scan_sees_the_offline_tools():
    for path in ("tpu_cnn_torch/train/data.py", "tpu_cnn_torch/utils/metrics.py",
                 "tpu_cnn_torch/utils/roofline.py",
                 "tpu_cnn_torch/apps/eval_detection.py",
                 "tpu_cnn_torch/apps/eval_tracking.py",
                 "tpu_cnn_torch/apps/dump_features.py",
                 "tpu_cnn_torch/apps/train_bbox.py",
                 "tpu_cnn_torch/apps/doctor.py",
                 "tpu_cnn_torch/apps/benchmark.py"):
        assert path in PORT_FILES


def test_eval_detection_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.apps.eval_detection"]
    assert code == 0, out
    assert "  samples: 12 (6 classes)" in out and "mean CAM-box IoU:" in out
    assert "tpu_cnn_torch.train.data" in refusing_run["modules"]


def test_benchmark_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.apps.benchmark"]
    assert code == 0, out
    assert "Total: 40.1M MACs/image" in out and "BEST:" in out
    assert "FAILED" not in out


def test_infer_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.apps.infer"]
    assert code == 0, out
    assert "Image:      test_image_0_class3.bin (true: class 3)" in out
    assert "Prediction:" in out and "BBox:" in out


def test_the_scan_sees_the_trainer_and_head_tools():
    for path in ("tpu_cnn_torch/train/train_cnn.py",
                 "tpu_cnn_torch/train/checkpoint.py",
                 "tpu_cnn_torch/apps/retrain_classifier.py",
                 "tpu_cnn_torch/apps/tune_shifts.py",
                 "tpu_cnn_torch/apps/calibrate_multi.py"):
        assert path in PORT_FILES


def test_train_cli_with_the_jax_package_refused(refusing_run):
    code, out = refusing_run["runs"]["tpu_cnn_torch.train.train_cnn"]
    assert code == 0, out
    assert "Phase 1: float training (1 epochs, 250 train / 50 val) on cpu" in out
    assert "Exported: weights.bin" in out
    assert {"weights.bin", "fc_weight.npy", "fc_bias.npy", "classes.json",
            "shifts.json"} <= set(refusing_run["runs"]["bundle"])
    for n in ("tpu_cnn_torch.train.checkpoint", "tpu_cnn_torch.apps.tune_shifts",
              "tpu_cnn_torch.apps.calibrate_multi",
              "tpu_cnn_torch.apps.retrain_classifier"):
        assert n in refusing_run["modules"]


def test_the_scan_sees_the_deployment_path():
    for path in ("tpu_cnn_torch/native/ring.py",
                 "tpu_cnn_torch/apps/serve_native.py",
                 "tpu_cnn_torch/apps/export_model.py",
                 "tpu_cnn_torch/deploy.py", "tpu_cnn_torch/ops/library.py",
                 "tpu_cnn_torch/head/detections.py",
                 "scripts/bench_serving_torch.py"):
        assert path in PORT_FILES


def test_deployment_path_with_the_jax_package_refused(refusing_run):
    for n in ("tpu_cnn_torch.native.ring", "tpu_cnn_torch.apps.serve_native",
              "tpu_cnn_torch.apps.export_model", "tpu_cnn_torch.deploy",
              "tpu_cnn_torch.ops.library"):
        assert n in refusing_run["modules"]
    runs = refusing_run["runs"]
    code, out = runs["tpu_cnn_torch.apps.benchmark --host-ingest"]
    assert code == 0 and "frames/s" in out, out
    code, out = runs["tpu_cnn_torch.apps.export_model"]
    assert code == 0 and "exported" in out, out
    code, out = runs["tpu_cnn_torch.apps.export_model --load"]
    assert code == 0 and "(torch.export)" in out and "box [" in out, out
    code, out = runs["scripts/bench_serving_torch.py"]
    assert code == 0 and "native  conc=2" in out and "python  conc=2" in out, out


def test_the_scan_sees_the_mesh():
    for path in ("tpu_cnn_torch/parallel/__init__.py",
                 "tpu_cnn_torch/parallel/mesh.py",
                 "tpu_cnn_torch/parallel/pipeline.py",
                 "tpu_cnn_torch/parallel/spatial.py",
                 "tpu_cnn_torch/parallel/multihost.py",
                 "tpu_cnn_torch/parallel/dryrun.py",
                 "scripts/build_pretrained_torch.py"):
        assert path in PORT_FILES


def test_mesh_and_build_pretrained_with_the_jax_package_refused(refusing_run):
    for n in ("tpu_cnn_torch.parallel", "tpu_cnn_torch.parallel.mesh",
              "tpu_cnn_torch.parallel.pipeline", "tpu_cnn_torch.parallel.spatial",
              "tpu_cnn_torch.parallel.multihost", "tpu_cnn_torch.parallel.dryrun"):
        assert n in refusing_run["modules"]
    runs = refusing_run["runs"]
    code, out = runs["tpu_cnn_torch.parallel.dryrun"]
    assert code == 0 and "every meshed path equals" in out, out
    code, out = runs["tpu_cnn_torch.apps.infer --mode"]
    assert code == 0 and "MeshEngine (mesh[(1, 1)]:mega)" in out, out
    code, out = runs["scripts/build_pretrained_torch.py"]
    assert code == 0 and "Bundle complete in" in out, out
    assert "pre" in refusing_run["runs"]["bundle"]


def test_the_scan_sees_the_bench_and_the_graft_entry(refusing_run):
    """The headline bench and the graft entry: scanned, and
    imported with the JAX package refused."""
    for path in ("tpu_cnn_torch/bench.py", "tpu_cnn_torch/graft_entry.py"):
        assert path in PORT_FILES
        assert not [n for n in _imports(path) if _refused(n)]
    for n in ("tpu_cnn_torch.bench", "tpu_cnn_torch.graft_entry"):
        assert n in refusing_run["modules"]
