"""The port's golden-model verifier (``tpu_cnn_torch.apps.verify``) on the
CPU: every backend's plain version against the numpy and native oracles
and the engines' heads against the host twins, with the reference's
per-channel report and verdict. A corrupted backend exits 1; a backend
named on the command line that cannot run exits non-zero instead of being
skipped.

On the card the same CLI runs with ``--device cuda`` (``chip_smoke.py``
runs it for lyr3-std and lyr4-wide)."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

from tpu_cnn_torch.apps import verify  # noqa: E402
from tpu_cnn_torch.ops import int8  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERDICT = "VERDICT: DESIGN IS BIT-ACCURATE across all backends"


def test_verify_lyr3_tiny_is_bit_accurate_without_jax(tmp_path):
    """All seven backends, in a process that never imports JAX (the card's
    machine need not have it): exit 0 and the verdict. The native oracle
    builds into its own directory, apart from other test processes."""
    code = (
        "import sys\n"
        "from tpu_cnn_torch.apps import verify\n"
        "rc = verify.main(['--device', 'cpu', '--variant', 'lyr3-tiny'])\n"
        "assert not [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=REPO, TPU_CNN_BUILD_DIR=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = proc.stdout
    assert VERDICT in out
    for name in verify.BACKENDS[1:]:
        assert f"numpy vs {name:10s}: BIT-EXACT" in out
    for name in ("pallas", "hybrid", "mega", "xla-f32", "xla-int32"):
        assert f"head[{name}] vs host twin CAM bbox     : OK" in out
    for name in ("pallas", "hybrid", "mega", "xla-f32", "xla-int32"):
        for check in ("multi boxes", "instances", "multi scores"):
            assert f"head[{name}] vs host twin {check:13s}: OK" in out


def test_verify_lyr3_std_shipped_weights(capsys):
    assert verify.main(["--device", "cpu", "--images", "1",
                        "--backends", "numpy,pallas,hybrid,mega"]) == 0
    out = capsys.readouterr().out
    assert "[lyr3-std, port on cpu]" in out and VERDICT in out


def test_corrupted_backend_exits_1_with_the_report(monkeypatch, capsys):
    real = int8.cnn_forward_pallas

    def corrupted(images, kernels, shifts):
        out = real(images, kernels, shifts).clone()
        out[0, 3, 5] ^= 1  # one flipped bit in channel 3 of the first stimulus
        return out

    monkeypatch.setattr(int8, "cnn_forward_pallas", corrupted)
    rc = verify.main(["--device", "cpu", "--variant", "lyr3-tiny",
                      "--backends", "numpy,pallas,hybrid"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "numpy vs pallas    : MISMATCH" in out
    assert "stimulus ramp: 1 mismatched values in channels [3]" in out
    assert "numpy vs hybrid    : BIT-EXACT" in out
    assert "VERDICT: MISMATCHES FOUND" in out


def test_named_backend_that_cannot_run_exits_nonzero(monkeypatch, capsys):
    def broken():
        raise RuntimeError("native oracle build failed")

    monkeypatch.setattr(verify, "NativeOracle", broken)
    rc = verify.main(["--device", "cpu", "--variant", "lyr3-tiny",
                      "--backends", "numpy,native,pallas"])
    out = capsys.readouterr().out
    assert rc == 2
    assert "backend cannot run: native: RuntimeError" in out
    assert VERDICT not in out


def test_cuda_device_without_a_card_exits_nonzero(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rc = verify.main(["--device", "cuda", "--variant", "lyr3-tiny",
                      "--backends", "numpy,pallas"])
    assert rc == 2
    assert "pallas: RuntimeError" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--backends", "numpy,torch"],  # not offered by the port
    ["--shifts", "2,-1,6"],
    ["--shifts", "2,4,32"],
    ["--shifts", "2,4"],
])
def test_bad_arguments_exit_nonzero(argv):
    with pytest.raises(SystemExit) as e:
        verify.main(["--device", "cpu", "--variant", "lyr3-tiny"] + argv)
    assert e.value.code != 0


def test_stimuli_are_the_references():
    from tpu_cnn.apps.verify import make_stimuli

    stims = make_stimuli(2, None, size=32)
    assert list(stims) == ["ramp", "zeros", "full255", "random0", "random1"]
    assert all(s.shape == (32, 32) and s.dtype == np.uint8
               for s in stims.values())
    ours = verify.make_stimuli(2, None, size=32)
    assert list(ours) == list(stims)
    assert all(np.array_equal(ours[k], stims[k]) for k in stims)
