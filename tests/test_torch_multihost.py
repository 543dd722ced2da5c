"""The port's multi-process engine (``tpu_cnn_torch.parallel.multihost``)
for real: OS processes joined over ``torch.distributed`` with gloo, each
with a mesh of virtual CPU positions, as ``tests/test_multihost.py`` runs
the JAX package's: two ranks of four positions, and four ranks of two.

Each rank feeds its own, uneven, batch through ``MultiHostEngine`` (a rank
with nothing to feed still joins the call and gets an empty result), gets
exactly its own rows back, and writes them for this test, which holds
them to the JAX package's numpy oracle and to the single-process
``CUDAEngine`` on the CPU; ``allgather_to_host`` gives every rank every
rank's rows, and an uneven topology is refused on every rank.

This file is its own worker: ``python tests/test_torch_multihost.py <rank>
<world> <port> <out_dir> <local positions>`` runs one rank."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFGS = ((1, 16, 32), (16, 32, 16), (32, 64, 8))
SHIFTS = (2, 4, 6)
FEEDS = (5, 3, 2, 4)  # frames per rank: uneven across ranks


def _model():
    from tpu_cnn_torch.models.cnn import CNNConfig, FpgaCNN

    rs = np.random.RandomState(11)
    ks = [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
          for ic, oc, _ in CFGS]
    fc = np.random.RandomState(5).randn(6, 64 * 16).astype(np.float32) * 0.05
    return FpgaCNN(ks, fc, np.zeros(6, np.float32), shifts=SHIFTS,
                   config=CNNConfig(layer_configs=CFGS))


def _images(rank: int) -> np.ndarray:
    return np.random.RandomState(100 + rank).randint(
        0, 256, (FEEDS[rank % 4], 32, 32)).astype(np.uint8)


def _worker(rank: int, world: int, port: int, out_dir: str, n_local: int):
    import torch

    torch.set_num_threads(1)
    from tpu_cnn_torch.engine.cpu_ref import numpy_cnn_forward
    from tpu_cnn_torch.parallel import multihost as mh

    mh.init_multihost(f"127.0.0.1:{port}", world, rank)
    assert mh.process_count() == world and mh.is_primary() == (rank == 0)
    devices = [torch.device("cpu")] * n_local
    model = _model()
    imgs = _images(rank)
    out = {}
    for backend in ("xla", "mega"):
        eng = mh.MultiHostEngine(model, backend=backend, devices=devices)
        assert eng.backend == f"multihost:mesh[({n_local}, 1)]:{backend}"
        feats = eng.run_batch(imgs)
        assert feats.shape[0] == len(imgs)
        for i in range(len(imgs)):
            np.testing.assert_array_equal(
                feats[i], numpy_cnn_forward(imgs[i], model.kernels, SHIFTS))
        res = eng.detect_batch(imgs)
        assert res.pred.shape == (len(imgs),) and res.bbox.shape == (len(imgs), 4)
        out.update({f"{backend}_feats": feats, f"{backend}_pred": res.pred,
                    f"{backend}_probs": res.probs, f"{backend}_bbox": res.bbox})
        # only rank 0 feeds this tick; the others join and get nothing
        n0 = 4 if rank == 0 else 0
        assert eng.run_batch(imgs[:n0]).shape[0] == n0
        assert eng.detect_batch(imgs[:n0]).pred.shape == (n0,)
    everyone = mh.allgather_to_host(out["mega_pred"])
    assert everyone.shape == (sum(FEEDS[r % 4] for r in range(world)),)
    mine = sum(FEEDS[r % 4] for r in range(rank))
    np.testing.assert_array_equal(everyone[mine:mine + len(imgs)],
                                  out["mega_pred"])
    try:  # rank r brings r + 1 positions: not homogeneous
        mh.MultiHostEngine(model, backend="xla",
                           devices=[torch.device("cpu")] * (rank + 1))
        raise AssertionError("an uneven topology was not refused")
    except ValueError as e:
        assert "homogeneous topology" in str(e)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    mh.shutdown_multihost()
    assert mh.process_count() == 1
    print(f"rank {rank} engine ok", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc,n_local", [(2, 4), (4, 2)])
def test_multi_process_engine(tmp_path, nproc, n_local):
    pytest.importorskip("torch", reason="torch not installed: the PyTorch "
                                        "port cannot be tested")
    from tpu_cnn.engine.cpu_ref import numpy_cnn_forward
    from tpu_cnn_torch.engine.cuda import CUDAEngine

    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(nproc),
             str(port), str(tmp_path), str(n_local)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for rank in range(nproc)
    ]
    try:
        outs = [pr.communicate(timeout=300)[0] for pr in procs]
    finally:
        # a wedged rank must not outlive the test: its peers would block in
        # the next collective
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    for rank, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, out
        assert f"rank {rank} engine ok" in out
    model = _model()
    single = CUDAEngine(model, "cpu", backend="xla")
    for rank in range(nproc):
        got = np.load(tmp_path / f"rank{rank}.npz")
        imgs = _images(rank)
        want = single.detect_batch(imgs)
        for backend in ("xla", "mega"):
            for i in range(len(imgs)):  # the JAX package's oracle
                np.testing.assert_array_equal(
                    got[f"{backend}_feats"][i],
                    numpy_cnn_forward(imgs[i], model.kernels, SHIFTS))
            np.testing.assert_array_equal(got[f"{backend}_pred"], want.pred)
            np.testing.assert_array_equal(got[f"{backend}_bbox"], want.bbox)
            np.testing.assert_allclose(got[f"{backend}_probs"], want.probs,
                                       rtol=0, atol=1e-4)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            int(sys.argv[5]))
