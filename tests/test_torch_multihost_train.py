"""Multi-process training over gloo for real: OS processes joined with
``tpu_cnn_torch.parallel.multihost.init_multihost``, each with a mesh of
virtual CPU positions, as ``tests/test_multihost.py`` runs the JAX
package's: two ranks of four positions, and four ranks of two.

Each rank, from the same initial parameters and the same global batch of
32 (lyr3-tiny):

- takes its slice through ``global_batches`` and runs one data-parallel
  step, the gradient all-reduced over the ranks: the parameters must be
  bit-equal across ranks and within ``atol=1e-6`` of the single-process
  plain step (this test computes it), the JAX suite's tolerance;
- runs one ZeRO-1 step, each rank holding its blocks of the moments and
  the updated parameter blocks gathered over the ranks (held to the same
  tolerances), and round-trips that state through a
  ``ShardedCheckpointer`` (each rank writes and restores its own blocks);
- runs the full two-phase ``train()``, only the primary exporting (each
  rank is given its own output directory, so the others' must stay
  absent);
- resumes with a ``.npz`` checkpoint that only rank 0 sees: every rank
  raises "resume desync";
- trains with rank 1 alone raising SIGTERM in its first step: every rank
  stops after epoch 1 and returns None (the signal is raised
  synchronously in the step, so the test has no race), and the sharded
  checkpoint's step 1 is whole;
- refuses an uneven topology (rank r bringing r + 1 positions).

This file is its own worker: ``python tests/test_torch_multihost_train.py
<rank> <world> <port> <out_dir> <local positions>`` runs one rank."""

import os
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ((1, 16, 32), (16, 32, 16), (32, 64, 8))


def _cfg(**kw):
    from tpu_cnn_torch.train.train_cnn import TrainConfig

    return TrainConfig(**dict(dict(layer_configs=TINY, epochs=2, batch_size=32,
                                   head_epochs=50), **kw))


def _batch():
    rs = np.random.RandomState(7)
    return (rs.rand(32, 32, 32).astype(np.float32),
            rs.randint(0, 6, 32).astype(np.int64))


def _data():
    from tpu_cnn_torch.train import data as D

    imgs, labels = D.SyntheticShapes(n_per_class=16, img_size=32).arrays()
    n_val = len(imgs) // 6
    return (imgs[n_val:], labels[n_val:]), (imgs[:n_val], labels[:n_val])


def _steps(mesh, zero1: bool):
    """One step from the seed-0 draw on the given mesh (None: plain, the
    whole batch; else this rank's slice): (loss, params, state)."""
    import torch

    from tpu_cnn_torch.parallel import multihost as mh
    from tpu_cnn_torch.train import train_cnn as T

    cfg = _cfg()
    net = T.init_params(cfg, torch.Generator().manual_seed(0))
    opt = T.AdamCosine(1e-3)
    state = opt.init(net.params())
    bi, bl = _batch()
    if mesh is not None:
        (bi, bl), = mh.global_batches(mesh, [(bi, bl)])
    loss, _ = T.make_train_step(cfg, opt, mesh, zero1=zero1)(
        net, state, torch.from_numpy(bi), torch.from_numpy(bl))
    return float(loss), T.params_to_numpy(net), state


def _worker(rank: int, world: int, port: int, out: str, n_local: int):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from tpu_cnn_torch.parallel import multihost as mh
    from tpu_cnn_torch.parallel.mesh import RowShards, make_mesh
    from tpu_cnn_torch.train import checkpoint as ckpt
    from tpu_cnn_torch.train import train_cnn as T
    from tpu_cnn_torch.train.checkpoint_sharded import ShardedCheckpointer

    mh.init_multihost(f"127.0.0.1:{port}", world, rank)
    mesh = make_mesh(devices=[torch.device("cpu")] * n_local)
    res = {}
    for tag, zero1 in (("dp", False), ("zero1", True)):
        loss, params, state = _steps(mesh, zero1)
        res[f"{tag}_loss"] = np.float32(loss)
        res.update({f"{tag}_{k}": v for k, v in params.items()})
    mu = state["mu"]["conv0"]  # 16 rows in world * n_local = 8 blocks
    assert isinstance(mu, RowShards) and mu.first == rank * n_local
    assert len(mu.parts) == n_local and mu.n_blocks == 8
    np.savez(os.path.join(out, f"step{rank}.npz"), **res)

    net = T.params_from_numpy({k: res[f"zero1_{k}"] for k in params})
    path = os.path.join(out, "ck")
    with ShardedCheckpointer(path) as ck:
        ck.save(1, net.params(), state, 0.5, net.params())
    dist.barrier()  # every rank's piece in place before anyone restores
    assert sorted(os.listdir(os.path.join(path, "1"))) == [
        f"rank{r}" for r in range(world)]
    like = T.zero1_constrain(T.AdamCosine(1e-3).init(net.params()), mesh)
    p, o, epoch, acc, _ = ShardedCheckpointer(path).restore(net.params(), like)
    assert (epoch, acc) == (1, 0.5)
    for g in ("mu", "nu"):
        for k, t in o[g].items():
            want = state[g][k]
            if isinstance(t, RowShards):
                assert t.first == want.first
                assert all(torch.equal(a, b) for a, b in zip(t.parts, want.parts))
            else:
                assert torch.equal(t, want)
    assert all(torch.equal(p[k], v.detach()) for k, v in net.params().items())
    print(f"rank {rank} ckpt roundtrip ok", flush=True)

    train_data, val_data = _data()
    bundle = T.train(_cfg(), train_data, val_data,
                     os.path.join(out, f"bundle{rank}"), mesh=mesh,
                     verbose=mh.is_primary(), device="cpu")
    assert bundle is not None
    np.save(os.path.join(out, f"fc{rank}.npy"), bundle.fc_weight)

    # resume consensus: rank 0 sees a checkpoint at epoch 1, the others none
    seen = os.path.join(out, f"seen{rank}.npz")
    if rank == 0:
        net = T.init_params(_cfg(), torch.Generator().manual_seed(0))
        opt = T.AdamCosine(1e-3, 10)
        ckpt.save_checkpoint(seen, net.params(), opt.leaves(opt.init(net.params())),
                             1, 0.5, net.params())
    try:
        T.train(_cfg(), train_data, val_data, os.path.join(out, "never"),
                mesh=mesh, verbose=False, checkpoint_path=seen, resume=True,
                device="cpu")
        raise AssertionError("ranks with different start epochs trained")
    except RuntimeError as e:
        assert "resume desync" in str(e)

    # SIGTERM on rank 1 alone, raised in its first step: all stop together
    orig = T.make_train_step
    if rank == 1:
        def make(*a, **kw):
            step = orig(*a, **kw)
            sent = []

            def wrapped(*args):
                if not sent:
                    sent.append(1)
                    signal.raise_signal(signal.SIGTERM)
                return step(*args)
            return wrapped

        T.make_train_step = make
    stopped = T.train(_cfg(epochs=5), train_data, val_data,
                      os.path.join(out, "stopped"), mesh=mesh, verbose=False,
                      checkpoint_path=os.path.join(out, "sig"), device="cpu")
    T.make_train_step = orig
    assert stopped is None
    dist.barrier()
    assert ShardedCheckpointer(os.path.join(out, "sig")).latest() == 1
    assert sorted(os.listdir(os.path.join(out, "sig"))) == ["1"]

    try:  # rank r brings r + 1 positions: not homogeneous
        T.train(_cfg(batch_size=120), train_data, val_data,
                os.path.join(out, "never"),
                mesh=make_mesh(devices=[torch.device("cpu")] * (rank + 1)),
                verbose=False, device="cpu")
        raise AssertionError("an uneven topology was not refused")
    except ValueError as e:
        assert "homogeneous topology" in str(e)
    mh.shutdown_multihost()
    print(f"rank {rank} done", flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("nproc,n_local", [(2, 4), (4, 2)])
def test_multi_process_train(tmp_path, nproc, n_local):
    pytest.importorskip("torch", reason="torch not installed: the PyTorch "
                                        "port cannot be tested")
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
        assert f"rank {rank} ckpt roundtrip ok" in out
        assert f"rank {rank} done" in out
    import torch

    torch.set_num_threads(1)
    got = [np.load(tmp_path / f"step{r}.npz") for r in range(nproc)]
    for tag in ("dp", "zero1"):
        for r in range(1, nproc):  # every rank the same bits
            for k in got[0].files:
                np.testing.assert_array_equal(got[r][k], got[0][k])
        loss, params, _ = _steps(None, False)  # the single-process step
        np.testing.assert_allclose(got[0][f"{tag}_loss"], loss, rtol=0, atol=1e-6)
        for k, v in params.items():
            np.testing.assert_allclose(got[0][f"{tag}_{k}"], v, rtol=0, atol=1e-6,
                                       err_msg=f"{tag} {k}")
    # the primary alone exported; every rank computed the same bundle
    assert (tmp_path / "bundle0" / "weights.bin").exists()
    assert not any((tmp_path / f"bundle{r}").exists() for r in range(1, nproc))
    for r in range(1, nproc):
        np.testing.assert_array_equal(np.load(tmp_path / f"fc{r}.npy"),
                                      np.load(tmp_path / "fc0.npy"))
    assert not (tmp_path / "never").exists()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
            int(sys.argv[5]))
