"""The port's training mesh against the JAX package's on the CPU: the
(data, model) and ZeRO-1 steps of ``train_cnn.make_train_step``, the
pipelined step (``parallel.pipeline_train``), the row-sharded step
(``parallel.spatial_train``), ``train()`` on each layout, and the sharded
checkpoint directory (``train.checkpoint_sharded``).

Setup, as ``tests/test_training.py``'s: lyr3-tiny (32x32, 1->16->32->64),
batch 32 of ``SyntheticShapes``, the JAX trainer's ``init_params`` at
PRNGKey(0) carried across with ``params_from_numpy``, ``optax.adam(1e-3)``
against ``AdamCosine(1e-3)``; the port on eight virtual CPU positions
(``[torch.device("cpu")] * 8``), JAX on the suite's eight virtual devices.

Tolerances, stated up front:

- One step of a layout against the JAX package's same step and against
  the port's plain step: the loss within 1e-6 and every parameter within
  ``atol=1e-6`` (JAX's own for its twins, ``tests/test_training.py``;
  measured: every layout within 4e-7 of both). The JAX dp x tp step is
  held there too, though JAX's own test allows it 1e-4.
- Logits: the pipelined logits bit-equal to ``float_forward`` on one
  pipe (each stage runs its real channels on the same microbatch, so
  nothing is added in another order), within 1e-5 on (data, pipe) and
  on the row-sharded layouts (the GAP adds its partial sums in another
  order), JAX's tolerances.
- ``train()`` end to end: ``tests/test_torch_train.py``'s: per-epoch mean
  losses within 1e-4 relative, the printed val accuracies equal, the
  phase-1 parameters within 1e-4 or else at most 0.1% of the elements
  off, each by under ``2 * lr * steps``, and weights.bin off by 1 LSB on
  at most 0.1% of the elements.
- The sharded checkpoint: a round trip is equal; a resumed run equals the
  unbroken run exactly (the CPU is deterministic).
"""

import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpu_cnn.parallel import mesh as j_mesh  # noqa: E402
from tpu_cnn.parallel import pipeline as j_pipeline  # noqa: E402
from tpu_cnn.parallel import spatial as j_spatial  # noqa: E402
from tpu_cnn.parallel.pipeline_train import pipelined_float_logits as j_pipe_logits  # noqa: E402
from tpu_cnn.parallel.spatial_train import spatial_float_logits as j_space_logits  # noqa: E402
from tpu_cnn.train import train_cnn as J  # noqa: E402
from tpu_cnn_torch.parallel import mesh, pipeline, spatial  # noqa: E402
from tpu_cnn_torch.parallel.mesh import RowShards  # noqa: E402
from tpu_cnn_torch.parallel.pipeline_train import pipelined_float_logits  # noqa: E402
from tpu_cnn_torch.parallel.spatial_train import spatial_float_logits  # noqa: E402
from tpu_cnn_torch.train import data as D  # noqa: E402
from tpu_cnn_torch.train import train_cnn as T  # noqa: E402
from tpu_cnn_torch.train.checkpoint_sharded import ShardedCheckpointer  # noqa: E402

TINY = ((1, 16, 32), (16, 32, 16), (32, 64, 8))
CPU8 = [torch.device("cpu")] * 8
LR = 1e-3
ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread beside JAX's pool (the suite runs files in
    parallel); the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """(initial parameters as numpy, images (32, 32, 32) f32, labels (32,)
    int32): the JAX suite's draw and batch."""
    cfg = J.TrainConfig(layer_configs=TINY)
    p0 = {k: np.asarray(v) for k, v in J.init_params(cfg, jax.random.PRNGKey(0)).items()}
    imgs, labels = D.SyntheticShapes(n_per_class=16, img_size=32).arrays()
    return p0, imgs[:32], labels[:32].astype(np.int32)


def _port_step(p0, bi, bl, mesh_=None, steps=1, **kw):
    """``steps`` port steps from p0: (losses, params, optimiser state)."""
    net = T.params_from_numpy(p0)
    opt = T.AdamCosine(LR)
    state = opt.init(net.params())
    step = T.make_train_step(T.TrainConfig(layer_configs=TINY, batch_size=32),
                             opt, mesh_, **kw)
    losses = [float(step(net, state, torch.as_tensor(bi),
                         torch.as_tensor(bl.astype(np.int64)))[0])
              for _ in range(steps)]
    return losses, T.params_to_numpy(net), state


def _jax_step(p0, bi, bl, mesh_=None, **kw):
    """One JAX step from p0: (loss, params)."""
    cfg = J.TrainConfig(layer_configs=TINY, batch_size=32)
    opt = optax.adam(LR)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    if mesh_ is not None and "model" in mesh_.axis_names:
        params = jax.tree.map(jax.device_put, params, J.param_shardings(cfg, mesh_))
    p, _, loss, _ = J.make_train_step(cfg, opt, mesh_, **kw)(
        params, opt.init(params), jnp.asarray(bi), jnp.asarray(bl))
    return float(loss), {k: np.asarray(v) for k, v in p.items()}


def _same_step(got, want):
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=0, atol=ATOL,
                                   err_msg=k)


@pytest.fixture(scope="module")
def plain(setup):
    """The port's plain step, and JAX's."""
    p0, bi, bl = setup
    losses, params, _ = _port_step(p0, bi, bl)
    return (losses[0], params), _jax_step(p0, bi, bl)


def test_plain_step_matches_jax(plain):
    _same_step(*plain)


LAYOUTS = {  # name -> (port mesh, JAX mesh, step options)
    "dp x tp 4x2": (lambda: mesh.make_mesh(8, model_axis=2, devices=CPU8),
                    lambda: j_mesh.make_mesh(8, model_axis=2), {}),
    "dp 8": (lambda: mesh.make_mesh(8, devices=CPU8),
             lambda: j_mesh.make_mesh(8, model_axis=1), {}),
    "zero1 8": (lambda: mesh.make_mesh(8, devices=CPU8),
                lambda: j_mesh.make_mesh(8, model_axis=1), {"zero1": True}),
    "pipe 3": (lambda: pipeline.make_pipeline_mesh(3, devices=CPU8),
               lambda: j_pipeline.make_pipeline_mesh(3), {"microbatch": 4}),
    "pipe 3 remat": (lambda: pipeline.make_pipeline_mesh(3, devices=CPU8),
                     lambda: j_pipeline.make_pipeline_mesh(3),
                     {"microbatch": 4, "remat": True}),
    "pipe 2x3": (lambda: pipeline.make_pipeline_mesh(6, data_axis=2, devices=CPU8),
                 lambda: j_pipeline.make_pipeline_mesh(6, data_axis=2),
                 {"microbatch": 4}),
    "space 4": (lambda: spatial.make_spatial_mesh(4, devices=CPU8),
                lambda: j_spatial.make_spatial_mesh(4), {}),
    "space 2x4": (lambda: spatial.make_spatial_mesh(8, data_axis=2, devices=CPU8),
                  lambda: j_spatial.make_spatial_mesh(8, data_axis=2), {}),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_layout_step_matches_jax_and_the_plain_step(name, setup, plain):
    p0, bi, bl = setup
    port_mesh, jax_mesh, kw = LAYOUTS[name]
    losses, params, _ = _port_step(p0, bi, bl, port_mesh(), **kw)
    got = (losses[0], params)
    _same_step(got, _jax_step(p0, bi, bl, jax_mesh(), **kw))
    _same_step(got, plain[0])


def test_zero1_shards_the_moments(setup, plain):
    """The moments of conv0-conv2 (16, 32, 64 rows) as 8 blocks, one per
    data position; fc_w (6 rows) and fc_b (6,) whole, as JAX's replicated
    leaves; a second step consumes the sharded state (equal to two plain
    steps); a model axis is refused."""
    p0, bi, bl = setup
    losses, _, state = _port_step(p0, bi, bl, mesh.make_mesh(8, devices=CPU8),
                                  steps=2, zero1=True)
    for group in ("mu", "nu"):
        for k, rows in (("conv0", 2), ("conv1", 4), ("conv2", 8)):
            t = state[group][k]
            assert isinstance(t, RowShards) and len(t.parts) == 8
            assert [p.shape[0] for p in t.parts] == [rows] * 8
            assert t.positions == [(d, 0) for d in range(8)]
        assert isinstance(state[group]["fc_w"], torch.Tensor)
        assert isinstance(state[group]["fc_b"], torch.Tensor)
    two, _, _ = _port_step(p0, bi, bl, steps=2)
    assert losses == pytest.approx(two, abs=1e-6)
    with pytest.raises(ValueError, match="pure data-parallel"):
        T.make_train_step(T.TrainConfig(layer_configs=TINY), T.AdamCosine(LR),
                          mesh.make_mesh(8, model_axis=2, devices=CPU8), zero1=True)


def test_zero1_state_reads_and_writes_the_npz_layout(setup):
    """AdamCosine.leaves gives a ZeRO-1 state whole (the .npz layout) and
    from_leaves puts it back in its blocks."""
    p0, bi, bl = setup
    _, _, state = _port_step(p0, bi, bl, mesh.make_mesh(4, devices=CPU8),
                             zero1=True)
    opt = T.AdamCosine(LR)
    leaves = opt.leaves(state)
    assert leaves[1].shape == (16, 1, 3, 3)
    back = opt.from_leaves(leaves, state)
    for k, t in state["mu"].items():
        if isinstance(t, RowShards):
            assert all(torch.equal(a, b) for a, b in zip(back["mu"][k].parts, t.parts))
        else:
            assert torch.equal(back["mu"][k], t)


@pytest.mark.parametrize("n,data", [(3, 1), (6, 2)])
def test_pipelined_logits(n, data, setup):
    p0, bi, _ = setup
    net = T.params_from_numpy(p0)
    got = pipelined_float_logits(pipeline.make_pipeline_mesh(n, data_axis=data,
                                                             devices=CPU8),
                                 TINY, microbatch=4)(net.params(), torch.as_tensor(bi))
    want = T.float_forward(net.params(), torch.as_tensor(bi), 3).detach().numpy()
    jx = np.asarray(j_pipe_logits(j_pipeline.make_pipeline_mesh(n, data_axis=data),
                                  TINY, microbatch=4)(
        {k: jnp.asarray(v) for k, v in p0.items()}, jnp.asarray(bi)))
    got = got.detach().numpy()
    if data == 1:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="not a multiple of microbatch"):
        pipelined_float_logits(pipeline.make_pipeline_mesh(n, data_axis=data,
                                                           devices=CPU8),
                               TINY, microbatch=5)(net.params(), torch.as_tensor(bi))


@pytest.mark.parametrize("remat", [False, True])
def test_pipelined_training_descends(remat, setup):
    """10 steps through one pipelined step (with and without remat) fall,
    and equal 10 plain steps."""
    p0, bi, bl = setup
    losses, params, _ = _port_step(p0, bi, bl, pipeline.make_pipeline_mesh(
        3, devices=CPU8), steps=10, microbatch=4, remat=remat)
    assert losses[-1] < losses[0]
    plain_losses, plain_params, _ = _port_step(p0, bi, bl, steps=10)
    np.testing.assert_allclose(losses, plain_losses, rtol=0, atol=1e-5)


@pytest.mark.parametrize("n,data", [(4, 1), (8, 2)])
def test_spatial_logits(n, data, setup):
    p0, bi, _ = setup
    net = T.params_from_numpy(p0)
    got = spatial_float_logits(spatial.make_spatial_mesh(n, data_axis=data,
                                                         devices=CPU8),
                               TINY)(net.params(), torch.as_tensor(bi)).detach().numpy()
    want = T.float_forward(net.params(), torch.as_tensor(bi), 3).detach().numpy()
    jx = np.asarray(j_space_logits(j_spatial.make_spatial_mesh(n, data_axis=data),
                                   TINY)({k: jnp.asarray(v) for k, v in p0.items()},
                                         jnp.asarray(bi)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, jx, rtol=0, atol=1e-5)


def test_spatial_refuses_a_straddling_split(setup):
    """Layer 2's 8 rows on 8 positions would put a pool window across two
    of them: refused, as by JAX."""
    p0, bi, _ = setup
    with pytest.raises(ValueError, match="straddle"):
        spatial_float_logits(spatial.make_spatial_mesh(8, devices=CPU8), TINY)(
            T.params_from_numpy(p0).params(), torch.as_tensor(bi))


def test_global_batches_in_one_process():
    """One process takes every row; a batch that does not tile the
    positions is refused; dense targets stay float32 (the JAX version's
    int32 cast would zero them)."""
    from tpu_cnn_torch.parallel.multihost import global_batches

    m = mesh.make_mesh(4, devices=CPU8)
    imgs = np.arange(8 * 2 * 2, dtype=np.float32).reshape(8, 2, 2)
    soft = np.full((8, 6), 0.5, np.float32)
    (bi, bl), = global_batches(m, [(imgs, soft)])
    np.testing.assert_array_equal(bi, imgs)
    assert bl.dtype == np.float32 and (bl == 0.5).all()
    with pytest.raises(ValueError, match="must divide by the mesh's device count 4"):
        list(global_batches(m, [(imgs[:6], soft[:6])]))


def test_dryrun_train_on_cpu_positions():
    from tpu_cnn_torch.parallel.dryrun import dryrun_train

    done = dryrun_train(8, CPU8)
    assert list(done) == ["dp x tp step", "zero1 step", "pipelined step",
                          "row-sharded step"]
    assert "8 blocks" in done["zero1 step"]


def test_twin_refusals():
    """bf16 and qat on the pipe/space twins, as JAX refuses them; dense
    composite targets there, which JAX's twins cannot take."""
    cfg = T.TrainConfig(layer_configs=TINY)
    opt = T.AdamCosine(LR)
    pipe = pipeline.make_pipeline_mesh(3, devices=CPU8)
    with pytest.raises(ValueError, match="bf16"):
        T.make_train_step(cfg, opt, pipe, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="qat"):
        T.make_train_step(cfg, opt, spatial.make_spatial_mesh(4, devices=CPU8),
                          qat=True)
    net = T.init_params(cfg, torch.Generator().manual_seed(0))
    step = T.make_train_step(cfg, opt, pipe)
    with pytest.raises(ValueError, match="integer labels only"):
        step(net, opt.init(net.params()), torch.zeros(4, 32, 32),
             torch.zeros(4, 6))
    with pytest.raises(ValueError, match="integer labels only"):
        T.train(cfg, (np.zeros((4, 32, 32), np.float32), np.zeros(4, int)),
                (np.zeros((4, 32, 32), np.float32), np.zeros(4, int)), "unused",
                mesh=pipe, aux_data=(np.zeros((2, 32, 32), np.float32),
                                     np.zeros((2, 6), np.float32)), device="cpu")


# ── train() on a mesh, against JAX's ─────────────────────────────────


class _Recorder:
    """Wraps a module's ``make_train_step``: records each step's loss and
    the latest parameters. It observes, it changes nothing."""

    def __init__(self, module, monkeypatch, port: bool):
        self.losses, self.last = [], None
        orig = module.make_train_step

        def make(*a, **kw):
            step = orig(*a, **kw)

            def wrapped(*args):
                out = step(*args)
                if port:
                    self.losses.append(float(out[0]))
                    self.last = T.params_to_numpy(args[0])
                else:
                    self.losses.append(float(out[2]))
                    self.last = {k: np.asarray(v) for k, v in out[0].items()}
                return out
            return wrapped

        monkeypatch.setattr(module, "make_train_step", make)


def _data():
    imgs, labels = D.SyntheticShapes(n_per_class=20, img_size=32).arrays()
    return (imgs[24:], labels[24:]), (imgs[:24], labels[:24])


def _val_lines(text):
    return [ln.split("val")[-1].strip() for ln in text.splitlines()
            if ln.strip().startswith("epoch")]


TRAIN_KW = dict(layer_configs=TINY, epochs=2, batch_size=16, head_epochs=50,
                lr=3e-3)
E2E = {  # name -> (port mesh, JAX mesh, train() options)
    "mesh 4x2": (lambda: mesh.make_mesh(8, model_axis=2, devices=CPU8),
                 lambda: j_mesh.make_mesh(8, model_axis=2), {}),
    "pipeline 2x3": (lambda: pipeline.make_pipeline_mesh(6, data_axis=2, devices=CPU8),
                     lambda: j_pipeline.make_pipeline_mesh(6, data_axis=2),
                     {"microbatch": 4, "remat": True}),
    "spatial 2x4": (lambda: spatial.make_spatial_mesh(8, data_axis=2, devices=CPU8),
                    lambda: j_spatial.make_spatial_mesh(8, data_axis=2), {}),
}


@pytest.mark.parametrize("name", list(E2E))
def test_train_on_a_mesh_matches_jax(name, setup, tmp_path, monkeypatch, capsys):
    p0 = setup[0]
    port_mesh, jax_mesh, kw = E2E[name]
    monkeypatch.setattr(T, "init_params", lambda cfg, gen: T.params_from_numpy(p0))
    monkeypatch.setattr(J, "init_params",
                        lambda cfg, key: {k: jnp.asarray(v) for k, v in p0.items()})
    jrec = _Recorder(J, monkeypatch, port=False)
    prec = _Recorder(T, monkeypatch, port=True)
    train_data, val_data = _data()
    J.train(J.TrainConfig(**TRAIN_KW), train_data, val_data, str(tmp_path / "j"),
            mesh=jax_mesh(), **kw)
    jtext = capsys.readouterr().out
    T.train(T.TrainConfig(**TRAIN_KW), train_data, val_data, str(tmp_path / "t"),
            mesh=port_mesh(), device="cpu", **kw)
    ttext = capsys.readouterr().out
    steps = len(train_data[0]) // 16
    np.testing.assert_allclose(np.reshape(prec.losses, (2, steps)).mean(1),
                               np.reshape(jrec.losses, (2, steps)).mean(1), rtol=1e-4)
    assert _val_lines(ttext) == _val_lines(jtext) and len(_val_lines(ttext)) == 2
    for k in jrec.last:
        diff = np.abs(prec.last[k] - jrec.last[k])
        far = diff > 1e-4
        assert far.mean() <= 1e-3 and (diff[far] < 2 * 3e-3 * 2 * steps).all(), k
    a = np.fromfile(tmp_path / "t" / "weights.bin", np.int8).astype(int)
    b = np.fromfile(tmp_path / "j" / "weights.bin", np.int8).astype(int)
    assert np.abs(a - b).max() <= 1 and (a != b).mean() <= 1e-3


# ── the sharded checkpoint directory ─────────────────────────────────


def _state(setup, n=4):
    """A ZeRO-1 state after one step on n positions, and its net."""
    p0, bi, bl = setup
    net = T.params_from_numpy(p0)
    opt = T.AdamCosine(LR, 10, every_k=2)
    state = opt.init(net.params())
    step = T.make_train_step(T.TrainConfig(layer_configs=TINY), opt,
                             mesh.make_mesh(n, devices=CPU8), zero1=True)
    for _ in range(3):
        step(net, state, torch.as_tensor(bi), torch.as_tensor(bl.astype(np.int64)))
    return net, opt, state


def _equal_states(a, b):
    assert a.keys() == b.keys()
    for k, v in a.items():
        if isinstance(v, dict):
            _equal_states(v, b[k])
        elif isinstance(v, RowShards):
            assert (v.first, v.n_blocks, v.positions) == (b[k].first, b[k].n_blocks,
                                                          b[k].positions)
            assert all(torch.equal(x, y) for x, y in zip(v.parts, b[k].parts))
        elif isinstance(v, torch.Tensor):
            assert torch.equal(v, b[k])
        else:
            assert v == b[k]


def test_sharded_checkpoint_round_trip_and_retention(setup, tmp_path):
    net, opt, state = _state(setup)
    best = {k: v.detach() * 2 for k, v in net.params().items()}
    rng = np.random.RandomState(4)
    rng.rand(7)
    path = str(tmp_path / "ck")
    with ShardedCheckpointer(path) as ck:
        assert ck.latest() is None
        with pytest.raises(FileNotFoundError):
            ck.restore(net.params(), state)
        for epoch in (1, 2, 3):
            ck.save(epoch, net.params(), state, 0.25 * epoch, best, rng=rng)
    want_next = rng.rand(5)
    assert sorted(os.listdir(path)) == ["2", "3"]  # max_to_keep=2
    files = os.listdir(os.path.join(path, "3", "rank0"))
    assert "opt.mu.conv0.part3.npy" in files and "opt.mu.fc_b.npy" in files
    like = T.zero1_constrain(opt.init(net.params()), mesh.make_mesh(4, devices=CPU8))
    fresh = np.random.RandomState(0)
    ck = ShardedCheckpointer(path)
    assert ck.latest() == 3
    params, got, epoch, acc, best_back = ck.restore(net.params(), like, rng=fresh)
    assert (epoch, acc) == (3, 0.75)
    np.testing.assert_array_equal(fresh.rand(5), want_next)
    _equal_states(got, state)
    for k, v in net.params().items():
        assert torch.equal(params[k], v.detach())
        assert torch.equal(best_back[k], best[k])
    # a whole template gathers the blocks; the .npz layout reads the same
    whole = opt.init(net.params())
    _, got_whole, _, _, _ = ck.restore(net.params(), whole)
    assert opt.leaves(got_whole)[3].shape == (16, 1, 3, 3)
    for a, b in zip(opt.leaves(got_whole), opt.leaves(state)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    wide = dict(net.params(), fc_w=torch.zeros(6, 65))
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(wide, like)


def test_an_interrupted_save_leaves_the_previous_step(setup, tmp_path, monkeypatch):
    """A save that fails before its rename (the finalisation) leaves the
    previous step the latest, restorable; the failure surfaces at close."""
    net, opt, state = _state(setup)
    path = str(tmp_path / "ck")
    ck = ShardedCheckpointer(path)
    ck.save(1, net.params(), state, 0.5, net.params())
    ck.close()
    saved = {k: v.detach().clone() for k, v in net.params().items()}
    with torch.no_grad():
        for v in net.params().values():
            v.add_(1.0)

    def crash(src, dst):
        raise OSError("the machine went away before the rename")

    import tpu_cnn_torch.train.checkpoint_sharded as cs

    monkeypatch.setattr(cs.os, "rename", crash)
    ck.save(2, net.params(), state, 0.9, net.params())
    with pytest.raises(OSError, match="went away"):
        ck.close()
    monkeypatch.undo()
    assert ShardedCheckpointer(path).latest() == 1
    params, _, epoch, acc, _ = ShardedCheckpointer(path).restore(net.params(), state)
    assert (epoch, acc) == (1, 0.5)
    for k, v in saved.items():
        assert torch.equal(params[k], v)


def _stop_in_epoch_2(monkeypatch, steps_per_epoch):
    """SIGTERM the process at epoch 2's first step: the trainer finishes
    epoch 2, checkpoints and returns None."""
    orig = T.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)
        calls = []

        def wrapped(*args):
            calls.append(1)
            if len(calls) == steps_per_epoch + 1:
                signal.raise_signal(signal.SIGTERM)
            return step(*args)
        return wrapped

    monkeypatch.setattr(T, "make_train_step", make)


def test_sharded_resume_equals_the_unbroken_run(setup, tmp_path, monkeypatch, capsys):
    """--mesh 8 --zero1 with a sharded checkpoint, stopped by SIGTERM in
    epoch 2 and resumed: "(sharded) at epoch 2", and the same bundle and
    final checkpoint as the run that was never stopped."""
    train_data, val_data = _data()
    cfg = T.TrainConfig(**dict(TRAIN_KW, epochs=3))
    kw = dict(zero1=True, augment=True, device="cpu")

    def mesh8():
        return mesh.make_mesh(8, devices=CPU8)

    straight = T.train(cfg, train_data, val_data, str(tmp_path / "a"), mesh=mesh8(),
                       checkpoint_path=str(tmp_path / "ca"), **kw)
    with monkeypatch.context() as m:
        _stop_in_epoch_2(m, len(train_data[0]) // 16)
        assert T.train(cfg, train_data, val_data, str(tmp_path / "b"), mesh=mesh8(),
                       checkpoint_path=str(tmp_path / "cb"), **kw) is None
    assert ShardedCheckpointer(str(tmp_path / "cb")).latest() == 2
    resumed = T.train(cfg, train_data, val_data, str(tmp_path / "b"), mesh=mesh8(),
                      checkpoint_path=str(tmp_path / "cb"), resume=True, **kw)
    out = capsys.readouterr().out
    assert f"Resumed from {tmp_path / 'cb'} (sharded) at epoch 2" in out
    for x, y in zip(straight.kernels, resumed.kernels):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(straight.fc_weight, resumed.fc_weight)
    a, b = (os.path.join(tmp_path, c, "3", "rank0") for c in ("ca", "cb"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for f in os.listdir(a):
        if f.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, f)),
                                          np.load(os.path.join(b, f)), err_msg=f)
