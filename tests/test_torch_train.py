"""The port's trainer (``tpu_cnn_torch.train.train_cnn``, ``.checkpoint``)
against the JAX package's, on the CPU, at lyr3-tiny and lyr2-small.

Parameters cross between the two through ``params_from_numpy`` /
``params_to_numpy``; every JAX side runs the JAX package's own functions.
Tolerances, stated up front:

- ``loss_fn``: the loss within 1e-6 relative and each gradient within
  ``rtol=1e-4, atol=1e-6 * max|g|`` in f32 (torch and XLA sum the conv and
  GAP reductions in different orders); in bf16 the loss within 2e-2
  relative and each gradient's L2 error within 2e-2 of its norm (bf16
  keeps 8 bits).
- The optimiser alone: the parameters and the state leaves within 1e-6
  after 6 updates of the same seeded gradients.
- ``train`` end to end: the per-epoch mean losses within 1e-4 relative, the
  printed val accuracies equal, the phase-1 parameters within 1e-4 or else
  at most 0.1% of the elements off, each by under ``2 * lr * steps``
  (Adam's normalisation turns a gradient that cancels to ~1e-9 into a full
  ``lr`` step of either sign), and the exported weights.bin off by 1 LSB
  on at most 0.1% of the elements.
- ``extract_qat_features``: bit-equal. ``fit_head``: within
  ``1e-4 * max|W| + 1e-5``.
- Checkpoints: a round trip is equal; an interrupted run resumed equals
  the unbroken run exactly (the CPU is deterministic); a JAX-written file
  resumed in the port follows JAX's own resume within ``train``'s
  tolerance.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from tpu_cnn.train import train_cnn as J  # noqa: E402
from tpu_cnn_torch.train import checkpoint as ckpt  # noqa: E402
from tpu_cnn_torch.train import data as D  # noqa: E402
from tpu_cnn_torch.train import train_cnn as T  # noqa: E402
from tpu_cnn_torch.utils import weights as weights_codec  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMS = {"lyr3-tiny": ((1, 16, 32), (16, 32, 16), (32, 64, 8)),
         "lyr2-small": ((1, 16, 64), (16, 32, 32))}
TINY = GEOMS["lyr3-tiny"]


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


def _jax_params(cfg, seed=0):
    return {k: np.asarray(v) for k, v in
            J.init_params(J.TrainConfig(layer_configs=cfg.layer_configs),
                          jax.random.PRNGKey(seed)).items()}


def _port_cfg(**kw):
    return T.TrainConfig(layer_configs=TINY, **kw)


def _jax_cfg(**kw):
    return J.TrainConfig(layer_configs=TINY, **kw)


def _labels(kind, rs, n, k=6):
    if kind == "int":
        return rs.randint(0, k, n).astype(np.int32)
    if kind == "dense":  # one-hot singles and 0.5/0.5 composites
        y = np.eye(k, dtype=np.float32)[rs.randint(0, k, n)]
        y[: n // 2] = 0
        for i in range(n // 2):
            a, b = rs.choice(k, 2, replace=False)
            y[i, a] = y[i, b] = 0.5
        return y
    y = (rs.rand(n, k) < 0.3).astype(np.float32)  # multi-hot, for BCE
    y[np.arange(n), rs.randint(0, k, n)] = 1.0
    return y


def test_params_cross_both_ways():
    cfg = _port_cfg()
    p = _jax_params(cfg)
    net = T.params_from_numpy(p)
    assert [n for n, _ in net.named_parameters()] == ["conv0", "conv1", "conv2",
                                                       "fc_w", "fc_b"]
    assert net.n_layers == 3
    back = T.params_to_numpy(net)
    assert back.keys() == p.keys()
    for k in p:
        np.testing.assert_array_equal(back[k], p[k])
    drawn = T.init_params(cfg, torch.Generator().manual_seed(0))
    for k, v in T.params_to_numpy(drawn).items():
        assert v.shape == p[k].shape and v.dtype == np.float32
    assert not drawn.fc_b.detach().any()
    again = T.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(drawn.parameters(),
                                                 again.parameters()))


def test_the_carried_jax_draw_is_the_jax_trainers_seed_0():
    """tests/data/jax_init_lyr3-std_seed0.f32, which chip_smoke.py's recipe
    starts phase 1 from, is the JAX trainer's lyr3-std draw at --seed 0."""
    sys.path.insert(0, REPO)
    import chip_smoke

    got = chip_smoke.jax_seed0_draw()
    want = J.init_params(J.TrainConfig(), jax.random.PRNGKey(0))
    assert list(got) == ["conv0", "conv1", "conv2", "fc_w", "fc_b"]
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v))
    assert T.params_to_numpy(T.params_from_numpy(got)).keys() == got.keys()


@pytest.mark.parametrize("variant", list(GEOMS))
@pytest.mark.parametrize("kind,soft_bce", [("int", False), ("dense", False),
                                           ("bce", True)])
@pytest.mark.parametrize("qat,per_layer", [(False, False), (True, False),
                                           (True, True)])
def test_loss_and_gradients_match_jax(variant, kind, soft_bce, qat, per_layer):
    cfg = T.TrainConfig(layer_configs=GEOMS[variant])
    rs = np.random.RandomState(1)
    s = cfg.layer_configs[0][2]
    imgs = rs.rand(8, s, s).astype(np.float32)
    labels = _labels(kind, rs, 8)
    p = _jax_params(cfg, seed=2)
    n = len(cfg.layer_configs)
    (j_loss, j_acc), j_grads = jax.value_and_grad(J.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(imgs),
        jnp.asarray(labels), n, jnp.float32, qat, per_layer, soft_bce)
    net = T.params_from_numpy(p)
    loss, acc = T.loss_fn(net.params(), torch.as_tensor(imgs),
                          torch.as_tensor(labels), n, "float32", qat,
                          per_layer, soft_bce)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=1e-6)
    for k, param in net.named_parameters():
        g, jg = param.grad.numpy(), np.asarray(j_grads[k])
        np.testing.assert_allclose(g, jg, rtol=1e-4,
                                   atol=1e-6 * np.abs(jg).max(), err_msg=k)
    logits = T.float_forward(
        T.fake_quant_convs(net.params(), n, per_layer) if qat else net.params(),
        torch.as_tensor(imgs), n)
    pred = logits.argmax(-1).numpy()
    if soft_bce:  # a hit when the predicted class is present
        assert float(acc) == pytest.approx(float((labels[np.arange(8), pred] > 0).mean()))
    else:
        assert float(acc) == pytest.approx(float(j_acc))


@pytest.mark.parametrize("variant", list(GEOMS))
@pytest.mark.parametrize("kind", ["int", "bce"])
def test_bf16_loss_and_gradients_match_jax(variant, kind):
    cfg = T.TrainConfig(layer_configs=GEOMS[variant])
    rs = np.random.RandomState(3)
    s = cfg.layer_configs[0][2]
    imgs = rs.rand(8, s, s).astype(np.float32)
    labels = _labels(kind, rs, 8)
    p = _jax_params(cfg, seed=4)
    n = len(cfg.layer_configs)
    (j_loss, _), j_grads = jax.value_and_grad(J.loss_fn, has_aux=True)(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(imgs),
        jnp.asarray(labels), n, jnp.bfloat16, False, False, kind == "bce")
    net = T.params_from_numpy(p)
    loss, _ = T.loss_fn(net.params(), torch.as_tensor(imgs),
                        torch.as_tensor(labels), n, "bfloat16",
                        soft_bce=kind == "bce")
    loss.backward()
    np.testing.assert_allclose(float(loss), float(j_loss), rtol=2e-2)
    for k, param in net.named_parameters():
        g, jg = param.grad.numpy(), np.asarray(j_grads[k], np.float32)
        assert param.grad.dtype == torch.float32  # master weights stay f32
        assert np.linalg.norm(g - jg) <= 2e-2 * np.linalg.norm(jg), k


def test_fake_quant_convs_on_the_export_grid():
    p = _jax_params(_port_cfg(), seed=5)
    for per_layer in (False, True):
        got = T.fake_quant_convs(T.params_from_numpy(p).params(), 3, per_layer)
        want = J.fake_quant_convs({k: jnp.asarray(v) for k, v in p.items()}, 3,
                                  per_layer)
        for k in want:
            np.testing.assert_array_equal(got[k].detach().numpy(),
                                          np.asarray(want[k]))
        quantize = (weights_codec.quantize_per_layer if per_layer
                    else weights_codec.quantize_global)
        q, scale = quantize([got[f"conv{i}"].detach().numpy() for i in range(3)])
        scales = scale if per_layer else [scale] * 3
        for i in range(3):
            np.testing.assert_allclose(q[i] / scales[i],
                                       got[f"conv{i}"].detach().numpy(),
                                       rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("every_k", [1, 2])
def test_optimizer_matches_optax(every_k):
    rs = np.random.RandomState(6)
    shapes = {"conv0": (16, 1, 3, 3), "conv1": (32, 16, 3, 3),
              "fc_b": (6,), "fc_w": (6, 32)}
    params = {k: rs.randn(*s).astype(np.float32) for k, s in shapes.items()}
    decay, lr = 10, 3e-3
    opt = optax.chain(optax.scale_by_adam(),
                      optax.scale_by_schedule(optax.cosine_decay_schedule(1.0, decay)),
                      optax.scale(-lr))
    if every_k > 1:
        opt = optax.MultiSteps(opt, every_k_schedule=every_k)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    ours = T.AdamCosine(lr, decay, every_k=every_k)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = ours.init(tp)
    for _ in range(6 * every_k):
        grads = {k: rs.randn(*s).astype(np.float32) * 10 ** rs.uniform(-3, 1)
                 for k, s in shapes.items()}
        u, js = opt.update({k: jnp.asarray(v) for k, v in grads.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        ours.update(tp, {k: torch.tensor(v) for k, v in grads.items()}, ts)
    for k in shapes:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0,
                                   atol=1e-6, err_msg=k)
    leaves = jax.tree.leaves(js)
    mine = ours.leaves(ts)
    assert len(mine) == len(leaves)
    for a, b in zip(mine, leaves):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-6)
    assert ts["count"] == 6
    back = ours.from_leaves(mine, ts)
    for k in shapes:
        assert torch.equal(back["mu"][k], ts["mu"][k])


def test_head_adam_without_schedule_is_optax_adam():
    rs = np.random.RandomState(7)
    w = rs.randn(6, 20).astype(np.float32)
    opt = optax.adam(0.01)
    jw = {"w": jnp.asarray(w)}
    js = opt.init(jw)
    ours = T.AdamCosine(0.01)
    tw = {"w": torch.tensor(w)}
    ts = ours.init(tw)
    for _ in range(5):
        g = rs.randn(6, 20).astype(np.float32)
        u, js = opt.update({"w": jnp.asarray(g)}, js)
        jw = optax.apply_updates(jw, u)
        ours.update(tw, {"w": torch.tensor(g)}, ts)
    np.testing.assert_allclose(tw["w"].numpy(), np.asarray(jw["w"]), atol=1e-6)
    with pytest.raises(ValueError):
        T.AdamCosine(0.01, 0)


def _data(n_per_class=20, s=32):
    imgs, labels = D.SyntheticShapes(n_per_class=n_per_class, img_size=s).arrays()
    n_val = 24
    return (imgs[n_val:], labels[n_val:]), (imgs[:n_val], labels[:n_val])


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

    def epoch_means(self, steps_per_epoch):
        x = np.asarray(self.losses)
        return x.reshape(-1, steps_per_epoch).mean(axis=1)


def _carry_init(monkeypatch, params):
    monkeypatch.setattr(T, "init_params",
                        lambda cfg, gen: T.params_from_numpy(params))


def _val_lines(text):
    return [ln.split("val")[-1].strip() for ln in text.splitlines()
            if ln.strip().startswith("epoch")]


def assert_params_close(got, want, lr, steps):
    """Within 1e-4, or else at most 0.1% of the elements off, each by
    under 2 * lr * steps."""
    for k in want:
        diff = np.abs(got[k] - want[k])
        far = diff > 1e-4
        assert far.mean() <= 1e-3, (k, far.sum(), diff.max())
        assert (diff[far] < 2 * lr * steps).all(), (k, diff.max())


def assert_weights_bin_close(dir_a, dir_b):
    a = np.fromfile(os.path.join(dir_a, "weights.bin"), np.int8).astype(int)
    b = np.fromfile(os.path.join(dir_b, "weights.bin"), np.int8).astype(int)
    assert a.shape == b.shape
    off = a != b
    assert np.abs(a - b).max() <= 1 and off.mean() <= 1e-3, off.sum()


TRAIN_KW = dict(epochs=2, batch_size=16, head_epochs=50, lr=3e-3)


@pytest.mark.parametrize("flags", [{}, {"qat": True, "augment": True}])
def test_train_end_to_end_matches_jax(flags, tmp_path, monkeypatch, capsys):
    train_data, val_data = _data()
    p0 = _jax_params(_port_cfg())
    _carry_init(monkeypatch, p0)
    monkeypatch.setattr(J, "init_params",
                        lambda cfg, key: {k: jnp.asarray(v) for k, v in p0.items()})
    jrec = _Recorder(J, monkeypatch, port=False)
    prec = _Recorder(T, monkeypatch, port=True)
    J.train(_jax_cfg(**TRAIN_KW), train_data, val_data, str(tmp_path / "j"),
            **flags)
    jtext = capsys.readouterr().out
    bundle = T.train(_port_cfg(**TRAIN_KW), train_data, val_data,
                     str(tmp_path / "t"), device="cpu", **flags)
    ttext = capsys.readouterr().out
    steps = len(train_data[0]) // 16
    np.testing.assert_allclose(prec.epoch_means(steps), jrec.epoch_means(steps),
                               rtol=1e-4)
    assert _val_lines(ttext) == _val_lines(jtext) and len(_val_lines(ttext)) == 2
    assert_params_close(prec.last, jrec.last, TRAIN_KW["lr"], 2 * steps)
    assert_weights_bin_close(tmp_path / "t", tmp_path / "j")
    assert bundle.shifts == [2, 4, 6] and bundle.fc_weight.shape == (6, 64)
    for name in ("fc_weight.npy", "fc_bias.npy", "classes.json", "shifts.json"):
        assert os.path.exists(tmp_path / "t" / name)
    assert (sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j")))


def test_train_with_bce_composites_matches_jax(tmp_path, monkeypatch, capsys):
    """aux_data under --composite-loss bce (multi-hot 1/1 targets, where
    the JAX trainer's int32 label cast is harmless) and --grad-accum 2."""
    train_data, val_data = _data()
    aux = D.soft_composites(*train_data, 16, seed=3, img_size=32)
    p0 = _jax_params(_port_cfg())
    _carry_init(monkeypatch, p0)
    monkeypatch.setattr(J, "init_params",
                        lambda cfg, key: {k: jnp.asarray(v) for k, v in p0.items()})
    jrec = _Recorder(J, monkeypatch, port=False)
    prec = _Recorder(T, monkeypatch, port=True)
    kw = dict(aux_data=aux, aux_bce=True, grad_accum=2)
    J.train(_jax_cfg(**TRAIN_KW), train_data, val_data, str(tmp_path / "j"), **kw)
    jtext = capsys.readouterr().out
    T.train(_port_cfg(**TRAIN_KW), train_data, val_data, str(tmp_path / "t"),
            device="cpu", **kw)
    ttext = capsys.readouterr().out
    steps = (len(train_data[0]) + 16) // 16
    np.testing.assert_allclose(prec.epoch_means(steps), jrec.epoch_means(steps),
                               rtol=1e-4)
    assert _val_lines(ttext) == _val_lines(jtext)
    assert_params_close(prec.last, jrec.last, TRAIN_KW["lr"], steps)
    assert_weights_bin_close(tmp_path / "t", tmp_path / "j")
    assert "soft composites" in ttext


def test_dense_ce_targets_keep_their_halves(monkeypatch):
    """The port stages 0.5/0.5 composite targets as float32 (the JAX
    trainer's int32 cast zeroes them)."""
    imgs = np.zeros((2, 4, 4), np.float32)
    labels = np.asarray([[0.5, 0.5, 0], [0, 0, 1]], np.float32)
    ints = np.asarray([1, 2])
    (bi, bl), (_, il) = T._prefetch_to_device(
        iter([(imgs, labels), (imgs, ints)]), torch.device("cpu"))
    assert bl.dtype == torch.float32 and torch.equal(bl, torch.as_tensor(labels))
    assert il.dtype == torch.int64 and il.tolist() == [1, 2]
    host = [(np.full((2, 4, 4), i, np.float32), np.asarray([i, i])) for i in range(5)]
    out = list(T._prefetch_to_device(iter(host), torch.device("cpu")))
    assert [int(b[1][0]) for b in out] == list(range(5))


@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small", "lyr4-wide"])
def test_extract_qat_features_bit_equal(variant):
    from tpu_cnn_torch.models.registry import default_shifts, get_config

    vcfg = get_config(variant)
    cfg = T.TrainConfig(layer_configs=vcfg.layer_configs,
                        shifts=tuple(default_shifts(vcfg)),
                        per_layer_scale=variant == "lyr2-small")
    jcfg = J.TrainConfig(layer_configs=vcfg.layer_configs, shifts=cfg.shifts,
                         per_layer_scale=cfg.per_layer_scale)
    p = _jax_params(cfg, seed=8)
    s = vcfg.layer_configs[0][2]
    n = 3 if variant == "lyr4-wide" else 10
    imgs = D.SyntheticShapes(n_per_class=2, img_size=s).arrays()[0][:n]
    got = T.extract_qat_features(T.params_from_numpy(p).params(), imgs, cfg,
                                 batch_size=4)
    want = J.extract_qat_features({k: jnp.asarray(v) for k, v in p.items()},
                                  imgs, jcfg, batch_size=4)
    assert got.dtype == np.float32 and got.shape == (n, vcfg.layer_configs[-1][1])
    np.testing.assert_array_equal(got, want)
    assert got.max() > 0


@pytest.fixture(scope="module")
def realphoto_feats():
    """The real-photo bundle's u8 features of 8 train tiles per class (the
    host oracle) and their labels."""
    from tpu_cnn_torch.apps.common import load_model
    from tpu_cnn_torch.engine.cpu_ref import CPURefEngine

    m = load_model(os.path.join(REPO, "artifacts", "realphoto", "bundle-qat"))
    imgs, labels = D.BinFolderDataset(
        os.path.join(REPO, "artifacts", "realphoto", "train_bins"),
        max_per_class=8).arrays()
    u8 = np.round(imgs * 255).astype(np.uint8)
    return CPURefEngine(m.kernels, m.shifts).run_batch(u8), labels


@pytest.mark.parametrize("pool,head_epochs,max_chunks",
                         [("bins", 200, 10), ("gap", 20, 1)])
def test_fit_head_matches_jax(pool, head_epochs, max_chunks, realphoto_feats):
    """On the bin features in [0, 1] that ``retrain_classifier --optimizer
    adam`` fits, the whole fit (up to 10 chunks of 200 steps); on the
    phase-2 GAP features in [0, 255] the first 20 steps only: there the
    full-batch Adam at lr 0.01 starts at a cross-entropy near 60, and two
    f32 implementations part from 1e-8 to 5e-2 within 100 steps (so do
    XLA and XLA on two platforms: the JAX trainer's "platform fp noise"
    note)."""
    from tpu_cnn_torch.head.classify import bin_pool_np, gap_pool_np

    feats, labels = realphoto_feats
    x = bin_pool_np(feats) if pool == "bins" else gap_pool_np(feats)
    w, b = T.fit_head(x, labels, _port_cfg(head_epochs=head_epochs),
                      verbose=False, max_chunks=max_chunks, device="cpu")
    jw, jb = J.fit_head(x, labels, _jax_cfg(head_epochs=head_epochs),
                        verbose=False, max_chunks=max_chunks)
    tol = 1e-4 * np.abs(jw).max() + 1e-5
    np.testing.assert_allclose(w, jw, rtol=0, atol=tol)
    np.testing.assert_allclose(b, jb, rtol=0, atol=tol)
    assert w.dtype == np.float32 and w.shape == (6, x.shape[1])


def test_checkpoint_round_trip(tmp_path):
    cfg = _port_cfg()
    net = T.params_from_numpy(_jax_params(cfg))
    opt = T.AdamCosine(1e-3, 10, every_k=2)
    state = opt.init(net.params())
    grads = {k: torch.ones_like(v) for k, v in net.params().items()}
    for _ in range(3):
        opt.update(net.params(), grads, state)
    best = {k: v.detach() * 2 for k, v in net.params().items()}
    rng = np.random.RandomState(4)
    rng.rand(7)
    path = str(tmp_path / "c.npz")
    ckpt.save_checkpoint(path, net.params(), opt.leaves(state), 3, 0.625, best,
                         rng=rng)
    want_next = rng.rand(5)
    fresh = np.random.RandomState(0)
    params, leaves, epoch, acc, best_np = ckpt.load_checkpoint(
        path, net.params(), opt.leaves(opt.init(net.params())), rng=fresh)
    assert (epoch, acc) == (3, 0.625)
    np.testing.assert_array_equal(fresh.rand(5), want_next)
    for k, v in net.params().items():
        np.testing.assert_array_equal(params[k], v.detach().numpy())
        np.testing.assert_array_equal(best_np[k], best[k].numpy())
    back = opt.from_leaves(leaves, state)
    assert (back["count"], back["mini_step"], back["gradient_step"]) == (1, 1, 1)
    for k in state["mu"]:
        assert torch.equal(back["mu"][k], state["mu"][k])
        assert torch.equal(back["acc"][k], state["acc"][k])
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    # another geometry or another optimiser than the file's is refused
    other = T.params_from_numpy(_jax_params(T.TrainConfig(layer_configs=GEOMS["lyr2-small"])))
    with pytest.raises(ValueError, match="leaves"):
        ckpt.load_checkpoint(path, other.params(), leaves)
    with pytest.raises(ValueError, match="grad-accum"):
        ckpt.load_checkpoint(path, net.params(),
                             T.AdamCosine(1e-3, 10).leaves(opt.init(net.params())))
    wide = dict(net.params(), fc_w=torch.zeros(6, 65))
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(path, wide, leaves)


def _stop_after_first_step(module, monkeypatch):
    """SIGTERM the process during the first train step: the trainer's
    handler finishes the epoch, checkpoints and returns None."""
    orig = module.make_train_step

    def make(*a, **kw):
        step = orig(*a, **kw)
        sent = []

        def wrapped(*args):
            if not sent:
                sent.append(1)
                signal.raise_signal(signal.SIGTERM)
            return step(*args)
        return wrapped

    monkeypatch.setattr(module, "make_train_step", make)


def test_resume_equals_the_unbroken_run(tmp_path, monkeypatch, capsys):
    train_data, val_data = _data()
    handler = signal.getsignal(signal.SIGTERM)
    kw = dict(augment=True, device="cpu")
    cfg = _port_cfg(**TRAIN_KW)
    straight = T.train(cfg, train_data, val_data, str(tmp_path / "a"),
                       checkpoint_path=str(tmp_path / "a.npz"), **kw)
    with monkeypatch.context() as m:
        _stop_after_first_step(T, m)
        stopped = T.train(cfg, train_data, val_data, str(tmp_path / "b"),
                          checkpoint_path=str(tmp_path / "b.npz"), **kw)
    assert stopped is None and not os.path.exists(tmp_path / "b")
    assert json.loads(bytes(np.load(tmp_path / "b.npz")["__meta"]).decode())["epoch"] == 1
    resumed = T.train(cfg, train_data, val_data, str(tmp_path / "b"),
                      checkpoint_path=str(tmp_path / "b.npz"), resume=True, **kw)
    out = capsys.readouterr().out
    assert "re-run with --resume" in out and "Resumed from" in out
    assert signal.getsignal(signal.SIGTERM) is handler
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(a.files) == sorted(b.files)
    for f in a.files:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    for x, y in ((straight.fc_weight, resumed.fc_weight),
                 (straight.fc_bias, resumed.fc_bias)):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(straight.kernels, resumed.kernels):
        np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, capsys):
    train_data, val_data = _data()
    path = str(tmp_path / "j.npz")
    with monkeypatch.context() as m:
        _stop_after_first_step(J, m)
        assert J.train(_jax_cfg(**TRAIN_KW), train_data, val_data,
                       str(tmp_path / "j0"), checkpoint_path=path) is None
    shutil.copy(path, tmp_path / "t.npz")
    capsys.readouterr()
    jrec = _Recorder(J, monkeypatch, port=False)
    prec = _Recorder(T, monkeypatch, port=True)
    J.train(_jax_cfg(**TRAIN_KW), train_data, val_data, str(tmp_path / "j"),
            checkpoint_path=path, resume=True)
    jtext = capsys.readouterr().out
    T.train(_port_cfg(**TRAIN_KW), train_data, val_data, str(tmp_path / "t"),
            checkpoint_path=str(tmp_path / "t.npz"), resume=True, device="cpu")
    ttext = capsys.readouterr().out
    assert "Resumed from" in ttext and "at epoch 1" in ttext
    steps = len(train_data[0]) // 16
    assert len(prec.losses) == len(jrec.losses) == steps
    np.testing.assert_allclose(prec.epoch_means(steps), jrec.epoch_means(steps),
                               rtol=1e-4)
    assert _val_lines(ttext) == _val_lines(jtext)
    assert_params_close(prec.last, jrec.last, TRAIN_KW["lr"], steps)
    assert_weights_bin_close(tmp_path / "t", tmp_path / "j")


def test_sigterm_graceful_checkpoint(tmp_path):
    """A twin of the JAX suite's test: SIGTERM mid-training finishes the
    current epoch, leaves a valid checkpoint and returns None; the
    snapshot resumes."""
    ckpt_path = str(tmp_path / "pre.npz")
    script = f"""
import sys
sys.path.insert(0, {REPO!r})
from tpu_cnn_torch.train import data as D
from tpu_cnn_torch.train.train_cnn import TrainConfig, train
cfg = TrainConfig(layer_configs=((1, 16, 32), (16, 32, 16), (32, 64, 8)),
                  epochs=500, batch_size=16, head_epochs=5)
ds = D.SyntheticShapes(n_per_class=16, img_size=32)
imgs, labels = ds.arrays()
out = train(cfg, (imgs[24:], labels[24:]), (imgs[:24], labels[:24]),
            {str(tmp_path / "out")!r}, checkpoint_path={ckpt_path!r},
            device="cpu")
print("RETURNED_NONE", out is None, flush=True)
"""
    proc = subprocess.Popen([sys.executable, "-c", script],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.time() + 300
        while not os.path.exists(ckpt_path) and time.time() < deadline:
            assert proc.poll() is None, proc.communicate()[0]
            time.sleep(0.2)
        assert os.path.exists(ckpt_path), "no checkpoint appeared within 300 s"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out
    assert "RETURNED_NONE True" in out
    assert "re-run with --resume" in out
    meta = json.loads(bytes(np.load(ckpt_path)["__meta"]).decode())
    assert meta["epoch"] >= 1
    net = T.init_params(_port_cfg(), torch.Generator())
    opt = T.AdamCosine(1e-3, 10)
    ckpt.load_checkpoint(ckpt_path, net.params(), opt.leaves(opt.init(net.params())))


def test_exact_float_restores_the_flags():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    before = (cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic)
    try:
        cudnn.allow_tf32 = matmul.allow_tf32 = True
        cudnn.deterministic = False
        with pytest.raises(KeyError):
            with T.exact_float():
                assert not cudnn.allow_tf32 and not matmul.allow_tf32
                assert cudnn.deterministic
                raise KeyError
        assert cudnn.allow_tf32 and matmul.allow_tf32 and not cudnn.deterministic
    finally:
        cudnn.allow_tf32, matmul.allow_tf32, cudnn.deterministic = before


def test_entry_points_refuse_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.main(["--synthetic", "--variant", "lyr3-tiny", "--epochs", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.fit_head(np.zeros((8, 4), np.float32), np.zeros(8, int), _port_cfg())


def _bins(root, n_per_class, s=32, seed=0):
    os.makedirs(root, exist_ok=True)
    rs = np.random.RandomState(seed)
    for i in range(n_per_class * 6):
        rs.randint(0, 256, s * s).astype(np.uint8).tofile(
            os.path.join(root, f"test_image_{i}_class{i % 6}.bin"))
    return root


def _coco(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(3)
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    images, annotations = [], []
    for iid, (name, cat_id) in enumerate(
            (n, c) for n, c in D.CocoClassification.COCO_CATS.items()
            for _ in range(4)):
        fn = f"{name}_{iid}.jpg"
        Image.fromarray(rs.randint(0, 256, (40, 40, 3)).astype(np.uint8)).save(
            img_dir / fn)
        images.append({"id": iid, "file_name": fn, "width": 40, "height": 40})
        annotations.append({"id": iid, "image_id": iid, "category_id": cat_id,
                            "bbox": [0, 0, 5, 5]})
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps({"images": images, "annotations": annotations}))
    return ["--train-images", str(img_dir), "--train-ann", str(ann)]


def _folder(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(5)
    for c in ("alpha", "beta", "gamma"):
        d = tmp_path / "folder" / c
        d.mkdir(parents=True)
        for k in range(6):
            Image.fromarray(rs.randint(0, 256, (30, 30)).astype(np.uint8)).save(
                d / f"{k}.png")
    return ["--image-folder", str(tmp_path / "folder")]


@pytest.mark.parametrize("case", ["synthetic-bf16", "synthetic-qat", "bins",
                                  "folder", "coco", "mesh-4x2", "pipeline-2x3",
                                  "spatial-2x4", "mesh-8-zero1"])
def test_train_cli_every_ported_flag(case, tmp_path, capsys):
    from tpu_cnn_torch.apps.common import load_model

    out = str(tmp_path / "out")
    base = ["--device", "cpu", "--variant", "lyr3-tiny", "--epochs", "1",
            "--batch-size", "8", "--output-dir", out]
    synthetic = ["--synthetic", "--max-per-class", "50"]

    def bins():
        return ["--bin-folder", _bins(str(tmp_path / "tr"), 4),
                "--val-bin-folder", _bins(str(tmp_path / "va"), 2, seed=1),
                "--max-per-class", "3"]

    argv = {
        "synthetic-bf16": synthetic + ["--bf16", "--grad-accum", "2",
                                       "--per-layer-scale", "--lr", "2e-3",
                                       "--seed", "3"],
        "synthetic-qat": synthetic + ["--qat", "--augment", "--composite-frac",
                                      "0.25", "--composite-loss", "bce",
                                      "--shifts", "1,3,5"],
        "bins": bins() + ["--checkpoint", str(tmp_path / "c.npz")],
        "folder": _folder(tmp_path),
        "coco": _coco(tmp_path),
        "mesh-4x2": bins() + ["--mesh", "4x2", "--bf16", "--qat", "--grad-accum",
                              "2", "--composite-frac", "0.5"],
        "pipeline-2x3": bins() + ["--pipeline", "2x3", "--microbatch", "4",
                                  "--remat", "--augment"],
        "spatial-2x4": bins() + ["--spatial", "2x4"],
        "mesh-8-zero1": bins() + ["--mesh", "8", "--zero1", "--grad-accum", "2",
                                  "--checkpoint", str(tmp_path / "ckpt")],
    }[case]
    bundle = T.main(base + argv)
    text = capsys.readouterr().out
    assert "Exported: weights.bin" in text
    model = load_model(out, "lyr3-tiny")
    assert model.kernels[0].shape == (16, 1, 3, 3)
    assert all(np.isfinite(k).all() for k in bundle.kernels)
    if case == "synthetic-bf16":
        assert all(np.abs(k).max() == 127 for k in bundle.kernels)
    if case == "synthetic-qat":
        assert list(model.shifts) == [1, 3, 5]
        assert "2-object soft-label frames (--composite-frac 0.25)" in text
    if case == "bins":
        assert "18 train / 12 val" in text
        T.main(base + argv + ["--resume", "--epochs", "2"])
        assert "Resumed from" in capsys.readouterr().out
    if case == "folder":
        assert json.load(open(os.path.join(out, "classes.json"))) == [
            "alpha", "beta", "gamma"]
    banner = {"mesh-4x2": "Mesh: 4 data x 2 model over 8 devices",
              "pipeline-2x3": "Pipeline: 2 data x 3 stages over 6 devices "
                              "(microbatch 4)",
              "spatial-2x4": "Spatial: 2 data x 4 row shards over 8 devices",
              "mesh-8-zero1": "Mesh: 8 data x 1 model over 8 devices"}.get(case)
    if banner:
        assert banner in text
    if case == "mesh-8-zero1":
        T.main(base + argv + ["--resume", "--epochs", "2"])
        assert (f"Resumed from {tmp_path / 'ckpt'} (sharded) at epoch 1"
                in capsys.readouterr().out)


MESH_REFUSALS = {  # name -> (argv, the refusal's exit code or exception)
    "exclusive": (["--mesh", "2", "--pipeline", "3"], 2),
    "no coordinator": (["--num-processes", "2"], 2),
    "multi-host pipeline": (["--num-processes", "2", "--coordinator",
                             "127.0.0.1:1", "--pipeline", "3"], 2),
    "mesh batch": (["--mesh", "3", "--batch-size", "16"], 2),
    "pipeline batch": (["--pipeline", "2x3", "--microbatch", "3",
                        "--batch-size", "16"], 2),
    "spatial batch": (["--spatial", "3x2", "--batch-size", "16"], 2),
    "zero1 on 4x2": (["--mesh", "4x2", "--zero1"], ValueError),
    "bf16 pipeline": (["--pipeline", "3", "--bf16"], ValueError),
    "bf16 spatial": (["--spatial", "4", "--bf16"], ValueError),
    "qat pipeline": (["--pipeline", "3", "--qat"], ValueError),
    "qat spatial": (["--spatial", "4", "--qat"], ValueError),
    "straddling spatial": (["--spatial", "8"], ValueError),
}


def _refusal(main, argv, kind, capsys):
    """What ``main(argv)`` refuses with: the exit code and argparse's
    message, or the exception's text."""
    if kind is ValueError:
        with pytest.raises(ValueError) as e:
            main(argv)
        return str(e.value)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert e.value.code == kind
    return capsys.readouterr().err.strip().splitlines()[-1].split("error: ", 1)[1]


@pytest.mark.parametrize("name", list(MESH_REFUSALS))
def test_train_cli_mesh_refusals_match_jax(name, tmp_path, capsys):
    """The JAX CLI's own p.errors and ValueErrors for the mesh flags: the
    same exit code and message from the port (on virtual CPU positions)."""
    argv, kind = MESH_REFUSALS[name]
    base = ["--synthetic", "--variant", "lyr3-tiny", "--epochs", "1",
            "--max-per-class", "100", "--output-dir", str(tmp_path / "out")]
    want = _refusal(J.main, base + argv, kind, capsys)
    got = _refusal(T.main, ["--device", "cpu"] + base + argv, kind, capsys)
    assert got == want
    assert not os.path.exists(tmp_path / "out")


def test_bench_train_counts_the_macs():
    from tpu_cnn_torch.apps import benchmark
    from tpu_cnn_torch.models.cnn import FpgaCNN
    from tpu_cnn_torch.utils.roofline import PEAK_BF16_MACS, PEAK_F32_MACS

    assert PEAK_F32_MACS == 33.5e12 and PEAK_BF16_MACS == 494.5e12
    rs = np.random.RandomState(0)
    from tpu_cnn_torch.models.registry import get_config

    config = get_config("lyr3-tiny")
    model = FpgaCNN([rs.randint(-9, 9, (oc, ic, 3, 3)).astype(np.int8)
                     for ic, oc, _ in config.layer_configs],
                    np.zeros((6, 64), np.float32), np.zeros(6, np.float32),
                    [str(i) for i in range(6)], config=config)
    ms, ips, mfu = benchmark.bench_train(model, 4, 2, "float32", passes=1,
                                         device="cpu")
    assert ms > 0 and ips == pytest.approx(4 / (ms / 1e3))
    macs = 3 * sum(s * s * oc * ic * 9 for ic, oc, s in config.layer_configs)
    assert mfu == pytest.approx(ips * macs / PEAK_F32_MACS * 100)
