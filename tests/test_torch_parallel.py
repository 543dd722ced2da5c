"""The port's mesh axes (``tpu_cnn_torch.parallel``) on the CPU against the
JAX package's (``tpu_cnn.parallel``), on the same seeded numpy inputs:
``MeshEngine`` and the ``sharded_*`` functions on eight virtual CPU
positions (``[torch.device("cpu")] * 8``) at model axis 1 and 2 against
the JAX functions on the suite's eight virtual devices (the JAX ``xla``
backend, so that no interpret-mode Pallas sits in the suite) and the numpy
oracle; the dispatch structure (one shard per position, B/n rows each);
the auto backend's fallback; the GPipe pipeline and the row-sharded
spatial forward against the contract (bit-exact, refusals, composite
meshes, ``accum_wrap``); the serving dry run.

Tolerances: u8 features, predictions, boxes, instance boxes and counts
equal; probabilities and presence scores within 1e-4 (the model axis sums
the classifier's partial logits in another order)."""

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.models import cnn as j_cnn  # noqa: E402
from tpu_cnn.ops import quant as j_quant  # noqa: E402
from tpu_cnn.parallel import mesh as j_mesh  # noqa: E402
from tpu_cnn_torch.models.cnn import CNNConfig, FpgaCNN  # noqa: E402
from tpu_cnn_torch.models.registry import REGISTRY, default_shifts  # noqa: E402
from tpu_cnn_torch.parallel import mesh, pipeline, spatial  # noqa: E402
from tpu_cnn_torch.parallel.dryrun import dryrun_mesh  # noqa: E402

CFGS = ((1, 16, 32), (16, 32, 16), (32, 64, 8))  # tests/test_parallel.py's
SHIFTS = (2, 4, 6)
CPU8 = [torch.device("cpu")] * 8
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread beside JAX's pool (the suite runs files in
    parallel); the results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kernels(rs, cfgs):
    return [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in cfgs]


@pytest.fixture(scope="module")
def tiny():
    """(port model, JAX model, images): the tiny stack with a bins head and
    a presence head, 13 images (not a multiple of the mesh)."""
    rs = np.random.RandomState(7)
    ks = _kernels(rs, CFGS)
    fc = rs.randn(6, 64 * 16).astype(np.float32) * 0.05
    mh = (rs.randn(6, 64 * 16).astype(np.float32) * 0.05,
          rs.randn(6).astype(np.float32))
    ours = FpgaCNN(ks, fc, np.zeros(6, np.float32), shifts=SHIFTS,
                   config=CNNConfig(layer_configs=CFGS), multi_head=mh)
    theirs = j_cnn.FpgaCNN(ks, fc, np.zeros(6, np.float32), shifts=SHIFTS,
                           config=j_cnn.CNNConfig(layer_configs=CFGS),
                           multi_head=mh)
    imgs = rs.randint(0, 256, (13, 32, 32)).astype(np.uint8)
    return ours, theirs, imgs


@pytest.fixture(scope="module")
def jax_results(tiny):
    """The JAX MeshEngine (``xla``) per model axis: features, detect and
    the multi head at instances 1 and 2."""
    _, theirs, imgs = tiny
    out = {}
    for ma in (1, 2):
        eng = j_mesh.MeshEngine(theirs, j_mesh.make_mesh(8, model_axis=ma),
                                backend="xla")
        out[ma] = (eng.run_batch(imgs), eng.detect_batch(imgs),
                   eng.detect_multi_batch(imgs, instances=1),
                   eng.detect_multi_batch(imgs, instances=2))
    return out


def _same_detect(got, want):
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.bbox, want.bbox)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.conf, want.conf, rtol=0, atol=TOL)


def _same_multi(got, want):
    np.testing.assert_array_equal(got.pred, want.pred)
    np.testing.assert_array_equal(got.boxes, want.boxes)
    np.testing.assert_allclose(got.probs, want.probs, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.scores, want.scores, rtol=0, atol=TOL)
    for a, b in ((got.inst_boxes, want.inst_boxes),
                 (got.inst_counts, want.inst_counts)):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["mega", "xla"])
@pytest.mark.parametrize("model_axis", [1, 2])
def test_mesh_engine_equals_the_jax_mesh_engine(tiny, jax_results, backend,
                                                model_axis):
    ours, _, imgs = tiny
    feats_j, det_j, multi_j, inst_j = jax_results[model_axis]
    eng = mesh.MeshEngine(ours, mesh.make_mesh(model_axis=model_axis,
                                               devices=CPU8), backend=backend)
    assert eng.backend == f"mesh[({8 // model_axis}, {model_axis})]:{backend}"
    feats = eng.run_batch(imgs)
    assert feats.shape == (13, 64, 16)
    np.testing.assert_array_equal(feats, feats_j)
    np.testing.assert_array_equal(feats[3], numpy_cnn_forward(imgs[3], ours.kernels,
                                                              SHIFTS))
    np.testing.assert_array_equal(eng.run(imgs[0])[0], feats[0])
    _same_detect(eng.detect_batch(imgs), det_j)
    _same_multi(eng.detect_multi_batch(imgs), multi_j)
    _same_multi(eng.detect_multi_batch(imgs, instances=2), inst_j)
    # the async protocol: several in flight, and a staged batch
    handles = [eng.detect_batch_async(imgs) for _ in range(2)]
    handles.append(eng.detect_batch_async(eng.stage_batch(imgs)))
    for h in handles:
        _same_detect(eng.detect_resolve(h), det_j)
    staged = eng.stage_batch(imgs)
    _same_multi(eng.detect_multi_resolve(
        eng.detect_multi_batch_async(staged, instances=2)), inst_j)


def test_mesh_engine_set_shifts_and_refusals(tiny):
    ours, theirs, imgs = tiny
    eng = mesh.MeshEngine(ours, mesh.make_mesh(model_axis=2, devices=CPU8))
    j_eng = j_mesh.MeshEngine(theirs, j_mesh.make_mesh(8, model_axis=2),
                              backend="xla")
    try:
        eng.set_shifts(1, 3, 5)
        j_eng.set_shifts(1, 3, 5)
        np.testing.assert_array_equal(eng.run_batch(imgs[:5]),
                                      j_eng.run_batch(imgs[:5]))
    finally:
        eng.set_shifts(*SHIFTS)
        j_eng.set_shifts(*SHIFTS)
    with pytest.raises(ValueError, match="0..31"):
        eng.set_shifts(1, 32, 5)
    with pytest.raises(ValueError, match="bbox_weight"):
        mesh.MeshEngine(ours, mesh.make_mesh(devices=CPU8), box_mode="reg")
    with pytest.raises(ValueError, match="must divide"):
        mesh.make_mesh(model_axis=3, devices=CPU8)
    with pytest.raises(ValueError, match="need 9 devices"):
        mesh.make_mesh(9, devices=CPU8)


@pytest.mark.parametrize("name", ["forward", "detect", "detect_multi"])
def test_sharded_functions_equal_the_jax_ones(tiny, name):
    """The functional API on a (4, 2) mesh: the port's ``xla`` and ``mega``
    versions against the JAX ``xla`` version."""
    ours, _, imgs = tiny
    imgs = imgs[:8]
    ks, fc, fb = ours.kernels, ours.fc_weight, ours.fc_bias
    jm = j_mesh.make_mesh(8, model_axis=2)
    tm = mesh.make_mesh(model_axis=2, devices=CPU8)
    sh = jnp.asarray(SHIFTS, jnp.int32)
    jk = [jnp.asarray(k) for k in ks]
    if name == "forward":
        want = (np.asarray(j_mesh.sharded_forward(jm, jk)(
            j_mesh.shard_batch(jm, jnp.asarray(imgs)), sh)),)
        fns = [mesh.sharded_forward(tm, ks), mesh.sharded_forward_mega(tm, ks)]
    elif name == "detect":
        want = jax.device_get(j_mesh.sharded_detect(jm, jk, fc, fb, img_size=32)(
            j_mesh.shard_batch(jm, jnp.asarray(imgs)), sh))
        fns = [mesh.sharded_detect(tm, ks, fc, fb, img_size=32),
               mesh.sharded_detect_mega(tm, ks, fc, fb, img_size=32)]
    else:
        want = jax.device_get(j_mesh.sharded_detect_multi(
            jm, jk, fc, fb, img_size=32, instances=2,
            multi_head=ours.multi_head)(
                j_mesh.shard_batch(jm, jnp.asarray(imgs)), sh))
        fns = [mesh.sharded_detect_multi(tm, ks, fc, fb, img_size=32,
                                         instances=2,
                                         multi_head=ours.multi_head),
               mesh.sharded_detect_multi_mega(tm, ks, fc, fb, img_size=32,
                                              instances=2,
                                              multi_head=ours.multi_head)]
    for fn in fns:
        got = mesh.to_host(fn(imgs, SHIFTS))
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert g.shape == w.shape
            if w.dtype == np.float32:
                np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
            else:
                np.testing.assert_array_equal(g, w)


def test_mesh_engine_per_position_dispatch_structure(tiny):
    """One shard per position, each of B/n rows, on all eight positions,
    for the staged input and for every in-flight batch's outputs (pure
    batch sharding over every axis on ``mega``; over ``data`` on ``xla``,
    its outputs on each data row's first position)."""
    ours, _, _ = tiny
    imgs = np.random.RandomState(3).randint(0, 256, (64, 32, 32)).astype(np.uint8)
    m = mesh.make_mesh(model_axis=2, devices=CPU8)
    eng = mesh.MeshEngine(ours, m, backend="mega")
    handles = [eng.detect_batch_async(imgs) for _ in range(3)]
    for h in handles:
        parts = h.shards.parts
        assert sorted(parts) == m.positions()
        assert [p[0].shape[0] for p in parts.values()] == [8] * 8
        staged = eng.stage_batch(imgs)[1].parts
        assert sorted(staged) == m.positions()
        assert [p[0].shape[0] for p in staged.values()] == [8] * 8
    for h in handles:
        assert eng.detect_resolve(h).pred.shape == (64,)
    xla = mesh.MeshEngine(ours, m, backend="xla")
    h = xla.detect_batch_async(imgs)
    assert sorted(h.shards.parts) == [(i, 0) for i in range(4)]
    assert [p[0].shape[0] for p in h.shards.parts.values()] == [16] * 4
    assert len(xla.stage_batch(imgs)[1].parts) == 8


def test_mesh_engine_auto_fallback_big_geometry():
    """No megakernel plan (no tail fits a CTA) -> the xla backend, as the
    JAX engine falls back; lyr4-wide plans the chained mega path."""
    rs = np.random.RandomState(11)
    for cfgs, want in ((((1, 64, 2048), (64, 1024, 1024)), "xla"),
                       (REGISTRY["lyr4-wide"].layer_configs, "mega")):
        cfg = CNNConfig(layer_configs=tuple(cfgs))
        fc = rs.randn(6, cfg.out_channels * 16).astype(np.float32) * 0.01
        ks = _kernels(rs, cfgs)
        ours = FpgaCNN(ks, fc, np.zeros(6, np.float32),
                       shifts=default_shifts(cfg), config=cfg)
        eng = mesh.MeshEngine(ours, mesh.make_mesh(devices=CPU8))
        assert eng.backend == f"mesh[(8, 1)]:{want}"
        jcfg = j_cnn.CNNConfig(layer_configs=tuple(cfgs))
        theirs = j_cnn.FpgaCNN(ks, fc, np.zeros(6, np.float32),
                               shifts=default_shifts(cfg), config=jcfg)
        j_eng = j_mesh.MeshEngine(theirs, j_mesh.make_mesh(8, model_axis=1))
        assert j_eng.backend.endswith(f":{want}")


def test_make_mesh_takes_every_card_or_refuses(monkeypatch):
    """No device list and no card: a clear refusal, not a silent CPU
    mesh."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipeline.make_pipeline_mesh(2)


# ── pipeline parallelism (GPipe over the 'pipe' axis) ──────────────────


def _contract(imgs, kernels, shifts, **kw):
    """The JAX package's contract forward (the reference of both axes)."""
    return np.asarray(j_quant.cnn_forward(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels],
        jnp.asarray(shifts, jnp.int32), **kw))


def _tiny_pipe_setup(rs):
    return (_kernels(rs, CFGS),
            rs.randint(0, 256, size=(12, 32, 32)).astype(np.uint8), [2, 4, 6])


@pytest.mark.parametrize("n_stages,microbatch", [(3, 4), (2, 2), (1, 4)])
def test_pipelined_forward_bit_exact(n_stages, microbatch):
    kernels, imgs, shifts = _tiny_pipe_setup(np.random.RandomState(7))
    f = pipeline.pipelined_forward(
        pipeline.make_pipeline_mesh(n_stages, devices=CPU8), kernels,
        microbatch=microbatch)
    out = f(imgs, shifts)
    assert out.dtype == torch.uint8
    np.testing.assert_array_equal(out.numpy(), _contract(imgs, kernels, shifts))


def test_pipelined_forward_uneven_stage_split():
    assert pipeline.split_stages(4, 3) == [(0, 2), (2, 3), (3, 4)]
    rs = np.random.RandomState(11)
    cfgs = [(1, 8, 32), (8, 16, 16), (16, 32, 8), (32, 64, 4)]
    kernels = _kernels(rs, cfgs)
    imgs = rs.randint(0, 256, size=(8, 32, 32)).astype(np.uint8)
    shifts = [2, 4, 5, 6]
    f = pipeline.pipelined_forward(pipeline.make_pipeline_mesh(3, devices=CPU8),
                                   kernels, microbatch=2)
    np.testing.assert_array_equal(f(imgs, shifts).numpy(),
                                  _contract(imgs, kernels, shifts))


def test_pipelined_forward_flagship_geometry(stock_kernels, rng):
    f = pipeline.pipelined_forward(pipeline.make_pipeline_mesh(3, devices=CPU8),
                                   stock_kernels, microbatch=4)
    imgs = rng.randint(0, 256, size=(8, 128, 128)).astype(np.uint8)
    feats = f(torch.from_numpy(imgs), torch.tensor(j_cnn.DEFAULT_SHIFTS,
                                                   dtype=torch.int32)).numpy()
    for b in range(0, 8, 3):
        np.testing.assert_array_equal(feats[b],
                                      numpy_cnn_forward(imgs[b], stock_kernels))


def test_pipelined_forward_rejects_bad_config():
    with pytest.raises(ValueError, match="must be in"):
        pipeline.split_stages(3, 4)
    kernels, imgs, shifts = _tiny_pipe_setup(np.random.RandomState(3))
    f = pipeline.pipelined_forward(pipeline.make_pipeline_mesh(2, devices=CPU8),
                                   kernels, microbatch=5)
    with pytest.raises(ValueError, match="microbatch"):
        f(imgs, shifts)  # 12 % 5 != 0
    with pytest.raises(ValueError, match="pipe"):
        pipeline.pipelined_forward(mesh.make_mesh(model_axis=2, devices=CPU8),
                                   kernels)
    with pytest.raises(ValueError, match="stages for a"):
        pipeline.pipelined_forward(pipeline.make_pipeline_mesh(2, devices=CPU8),
                                   kernels, stages=[(0, 3)])


def test_pipelined_forward_composite_dp_pp():
    rs = np.random.RandomState(17)
    cfgs = [(1, 8, 32), (8, 16, 16), (16, 32, 8), (32, 64, 4)]
    kernels = _kernels(rs, cfgs)
    imgs = rs.randint(0, 256, size=(12, 32, 32)).astype(np.uint8)
    shifts = [2, 4, 5, 6]
    m = pipeline.make_pipeline_mesh(8, data_axis=2, devices=CPU8)
    assert m.axis_names == ("data", "pipe")
    f = pipeline.pipelined_forward(m, kernels, microbatch=2)
    np.testing.assert_array_equal(f(imgs, shifts).numpy(),
                                  _contract(imgs, kernels, shifts))
    with pytest.raises(ValueError, match="data shards"):
        f(imgs[:10], shifts)  # 10 % (2*2) != 0


def test_pipelined_forward_nonsquare_wrap_and_4d():
    """Non-square images, ``accum_wrap`` and the (B, 1, H, W) form on both
    axes, against the JAX contract with the same wrap."""
    rs = np.random.RandomState(23)
    kernels = _kernels(rs, [(1, 16, 32), (16, 64, 16)])
    imgs = np.full((4, 32, 64), 255, np.uint8)  # H != W; wraps at shift 0
    shifts = [0, 0]
    ref = _contract(imgs, kernels, shifts, accum_wrap=True,
                    compute_dtype="int32")
    assert ref.shape == (4, 64, 8 * 16)
    f_pp = pipeline.pipelined_forward(
        pipeline.make_pipeline_mesh(2, devices=CPU8), kernels, microbatch=2,
        accum_wrap=True, compute_dtype="int32")
    f_sp = spatial.spatial_forward(
        spatial.make_spatial_mesh(4, devices=CPU8), kernels, accum_wrap=True,
        compute_dtype="int32")
    for f in (f_pp, f_sp):
        np.testing.assert_array_equal(f(imgs, shifts).numpy(), ref)
        np.testing.assert_array_equal(f(imgs[:, None], shifts).numpy(), ref)


# ── spatial parallelism (row bands + halo exchange over 'space') ───────


@pytest.mark.parametrize("n_devices", [2, 4, 8])
def test_spatial_forward_bit_exact(n_devices):
    rs = np.random.RandomState(5)
    kernels = _kernels(rs, CFGS)
    imgs = rs.randint(0, 256, size=(4, 64, 64)).astype(np.uint8)
    shifts = [2, 4, 6]
    f = spatial.spatial_forward(
        spatial.make_spatial_mesh(n_devices, devices=CPU8), kernels)
    np.testing.assert_array_equal(f(imgs, shifts).numpy(),
                                  _contract(imgs, kernels, shifts))


def test_spatial_forward_flagship_geometry(stock_kernels, rng):
    f = spatial.spatial_forward(spatial.make_spatial_mesh(4, devices=CPU8),
                                stock_kernels)
    imgs = rng.randint(0, 256, size=(6, 128, 128)).astype(np.uint8)
    feats = f(imgs, j_cnn.DEFAULT_SHIFTS).numpy()
    for b in range(0, 6, 2):
        np.testing.assert_array_equal(feats[b],
                                      numpy_cnn_forward(imgs[b], stock_kernels))


def test_spatial_forward_wrap_semantics():
    rs = np.random.RandomState(9)
    kernels = _kernels(rs, [(1, 16, 32), (16, 64, 16)])
    imgs = np.full((2, 32, 32), 255, np.uint8)
    f = spatial.spatial_forward(spatial.make_spatial_mesh(4, devices=CPU8),
                                kernels, accum_wrap=True, compute_dtype="int32")
    np.testing.assert_array_equal(
        f(imgs, [0, 0]).numpy(),
        _contract(imgs, kernels, [0, 0], accum_wrap=True, compute_dtype="int32"))


def test_spatial_forward_rejects_straddling_split():
    with pytest.raises(ValueError, match="straddle"):
        spatial.check_spatial_split(32, 3, 8)
    spatial.check_spatial_split(128, 3, 8)  # a valid split raises nothing
    rs = np.random.RandomState(1)
    kernels = [rs.randint(-127, 128, size=(8, 1, 3, 3)).astype(np.int8)] * 3
    with pytest.raises(ValueError, match="space"):
        spatial.spatial_forward(mesh.make_mesh(model_axis=2, devices=CPU8),
                                kernels)


def test_spatial_forward_composite_dp_sp():
    rs = np.random.RandomState(13)
    kernels = _kernels(rs, CFGS)
    imgs = rs.randint(0, 256, size=(6, 64, 64)).astype(np.uint8)
    m = spatial.make_spatial_mesh(8, data_axis=2, devices=CPU8)
    assert m.axis_names == ("data", "space")
    f = spatial.spatial_forward(m, kernels)
    np.testing.assert_array_equal(f(imgs, [2, 4, 6]).numpy(),
                                  _contract(imgs, kernels, [2, 4, 6]))
    with pytest.raises(ValueError, match="divisible by data"):
        f(imgs[:5], [2, 4, 6])


def test_spatial_forward_large_input_regime():
    """512 px, a 4-layer ladder, row-sharded 8 ways."""
    rs = np.random.RandomState(21)
    cfgs = [(1, 16, 256), (16, 32, 128), (32, 48, 64), (48, 64, 32)]
    kernels = _kernels(rs, cfgs)
    imgs = rs.randint(0, 256, size=(2, 512, 512)).astype(np.uint8)
    f = spatial.spatial_forward(spatial.make_spatial_mesh(8, devices=CPU8),
                                kernels)
    out = f(imgs, [3, 5, 6, 7]).numpy()
    assert out.shape == (2, 64, 32 * 32)
    np.testing.assert_array_equal(out, _contract(imgs, kernels, [3, 5, 6, 7]))


def test_dryrun_mesh_on_cpu_positions():
    """The serving dry run on four CPU positions: every meshed path equals
    the single-device path (it raises otherwise)."""
    done = dryrun_mesh(4, [torch.device("cpu")] * 4)
    assert set(done) == {"xla detect", "mega detect",
                         "multi detect, instances 1",
                         "multi detect, instances 2", "pipeline", "spatial"}
    assert done["pipeline"] == (3,) and done["spatial"] == (4,)
