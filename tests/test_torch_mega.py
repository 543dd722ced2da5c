"""The port's megakernel wrapper and chained plan (``tpu_cnn_torch.ops.mega``)
against the JAX megakernel ``pallas_poly.cnn_forward_polyphase_pallas`` and
the JAX chained plan ``pallas_poly.cnn_forward_mega``, run in Pallas
interpret mode on the CPU, on the same inputs.

On a CPU tensor the wrapper runs the kernel's plain version, so these tests
hold the plain version (and the wrapper's output contract) against the TPU
kernel. The CUDA kernel itself has no CPU or interpret mode: the tests
marked ``cuda`` hold it against the plain version on the card and skip
elsewhere (run them with ``python -m pytest -m cuda tests/test_torch_mega.py``
on a machine with a GPU and nvcc).

Tolerances: features and twin bit-equal (integer contract; 0..255 is exact
in bf16). Bins within 1e-6: both sides take exact integer bin sums, then
divide by npx^2 and by 255 in f32, where a division folded into a
multiplication by the reciprocal can move the last bit (~6e-8)."""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip(
    "torch", reason="torch not installed: the PyTorch port cannot be tested")

import jax.numpy as jnp  # noqa: E402

from tpu_cnn.engine.cpu_ref import numpy_cnn_forward  # noqa: E402
from tpu_cnn.models.cnn import DEFAULT_SHIFTS  # noqa: E402
from tpu_cnn.models.registry import REGISTRY, default_shifts, get_config  # noqa: E402
from tpu_cnn.ops import pallas_poly  # noqa: E402
from tpu_cnn.utils import artifacts as art  # noqa: E402
from tpu_cnn.utils.paths import default_artifacts  # noqa: E402
from tpu_cnn_torch.ops import _build, conv_pool, mega  # noqa: E402

BINS_ATOL = 1e-6
COMBOS = [c for c in itertools.product((True, False), repeat=3) if any(c)]


def _random_kernels(rs, layer_configs):
    """Full-range int8 kernels, (oc, ic, 3, 3) per layer."""
    return [rs.randint(-127, 128, (oc, ic, 3, 3)).astype(np.int8)
            for ic, oc, _ in layer_configs]


def _case(variant, seed, batch, kernels=None):
    rs = np.random.RandomState(seed)
    cfg = get_config(variant)
    if kernels is None:
        kernels = _random_kernels(rs, cfg.layer_configs)
    shifts = np.asarray(default_shifts(cfg) if variant != "lyr3-std"
                        else DEFAULT_SHIFTS, np.int32)
    imgs = rs.randint(0, 256, (batch, cfg.img_size, cfg.img_size)).astype(np.uint8)
    return imgs, kernels, shifts


def _jax_mega(imgs, kernels, shifts):
    """(feats, bins, twin) from the TPU kernel in interpret mode."""
    out = pallas_poly.cnn_forward_polyphase_pallas(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels],
        jnp.asarray(shifts), interpret=True, with_feats=True, with_bins=True,
        with_twin=True)
    return tuple(np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                 else np.asarray(a) for a in out)


def _port(imgs, kernels, shifts, device="cpu", **flags):
    return mega.cnn_forward_mega(
        torch.from_numpy(imgs).to(device),
        [torch.from_numpy(k).to(device) for k in kernels],
        torch.from_numpy(shifts).to(device), **flags)


def _assert_outputs(got, want, flags):
    """``got``: the wrapper's return for ``flags``; ``want``: all three."""
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == sum(flags)
    for name, on, ref in zip(("feats", "bins", "twin"), flags, want):
        if not on:
            continue
        g = got.pop(0).cpu()
        if name == "feats":
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), ref)
        elif name == "bins":
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=BINS_ATOL)
        else:
            assert g.dtype == torch.bfloat16
            np.testing.assert_array_equal(g.float().numpy(), ref)


@pytest.fixture(scope="module")
def tiny():
    """lyr3-tiny, B=5 (not a multiple of the TPU kernel's batch tile)."""
    imgs, kernels, shifts = _case("lyr3-tiny", 21, 5)
    return imgs, kernels, shifts, _jax_mega(imgs, kernels, shifts)


@pytest.mark.parametrize("flags", COMBOS,
                         ids=lambda c: "feats%d-bins%d-twin%d" % c)
def test_mega_matches_pallas_interpret(tiny, flags):
    imgs, kernels, shifts, want = tiny
    got = _port(imgs, kernels, shifts, with_feats=flags[0],
                with_bins=flags[1], with_twin=flags[2])
    _assert_outputs(got, want, flags)


def test_mega_lyr3_std_shipped_weights():
    kernels = art.load_bundle(default_artifacts()).kernels
    imgs, kernels, shifts = _case("lyr3-std", 22, 2, kernels=kernels)
    want = _jax_mega(imgs, kernels, shifts)
    np.testing.assert_array_equal(
        want[0], np.stack([numpy_cnn_forward(im, kernels) for im in imgs]))
    got = _port(imgs, kernels, shifts, with_feats=True, with_bins=True,
                with_twin=True)
    _assert_outputs(got, want, (True, True, True))


def test_no_outputs_raises(tiny):
    imgs, kernels, shifts, _ = tiny
    with pytest.raises(ValueError, match="at least one"):
        _port(imgs, kernels, shifts, with_feats=False)


def test_lyr4_wide_chain_matches_jax_chain():
    """lyr4-wide on the chained plan (one head layer + the L1-L3 tail)
    against JAX's ``cnn_forward_mega``, which runs the same plan (K3 head,
    K1 tail) in interpret mode, and against the numpy oracle; B=2."""
    imgs, kernels, shifts = _case("lyr4-wide", 23, 2)
    shifts = np.asarray([3, 5, 5, 7], np.int32)  # the shipped bundle's
    out = pallas_poly.cnn_forward_mega(
        jnp.asarray(imgs), [jnp.asarray(k) for k in kernels],
        jnp.asarray(shifts), interpret=True, with_feats=True, with_bins=True,
        with_twin=True)
    want = tuple(np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                 else np.asarray(a) for a in out)
    np.testing.assert_array_equal(
        want[0], np.stack([numpy_cnn_forward(im, kernels, shifts)
                           for im in imgs]))
    for flags in ((True, True, True), (False, True, False)):
        got = _port(imgs, kernels, shifts, with_feats=flags[0],
                    with_bins=flags[1], with_twin=flags[2])
        _assert_outputs(got, want, flags)


def test_cpu_chain_equals_the_whole_net_plain_version():
    """On the CPU the chain is conv_pool_reference then mega_reference on
    the tail; it is bit-equal to mega_reference on the whole net."""
    imgs, kernels, shifts = _case("lyr4-wide", 25, 2)
    t = (torch.from_numpy(imgs), [torch.from_numpy(k) for k in kernels],
         torch.from_numpy(shifts))
    got = mega.cnn_forward_mega(*t, with_feats=True, with_bins=True,
                                with_twin=True)
    for g, w in zip(got, mega.mega_reference(*t)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("variant,n_head", [
    ("lyr3-std", 0), ("lyr3-tiny", 0), ("lyr2-small", 0), ("lyr4-wide", 1)])
def test_mega_plan(variant, n_head):
    cfgs = REGISTRY[variant].layer_configs
    assert mega.mega_plan(cfgs) == n_head
    assert mega.mega_smem_bytes(cfgs[n_head:]) <= mega.MAX_SMEM_BYTES


def test_mega_plan_refuses_what_no_tail_fits():
    # one 512^2 layer with 16 outputs: 16 * 256^2 = 1 MiB of output
    assert mega.mega_plan(((1, 16, 512),)) is None
    assert mega.mega_plan(()) is None
    # five small layers: the tail drops the first to fit four
    five = ((1, 16, 64), (16, 16, 32), (16, 16, 16), (16, 16, 8), (16, 16, 4))
    assert mega.mega_plan(five) == 1
    rs = np.random.RandomState(26)
    kernels = _random_kernels(rs, ((1, 16, 512),))
    imgs = rs.randint(0, 256, (1, 512, 512)).astype(np.uint8)
    with pytest.raises(ValueError, match="fits one CTA"):
        _port(imgs, kernels, np.asarray([2], np.int32))


@pytest.mark.parametrize("variant,smem", [
    ("lyr3-std", 65536 + 32768), ("lyr3-tiny", 4096 + 2048),
    ("lyr2-small", 16384 + 8192), ("lyr4-wide", 131072 + 65536)])
def test_smem_model(variant, smem):
    """Peak shared memory of the megakernel's part of the plan: the two
    largest alternating layer outputs. Every whole net but lyr4-wide
    (262,144 + 131,072 B) fits one CTA; lyr4-wide's L1-L3 tail does."""
    cfgs = REGISTRY[variant].layer_configs
    tail = cfgs[mega.mega_plan(cfgs):]
    assert mega.mega_smem_bytes(tail) == smem <= mega.MAX_SMEM_BYTES
    whole = mega.mega_smem_bytes(cfgs)
    assert (whole <= mega.MAX_SMEM_BYTES) == (variant != "lyr4-wide")
    if variant == "lyr4-wide":
        assert whole == 262144 + 131072


def test_tail_input_matches_pallas_nchw_entry():
    """The 4-D (B, 16, 128, 128) tail input of lyr4-wide's L1-L3 against
    the TPU kernel's multi-channel NCHW entry (tb=1, interpret mode)."""
    rs = np.random.RandomState(27)
    kernels = _random_kernels(rs, REGISTRY["lyr4-wide"].layer_configs)[1:]
    shifts = np.asarray([5, 5, 7], np.int32)
    x = rs.randint(0, 256, (2, 16, 128, 128)).astype(np.uint8)
    out = pallas_poly.cnn_forward_polyphase_pallas(
        jnp.asarray(x), [jnp.asarray(k) for k in kernels], jnp.asarray(shifts),
        tb=1, interpret=True, with_feats=True, with_bins=True, with_twin=True)
    want = tuple(np.asarray(a.astype(jnp.float32)) if a.dtype == jnp.bfloat16
                 else np.asarray(a) for a in out)
    before = conv_pool.launches, mega.launches
    for flags in COMBOS:
        _assert_outputs(_port(x, kernels, shifts, with_feats=flags[0],
                              with_bins=flags[1], with_twin=flags[2]),
                        want, flags)
    assert (conv_pool.launches, mega.launches) == before


def test_cpu_runs_the_plain_version_without_launching(tiny):
    imgs, kernels, shifts, _ = tiny
    before = mega.launches
    feats = _port(imgs, kernels, shifts)
    ref = mega.mega_reference(torch.from_numpy(imgs),
                              [torch.from_numpy(k) for k in kernels],
                              torch.from_numpy(shifts))[0]
    assert torch.equal(feats, ref)
    assert mega.launches == before  # the CPU path launches nothing


def test_other_devices_raise_instead_of_falling_back(tiny):
    imgs, kernels, shifts, _ = tiny
    before = mega.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        _port(imgs, kernels, shifts, device="meta")
    assert mega.launches == before


def test_bad_inputs_raise(tiny):
    imgs, kernels, shifts, _ = tiny
    with pytest.raises(ValueError, match="uint8"):
        _port(imgs.astype(np.int32), kernels, shifts)
    with pytest.raises(ValueError, match="int32"):
        _port(imgs, kernels, shifts.astype(np.int64))
    with pytest.raises(ValueError, match="chain"):
        _port(imgs, kernels[::-1], shifts)
    with pytest.raises(ValueError, match="chain"):
        _port(imgs[:, None].repeat(2, axis=1), kernels, shifts)  # ic0 = 2
    with pytest.raises(ValueError, match="uint8"):
        _port(imgs[:, None, None], kernels, shifts)  # 5-D


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source nvcc cannot build (or no nvcc at all) raises with the
    reason; nothing is loaded in its place."""
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(_build.KernelBuildError):
        _build.build("broken")
    assert not list(tmp_path.glob("build/*.so"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA megakernel has no "
                    "CPU or interpret mode (on the card: python -m pytest -m "
                    "cuda tests/test_torch_mega.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small", "lyr3-std",
                                     "lyr4-wide"])
def test_kernel_matches_plain_version_on_card(cuda_device, variant):
    """Every registry geometry on the chained plan; lyr4-wide launches the
    layer kernel and the megakernel per call."""
    imgs, kernels, shifts = _case(variant, 24, 37)
    t = (torch.from_numpy(imgs).to(cuda_device),
         [torch.from_numpy(k).to(cuda_device) for k in kernels],
         torch.from_numpy(shifts).to(cuda_device))
    want = [a.float().cpu().numpy() if a.dtype == torch.bfloat16
            else a.cpu().numpy()
            for a in mega.mega_reference(*t, compute_dtype="int32")]
    before = mega.launches, conv_pool.launches
    for flags in COMBOS:
        got = mega.cnn_forward_mega(*t, with_feats=flags[0],
                                    with_bins=flags[1], with_twin=flags[2])
        torch.cuda.synchronize()
        _assert_outputs(got, want, flags)
    n_head = mega.mega_plan(get_config(variant).layer_configs)
    assert (mega.launches, conv_pool.launches) == (
        before[0] + len(COMBOS), before[1] + n_head * len(COMBOS))


@pytest.mark.cuda
def test_tail_input_kernel_matches_plain_version_on_card(cuda_device):
    """The megakernel on lyr4-wide's 4-D (B, 16, 128, 128) tail input."""
    rs = np.random.RandomState(28)
    kernels = _random_kernels(rs, REGISTRY["lyr4-wide"].layer_configs)[1:]
    t = (torch.from_numpy(rs.randint(0, 256, (37, 16, 128, 128))
                          .astype(np.uint8)).to(cuda_device),
         [torch.from_numpy(k).to(cuda_device) for k in kernels],
         torch.tensor([5, 5, 7], dtype=torch.int32, device=cuda_device))
    want = [a.float().cpu().numpy() if a.dtype == torch.bfloat16
            else a.cpu().numpy()
            for a in mega.mega_reference(*t, compute_dtype="int32")]
    for flags in COMBOS:
        got = mega.cnn_forward_mega(*t, with_feats=flags[0],
                                    with_bins=flags[1], with_twin=flags[2])
        torch.cuda.synchronize()
        _assert_outputs(got, want, flags)
