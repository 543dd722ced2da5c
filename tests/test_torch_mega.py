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
from tpu_cnn_torch.ops import _build, conv_pool, int8, mega, quant  # noqa: E402

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


# the kernel's shared memory (mega_layout): (region 0, region 1, the image
# buffer, layer 0's band rows, which weights stay resident). Layer outputs
# channels-last with a 1-pixel halo and cpad channels a pixel, the final
# one NCHW; a one-channel image in its own buffer (S + 2 rows of S bytes);
# lyr4-wide's 16-channel tail input in bands in region 1, behind which L1's
# weights go (its L3's go behind L3's output, per image)
LAYOUTS = {"lyr3-std": (66 * 66 * 16, 34 * 34 * 32, 130 * 128, 128, (True,) * 3),
           "lyr3-tiny": (18 * 18 * 16, 10 * 10 * 32, 34 * 32, 32, (True,) * 3),
           "lyr2-small": (34 * 34 * 16, 32 * 16 * 16, 66 * 64, 64, (True,) * 2),
           "lyr4-wide": (66 * 66 * 32, 34 * 34 * 64, 0, 30, (False, True, False))}


@pytest.mark.parametrize("variant,smem", [
    ("lyr3-std", 65536 + 32768), ("lyr3-tiny", 4096 + 2048),
    ("lyr2-small", 16384 + 8192), ("lyr4-wide", 131072 + 65536)])
def test_smem_model(variant, smem):
    """Peak shared memory of the megakernel's part of the plan. ``smem``:
    the two largest alternating layer outputs as bare u8 maps; the kernel's
    two regions add each output's halo and channel padding, then come the
    image buffer and the weights. Every whole net but lyr4-wide fits one
    CTA; lyr4-wide's L1-L3 tail does, with its 16 x 128^2 input in bands
    of 30 rows and two layers' weights copied per image."""
    cfgs = REGISTRY[variant].layer_configs
    tail = cfgs[mega.mega_plan(cfgs):]
    bare = [0, 0]
    for li, (_ic, oc, s) in enumerate(tail):
        bare[li % 2] = max(bare[li % 2], oc * (s // 2) ** 2)
    assert sum(bare) == smem
    lay = mega.mega_layout(tail)
    assert (lay.region0, lay.region1, lay.input, lay.band_rows,
            lay.resident) == LAYOUTS[variant]
    assert lay.region0 >= bare[0] and lay.region1 >= bare[1]
    assert lay.weights == tuple(mega.weight_bytes(ic, oc) for ic, oc, _ in tail)
    assert lay.weights == tuple(mega.packed_shape(torch.zeros(
        (oc, ic, 3, 3), dtype=torch.int8))[0] for ic, oc, _ in tail)
    assert mega.mega_smem_bytes(tail) == lay.smem <= mega.MAX_SMEM_BYTES
    # the buffers do not overlap: weights that stay sit past everything
    # else, and the others past what their layer reads and writes
    ends = sorted(off + w for off, w in zip(lay.w_offsets, lay.weights))
    assert ends[-1] <= lay.smem and all(off % 128 == 0 for off in lay.w_offsets)
    base = (128 + -(-lay.region0 // 128) * 128 + -(-lay.region1 // 128) * 128
            + -(-lay.input // 128) * 128)
    for off, keep in zip(lay.w_offsets, lay.resident):
        assert (off >= base) == keep
    whole = mega.mega_smem_bytes(cfgs)
    assert (whole is not None) == (variant != "lyr4-wide")
    if variant == "lyr4-wide":  # its L0 output alone: 130^2 x 16 bytes
        assert mega.mega_layout(cfgs) is None


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


# ── the tensor-core kernels' packed weights ──────────────────────────

PACK_GEOMETRIES = [(1, 16), (16, 32), (32, 64), (64, 128), (3, 5), (20, 35),
                   (16, 1), (1, 1), (128, 16)]


def _fragment_b(packed):
    """The (K, N) int32 GEMM operand a packed tensor feeds the MMAs, read
    by the PTX fragment layout of mma.m16n8k32's B (lane l, register r,
    byte j: k = 16 r + 4 (l % 4) + j, n = l // 4), not by ``_unpack``."""
    ks, nt = packed.shape[:2]
    b = torch.zeros((32 * ks, 8 * nt), dtype=torch.int32)
    for s in range(ks):
        for t in range(nt):
            for lane in range(32):
                for byte in range(8):
                    k = 32 * s + 16 * (byte // 4) + 4 * (lane % 4) + byte % 4
                    b[k, 8 * t + lane // 4] = int(packed[s, t, lane, byte])
    return b


def _wgmma_b(packed, ic, oc):
    """The (K, N) int32 operand the megakernel's wgmma reads from a packed
    multi-channel layer, by the K-major core-matrix layout of its shared
    memory (8 N rows x 16 K bytes a core matrix, the two of a K step 128
    bytes apart, groups of 8 channels 256 apart: byte ((s * NG + n8) * 2 +
    h) * 128 + 16 r + j holds B[32 s + 16 h + j][8 n8 + r]), not by the
    packing's own arithmetic."""
    ks = -(-9 * mega.cpad(ic) // 32)
    nw = mega.chunk_n(oc)
    npad = -(-oc // nw) * nw
    flat = packed.numpy().astype(np.int32)
    assert flat.shape == (ks * npad * 32,)
    b = np.zeros((32 * ks, npad), np.int32)
    for s in range(ks):
        for n8 in range(npad // 8):
            for h in range(2):
                for r in range(8):
                    at = ((s * (npad // 8) + n8) * 2 + h) * 128 + 16 * r
                    b[32 * s + 16 * h:32 * s + 16 * h + 16, 8 * n8 + r] = flat[at:at + 16]
    return torch.from_numpy(b)


def _unpack(b, ic, oc):
    """A (K, N) GEMM operand back to (oc, ic, 3, 3) int8 (K = 9 taps x
    cpad(ic), tap-major)."""
    cp = mega.cpad(ic)
    return (b[:9 * cp].reshape(9, cp, -1)[:, :ic, :oc].to(torch.int8)
            .reshape(3, 3, ic, oc).permute(3, 2, 0, 1).contiguous())


def _want_b(k, rows, cols):
    """The (rows, cols) int32 GEMM operand of kernel k: K tap-major over
    cpad channels, zero in the padding."""
    oc, ic = k.shape[:2]
    cp = mega.cpad(ic)
    want = torch.zeros((rows, cols), dtype=torch.int32)
    want[:9 * cp].view(9, cp, -1)[:, :ic, :oc] = (
        k.permute(2, 3, 1, 0).reshape(9, ic, oc).to(torch.int32))
    return want


@pytest.mark.parametrize("ic,oc", PACK_GEOMETRIES)
def test_packed_weights_round_trip(ic, oc):
    """The megakernel's packing: a one-channel layer's is the recast's B
    (``pack_one_channel``'s bytes); a multi-channel layer's is the wgmma
    B, K-major core matrices, every byte where the core-matrix layout puts
    it, zero in the padded K rows and N columns. Its size is
    ``weight_bytes`` (the kernel copies that many), and its shape differs
    from every shape the kernel read before (4-D fragments), so an old
    packing is refused."""
    rs = np.random.RandomState(40 + ic + oc)
    k = torch.from_numpy(rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8))
    packed = mega.pack_weights(k)
    assert packed.dtype == torch.int8 and packed.is_contiguous() and packed.dim() == 1
    assert tuple(packed.shape) == mega.packed_shape(k) == (mega.weight_bytes(ic, oc),)
    assert tuple(packed.shape) != mega.fragments_shape(k)
    if ic == 1:
        assert torch.equal(packed, mega.pack_one_channel(k).reshape(-1))
        return
    b = _wgmma_b(packed, ic, oc)
    assert torch.equal(_unpack(b, ic, oc), k)
    assert torch.equal(b, _want_b(k, *b.shape))


@pytest.mark.parametrize("ic,oc", PACK_GEOMETRIES)
def test_fragment_weights_round_trip(ic, oc):
    """The layer kernel's packing of a multi-channel layer (mma.m16n8k32's
    B fragments, ``pack_fragments``), read back by the fragment layout."""
    rs = np.random.RandomState(40 + ic + oc)
    k = torch.from_numpy(rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8))
    packed = mega.pack_fragments(k)
    cp = mega.cpad(ic)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == mega.fragments_shape(k) == (
        -(-9 * cp // 32), -(-oc // 8), 32, 8)
    b = _fragment_b(packed)
    assert torch.equal(_unpack(b, ic, oc), k)
    assert torch.equal(b, _want_b(k, *b.shape))
    if ic > 1:
        assert torch.equal(mega.pack_layer(k), packed)


def _implicit_gemm_layer(x, b, ic, oc, shift):
    """One multi-channel layer as the kernel computes it, in plain int32 on
    the CPU: channels-last with a zero halo and cpad channels, im2col in the
    tap-major K order (padded to B's K), one GEMM with the decoded B, then
    >> shift, clip and the 2x2 max."""
    bsz, _, s, _ = x.shape
    cp = mega.cpad(ic)
    xl = torch.zeros((bsz, s + 2, s + 2, cp), dtype=torch.int32)
    xl[:, 1:-1, 1:-1, :ic] = x.permute(0, 2, 3, 1).to(torch.int32)
    cols = torch.stack([xl[:, ky:ky + s, kx:kx + s] for ky in range(3)
                        for kx in range(3)], dim=3)  # (B, S, S, 9, cp)
    a = torch.zeros((bsz * s * s, b.shape[0]), dtype=torch.int32)
    a[:, :9 * cp] = cols.reshape(bsz * s * s, 9 * cp)
    acc = (a @ b)[:, :oc].reshape(bsz, s, s, oc).permute(0, 3, 1, 2)
    act = torch.clamp(acc >> shift, 0, 255)
    return act.reshape(bsz, oc, s // 2, 2, s // 2, 2).amax(dim=(3, 5)).to(torch.uint8)


def _emulated_layer(x, packed, ic, oc, shift):
    """One layer from the megakernel's packed bytes, the way the kernel
    runs it: the one-channel recast (the 4x4 patch under each quad times
    the fragment-decoded 16 x (4 x G*16) matrix, the max over the four
    positions) or the wgmma implicit GEMM."""
    if ic == 1:
        acc = _one_channel_gemm(x, packed.view(-1, 8, 32, 4), oc)
        return torch.clamp(acc.amax(dim=3) >> shift, 0, 255).permute(0, 3, 1, 2).to(torch.uint8)
    return _implicit_gemm_layer(x, _wgmma_b(packed, ic, oc), ic, oc, shift)


@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small", "lyr4-wide-tail"])
def test_gemm_in_packed_order_equals_the_plain_version(variant):
    rs = np.random.RandomState(41)
    if variant == "lyr4-wide-tail":
        cfgs = REGISTRY["lyr4-wide"].layer_configs[1:]
        x = torch.from_numpy(rs.randint(0, 256, (2, 16, 32, 32)).astype(np.uint8))
        cfgs = tuple((ic, oc, 32 >> i) for i, (ic, oc, _) in enumerate(cfgs))
        shifts = [5, 5, 7]
    else:
        cfgs = REGISTRY[variant].layer_configs
        x = torch.from_numpy(rs.randint(0, 256, (2, 1, cfgs[0][2], cfgs[0][2]))
                             .astype(np.uint8))
        shifts = default_shifts(get_config(variant))
    kernels = [torch.from_numpy(k) for k in _random_kernels(rs, cfgs)]
    want = mega.mega_reference(x, kernels, torch.tensor(shifts, dtype=torch.int32),
                               compute_dtype="int32")[0]
    h = x
    for k, sh in zip(kernels, shifts):
        ic, oc = int(k.shape[1]), int(k.shape[0])
        h = _emulated_layer(h, mega.pack_weights(k), ic, oc, sh)
    assert torch.equal(h.reshape(want.shape), want)


@pytest.mark.parametrize("weights", ["shipped", "seed7"])
@pytest.mark.parametrize("variant", ["lyr3-tiny", "lyr2-small"])
def test_emulated_packing_matches_quant_and_the_tpu_kernel(variant, weights):
    """The megakernel's arithmetic on its packed bytes (``pack_plan``, the
    recast for L0 and the wgmma B for the others, decoded by the PTX
    layouts and multiplied in numpy int32) equals ``quant.cnn_forward``
    after every layer and the TPU kernel in interpret mode at the end.
    ``shipped``: lyr3-std's shipped kernels, whose shapes lyr3-tiny's
    layers (and lyr2-small's first two) share; ``seed7``: full-range
    kernels from seed 7."""
    cfg = get_config(variant)
    if weights == "shipped":
        kernels = art.load_bundle(default_artifacts()).kernels[:len(cfg.layer_configs)]
    else:
        kernels = _random_kernels(np.random.RandomState(7), cfg.layer_configs)
    shifts = np.asarray(default_shifts(cfg), np.int32)
    imgs = np.random.RandomState(48).randint(
        0, 256, (2, cfg.img_size, cfg.img_size)).astype(np.uint8)
    ks = [torch.from_numpy(k) for k in kernels]
    packed = mega.pack_plan(ks, cfg.img_size)
    assert mega.mega_plan(cfg.layer_configs) == 0
    h = torch.from_numpy(imgs)[:, None]
    for li, (k, p) in enumerate(zip(ks, packed)):
        h = _emulated_layer(h, p, int(k.shape[1]), int(k.shape[0]), int(shifts[li]))
        want = quant.cnn_forward(torch.from_numpy(imgs), ks[:li + 1],
                                 torch.from_numpy(shifts[:li + 1]), compute_dtype="int32")
        assert torch.equal(h.reshape(want.shape), want), f"layer {li}"
    jax_feats = _jax_mega(imgs, kernels, shifts)[0]
    np.testing.assert_array_equal(h.reshape(jax_feats.shape).numpy(), jax_feats)


def test_old_fragment_packing_is_refused():
    """A packing in the kernel's layout before the wgmma design (mma.sync
    fragments for every layer, the one-channel L0 padded to K 32) is
    refused with ValueError before anything runs: every shape differs from
    the new packing's."""
    rs = np.random.RandomState(49)
    cfg = get_config("lyr3-std")
    ks = [torch.from_numpy(k) for k in _random_kernels(rs, cfg.layer_configs)]
    old = [mega.pack_fragments(k) for k in ks]
    assert [tuple(p.shape) for p in old] == [(1, 2, 32, 8), (5, 4, 32, 8), (9, 8, 32, 8)]
    assert all(tuple(o.shape) != mega.packed_shape(k) for o, k in zip(old, ks))
    imgs = torch.from_numpy(rs.randint(0, 256, (1, 128, 128)).astype(np.uint8))
    shifts = torch.tensor([2, 4, 6], dtype=torch.int32)
    before = mega.launches
    with pytest.raises(ValueError, match="pack_plan"):
        mega._check_packed(old, ks, 0)
    with pytest.raises(ValueError, match="pack_plan"):
        mega.cnn_forward_mega(imgs, ks, shifts, packed=old)
    assert mega.launches == before


def test_engine_packs_its_weights_once_under_inference_mode(monkeypatch):
    """The engine packs the megakernel's weights when it is built, also
    under ``torch.inference_mode`` (a serving app's usual setting), and no
    detect packs them again."""
    from tpu_cnn_torch.apps.common import load_model
    from tpu_cnn_torch.engine.cuda import CUDAEngine

    calls = []
    pack = mega.pack_weights
    monkeypatch.setattr(mega, "pack_weights",
                        lambda k: calls.append(k) or pack(k))
    imgs = np.random.RandomState(42).randint(0, 256, (3, 128, 128)).astype(np.uint8)
    with torch.inference_mode():
        engine = CUDAEngine(load_model(default_artifacts()), device="cpu")
        assert len(calls) == 3
        for k, p in zip(engine.net.kernels, engine._packed):
            assert torch.equal(p, pack(k))
        first = engine.detect_batch(imgs)
        second = engine.detect_batch(imgs)
    assert len(calls) == 3  # packed once, not per call
    np.testing.assert_array_equal(first.pred, second.pred)


@pytest.mark.parametrize("bad", ["one short", "another kernel's", "int32"])
def test_packed_weights_must_match_the_kernels(tiny, bad):
    imgs, kernels, shifts, _ = tiny
    ks = [torch.from_numpy(k) for k in kernels]
    packed = [mega.pack_weights(k) for k in ks]
    if bad == "one short":
        packed = packed[:-1]
    elif bad == "another kernel's":
        packed[1] = packed[0]
    else:
        packed[0] = packed[0].to(torch.int32)
    with pytest.raises(ValueError, match="pack_weights"):
        mega.cnn_forward_mega(torch.from_numpy(imgs), ks,
                              torch.from_numpy(shifts), packed=packed)


@pytest.mark.parametrize("cfgs,rows", [
    (((1, 16, 128), (16, 32, 64), (32, 64, 32)), 128),   # lyr3-std: whole image
    (((16, 32, 128), (32, 64, 64), (64, 128, 32)), 30),  # lyr4-wide's tail
    (((1, 16, 64),), 64),                                 # one layer, whole
    (((64, 16, 64),), 2)])                                # one layer, thin bands
def test_layer0_band_rows(cfgs, rows):
    """A one-channel image comes whole into its own buffer (S + 2 rows of
    S bytes); a multi-channel one in bands into region 1, which holds
    them (and, behind them, L1's weights when those are copied per
    image)."""
    lay = mega.mega_layout(cfgs)
    assert lay.band_rows == rows and rows % 2 == 0
    assert lay.region0 >= 0 and lay.smem <= mega.MAX_SMEM_BYTES
    s, ic = cfgs[0][2], cfgs[0][0]
    if ic == 1:
        assert lay.input == (s + 2) * s and rows == s
    else:
        row = (s + 2) * mega.cpad(ic)
        assert lay.input == 0 and lay.region1 >= (rows + 2) * row
        if not lay.resident[0]:  # region 1 starts past the slack and region 0
            off1 = 128 + -(-lay.region0 // 128) * 128
            assert lay.w_offsets[0] >= off1 + (rows + 2) * row
            assert lay.w_offsets[0] + lay.weights[0] <= off1 + lay.region1


@pytest.mark.cuda
def test_smem_model_equals_the_kernels_plan(cuda_device):
    """mega_layout is a mirror of the kernel's smem_plan: on every registry
    net and tail, the kernel cases' edge geometries and seeded random nets,
    the library's exported plan refuses the same geometries and places
    every buffer where mega_layout does."""
    from tpu_cnn_torch.apps import kernel_cases

    assert kernel_cases.smem_plans_vs_kernel() == len(kernel_cases._plan_geometries())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["all-255 x 127", "all-255 x -128",
                                  "0/255 x 127/-128", "ic0=3", "wide middle",
                                  "padded N", "ragged", "one-channel middle",
                                  "one layer", "one layer 30 wide",
                                  "misaligned input", "3 channels 30 wide"])
def test_mma_edges_match_plain_version_on_card(cuda_device, case):
    """The tensor-core path's edges against the plain version on the card:
    saturating and most negative sums at shifts 0 and 31, padded K and N,
    the runtime-chunk path, column groups cut by the map's edge and
    one-layer nets (a one-channel image by plain loads when 30 wide or
    misaligned; a 3-channel band byte by byte when 30 wide)."""
    rs = np.random.RandomState(43)
    lyr3 = REGISTRY["lyr3-std"].layer_configs
    b = 37
    if case.startswith("all-255"):
        fill = 127 if case.endswith("127") else -128
        imgs = np.full((b, 128, 128), 255, np.uint8)
        kernels = [np.full((oc, ic, 3, 3), fill, np.int8) for ic, oc, _ in lyr3]
        shift_sets = [(0, 0, 0), (31, 31, 31)]
    elif case.startswith("0/255"):
        imgs = (rs.randint(0, 2, (b, 128, 128)) * 255).astype(np.uint8)
        kernels = [np.where(rs.randint(0, 2, (oc, ic, 3, 3)) == 1, 127,
                            -128).astype(np.int8) for ic, oc, _ in lyr3]
        shift_sets = [(0, 0, 0), (31, 31, 31), (9, 11, 13)]
    else:
        ic0, s, chans, sh = {
            "ic0=3": (3, 32, (24, 8), (3, 5)),
            "wide middle": (16, 16, (128, 16), (4, 9)),
            "padded N": (1, 32, (35, 13), (2, 6)),
            "ragged": (1, 24, (16, 24), (2, 5)),
            "one-channel middle": (1, 32, (1, 16), (1, 3)),
            "one layer": (16, 32, (32,), (6,)),
            "one layer 30 wide": (1, 30, (16,), (2,)),
            "misaligned input": (1, 32, (16, 32), (2, 4)),
            "3 channels 30 wide": (3, 30, (16,), (4,))}[case]
        imgs = rs.randint(0, 256, (b, s, s) if ic0 == 1 else (b, ic0, s, s)
                          ).astype(np.uint8)
        kernels = [rs.randint(-128, 128, (oc, ic, 3, 3)).astype(np.int8)
                   for ic, oc in zip((ic0,) + chans[:-1], chans)]
        shift_sets = [sh]
    x = torch.from_numpy(imgs).to(cuda_device)
    if case == "misaligned input":  # one byte into its storage: byte staging
        flat = torch.empty(x.numel() + 1, dtype=torch.uint8, device=cuda_device)
        flat[1:] = x.reshape(-1)
        x = flat[1:].view(x.shape)
    ks = [torch.from_numpy(k).to(cuda_device) for k in kernels]
    final = imgs.shape[-1] >> len(kernels)
    for sh in shift_sets:
        shifts = torch.tensor(sh, dtype=torch.int32, device=cuda_device)
        want = [a.float().cpu().numpy() if a is not None and a.dtype == torch.bfloat16
                else (a.cpu().numpy() if a is not None else None)
                for a in mega.mega_reference(x, ks, shifts, compute_dtype="int32")]
        for flags in COMBOS:
            if flags[1] and final % 4:
                continue
            got = mega.cnn_forward_mega(x, ks, shifts, with_feats=flags[0],
                                        with_bins=flags[1], with_twin=flags[2])
            torch.cuda.synchronize()
            _assert_outputs(got, want, flags)


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [None, 1, 5])
def test_persistent_grid_matches_plain_version_on_card(cuda_device, extra):
    """The persistent grid (one CTA per SM, each walking images): one
    image, and more images than CTAs (a second image for every CTA, the
    bulk copy of the next image under the current one's later layers)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    b = 1 if extra is None else sms + extra
    imgs, kernels, shifts = _case("lyr3-std", 50, b,
                                  kernels=art.load_bundle(default_artifacts()).kernels)
    t = (torch.from_numpy(imgs).to(cuda_device),
         [torch.from_numpy(k).to(cuda_device) for k in kernels],
         torch.from_numpy(shifts).to(cuda_device))
    want = [a.float().cpu().numpy() if a.dtype == torch.bfloat16 else a.cpu().numpy()
            for a in mega.mega_reference(*t, compute_dtype="int32")]
    got = mega.cnn_forward_mega(*t, with_feats=True, with_bins=True, with_twin=True)
    torch.cuda.synchronize()
    _assert_outputs(got, want, (True, True, True))


# ── the layer kernel's one-channel recast ────────────────────────────


def _one_channel_b(packed):
    """The (16, 4, G*16) int32 operand (K, position, channel) a packed
    one-channel tensor feeds the MMAs, read by the PTX fragment layout of
    mma.m16n8k16's B (lane l, byte j: k = 4 (l % 4) + j, n = l // 4; N tile
    t = 2 p + h holds channels 16 q + 8 h + n at position p), not by the
    packing's own arithmetic."""
    groups = packed.shape[0]
    b = torch.zeros((16, 4, 16 * groups), dtype=torch.int32)
    for q in range(groups):
        for t in range(8):
            p, h = divmod(t, 2)
            for lane in range(32):
                for j in range(4):
                    b[4 * (lane % 4) + j, p, 16 * q + 8 * h + lane // 4] = int(
                        packed[q, t, lane, j])
    return b


def _one_channel_gemm(x, packed, oc):
    """The recast GEMM in plain int32 on the CPU: each 2x2 output quad's
    4x4 input patch (zero outside the image) times the fragment-decoded
    weight matrix -> (B, quad rows, quad cols, position, oc) sums."""
    bsz, _, h, w = x.shape
    qh, qw = -(-h // 2), -(-w // 2)
    xp = torch.zeros((bsz, 2 * qh + 2, 2 * qw + 2), dtype=torch.int32)
    xp[:, 1:h + 1, 1:w + 1] = x[:, 0].to(torch.int32)
    patches = torch.stack([xp[:, r:r + 2 * qh:2, s:s + 2 * qw:2]
                           for r in range(4) for s in range(4)], dim=-1)
    b = _one_channel_b(packed)
    acc = patches.reshape(-1, 16) @ b.reshape(16, -1)
    return acc.reshape(bsz, qh, qw, 4, -1)[..., :oc]


@pytest.mark.parametrize("oc,h,w", [(16, 32, 32), (16, 16, 24), (5, 6, 10),
                                    (35, 8, 8), (13, 7, 9), (1, 4, 6)])
def test_one_channel_recast_equals_the_plain_versions(oc, h, w):
    """The recast (K = the 4x4 patch under a quad, N = 4 positions x oc)
    holds every output of the conv: the max over positions, shifted and
    clipped, is the plain pooled layer; the positions laid out as pixels
    are the plain unpooled conv (odd H or W: the quads past the edge are
    cut)."""
    rs = np.random.RandomState(44 + oc + h)
    k = torch.from_numpy(rs.randint(-128, 128, (oc, 1, 3, 3)).astype(np.int8))
    x = torch.from_numpy(rs.randint(0, 256, (3, 1, h, w)).astype(np.uint8))
    packed = mega.pack_one_channel(k)
    assert packed.dtype == torch.int8 and packed.is_contiguous()
    assert tuple(packed.shape) == mega.layer_packed_shape(k) == (-(-oc // 16), 8, 32, 4)
    assert torch.equal(mega.pack_layer(k), packed)
    acc = _one_channel_gemm(x, packed, oc)
    qh, qw = acc.shape[1:3]
    for sh in (0, 4, 31):
        shifts = torch.tensor([sh], dtype=torch.int32)
        act = torch.clamp(acc >> sh, 0, 255)
        full = (act.reshape(3, qh, qw, 2, 2, oc).permute(0, 5, 1, 3, 2, 4)
                .reshape(3, oc, 2 * qh, 2 * qw)[:, :, :h, :w])
        assert torch.equal(full.to(torch.uint8), int8.conv_act_reference(
            x, k, shifts, 0, compute_dtype="int32"))
        if h % 2 == 0 and w % 2 == 0:
            pooled = torch.clamp(acc.amax(dim=3) >> sh, 0, 255).permute(0, 3, 1, 2)
            assert torch.equal(pooled.to(torch.uint8), conv_pool.conv_pool_reference(
                x, k, shifts, 0, compute_dtype="int32"))


def test_one_channel_matrix_places_the_kernel_at_each_position():
    k = torch.arange(1, 10, dtype=torch.int8).view(1, 1, 3, 3)
    b = mega.one_channel_matrix(k).view(4, 4, 4, 16)  # (r, s, position, channel)
    for p in range(4):
        py, px = divmod(p, 2)
        want = torch.zeros((4, 4), dtype=torch.int8)
        want[py:py + 3, px:px + 3] = k[0, 0]
        assert torch.equal(b[:, :, p, 0], want)
    assert not b[..., 1:].any()  # padded channels hold zero weights


@pytest.mark.parametrize("variant,n_head", [("lyr3-std", 0), ("lyr4-wide", 1)])
def test_pack_plan_packs_the_head_layers_for_the_layer_kernel(variant, n_head):
    rs = np.random.RandomState(45)
    cfg = get_config(variant)
    ks = [torch.from_numpy(k) for k in _random_kernels(rs, cfg.layer_configs)]
    packed = mega.pack_plan(ks, cfg.img_size)
    assert len(packed) == len(ks)
    for i, (p, k) in enumerate(zip(packed, ks)):
        want = mega.pack_layer(k) if i < n_head else mega.pack_weights(k)
        assert torch.equal(p, want)


def test_chained_plan_takes_its_packing_on_cpu():
    """The lyr4-wide chain with ``pack_plan`` gives the plain chain's
    answer; K1's packing of the head layer is refused, naming both."""
    rs = np.random.RandomState(46)
    cfg = get_config("lyr4-wide")
    ks = [torch.from_numpy(k) for k in _random_kernels(rs, cfg.layer_configs)]
    imgs = torch.from_numpy(rs.randint(0, 256, (1, 256, 256)).astype(np.uint8))
    shifts = torch.tensor(default_shifts(cfg), dtype=torch.int32)
    got = mega.cnn_forward_mega(imgs, ks, shifts,
                                packed=mega.pack_plan(ks, cfg.img_size))
    assert torch.equal(got, mega.mega_reference(imgs, ks, shifts)[0])
    with pytest.raises(ValueError, match="pack_layer .* pack_weights"):
        mega.cnn_forward_mega(imgs, ks, shifts,
                              packed=[mega.pack_weights(k) for k in ks])


@pytest.mark.parametrize("backend", ["pallas", "hybrid"])
def test_engine_packs_the_layer_kernel_once(monkeypatch, backend):
    """The per-layer backends' engine packs the layer kernel's weights when
    it is built (every layer for pallas, layer 0 for hybrid) and hands
    them to every pass."""
    from tpu_cnn_torch.apps.common import load_model
    from tpu_cnn_torch.engine.cuda import CUDAEngine

    calls = []
    pack = mega.pack_layer
    monkeypatch.setattr(mega, "pack_layer", lambda k: calls.append(k) or pack(k))
    engine = CUDAEngine(load_model(default_artifacts()), device="cpu",
                        backend=backend)
    n = 3 if backend == "pallas" else 1
    assert len(calls) == n
    for k, p in zip(engine.net.kernels[:n], engine._packed):
        assert torch.equal(p, pack(k))
    imgs = np.random.RandomState(47).randint(0, 256, (2, 128, 128)).astype(np.uint8)
    engine.detect_batch(imgs)
    assert len(calls) == n
