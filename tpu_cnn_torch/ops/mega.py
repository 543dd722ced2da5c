"""The megakernel and the chained plan: wrapper, plan and plain versions.

``cnn_forward_mega`` is the port of ``tpu_cnn.ops.pallas_poly``'s
``cnn_forward_mega``. ``mega_plan`` picks how many head layers run one at a
time (``ops.conv_pool.conv_pool_layer``, the port of the single-layer
Pallas kernels) so that the rest of the net, the tail, fits one CTA of the
megakernel ``csrc/mega_cnn.cu`` (the port of
``cnn_forward_polyphase_pallas``): no head layer for lyr3-std, lyr3-tiny
and lyr2-small, one for lyr4-wide. On a CUDA tensor each stage launches its
hand-written kernel; on a CPU tensor each runs its plain version
(``conv_pool_reference``, ``mega_reference``), built on ``ops.quant``. Any
other device, or a CUDA call a kernel cannot take, raises: nothing falls
back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from tpu_cnn_torch.ops import _build, conv_pool, quant
from tpu_cnn_torch.ops.detect_head import bin_pool

MAX_LAYERS = 4
# the dynamic shared memory of one block: sm_90's opt-in 232,448 bytes less
# 128 for the kernel's two mbarriers
MAX_SMEM_BYTES = 232448 - 128
ALIGN = 128  # every shared-memory buffer's alignment
READ_SLACK = 16  # bytes after the last buffer: the recast reads around a map

# kernel launches made by this wrapper in this process
launches = 0


def _layer_configs(kernels: Sequence[torch.Tensor], size: int):
    """((ic, oc, input size), ...) per layer, as ``CNNConfig`` holds them."""
    cfgs = []
    for k in kernels:
        cfgs.append((int(k.shape[1]), int(k.shape[0]), size))
        size //= 2
    return tuple(cfgs)


def cpad(c: int) -> int:
    """Bytes one pixel of a ``c``-channel map takes in the kernel's shared
    memory: 1 for one channel, else a power of two >= 16."""
    return 1 if c == 1 else max(16, 1 << (c - 1).bit_length())


def pitch1(s: int) -> int:
    """Bytes of a row of an S-wide one-channel map in the kernel's shared
    memory (the image, or a middle layer's output)."""
    return -(-s // 4) * 4


def chunk_n(oc: int) -> int:
    """The megakernel's wgmma N chunk for ``oc`` output channels."""
    return 16 if oc <= 16 else 32 if oc <= 32 else 64


def weight_bytes(ic: int, oc: int) -> int:
    """Bytes of ``pack_weights`` for an (oc, ic, 3, 3) kernel."""
    if ic == 1:
        return 1024 * -(-oc // 16)
    nw = chunk_n(oc)
    return -(-9 * cpad(ic) // 32) * (-(-oc // nw) * nw) * 32


def _align(x: int) -> int:
    return -(-x // ALIGN) * ALIGN


class MegaLayout(NamedTuple):
    """The megakernel's shared memory for a geometry (``smem_plan`` in
    ``csrc/mega_cnn.cu``): region bytes, a one-channel layer 0's image
    buffer, a multi-channel layer 0's rows per band, and each layer's
    weights (bytes, offset, and whether they stay for the CTA's life or
    are copied per image)."""
    region0: int
    region1: int
    input: int
    band_rows: int
    weights: tuple[int, ...]
    w_offsets: tuple[int, ...]
    resident: tuple[bool, ...]
    smem: int


def mega_layout(layer_configs) -> MegaLayout | None:
    """The kernel's plan of shared memory (its ``smem_plan``), None when
    the kernel does not take the geometry; held equal to the library's
    exported plan (``mega_cnn_smem_plan``) on the card by
    ``apps.kernel_cases.smem_plans_vs_kernel``. Layer l's output goes to region
    l % 2: channels-last with a 1-pixel halo, ``(P + 2)^2 * cpad(oc)``
    bytes, a one-channel map ``(P + 2) * pitch1(P)`` (a zero row above
    and below), or NCHW ``oc * P^2`` for the final layer. A one-channel
    layer 0 reads its image from its own buffer after the regions, laid
    out as a one-channel map; a multi-channel one is staged into region 1
    in bands (the
    whole image when it fits one block, else as many rows as region 1
    holds, an even number, at least 2). The weights follow: all of them
    when they fit, else the largest that fit the room left, and each
    other layer's go, per image, into a region's bytes past what its layer
    reads or writes (layer 0's behind the band, its rows cut to make
    room). ``ALIGN`` bytes come before region 0 and ``READ_SLACK`` end
    it: the recast reads 4 bytes around a one-channel map. Each buffer
    starts 128-byte aligned. lyr3-std: 69,696 (66^2 x
    16) + 36,992 (34^2 x 32) + 16,640 (130 x 128) + the weights' 24,576,
    148,112 bytes in all; lyr4-wide's tail: 139,392 + 73,984, bands of
    30 rows, L2's weights resident, L1's and L3's per image."""
    limit = MAX_SMEM_BYTES - READ_SLACK
    n = len(layer_configs)
    if not 1 <= n <= MAX_LAYERS:
        return None
    ic0, size0 = layer_configs[0][0], layer_configs[0][2]
    if size0 <= 0 or size0 % (1 << n) or ic0 <= 0:
        return None
    out, region = [], [0, 0]
    for li, (ic, oc, size) in enumerate(layer_configs):
        if ic <= 0 or oc <= 0 or (li and ic != layer_configs[li - 1][1]):
            return None
        p = size // 2
        out.append(oc * p * p if li == n - 1 else (p + 2) * pitch1(p) if oc == 1
                   else (p + 2) ** 2 * cpad(oc))
        region[li % 2] = max(region[li % 2], out[-1])
    one0 = ic0 == 1
    row = (size0 + 2) * cpad(ic0)
    in_bytes, rows = 0, size0
    if one0:
        in_bytes = (size0 + 2) * pitch1(size0)
    elif _align(region[0]) + max(region[1], (size0 + 2) * row) > limit:
        rows = max(2, min(size0, region[1] // row - 2) & ~1)
    if not one0:
        region[1] = max(region[1], (rows + 2) * row)
    if region[0] + region[1] + in_bytes > limit:
        return None
    off0 = ALIGN  # the slack before region 0
    off1 = off0 + _align(region[0])
    base = off1 + _align(region[1]) + _align(in_bytes)
    if base > limit:
        return None
    wb = [weight_bytes(ic, oc) for ic, oc, _ in layer_configs]
    resident, w_off, end = [False] * n, [0] * n, base
    if base + sum(_align(w) for w in wb) <= limit:
        for li in range(n):
            resident[li], w_off[li] = True, end
            end += _align(wb[li])
    else:
        while True:  # the largest first, while they fit the room left
            fit = [li for li in range(n)
                   if not resident[li] and end + wb[li] <= limit]
            if not fit:
                break
            best = max(fit, key=lambda li: (wb[li], -li))
            resident[best], w_off[best] = True, end
            end += _align(wb[best])
        roff = (off0, off1)
        for li in range(n):
            if resident[li]:
                continue
            if li == 0 and not one0:  # behind the band, in region 1
                r = min(rows, ((region[1] - wb[0] - ALIGN) // row - 2) & ~1)
                if r < 2:
                    return None
                rows = r
                w_off[0] = off1 + _align((rows + 2) * row)
                continue
            o, i = li % 2, (li + 1) % 2
            used_out = _align(out[li])
            used_in = _align(out[li - 1]) if li else 0
            if region[o] - used_out >= wb[li]:
                w_off[li] = roff[o] + used_out
            elif li and region[i] - used_in >= wb[li]:
                w_off[li] = roff[i] + used_in
            else:
                return None
    return MegaLayout(region[0], region[1], in_bytes, rows, tuple(wb),
                      tuple(w_off), tuple(resident), end + READ_SLACK)


def mega_smem_bytes(layer_configs) -> int | None:
    """Dynamic shared memory one CTA needs for a geometry (``mega_layout``'s
    ``smem``), None when the kernel does not take it. lyr3-std: 148,112."""
    layout = mega_layout(layer_configs)
    return None if layout is None else layout.smem


def mega_plan(layer_configs) -> int | None:
    """The chained plan's number of head layers: the smallest ``n_head``
    whose tail ``layer_configs[n_head:]`` runs in one CTA (at most four
    layers, a shared-memory plan within one block). None when no tail of
    at least one layer fits."""
    for n_head in range(len(layer_configs)):
        if mega_layout(layer_configs[n_head:]) is not None:
            return n_head
    return None


def mega_reference(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                   shifts: torch.Tensor, *, compute_dtype: str = "float32"):
    """The megakernel's plain version on (B, S, S) or (B, ic0, S, S) u8:
    (feats u8 (B, oc, P*P), bins f32 (B, oc*16), twin bf16 (B, oc, P*P))
    from ``ops.quant`` and ``detect_head.bin_pool``; bins None when P is
    not divisible by 4 (the kernel refuses them there)."""
    feats = quant.cnn_forward(images, kernels, shifts,
                              compute_dtype=compute_dtype)
    p = images.shape[-1] >> len(kernels)
    return (feats, bin_pool(feats) if p % 4 == 0 else None,
            feats.to(torch.bfloat16))


def pack_fragments(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, ic, 3, 3) int8 -> the layer kernel's B fragments for a
    multi-channel layer (``csrc/conv_layer.cuh``, mma.sync.m16n8k32),
    (KS, NT, 32, 8) int8 on the same device. The GEMM's B is (K, N): K = 9
    taps x cpad(ic) channels, tap-major (k = tap * cpad + c), padded to KS
    steps of 32; N = oc padded to NT tiles of 8; padding holds zero
    weights. Row (s, t) holds what lane l of mma.m16n8k32 takes for K step
    s and N tile t: bytes 0-3 B[32 s + 4 (l % 4) + j][8 t + l // 4], bytes
    4-7 the same 16 rows further down."""
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    cp = cpad(ic)
    kp, npad = -(-9 * cp // 32) * 32, -(-oc // 8) * 8
    b = _gemm_b(kernel, kp, npad)
    ks, nt = kp // 32, npad // 8
    # (s, half, t4, j, t, g) -> (s, t, lane = 4 g + t4, byte = 4 half + j)
    return (b.view(ks, 2, 4, 4, nt, 8).permute(0, 4, 5, 2, 1, 3)
            .contiguous().view(ks, nt, 32, 8))


def fragments_shape(kernel: torch.Tensor) -> tuple[int, int, int, int]:
    """The shape ``pack_fragments(kernel)`` gives: (KS, NT, 32, 8)."""
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    return -(-9 * cpad(ic) // 32), -(-oc // 8), 32, 8


def _gemm_b(kernel: torch.Tensor, kp: int, npad: int) -> torch.Tensor:
    """The (kp, npad) int8 GEMM operand B of a multi-channel layer: K = 9
    taps x cpad(ic), tap-major, N the output channels; zero past them."""
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    cp = cpad(ic)
    b = torch.zeros((kp, npad), dtype=torch.int8, device=kernel.device)
    b[:9 * cp].view(9, cp, npad)[:, :ic, :oc] = (
        kernel.permute(2, 3, 1, 0).reshape(9, ic, oc))
    return b


def pack_weights(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, ic, 3, 3) int8 -> the megakernel's weights for one layer, the
    bytes it copies into shared memory, 1-D int8 on the same device
    (``weight_bytes(ic, oc)`` of them).

    One input channel: ``pack_one_channel``'s (G, 8, 32, 4) bytes in that
    order, the recast's B registers. Otherwise the B of wgmma (K-major
    core matrices of 8 N rows x 16 K bytes; ``csrc/hopper.cuh``): B is
    (K, N), K = 9 taps x cpad(ic) channels, tap-major, padded to KS steps
    of 32; N = oc padded to a multiple of ``chunk_n(oc)``; zero past the
    weights. Byte ((s * NG + n8) * 2 + h) * 128 + 16 r + j holds
    B[32 s + 16 h + j][8 n8 + r], NG = the padded N / 8."""
    oc, ic = int(kernel.shape[0]), int(kernel.shape[1])
    if ic == 1:
        return pack_one_channel(kernel).reshape(-1)
    nw = chunk_n(oc)
    kp, npad = -(-9 * cpad(ic) // 32) * 32, -(-oc // nw) * nw
    b = _gemm_b(kernel, kp, npad)
    # (s, h, j, n8, r) -> (s, n8, h, r, j)
    return (b.view(kp // 32, 2, 16, npad // 8, 8).permute(0, 3, 1, 4, 2)
            .contiguous().view(-1))


def packed_shape(kernel: torch.Tensor) -> tuple[int]:
    """The shape ``pack_weights(kernel)`` gives: (bytes,)."""
    return (weight_bytes(int(kernel.shape[1]), int(kernel.shape[0])),)


def one_channel_matrix(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, 1, 3, 3) int8 -> the one-channel recast's GEMM operand B,
    (16, 4, G*16) int8 over (K, position, channel): K = 4 r + s indexes the
    4x4 input patch under a 2x2 output quad, position p = 2 py + px the
    quad's output, and B[4 r + s, p, o] = kernel[o, 0, r - py, s - px]
    where that tap exists, else 0. Channels are padded to G = ceil(oc/16)
    groups of 16 with zero weights."""
    oc = int(kernel.shape[0])
    groups = -(-oc // 16)
    w = torch.zeros((3, 3, groups * 16), dtype=torch.int8, device=kernel.device)
    w[:, :, :oc] = kernel[:, 0].permute(1, 2, 0)
    b = torch.zeros((4, 4, 4, groups * 16), dtype=torch.int8, device=kernel.device)
    for p in range(4):
        py, px = divmod(p, 2)
        b[py:py + 3, px:px + 3, p] = w
    return b.view(16, 4, groups * 16)


def pack_one_channel(kernel: torch.Tensor) -> torch.Tensor:
    """(oc, 1, 3, 3) int8 -> the layer kernel's one-channel B fragments,
    (G, 8, 32, 4) int8 on the same device: for channel group q (16
    channels) and N tile t = 2 p + h (channels 16 q + 8 h .. + 7 at quad
    position p), row (q, t) holds what lane l of mma.m16n8k16 takes: bytes
    j = 0-3 B[4 (l % 4) + j, p, 16 q + 8 h + l // 4] of
    ``one_channel_matrix``."""
    b = one_channel_matrix(kernel)
    groups = b.shape[2] // 16
    # (t4, j, p, q, h, g) -> (q, t = 2 p + h, lane = 4 g + t4, byte = j)
    return (b.view(4, 4, 4, groups, 2, 8).permute(3, 2, 4, 5, 0, 1)
            .contiguous().view(groups, 8, 32, 4))


def layer_packed_shape(kernel: torch.Tensor) -> tuple[int, ...]:
    """The shape ``pack_layer(kernel)`` gives."""
    if int(kernel.shape[1]) == 1:
        return -(-int(kernel.shape[0]) // 16), 8, 32, 4
    return fragments_shape(kernel)


def pack_layer(kernel: torch.Tensor) -> torch.Tensor:
    """The layer kernel's weights (``csrc/conv_layer.cuh``, under
    ``conv_act``, ``fused_conv_layer`` and ``conv_pool_layer``):
    ``pack_one_channel`` for one input channel, else ``pack_fragments``."""
    if int(kernel.shape[1]) == 1:
        return pack_one_channel(kernel)
    return pack_fragments(kernel)


def check_layer_packed(packed: torch.Tensor | None, kernel: torch.Tensor) -> None:
    """Raise unless ``packed`` is None or has the dtype and shape of
    ``pack_layer(kernel)`` on the kernel's device."""
    if packed is not None and (
            packed.dtype != torch.int8 or packed.device != kernel.device
            or tuple(packed.shape) != layer_packed_shape(kernel)):
        raise ValueError(
            f"packed must be pack_layer of the kernel, "
            f"{layer_packed_shape(kernel)} int8 on {kernel.device}; got "
            f"{tuple(packed.shape)} {packed.dtype} on {packed.device}")


def pack_plan(kernels: Sequence[torch.Tensor], size: int) -> list[torch.Tensor]:
    """Each kernel's packing for ``cnn_forward_mega`` at input side
    ``size``: ``pack_layer`` for the plan's head layers (the layer kernel),
    ``pack_weights`` for the tail (the megakernel: ``pack_one_channel``'s
    bytes for a one-channel layer, the wgmma B for the others)."""
    n_head = mega_plan(_layer_configs(kernels, size))
    if n_head is None:
        n_head = 0  # cnn_forward_mega refuses the geometry
    return ([pack_layer(k) for k in kernels[:n_head]]
            + [pack_weights(k) for k in kernels[n_head:]])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("mega_cnn")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mega_cnn_forward.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p, p, i, p]
    lib.mega_cnn_forward.restype = i
    lib.mega_cnn_error_string.argtypes = [i]
    lib.mega_cnn_error_string.restype = ctypes.c_char_p
    return lib


def _check_inputs(images, kernels, shifts, with_bins):
    if images.dtype != torch.uint8 or images.dim() not in (3, 4):
        raise ValueError(f"images must be (B, S, S) or (B, ic0, S, S) uint8, "
                         f"got {tuple(images.shape)} {images.dtype}")
    s, s2 = images.shape[-2:]
    n = len(kernels)
    if s != s2 or n < 1 or s % (1 << n):
        raise ValueError(f"need square images with side divisible by 2^L "
                         f"and L >= 1; got {s}x{s2}, L={n}")
    ic = 1 if images.dim() == 3 else images.shape[1]
    for k in kernels:
        if (k.dtype != torch.int8 or k.dim() != 4 or k.shape[1] != ic
                or tuple(k.shape[2:]) != (3, 3)):
            raise ValueError(f"kernels must chain (oc, ic, 3, 3) int8 from "
                             f"the input's channels; at ic={ic} got "
                             f"{tuple(k.shape)} {k.dtype}")
        ic = k.shape[0]
    if shifts.dtype != torch.int32 or tuple(shifts.shape) != (n,):
        raise ValueError(f"shifts must be ({n},) int32, got "
                         f"{tuple(shifts.shape)} {shifts.dtype}")
    if with_bins and (s >> n) % 4:
        raise ValueError(f"bins need a final map divisible by 4, got {s >> n}")


def _check_packed(packed, kernels, n_head):
    n = len(kernels)
    want = ([layer_packed_shape(k) for k in kernels[:n_head]]
            + [packed_shape(k) for k in kernels[n_head:]])
    if packed is not None and (
            len(packed) != n
            or any(p.dtype != torch.int8 or tuple(p.shape) != w
                   for p, w in zip(packed, want))):
        raise ValueError(f"packed must hold pack_plan of the {n} kernels "
                         f"(pack_layer of the {n_head} head layers, "
                         f"pack_weights of the tail): shapes {want}, got "
                         f"{[(tuple(p.shape), p.dtype) for p in packed]}")


def _launch(images, kernels, shifts, packed, with_feats, with_bins,
            with_twin):
    """The megakernel on the tensors' CUDA device and current stream: a
    whole net or a tail that fits one CTA. ``packed``: the kernels'
    ``pack_weights``, or None to pack them here."""
    global launches
    dev = images.device
    if packed is None:
        packed = [pack_weights(k) for k in kernels]
    tensors = [images, shifts, *packed]
    if any(t.device != dev for t in tensors):
        raise ValueError("images, kernels and shifts must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("images, kernels and shifts must be contiguous")
    if any(p.data_ptr() % 16 for p in packed):
        raise ValueError("packed weights must start 16-byte aligned: the "
                         "kernel's bulk copies read them")
    b, s = images.shape[0], images.shape[-1]
    oc, p = kernels[-1].shape[0], s >> len(kernels)
    feats = (torch.empty((b, oc, p * p), dtype=torch.uint8, device=dev)
             if with_feats else None)
    bins = (torch.empty((b, oc * 16), dtype=torch.float32, device=dev)
            if with_bins else None)
    twin = (torch.empty((b, oc, p * p), dtype=torch.bfloat16, device=dev)
            if with_twin else None)
    n = len(kernels)
    ws = [p.data_ptr() for p in packed] + [None] * (MAX_LAYERS - n)
    ic = (ctypes.c_int * n)(*[int(k.shape[1]) for k in kernels])
    ocs = (ctypes.c_int * n)(*[int(k.shape[0]) for k in kernels])
    lib = _lib()
    err = lib.mega_cnn_forward(
        images.data_ptr(), *ws, shifts.data_ptr(),
        feats.data_ptr() if feats is not None else None,
        bins.data_ptr() if bins is not None else None,
        twin.data_ptr() if twin is not None else None,
        b, n, s, ctypes.addressof(ic), ctypes.addressof(ocs),
        dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"mega_cnn_forward failed: cudaError {err} "
                           f"({lib.mega_cnn_error_string(err).decode()})")
    launches += 1
    return feats, bins, twin


def cnn_forward_mega(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                     shifts: torch.Tensor, *, with_feats: bool = True,
                     with_bins: bool = False, with_twin: bool = False,
                     packed: Sequence[torch.Tensor] | None = None):
    """The net on the chained plan: (B, S, S) u8 images (or (B, ic0, S, S)
    NCHW when the first kernel takes ic0 channels), per-layer
    (oc, ic, 3, 3) int8 kernels and (L,) int32 shifts (on the device, read
    by the kernels: a shift change rebuilds nothing) -> the requested
    outputs in (feats, bins, twin) order, a bare tensor when only one is
    requested:

      feats (B, oc_L, P*P) u8, bins (B, oc_L*16) f32 4x4 bin means / 255,
      twin (B, oc_L, P*P) bf16 copy of the features.

    The ``mega_plan`` head layers run through ``conv_pool.conv_pool_layer``
    and the tail through the megakernel: on CUDA tensors
    ``csrc/conv_pool_layer.cu`` then ``csrc/mega_cnn.cu``, on CPU tensors
    ``conv_pool_reference`` then ``mega_reference``. A CPU shift vector is
    held to 0..31 here; a CUDA one where it was built on the host.

    ``packed``: ``pack_plan`` of the kernels, made once by the weights'
    owner (``CUDAEngine`` does); when None, each kernel's layers are
    packed on every CUDA call."""
    if not (with_feats or with_bins or with_twin):
        raise ValueError("at least one of with_feats/with_bins/with_twin "
                         "must be requested")
    _check_inputs(images, kernels, shifts, with_bins)
    if shifts.device.type == "cpu":
        quant.check_shifts(shifts)
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"cnn_forward_mega runs on CUDA tensors (the "
                         f"kernels) or CPU tensors (their plain versions), "
                         f"not on {images.device}")
    cfgs = _layer_configs(kernels, images.shape[-1])
    n_head = mega_plan(cfgs)
    if n_head is None:
        raise ValueError(
            f"no tail of {cfgs} fits one CTA ({MAX_SMEM_BYTES:,} B of shared "
            f"memory, at most {MAX_LAYERS} layers)")
    _check_packed(packed, kernels, n_head)
    x = images if images.dim() == 4 else images[:, None]
    for i in range(n_head):
        x = conv_pool.conv_pool_layer(
            x, kernels[i], shifts, i,
            packed=None if packed is None else packed[i])
    tail, tail_shifts = kernels[n_head:], shifts[n_head:]
    if x.device.type == "cpu":
        outs = mega_reference(x, tail, tail_shifts)
    else:
        outs = _launch(x, tail, tail_shifts,
                       None if packed is None else packed[n_head:],
                       with_feats, with_bins, with_twin)
    ret = [o for o, want in zip(outs, (with_feats, with_bins, with_twin))
           if want]
    return tuple(ret) if len(ret) > 1 else ret[0]
