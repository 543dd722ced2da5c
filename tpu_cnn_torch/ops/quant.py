"""The fixed-point contract in plain PyTorch — the megakernel's reference.

Port of ``tpu_cnn.ops.quant``. Per layer (uint8 activations, int8 weights):

    conv  = SAME 3x3 conv, integer accumulate
    wrap  = optional 24-bit two's-complement wraparound (QAT-sim semantics)
    out   = clip(conv >> shift, 0, 255)      # arithmetic shift (floor)
    pool  = 2x2 stride-2 max

Activations are NCHW here (PyTorch's layout); ``cnn_forward`` returns the
JAX package's (B, C, S*S) feature layout.

Two compute paths, bit-identical to each other and to the numpy oracle:

  - ``"float32"``: im2col (``unfold``) and one f32 matmul per layer. Exact
    because every partial sum is an integer below 2^24 (see
    ``tpu_cnn.ops.quant``'s docstring and ``theoretical_accum_bound``), in
    whatever order the sums are taken. Not ``conv2d``: on a CUDA tensor
    cuDNN may pick TF32, Winograd or FFT algorithms, none of them exact.
    A TF32 matmul is not exact either, so on CUDA this path refuses to run
    while ``torch.backends.cuda.matmul.allow_tf32`` is on.
  - ``"int32"``: a loop of elementwise int32 multiply-adds, one per (tap,
    input channel). cuDNN has no integer conv and torch has no integer
    matmul on CUDA, so this path uses neither; it is exact on any device.

Shifts are a tensor argument (the reference's runtime register): changing
them never rebuilds anything. The register is unsigned and 0..31 is its
contract: ``check_shifts`` refuses anything else wherever a shift enters.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

ACCUM_BITS = 24  # the QAT sim's accumulator width
SHIFT_MAX = 31


def check_shifts(shifts) -> None:
    """Raise ``ValueError`` for a shift outside 0..31. ``shifts`` is a host
    sequence or a CPU tensor, one entry per layer. Outside that range the
    paths disagree (the f32 plain version multiplies at a negative shift,
    the int32 one gives 0, the CUDA kernels clamp), and the reference's
    shift register is unsigned, so no answer is right."""
    values = shifts.tolist() if isinstance(shifts, torch.Tensor) else list(shifts)
    for layer, s in enumerate(values):
        if not 0 <= int(s) <= SHIFT_MAX:
            raise ValueError(f"shift {int(s)} of layer {layer} is outside "
                             f"0..{SHIFT_MAX}")


def wrap_accum(x: torch.Tensor, bits: int = ACCUM_BITS) -> torch.Tensor:
    """24-bit two's-complement wraparound: ``((x + M) % (2M)) - M``
    (torch's ``%`` is floor-mod, like numpy's and jnp's)."""
    m = 1 << (bits - 1)
    return ((x + m) % (2 * m)) - m


def shift_relu_clamp(conv: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """clip(conv >> shift, 0, 255) with arithmetic (floor) shift semantics.

    Integer accumulators use ``bitwise_right_shift`` (arithmetic for signed
    types); float accumulators floor-divide by 2^shift, which equals the
    arithmetic shift on negative values too (exact below 2^24)."""
    shift = torch.as_tensor(shift, device=conv.device)
    if conv.dtype.is_floating_point:
        shifted = torch.div(conv, torch.exp2(shift.to(conv.dtype)),
                            rounding_mode="floor")
    else:
        shifted = torch.bitwise_right_shift(conv, shift.to(conv.dtype))
    return shifted.clamp(0, 255)


def maxpool2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool over NCHW, any dtype."""
    b, c, h, w = x.shape
    return x.reshape(b, c, h // 2, 2, w // 2, 2).amax(dim=(3, 5))


def conv3x3_same(x: torch.Tensor, kernel: torch.Tensor,
                 compute_dtype: str = "float32") -> torch.Tensor:
    """SAME 3x3 conv with exact integer accumulation:
    (B, ic, H, W) u8 x (oc, ic, 3, 3) s8 -> (B, oc, H, W) accumulator
    (f32 for ``"float32"``, int32 for ``"int32"``)."""
    b, ic, h, w = x.shape
    oc = kernel.shape[0]
    if compute_dtype == "float32":
        if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("the f32 contract path needs f32 matmuls; "
                               "torch.backends.cuda.matmul.allow_tf32 is on")
        cols = F.unfold(x.to(torch.float32), 3, padding=1)  # (B, ic*9, H*W)
        acc = kernel.to(torch.float32).reshape(oc, ic * 9) @ cols
        return acc.reshape(b, oc, h, w)
    if compute_dtype != "int32":
        raise ValueError(f"compute_dtype {compute_dtype!r}: "
                         f"need 'float32' or 'int32'")
    xp = F.pad(x.to(torch.int32), (1, 1, 1, 1))
    k = kernel.to(torch.int32)[None, :, :, :, :, None, None]
    acc = torch.zeros((b, oc, h, w), dtype=torch.int32, device=x.device)
    # one (B, oc, H, W) multiply-add per (tap, input channel): exact, and
    # its peak memory is one accumulator, whatever the batch
    for dy in range(3):
        for dx in range(3):
            for i in range(ic):
                acc += xp[:, i:i + 1, dy:dy + h, dx:dx + w] * k[:, :, i, dy, dx]
    return acc


def conv_epilogue(conv: torch.Tensor, shift: torch.Tensor, *,
                  accum_wrap: bool) -> torch.Tensor:
    """[wrap24] -> >>shift -> clip -> 2x2 pool -> uint8."""
    if accum_wrap:
        conv = wrap_accum(conv)
    return maxpool2x2(shift_relu_clamp(conv, shift)).to(torch.uint8)


def fixed_point_conv_layer(x: torch.Tensor, kernel: torch.Tensor,
                           shift: torch.Tensor, *, accum_wrap: bool = False,
                           compute_dtype: str = "float32") -> torch.Tensor:
    """One contract layer: (B, ic, H, W) u8 -> (B, oc, H/2, W/2) u8."""
    conv = conv3x3_same(x, kernel, compute_dtype)
    return conv_epilogue(conv, shift, accum_wrap=accum_wrap)


def cnn_forward(images: torch.Tensor, kernels: Sequence[torch.Tensor],
                shifts: torch.Tensor, *, accum_wrap: bool = False,
                compute_dtype: str = "float32") -> torch.Tensor:
    """Full forward: (B, S, S) u8 images, or a (B, C, S, S) NCHW input for
    kernels that start at C channels -> (B, oc, S'*S') u8 features, the
    reference's (channel, flattened-spatial) dump layout."""
    if images.dim() not in (3, 4):
        raise ValueError(f"images must be (B, S, S) or (B, C, S, S), got "
                         f"{tuple(images.shape)}")
    x = images[:, None] if images.dim() == 3 else images
    for i, k in enumerate(kernels):
        x = fixed_point_conv_layer(x, k, shifts[i], accum_wrap=accum_wrap,
                                   compute_dtype=compute_dtype)
    b, c, h, w = x.shape
    return x.reshape(b, c, h * w)


def theoretical_accum_bound(kernels) -> int:
    """Max possible |accumulator| for concrete weights: 255 * sum|w| per
    output channel. Below 2^24 the f32 path is exact and the 24-bit wrap is
    a no-op."""
    bound = 0
    for k in kernels:
        if isinstance(k, torch.Tensor):
            k = k.cpu().numpy()
        per_oc = np.abs(np.asarray(k, dtype=np.int64)).sum(axis=(1, 2, 3))
        bound = max(bound, int(per_oc.max()) * 255)
    return bound
