"""The card's peaks and the least time a piece of work can take on it.

One copy of the NVIDIA H100 SXM data sheet's dense peaks at 700 W, read by
``apps.benchmark`` (its per-layer MFU and ``--roofline``) and by the
repository's ``chip_smoke.py`` (every kernel's ``bound_ms``): int8 tensor
cores 1,979 T op/s (a multiply-add is two), HBM3 3.35 TB/s; and for the
float trainer (the benchmark's ``--train`` MFU) FP32 outside the tensor
cores 67 TFLOP/s and BF16 tensor cores 989 TFLOP/s. A card set below
700 W runs slower than these under load; the measurements print its
power limit beside their numbers.
"""

from __future__ import annotations

from tpu_cnn_torch.models.cnn import LAYER_CONFIGS

PEAK_INT8_MACS = 1979e12 / 2
PEAK_HBM_BYTES = 3.35e12
PEAK_F32_MACS = 67e12 / 2
PEAK_BF16_MACS = 989e12 / 2


def macs_per_image(layer_configs=LAYER_CONFIGS) -> int:
    """int8 multiply-adds of one image through the contract layers."""
    return sum(size * size * oc * ic * 9 for ic, oc, size in layer_configs)


def bound(macs: float, nbytes: float) -> tuple[float, str]:
    """The least ms the card could take for ``macs`` int8 multiply-adds on
    inputs and outputs of ``nbytes`` (each read or written once), and the
    limit that sets it: "operations" or "bytes"."""
    ops_ms = macs / PEAK_INT8_MACS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def layers_bound(layer_configs, batch: int, out_bytes: int,
                 calls: str = "net") -> tuple[float, str]:
    """``bound`` of a stack of contract layers at ``batch``. ``calls``:
    "net", one call for the stack (the megakernel, the layer kernel): the
    first layer's u8 input, the weights and ``out_bytes`` per image of
    output; "unpooled" or "pooled", each layer its own call of the conv
    kernel (its input read, its output written: ``oc * s^2`` unpooled,
    ``oc * (s/2)^2`` pooled), and the bounds add up."""
    weights = sum(oc * ic * 9 for ic, oc, _ in layer_configs)
    if calls == "net":
        ic, _, s = layer_configs[0]
        return bound(macs_per_image(layer_configs) * batch,
                     ic * s * s * batch + weights + out_bytes * batch)
    div = 4 if calls == "pooled" else 1
    parts = [bound(oc * ic * 9 * s * s * batch,
                   (ic * s * s + oc * s * s // div) * batch + oc * ic * 9)
             for ic, oc, s in layer_configs]
    kinds = {k for _, k in parts}
    return sum(t for t, _ in parts), kinds.pop() if len(kinds) == 1 else "mixed"


def detect_out_bytes(layer_configs) -> int:
    """Per image, the megakernel's detect outputs: the bf16 twin and the
    f32 bins of the final map."""
    _, oc, s = layer_configs[-1]
    return oc * (s // 2) ** 2 * 2 + oc * 16 * 4
