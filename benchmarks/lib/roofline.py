"""The card's peaks and the least time a piece of work can take on it.

A frozen copy of the program's ``tpu_cnn_torch/utils/roofline.py``
(``macs_per_image``, ``bound``, ``layers_bound`` and the peaks), so that a
change to the program cannot move the yardstick. The peaks are the NVIDIA
H100 SXM data sheet's dense rates at 700 W: int8 tensor cores 1,979 T op/s
(a multiply-add is two operations) and HBM3 3.35 TB/s.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1979e12
PEAK_INT8_MACS = PEAK_INT8_OPS / 2
PEAK_HBM_BYTES = 3.35e12


def macs_per_image(layer_configs) -> int:
    """int8 multiply-adds of one image through the conv layers, each
    ``(in_channels, out_channels, input_size)``, 3x3 with zero padding."""
    return sum(size * size * oc * ic * 9 for ic, oc, size in layer_configs)


def bound(macs: float, nbytes: float) -> tuple[float, str]:
    """The least ms the card could take for ``macs`` int8 multiply-adds on
    inputs and outputs of ``nbytes`` (each read or written once), and the
    limit that sets it: "operations" or "bytes"."""
    ops_ms = macs / PEAK_INT8_MACS * 1e3
    bytes_ms = nbytes / PEAK_HBM_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def layers_bound(layer_configs, batch: int, out_bytes: int) -> tuple[float, str]:
    """``bound`` of the whole conv stack at ``batch`` as one piece of work,
    whatever kernels implement it: the first layer's u8 input, the weights
    and ``out_bytes`` per image of output."""
    weights = sum(oc * ic * 9 for ic, oc, _ in layer_configs)
    ic, _, s = layer_configs[0]
    return bound(macs_per_image(layer_configs) * batch,
                 ic * s * s * batch + weights + out_bytes * batch)


def feature_map_bytes(layer_configs) -> int:
    """Per image, the net's u8 output feature map (the contract's output:
    ``out_channels`` x (size/2)^2 bytes)."""
    _, oc, s = layer_configs[-1]
    return oc * (s // 2) ** 2
