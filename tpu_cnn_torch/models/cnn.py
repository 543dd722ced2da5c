"""Model topology, configuration and parameters of the FPGA-contract CNN.

The port's copy of ``tpu_cnn.models.cnn`` (the constants, ``CNNConfig`` and
the numpy ``FpgaCNN`` holder), plus ``TorchFpgaCNN``, which carries those
parameters across to torch. The network:

    input: 128x128x1 uint8 grayscale
    L0: conv3x3 (1 -> 16),  ReLU >> s0, maxpool2x2  -> 16x64x64
    L1: conv3x3 (16 -> 32), ReLU >> s1, maxpool2x2  -> 32x32x32
    L2: conv3x3 (32 -> 64), ReLU >> s2, maxpool2x2  -> 64x16x16
    head: 4x4 spatial-bin pooling -> 1024-d -> Linear -> softmax
          (or global-avg-pool -> 64-d -> Linear for the GAP head)
    CAM (class-weighted feature maps) -> threshold -> bounding box

``TorchFpgaCNN`` holds the per-layer int8 conv kernels (oc, ic, 3, 3), the
(L,) int32 shift register, the f32 head (``fc_weight`` (K, D),
``fc_bias`` (K,)), the optional (D+1, 4) box regression head and the
optional multi-label presence head (``mw`` (K, D), ``mb`` (K,), the
bundle's ``multi_head.npz``), all as buffers on one explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from tpu_cnn_torch.ops.quant import ACCUM_BITS  # noqa: F401  (the contract's)

# (in_channels, out_channels, input_size) per layer
LAYER_CONFIGS: tuple[tuple[int, int, int], ...] = (
    (1, 16, 128),
    (16, 32, 64),
    (32, 64, 32),
)

# default per-layer ReLU right-shifts (a runtime register: no rebuild when
# they change)
DEFAULT_SHIFTS: tuple[int, int, int] = (2, 4, 6)

IMG_SIZE = 128
NUM_CLASSES = 6
QUANT_MAX = 127  # symmetric int8 range

# shipped class set (the bundle's classes.json)
CLASS_NAMES = ["airplane", "cat", "zebra", "bus", "bicycle", "donut"]

WEIGHT_BYTES = 23184  # weights.bin of the stock net


def layer_weight_sizes() -> list[int]:
    """Per-layer byte counts inside weights.bin: 144 / 4608 / 18432."""
    return [oc * ic * 9 for ic, oc, _ in LAYER_CONFIGS]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    """Static configuration for one FpgaCNN instance; ``layer_configs`` may
    shrink the geometry for fast tests."""

    layer_configs: tuple[tuple[int, int, int], ...] = LAYER_CONFIGS
    num_classes: int = NUM_CLASSES
    accum_bits: int = ACCUM_BITS
    accum_wrap: bool = False  # True matches the QAT sim's 24-bit wraparound

    @property
    def img_size(self) -> int:
        return self.layer_configs[0][2]

    @property
    def out_channels(self) -> int:
        return self.layer_configs[-1][1]

    @property
    def out_spatial(self) -> int:
        return self.layer_configs[-1][2] // 2

    @property
    def feature_dim_bins(self) -> int:
        """Spatial-bin-pooled feature dimension (4x4 grid)."""
        return self.out_channels * 16

    def weight_bytes(self) -> int:
        return sum(oc * ic * 9 for ic, oc, _ in self.layer_configs)


class FpgaCNN:
    """The model's host-side numpy parameters: (oc, ic, 3, 3) int8 kernels
    (the decoded weights.bin layout), the f32 head, the shifts and the
    optional box, threshold and presence heads."""

    def __init__(
        self,
        kernels: Sequence[np.ndarray],
        fc_weight: np.ndarray,
        fc_bias: np.ndarray,
        class_names: Sequence[str] | None = None,
        shifts: Sequence[int] = DEFAULT_SHIFTS,
        config: CNNConfig = CNNConfig(),
        bbox_weight: np.ndarray | None = None,  # (D+1, 4) regression head
        multi_thresh=None,  # per-class multi-object thresholds (K,) or None
        multi_head=None,  # (w (K, D), b (K,)) multi-label presence head
    ):
        self.config = config
        expected = [(oc, ic, 3, 3) for ic, oc, _ in config.layer_configs]
        got = [tuple(k.shape) for k in kernels]
        if got != expected:
            raise ValueError(f"kernel shapes {got} != expected {expected}")
        self.kernels = [np.asarray(k, dtype=np.int8) for k in kernels]
        self.fc_weight = np.asarray(fc_weight, dtype=np.float32)
        self.fc_bias = np.asarray(fc_bias, dtype=np.float32)
        self.class_names = (
            list(class_names) if class_names is not None else list(CLASS_NAMES)
        )
        self.shifts = np.asarray(list(shifts), dtype=np.int32)
        if self.shifts.shape != (len(config.layer_configs),):
            raise ValueError("one shift per layer required")
        self.bbox_weight = (
            np.asarray(bbox_weight, np.float32) if bbox_weight is not None
            else None
        )
        if self.bbox_weight is not None and self.bbox_weight.shape != (
            config.feature_dim_bins + 1, 4
        ):
            raise ValueError(
                f"bbox_weight shape {self.bbox_weight.shape} != "
                f"({config.feature_dim_bins + 1}, 4)"
            )
        self.multi_thresh = (
            np.asarray(list(multi_thresh), np.float32)
            if multi_thresh is not None else None
        )
        if (self.multi_thresh is not None
                and self.multi_thresh.shape != (len(self.class_names),)):
            raise ValueError("one multi threshold per class required")
        # the presence head replaces softmax probs as the --multi score; the
        # floors in multi_thresh then live in its sigmoid-score space
        self.multi_head = None
        if multi_head is not None:
            mw = np.asarray(multi_head[0], np.float32)
            mb = np.asarray(multi_head[1], np.float32)
            if mw.shape != self.fc_weight.shape or mb.shape != (
                    len(self.class_names),):
                raise ValueError(
                    f"multi_head shapes {mw.shape}/{mb.shape} must match "
                    f"the fc head {self.fc_weight.shape}")
            self.multi_head = (mw, mb)

    @property
    def head_mode(self) -> str:
        """'bins' for the (C, C*16) spatial-bin head, 'gap' for (C, C),
        inferred from the fc weight's shape."""
        d = self.fc_weight.shape[1]
        if d == self.config.feature_dim_bins:
            return "bins"
        if d == self.config.out_channels:
            return "gap"
        raise ValueError(f"unrecognised fc feature dim {d}")


def params_from_numpy(
    kernels: Sequence[np.ndarray],
    fc_weight: np.ndarray,
    fc_bias: np.ndarray,
    shifts: Sequence[int],
    bbox_weight: np.ndarray | None = None,
    multi_head: tuple[np.ndarray, np.ndarray] | None = None,
    *,
    device: torch.device | str,
) -> dict[str, torch.Tensor | list[torch.Tensor] | None]:
    """numpy parameters (as ``FpgaCNN`` and ``load_bundle`` hold them) ->
    contiguous torch tensors on ``device``: ``kernels`` int8,
    ``shifts`` int32, ``fc_weight``/``fc_bias``/``bbox_weight`` and the
    multi head's ``mw``/``mb`` f32 (None where absent)."""
    dev = torch.device(device)

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    return {
        "kernels": [put(k, np.int8) for k in kernels],
        "shifts": put(np.asarray(list(shifts)), np.int32),
        "fc_weight": put(fc_weight, np.float32),
        "fc_bias": put(fc_bias, np.float32),
        "bbox_weight": (put(bbox_weight, np.float32)
                        if bbox_weight is not None else None),
        "mw": put(multi_head[0], np.float32) if multi_head is not None else None,
        "mb": put(multi_head[1], np.float32) if multi_head is not None else None,
    }


class TorchFpgaCNN(nn.Module):
    """The FpgaCNN parameters on one device. Compute lives in ``ops`` and
    ``engine``; this module only owns the tensors and the config."""

    def __init__(self, config: CNNConfig, params: dict):
        super().__init__()
        self.config = config
        expected = [(oc, ic, 3, 3) for ic, oc, _ in config.layer_configs]
        got = [tuple(k.shape) for k in params["kernels"]]
        if got != expected:
            raise ValueError(f"kernel shapes {got} != expected {expected}")
        if params["shifts"].shape != (len(expected),):
            raise ValueError("one shift per layer required")
        for i, k in enumerate(params["kernels"]):
            self.register_buffer(f"kernel{i}", k)
        self.register_buffer("shifts", params["shifts"])
        self.register_buffer("fc_weight", params["fc_weight"])
        self.register_buffer("fc_bias", params["fc_bias"])
        self.register_buffer("bbox_weight", params["bbox_weight"])
        self.register_buffer("mw", params.get("mw"))
        self.register_buffer("mb", params.get("mb"))

    @property
    def kernels(self) -> list[torch.Tensor]:
        return [getattr(self, f"kernel{i}")
                for i in range(len(self.config.layer_configs))]

    @property
    def multi_head(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """(mw, mb) of the presence head, or None."""
        return (self.mw, self.mb) if self.mw is not None else None

    @classmethod
    def from_fpga_cnn(cls, model, device: torch.device | str) -> "TorchFpgaCNN":
        """From any holder of the FpgaCNN arrays (``kernels``, ``shifts``,
        ``fc_weight``, ``fc_bias``, ``bbox_weight``, ``multi_head`` and
        ``config.layer_configs``): this module's ``FpgaCNN``, or the JAX
        package's, which the tests hand over."""
        config = model.config
        if not isinstance(config, CNNConfig):
            config = CNNConfig(layer_configs=tuple(config.layer_configs),
                               num_classes=config.num_classes,
                               accum_bits=config.accum_bits,
                               accum_wrap=config.accum_wrap)
        return cls(config, params_from_numpy(
            model.kernels, model.fc_weight, model.fc_bias, model.shifts,
            model.bbox_weight, model.multi_head, device=device))
