"""``TorchFpgaCNN``: the FpgaCNN parameters as an ``nn.Module`` on a device.

The topology, configuration and artifact loading stay in
``tpu_cnn.models.cnn`` (``CNNConfig``, ``FpgaCNN``), which is numpy-only.
This module carries those parameters across to torch: the per-layer int8
conv kernels (oc, ic, 3, 3), the (L,) int32 shift register, the f32 head
(``fc_weight`` (K, D), ``fc_bias`` (K,)), the optional (D+1, 4) box
regression head and the optional multi-label presence head (``mw`` (K, D),
``mb`` (K,), the bundle's ``multi_head.npz``), all as buffers on one
explicit device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from tpu_cnn.models.cnn import CNNConfig, FpgaCNN


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
    def from_fpga_cnn(cls, model: FpgaCNN,
                      device: torch.device | str) -> "TorchFpgaCNN":
        return cls(model.config, params_from_numpy(
            model.kernels, model.fc_weight, model.fc_bias, model.shifts,
            model.bbox_weight, model.multi_head, device=device))
