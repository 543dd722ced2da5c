"""Named model-variant registry: the port's copy of
``tpu_cnn.models.registry``. Any stack of conv3x3 -> shift-relu -> pool2x2
layers with 16-multiple output channels and power-of-two square inputs;
the registry names the useful points."""

from __future__ import annotations

from tpu_cnn_torch.models.cnn import LAYER_CONFIGS, CNNConfig

REGISTRY: dict[str, CNNConfig] = {
    # the reference hardware network (flagship)
    "lyr3-std": CNNConfig(layer_configs=LAYER_CONFIGS),
    # reduced geometry for tests/edge: 32x32 input, same channel ladder
    "lyr3-tiny": CNNConfig(layer_configs=((1, 16, 32), (16, 32, 16), (32, 64, 8))),
    # shallow 2-layer variant
    "lyr2-small": CNNConfig(layer_configs=((1, 16, 64), (16, 32, 32))),
    # deeper/wider 4-layer variant for 256x256 inputs
    "lyr4-wide": CNNConfig(
        layer_configs=((1, 16, 256), (16, 32, 128), (32, 64, 64), (64, 128, 32))
    ),
}


def get_config(name: str) -> CNNConfig:
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown model variant {name!r}; have {sorted(REGISTRY)}")


def default_shifts(config: CNNConfig) -> list[int]:
    """Per-layer shifts growing with accumulated channel depth, matching the
    2/4/6 ladder of the stock network."""
    return [2 * (i + 1) for i in range(len(config.layer_configs))]
