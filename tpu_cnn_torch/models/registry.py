"""Named model-variant registry: the port's copy of
``tpu_cnn.models.registry``. Any stack of conv3x3 -> shift-relu -> pool2x2
layers with 16-multiple output channels and power-of-two square inputs;
the registry names the useful points.

``DETECTORS`` names the port's own region-head detectors
(``models.region``), which the JAX package does not have; ``get_config``
finds a name in either."""

from __future__ import annotations

from tpu_cnn_torch.models.cnn import LAYER_CONFIGS, CNNConfig
from tpu_cnn_torch.models.region import (YOLOV7_ANCHORS, DarknetConfig, RegionConfig,
                                         yolov3_rows, yolov7_rows)

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


DETECTORS: dict[str, RegionConfig | DarknetConfig] = {
    # darknet's cfg/yolov2-tiny-voc.cfg: 416x416x3, conv3x3 3-16-...-1024
    # with 2x2 pools (the sixth at stride 1), conv3x3 1024-1024, conv1x1
    # 1024-125, the VOC region head
    "yolov2-tiny-voc": RegionConfig(layer_configs=(
        (3, 16, 416, 3, 2), (16, 32, 208, 3, 2), (32, 64, 104, 3, 2),
        (64, 128, 52, 3, 2), (128, 256, 26, 3, 2), (256, 512, 13, 3, 1),
        (512, 1024, 13, 3, 0), (1024, 1024, 13, 3, 0),
        (1024, 125, 13, 1, 0))),
    # darknet's cfg/yolov3.cfg at 416x416x3: Darknet-53 (75 convs in all,
    # 23 shortcuts, stride-2 downsampling), 4 routes, 2 upsamples and three
    # [yolo] heads over 80 COCO classes
    "yolov3-416": DarknetConfig(layer_configs=yolov3_rows(416, 80)),
    # YOLOv7 (cfg/deploy/yolov7.yaml) at 640x640x3: 92 convs, 8 max-pools,
    # routes of up to 6 maps, 2 upsamples, three heads fine to coarse with
    # the scaled decode; test.py's threshold 0.001, IoU 0.65 and 300
    # detections
    "yolov7-640": DarknetConfig(layer_configs=yolov7_rows(640, 80), anchors=YOLOV7_ANCHORS,
                                thresh=0.001, nms=0.65, max_det=300, decode="scaled"),
}


def get_config(name: str) -> CNNConfig | RegionConfig | DarknetConfig:
    if name in REGISTRY:
        return REGISTRY[name]
    try:
        return DETECTORS[name]
    except KeyError:
        raise KeyError(f"unknown model variant {name!r}; have "
                       f"{sorted(REGISTRY) + sorted(DETECTORS)}")


def default_shifts(config: CNNConfig) -> list[int]:
    """Per-layer shifts growing with accumulated channel depth, matching the
    2/4/6 ladder of the stock network."""
    return [2 * (i + 1) for i in range(len(config.layer_configs))]
