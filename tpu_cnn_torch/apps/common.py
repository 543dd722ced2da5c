"""Shared CLI plumbing, variant-aware model loading: the port's copy of
``tpu_cnn.apps.common``."""

from __future__ import annotations

from tpu_cnn_torch.models.cnn import DEFAULT_SHIFTS, FpgaCNN
from tpu_cnn_torch.models.region import DarknetConfig, RegionConfig, RegionModel
from tpu_cnn_torch.models.registry import default_shifts, get_config
from tpu_cnn_torch.utils import artifacts as art


def add_variant_arg(parser) -> None:
    parser.add_argument("--variant", default="lyr3-std",
                        help="model geometry from models.registry")


def load_model(
    artifacts_dir: str,
    variant: str = "lyr3-std",
    head_prefix: str = "",
    shifts: list[int] | None = None,
) -> FpgaCNN | RegionModel:
    """Load an ArtifactBundle for ``variant`` and build the model.

    ``shifts=None``: the bundle's persisted shifts (shifts.json) when they
    fit the geometry, else the stock 2/4/6 ladder for lyr3-std and the
    registry's default ladder for other geometries. A region-head
    detector (``registry.DETECTORS``) loads its own bundle
    (``artifacts.load_region_bundle``) at its shifts.json's shifts."""
    config = get_config(variant)
    if isinstance(config, (RegionConfig, DarknetConfig)):
        kernels, biases, saved, names = art.load_region_bundle(
            artifacts_dir, len(config.specs))
        return RegionModel(kernels, biases, saved if shifts is None else shifts,
                           config, names)
    bundle = art.load_bundle(artifacts_dir, prefix=head_prefix,
                             layer_configs=config.layer_configs)
    if shifts is None:
        if (bundle.shifts is not None
                and len(bundle.shifts) == len(config.layer_configs)):
            shifts = list(bundle.shifts)
        else:
            shifts = (list(DEFAULT_SHIFTS) if variant == "lyr3-std"
                      else default_shifts(config))
    return FpgaCNN(bundle.kernels, bundle.fc_weight, bundle.fc_bias,
                   bundle.class_names, shifts=shifts, config=config,
                   bbox_weight=bundle.bbox_weight,
                   multi_thresh=bundle.multi_thresh,
                   multi_head=bundle.multi_head)
