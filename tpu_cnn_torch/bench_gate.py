"""The bench's parity gate without JAX (``bench.py:38-91``).

Before a throughput number means anything, the exact measured path runs on
shipped test images plus noise and is held against the host numpy oracle
and head twins: u8 features bit-equal to ``numpy_cnn_forward``; fused bins
within 1e-5 of ``bin_pool_np``; predictions equal to ``classify_np``;
probabilities within 1e-4; boxes equal to ``cam_bbox_fast``. The oracle
runs at the model's own shifts and image size (the defaults are lyr3-std's
stock 2/4/6 and 128).
"""

from __future__ import annotations

import glob
import os
from typing import Callable, Sequence

import numpy as np

from tpu_cnn.engine.cpu_ref import numpy_cnn_forward
from tpu_cnn.head.cam import cam_bbox_fast
from tpu_cnn.head.classify import bin_pool_np, classify_np
from tpu_cnn.models.cnn import DEFAULT_SHIFTS, IMG_SIZE


def load_gate_images(art_dir: str, n_real: int = 28, n_noise: int = 4,
                     img_size: int = IMG_SIZE) -> np.ndarray:
    """The first ``n_real`` shipped test images (sorted by name) plus
    ``n_noise`` uniform-noise images from seed 0, as (N, S, S) u8."""
    rs = np.random.RandomState(0)
    paths = sorted(glob.glob(os.path.join(art_dir, "test_image_*.bin")))
    imgs = [np.fromfile(p, dtype=np.uint8, count=img_size * img_size)
            .reshape(img_size, img_size) for p in paths[:n_real]]
    imgs += [rs.randint(0, 256, (img_size, img_size)).astype(np.uint8)
             for _ in range(n_noise)]
    return np.stack(imgs)


def run_parity_gate(production_path: Callable, bundle, gate: np.ndarray,
                    shifts: Sequence[int] = DEFAULT_SHIFTS,
                    img_size: int = IMG_SIZE) -> str | None:
    """Run ``production_path`` (images -> (feats, pooled, pred, conf, probs,
    bbox), numpy or tensors) on the gate batch and compare every output with
    the host oracle at the model's ``shifts`` and ``img_size``. Returns an
    error string on a mismatch, None when bit-accurate."""
    gfeats, gpooled, gpred, gconf, gprobs, gbbox = (
        a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
        for a in production_path(gate))

    kernels = [np.asarray(k) for k in bundle.kernels]
    want_feats = np.stack([numpy_cnn_forward(im, kernels, shifts) for im in gate])
    if not np.array_equal(gfeats, want_feats):
        return "bit-parity failure: device features vs numpy oracle"
    # Bin sums are exact integers; the /16/255 scaling may differ from the
    # host twin by 1 ulp (~6e-8). A real corruption moves a bin by at least
    # 1/4080 ~ 2.4e-4, so 1e-5 separates the two by >10x either way.
    if not np.allclose(gpooled, bin_pool_np(want_feats), atol=1e-5):
        return "parity failure: fused bin pooling vs host bin_pool"
    widx, _wconf, wprobs = classify_np(want_feats, bundle.fc_weight,
                                       bundle.fc_bias)
    if not np.array_equal(gpred, widx.astype(gpred.dtype)):
        return "parity failure: device predictions vs host classifier"
    if not np.allclose(gprobs, wprobs, atol=1e-4):
        return "parity failure: device probabilities vs host classifier"
    want_bbox = np.stack([
        cam_bbox_fast(want_feats[i], int(widx[i]), bundle.fc_weight,
                      img_size=img_size)
        for i in range(len(gate))
    ])
    if not np.array_equal(gbbox, want_bbox.astype(gbbox.dtype)):
        return "parity failure: device CAM bbox vs host CAM twin"
    return None
