"""The one traffic generator: frames from a seed.

Every mix is a data file under ``traffic/`` that this module reads; a cell
file may set its own values over the mix's. What it draws:

- ``frames``: uniform-noise u8 frames, (n, size, size), or (n, channels,
  size, size) where a configuration's frames have more than one channel
  (``spec.frame_shape``), from the seed and the name of the stream they
  are for (so that the pools and the camera's
  pool of one seed are independent draws). A seed may be
  any whole number: it enters a ``numpy.random.SeedSequence`` whole;
  ``with_shipped`` puts a seeded choice of the bundle's shipped test
  frames among them.
"""

from __future__ import annotations

import glob
import os
import zlib

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A generator for ``stream`` of ``seed``: independent streams of one
    seed, the same numbers for the same (seed, stream)."""
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) & (2**64 - 1),
                                (int(seed) >> 64) & (2**64 - 1),
                                zlib.crc32(stream.encode())]))


def frames(seed: int, stream: str, n: int, size: int, channels: int = 1) -> np.ndarray:
    """(n, size, size) u8 uniform-noise frames at one channel, (n,
    channels, size, size) at more."""
    shape = (n, size, size) if channels == 1 else (n, channels, size, size)
    return rng(seed, stream).integers(0, 256, size=shape, dtype=np.uint8)


def with_shipped(frames: np.ndarray, seed: int, stream: str, bundle: str,
                 count: int) -> np.ndarray:
    """``frames`` with ``count`` of them, at seeded places, replaced by
    seeded picks of the bundle's shipped test frames
    (``test_image_*.bin`` of the frames' size): frames the classifier is
    not saturated on, so that the comparison sees the head's precision.
    The shipped frames are gray: frames of more channels take none."""
    if count <= 0:
        return frames
    if frames.ndim != 3:
        raise ValueError(f"{count} shipped test frames asked for among frames of "
                         f"shape {frames.shape[1:]}: the shipped ones are gray")
    size = frames.shape[1]
    paths = sorted(glob.glob(os.path.join(bundle, "test_image_*.bin")))
    if not paths:
        raise FileNotFoundError(f"no shipped test frames in {bundle}")
    shipped = np.stack([np.fromfile(p, np.uint8).reshape(size, size) for p in paths])
    r = rng(seed, stream + ".shipped")
    at = r.choice(len(frames), size=count, replace=False)
    frames[at] = shipped[r.integers(0, len(shipped), size=count)]
    return frames
