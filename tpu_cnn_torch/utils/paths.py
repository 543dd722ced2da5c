"""Default artifact resolution: the port's copy of ``tpu_cnn.utils.paths``.

Preference order: ``$TPU_CNN_ARTIFACTS`` > the variant family's own shipped
bundle (``artifacts/pretrained-<family>``) > the repository's pretrained
bundle (``artifacts/pretrained``). The original's last fallback, a mounted
upstream bundle, is left out: the repository's own bundle comes first.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
PRETRAINED_DIR = os.path.join(_REPO_ROOT, "artifacts", "pretrained")


def default_artifacts(variant: str = "lyr3-std") -> str:
    """The default bundle directory for ``variant``: a non-flagship variant
    (e.g. ``lyr4-wide``) prefers ``artifacts/pretrained-<family>`` when it
    exists, so the CLIs need no ``--artifacts`` for a shipped family."""
    env = os.environ.get("TPU_CNN_ARTIFACTS")
    if env:
        return env
    dirs = []
    if variant and variant != "lyr3-std":
        dirs.append(os.path.join(_REPO_ROOT, "artifacts",
                                 "pretrained-" + variant.split("-")[0]))
    dirs.append(PRETRAINED_DIR)
    for d in dirs:
        if os.path.exists(os.path.join(d, "weights.bin")):
            return d
    raise FileNotFoundError(
        "no artifact bundle found; set TPU_CNN_ARTIFACTS or pass --artifacts")
