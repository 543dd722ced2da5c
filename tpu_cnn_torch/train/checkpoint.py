"""Training checkpoint/resume: the port of ``tpu_cnn.train.checkpoint``.

Every epoch can snapshot the parameters, the optimiser state, the best-val
state, the progress and the host RNG to one ``.npz`` (write-temp + rename),
and a run resumes from it. The file's layout is the JAX trainer's:
``{prefix}__{i}`` per leaf for the prefixes ``params``, ``opt`` and
``best``, plus ``__meta`` (JSON: ``epoch``, ``best_acc``). The leaves of a
parameter dict are its arrays in sorted-name order (``conv0``.., ``fc_b``,
``fc_w``); those of the optimiser state are ``AdamCosine.leaves``': Adam's
count, mu and nu, then the schedule's count (behind MultiSteps' two counts
and ahead of its accumulated gradients under ``--grad-accum``). So a plain
``.npz`` that the JAX trainer wrote loads here, and a run begun in JAX
resumes in the port.

The JAX file also holds ``{prefix}__treedef``, a pytree string that only
JAX prints; the port writes a list of its leaves' names there and compares
leaf count and shapes on load instead, refusing a mismatch. The host RNG
(the permutation and augmentation stream) is the port's addition:
``rng__keys`` and ``__meta["rng"]``; a file without it resumes with the
caller's fresh RNG, as the JAX trainer does.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Mapping, Sequence

import numpy as np
import torch


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _flatten(prefix: str, leaves: Sequence, names: Sequence[str], out: dict) -> None:
    out[f"{prefix}__treedef"] = np.asarray(",".join(names))
    for i, leaf in enumerate(leaves):
        out[f"{prefix}__{i}"] = _host(leaf)


def save_checkpoint(
    path: str,
    params: Mapping,
    opt_state: Sequence,
    epoch: int,
    best_acc: float,
    best_params: Mapping,
    extra: dict | None = None,
    rng: np.random.RandomState | None = None,
) -> None:
    """Atomic .npz snapshot (write-temp + rename). ``params`` and
    ``best_params`` map names to tensors or arrays; ``opt_state`` is the
    optimiser's leaf list (``AdamCosine.leaves``)."""
    arrays: dict[str, np.ndarray] = {}
    names = sorted(params)
    _flatten("params", [params[k] for k in names], names, arrays)
    _flatten("opt", opt_state, [f"opt{i}" for i in range(len(opt_state))], arrays)
    _flatten("best", [best_params[k] for k in names], names, arrays)
    meta = {"epoch": int(epoch), "best_acc": float(best_acc), **(extra or {})}
    if rng is not None:
        _, keys, pos, has_gauss, cached = rng.get_state()
        arrays["rng__keys"] = keys
        meta["rng"] = [int(pos), int(has_gauss), float(cached)]
    arrays["__meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, params_like: Mapping, opt_state_like: Sequence,
                    rng: np.random.RandomState | None = None):
    """Restore ``(params, opt_state, epoch, best_acc, best_params)``:
    ``params``/``best_params`` as name -> numpy dicts keyed as
    ``params_like``, ``opt_state`` as a leaf list shaped as
    ``opt_state_like``. Raises ``ValueError`` when the file's leaf count or
    a leaf's shape differs from the template's. Restores ``rng``'s state
    when the file holds one."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta"]).decode())

    def leaves(prefix, like):
        saved = sum(1 for k in data.files
                    if k.startswith(prefix + "__") and k[len(prefix) + 2:].isdigit())
        if saved != len(like):
            raise ValueError(
                f"checkpoint {path!r} [{prefix}] holds {saved} leaves, the "
                f"template {len(like)}: another model or optimiser "
                f"(--grad-accum?) than this run's")
        out = []
        for i, leaf in enumerate(like):
            r = np.asarray(data[f"{prefix}__{i}"])
            if r.shape != tuple(np.shape(leaf)):
                raise ValueError(
                    f"checkpoint {path!r} [{prefix} leaf {i}] shape mismatch: "
                    f"saved {r.shape}, template {tuple(np.shape(leaf))} — "
                    f"layer_configs changed since this checkpoint was saved?")
            out.append(r)
        return out

    names = sorted(params_like)
    like = [params_like[k] for k in names]
    params = dict(zip(names, leaves("params", like)))
    opt_state = leaves("opt", list(opt_state_like))
    best_params = dict(zip(names, leaves("best", like)))
    if rng is not None and "rng" in meta:
        pos, has_gauss, cached = meta["rng"]
        rng.set_state(("MT19937", data["rng__keys"], pos, has_gauss, cached))
    return params, opt_state, meta["epoch"], meta["best_acc"], best_params
