"""Sharded training checkpoints: the port of
``tpu_cnn.train.checkpoint_sharded`` (orbax's ``CheckpointManager`` there).

The ``.npz`` path (``train/checkpoint.py``) gathers every leaf into one
host file, which defeats sharded training state: a ZeRO-1 moment
(``train_cnn --zero1``) would be gathered on every save. This module is
the sharded alternative, in a plain format of the port's own: a
directory holding one subdirectory per saved step, and in it one piece
per process, ``<step>/rank<r>/``, of ``.npy`` files:

  * the replicated leaves (parameters, best-val parameters, whole
    optimiser leaves) and ``meta.json`` (epoch, best accuracy, the
    optimiser's counters, the process count, the host RNG) in rank 0's
    piece, written once;
  * each ``RowShards`` block as its own file, ``<leaf>.part<block>.npy``,
    written by the process that holds it, never gathered.

A save snapshots the tensors to host memory (pinned, copied behind an
event on a card) and returns; a writer thread writes the files into a
temporary directory and renames it into place, so a step is whole or
absent, and a crash mid-save leaves the previous step restorable. A step
counts once every process's piece is in place. The last ``max_to_keep``
steps are kept. ``close()`` waits for the writer.

A restore takes the live state as its template and puts each leaf back
where the template holds it: a tensor on its device, a ``RowShards`` as
its blocks on their positions (a whole template leaf gathers the blocks,
a sharded one splits a whole saved leaf). Selected by the trainer when
``--checkpoint`` does not end in ``.npz``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import threading

import numpy as np
import torch

from tpu_cnn_torch.parallel import multihost as mh
from tpu_cnn_torch.parallel.mesh import RowShards


def _walk(prefix: str, tree: dict):
    """(dotted name, leaf) of a nested dict, in insertion order."""
    for k, v in tree.items():
        name = f"{prefix}.{k}"
        if isinstance(v, dict):
            yield from _walk(name, v)
        else:
            yield name, v


def _snapshot(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` that later in-place updates cannot reach: on a
    card, a pinned buffer filled by a copy on the current stream."""
    t = t.detach()
    if t.is_cuda:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        return h
    return t.clone()


class ShardedCheckpointer:
    """Epoch-step checkpoints over a directory: asynchronous saves, the
    last ``max_to_keep`` steps kept, restores onto the template's places.
    Every process of a multi-process job makes one and calls ``save``
    and ``restore`` with it together (no collective runs inside)."""

    def __init__(self, path: str, *, max_to_keep: int = 2):
        self.path = os.path.abspath(path)
        self.max_to_keep = int(max_to_keep)
        self.rank, self.world = mh.process_index(), mh.process_count()
        os.makedirs(self.path, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def save(self, epoch: int, params, opt_state: dict, best_acc: float,
             best_params, rng: np.random.RandomState | None = None) -> None:
        """Snapshot the state of ``epoch`` and write it in the background
        (after the previous save's write has finished)."""
        self._wait()
        files: dict[str, torch.Tensor] = {}
        counters = {}
        primary = self.rank == 0
        if primary:
            for k, v in params.items():
                files[f"params.{k}"] = _snapshot(v)
            for k, v in best_params.items():
                files[f"best.{k}"] = _snapshot(v)
        for name, leaf in _walk("opt", opt_state):
            if isinstance(leaf, RowShards):
                for i, part in enumerate(leaf.parts):
                    files[f"{name}.part{leaf.first + i}"] = _snapshot(part)
            elif isinstance(leaf, torch.Tensor):
                if primary:
                    files[name] = _snapshot(leaf)
            else:
                counters[name] = int(leaf)
        meta = {"epoch": int(epoch), "best_acc": float(best_acc),
                "world": self.world, "opt": counters}
        if rng is not None:
            _, keys, pos, has_gauss, cached = rng.get_state()
            files["rng_keys"] = torch.from_numpy(np.array(keys))
            meta["rng"] = [int(pos), int(has_gauss), float(cached)]
        event = None
        if torch.cuda.is_available() and any(t.is_pinned() for t in files.values()):
            event = torch.cuda.Event()
            event.record()
        self._thread = threading.Thread(
            target=self._write, args=(int(epoch), files, meta, event),
            name="sharded-checkpoint", daemon=True)
        self._thread.start()

    def _write(self, epoch: int, files: dict, meta: dict, event) -> None:
        try:
            if event is not None:
                event.synchronize()
            tmp = os.path.join(self.path, f".tmp-{epoch}-rank{self.rank}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for name, h in files.items():
                np.save(os.path.join(tmp, name + ".npy"), h.numpy())
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            step_dir = os.path.join(self.path, str(epoch))
            os.makedirs(step_dir, exist_ok=True)
            final = os.path.join(step_dir, f"rank{self.rank}")
            shutil.rmtree(final, ignore_errors=True)  # a step saved again
            os.rename(tmp, final)  # the finalisation
            self._prune()
        except Exception as e:  # re-raised by the next save or close
            self._error = e

    def _prune(self) -> None:
        """Drop this process's pieces of all but its last max_to_keep
        steps (and a step directory left empty)."""
        mine = sorted(s for s in self._steps() if os.path.isdir(
            os.path.join(self.path, str(s), f"rank{self.rank}")))
        for s in mine[:-self.max_to_keep]:
            step_dir = os.path.join(self.path, str(s))
            shutil.rmtree(os.path.join(step_dir, f"rank{self.rank}"))
            try:
                os.rmdir(step_dir)
            except OSError:  # another process's piece is still there
                pass

    def _steps(self) -> list[int]:
        return [int(n) for n in os.listdir(self.path) if n.isdigit()]

    def _complete(self, step: int) -> bool:
        d = os.path.join(self.path, str(step))
        try:
            with open(os.path.join(d, "rank0", "meta.json")) as f:
                world = json.load(f)["world"]
        except FileNotFoundError:
            return False
        return all(os.path.isdir(os.path.join(d, f"rank{r}")) for r in range(world))

    def _wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def latest(self) -> int | None:
        """The newest step every process's piece of which is in place."""
        done = [s for s in self._steps() if self._complete(s)]
        return max(done) if done else None

    def restore(self, params_like, opt_state_like: dict,
                rng: np.random.RandomState | None = None):
        """(params, opt_state, epoch, best_acc, best_params) from the latest
        step: each leaf where the template leaf is (``params_like`` a
        name -> tensor dict, ``opt_state_like`` the optimiser state);
        ``rng``'s state restored when the step holds one."""
        step = self.latest()
        if step is None:
            raise FileNotFoundError("no checkpoint steps in manager dir")
        step_dir = os.path.join(self.path, str(step))
        with open(os.path.join(step_dir, "rank0", "meta.json")) as f:
            meta = json.load(f)

        def path_of(name: str) -> str:
            return os.path.join(step_dir, "rank0", name + ".npy")

        def parts_of(name: str) -> list[str]:
            found = glob.glob(os.path.join(step_dir, "rank*", name + ".part*.npy"))
            return sorted(found, key=lambda p: int(p.rsplit(".part", 1)[1][:-4]))

        def whole(name: str, shape) -> torch.Tensor:
            if os.path.exists(path_of(name)):
                a = np.load(path_of(name))
            else:
                a = np.concatenate([np.load(p) for p in parts_of(name)])
            if a.shape != tuple(shape):
                raise ValueError(f"checkpoint {step_dir!r} [{name}] shape mismatch: "
                                 f"saved {a.shape}, template {tuple(shape)}")
            return torch.from_numpy(a)

        def leaf(name: str, like):
            if isinstance(like, RowShards):
                parts = []
                for i, p in enumerate(like.parts):
                    f = os.path.join(step_dir, f"rank{self.rank}",
                                     f"{name}.part{like.first + i}.npy")
                    blk = (torch.from_numpy(np.load(f)) if os.path.exists(f)
                           else whole(name, like.shape)[like.rows(i)])
                    parts.append(blk.to(p.device, p.dtype).clone())
                return dataclasses.replace(like, parts=parts)
            if isinstance(like, torch.Tensor):
                return whole(name, like.shape).to(like.device, like.dtype).clone()
            return meta["opt"][name]

        def tree(prefix: str, like: dict) -> dict:
            return {k: tree(f"{prefix}.{k}", v) if isinstance(v, dict)
                    else leaf(f"{prefix}.{k}", v) for k, v in like.items()}

        params = {k: leaf(f"params.{k}", v) for k, v in params_like.items()}
        best = {k: leaf(f"best.{k}", v) for k, v in params_like.items()}
        opt_state = tree("opt", opt_state_like)
        if rng is not None and "rng" in meta:
            pos, has_gauss, cached = meta["rng"]
            rng.set_state(("MT19937", np.load(path_of("rng_keys")), pos,
                           has_gauss, cached))
        return params, opt_state, meta["epoch"], meta["best_acc"], best

    def close(self) -> None:
        """Wait for the last save's write (re-raising its error)."""
        self._wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
