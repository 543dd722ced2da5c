"""What a driver hands back from one run of a cell."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answers:
    """The program's answers: for each, which distinct frame it is for, and
    the pred, conf, probs and bbox it gave."""

    frame: np.ndarray  # (n,) int64 index into Outcome.frames
    pred: np.ndarray  # (n,)
    conf: np.ndarray  # (n,)
    probs: np.ndarray  # (n, K)
    bbox: np.ndarray  # (n, 4)

    @classmethod
    def join(cls, parts: list["Answers"], k: int) -> "Answers":
        if not parts:
            return cls(np.zeros(0, np.int64), np.zeros(0, np.int64),
                       np.zeros(0), np.zeros((0, k)), np.zeros((0, 4), np.int64))
        return cls(*(np.concatenate([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(cls)))


@dataclasses.dataclass
class Outcome:
    measured: dict  # end-to-end readings by metric name
    attempted: int
    failed: int
    frames: object  # (U, S, S) u8 distinct frames, numpy or torch
    answers: Answers
    lost: int  # answers that never came
    kind: str  # the card's name (torch.cuda.get_device_name) or "cpu"
    count: int
    memory_peak_bytes: int
    ctx: dict  # what the per-layer readers read
    trace: dict | None  # the traced sub-window, reduced (lib.trace)
