"""What a driver hands back from one run of a cell."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Answers:
    """The program's answers: for each, which distinct frame it is for, and
    the outputs it gave, one array per output (n rows each) in the order
    the program hands them back. Only the cell's reference module
    (``reference/<name>.py``) reads what each output means."""

    frame: np.ndarray  # (n,) int64 index into Outcome.frames
    outputs: tuple[np.ndarray, ...]

    @classmethod
    def join(cls, parts: list["Answers"], empty: "Answers") -> "Answers":
        """The parts one after the other; ``empty`` where there are none."""
        if not parts:
            return empty
        return cls(np.concatenate([p.frame for p in parts]),
                   tuple(np.concatenate(col) for col in zip(*(p.outputs for p in parts))))


@dataclasses.dataclass
class Outcome:
    measured: dict  # end-to-end readings by metric name
    attempted: int
    failed: int
    frames: object  # (U, S, S) or (U, C, S, S) u8 distinct frames, numpy or torch
    answers: Answers
    lost: int  # answers that never came
    kind: str  # the card's name (torch.cuda.get_device_name) or "cpu"
    count: int
    memory_peak_bytes: int
    ctx: dict  # what the per-layer readers read
    trace: dict | None  # the traced sub-window, reduced (lib.trace)
