"""Per-frame translational motion shifts (equivalent of
``src/motion/motion_shift.{h,cpp}``).

A MotionShiftSequence holds (dx, dy) subpixel shifts, one per frame, relative
to frame 0. The whitespace text file format is preserved for data
compatibility (``motion_shift.cpp:17-45``): one ``dx dy`` pair per line, e.g.
``test_data/test_motion_sequence_4.txt`` = ``0 0 / 1 1 / 0 1 / 1 0``.

Internally the sequence is a ``[K, 2]`` float array (columns dx, dy).

Numpy only; the port's own copy of the JAX package's module of the same name.
"""

from __future__ import annotations

from typing import Iterable

import numpy as np

__all__ = ["MotionShift", "MotionShiftSequence"]


class MotionShift:
    """A single (dx, dy) shift (``motion_shift.h:14-19``)."""

    __slots__ = ("dx", "dy")

    def __init__(self, dx: float, dy: float):
        self.dx = float(dx)
        self.dy = float(dy)

    def __repr__(self) -> str:
        return f"MotionShift(dx={self.dx}, dy={self.dy})"

    def __eq__(self, other) -> bool:
        return isinstance(other, MotionShift) and (self.dx, self.dy) == (
            other.dx,
            other.dy,
        )


class MotionShiftSequence:
    """Ordered sequence of per-frame shifts with text-file I/O."""

    def __init__(self, shifts: Iterable = ()):  # MotionShift | (dx, dy) pairs
        self._shifts: list[MotionShift] = []
        self.set_motion_sequence(shifts)

    def set_motion_sequence(self, shifts: Iterable) -> None:
        out = []
        for s in shifts:
            if isinstance(s, MotionShift):
                out.append(MotionShift(s.dx, s.dy))
            else:
                dx, dy = s
                out.append(MotionShift(dx, dy))
        self._shifts = out

    @classmethod
    def from_file(cls, file_path: str) -> "MotionShiftSequence":
        """Load whitespace-delimited ``dx dy`` pairs (``motion_shift.cpp:17-30``)."""
        seq = cls()
        seq.load_sequence_from_file(file_path)
        return seq

    def load_sequence_from_file(self, file_path: str) -> None:
        values = []
        with open(file_path) as f:
            for token in f.read().split():
                values.append(float(token))
        if len(values) % 2 != 0:
            raise ValueError(f"Odd number of values in motion file {file_path}")
        self._shifts = [
            MotionShift(values[i], values[i + 1]) for i in range(0, len(values), 2)
        ]

    def save_sequence_to_file(self, file_path: str) -> None:
        with open(file_path, "w") as f:
            for s in self._shifts:
                f.write(f"{_fmt(s.dx)} {_fmt(s.dy)}\n")

    @property
    def num_motion_shifts(self) -> int:
        return len(self._shifts)

    def __len__(self) -> int:
        return len(self._shifts)

    def __getitem__(self, index: int) -> MotionShift:
        if not 0 <= index < len(self._shifts):
            raise IndexError(f"Motion shift index {index} out of range.")
        return self._shifts[index]

    def __iter__(self):
        return iter(self._shifts)

    def as_array(self) -> np.ndarray:
        """``[K, 2]`` array with columns (dx, dy)."""
        if not self._shifts:
            return np.zeros((0, 2))
        return np.array([[s.dx, s.dy] for s in self._shifts])

    @property
    def max_abs_shift(self) -> float:
        if not self._shifts:
            return 0.0
        return float(np.abs(self.as_array()).max())


def _fmt(v: float) -> str:
    # Match the reference's default operator<< formatting (drops trailing zeros).
    return f"{v:g}"
