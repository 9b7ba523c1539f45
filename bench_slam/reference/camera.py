"""Pinhole intrinsics of the benchmark's plain reference."""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Intrinsics:
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    @property
    def fovx(self) -> float:
        return 2.0 * math.atan(self.width / (2.0 * self.fx))

    @property
    def fovy(self) -> float:
        return 2.0 * math.atan(self.height / (2.0 * self.fy))
