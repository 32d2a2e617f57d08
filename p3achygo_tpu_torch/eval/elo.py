"""Relative Elo from winrate (port of p3achygo_tpu/eval/elo.py, a copy;
mirrors cc/core/elo.h:8 + eval/main.cc:455-470)."""
from __future__ import annotations

import math
from typing import Tuple


def relative_elo(winrate: float) -> float:
    """400 * log10(w / (1 - w)), clamped away from 0/1."""
    w = min(max(winrate, 1e-6), 1.0 - 1e-6)
    return 400.0 * math.log10(w / (1.0 - w))


def elo_with_ci(wins: float, num_games: int,
                z: float = 1.96) -> Tuple[float, float, float]:
    """-> (elo, lo, hi) with a 95% normal-approx CI on the winrate."""
    n = max(num_games, 1)
    w = wins / n
    sigma = math.sqrt(max(w * (1.0 - w), 1e-12) / n)
    return (relative_elo(w), relative_elo(w - z * sigma),
            relative_elo(w + z * sigma))
