"""D4 symmetry group on board grids and move indices (port of
p3achygo_tpu/game/symmetry.py; reference cc/game/symmetry.h:12-21).

Precomputed index-permutation tables; a per-board transform is one
`gather` with the board's table row.
"""
from __future__ import annotations

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BOARD_LEN, NUM_LOCS
from p3achygo_tpu_torch.tables import DeviceTable

IDENTITY = 0
ROT90 = 1
ROT180 = 2
ROT270 = 3
FLIP = 4  # flip across vertical line
FLIP_ROT90 = 5
FLIP_ROT180 = 6
FLIP_ROT270 = 7
NUM_SYMMETRIES = 8


def _transform_grid(g: np.ndarray, sym: int) -> np.ndarray:
    if sym >= FLIP:
        g = g[:, ::-1]
        sym -= FLIP
    return np.rot90(g, k=sym)


def _build_tables():
    idx = np.arange(NUM_LOCS).reshape(BOARD_LEN, BOARD_LEN)
    fwd = np.zeros((NUM_SYMMETRIES, NUM_LOCS), np.int64)
    inv = np.zeros((NUM_SYMMETRIES, NUM_LOCS), np.int64)
    for s in range(NUM_SYMMETRIES):
        t = _transform_grid(idx, s).reshape(-1)
        fwd[s] = t
        inv[s][t] = np.arange(NUM_LOCS)
    return fwd, inv


_FWD_NP, _INV_NP = _build_tables()
# SYM_GATHER[s, p] = source index: apply(grid, s)[p] = grid[SYM_GATHER[s, p]]
SYM_GATHER = DeviceTable(_FWD_NP, torch.int64)
# SYM_SCATTER[s, p] = destination index of point p under symmetry s
SYM_SCATTER = DeviceTable(_INV_NP, torch.int64)


def apply_symmetry_grid_batch(grid: torch.Tensor, sym: torch.Tensor
                              ) -> torch.Tensor:
    """Per-board D4 transform of [B, 361] grids (any dtype)."""
    idx = SYM_GATHER.on(grid.device)[sym.long()]
    return grid.gather(1, idx)


def apply_symmetry_action(action: torch.Tensor, sym: torch.Tensor
                          ) -> torch.Tensor:
    """Transform move encodings [B, ...] under per-board symmetry sym [B]
    (pass and noop are fixed points)."""
    table = SYM_SCATTER.on(action.device)
    s = sym.long().reshape(sym.shape + (1,) * (action.dim() - 1))
    mapped = table[s, action.long().clamp(0, NUM_LOCS - 1)]
    on_board = (action >= 0) & (action < NUM_LOCS)
    return torch.where(on_board, mapped.to(action.dtype), action)
