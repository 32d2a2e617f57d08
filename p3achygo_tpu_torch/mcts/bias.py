"""Local-pattern value-bias cache (port of p3achygo_tpu/mcts/bias.py;
reference cc/mcts/bias_cache.h:16-205).

Positions sharing the same 5x5 local pattern around the last move (stones
+ atari map + illegal-empty map, plus the last two moves and the mover's
color) share a cache entry that tracks the network's observed value error
there; fresh evaluations of matching patterns are corrected by
lambda * (weighted error / weighted visits).

The table is per board, open-addressed, keyed by two 32-bit pattern-hash
lanes (held in int64). Leaves fetch their correction at creation; the
error statistics accumulate once at the end of each search from node
aggregates, delta'd against each node's last contribution so tree reuse
never double-counts (the JAX package's telescoped UpdateAndFetch). Window
values and Zobrist rows are read by gathers; where the JAX package selects
Zobrist rows with a where-chain, the port indexes the [25, 4, 2] table.

Off by default, as in the reference (bias_cache_lambda = 0.0,
selfplay/main.cc:58).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from p3achygo_tpu_torch.constants import BLACK, BOARD_LEN, EMPTY, NUM_LOCS, WHITE
from p3achygo_tpu_torch.mcts.tree import mul_u32, scatter_last
from p3achygo_tpu_torch.tables import DeviceTable

PATTERN_LEN = 5
_HALF = PATTERN_LEN // 2
# State encoding inside the pattern (bias_cache.h:33-39): EMPTY 0 (hash 0),
# BLACK 1, OFF_BOARD 2, WHITE 3.
_NUM_STATES = 4

# [5, 5, 4, 2-lane] Zobrist rows with the EMPTY rows zero: the JAX
# package's tables, made by the same numpy calls.
_rng = np.random.default_rng(0xB1A5)
_PZ = _rng.integers(0, 1 << 32, (PATTERN_LEN, PATTERN_LEN, _NUM_STATES, 2),
                    dtype=np.uint32)
_PZ[:, :, EMPTY, :] = 0
_PZ_ATARI = np.roll(_PZ, 7, axis=3) ^ np.uint32(0x9E3779B9)
_PZ_KO = np.roll(_PZ, 13, axis=3) ^ np.uint32(0x85EBCA6B)


def _gather_table(z: np.ndarray) -> DeviceTable:
    """[25, 4, 2] rows for `_xor_select`: state 0 contributes nothing (the
    JAX select chain's default), so its rows are zero in every table."""
    flat = z.reshape(PATTERN_LEN * PATTERN_LEN, _NUM_STATES, 2).astype(np.int64)
    flat[:, 0] = 0
    return DeviceTable(flat, torch.int64)


PZ_GRID, PZ_ATARI, PZ_KO = _gather_table(_PZ), _gather_table(_PZ_ATARI), _gather_table(_PZ_KO)
# Arithmetic mixing constants for (last move, two-moves-ago, color).
_C_LAST = 2654435761
_C_PREV = 2246822519
_C_COLOR = 3266489917

BIAS_PROBES = 4


class BiasTable(NamedTuple):
    """Open-addressed per-board pattern table [B, S] (S a power of two)."""

    key0: torch.Tensor  # int64[B, S] (uint32 value)
    key1: torch.Tensor  # int64[B, S]
    used: torch.Tensor  # int8[B, S] 0 = empty
    err_sum: torch.Tensor  # f32[B, S] weighted observed error
    w_sum: torch.Tensor  # f32[B, S] weighted visits


def make_bias_table(batch_size: int, size: int = 1024, device="cuda") -> BiasTable:
    if size & (size - 1):
        raise ValueError(f"table size must be a power of two, got {size}")
    dev = torch.device(device)
    z = lambda dtype: torch.zeros((batch_size, size), dtype=dtype, device=dev)
    return BiasTable(key0=z(torch.int64), key1=z(torch.int64), used=z(torch.int8),
                     err_sum=z(torch.float32), w_sum=z(torch.float32))


def _window_values(grid: torch.Tensor, center: torch.Tensor,
                   off_board_val: int) -> torch.Tensor:
    """[W, 361] per-lane grids + [W] centers -> int64[W, 25] values of the
    5x5 window around each center, row-major, off-board points reading
    `off_board_val`."""
    W = grid.shape[0]
    g = grid.reshape(W, BOARD_LEN, BOARD_LEN).long()
    pad = F.pad(g, (_HALF, _HALF, _HALF, _HALF), value=off_board_val)
    width = BOARD_LEN + 2 * _HALF
    c = center.long().clamp(0, NUM_LOCS - 1)
    top_left = (c // BOARD_LEN) * width + c % BOARD_LEN  # window origin in pad
    d = torch.arange(PATTERN_LEN, device=grid.device)
    offs = (d[:, None] * width + d[None, :]).reshape(-1)
    return pad.reshape(W, -1).gather(1, top_left[:, None] + offs[None, :])


def _xor_select(vals: torch.Tensor, ztab: torch.Tensor) -> torch.Tensor:
    """[W, 25] states 0..3 -> XOR over offsets of ztab[off, state] ->
    int64[W, 2] (uint32 lanes)."""
    rows = ztab[torch.arange(PATTERN_LEN * PATTERN_LEN, device=vals.device)[None, :],
                vals]  # [W, 25, 2]
    h = rows[:, 0]
    for off in range(1, PATTERN_LEN * PATTERN_LEN):
        h = h ^ rows[:, off]
    return h


def local_pattern_keys(stones: torch.Tensor, atari: torch.Tensor,
                       illegal_empty: torch.Tensor, last_moves: torch.Tensor,
                       to_move: torch.Tensor):
    """Per-lane pattern keys (LocalPattern::FromCurrentPosition,
    bias_cache.h:63-118).

    stones int8[W, 361]; atari bool[W, 361] (chain liberties == 1);
    illegal_empty bool[W, 361] (empty and not legal for the side to move,
    the reference's ko map); last_moves int[W, 5] (oldest..newest).
    Returns (h0, h1, valid): int64 keys holding uint32 values, and valid
    False when the last move is a pass or noop or the move before it is a
    noop."""
    dev = stones.device
    last = last_moves[:, -1].long()
    prev = last_moves[:, -2].long()
    valid = (last >= 0) & (last < NUM_LOCS) & (prev != -1)
    grid = torch.where(stones == BLACK, 1, torch.where(stones == WHITE, 3, 0))
    h = (_xor_select(_window_values(grid, last, 2), PZ_GRID.on(dev))
         ^ _xor_select(_window_values(atari, last, 0), PZ_ATARI.on(dev))
         ^ _xor_select(_window_values(illegal_empty, last, 0), PZ_KO.on(dev)))
    # Fold last/prev moves and the mover's color in; the color of the LAST
    # move is the opponent of the side to move now. A negative last move
    # wraps as uint32 does in the JAX package (such keys are not valid).
    lastu = last & 0xFFFFFFFF
    prevu = prev.clamp(0, NUM_LOCS)
    colu = torch.where(to_move == BLACK, 2, 1).long()
    col = mul_u32(colu, _C_COLOR)
    h0 = h[:, 0] ^ mul_u32(lastu, _C_LAST) ^ col
    h1 = h[:, 1] ^ mul_u32(prevu, _C_PREV) ^ col
    return h0, h1, valid


def _slots(h0: torch.Tensor, h1: torch.Tensor, size: int) -> torch.Tensor:
    base = h0 ^ mul_u32(h1, 2654435761)
    offs = torch.arange(BIAS_PROBES, device=h0.device)[None, :]
    return (base[:, None] + offs) & (size - 1)


def bias_probe(table: BiasTable, k_r: int, h0: torch.Tensor, h1: torch.Tensor,
               valid: torch.Tensor):
    """Lookup W = B * k_r lanes (lanes b-major) -> (bias_num f32[W],
    bias_den f32[W], slot int64[W], can_insert bool[W]). `slot` is the
    matching slot if found, else the first empty probed slot; can_insert
    says some usable slot exists."""
    S = table.key0.shape[1]
    slots = _slots(h0, h1, S)
    bw = (torch.arange(h0.shape[0], device=h0.device) // k_r)[:, None]
    used = table.used[bw, slots] > 0
    hit_p = used & (table.key0[bw, slots] == h0[:, None]) \
        & (table.key1[bw, slots] == h1[:, None])
    first = lambda m: m & (m.long().cumsum(dim=1) == 1)
    first_hit = first(hit_p)
    any_hit = hit_p.any(dim=1)
    empty_p = ~used
    pick = torch.where(any_hit[:, None], first_hit, first(empty_p))
    slot = torch.where(pick, slots, 0).sum(dim=1)
    can = (any_hit | empty_p.any(dim=1)) & valid
    hit = any_hit & valid
    num = torch.where(first_hit, table.err_sum[bw, slots], 0.0).sum(dim=1)
    den = torch.where(first_hit, table.w_sum[bw, slots], 0.0).sum(dim=1)
    return (torch.where(hit, num, 0.0), torch.where(hit, den, 0.0), slot, can)


def bias_fetch(table: BiasTable, k_r: int, h0, h1, valid, lam: float) -> torch.Tensor:
    """lambda * err_sum / w_sum for matching patterns, else 0
    (BiasCache::Fetch, bias_cache.h:188-193)."""
    num, den, _, _ = bias_probe(table, k_r, h0, h1, valid)
    return torch.where(den > 0, lam * num / den.clamp(min=1e-9), 0.0)


def bias_accumulate(table: BiasTable, slot_bn: torch.Tensor, valid_bn: torch.Tensor,
                    key0_bn: torch.Tensor, key1_bn: torch.Tensor,
                    d_err_bn: torch.Tensor, d_w_bn: torch.Tensor) -> BiasTable:
    """End-of-search accumulation: per-node deltas [B, N] added into their
    pattern slots; the slots are marked used and take the node's keys (where
    nodes collide on a slot, the last node in (board, node) order wins, as
    in the JAX package's scatter). Returns a new table."""
    B, S = table.key0.shape
    N = slot_bn.shape[1]
    dev = slot_bn.device
    flat = (torch.arange(B, device=dev)[:, None] * S
            + torch.where(valid_bn, slot_bn.long(), 0)).reshape(-1)
    v = valid_bn.reshape(-1)
    err_sum = table.err_sum.clone()
    w_sum = table.w_sum.clone()
    err_sum.view(-1).index_add_(0, flat, torch.where(v, d_err_bn.reshape(-1), 0.0))
    w_sum.view(-1).index_add_(0, flat, torch.where(v, d_w_bn.reshape(-1), 0.0))
    used, key0, key1 = table.used.clone(), table.key0.clone(), table.key1.clone()
    scatter_last(used.view(-1), flat, torch.ones(B * N, dtype=torch.int8, device=dev), v)
    scatter_last(key0.view(-1), flat, key0_bn.reshape(-1), v)
    scatter_last(key1.view(-1), flat, key1_bn.reshape(-1), v)
    return BiasTable(key0=key0, key1=key1, used=used, err_sum=err_sum, w_sum=w_sum)
