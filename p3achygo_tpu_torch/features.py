"""NN input featurizer v1: 15 planes + 8 scalars (port of
p3achygo_tpu/features.py; reference cc/nn/engine/go_features.cc:10-62).

  planes 0/1   own/opp stones
  planes 2-6   last-5-move one-hots (oldest..newest; pass/noop skipped)
  planes 7/8   own/opp stones in atari (1 liberty)
  planes 9/10  own/opp stones with 2 liberties
  planes 11/12 own/opp stones with 3 liberties
  planes 13/14 own/opp laddered stones (always zero: ladders are off)
  scalars: [own==B, own==W, pass flags for last-5 moves, signed komi/15]

Planes are NHWC [B, 19, 19, 15], the JAX package's layout.
"""
from __future__ import annotations

from typing import Tuple

import torch

from p3achygo_tpu_torch.constants import (
    BLACK,
    BOARD_LEN,
    NUM_INPUT_PLANES,
    NUM_LOCS,
)
from p3achygo_tpu_torch.game.board import GoState
from p3achygo_tpu_torch.ops.liberties import point_liberties_batch


def batched_features(states: GoState, include_ladders: bool = False,
                     planes_dtype: torch.dtype = torch.float32
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B] states -> (planes [B, 19, 19, 15] planes_dtype, scalars
    float32[B, 8]) for each board's to_move; liberties from the kernel."""
    if include_ladders:
        raise NotImplementedError("ladder planes are not ported; "
                                  "include_ladders=False is the production setting")
    libs = point_liberties_batch(states.stones, states.chain_id)
    B = states.stones.shape[0]
    dev = states.stones.device
    c = states.to_move[:, None]
    own = states.stones == c
    opp = states.stones == -c
    zeros = torch.zeros((B, NUM_LOCS), dtype=torch.bool, device=dev)

    mv = states.last_moves  # [B, 5]
    on_board = (mv >= 0) & (mv < NUM_LOCS)
    iota = torch.arange(NUM_LOCS, device=dev)[None, None, :]
    onehots = (iota == mv.clamp(0, NUM_LOCS - 1)[:, :, None]) & on_board[:, :, None]

    planes = torch.stack([
        own, opp,
        onehots[:, 0], onehots[:, 1], onehots[:, 2], onehots[:, 3], onehots[:, 4],
        own & (libs == 1), opp & (libs == 1),
        own & (libs == 2), opp & (libs == 2),
        own & (libs == 3), opp & (libs == 3),
        zeros, zeros,
    ], dim=-1).to(planes_dtype)
    planes = planes.reshape(B, BOARD_LEN, BOARD_LEN, NUM_INPUT_PLANES)

    is_black = (states.to_move == BLACK).to(torch.float32)
    pass_flags = (mv == NUM_LOCS).to(torch.float32)
    komi_feat = torch.where(states.to_move == BLACK, -1.0, 1.0) * states.komi / 15.0
    scalars = torch.cat([is_black[:, None], (1.0 - is_black)[:, None],
                         pass_flags, komi_feat[:, None]], dim=1)
    return planes, scalars

