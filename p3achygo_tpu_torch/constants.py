"""Framework-wide constants of the PyTorch port.

The same values as `p3achygo_tpu/constants.py` (reference
cc/constants/constants.h:7-84). They are written out here rather than
imported so that the port loads nothing of the JAX package;
tests/test_torch_board.py holds every value equal to the JAX package's.
"""
from __future__ import annotations

BOARD_LEN = 19
NUM_LOCS = BOARD_LEN * BOARD_LEN  # 361
NUM_MOVES = NUM_LOCS + 1  # 362, incl. pass
PASS_MOVE = NUM_LOCS  # 361
NOOP_MOVE = -1

EMPTY = 0
BLACK = 1
WHITE = -1

MAX_GAME_LEN = 600

NUM_LAST_MOVES = 5

NUM_INPUT_PLANES = 15
NUM_INPUT_FEATURES = 8

NUM_VALUE_LOGITS = 2
NUM_SCORE_LOGITS = 800
SCORE_INFLECTION_POINT = 400

NUM_V_BUCKETS = 51

NUM_PASSES_BEFORE_BENSONS = 3

GO_EXPLOIT_BUFFER_SIZE = 8192

MAX_HISTORY = MAX_GAME_LEN + 16

DEFAULT_KOMI = 7.5
