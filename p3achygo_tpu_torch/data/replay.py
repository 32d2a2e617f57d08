"""Host-side replay buffer with reference window/sampling semantics (port
of p3achygo_tpu/data/replay.py; numpy, a copy).

Replaces the selfplay -> file chunks -> shuffler -> golden chunk relay
(cc/shuffler/chunk_manager.cc: reservoir sample prob p, shuffle buffer,
train_window_size) with an in-memory ring: examples stream in from the
vectorized self-play loop; training samples uniformly from the most recent
`window` examples weighted by the policy-surprise weight (tf_recorder's
example duplication, expressed as importance sampling). The same seed and
the same games give the same sample indices as the JAX package's buffer.
"""
from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

from p3achygo_tpu_torch.constants import NUM_LAST_MOVES, NUM_LOCS, NUM_MOVES
from p3achygo_tpu_torch.selfplay.records import GameExamples

_FIELDS = dict(
    stones=(np.int8, (NUM_LOCS,)),
    last_moves=(np.int16, (NUM_LAST_MOVES,)),
    color=(np.int8, ()),
    komi=(np.float32, ()),
    pi=(np.float32, (NUM_MOVES,)),
    pi_aux=(np.int16, ()),
    pi_aux_dist=(np.float32, (NUM_MOVES,)),
    has_pi_aux_dist=(np.bool_, ()),
    own=(np.int8, (NUM_LOCS,)),
    score_margin=(np.float32, ()),
    z=(np.float32, ()),
    q6=(np.float32, ()),
    q16=(np.float32, ()),
    q50=(np.float32, ()),
    q6_score=(np.float32, ()),
    q16_score=(np.float32, ()),
    q50_score=(np.float32, ()),
    weight=(np.float32, ()),
    mcts_value_dist=(np.uint16, (51,)),
)


class ReplayBuffer:
    def __init__(self, capacity: int = 1 << 20, seed: int = 0):
        self.capacity = capacity
        self._data = {
            name: np.zeros((capacity,) + shape, dtype)
            for name, (dtype, shape) in _FIELDS.items()
        }
        self._write = 0
        self._size = 0
        self.total_added = 0
        self.games_added = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return self._size

    def add_game(self, ex: GameExamples):
        n = len(ex)
        if n == 0:
            return
        idx = (self._write + np.arange(n)) % self.capacity
        for name in self._data:
            self._data[name][idx] = getattr(ex, name)
        self._write = int((self._write + n) % self.capacity)
        self._size = min(self._size + n, self.capacity)
        self.total_added += n
        self.games_added += 1

    def training_window(self) -> int:
        """KataGo-style window growth over total examples generated
        (shuffle_metadata.py:9-26: c*(1 + beta*((n/c)^alpha - 1)/alpha),
        alpha=.75 beta=.5 c=250k, floor 100k)."""
        alpha, beta, c, min_window = 0.75, 0.5, 250000, 100000
        n = max(self.total_added, 1)
        mult = beta * ((n / c) ** alpha - 1.0) / alpha + 1.0
        return int(max(min_window, mult * c))

    def sample(self, batch_size: int,
               window: Optional[int] = None) -> Dict[str, np.ndarray]:
        """Weighted sample from the most recent `window` examples."""
        if self._size == 0:
            raise ValueError("empty replay buffer")
        window = min(window or self._size, self._size)
        # indices of the most recent `window` entries
        start = (self._write - window) % self.capacity
        idx = (start + np.arange(window)) % self.capacity
        w = self._data["weight"][idx]
        p = w / w.sum() if w.sum() > 0 else None
        chosen = self._rng.choice(window, size=batch_size, replace=True, p=p)
        sel = idx[chosen]
        return {name: arr[sel] for name, arr in self._data.items()}

    # ---- persistence (resume support; fs_utils.py:37-65 rediscovers data
    # from disk on restart — here the ring itself is the store) ----
    def save(self, path: str):
        """Write the valid region + counters + rng state to an .npz."""
        size = self._size
        start = (self._write - size) % self.capacity
        idx = (start + np.arange(size)) % self.capacity
        arrays = {name: arr[idx] for name, arr in self._data.items()}
        meta = json.dumps({
            "size": size,
            "total_added": self.total_added,
            "games_added": self.games_added,
            "rng_state": self._rng.bit_generator.state,
        })
        np.savez(path, __meta__=np.frombuffer(meta.encode(), np.uint8),
                 **arrays)

    def load(self, path: str):
        """Restore from `save`; rows land at the head of the ring."""
        with np.load(path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            size = min(int(meta["size"]), self.capacity)
            for name in self._data:
                rows = z[name][-size:]
                self._data[name][:size] = rows
        self._write = size % self.capacity
        self._size = size
        self.total_added = int(meta["total_added"])
        self.games_added = int(meta["games_added"])
        self._rng.bit_generator.state = meta["rng_state"]
