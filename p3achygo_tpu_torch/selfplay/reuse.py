"""Position-reuse buffers (port of p3achygo_tpu/selfplay/reuse.py, a copy;
GoExploit, arXiv 2302.12359; mirrors cc/selfplay/reuse_buffer.h).

Host-side stores of mid-game starting positions: selfplay adds ~1 position
per game (kAddSeenStateProb = 0.003/move, self_play_thread.cc:40) plus the
fork manager's sampled continuations (fork.py), and new games restart from
a popped entry with probability `use_seen_state_prob`.

Variants (reuse_buffer.h:46-151):
- GoExploitBuffer: ring, uniform random pop (the reference's production
  default, selfplay/main.cc:186).
- RegretGuidedBuffer: max-heap by regret; Get() returns the highest-regret
  state with first_move_behavior forced to FORCE_FULL_SEARCH.
- CompositeBuffer: Add() feeds both, Get() alternates between them.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import List, Optional

import numpy as np

from p3achygo_tpu_torch.constants import GO_EXPLOIT_BUFFER_SIZE

# FirstMoveBehavior (reuse_buffer.h:19-26).
FMB_SAMPLE = 0  # game proceeds as normal
FMB_PLAY = 1  # no opening raw-policy sampling
FMB_FORCE_FULL_SEARCH = 2  # no raw-policy sampling; first move full search


@dataclasses.dataclass
class InitState:
    """Mirrors reuse_buffer.h:27-42 (board + last moves + mover + move# +
    restart behavior + provenance)."""

    stones: np.ndarray  # int8[361]
    last_moves: np.ndarray  # int16[5]
    to_move: int
    move_num: int
    komi: Optional[float] = None  # None -> run default komi
    first_move_behavior: int = FMB_SAMPLE
    kind: str = "goexploit"  # provenance (InitState::Kind + ForkKind)
    regret: float = 0.0


class GoExploitBuffer:
    def __init__(self, capacity: int = GO_EXPLOIT_BUFFER_SIZE, seed: int = 0):
        self.capacity = capacity
        self._buf: List[InitState] = []
        self._write = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self._buf)

    def add(self, state: InitState, regret: float = 0.0):
        if len(self._buf) < self.capacity:
            self._buf.append(state)
        else:
            self._buf[self._write] = state
            self._write = (self._write + 1) % self.capacity

    def pop_random(self) -> Optional[InitState]:
        """Random removal (GoExploitReuseBuffer::Get semantics)."""
        if not self._buf:
            return None
        idx = int(self._rng.integers(len(self._buf)))
        state = self._buf[idx]
        self._buf[idx] = self._buf[-1]
        self._buf.pop()
        return state

    # Buffer-protocol alias (ReuseBuffer::Get).
    get = pop_random

    def maybe_add_from_game(self, stones: np.ndarray, last_moves: np.ndarray,
                            to_move: np.ndarray, num_moves: int,
                            add_prob: float = 0.003):
        """Sample positions of a finished game into the buffer
        (|V|-annealing omitted: uniform per-move Bernoulli for now)."""
        L = int(num_moves)
        for t in range(L):
            if self._rng.uniform() < add_prob:
                self.add(InitState(
                    stones=stones[t].copy(),
                    last_moves=last_moves[t].copy(),
                    to_move=int(to_move[t]),
                    move_num=t,
                ))


class RegretGuidedBuffer:
    """Max-heap by regret; evicts the lowest-regret entry on overflow
    (RegretGuidedBuffer, reuse_buffer.h:79-117)."""

    def __init__(self, capacity: int = GO_EXPLOIT_BUFFER_SIZE, seed: int = 0):
        self.capacity = capacity
        # heapq is a min-heap: store (-regret, seq, state) for max-pop and
        # track the min separately for eviction.
        self._heap: list = []
        self._seq = itertools.count()

    def __len__(self):
        return len(self._heap)

    def add(self, state: InitState, regret: float = 0.0):
        heapq.heappush(self._heap, (-float(regret), next(self._seq), state))
        if len(self._heap) > self.capacity:
            # evict lowest regret (= max of the negated keys)
            idx = max(range(len(self._heap)), key=lambda i: self._heap[i][0])
            self._heap[idx] = self._heap[-1]
            self._heap.pop()
            heapq.heapify(self._heap)

    def get(self) -> Optional[InitState]:
        if not self._heap:
            return None
        _, _, state = heapq.heappop(self._heap)
        state = dataclasses.replace(
            state, first_move_behavior=FMB_FORCE_FULL_SEARCH)
        return state

    def maybe_add_from_game(self, *a, **kw):  # regret buffer takes only forks
        pass


class CompositeBuffer:
    """GoExploit + RegretGuided, alternating Get()
    (CompositeReuseBuffer, reuse_buffer.h:120-148)."""

    def __init__(self, capacity: int = GO_EXPLOIT_BUFFER_SIZE, seed: int = 0):
        self.goexploit = GoExploitBuffer(capacity, seed)
        self.regret = RegretGuidedBuffer(capacity, seed)
        self._turn = 0

    def __len__(self):
        return len(self.goexploit) + len(self.regret)

    def add(self, state: InitState, regret: float = 0.0):
        self.goexploit.add(state, regret)
        self.regret.add(state, regret)

    def get(self) -> Optional[InitState]:
        use_goexploit = (self._turn & 1) == 0
        self._turn += 1
        st = (self.goexploit.get() if use_goexploit else self.regret.get())
        if st is None:  # fall through to the other buffer
            st = (self.regret.get() if use_goexploit
                  else self.goexploit.get())
        return st

    def pop_random(self) -> Optional[InitState]:
        return self.get()

    def maybe_add_from_game(self, stones, last_moves, to_move, num_moves,
                            add_prob: float = 0.003):
        self.goexploit.maybe_add_from_game(stones, last_moves, to_move,
                                           num_moves, add_prob)


def make_reuse_buffer(buffer_type: str = "goexploit",
                      capacity: int = GO_EXPLOIT_BUFFER_SIZE,
                      seed: int = 0):
    """Factory over BufferType (reuse_buffer.h:44)."""
    if buffer_type == "goexploit":
        return GoExploitBuffer(capacity, seed)
    if buffer_type == "regret":
        return RegretGuidedBuffer(capacity, seed)
    if buffer_type == "composite":
        return CompositeBuffer(capacity, seed)
    raise ValueError(f"unknown reuse buffer type: {buffer_type}")
