"""GTP time control (a copy of p3achygo_tpu/gtp/time_control.py, which is
plain Python; reference cc/gtp/time_control.{h,cc}).

The reference stops a wall-clock search thread at a per-move budget
(time_control.cc:35). Here the budget maps to the largest search size of a
fixed set that fits (estimated ms/visit is measured online from completed
searches), and a timed search runs in slices of those sizes.

Budget semantics carried over:
- sudden-death main time budgeted over approx-moves-left, where moves left
  is min(400 - move_num, q-derived curve |v| -> moves
  (time_control.cc:59-67: ((|v| - 1.2525)/-0.18)^(1/0.3386) - 1 + 10));
- byoyomi: use (period - 1s) per move;
- optional obvious-move / stddev-EMA factors scale the budget down for
  clear positions and up for noisy ones.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TimeControl:
    enabled: bool = False
    main_time_secs: int = 0
    byoyomi_time_secs: int = 0
    byoyomi_periods: int = 0
    main_time_left_secs: int = 0
    byoyomi_time_left_secs: int = 0
    byoyomi_periods_left: int = 0
    in_byoyomi: bool = False
    stddev_ema: float = 0.0
    ms_per_visit: float = 10.0  # online estimate

    def set_time_settings(self, main_s: int, byo_s: int, periods: int):
        self.main_time_secs = main_s
        self.byoyomi_time_secs = byo_s
        self.byoyomi_periods = periods
        self.main_time_left_secs = main_s
        self.enabled = True

    def set_time_left(self, main_left_s: int, byo_left_s: int,
                      periods_left: int):
        self.main_time_left_secs = main_left_s
        self.byoyomi_time_left_secs = byo_left_s
        self.byoyomi_periods_left = periods_left
        self.in_byoyomi = periods_left > 0

    def observe_search(self, elapsed_ms: float, visits: int,
                       root_stddev: Optional[float] = None):
        if visits > 0:
            est = elapsed_ms / visits
            self.ms_per_visit = (0.5 * self.ms_per_visit + 0.5 * est
                                 if self.ms_per_visit else est)
        if root_stddev is not None:
            self.stddev_ema = (root_stddev if self.stddev_ema == 0
                               else 0.75 * self.stddev_ema + 0.25 * root_stddev)

    def compute_move_time_ms(self, move_num: int,
                             root_v: Optional[float] = None,
                             root_stddev: Optional[float] = None) -> int:
        """Per-move budget in ms; 0 = unconfigured (fixed-visit mode)."""
        if not self.enabled:
            return 0
        if self.in_byoyomi:
            return max(0, self.byoyomi_time_left_secs * 1000 - 1000)

        moves_left = max(400 - move_num, 10)
        if root_v is not None:
            # experimentally-derived curve (time_control.cc:59-67)
            av = min(abs(root_v), 1.2)
            q_moves = ((av - 1.2525) / -0.18) ** (1.0 / 0.3386) - 1 + 10
            moves_left = min(moves_left, max(int(round(q_moves)), 5))

        base_ms = self.main_time_left_secs * 1000.0 / max(moves_left, 1)

        factor = 1.0
        if root_stddev is not None and self.stddev_ema > 0:
            factor *= min(max(root_stddev / self.stddev_ema, 0.5), 2.0)
        return int(base_ms * factor)

    def pick_visits(self, budget_ms: int, choices=(16, 32, 64, 128, 256),
                    default: int = 128) -> int:
        """Largest visit count of `choices` fitting the budget."""
        if budget_ms <= 0:
            return default
        fit = [n for n in choices
               if n * self.ms_per_visit <= budget_ms]
        return fit[-1] if fit else choices[0]
