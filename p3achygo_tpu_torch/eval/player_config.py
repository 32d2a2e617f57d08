"""Per-player eval search configuration (port of
p3achygo_tpu/eval/player_config.py, a copy; mirrors
cc/eval/player_config.h:21-109 + its key:value file parser :111-240).

Only the knobs meaningful to the TPU search are carried; the reference's
parallel-search selectors (collision policies etc.) have no equivalent
here by design (see mcts/puct.py docstring).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from p3achygo_tpu_torch.mcts.gumbel import SearchParams
from p3achygo_tpu_torch.mcts.puct import PuctParams


@dataclasses.dataclass
class PlayerSearchConfig:
    search_type: str = "gumbel"  # gumbel | puct
    n: int = 128
    k: int = 8
    tau: float = 0.0
    # 1.0 = reference gumbel root noise; also the per-game diversity
    # source in matches (see EvalConfig.search note).
    noise_scale: float = 1.0
    score_weight: float = 0.5
    # MCGS graph search (use_mcgs, player_config.h + node_table.h:78-120).
    use_mcgs: bool = False
    # Grouped visits (SearchParams.visit_group; 1 = reference semantics).
    visit_group: int = 1
    # "direct" | "integral" (ScoreUtilityMode, leaf_evaluator.h:12-16).
    score_utility_mode: str = "direct"
    # puct knobs
    c_puct: float = 1.0
    c_puct_visit_scaling: float = 0.45
    root_fpu: float = 0.2
    enable_var_scaling: bool = False
    var_scale_prior_visits: int = 4
    root_selection: str = "visit_count"
    max_depth: int = 32

    def to_search_params(self) -> SearchParams:
        return SearchParams(n=self.n, k=self.k, tau=self.tau,
                            noise_scale=self.noise_scale,
                            score_weight=self.score_weight,
                            max_depth=self.max_depth,
                            use_mcgs=self.use_mcgs,
                            visit_group=self.visit_group,
                            score_utility_mode=self.score_utility_mode)

    def to_puct_params(self) -> PuctParams:
        return PuctParams(n=self.n, c_puct=self.c_puct,
                          c_puct_visit_scaling=self.c_puct_visit_scaling,
                          root_fpu=self.root_fpu,
                          enable_var_scaling=self.enable_var_scaling,
                          var_scale_prior_visits=self.var_scale_prior_visits,
                          root_selection=self.root_selection, tau=self.tau,
                          max_depth=self.max_depth,
                          score_weight=self.score_weight,
                          score_utility_mode=self.score_utility_mode)


def parse_player_config(text: str) -> PlayerSearchConfig:
    """Parse `key: value` lines (player_config.h:111-240); '#' comments."""
    cfg = PlayerSearchConfig()
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line or ":" not in line:
            continue
        key, val = (s.strip() for s in line.split(":", 1))
        if not hasattr(cfg, key):
            continue
        cur = getattr(cfg, key)
        if isinstance(cur, bool):
            setattr(cfg, key, val.lower() in ("1", "true", "yes"))
        elif isinstance(cur, int):
            setattr(cfg, key, int(val))
        elif isinstance(cur, float):
            setattr(cfg, key, float(val))
        else:
            setattr(cfg, key, val)
    return cfg


def load_player_config(path: Optional[str]) -> PlayerSearchConfig:
    if not path:
        return PlayerSearchConfig()
    with open(path) as f:
        return parse_player_config(f.read())
