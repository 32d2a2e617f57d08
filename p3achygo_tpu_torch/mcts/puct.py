"""PUCT search parameters (the `PuctParams` dataclass of
p3achygo_tpu/mcts/puct.py, a copy; mirrors mcts::PuctParams,
search_policy.h:24-50).

Only the parameters are ported, so that an eval player's configuration
(eval/player_config.py) can name a PUCT search; the search itself
(`search_root_puct`) is not ported, and a PUCT player raises
NotImplementedError when it is asked to search (eval/harness.py).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PuctParams:
    """Mirrors mcts::PuctParams (search_policy.h:24-50)."""

    n: int = 64
    c_puct: float = 1.0
    c_puct_visit_scaling: float = 0.45
    fpu: float = 0.2  # kDefaultFPU
    root_fpu: float = 0.2
    enable_var_scaling: bool = False
    var_scale_prior_visits: int = 4
    root_selection: str = "visit_count"  # visit_count | lcb | sample
    tau: float = 0.0
    lcb_z: float = 1.96
    max_depth: int = 32
    score_weight: float = 0.5
    # "direct" | "integral" (ScoreUtilityMode, leaf_evaluator.h:12-16).
    score_utility_mode: str = "direct"
    terminal_mode: str = "cheap"
    # Experimental variants (search_policy.h:24-50):
    # PUCT-V (search_policy.h:292-312): exploration scaled by the child's
    # value stddev plus a log-visit term weighted by c_puct_v_2.
    use_puct_v: bool = False
    c_puct_v_2: float = 3.0
    # M3/skewness bonus (search_policy.h:277-290): children with a larger
    # positive value tail than the visit-weighted average get a bonus that
    # decays with visits (dampened by m3_prior_visits).
    enable_m3_bonus: bool = False
    m3_prior_visits: int = 20
    # Optimistic-policy interpolation (search_policy.h:171-185). The
    # reference blends move_probs with opt_probs per node; the tree stores
    # one prior set, so the blend happens at NN-eval time — build the
    # eval_fn with make_eval_fn(p_opt_weight=...) to honor this knob (the
    # EvalRunner/player_config wiring does). Kept here for config parity.
    p_opt_weight: float = 0.0
