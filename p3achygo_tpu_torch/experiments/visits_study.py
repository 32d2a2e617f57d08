"""Gumbel visit-count study (port of p3achygo_tpu/experiments/
visits_study.py; reference cc/experiments/gumbel_visits_study.cc).

Measures, per position, the KLD between a "ground-truth" improved policy
(Gumbel N=gt_n K=16, or PUCT N=gt_n empirical visit distribution with
--use_gumbel=false) and the improved policy produced by an N-visit search
for each N in a sweep. Each N-visit Gumbel search is first seeded with
`seed_visits` PUCT visits (simulating self-play tree reuse) via
search_root_puct(return_tree=True) -> init_tree, mirroring RunSeededGumbel
(gumbel_visits_study.cc:219-241).

The reference's per-example loop is ONE lockstep batch per (search kind,
N): all positions search together. The fixed per-position seed
(gumbel_visits_study.cc:427-429: the same Gumbel noise gives the same
top-K actions across the ground truth and every N) is kept by drawing the
root noise once and passing the same `gumbel_noise` to every search.

Deviations (the JAX package's): the reference study's PUCT config sets
p_opt_weight=1.0 (optimistic-policy interpolation, search_policy.h:
171-185), which this PUCT does not expose; its per-search BiasCache
(alpha=0.8, lambda=0.3 for Gumbel) is honoured for Gumbel searches via
SearchParams.bias_lambda and a fresh bias table per search, but not for
the PUCT seeding pass (mcts/puct.py takes no bias table).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from p3achygo_tpu_torch.constants import NUM_MOVES
from p3achygo_tpu_torch.game.board import GoState, from_stones
from p3achygo_tpu_torch.mcts.bias import make_bias_table
from p3achygo_tpu_torch.mcts.gumbel import (EvalFn, GumbelResult, SearchParams,
                                            gumbel, search_root)
from p3achygo_tpu_torch.mcts.puct import PuctParams, search_root_puct

# gumbel_visits_study.cc:87-92.
GROUND_TRUTH_VISITS = 10000
STUDY_K = 16
DEFAULT_N_VALUES = (64, 100, 150, 200, 300, 400, 800)


def states_from_examples(examples: Sequence[dict], device="cuda") -> GoState:
    """A batch of GoStates on `device` from decoded training examples.

    Mirrors BuildBoard (gumbel_visits_study.cc:158-174): the position is
    rebuilt from the raw stones array (chains and hash recomputed by
    from_stones), last_moves/color/komi restored from the example."""
    dev = torch.device(device)
    stones = np.stack([np.frombuffer(ex["board"], np.int8) for ex in examples])
    last_moves = np.stack([np.frombuffer(ex["last_moves"], np.int16).astype(np.int32)
                           for ex in examples])
    colors = np.array([np.frombuffer(ex["color"], np.int8)[0] for ex in examples],
                      np.int8)
    komis = np.array([float(ex["komi"][0]) for ex in examples], np.float32)
    states = from_stones(stones, torch.from_numpy(komis).to(dev),
                         torch.from_numpy(colors).to(dev), device=dev)
    return states._replace(last_moves=torch.from_numpy(last_moves).to(dev))


def compute_kld(target: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """ComputeKLD (gumbel.cc:183-193): sum target*log(target/(prior+eps))
    over target>0 entries. Batched: [B, 362] x [B, 362] -> [B]."""
    eps = 1e-10
    term = np.where(target > 0.0,
                    target * np.log(np.maximum(target, eps) / (prior + eps)), 0.0)
    # KLD >= 0 by definition; float error (bf16-stored priors) can leave
    # a ~1e-8 negative residue when target == prior.
    return np.maximum(term.sum(axis=-1), 0.0)


def _stats(vals: np.ndarray) -> Dict[str, float]:
    """mean/p75/p95/max (gumbel_visits_study.cc:318-339)."""
    v = np.sort(np.asarray(vals, np.float64))
    if v.size == 0:
        return {"mean": 0.0, "p75": 0.0, "p95": 0.0, "max": 0.0}

    def pct(p):
        idx = p * (v.size - 1)
        lo = int(idx)
        hi = min(lo + 1, v.size - 1)
        return float(v[lo] + (idx - lo) * (v[hi] - v[lo]))

    return {"mean": float(v.mean()), "p75": pct(0.75), "p95": pct(0.95),
            "max": float(v[-1])}


def _empirical_dist(child_visits: np.ndarray) -> np.ndarray:
    """Normalized root visit distribution (EmpiricalVisitDist,
    gumbel_visits_study.cc:244-256)."""
    total = child_visits.sum(axis=-1, keepdims=True)
    return np.where(total > 0, child_visits / np.maximum(total, 1), 0.0)


def _study_puct(n: int, max_depth: int) -> PuctParams:
    """PUCT config for --use_gumbel=false (kStudyPuctParams,
    gumbel_visits_study.cc:258-265; p_opt_weight not exposed)."""
    return PuctParams(n=n, root_fpu=0.1, enable_var_scaling=True,
                      var_scale_prior_visits=10, root_selection="lcb",
                      max_depth=max_depth)


def _result(out) -> GumbelResult:
    """search_root returns (result[, tree][, bias_table]); the result
    leads. GumbelResult is itself a tuple, so test for it first."""
    return out if isinstance(out, GumbelResult) else out[0]


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_visits_study(eval_fn: EvalFn, states: GoState,
                     n_values: Sequence[int] = DEFAULT_N_VALUES,
                     gt_n: int = GROUND_TRUTH_VISITS,
                     k: int = STUDY_K,
                     seed_visits: int = 30,
                     use_gumbel: bool = True,
                     bias_lambda: float = 0.3,
                     bias_alpha: float = 0.8,
                     max_depth: int = 32,
                     seed: int = 0,
                     gumbel_noise: Optional[torch.Tensor] = None) -> Dict:
    """Run the study over one batch of positions; returns the report dict.

    The root noise of every Gumbel search is `gumbel_noise` ([B, 362]
    standard Gumbel), or one draw from a generator on the boards' device
    seeded `seed`. Report: {"prior": stats, "per_n": [{"n", "kld_gt":
    stats, "kld_prior": stats, "nats_per_visit"}, ...], "gt_best",
    "n_best"}."""
    B = states.stones.shape[0]
    dev = states.stones.device
    if use_gumbel and gumbel_noise is None:
        gumbel_noise = gumbel((B, NUM_MOVES), torch.Generator(device=dev).manual_seed(seed),
                              dev)

    def bias_table():
        return make_bias_table(B, device=dev) if bias_lambda > 0 else None

    if use_gumbel:
        gt_params = SearchParams(n=gt_n, k=k, max_depth=max_depth,
                                 bias_lambda=bias_lambda, bias_alpha=bias_alpha)
        gt_res = _result(search_root(states, eval_fn, gt_params, gumbel_noise=gumbel_noise,
                                     bias_table=bias_table()))
        gt_pi = _np(gt_res.pi_improved)
    else:
        gt_res = search_root_puct(states, eval_fn, _study_puct(gt_n, max_depth))
        gt_pi = _empirical_dist(_np(gt_res.root_child_visits).astype(np.float64))
    prior = _np(gt_res.root_priors)
    gt_best = _np(gt_res.mcts_move)

    kld_prior = compute_kld(gt_pi, prior)
    prior_stats = _stats(kld_prior)

    per_n: List[Dict] = []
    n_best: Dict[int, np.ndarray] = {}
    for n in n_values:
        if use_gumbel:
            seed_tree = None
            cap = 0
            if seed_visits > 0:
                pp = PuctParams(n=seed_visits, root_selection="lcb", max_depth=max_depth)
                _, seed_tree = search_root_puct(states, eval_fn, pp, return_tree=True)
                cap = seed_tree.n.shape[1]
            np_params = SearchParams(n=n, k=k, max_depth=max_depth,
                                     bias_lambda=bias_lambda, bias_alpha=bias_alpha)
            # The ground truth's noise => the same top-K actions (the fixed
            # pos_seed of gumbel_visits_study.cc:477-481).
            res = _result(search_root(states, eval_fn, np_params, init_tree=seed_tree,
                                      reuse_capacity=cap, gumbel_noise=gumbel_noise,
                                      bias_table=bias_table()))
            pi_n = _np(res.pi_improved)
        else:
            res = search_root_puct(states, eval_fn, _study_puct(n, max_depth))
            pi_n = _empirical_dist(_np(res.root_child_visits).astype(np.float64))
        kld_gt = compute_kld(gt_pi, pi_n)
        kld_pd = compute_kld(pi_n, prior)
        s = _stats(kld_gt)
        per_n.append({
            "n": n,
            "kld_gt": s,
            "kld_prior": _stats(kld_pd),
            "nats_per_visit": (prior_stats["mean"] - s["mean"]) / n,
        })
        n_best[n] = _np(res.mcts_move)

    return {
        "examples": B,
        "mode": "gumbel" if use_gumbel else "puct",
        "gt_n": gt_n,
        "k": k,
        "seed_visits": seed_visits,
        "prior": prior_stats,
        "per_n": per_n,
        "gt_best": gt_best,
        "n_best": n_best,
    }


def format_report(report: Dict) -> str:
    """Render the summary table (gumbel_visits_study.cc:534-555)."""
    lines = ["", "Visit Count Study"]
    if report["mode"] == "gumbel":
        lines.append(
            f"Mode:         Gumbel (GT: N={report['gt_n']} "
            f"K={report['k']}, seed: {report['seed_visits']} PUCT visits)")
    else:
        lines.append(
            f"Mode:         PUCT (GT: N={report['gt_n']} fpu=0.1, "
            "empirical visit dist)")
    lines.append(f"Examples:     {report['examples']}")
    p = report["prior"]
    lines.append("")
    lines.append(
        f"KLD(GT, prior) -- mean: {p['mean']:.5f}  p75: {p['p75']:.5f}  "
        f"p95: {p['p95']:.5f}  max: {p['max']:.5f}")
    lines.append("")
    lines.append(f"{'N':<8}  {'KLD(GT||N)':<12}  {'KLD(N||prior)':<13}  "
                 f"{'nats/visit':<12}")
    lines.append(f"{'-'*8}  {'-'*12}  {'-'*13}  {'-'*12}")
    for row in report["per_n"]:
        lines.append(f"{row['n']:<8}  {row['kld_gt']['mean']:<12.5f}  "
                     f"{row['kld_prior']['mean']:<13.5f}  "
                     f"{row['nats_per_visit']:<12.6f}")
    return "\n".join(lines)


def load_chunk_examples(chunk_path: str, num_examples: int) -> List[dict]:
    """Read + decode up to num_examples examples from a tfrecord chunk."""
    from p3achygo_tpu_torch.data.example import decode_example
    from p3achygo_tpu_torch.data.tfrecord import read_records
    out = []
    for rec in read_records(chunk_path):
        try:
            out.append(decode_example(rec))
        except (ValueError, IndexError, struct.error):
            continue  # skip unparseable records (the study's main loop does)
        if len(out) >= num_examples:
            break
    return out
