"""The comparison that decides `correct`: what the timed path produced
against the plain reference (`portbench/reference/`).

Three layers are judged, on samples drawn from the seed:
- board and rules: the sampled boards' games are replayed from the start
  positions the benchmark made, each recorded move judged legal or not by
  the reference engine (superko included) and the stones after it, the
  finished flags and the resets compared exactly (`rules_mismatches`);
- the network: leaf batches that search sent to the eval function in the
  window, their inputs evaluated again by the float32 reference: a row's
  widest gap of a log-prior, and its gap of the value, taken at the
  widest row (`leaf_logp_gap`, `leaf_value_gap`) and at the rows' 75th
  percentile (`leaf_logp_q75`, `leaf_value_q75`);
- the search: each recorded target is one that a search call returned,
  the call searched with one of the traffic's (n, k) on a tier of the
  reference's size, it added below the root the visits the schedule gives
  for the root's legal moves, and the target is the completed-Q improved
  policy (`reference.search.improved_policy`) of the root as the
  program's tree holds it: its priors, child visits and Q, and utility
  (`search_mismatches`, exact); and no target puts mass on a move the
  reference calls illegal (`pi_illegal_mass`). See `search_gaps`.
Each cell's limits/<cell>.json names the numbers it compares and their
limits; the others are logged beside them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench.reference import rules
from portbench.reference import search as ref_search
from portbench.reference.network import Network, float32_exact


def _cheap_illegal(stones: np.ndarray, to_move: np.ndarray, ko: np.ndarray) -> np.ndarray:
    """bool[N, 362]: `rules.Game.cheap_illegal` of N positions at once."""
    N = stones.shape[0]
    libs = rules.batch_point_liberties(stones)
    nbr = rules._NBR_IDX
    col = np.concatenate([stones, np.full((N, 1), 9, np.int8)], axis=1)[:, nbr]
    lib = np.concatenate([libs, np.zeros((N, 1), np.int32)], axis=1)[:, nbr]
    c = to_move[:, None, None]
    ok = ((col == rules.EMPTY) | ((col == c) & (lib >= 2)) | ((col == -c) & (lib == 1))).any(axis=2)
    bad = np.zeros((N, rules.PASS + 1), bool)
    bad[:, :rules.POINTS] = (stones != rules.EMPTY) | ~ok
    has_ko = ko >= 0
    bad[np.nonzero(has_ko)[0], ko[has_ko]] = True
    return bad


def replay(events: List[tuple], start_stones: np.ndarray, start_to_move: np.ndarray,
           max_len: int) -> Tuple[int, int, List[str], dict]:
    """Replays the sampled boards' games through the reference engine.
    Returns (board-plies and resets compared, mismatches, the first causes,
    the root positions of the moves judged, with their recorded targets,
    the root's own utility and what the ply's search calls hold of it)."""
    K = start_stones.shape[0]
    games = [rules.Game(start_stones[i], start_to_move[i], max_len) for i in range(K)]
    broken = [False] * K
    compared, bad, causes = 0, 0, []
    roots = {k: [] for k in ("stones", "to_move", "last_moves", "ko", "pi", "v_mix", "matched",
                             "n", "k", "priors", "visits", "q", "pre")}

    def fail(i, why):
        nonlocal bad
        bad += 1
        broken[i] = True
        if len(causes) < 8:
            causes.append(f"board {i}: {why}")

    for ev in events:
        if ev[0] == "ply":
            _, fin, mv, pi, after, nn_q, found = ev
            for i, g in enumerate(games):
                if broken[i]:
                    continue
                compared += 1
                if g.over():
                    if not fin[i] or not np.array_equal(after[i], g.stones):
                        fail(i, "a finished game moved on or was not seen as finished")
                    continue
                if fin[i]:
                    fail(i, "an unfinished game was treated as finished")
                    continue
                m = int(mv[i])
                why = g.why_illegal(m)
                if why:
                    fail(i, f"move {m} illegal ({why}) at move {g.move_count}")
                    continue
                roots["stones"].append(g.stones.copy())
                roots["to_move"].append(g.to_move)
                roots["last_moves"].append(list(g.last_moves))
                roots["ko"].append(g.ko)
                roots["pi"].append(pi[i])
                roots["v_mix"].append(nn_q[i])
                for key in ("matched", "n", "k", "priors", "visits", "q", "pre"):
                    roots[key].append(found[key][i])
                g.play(m)
                if not np.array_equal(after[i], g.stones):
                    fail(i, f"stones after move {m} differ at {int((after[i] != g.stones).sum())} points")
        else:
            _, done, after = ev
            for i, g in enumerate(games):
                if broken[i]:
                    continue
                compared += 1
                if bool(done[i]) != g.over():
                    fail(i, "the reset's finished flag differs")
                    continue
                if g.over():
                    games[i] = rules.Game(np.zeros(rules.POINTS, np.int8), rules.BLACK, max_len)
                if not np.array_equal(after[i], games[i].stones):
                    fail(i, "the stones after the reset differ")
    out = {k: np.array(v) for k, v in roots.items()}
    return compared, bad, causes, out


def leaf_gaps(net: Network, samples: List[tuple]) -> Dict[str, float]:
    """The leaf batches' outputs against the reference's on their inputs:
    the widest gap over all rows, and the 75th percentile over rows (a
    steadier number that a quarter of the rows or more must move)."""
    if not samples:
        return {"rows": 0}
    cat = [torch.cat([s[j].detach().cpu() for s in samples]) for j in range(9)]
    stones, to_move, last, komi = (t.numpy() for t in cat[:4])
    ref = net.evaluate(stones, to_move, last, komi)
    got = [t.float().to(ref.log_priors.device) for t in cat[4:]]
    logp_gap = (got[0] - ref.log_priors).abs().amax(dim=1)
    value_gap = (got[1] - ref.value).abs()
    return {"rows": int(stones.shape[0]), "leaf_logp_gap": float(logp_gap.max()),
            "leaf_logp_q75": float(torch.quantile(logp_gap, 0.75)),
            "leaf_value_gap": float(value_gap.max()),
            "leaf_value_q75": float(torch.quantile(value_gap, 0.75)),
            "leaf_score_gap": float((got[2] - ref.score_est).abs().max())}


# A target and the improved policy of its root's tree differ by float32
# round-off, a total variation of ~1e-6; a search fault moves it by 1e-3 or
# more (in the fault test: half the simulations 3.4e-3, half the c_visit
# 0.13, the prior as the target 0.99).
TREE_TV = 1e-4


def search_gaps(net: Network, roots: dict, tr: dict, limit: int, rng) -> Dict[str, float]:
    """The search's numbers on the replayed roots. Over all of them:
    `search_mismatches`, the roots whose target no search call returned,
    or whose call searched with an (n, k) that is neither of the traffic's,
    or added below the root other visits than `reference.search.visits_added`
    gives for the root's legal moves, or whose target is not, to within
    `TREE_TV` in total variation, the improved policy of the root as the
    program's tree holds it (priors, child visits and Q, utility) with the
    traffic's schedule, c_visit and c_scale. On at most `limit` of them drawn
    by `rng`: `pi_illegal_mass`, the most mass a target puts on moves the
    reference calls illegal (0 by construction: search masks them before
    its softmax). Logged, not compared (PERF.md: the tree's bfloat16 priors
    set it for the program and its int8 control alike): the total variation
    between a target and the improved policy worked out from the
    reference's own priors, rounded to bfloat16 as the tree keeps them
    (`pi_target_tv_q75`, and unrounded `pi_target_tv_f32_q75`)."""
    R = len(roots["pi"])
    if R == 0:
        return {"positions": 0}
    r = {k: np.array(v) for k, v in roots.items()}
    illegal = _cheap_illegal(r["stones"], r["to_move"].astype(np.int8), r["ko"])
    n_legal = (~illegal).sum(axis=1)
    tiers = {(tr["selected"]["n"], tr["selected"]["k"]), (tr["fast"]["n"], tr["fast"]["k"])}
    known = r["matched"] & np.array([(int(a), int(b)) in tiers for a, b in zip(r["n"], r["k"])])
    added = r["visits"].astype(np.int64).sum(axis=1) - r["pre"]
    want = np.array([ref_search.visits_added(int(a), int(b), int(c)) if ok else -1
                     for a, b, c, ok in zip(r["n"], r["k"], n_legal, known)])
    pi_all = r["pi"].astype(np.float64)
    target = lambda idx, logp, legal: ref_search.improved_policy(
        logp, legal, r["visits"][idx], r["q"][idx], r["v_mix"][idx], r["n"][idx], r["k"][idx],
        tr["c_visit"], tr["c_scale"])
    held = r["priors"].astype(np.float64) > 0
    tree_tv = np.full(R, np.inf)
    pool = np.nonzero(known)[0]
    if pool.size:
        logp_tree = np.log(np.where(held[pool], r["priors"][pool], 1.0))
        tree_tv[pool] = 0.5 * np.abs(pi_all[pool] - target(pool, logp_tree, held[pool])).sum(axis=1)
    sound = known & (added == want) & (tree_tv <= TREE_TV)
    out = {"roots": R, "search_mismatches": float((~sound).sum()),
           "tree_tv_max": float(tree_tv[pool].max()) if pool.size else float("inf"),
           "visits_added_median": float(np.median(added[known])) if pool.size else 0.0}
    if pool.size == 0:
        return {**out, "positions": 0}
    take = np.sort(rng.choice(pool, size=min(limit, pool.size), replace=False))
    pi = pi_all[take]
    ref = net.evaluate(r["stones"][take], r["to_move"][take].astype(np.int8),
                       r["last_moves"][take], np.full(take.shape[0], tr["komi"], np.float32))
    logp = ref.log_priors.double().cpu().numpy()
    stored = ref.log_priors.to(torch.bfloat16).double().cpu().numpy()
    tv = 0.5 * np.abs(pi - target(take, stored, ~illegal[take])).sum(axis=1)
    tv_f32 = 0.5 * np.abs(pi - target(take, logp, ~illegal[take])).sum(axis=1)
    mass = np.where(illegal[take], pi, 0.0).sum(axis=1)
    return {**out, "positions": int(take.shape[0]), "pi_illegal_mass": float(mass.max()),
            "pi_target_tv_q75": float(np.quantile(tv, 0.75)),
            "pi_target_tv_f32_q75": float(np.quantile(tv_f32, 0.75)),
            "pi_sum_err": float(np.abs(pi.sum(axis=1) - 1.0).max())}


def tier_mismatches(events: List[tuple], tr: dict) -> int:
    """Plies whose search calls are not one call of each tier at the
    reference's tier sizes with the traffic's (n, k)."""
    b_sel, b_fast = ref_search.tier_sizes(tr["batch"], tr["selected_share"])
    want = sorted([(tr["selected"]["n"], tr["selected"]["k"], b_sel),
                   (tr["fast"]["n"], tr["fast"]["k"], b_fast)])
    return sum(1 for ev in events if ev[0] == "ply" and sorted(ev[-1]["tiers"]) != want)


NUMBERS = ("rules_mismatches", "search_mismatches", "pi_illegal_mass", "leaf_logp_gap",
           "leaf_logp_q75", "leaf_value_gap", "leaf_value_q75")


def judge(run, events, limits: Dict[str, float], device, log) -> Tuple[bool, int, Dict]:
    """-> (correct, failed, {number: (value, limit)}) for a finished run.
    The numbers compared are those `limits` names; the others are logged."""
    float32_exact()
    tr = run.tr
    net = Network(run.cell["config"], run.params, device)
    compared, bad, causes, roots = replay(events, run.start_stones[run.sampled],
                                          run.start_to_move[run.sampled], tr["max_game_len"])
    for c in causes:
        log(f"check: {c}")
    rng = np.random.default_rng(run.seed + 7)
    leaf = leaf_gaps(net, run.eval_tap.samples)
    sg = search_gaps(net, roots, tr, run.check["pi_positions_max"], rng)
    bad_plies = tier_mismatches(events, tr)
    sg["search_mismatches"] = sg.get("search_mismatches", 0.0) + bad_plies
    log(f"check: {compared} board-plies and resets replayed; leaf rows {leaf.get('rows')}; "
        f"target positions {sg.get('positions')}; plies with other tiers {bad_plies}; "
        f"{leaf}; {sg}")
    values = {"rules_mismatches": float(bad), **leaf, **sg}
    unknown = set(limits) - set(NUMBERS)
    if unknown:
        raise KeyError(f"limits name numbers the check does not make: {sorted(unknown)}")
    numbers = {k: (values.get(k, float("inf")), limits[k]) for k in NUMBERS if k in limits}
    failed = sum(1 for v, lim in numbers.values() if not v <= lim)
    if compared == 0 or leaf.get("rows", 0) == 0 or sg.get("positions", 0) == 0:
        log("check: nothing was compared")
        failed += 1
    return failed == 0, failed, numbers
