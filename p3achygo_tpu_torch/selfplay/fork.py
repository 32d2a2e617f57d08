"""Fork manager: position-diversity sampling for self-play (port of
p3achygo_tpu/selfplay/fork.py: the host logic is a copy; the evaluator is
batch-first torch).

Mirrors cc/selfplay/fork_manager.h:39-662 (fork kinds, trapezoidal /
exponential move sampling, best-of-N / policy / uniform alternative-move
sampling, double-sampling, score-neutral komi adjustment, end-of-game
regret scoring feeding the reuse buffer).

TPU redesign: the reference forks DURING the game, issuing on-demand n=1
NN evaluations from each selfplay thread (fork_manager.h:524-539
EvalBoard). Here games run lockstep on the device and forking is deferred
to HARVEST time: each finished game's recorded per-move arrays (board
before move, search value/score, NN value, visit eligibility) drive the
same sampling decisions, and all NN evaluations a harvest batch needs are
collected into a few batched forward passes (ForkEvaluator) instead of
per-thread single evals. Semantics and constants are mirrored; the only
timing change is WHEN fork positions enter the reuse buffer (end of game
instead of mid-game), which the lockstep loop already implies for every
buffer interaction.

Deviation: is_eligible uses ~sampled_raw (raw-policy moves discard the
search) as a proxy for the reference's per-move played-edge visit count
(move_n != 0, self_play_thread.cc:694-696).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BLACK, NUM_MOVES
from p3achygo_tpu_torch.game.board import GoState, from_stones, legal_mask_batch, step
from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
from p3achygo_tpu_torch.selfplay.reuse import (
    FMB_FORCE_FULL_SEARCH,
    FMB_PLAY,
    FMB_SAMPLE,
    InitState,
)

# ForkKind (cc/selfplay/fork_kind.h).
EARLY = "early"
LATE = "late"
SAMPLE_T1 = "sample_t1"
SAMPLE_T2 = "sample_t2"
SAMPLE_UNIFORM = "sample_uniform"
REGRET = "regret"
UNIFORM = "uniform"

# Baseline conditional probabilities at reuse_prob=0.2
# (fork_manager.h:42 kBaseProbs).
_BASE_PROBS = {EARLY: 0.0, LATE: 0.09, SAMPLE_T1: 0.0, SAMPLE_T2: 0.0,
               SAMPLE_UNIFORM: 0.01}


@dataclasses.dataclass(frozen=True)
class ForkParams:
    """Fork-kind probabilities (fork_manager.h:44-96)."""

    early_fork_prob: float = _BASE_PROBS[EARLY]
    late_fork_prob: float = _BASE_PROBS[LATE]
    sample_policy_t1_prob: float = _BASE_PROBS[SAMPLE_T1]
    sample_policy_t2_prob: float = _BASE_PROBS[SAMPLE_T2]
    sample_random_prob: float = _BASE_PROBS[SAMPLE_UNIFORM]
    regret_prob: float = 0.0
    force_full_search_prob: float = 0.25
    double_sample_prob: float = 0.5

    @property
    def uniform_prob(self) -> float:
        return 1.0 - (self.early_fork_prob + self.late_fork_prob
                      + self.sample_policy_t1_prob
                      + self.sample_policy_t2_prob + self.sample_random_prob
                      + self.regret_prob)

    @staticmethod
    def for_reuse(reuse_prob: float) -> "ForkParams":
        """Rescale fork probabilities to keep per-game fork rates constant
        across reuse fractions (Params::ForReuse, fork_manager.h:65-96)."""
        base_reuse = 0.2
        scale = 0.0 if reuse_prob == 0 else base_reuse / reuse_prob
        probs = {k: v * scale for k, v in _BASE_PROBS.items()}
        fork_sum = sum(probs.values())
        if fork_sum >= 1.0:
            down = 0.9 / fork_sum
            probs = {k: v * down for k, v in probs.items()}
        return ForkParams(
            early_fork_prob=probs[EARLY], late_fork_prob=probs[LATE],
            sample_policy_t1_prob=probs[SAMPLE_T1],
            sample_policy_t2_prob=probs[SAMPLE_T2],
            sample_random_prob=probs[SAMPLE_UNIFORM], regret_prob=0.0)


# Trapezoidal fork-move distribution (fork_manager.h:113-135):
# uniform on [10, 100), linearly decaying to 0 at 250.
_FLAT_START, _FLAT_END, _MV_MAX = 10, 100, 250
_FLAT_MASS = 0.6


def sample_trapezoidal(rng: np.random.Generator) -> int:
    flat_density = _FLAT_MASS / (_FLAT_END - _FLAT_START)
    tail_start = 2.0 * (1.0 - _FLAT_MASS) / (_MV_MAX - _FLAT_END)
    tail_slope = tail_start / (_MV_MAX - _FLAT_END)
    p = rng.uniform()
    cum = 0.0
    for mv in range(_FLAT_START, _MV_MAX):
        cum += (flat_density if mv < _FLAT_END
                else tail_start - tail_slope * (mv - _FLAT_END))
        if p <= cum:
            return mv
    return _MV_MAX


@dataclasses.dataclass
class ForkPlan:
    """Per-game fork decision, sampled at game start
    (ForkManager ctor, fork_manager.h:110-168)."""

    kind: str
    fork_mv: int  # target move number (-1 for regret/unused)


def sample_fork_plan(rng: np.random.Generator, params: ForkParams) -> ForkPlan:
    p = rng.uniform()
    cum = params.early_fork_prob
    if p < cum:
        return ForkPlan(EARLY, int(round(rng.exponential() * 9)))
    cum += params.late_fork_prob
    if p < cum:
        return ForkPlan(LATE, sample_trapezoidal(rng))
    cum += params.sample_policy_t1_prob
    if p < cum:
        return ForkPlan(SAMPLE_T1, sample_trapezoidal(rng))
    cum += params.sample_policy_t2_prob
    if p < cum:
        return ForkPlan(SAMPLE_T2, sample_trapezoidal(rng))
    cum += params.sample_random_prob
    if p < cum:
        return ForkPlan(SAMPLE_UNIFORM, sample_trapezoidal(rng))
    cum += params.regret_prob
    if p < cum:
        return ForkPlan(REGRET, -1)
    return ForkPlan(UNIFORM, sample_trapezoidal(rng))


@dataclasses.dataclass
class GameRecord:
    """Per-move arrays of one finished game, harvested from GameBuffer."""

    stones: np.ndarray  # int8[L, 361] board BEFORE each move
    last_moves: np.ndarray  # int16[L, 5]
    to_move: np.ndarray  # int8[L]
    move: np.ndarray  # int16[L]
    nn_value: np.ndarray  # f32[L] root NN utility (nn_util_est)
    mcts_value: np.ndarray  # f32[L] post-search root outcome (q_post)
    mcts_score: np.ndarray  # f32[L] root score estimate
    eligible: np.ndarray  # bool[L] move had MCTS visits
    komi: float
    winner: int  # +1 black, -1 white
    init_mv_num: int = 0  # starting move number (restarts)


@dataclasses.dataclass
class _Position:
    stones: np.ndarray
    last_moves: np.ndarray
    to_move: int
    komi: float


def _shift_last_moves(last_moves: np.ndarray, move: int) -> np.ndarray:
    out = np.empty_like(last_moves)
    out[:-1] = last_moves[1:]
    out[-1] = move
    return out


def compute_komi_delta(fork_score: float, color: int) -> float:
    """Komi delta toward a score-neutral fork (fork_manager.h:513-521):
    fork_score is from `color`'s perspective; komi is added to White."""
    return float(np.round(fork_score if color == 1 else -fork_score))


def regret_candidates(rec: GameRecord,
                      rng: np.random.Generator) -> List[Tuple[float, int]]:
    """Per-move regret scores (FinalizeGame, fork_manager.h:549-482..540).

    Returns accepted (regret_score, move_num) pairs after the winrate /
    move-number attenuation coin flips; caller takes the max.
    """
    ema_decay = 0.94
    horizon = 50
    L = len(rec.move)
    out: List[Tuple[float, int]] = []
    for m in range(L):
        if not rec.eligible[m]:
            continue
        color = int(rec.to_move[m])
        game_outcome = 1.5 if rec.winner == color else -1.5
        mcts_value = float(rec.mcts_value[m])
        nn_value = float(rec.nn_value[m])

        future_ema, weight, weight_sum = 0.0, 1.0, 0.0
        for k in range(1, horizon):
            j = m + k
            if j >= L:
                break
            weight *= ema_decay
            if not rec.eligible[j]:
                continue
            fv = float(rec.mcts_value[j])
            if int(rec.to_move[j]) != color:
                fv = -fv
            future_ema += weight * fv
            weight_sum += weight
        if weight_sum > 0:
            future_ema /= weight_sum

        smoothed = (mcts_value + future_ema * ema_decay) / (1.0 + ema_decay)
        nn_miseval = abs(nn_value - smoothed)
        wr_drift = abs(mcts_value - future_ema)
        value_error = max(smoothed - game_outcome - abs(game_outcome), 0.0)
        score = nn_miseval**2 + wr_drift**2 + value_error**2

        av = abs(mcts_value)
        if av > 0.9:
            wr_weight = 0.0
        elif av <= 0.5:
            wr_weight = 1.0
        else:
            wr_weight = (0.9 - av) / (0.9 - 0.5)
        abs_mv = rec.init_mv_num + m
        offset = float(np.clip(abs_mv - 100, 0, 100))
        mv_weight = float(np.clip((1.0 - offset / 100.0) ** 1.2, 0.0, 1.0))
        if rng.uniform() >= wr_weight * mv_weight:
            continue
        out.append((score, m))
    return out


class ForkEvaluator:
    """Batched device helper for fork sampling.

    Builds the n host positions as one batch of states on `device` and runs
    legality + NN eval (or one `step`) over them in chunks of `batch`,
    returning numpy results; it replaces the reference's per-thread n=1
    GumbelEvaluator calls (fork_manager.h:524-539). The network comes with
    each call (`evaluate(model, ...)`), so golden-weight updates need
    nothing rebuilt.
    """

    def __init__(self, batch: int = 64, device="cuda"):
        self.batch = batch
        self.device = torch.device(device)

    def _states(self, positions: Sequence[_Position]) -> GoState:
        """from_stones, then last moves and the side to move, move 0."""
        st = from_stones(np.stack([p.stones for p in positions]),
                         torch.tensor([p.komi for p in positions], dtype=torch.float32),
                         BLACK, device=self.device)
        lm = np.stack([p.last_moves for p in positions]).astype(np.int32)
        color = np.array([p.to_move for p in positions], np.int8)
        return st._replace(last_moves=torch.from_numpy(lm).to(self.device),
                           to_move=torch.from_numpy(color).to(self.device))

    def _chunks(self, n: int):
        return (slice(i, min(i + self.batch, n)) for i in range(0, n, self.batch))

    def evaluate(self, model, positions: Sequence[_Position]):
        """-> (legal [n,362] bool, probs [n,362], value [n], score [n])."""
        if not positions:
            z = np.zeros((0,))
            return (np.zeros((0, NUM_MOVES), bool),
                    np.zeros((0, NUM_MOVES), np.float32), z, z)
        fn = make_eval_fn(model)
        outs = []
        for sl in self._chunks(len(positions)):
            states = self._states(positions[sl])
            ev = fn(states)
            outs.append((legal_mask_batch(states), torch.exp(ev.log_priors),
                         ev.outcome_value, ev.score_est))
        return tuple(torch.cat(parts).cpu().numpy() for parts in zip(*outs))

    def play(self, positions: Sequence[_Position],
             moves: Sequence[int]) -> List[_Position]:
        """Apply one move per position (captures handled on device)."""
        if not positions:
            return []
        stones, colors = [], []
        for sl in self._chunks(len(positions)):
            mv = torch.as_tensor(np.asarray(moves[sl], np.int64), device=self.device)
            new, _ = step(self._states(positions[sl]), mv)
            stones.append(new.stones)
            colors.append(new.to_move)
        stones = torch.cat(stones).cpu().numpy()
        colors = torch.cat(colors).cpu().numpy()
        return [_Position(stones=stones[i],
                          last_moves=_shift_last_moves(p.last_moves, int(moves[i])),
                          to_move=int(colors[i]), komi=p.komi)
                for i, p in enumerate(positions)]


@dataclasses.dataclass
class _ForkJob:
    kind: str
    pos: _Position  # P: board before the fork move
    color: int  # color to move at P
    move_num: int
    alt_move: int = -1
    cand_moves: Optional[List[int]] = None  # EARLY/LATE candidates
    double: bool = False
    pos1: Optional[_Position] = None  # P' after alt_move
    alt_move2: int = -1
    pos2: Optional[_Position] = None  # P'' after alt_move2


class ForkManager:
    """Harvest-time fork sampling over finished games.

    process_game() stages the per-game fork decision; flush() executes the
    staged NN work in a few batched device rounds and pushes the resulting
    InitStates into the reuse buffer. Call flush() once per harvest.
    """

    def __init__(self, params: ForkParams, buffer, evaluator: ForkEvaluator,
                 seed: int = 0):
        self.params = params
        self.buffer = buffer
        self.evaluator = evaluator
        self._rng = np.random.default_rng(seed)
        self._jobs: List[_ForkJob] = []
        self.counts = {k: 0 for k in (EARLY, LATE, SAMPLE_T1, SAMPLE_T2,
                                      SAMPLE_UNIFORM, REGRET, UNIFORM)}

    def new_plan(self, is_fresh: bool) -> Optional[ForkPlan]:
        """Sample a fork plan for a new game; None for restarted games
        (started_from_forced_search, fork_manager.h:33-36)."""
        if not is_fresh:
            return None
        return sample_fork_plan(self._rng, self.params)

    # ---------------- per-game processing ----------------
    def process_game(self, plan: Optional[ForkPlan], rec: GameRecord):
        if plan is None:
            return
        rng = self._rng
        L = len(rec.move)
        if plan.kind == UNIFORM:
            self._process_uniform(rec, rng)
            return
        if plan.kind == REGRET:
            self._process_regret(rec, rng)
            return
        m = plan.fork_mv
        if m < 0 or m >= L:
            return
        pos = _Position(stones=rec.stones[m].copy(),
                        last_moves=rec.last_moves[m].astype(np.int32).copy(),
                        to_move=int(rec.to_move[m]), komi=rec.komi)
        self._jobs.append(_ForkJob(kind=plan.kind, pos=pos,
                                   color=int(rec.to_move[m]),
                                   move_num=rec.init_mv_num + m))

    def _process_uniform(self, rec: GameRecord, rng):
        """kUniform: restart from a current-game position with optional
        score-neutral komi (fork_manager.h:183-210 + FinalizeGame pick)."""
        sampled: List[InitState] = []
        for m in range(len(rec.move)):
            v = abs(float(rec.mcts_value[m]))
            atten = 1.0 - float(np.clip((v - 0.5) / (0.9 - 0.5), 0.0, 1.0))
            if rng.uniform() > 0.05 * atten:
                continue
            color = int(rec.to_move[m])
            score = float(rec.mcts_score[m])
            komi = rec.komi
            p_adjust = float(np.arctan(abs(score) / 3.0) * 2.0 / np.pi)
            if rng.uniform() < p_adjust:
                komi = rec.komi + compute_komi_delta(score, color)
            sampled.append(InitState(
                stones=rec.stones[m].copy(),
                last_moves=rec.last_moves[m].copy(),
                to_move=color, move_num=rec.init_mv_num + m, komi=komi,
                first_move_behavior=FMB_SAMPLE, kind="fork_" + UNIFORM))
        if sampled:
            pick = sampled[int(rng.integers(len(sampled)))]
            self.buffer.add(pick, 0.0)
            self.counts[UNIFORM] += 1

    def _process_regret(self, rec: GameRecord, rng):
        cands = regret_candidates(rec, rng)
        if not cands:
            return
        score, m = max(cands)
        fmb = (FMB_FORCE_FULL_SEARCH
               if rng.uniform() < self.params.force_full_search_prob
               else FMB_SAMPLE)
        self.buffer.add(InitState(
            stones=rec.stones[m].copy(), last_moves=rec.last_moves[m].copy(),
            to_move=int(rec.to_move[m]), move_num=rec.init_mv_num + m,
            komi=rec.komi, first_move_behavior=fmb, kind="fork_" + REGRET,
            regret=score), score)
        self.counts[REGRET] += 1

    # ---------------- batched flush ----------------
    def flush(self, model) -> int:
        """Run the staged fork jobs' device rounds with `model` (the golden
        network); returns forks added."""
        jobs, self._jobs = self._jobs, []
        if not jobs:
            return 0
        rng = self._rng
        ev = self.evaluator

        # Round 1: evaluate every fork position P (legal mask + policy).
        legal, probs, _, _ = ev.evaluate(model, [j.pos for j in jobs])

        # Choose the alternative move (sample_alt_move,
        # fork_manager.h:318-336); EARLY/LATE stage candidate children.
        child_jobs: List[Tuple[int, int]] = []  # (job idx, cand move)
        for i, j in enumerate(jobs):
            lg = np.flatnonzero(legal[i])
            if lg.size == 0:
                j.alt_move = -1
                continue
            if j.kind == SAMPLE_UNIFORM:
                j.alt_move = int(rng.choice(lg))
            elif j.kind in (SAMPLE_T1, SAMPLE_T2):
                w = probs[i][lg]
                if j.kind == SAMPLE_T2:
                    w = np.sqrt(w)
                s = w.sum()
                j.alt_move = (int(rng.choice(lg)) if s <= 0
                              else int(rng.choice(lg, p=w / s)))
            else:  # EARLY / LATE best-of-N (fork_manager.h:289-316)
                take = (int(rng.integers(3, 13)) if j.kind == EARLY
                        else int(rng.integers(5, 37)))
                take = min(take, lg.size)
                j.cand_moves = list(rng.choice(lg, size=take, replace=False))
                for a in j.cand_moves:
                    child_jobs.append((i, int(a)))

        # Round 2: evaluate candidate children; best = argmin of the
        # opponent's utility on the resulting position.
        if child_jobs:
            parents = [jobs[i].pos for i, _ in child_jobs]
            moves = [a for _, a in child_jobs]
            children = ev.play(parents, moves)
            _, _, child_value, _ = ev.evaluate(model, children)
            best: dict = {}
            for (i, a), v in zip(child_jobs, child_value):
                if i not in best or v < best[i][0]:
                    best[i] = (float(v), a)
            for i, (_, a) in best.items():
                jobs[i].alt_move = a

        live = [j for j in jobs if j.alt_move >= 0]
        if not live:
            return 0

        # P' = play(P, alt); evaluate P' for the komi adjustment and (for
        # double-sampled jobs) the second alternative move's policy.
        pos1 = ev.play([j.pos for j in live], [j.alt_move for j in live])
        for j, p1 in zip(live, pos1):
            j.pos1 = p1
            j.double = rng.uniform() < self.params.double_sample_prob
        legal1, probs1, _, score1 = ev.evaluate(model,
                                                [j.pos1 for j in live])

        double_jobs: List[_ForkJob] = []
        for idx, j in enumerate(live):
            if not j.double:
                continue
            lg = np.flatnonzero(legal1[idx])
            if lg.size == 0:
                j.double = False
                continue
            if j.kind == SAMPLE_UNIFORM:
                j.alt_move2 = int(rng.choice(lg))
            elif j.kind in (SAMPLE_T1, SAMPLE_T2):
                w = probs1[idx][lg]
                if j.kind == SAMPLE_T2:
                    w = np.sqrt(w)
                s = w.sum()
                j.alt_move2 = (int(rng.choice(lg)) if s <= 0
                               else int(rng.choice(lg, p=w / s)))
            else:
                # EARLY/LATE double-sample uses the same best-of-N at P'
                # in the reference; one batched argmax over the policy is
                # the cheap stand-in (documented deviation).
                j.alt_move2 = int(lg[np.argmax(probs1[idx][lg])])
            double_jobs.append(j)

        # P'' for double-sampled jobs + their komi eval.
        if double_jobs:
            pos2 = ev.play([j.pos1 for j in double_jobs],
                           [j.alt_move2 for j in double_jobs])
            for j, p2 in zip(double_jobs, pos2):
                j.pos2 = p2
            _, _, _, score2 = ev.evaluate(model,
                                          [j.pos2 for j in double_jobs])
        score2_by_id = {id(j): s for j, s in zip(double_jobs, score2)} \
            if double_jobs else {}

        added = 0
        for idx, j in enumerate(live):
            fmb = (FMB_FORCE_FULL_SEARCH
                   if (j.kind == SAMPLE_UNIFORM
                       or rng.uniform() < self.params.force_full_search_prob)
                   else FMB_PLAY)
            if j.double and j.pos2 is not None:
                # Double-sample: add P'' (same side to move as P);
                # ComputeAdjKomi with fork_color == orig_color.
                fork_score = float(score2_by_id[id(j)])
                adj_komi = j.pos.komi + compute_komi_delta(fork_score,
                                                           j.color)
                komi = adj_komi if rng.uniform() < 0.5 else j.pos.komi
                st = InitState(
                    stones=j.pos2.stones, last_moves=j.pos2.last_moves,
                    to_move=j.color, move_num=j.move_num + 2, komi=komi,
                    first_move_behavior=fmb, kind="fork_" + j.kind)
            else:
                # Single-sample: add P' (opponent to move); score from the
                # opponent's perspective is negated for orig color.
                fork_score = -float(score1[idx])
                komi = j.pos.komi + compute_komi_delta(fork_score, j.color)
                st = InitState(
                    stones=j.pos1.stones, last_moves=j.pos1.last_moves,
                    to_move=j.pos1.to_move, move_num=j.move_num + 1,
                    komi=komi, first_move_behavior=fmb,
                    kind="fork_" + j.kind)
            self.buffer.add(st, 0.0)
            self.counts[j.kind] += 1
            added += 1
        return added
