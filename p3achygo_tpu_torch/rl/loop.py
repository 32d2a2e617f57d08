"""Full RL generation loop (port of p3achygo_tpu/rl/loop.py; reference
python/rl_loop/train_sp_eval.py:145-487).

Per generation: self-play `games_per_gen` games with the *golden* network
-> train the live model on the replay window -> SWA-average + BN refresh
-> cur-vs-cand eval against golden -> promote iff relative Elo > 0
(train_sp_eval.py:229-233) -> checkpoint model_%04d + live, append
elo_history.txt (train_sp_eval.py:234-238).

Three networks: the live model, which the train step updates in place;
the golden, a module of its own that self-play, the fork evaluator and
the incumbent side of the eval serve, and into which promotion loads the
candidate; and each generation's candidate, a copy holding the SWA
parameters and refreshed BN statistics. All serve the plain model forward
(make_eval_fn(model)), as the JAX loop does.

Randomness: the initial weights from a CPU generator seeded `seed`;
every device draw (Gumbel noise, tier subsets, raw-policy lengths,
augmentation symmetries) from one generator on the device seeded
`seed + 1`; the host decisions from numpy generators seeded as in the JAX
package (replay `seed`, val replay `seed + 3`, restarts and the val split
`seed + 2`, reuse buffer and fork plans `seed`), so they match the JAX
loop's given the same games.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from p3achygo_tpu_torch.constants import BLACK, NOOP_MOVE
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.data.replay import ReplayBuffer
from p3achygo_tpu_torch.eval.harness import EvalConfig, EvalRunner
from p3achygo_tpu_torch.game.board import from_stones, map_state, new_state
from p3achygo_tpu_torch.game.scoring import refresh_pass_alive
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu_torch.mcts.bias import make_bias_table
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs, compute_losses
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.rl.config import (
    RunConfig,
    eval_games_for_gen,
    eval_n_for_gen,
    gumbel_params_for_gen,
)
from p3achygo_tpu_torch.selfplay.book import sample_book_prefix
from p3achygo_tpu_torch.selfplay.fork import ForkEvaluator, ForkManager, ForkParams, GameRecord
from p3achygo_tpu_torch.selfplay.loop import (
    GameBuffer,
    SelfplayConfig,
    final_scores,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step_tiered,
)
from p3achygo_tpu_torch.selfplay.move_sel import calibration_from_dict, default_calibration
from p3achygo_tpu_torch.selfplay.records import finalize_game, game_to_sgf
from p3achygo_tpu_torch.selfplay.reuse import (
    FMB_FORCE_FULL_SEARCH,
    FMB_SAMPLE,
    make_reuse_buffer,
)
from p3achygo_tpu_torch.selfplay.stats import (
    MoveStatsBatch,
    compute_calibration,
    compute_sel_mult_base,
    write_calibration_file,
    write_stats_file,
)
from p3achygo_tpu_torch.train.checkpoint import restore_checkpoint, save_checkpoint, save_named
from p3achygo_tpu_torch.train.lr_schedule import lr_for_gen
from p3achygo_tpu_torch.train.optimizer import conv_muon, sgd_nesterov
from p3achygo_tpu_torch.train.render import render_sample
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step
from p3achygo_tpu_torch.train.swa import SnapshotManager, recompute_batch_stats
from p3achygo_tpu_torch.train.val import batch_metrics

_log = logging.getLogger(__name__)


class GenerationLoop:
    def __init__(self, cfg: RunConfig, root_dir: str = "runs/local",
                 dtype: torch.dtype = torch.bfloat16, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.root = root_dir
        os.makedirs(root_dir, exist_ok=True)
        self.device = dev = torch.device(device)
        self.model = build_model(get_config(cfg.model_config), dtype, dev)
        init_params(self.model, torch.Generator().manual_seed(seed))
        self.replay = ReplayBuffer(capacity=cfg.replay_capacity, seed=seed)
        # Held-out split for per-gen validation (dual validation,
        # rl_loop/train.py:183-198): val_game_frac of finished games land
        # here instead of the training replay.
        self.val_replay = ReplayBuffer(capacity=1 << 16, seed=seed + 3)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

        # The optimizer reads the LR through a schedule that returns the
        # loop's current per-generation LR (rl_loop/train.py:33-49), so a
        # new generation's LR applies without resetting momentum.
        self.lr = lr_for_gen(cfg, 0)
        lr_fn = lambda _count: self.lr
        if cfg.optimizer == "muon":
            tx = conv_muon(lr_fn, weight_decay=cfg.muon_wd,
                           wd_lr_exponent=cfg.wd_lr_exponent, wd_lr_max=cfg.wd_lr_max,
                           adam_weight_decay=cfg.adam_wd)
        else:
            tx = sgd_nesterov(lr_fn)
        self.train_state = create_train_state(self.model, tx)
        self._train_step = make_train_step(self.model, tx, LossCoeffs.rl())

        # Golden network: drives self-play and is the eval incumbent.
        self.golden = copy.deepcopy(self.model)
        self.gen = 0
        self.snapshots = SnapshotManager()

        B = cfg.selfplay_batch_size
        self.sp_cfg = SelfplayConfig(
            batch_size=B, max_game_len=cfg.selfplay_max_game_len,
            sel_mult_scale_factor=cfg.sel_mult_scale_factor)
        # sel_mult calibration (sp_loop.py:140-157), refreshed per
        # generation from .stats files.
        self.calib = default_calibration()
        self.sel_mult_base = float(np.float32(cfg.sel_mult_base))
        self.stats_dir = os.path.join(root_dir, "stats")
        self._move_stats: list = []
        self.states = new_state(B, self.sp_cfg.komi, device=dev)
        self.buf = make_game_buffer(B, self.sp_cfg.max_game_len, dev)
        self.aux = make_aux(B, self.generator, self.sp_cfg.max_raw_policy_moves, dev)
        self.reuse = make_reuse_buffer(cfg.reuse_buffer_type, seed=seed)
        # Fork manager (fork_manager.h): per-game fork plans, harvest-time
        # execution with batched NN rounds.
        self.fork: Optional[ForkManager] = None
        if cfg.fork_enabled:
            fp = ForkParams.for_reuse(cfg.use_seen_state_prob) \
                if cfg.use_seen_state_prob > 0 else ForkParams()
            if cfg.fork_regret_prob > 0:
                fp = dataclasses.replace(
                    fp, regret_prob=cfg.fork_regret_prob,
                    late_fork_prob=max(fp.late_fork_prob - cfg.fork_regret_prob, 0.0))
            self.fork = ForkManager(fp, self.reuse, ForkEvaluator(device=dev), seed=seed)
        self._fork_plans = [None] * B
        self._init_mv = np.zeros(B, np.int32)
        self._is_fresh = np.ones(B, bool)
        if self.fork is not None:
            self._fork_plans = [self.fork.new_plan(True) for _ in range(B)]
        max_n = max(gumbel_params_for_gen(cfg, cfg.num_generations, True)[0],
                    gumbel_params_for_gen(cfg, cfg.num_generations, False)[0],
                    gumbel_params_for_gen(cfg, 0, True)[0])
        self.reuse_capacity = max_n + 2 if self.sp_cfg.tree_reuse else 0
        self.tree = (make_tree(B, self.reuse_capacity, dev)
                     if self.sp_cfg.tree_reuse else None)
        # Value-bias cache (bias_cache.h; off by default like the
        # reference, selfplay/main.cc:58), 1024 slots per board.
        self.bias = (make_bias_table(B, 1024, dev) if cfg.bias_cache_lambda > 0
                     else None)
        self.sgf_dir: Optional[str] = None
        self._sp = None
        self._eval_n = None
        self._eval_runner: Optional[EvalRunner] = None
        self._np_rng = np.random.default_rng(seed + 2)
        # Optional tap on finalized games, called after the replay add (the
        # actor exports them to the store bus; rl/workers.py).
        self.game_sink = None

    # ---------------- selfplay ----------------
    def _bind_selfplay(self):
        """The two tiers' SearchParams at this generation's n/k and the
        golden's evaluator (selfplay_step_tiered: a random quarter of the
        batch runs the selected tier; self_play_thread.cc:527-611)."""
        cfg = self.cfg
        n_s, k_s = gumbel_params_for_gen(cfg, self.gen, selected=True)
        n_f, k_f = gumbel_params_for_gen(cfg, self.gen, selected=False)
        common = dict(noise_scale=1.0, max_depth=24,
                      early_stopping=cfg.early_stopping_enabled,
                      visit_group=max(cfg.visit_group, 1),
                      bias_lambda=cfg.bias_cache_lambda,
                      bias_alpha=cfg.bias_cache_alpha,
                      terminal_mode=cfg.terminal_mode)
        params_sel = SearchParams(n=n_s, k=k_s, **common)
        params_fast = SearchParams(n=n_f, k=k_f, **common)
        self._sp = (params_sel, params_fast, make_eval_fn(self.golden))

    def selfplay_games(self, num_games: int, max_plies: int = 100000) -> int:
        if self._sp is None:
            self._bind_selfplay()
        params_sel, params_fast, eval_fn = self._sp
        start_games = self.replay.games_added
        plies = 0
        last_harvest = 0
        B = self.cfg.selfplay_batch_size
        while (self.replay.games_added - start_games) < num_games \
                and plies < max_plies:
            out = selfplay_step_tiered(
                self.states, self.buf, self.aux, eval_fn, params_sel, params_fast,
                self.sp_cfg, generator=self.generator, reuse_tree=self.tree,
                reuse_capacity=self.reuse_capacity, calib=self.calib,
                sel_mult_base=self.sel_mult_base, bias_table=self.bias)
            self._unpack(out)
            plies += 1
            # Pass-alive checkpoint poll (self_play_thread.cc:701-705 +
            # board.cc:587-590), amortized over 8 moves.
            if plies % 8 == 0:
                self.states = refresh_pass_alive(self.states)
            # Harvest in batches: scoring runs Benson over the finished
            # boards, so amortize it (finished boards stay frozen).
            done = finished_mask(self.states, self.sp_cfg)
            ndone = int(done.sum())
            if ndone > 0 and (ndone >= max(B // 16, 1)
                              or plies - last_harvest >= 16):
                self._harvest(done.cpu().numpy())
                last_harvest = plies
        done = finished_mask(self.states, self.sp_cfg)
        if bool(done.any()):
            self._harvest(done.cpu().numpy())
        return self.replay.games_added - start_games

    def _harvest(self, done: np.ndarray):
        """Score the finished boards (`done` bool [B]), turn their records
        into replay rows, move stats, reuse and fork candidates and SGFs,
        then restart them. Their records move to the host once."""
        idx = np.flatnonzero(done)
        idx_t = torch.from_numpy(idx).to(self.device)
        finished = map_state(lambda t: t[idx_t], self.states)
        bs, ws, own = (t.cpu().numpy() for t in final_scores(finished))
        rec = {f: getattr(self.buf, f)[idx_t].cpu().numpy() for f in GameBuffer._fields}
        counts = finished.move_count.cpu().numpy()
        komi = finished.komi.cpu().numpy()
        for i, b in enumerate(idx):
            r = {f: v[i] for f, v in rec.items()}
            L = min(int(counts[i]), self.sp_cfg.max_game_len)
            mv0 = int(self._init_mv[b])  # restart offset; rows < mv0 empty
            ex = finalize_game(
                stones=r["stones"], last_moves=r["last_moves"],
                to_move=r["to_move"], pi=r["pi"], move=r["move"],
                root_q_outcome=r["root_q_outcome"], root_score=r["root_score"],
                kld=r["kld"], trainable=r["trainable"],
                mcts_value_dist=r["mcts_value_dist"], num_moves=L,
                black_score=float(bs[i]), white_score=float(ws[i]),
                ownership=own[i], komi=float(komi[i]))
            if ex is not None:
                if (self.cfg.val_game_frac > 0
                        and self._np_rng.uniform() < self.cfg.val_game_frac):
                    self.val_replay.add_game(ex)
                else:
                    self.replay.add_game(ex)
                if self.game_sink is not None:
                    self.game_sink(ex)
            # Per-move diagnostics for the .stats pipeline
            # (tf_recorder.cc RecordGame move_stats accumulation).
            self._move_stats.append(MoveStatsBatch(
                sampled_raw_policy=r["sampled_raw"][:L], nn_q=r["nn_q"][:L],
                mcts_q=r["mcts_q"][:L], nn_mcts_diff=r["nn_mcts_diff"][:L],
                v_outcome_stddev=r["v_stddev"][:L],
                prior_entropy=r["prior_entropy"][:L],
                nn_uncertainty=r["nn_uncertainty"][:L], kld=r["kld"][:L],
                pre_kld=r["pre_kld"][:L],
                sel_mult_modifier=r["sel_mult_modifier"][:L],
                sel_mult_modifier_weight=r["sel_weight"][:L],
                visit_count=r["visits"][:L].astype(np.float32),
                visit_count_pre=r["visit_count_pre"][:L]))
            self.reuse.maybe_add_from_game(
                r["stones"][mv0:L], r["last_moves"][mv0:L], r["to_move"][mv0:L],
                L - mv0)
            # Fork manager: stage this game's fork decision
            # (MaybeFork/FinalizeGame deferred to harvest, fork.py).
            if self.fork is not None and L - mv0 > 0:
                self.fork.process_game(self._fork_plans[b], GameRecord(
                    stones=r["stones"][mv0:L], last_moves=r["last_moves"][mv0:L],
                    to_move=r["to_move"][mv0:L], move=r["move"][mv0:L],
                    nn_value=r["nn_q"][mv0:L], mcts_value=r["root_q_outcome"][mv0:L],
                    mcts_score=r["root_score"][mv0:L],
                    eligible=~r["sampled_raw"][mv0:L] & (r["visits"][mv0:L] > 0),
                    komi=float(komi[i]),
                    winner=1 if float(bs[i]) > float(ws[i]) else -1,
                    init_mv_num=mv0))
            if self.sgf_dir:
                os.makedirs(self.sgf_dir, exist_ok=True)
                sgf = game_to_sgf(r["to_move"], r["move"], L, float(bs[i]),
                                  float(ws[i]), float(komi[i]))
                with open(os.path.join(
                        self.sgf_dir, f"g{self.replay.games_added:06d}_b{b}.sgf"),
                        "w") as f:
                    f.write(sgf)

        # Flush staged fork jobs' batched NN rounds into the reuse buffer.
        if self.fork is not None:
            self.fork.flush(self.golden)

        # Per-board restarts (GetInitState, self_play_thread.cc:203-254).
        init_states, use_init, komi_arr, no_raw, force_sel = \
            self._build_restart_batch(idx)
        out = reset_finished(
            self.states, self.buf, self.aux, torch.from_numpy(done).to(self.device),
            komi_arr, generator=self.generator,
            max_raw_policy_moves=self.sp_cfg.max_raw_policy_moves,
            reuse_tree=self.tree, init_states=init_states, use_init=use_init,
            no_raw=no_raw, force_sel=force_sel, bias_table=self.bias)
        self._unpack(out)

    def _unpack(self, out):
        """Store the (states, buf, aux[, tree][, bias]) a step or a reset
        returns."""
        self.states, self.buf, self.aux = out[:3]
        rest = list(out[3:])
        if self.tree is not None:
            self.tree = rest.pop(0)
        if self.bias is not None:
            self.bias = rest.pop(0)

    # Free-handicap placement (board.cc:479-480 kHandicapStones), flat idx.
    _HANDICAP_STONES = (15 * 19 + 3, 3 * 19 + 15, 3 * 19 + 3, 15 * 19 + 15)

    def _note_new_game(self, b: int, is_fresh: bool, init_mv: int):
        self._is_fresh[b] = is_fresh
        self._init_mv[b] = init_mv
        self._fork_plans[b] = (self.fork.new_plan(is_fresh)
                               if self.fork is not None else None)

    def _build_restart_batch(self, done_idx):
        """Per-board restart positions (GetInitState,
        self_play_thread.cc:203-254): randomized komi for fresh games, 5%
        handicap starts, use_seen_state_prob reuse-buffer restarts with
        their stored komi/first-move behavior; updates fork-plan and
        freshness bookkeeping for every restarted board.

        -> (init_states, use_init, komi [B], no_raw [B], force_sel [B]) on
        the device."""
        B = self.cfg.selfplay_batch_size
        rng = self._np_rng
        cfg = self.cfg
        stones = np.zeros((B, 361), np.int8)
        last_moves = np.full((B, 5), NOOP_MOVE, np.int32)
        to_move = np.ones((B,), np.int8)
        move_num = np.zeros((B,), np.int32)
        komi = np.full((B,), self.sp_cfg.komi, np.float32)
        no_raw = np.zeros((B,), bool)
        force = np.zeros((B,), bool)
        use = np.zeros((B,), bool)
        for b in done_idx:
            use[b] = True
            if cfg.randomize_komi:
                komi[b] = (np.round(7.0 + np.clip(rng.normal(), -3.0, 3.0))
                           + (0.5 if rng.uniform() < 0.5 else -0.5))
            p = rng.uniform()
            if p <= cfg.play_from_book_prob:
                # Opening book (GetInitState, self_play_thread.cc:216-232):
                # random prefix of a random fixed line, BLACK first.
                prefix = sample_book_prefix(rng)
                color = 1
                moves = []
                for loc in prefix:
                    stones[b, loc] = color
                    moves.append(loc)
                    color = -color
                for i, loc in enumerate(moves[-5:]):
                    last_moves[b, 5 - len(moves[-5:]) + i] = loc
                to_move[b] = color
                move_num[b] = len(moves)
                self._note_new_game(b, is_fresh=True, init_mv=len(moves))
            elif p <= cfg.play_from_book_prob + cfg.handicap_game_prob:
                h = int(np.floor(rng.uniform() * 3 + 2))  # 2..4 stones
                komi[b] = (h - 2) * 14 + 20.5  # katago ;) (ssp.cc:238)
                for loc in self._HANDICAP_STONES[:h]:
                    stones[b, loc] = 1
                to_move[b] = -1  # WHITE moves first
                self._note_new_game(b, is_fresh=True, init_mv=0)
            elif (p <= cfg.play_from_book_prob + cfg.handicap_game_prob
                  + cfg.use_seen_state_prob and len(self.reuse) > 0):
                st = self.reuse.get()
                if st is None:
                    self._note_new_game(b, is_fresh=True, init_mv=0)
                    continue
                stones[b] = st.stones
                last_moves[b] = st.last_moves
                to_move[b] = st.to_move
                move_num[b] = st.move_num
                if st.komi is not None:
                    komi[b] = st.komi
                no_raw[b] = st.first_move_behavior != FMB_SAMPLE
                force[b] = st.first_move_behavior == FMB_FORCE_FULL_SEARCH
                self._note_new_game(b, is_fresh=False, init_mv=st.move_num)
            else:
                self._note_new_game(b, is_fresh=True, init_mv=0)
        dev = self.device
        t = lambda a: torch.from_numpy(a).to(dev)
        init = from_stones(stones, t(komi), BLACK, device=dev)._replace(
            last_moves=t(last_moves), to_move=t(to_move), move_count=t(move_num))
        return init, t(use), t(komi), t(no_raw), t(force)

    # ---------------- training ----------------
    def _prepare(self, batch, augment: bool = True):
        return prepare_batch(batch, augment=augment, generator=self.generator,
                             device=self.device)

    def train_epoch(self, num_steps: Optional[int] = None,
                    window: Optional[int] = None):
        steps = num_steps or max(len(self.replay) // self.cfg.train_batch_size, 1)
        if window is None:
            # KataGo-style train_window_size growth (shuffle.py:175-186 +
            # shuffle_metadata.py:9-26): stale early generations age out.
            window = self.replay.training_window()
        losses = {}
        for _ in range(steps):
            batch = self.replay.sample(self.cfg.train_batch_size, window)
            planes, scalars, targets = self._prepare(batch)
            self.train_state, losses = self._train_step(
                self.train_state, planes, scalars, targets)
            self.snapshots.maybe_snapshot(self.train_state.step, self.train_state.params)
        return {k: float(v) for k, v in losses.items()}

    def _bn_batches(self, num_passes: int):
        """(planes, scalars) batches for the BN refresh, drawn from the
        training window."""
        window = self.replay.training_window()
        for _ in range(num_passes):
            planes, scalars, _ = self._prepare(
                self.replay.sample(self.cfg.train_batch_size, window))
            yield planes, scalars

    @torch.no_grad()
    def validate(self, num_batches: Optional[int] = None) -> dict:
        """Held-out losses + accuracy metrics of the live model
        (train.py:1038 val), plus a rendered sample-board diagnostic per
        generation appended to train_samples.txt (log_board_position,
        train.py:748-1020)."""
        num_batches = num_batches or self.cfg.val_batches
        if len(self.val_replay) == 0 or num_batches <= 0:
            return {}
        totals: dict = {}
        last = None
        for _ in range(num_batches):
            planes, scalars, targets = self._prepare(
                self.val_replay.sample(self.cfg.train_batch_size), augment=False)
            outputs = self.model(planes, scalars)
            out = {**compute_losses(outputs, targets, LossCoeffs.rl()),
                   **batch_metrics(outputs, targets)}
            last = (planes, scalars, outputs, targets)
            for key, val in out.items():
                totals[key] = totals.get(key, 0.0) + float(val)
        try:
            with open(os.path.join(self.root, "train_samples.txt"), "a") as f:
                f.write(f"\n# generation {self.gen}\n")
                f.write(render_sample(*last))
                f.write("\n")
        except Exception:  # diagnostics must never kill the run
            _log.exception("train sample render failed")
        return {f"val_{k}": v / num_batches for k, v in totals.items()}

    # ---------------- eval + promotion ----------------
    def build_candidate(self, swa: bool = True) -> torch.nn.Module:
        """A copy of the live model holding the SWA-averaged parameters
        (or the live ones) with its BN statistics refreshed."""
        cand = copy.deepcopy(self.model)
        if swa:
            avg = self.snapshots.final(self.train_state.params)
            with torch.no_grad():
                for k, p in cand.named_parameters():
                    p.copy_(avg[k])
        # SWA-averaged weights shift activation statistics: refresh the BN
        # running stats with forward passes before gating
        # (model_utils.py:42-116 recompute_bn_statistics).
        passes = self.cfg.bn_recompute_passes
        if swa and passes > 0 and len(self.replay) > 0 and self.train_state.batch_stats:
            recompute_batch_stats(cand, self._bn_batches(passes), num_passes=passes)
        return cand

    def evaluate_candidate(self, swa: bool = True,
                           cand: Optional[torch.nn.Module] = None):
        if cand is None:
            cand = self.build_candidate(swa)
        # Eval n and games grow over their windows (get_eval_n,
        # train_sp_eval.py:70-74); the runner is rebuilt when they change.
        n_e = eval_n_for_gen(self.cfg, self.gen)
        games_e = eval_games_for_gen(self.cfg, self.gen)
        if self._eval_n != (n_e, games_e):
            self._eval_runner = EvalRunner(EvalConfig(
                num_games=games_e, max_game_len=self.cfg.eval_max_game_len,
                search=SearchParams(n=n_e, k=self.cfg.eval_k, noise_scale=1.0,
                                    tau=0.0, terminal_mode=self.cfg.terminal_mode)))
            self._eval_n = (n_e, games_e)
        res = self._eval_runner.run(cand, self.golden, self.generator)
        return res, cand

    def _flush_stats(self):
        """Write this generation's .stats file and refresh the sel_mult
        calibration for the next one (tf_recorder.cc:313-461 +
        sp_loop.py:140-157)."""
        if not self._move_stats:
            return
        os.makedirs(self.stats_dir, exist_ok=True)
        stats = MoveStatsBatch.concatenate(self._move_stats)
        self._move_stats = []
        n = int(stats.nn_q.size)
        ts = int(time.time())
        name = f"gen{self.gen:03d}_b000_g000_n{n:05d}_t{ts}_w0.stats"
        write_stats_file(os.path.join(self.stats_dir, name), stats)
        calib = compute_calibration(self.stats_dir, self.gen)
        if calib is not None:
            write_calibration_file(calib, os.path.join(self.root, "sel_mult_calib.txt"))
            self.calib = calibration_from_dict(calib)
            base = compute_sel_mult_base(calib)
            if base is not None:
                self.sel_mult_base = float(np.float32(base))

    def run_generation(self, eval_gating: bool = True) -> dict:
        t0 = time.time()
        games = self.cfg.games_first_gen if self.gen == 0 else self.cfg.games_per_gen
        self.selfplay_games(games)
        self._flush_stats()
        sp_t = time.time() - t0
        out = self.train_and_gate(eval_gating)
        return dict(games=games, selfplay_s=sp_t, **out)

    def train_and_gate(self, eval_gating: bool = True) -> dict:
        """Train on the replay, gate the candidate, checkpoint, advance the
        generation (the train_sp_eval.py loop body minus sp_loop)."""
        t0 = time.time()
        # Per-generation LR (get_lr, rl_loop/train.py:33-49): the
        # optimizer's schedule reads self.lr; momentum is kept.
        self.lr = lr = lr_for_gen(self.cfg, self.gen)
        losses = self.train_epoch()
        losses["lr"] = lr
        losses.update(self.validate())
        train_t = time.time() - t0

        promoted = True
        elo = 0.0
        if eval_gating:
            cand = self.build_candidate()
            # Candidate-first checkpointing (train_sp_eval.py:213-215: the
            # model is saved BEFORE eval so a crash during gating never
            # loses the training work).
            save_named(self.root, "cand", {"model": cand.state_dict()})
            res, _ = self.evaluate_candidate(cand=cand)
            elo = res.elo
            promoted = res.elo > 0
            if promoted:
                self.golden.load_state_dict(cand.state_dict())
        else:
            self.golden.load_state_dict(self.model.state_dict())

        old_nk = (gumbel_params_for_gen(self.cfg, self.gen, True),
                  gumbel_params_for_gen(self.cfg, self.gen, False))
        self.gen += 1
        new_nk = (gumbel_params_for_gen(self.cfg, self.gen, True),
                  gumbel_params_for_gen(self.cfg, self.gen, False))
        if new_nk != old_nk:
            self._sp = None  # n/k changed: rebind the search parameters
        save_checkpoint(self.root, self.gen, {"model": self.golden.state_dict(),
                                              "step": self.train_state.step}, live=False)
        with open(os.path.join(self.root, "elo_history.txt"), "a") as f:
            f.write(f"{self.gen} {elo:.2f} {int(promoted)}\n")
        self.save_resume()
        return dict(gen=self.gen, elo=elo, promoted=promoted, train_s=train_t, **losses)

    # ---------------- resume (elastic recovery) ----------------
    # The generation boundary is the durable point (fs_utils.py:25-65 +
    # train_sp_eval.py:213-215): the full train state, golden, device
    # generator and replay rings land on disk after every generation, and
    # `try_resume` picks the run back up from there. In-flight self-play
    # games at crash time are lost, as the reference's thread games are,
    # and with them the bias table, which holds their per-game knowledge:
    # as in JAX (whose resume template has no bias entry), a resumed loop
    # starts from an empty table.
    def save_resume(self):
        ts = self.train_state
        save_named(self.root, "live", {
            "params": {k: p.detach() for k, p in ts.params.items()},
            "batch_stats": dict(ts.batch_stats),
            "opt_state": ts.opt_state,
            "step": ts.step,
            "golden": self.golden.state_dict(),
            "generator": self.generator.get_state(),
            "sel_mult_base": self.sel_mult_base,
        })
        self.replay.save(os.path.join(self.root, "replay.npz"))
        self.val_replay.save(os.path.join(self.root, "val_replay.npz"))
        meta = {"gen": self.gen,
                "np_rng_state": self._np_rng.bit_generator.state}
        tmp = os.path.join(self.root, "resume_meta.json.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(self.root, "resume_meta.json"))

    def try_resume(self) -> bool:
        """Restore run state saved by `save_resume`; returns True if the
        loop was resumed."""
        meta_path = os.path.join(self.root, "resume_meta.json")
        live_path = os.path.join(self.root, "live")
        if not (os.path.exists(meta_path) and os.path.isdir(live_path)):
            return False
        with open(meta_path) as f:
            meta = json.load(f)
        state = restore_checkpoint(live_path, map_location=self.device)
        ts = self.train_state
        with torch.no_grad():
            for group in ("params", "batch_stats"):
                for k, t in getattr(ts, group).items():
                    t.copy_(state[group][k])
        self.train_state = ts._replace(opt_state=state["opt_state"], step=state["step"])
        self.golden.load_state_dict(state["golden"])
        self.generator.set_state(state["generator"].cpu())
        self.sel_mult_base = state["sel_mult_base"]
        self.gen = int(meta["gen"])
        self._np_rng.bit_generator.state = meta["np_rng_state"]
        for buf, fname in ((self.replay, "replay.npz"),
                           (self.val_replay, "val_replay.npz")):
            path = os.path.join(self.root, fname)
            if os.path.exists(path):
                buf.load(path)
        # sel_mult calibration comes back from the on-disk .stats files
        # (sp_loop.py:140-157), exactly as _flush_stats derives it.
        calib = compute_calibration(self.stats_dir, self.gen)
        if calib is not None:
            self.calib = calibration_from_dict(calib)
        self._sp = None  # rebind: n/k may differ at the resumed gen
        return True
