"""Drive the PyTorch port's self-play, learning, generation, search and
GTP paths once on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  0 device   needs torch.cuda; prints the card's name and power limit and
             the TF32 switches (both off).
  1 build    compiles the liberty kernel (csrc/liberties.cu), the broadcast
             kernel (csrc/trunk_broadcast.cu) and the segment kernel
             (csrc/trunk_segment.cu) with one nvcc each, started together;
             prints each build's seconds, ptxas' register/spill lines and
             each trunk kernel's count of HGMMA (wgmma) and of all SASS
             instructions from `cuobjdump -sass`: every width of both trunk kernels must be
             there with a count > 0, each source held to its own counts
             (where cuobjdump is missing the line says so).
  2 kernel   boards from random legal play with the port's `step`; the
             liberty kernel must equal its plain PyTorch version exactly at
             B in {1, 7, 64, 192, 1024, 2048, 2880, 8192}; times both at
             B = 1024 and 8192: device time per call (profiler kernel
             records) and wall time per call (CUDA events, median of 5).
  3 forward  b12c128btl3 with seeded random weights (BN statistics
             perturbed so the fold is not an identity): the folded serving
             forward against the plain forward, in float32 (max |d| of the
             policy logits < 1e-3) and in bf16 (top-1 agreement, max |d| of
             the value printed); every output finite.
  4 selfplay selfplay_step_tiered + finished_mask + reset_finished at the
             bench mix (25% n=128/k=8, 75% n=32/k=5, visit_group 4, tree
             reuse 64, b12c128btl3 bf16, serve_fold) on B=256 fresh games
             for 10 plies; checks every played move was legal and passed
             the superko guard, pi_improved is finite and sums to 1, and
             the liberty kernel was launched by this phase. Prints plies/s
             and moves/s (informative, not a benchmark).
  5 trunk    the fused-trunk kernels, b12c128btl3 and b8c64 with seeded
             random weights and perturbed BN, at N in {1, 7, 64, 512, 2880}
             (2880: the widest leaf batch at B=256), on the stem
             activations of the boards of phase 2: each segment and
             broadcast kernel call against its plain version on the same
             bf16 input (max |d| / max |ref| <= KERNEL_TOL), build_trunk_fn
             and build_trunk_fn_v2 against their plain trunks (TRUNK_TOL), and
             the model with the fused trunk against the plain bf16 model on
             512 positions (policy top-1 agreement >= 0.95, every output
             finite). Times at N = 512 and 2880 (device time and wall time
             per call): the fused trunk, the plain trunk, ServeNet's trunk
             and ServeNet's whole forward, and each kernel against its
             plain version; for the segment and broadcast kernels at both N
             also their FLOP count, TFLOP/s, bound and share of it, and
             library_products_ms: the same products alone (segment: bf16
             F.conv2d for the 3x3s, bf16 torch.matmul for the 1x1s;
             broadcast: bf16 torch.matmul for x.Wf, the batched WdT.m and
             z.Wl), a yardstick the port never calls, since no single
             PyTorch call computes a segment or a broadcast block.
  6 fused    the phase-4 loop with make_eval_fn(use_fused_trunk=True) in
             place of serve_fold, for 6 plies with one reset; the same
             checks, and all three kernels (segment, broadcast, liberty)
             must have been launched by this phase.
  7 learn    the learning loop through rl/slice.py RLSlice: b12c128btl3
             bf16 with seeded weights, B=128 boards, SearchParams(n=16, k=4),
             max_game_len 24, train batch 256. Plays until B games are
             harvested (every harvested board's Benson scores and ownership,
             computed on the card, equal to the CPU's); one replay batch
             through prepare_batch on the card and on the CPU with the same
             symmetries (equal; the liberty kernel launched); 8 sgd_nesterov
             steps (finite losses, grad_norm > 0), 10 more on one fixed
             batch (its loss falls; the last 8 timed, with the split into
             forward, backward and optimizer and a profile of 2 steps), 2
             conv_muon steps on a copy; an SWA snapshot, a 4-pass BN
             refresh, validation on 2 batches, a checkpoint save -> restore
             into a fresh model (bitwise equal); then 2 plies with the new
             weights (every move legal and superko-clean, pi_improved
             finite and summing to 1). The liberty kernel must have been
             launched by this phase; the trunk kernels are not on its path.

  8 gen      one generation of rl/loop.py GenerationLoop (the system users
             run) on config/b12-onegen.json at b12c128btl3 width, bf16,
             seeded weights, with the cuts of GEN_CUTS (B=128, 128 games of
             at most 32 moves, selected 32/4 and fast 16/4, eval 16 games at
             n=16/k=4 of at most 16 moves, 4 BN-refresh passes, 2
             validation batches, use_seen_state_prob 0.25 so GoExploit
             restarts happen), SGFs on: self-play with restarts and forks
             -> harvest -> train -> SWA + BN refresh -> validation -> gating
             eval -> checkpoint. Checks every played move legal and
             superko-clean, gen 1, model_0001 and elo_history.txt written,
             one .stats file and a calibration, a non-empty reuse buffer, at
             least one fork job flushed, every SGF parsing back into the
             moves its board played, the eval's wins + losses = its games,
             the liberty kernel launched; then a second loop on the same
             directory resumes bitwise (gen, golden, train state, optimizer,
             generators, replay). Prints the wall time of each part.

  9 search   the search extras, about a minute and a half:
             (a) one generation of GenerationLoop on
             config/r4-b8c64-curve.json at b8c64 width, bf16, seeded
             weights, with its own terminal_mode "exact", lr_schedule,
             selected 32/4 and default 16/4, phase 8's cuts (SEARCH_CUTS:
             B=128, 128 games of at most 32 moves, eval 16 games of at most
             16 moves at n=16/k=4, 4 BN-refresh passes, 2 validation
             batches) and two smoke choices no committed config sets
             together with it (SEARCH_SWITCHES: early stopping, the bias
             cache at lambda 0.35 / alpha 0.8); a quarter of the boards
             starts from a settled endgame (settled_boards), since a
             seeded network ranks pass last and would never finish a game
             within 32 moves. Checks every move legal and superko-clean,
             gen 1 and model_0001 written, the eval's wins + losses = its
             games, every board's visits within visit_budget, a round
             stopped early, a bias slot filled, a leaf scored exactly, the
             liberty kernel launched; prints each part's wall time and the
             host syncs per searched move (mcts.gumbel.COUNTERS).
             (b) run_eval of 16 games of at most 16 moves between two
             seeded b8c64 bf16 networks, tree reuse on: a PUCT player at
             n=32 (max_depth 4: its visits run down one line) against a
             Gumbel player at n=32/k=4 with MCGS and the integral utility. Checks wins + losses = games and every move
             legal; prints the MCGS hits.
             (c) one search_root with MCGS, the bias cache (filled by a
             first search), early stopping, exact terminals and the
             integral utility at B=64 (random-play and settled boards, half
             one pass from the end), float32 weights and one Gumbel draw,
             on the card (the liberty kernel launched) and on the CPU:
             fails if fewer than 90% of the boards agree on the move and
             the root visit counts (the card sums floats in another order;
             exact parity is the CPU tests').

  10 gtp    the GTP engine, ladders and grouped tiers, on the card:
             (a) GtpService over make_eval_fn(b12c128btl3 bf16) with phase
             8's model_0001 (read as --checkpoint reads it), n=128/k=8, no
             root noise, driven through run_stdin_loop on an os.pipe (so
             its select() paths run): protocol_version, name,
             list_commands, boardsize, clear_board, komi; 16 alternating
             genmoves with 3 plays between; an illegal play on an occupied
             point, then undo; a one-shot and a streamed lz-analyze (the
             stream stopped by the next command); ownership, final_score,
             showboard; loadsgf of an SGF phase 8 wrote;
             p3achygo-serialize_sgf_with_trees; a genmove in byoyomi with a
             1 s budget (a 2 s period: the engine keeps 1 s back); quit.
             Checks every answer is '=' but the illegal play's '?', every
             genmove legal by full_legal_mask on the card and that mask
             equal to the CPU's, undo restoring the state bit for bit, the
             SGF parsing back to the game's moves, the byoyomi genmove
             within its budget plus one 16-visit slice, the liberty kernel
             launched; prints ms per genmove (median, max), host syncs per
             genmove, ms per lz-analyze batch, the byoyomi slices and
             visits. (b) python -m p3achygo_tpu_torch.gtp --checkpoint
             model_0001 with no --device answers `genmove b` and quits.
             (c) batched_features(include_ladders=True) on the card equal
             to the CPU's on the six positions of tests/test_ladder.py and
             1,024 boards of phase 2; one make_eval_fn(include_ladders=
             True) call finite; ms per featurizer call at B=1024 with and
             without ladders, ladder syncs per call. (d) phase 4's mix at
             B=256 with tier_groups=4 for 4 plies: every move legal and
             superko-clean, pi_improved summing to 1, B_sel/G selected
             boards in every group every ply.

Phases 7, 8, 9 and 10 print {"learn": ...}, {"gen": ...}, {"search": ...}
and {"gtp": ...} JSON lines of their measurements. Before the
last line it prints the kernels JSON line (every kernel with
its bound: the larger of its operations over 989 TFLOP/s bf16 and its bytes,
each input read once and each output written once, over 3.35 TB/s) and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from p3achygo_tpu_torch.constants import NUM_MOVES, PASS_MOVE
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import (
    from_stones,
    is_game_over,
    legal_mask_batch,
    legal_mask_from_libs,
    map_state,
    min_labels,
    new_state,
    select_state,
    step,
    superko_violation,
)
from p3achygo_tpu_torch.game.board import full_legal_mask
from p3achygo_tpu_torch.game.dsl import board_from_dsl
from p3achygo_tpu_torch.game.ladder import laddered_stones
from p3achygo_tpu_torch.game.scoring import pass_alive_for_color
from p3achygo_tpu_torch.gtp import GtpConfig, GtpService, gtp_vertex_to_action, run_stdin_loop
from p3achygo_tpu_torch.gtp.__main__ import load_model
from p3achygo_tpu_torch.eval.player_config import PlayerSearchConfig
from p3achygo_tpu_torch.mcts import gumbel as search
from p3achygo_tpu_torch.mcts.bias import bias_probe, local_pattern_keys, make_bias_table
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn, visit_budget
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.blocks import BatchNorm
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs, compute_losses
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model, init_params
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn, trunk_reference
from p3achygo_tpu_torch.nn.trunk_kernel2 import build_trunk_fn_v2
from p3achygo_tpu_torch.ops import cuda_build
from p3achygo_tpu_torch.ops import liberties as lib_ops
from p3achygo_tpu_torch.ops import trunk as trunk_ops
from p3achygo_tpu_torch.ops.liberties import (
    point_liberties_batch,
    point_liberties_reference,
)
from p3achygo_tpu_torch.eval import harness
from p3achygo_tpu_torch.game.scoring import score as score_boards
from p3achygo_tpu_torch.rl import loop as rl_loop
from p3achygo_tpu_torch.rl import slice as rl_slice
from p3achygo_tpu_torch.rl.config import parse as parse_run_config
from p3achygo_tpu_torch.rl.loop import GenerationLoop
from p3achygo_tpu_torch.rl.slice import RLSlice, SliceConfig
from p3achygo_tpu_torch.selfplay.stats import compute_calibration
from p3achygo_tpu_torch.sgf import extract_moves, parse_sgf
from p3achygo_tpu_torch.selfplay.loop import (
    SelfplayConfig,
    final_scores,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step_tiered,
    tier_sizes,
)
from p3achygo_tpu_torch.train import checkpoint
from p3achygo_tpu_torch.train.optimizer import apply_updates, conv_muon, global_norm
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step
from p3achygo_tpu_torch.train.swa import SnapshotManager, recompute_batch_stats
from p3achygo_tpu_torch.train.val import validate

BENCH_B = 256
PLIES = 10
FUSED_PLIES = 6
RESET_EVERY = 5
CHECK_BATCHES = (1, 7, 64, 192, 1024, 2048, 2880, 8192)
TIMED_BATCHES = (1024, 8192)
TRUNK_CONFIGS = ("b12c128btl3", "b8c64")
TRUNK_BATCHES = (1, 7, 64, 512, 2880)
TRUNK_TIMED = (512, 2880)
# max |d| / max |ref| of one kernel call against its plain version, and of
# a whole trunk (12 blocks) against the plain trunk. Both sides round to
# bf16 at the same points and differ only in the f32 summation order, so
# rounding flips of one or two bf16 units in the last place show up at the
# largest magnitudes (2 units = 0.8-1.6% of max |ref|); the plain float32
# version is itself that far from a float64-summed reference (PERF.md).
KERNEL_TOL = 2e-2
TRUNK_TOL = 4e-2
KERNELS = (point_liberties_batch, trunk_ops.trunk_segment, trunk_ops.trunk_broadcast)
# Published peaks of one H100 SXM (dense bf16 tensor rate, HBM3), for bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
# Phase 7: the learning loop.
LEARN_MODEL = "b12c128btl3"
LEARN_B = 128
LEARN_TRAIN_B = 256
LEARN_MAX_GAME_LEN = 24
LEARN_STEPS = 8
# Phase 8: one generation of rl/loop.py GenerationLoop on config/b12-onegen.json
# with these cuts (config value -> phase value).
GEN_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                          "b12-onegen.json")
GEN_CUTS = dict(
    selfplay_batch_size=128, games_first_gen=128, selfplay_max_game_len=32,
    min_train_selected_n=32, max_train_selected_n=32,
    min_train_selected_k=4, max_train_selected_k=4,
    min_train_default_n=16, max_train_default_n=16,
    min_train_default_k=4, max_train_default_k=4,
    eval_games=16, eval_n=16, eval_k=4, eval_max_game_len=16,
    bn_recompute_passes=4, val_batches=2,
    # GoExploit restarts within the phase (config: 0.0).
    use_seen_state_prob=0.25)
# Seed 0's first 128 fork plans hold 3 fork jobs below move 32 (two late
# forks, one uniform-sample fork), so the fork flush runs within the phase.
GEN_SEED = 0
# Phase 9: the search extras. (a) one generation of config/r4-b8c64-curve.json
# (terminal_mode "exact", its lr_schedule, selected 32/4 and default 16/4 stay)
# with phase 8's cuts (config value -> phase value) ...
SEARCH_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "config",
                             "r4-b8c64-curve.json")
SEARCH_CUTS = dict(
    selfplay_batch_size=128, games_first_gen=128, selfplay_max_game_len=32,
    eval_games=16, min_eval_games=16, eval_n=16, min_eval_n=16, eval_k=4,
    eval_max_game_len=16, bn_recompute_passes=4, val_batches=2)
# ... and two smoke choices that no committed config sets together with it:
# early stopping (as config/ci-tiny.json sets it) and the value-bias cache.
SEARCH_SWITCHES = dict(early_stopping_enabled=True, bias_cache_lambda=0.35,
                       bias_cache_alpha=0.8)
SEARCH_SEED = 0
# A quarter of the self-play boards starts from a settled endgame (two
# living groups with two eyes each: two legal moves and a pass), so games
# end by passes within the cut and their leaves are scored exactly; a
# seeded network ranks pass last everywhere else.
SEARCH_SETTLED_SHARE = 4
# (b) run_eval: a PUCT player against a Gumbel player with MCGS and the
# integral utility, two seeded b8c64 bf16 networks, tree reuse on.
SEARCH_MODEL = "b8c64"
EXTRAS_EVAL = dict(num_games=16, max_game_len=16)
# A seeded network values positions alike, so PUCT's visits run down one
# line and simulation i descends i levels, each a scratch-board step of
# ~8 ms of host time on an H100 machine: max_depth 4 (the config default is
# 32) bounds the descent.
EXTRAS_PUCT = dict(search_type="puct", n=32, max_depth=4)
EXTRAS_GUMBEL = dict(n=32, k=4, use_mcgs=True, score_utility_mode="integral")
# (c) one search_root with every Gumbel extra on, card against CPU.
EXTRAS_B = 64
EXTRAS_PARAMS = dict(n=32, k=4, max_depth=24, visit_group=4, use_mcgs=True,
                     bias_lambda=0.35, bias_alpha=0.8, early_stopping=True,
                     terminal_mode="exact", score_utility_mode="integral")
EXTRAS_AGREE_MIN = 0.9
# Phase 10: the GTP engine at b12c128btl3 width with phase 8's model_0001,
# searching as `python -m p3achygo_tpu_torch.gtp` does by default.
GTP_MODEL = "b12c128btl3"
GTP_SEARCH = dict(n=128, k=8, noise_scale=0.0)
GTP_GENMOVES = 16
GTP_PLAY_AFTER = (4, 8, 12)  # a `play` follows these genmoves
# A byoyomi period of P s is budgeted P - 1 s per move (time_control.py), so
# a 1 s budget needs a 2 s period (a 1 s period would mean an untimed search).
GTP_BYOYOMI_S = 2
LADDER_B = 1024
# The six positions of tests/test_ladder.py as (black, white, to_move).
LADDER_POSITIONS = (
    (((8, 9), (9, 8), (8, 10)), ((9, 9),), 1),
    (((8, 9), (9, 8), (8, 10)), ((9, 9), (15, 15)), 1),
    (((9, 10), (10, 9)), ((9, 9), (10, 10)), 1),
    (((0, 1), (1, 0)), ((1, 1),), 1),
    ((), ((5, 5), (5, 6), (6, 5), (6, 6)), 1),
    (((0, 1), (1, 1), (2, 0)), ((0, 0),), -1),
)
TIER_GROUPS = 4
TIER_PLIES = 4
# Kernel classes of a profile, by substrings of the kernel's name (first match).
CLASSES = (
    ("segment kernel", ("trunk_segment_kernel",)),
    ("broadcast kernel", ("trunk_broadcast_kernel",)),
    ("liberty kernel", ("point_liberties_kernel",)),
    ("cuDNN/cuBLAS convs and GEMMs", ("gemm", "conv", "cutlass", "xmma", "cudnn", "sm90_")),
    ("index/gather/scatter", ("index", "gather", "scatter")),
    ("reductions, sorts, softmax", ("reduce", "sort", "softmax", "scan", "radix")),
    ("elementwise", ("elementwise",)),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_boards(B: int, plies: int, device, gen: torch.Generator):
    """B boards after up to `plies` random legal moves (per-board pass
    probability spread over [0, 0.3) so stone counts vary)."""
    states = new_state(B, device=device)
    pass_p = torch.rand(B, generator=gen, device=device) * 0.3
    for _ in range(plies):
        legal = legal_mask_batch(states)[:, :PASS_MOVE]
        score = torch.rand(legal.shape, generator=gen, device=device)
        pick = torch.where(legal, score, -1.0).argmax(dim=1)
        passes = (~legal.any(dim=1)) | (torch.rand(B, generator=gen,
                                                   device=device) < pass_p)
        states, _ = step(states, torch.where(passes, PASS_MOVE, pick))
    return states


def wall_ms(fn, reps: int = 5, inner: int = 20) -> float:
    """Median over `reps` of the mean wall time (CUDA events) of `inner`
    back-to-back calls; includes the host's launch cost."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def device_ms(fn, calls: int = 50, attempts: int = 3) -> float:
    """Device time per call: the summed duration of the CUDA kernels that
    `calls` calls ran, from the profiler's kernel records. A profile that
    records no kernel (CUPTI drops one now and then) is taken again; after
    `attempts` empty ones the time comes from CUDA events around the calls
    instead, host gaps included, and a line says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / calls / 1000.0
    log(f"device_ms: {attempts} profiles recorded no device time; CUDA-event time per "
        f"call used instead")
    return event_ms(lambda: [fn() for _ in range(calls)]) / calls


def event_ms(fn) -> float:
    """Time of one call of `fn` on the card (CUDA events around it)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b)


def kernel_classes(prof, calls: int):
    """({class: device ms per call}, kernels per call) of a profile that
    covered `calls` calls."""
    by_class, kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        kernels += e.count
        name = e.key.lower()
        cls = next((c for c, keys in CLASSES if any(k in name for k in keys)), "other, copies")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3 / calls
    return by_class, kernels / calls


def phase_kernel(device, gen):
    boards = random_boards(max(CHECK_BATCHES), 150, device, gen)
    stones_all, chain_all = boards.stones, boards.chain_id
    max_err, times = 0, {}
    for B in CHECK_BATCHES:
        off = (B * 37) % (stones_all.shape[0] - B + 1)
        stones = stones_all[off:off + B].contiguous()
        chain = chain_all[off:off + B].contiguous()
        got = point_liberties_batch(stones, chain)
        want = point_liberties_reference(stones, chain)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0 or got.dtype != torch.int32 or got.shape != want.shape:
            raise AssertionError(f"liberty kernel != plain at B={B}: max err {err}")
        max_err = max(max_err, err)
        if B in TIMED_BATCHES:
            kern = lambda: point_liberties_batch(stones, chain)
            plain = lambda: point_liberties_reference(stones, chain)
            times[B] = (device_ms(kern), device_ms(plain), wall_ms(kern),
                        wall_ms(plain))
            log(f"phase 2: B={B} device time per call: kernel {times[B][0]:.4f} ms, "
                f"plain {times[B][1]:.4f} ms; wall per call (CUDA events, "
                f"host launch included): kernel {times[B][2]:.4f} ms, plain "
                f"{times[B][3]:.4f} ms")
    log(f"phase 2: kernel == plain at B in {list(CHECK_BATCHES)} (max |d| {max_err})")
    return boards, max_err, times


def seeded_model(name: str, device, gen: torch.Generator, dtype=torch.float32):
    """Model of config `name` (float32 unless `dtype`) with random weights
    from `gen` (a CPU generator) and BN statistics perturbed so no fold is
    an identity."""
    model = build_model(get_config(name), dtype, device)
    init_params(model, gen)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                c = mod.weight.shape[0]
                r = lambda: torch.rand(c, generator=gen).to(device)
                mod.weight.copy_(0.7 + 0.6 * r())
                mod.bias.copy_(0.2 * (r() - 0.5))
                mod.running_mean.copy_(0.2 * (r() - 0.5))
                mod.running_var.copy_(0.5 + r())
    return model


def phase_forward(device, boards, gen):
    model = seeded_model("b12c128btl3", device, gen)
    sub = type(boards)(*[t[:512] for t in boards])
    planes, scalars = batched_features(sub, planes_dtype=torch.float32)

    plain = model(planes, scalars)
    served = ServeNet(model)(planes, scalars)
    d32 = float((served.pi_logits - plain.pi_logits).abs().max())
    log(f"phase 3: float32 serve vs plain: max |d pi_logits| {d32:.3e}")
    if not d32 < 1e-3:
        raise AssertionError(f"float32 serve forward disagrees: {d32}")

    model.dtype = torch.bfloat16
    plain = model(planes, scalars)
    served = ServeNet(model)(planes, scalars)
    check_finite(plain, ModelOutputs._fields, "plain bf16")
    check_finite(served, ("pi_logits", "outcome_probs", "score_probs", "q6_err",
                          "gamma"), "served bf16")
    top1 = float((served.pi_logits.argmax(-1) == plain.pi_logits.argmax(-1)).float().mean())
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    dv = float((value(served) - value(plain)).abs().max())
    log(f"phase 3: bf16 serve vs plain on {planes.shape[0]} positions: top-1 "
        f"agreement {top1:.4f}, max |d value| {dv:.3e}")
    return model, (planes, scalars, plain)


def check_finite(out, fields, what):
    for f in fields:
        if not bool(torch.isfinite(getattr(out, f)).all()):
            raise AssertionError(f"{what} output {f} not finite")


def rel_err(got, want):
    d = float((got.float() - want.float()).abs().max())
    return d, d / float(want.float().abs().max())


def bound_ms(flops: float, nbytes: float):
    """(least time on the card in ms, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def tensor_bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def segment_work(w, n: int):
    """(FLOP, bytes) of one segment call on n boards: every product of every
    block; x read once and written once, the packed weights and affines
    read once."""
    n_blocks, layers = w.aff.shape[:2]
    C, cb = w.wr.shape[1:]
    flops = n_blocks * n * 2 * 361 * (2 * C * cb + 9 * (layers - 2) * cb * cb)
    return flops, 2 * n * 361 * C * 2 + tensor_bytes((w.aff, w.packed))


def broadcast_work(w, n: int):
    """(FLOP, bytes) of one broadcast call on n boards: conv_first, the
    361 x 361 position mix, conv_last; x in and out, the packed weights,
    affines and bias read once."""
    C = w.wf.shape[0]
    flops = n * 2 * (2 * 361 * C * C + 361 * 361 * C)
    return flops, 2 * n * 361 * C * 2 + tensor_bytes((w.f_aff, w.bd, w.l_aff, w.packed))


def broadcast_library_products(w, x):
    """-> fn running the broadcast block's three products alone on x's
    shapes in bf16 torch.matmul (x.Wf, the batched WdT.m, z.Wl), without
    the elementwise chain. A yardstick only: no single PyTorch call
    computes the broadcast block, and the port never calls this."""
    n, _, C = x.shape
    a = x.reshape(n * 361, C)
    wdt = w.wdt[:361, :361].contiguous()

    def run():
        m = (a @ w.wf).reshape(n, 361, C)
        torch.matmul(wdt, m).reshape(n * 361, C) @ w.wl
    return run


def segment_library_products(w, x):
    """-> fn running the segment's products alone on x's shapes: bf16
    torch.matmul for each 1x1 and bf16 F.conv2d (channels-last) for each
    3x3, without the elementwise chain. A yardstick only: no single PyTorch
    call computes the segment, and the port never calls this."""
    n, _, C = x.shape
    cb = w.wr.shape[2]
    w9 = w.w9.reshape(*w.w9.shape[:2], 3, 3, cb, cb).permute(0, 1, 5, 4, 2, 3)
    w9 = w9.contiguous(memory_format=torch.contiguous_format)
    a = x.reshape(n * 361, C)

    def run():
        for blk in range(w.wr.shape[0]):
            t = (a @ w.wr[blk]).reshape(n, 19, 19, cb).permute(0, 3, 1, 2)
            for j in range(w9.shape[1]):
                t = F.conv2d(t, w9[blk, j], padding=1)
            t.permute(0, 2, 3, 1).reshape(n * 361, cb) @ w.we[blk]
    return run


def sass_counts(source: str):
    """({kernel<widths>: HGMMA instructions}, {kernel<widths>: SASS
    instructions}) in the built library of `source`, from `cuobjdump
    -sass`; None where cuobjdump is missing. The second says how much code
    a kernel streams through the instruction cache."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", cuda_build.built_path(source)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    hgmma, size, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(trunk_(?:segment|broadcast)_kernel)I((?:Li\d+E)+)", line)
            widths = ",".join(re.findall(r"Li(\d+)E", m.group(2))) if m else ""
            name = (f"{m.group(1)}<{widths}>" if m
                    else line.split("Function :")[1].strip())
            hgmma[name] = size[name] = 0
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            size[name] += 1
            hgmma[name] += "HGMMA" in line
    return hgmma, size


def stem_activations(model, boards, n: int) -> torch.Tensor:
    """The trunk input the main path gives the kernels: the bf16 stem output
    of the first `n` boards, [n, 361, C]."""
    sub = type(boards)(*[t[:n] for t in boards])
    planes, scalars = batched_features(sub, planes_dtype=model.dtype)
    with torch.no_grad():
        x = model.stem(planes, scalars).permute(0, 2, 3, 1)
    return x.reshape(n, 361, -1).to(torch.bfloat16).contiguous()


def phase_trunk(device, boards, forward_model, forward_batch, gen):
    """Trunk kernels against their plain versions, the trunks against the
    plain trunks, the fused model against the plain bf16 model, and times.
    Inputs are stem activations of the boards of phase 2.
    Returns ({kernel name: max |d|}, {timed row: (device ms, wall ms)},
    {"<kernel>@N": each trunk kernel's row at each timed N})."""
    max_err = {"trunk_segment": 0.0, "trunk_broadcast": 0.0}
    times, kernel_rows = {}, {}
    for name in TRUNK_CONFIGS:
        model = (forward_model if name == TRUNK_CONFIGS[0]
                 else seeded_model(name, device, gen))
        model.dtype = torch.bfloat16
        cfg = model.config
        stem = stem_activations(model, boards, max(TRUNK_BATCHES))
        trunk_fn = build_trunk_fn(cfg, model)
        trunk_v2 = build_trunk_fn_v2(cfg, model)
        kernel_rel, trunk_rel = 0.0, [0.0, 0.0]
        for N in TRUNK_BATCHES:
            x = x0 = stem[:N]
            for kern, plain, w in trunk_fn.segments:
                got, want = kern(x, w), plain(x, w)
                torch.cuda.synchronize()
                if got.shape != want.shape or got.dtype != torch.bfloat16:
                    raise AssertionError(f"{kern.__name__}: {got.shape} {got.dtype}")
                d, rel = rel_err(got, want)
                if not (bool(torch.isfinite(got.float()).all()) and rel <= KERNEL_TOL):
                    raise AssertionError(f"{name} N={N} {kern.__name__} vs plain: "
                                         f"max |d| {d}, relative {rel}")
                max_err[kern.__name__] = max(max_err[kern.__name__], d)
                kernel_rel = max(kernel_rel, rel)
                row_key = f"{kern.__name__}@{N}"
                if name == TRUNK_CONFIGS[0] and N in TRUNK_TIMED and row_key not in kernel_rows:
                    kernel_rows[row_key] = kernel_row(kern, w, x)
                if N == max(TRUNK_TIMED) and name == TRUNK_CONFIGS[0] \
                        and kern.__name__ not in times:
                    times[kern.__name__] = (device_ms(lambda: kern(x, w), 10),
                                            wall_ms(lambda: kern(x, w), 3, 5))
                    times[kern.__name__ + "_plain"] = (
                        device_ms(lambda: plain(x, w), 10),
                        wall_ms(lambda: plain(x, w), 3, 5))
                    work = (segment_work if kern is trunk_ops.trunk_segment
                            else broadcast_work)(w, N)
                    times[kern.__name__ + "_bound"] = bound_ms(*work)
                x = want
            xs = x0.reshape(N, 19, 19, cfg.channels)
            for i, fn in enumerate((trunk_fn, trunk_v2)):
                got, want = fn(xs), trunk_reference(xs, fn.segments)
                torch.cuda.synchronize()
                d, rel = rel_err(got, want)
                if not (bool(torch.isfinite(got.float()).all()) and rel <= TRUNK_TOL):
                    raise AssertionError(f"{name} N={N} trunk v{i + 1} vs plain: "
                                         f"max |d| {d}, relative {rel}")
                trunk_rel[i] = max(trunk_rel[i], rel)
        log(f"phase 5: {name}: kernel vs plain per call max relative {kernel_rel:.3e} "
            f"(bound {KERNEL_TOL}); trunk v1 {trunk_rel[0]:.3e}, v2 {trunk_rel[1]:.3e} "
            f"(bound {TRUNK_TOL}) at N in {list(TRUNK_BATCHES)}")

    # The bench model: fused trunk vs the plain bf16 model, then times.
    model = forward_model
    cfg = model.config
    planes, scalars, plain_out = forward_batch
    trunk_fn = build_trunk_fn(cfg, model)
    fused = model(planes, scalars, trunk_fn=trunk_fn)
    check_finite(fused, ModelOutputs._fields, "fused bf16")
    top1 = float((fused.pi_logits.argmax(-1) == plain_out.pi_logits.argmax(-1)
                  ).float().mean())
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    dv = float((value(fused) - value(plain_out)).abs().max())
    log(f"phase 5: fused-trunk model vs plain bf16 model on {planes.shape[0]} "
        f"positions: top-1 agreement {top1:.4f}, max |d value| {dv:.3e}")
    if top1 < 0.95:
        raise AssertionError(f"fused-trunk top-1 agreement {top1} < 0.95")
    net = ServeNet(model)
    for N in TRUNK_TIMED:
        p_n, s_n = batched_features(type(boards)(*[t[:N] for t in boards]),
                                    planes_dtype=model.dtype)
        xs = stem_activations(model, boards, N).reshape(N, 19, 19, cfg.channels)
        x_nchw = xs.permute(0, 3, 1, 2).contiguous()
        rows = {
            "fused_trunk": lambda: trunk_fn(xs),
            "plain_trunk": lambda: trunk_reference(xs, trunk_fn.segments),
            "servenet_trunk": lambda: net.trunk(x_nchw),
            "servenet_forward": lambda: net(p_n, s_n),
            "fused_forward": lambda: model(p_n, s_n, trunk_fn=trunk_fn),
        }
        for row, fn in rows.items():
            times[f"{row}@{N}"] = (device_ms(fn, 10), wall_ms(fn, 3, 5))
            log(f"phase 5: {TRUNK_CONFIGS[0]} N={N} {row}: device {times[f'{row}@{N}'][0]:.3f} ms, "
                f"wall {times[f'{row}@{N}'][1]:.3f} ms per call")
    for k in ("trunk_segment", "trunk_broadcast"):
        log(f"phase 5: N={max(TRUNK_TIMED)} {k}: device {times[k][0]:.4f} ms vs plain "
            f"{times[k + '_plain'][0]:.4f} ms; wall {times[k][1]:.4f} vs "
            f"{times[k + '_plain'][1]:.4f} ms; bound {times[k + '_bound'][0]:.4f} ms "
            f"({times[k + '_bound'][1]})")
    return max_err, times, kernel_rows


def kernel_row(kern, w, x):
    """A trunk kernel (segment or broadcast) on x: device time per call,
    its work, bound and share of it, and its products alone in PyTorch
    (library_products_ms)."""
    n = x.shape[0]
    segment = kern is trunk_ops.trunk_segment
    ms = device_ms(lambda: kern(x, w), 10)
    flops, nbytes = (segment_work if segment else broadcast_work)(w, n)
    b_ms, b_by = bound_ms(flops, nbytes)
    products = segment_library_products if segment else broadcast_library_products
    lib_ms = device_ms(products(w, x), 10)
    row = {"ms": ms, "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
           "library_products_ms": lib_ms}
    if segment:
        row["n_blocks"] = int(w.aff.shape[0])
        what = (f"trunk_segment N={n} ({row['n_blocks']} blocks)",
                "bf16 F.conv2d + torch.matmul; no single PyTorch call computes the segment")
    else:
        what = (f"trunk_broadcast N={n}", "bf16 torch.matmul x.Wf, WdT.m, z.Wl; no single "
                "PyTorch call computes the broadcast block")
    log(f"phase 5: {what[0]}: device {ms:.4f} ms, {row['gflop']:.1f} GFLOP, "
        f"{row['tflops']:.1f} TFLOP/s; bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * row['share_of_bound']:.1f}% of it; library_products_ms {lib_ms:.4f} "
        f"(the same products alone, {what[1]})")
    return row


def check_moves(prev, active, move, after, what: str) -> None:
    """Every active board's move was legal and superko-clean (and placed its
    stone)."""
    b = torch.arange(prev.stones.shape[0], device=prev.stones.device)
    libs = point_liberties_reference(prev.stones, prev.chain_id)
    ok_legal = legal_mask_from_libs(prev, libs)[b, move]
    ok_superko = ~superko_violation(prev, move)
    on_board = move < PASS_MOVE
    placed = after.stones[b, move.clamp(max=PASS_MOVE - 1)] == prev.to_move
    bad = active & ~(ok_legal & ok_superko & (~on_board | placed))
    if bool(bad.any()):
        raise AssertionError(f"{what}: illegal move on boards {b[bad].tolist()[:8]}")


def check_ply(prev, active, move, pi, after, what: str) -> None:
    """check_moves, and every active board's pi_improved finite and summing
    to 1."""
    check_moves(prev, active, move, after, what)
    pis = pi[active]
    if not bool(torch.isfinite(pis).all()):
        raise AssertionError(f"{what}: pi_improved not finite")
    err = float((pis.sum(-1) - 1.0).abs().max())
    if err > 1e-4 or pis.shape[1] != NUM_MOVES:
        raise AssertionError(f"{what}: pi_improved sums off by {err}")


def phase_selfplay(device, model, gen, eval_fn, plies, phase):
    """`plies` plies of the tiered self-play step with resets; returns
    (launches of each kernel in KERNELS during the run, plies/s, moves/s)."""
    B = BENCH_B
    cfg = SelfplayConfig(batch_size=B)
    params_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                              visit_group=4)
    params_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                               visit_group=4)
    reuse_capacity = 64
    states = new_state(B, cfg.komi, device=device)
    buf = make_game_buffer(B, cfg.max_game_len, device)
    aux = make_aux(B, gen, device=device)
    aux = aux._replace(raw_until=aux.raw_until * 0)  # full search, as bench
    tree = make_tree(B, reuse_capacity, device)
    b = torch.arange(B, device=device)

    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moves_played = 0
    resets = 0
    checks = []
    for ply in range(plies):
        prev = states
        active = ~finished_mask(prev, cfg)
        states, buf, aux, tree = selfplay_step_tiered(
            states, buf, aux, eval_fn, params_sel, params_fast, cfg,
            generator=gen, reuse_tree=tree, reuse_capacity=reuse_capacity)
        t = prev.move_count.long().clamp(max=cfg.max_game_len - 1)
        checks.append((prev, active, buf.move[b, t].long(), buf.pi[b, t].clone(),
                       states))
        moves_played += int(active.sum())
        if (ply + 1) % RESET_EVERY == 0:
            done = finished_mask(states, cfg)
            states, buf, aux, tree = reset_finished(
                states, buf, aux, done, cfg.komi, generator=gen,
                max_raw_policy_moves=0, reuse_tree=tree)
            resets += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in KERNELS}

    for ply, check in enumerate(checks):
        check_ply(*check, f"phase {phase} ply {ply}")
    log(f"phase {phase}: {plies} plies at B={B}, {resets} resets, {moves_played} moves "
        f"in {dt:.2f} s; every move legal and superko-clean, pi_improved sums to 1; "
        f"launches {launches}")
    return launches, plies / dt, moves_played / dt


def play_learn(sl: RLSlice, device):
    """Step 1 of phase 7: plies of `sl.play_moves` until LEARN_B games are
    harvested. Harvests are timed and every scored batch is recorded (the
    slice itself calls the real functions). Returns (plies, seconds,
    [(harvest ms, games)], [(finished states, (black, white, ownership))],
    (label sweeps, Benson sweeps))."""
    scored, harvests = [], []
    real_scores, real_harvest = rl_slice.final_scores, sl._harvest

    def spy_scores(states):
        out = real_scores(states)
        scored.append((states, out))
        return out

    def timed_harvest(done):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = real_harvest(done)
        torch.cuda.synchronize()
        harvests.append((1e3 * (time.perf_counter() - t0), n))
        return n

    sweeps0 = (min_labels.sweeps, pass_alive_for_color.sweeps)
    rl_slice.final_scores, sl._harvest = spy_scores, timed_harvest
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        harvested = plies = 0
        while harvested < LEARN_B:
            if plies >= LEARN_MAX_GAME_LEN + 2:
                raise AssertionError(f"phase 7: {harvested} games harvested in {plies} plies")
            harvested += sl.play_moves(1)
            plies += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        rl_slice.final_scores = real_scores
        del sl._harvest
    sweeps = (min_labels.sweeps - sweeps0[0], pass_alive_for_color.sweeps - sweeps0[1])
    return plies, seconds, harvests, scored, sweeps


def check_scores(scored) -> int:
    """Each recorded scoring on the card equals the same function on the
    CPU, exactly. Returns the number of boards checked."""
    n = 0
    for states, out in scored:
        want = final_scores(map_state(lambda t: t.cpu(), states))
        for name, got, w in zip(("black", "white", "ownership"), out, want):
            if got.dtype != w.dtype or not torch.equal(got.cpu(), w):
                raise AssertionError(f"phase 7: {name} scores on the card != CPU")
        n += states.stones.shape[0]
    return n


def check_prepare(rows, device):
    """prepare_batch on the card against the CPU with the same symmetries:
    planes, scalars and targets equal. Returns the card's batch and the
    liberty launches it made."""
    syms = torch.randint(0, 8, (LEARN_TRAIN_B,), generator=torch.Generator().manual_seed(5))
    before = point_liberties_batch.launches
    card = prepare_batch(rows, syms=syms.to(device), device=device)
    launched = point_liberties_batch.launches - before
    cpu = prepare_batch(rows, syms=syms, device="cpu")
    pairs = [("planes", card[0], cpu[0]), ("scalars", card[1], cpu[1])]
    pairs += [(f, getattr(card[2], f), getattr(cpu[2], f)) for f in card[2]._fields]
    for name, got, want in pairs:
        if got.dtype != want.dtype or not torch.equal(got.cpu(), want):
            raise AssertionError(f"phase 7: prepare_batch {name} on the card != CPU")
    if launched <= 0:
        raise AssertionError("phase 7: prepare_batch on the card launched no liberty kernel")
    return card, launched


def train_split(model, tx, coeffs, planes, scalars, targets, reps: int = 5):
    """Medians over `reps` of: the train-mode forward + losses, forward +
    backward, and the optimizer update + apply, each timed by CUDA events
    (ms). Each run updates the model, as a step does."""
    params = dict(model.named_parameters())
    opt_state = tx.init(params)
    fwd, fwd_bwd, opt = [], [], []
    for _ in range(reps):
        fwd.append(event_ms(lambda: compute_losses(model(planes, scalars, train=True),
                                                   targets, coeffs)["loss"]))
        grads = {}

        def fb():
            loss = compute_losses(model(planes, scalars, train=True), targets, coeffs)["loss"]
            grads.update(zip(params, torch.autograd.grad(loss, list(params.values()))))
        fwd_bwd.append(event_ms(fb))

        def step_opt():
            nonlocal opt_state
            updates, opt_state = tx.update(grads, opt_state, params)
            apply_updates(params, updates)
        opt.append(event_ms(step_opt))
    f, fb_, o = (statistics.median(x) for x in (fwd, fwd_bwd, opt))
    return {"forward_ms": f, "backward_ms": fb_ - f, "optimizer_ms": o}


def phase_learn(device, smi):
    """Phase 7 (see the module docstring). Returns (liberty launches of the
    phase, the {"learn": ...} measurements)."""
    t_phase = time.perf_counter()
    cfg = SliceConfig(model=LEARN_MODEL, batch_size=LEARN_B, train_batch_size=LEARN_TRAIN_B,
                      selfplay=SelfplayConfig(batch_size=LEARN_B,
                                              max_game_len=LEARN_MAX_GAME_LEN),
                      dtype="bfloat16", seed=0)
    sl = RLSlice(cfg, device=device)
    torch.cuda.reset_peak_memory_stats(device)
    for k in KERNELS:
        k.launches = 0

    # 1. self-play until B games are harvested.
    plies, play_s, harvests, scored, sweeps = play_learn(sl, device)
    games = sum(n for _, n in harvests)
    harvest_ms = sum(ms for ms, _ in harvests)
    log(f"phase 7: {plies} plies of B={LEARN_B} ({play_s:.2f} s), {games} games harvested "
        f"in {len(harvests)} harvests, {len(sl.replay)} replay rows; harvest "
        f"{harvest_ms:.1f} ms in all, {harvest_ms / games:.3f} ms per game; scoring sweeps: "
        f"{sweeps[0]} labelling, {sweeps[1]} Benson ({smi})")

    # 2. one replay batch through prepare_batch, card against CPU.
    rows = sl.replay.sample(LEARN_TRAIN_B)
    (planes, scalars, targets), prep_launches = check_prepare(rows, device)
    prep_ms = statistics.median(
        event_ms(lambda: prepare_batch(rows, generator=sl.generator, device=device))
        for _ in range(5))
    log(f"phase 7: prepare_batch card == CPU (planes, scalars, {len(targets)} targets) "
        f"at N={LEARN_TRAIN_B}, {prep_launches} liberty launch(es); {prep_ms:.3f} ms per call")

    # 3. training steps from the replay buffer, then on one fixed batch.
    step_losses = [sl.train_steps(1) for _ in range(LEARN_STEPS)]
    for i, losses in enumerate(step_losses):
        bad = [k for k, v in losses.items() if not torch.isfinite(torch.tensor(v))]
        if bad or not losses["grad_norm"] > 0:
            raise AssertionError(f"phase 7: train step {i}: non-finite {bad} or grad_norm "
                                 f"{losses['grad_norm']}")
    series = lambda key, fmt: ", ".join(fmt.format(x[key]) for x in step_losses)
    log(f"phase 7: {LEARN_STEPS} sgd_nesterov steps (lr {cfg.lr}): loss "
        f"{series('loss', '{:.4f}')}; grad_norm {series('grad_norm', '{:.3f}')}")
    state, train_step = sl.train_state, sl._train_step
    fixed, times = [], []
    for i in range(LEARN_STEPS + 2):
        out = {}

        def one():
            nonlocal state
            state, out["losses"] = train_step(state, planes, scalars, targets)
        ms = event_ms(one)
        fixed.append(float(out["losses"]["loss"]))
        if i >= 2:
            times.append(ms)
    sl.train_state = state
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"phase 7: loss on one fixed batch did not fall: {fixed}")
    step_ms = statistics.median(times)
    log(f"phase 7: {LEARN_STEPS + 2} steps on one fixed batch: loss {fixed[0]:.4f} -> "
        f"{fixed[-1]:.4f}; {step_ms:.3f} ms per step (median of {LEARN_STEPS} after 2 "
        f"warm-up), {LEARN_TRAIN_B / step_ms * 1e3:.0f} examples/s ({smi})")
    split = train_split(sl.model, sl.tx, LossCoeffs.rl(), planes, scalars, targets)
    log(f"phase 7: step split (CUDA events, medians of 5): forward + losses "
        f"{split['forward_ms']:.3f} ms, backward {split['backward_ms']:.3f} ms, optimizer "
        f"{split['optimizer_ms']:.3f} ms")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            state, _ = train_step(state, planes, scalars, targets)
        torch.cuda.synchronize()
        prof_wall = 1e3 * (time.perf_counter() - t0) / 2
    sl.train_state = state
    by_class, kernels_per_step = kernel_classes(prof, 2)
    busy = sum(by_class.values())
    if busy <= 0 and device.type == "cuda":
        raise RuntimeError("the profiler recorded no device time for the train step")
    log(f"phase 7: profiled step: device busy {busy:.3f} of {prof_wall:.3f} ms wall "
        f"(idle {100 * (1 - busy / prof_wall):.0f}%), {kernels_per_step:.0f} kernels per step")
    for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        log(f"phase 7:   {cls}: {ms:.3f} ms per step ({100 * ms / busy:.1f}%)")
    muon_model = copy.deepcopy(sl.model)
    muon_tx = conv_muon(cfg.lr)
    muon_state = create_train_state(muon_model, muon_tx)
    muon_step = make_train_step(muon_model, muon_tx, LossCoeffs.rl())
    for i in range(2):
        muon_state, ml = muon_step(muon_state, planes, scalars, targets)
        if not (all(bool(torch.isfinite(v)) for v in ml.values()) and float(ml["grad_norm"]) > 0):
            raise AssertionError(f"phase 7: conv_muon step {i}: {ml}")
    log(f"phase 7: 2 conv_muon steps on a copy: loss {float(ml['loss']):.4f}, "
        f"grad_norm {float(ml['grad_norm']):.3f}")
    del muon_model, muon_state

    # 4. SWA, BN refresh, validation, checkpoint round trip.
    snaps = SnapshotManager(interval=1)
    snaps.maybe_snapshot(state.step, state.params)
    avg = snaps.final(state.params)
    sl.model.load_state_dict(avg, strict=False)
    batches = [prepare_batch(sl.replay.sample(LEARN_TRAIN_B), generator=sl.generator,
                             device=device) for _ in range(4)]
    passes = recompute_batch_stats(sl.model, [(p, s) for p, s, _ in batches], num_passes=4)
    val = validate(sl.model, batches[:2], LossCoeffs.rl())
    if passes != 4 or not all(torch.isfinite(torch.tensor(v)) for v in val.values()):
        raise AssertionError(f"phase 7: BN refresh passes {passes}, validation {val}")
    with tempfile.TemporaryDirectory() as root:
        tree = {"model": sl.model.state_dict(), "opt_state": state.opt_state,
                "step": state.step}
        path = checkpoint.save_checkpoint(root, 1, tree)
        back = checkpoint.restore_checkpoint(path)
        fresh = build_model(get_config(LEARN_MODEL), torch.bfloat16, device)
        fresh.load_state_dict(back["model"])
        same = all(torch.equal(fresh.state_dict()[k], v) for k, v in sl.model.state_dict().items())
        same &= all(torch.equal(back["opt_state"]["trace"][k], v)
                    for k, v in state.opt_state["trace"].items())
        if not same or back["step"] != state.step or checkpoint.latest_generation(root) != 1:
            raise AssertionError("phase 7: checkpoint round trip is not bitwise equal")
    log(f"phase 7: SWA snapshot + {passes}-pass BN refresh; validation on 2 batches: loss "
        f"{val['loss']:.4f}, policy_acc {val['policy_acc']:.4f}; checkpoint save -> restore "
        f"into a fresh model bitwise equal")

    # 5. two plies with the trained weights.
    sl.refresh_weights()
    for ply in range(2):
        prev = sl.states
        active = ~finished_mask(prev, cfg.selfplay)
        sl.play_moves(1)
        b = torch.arange(LEARN_B, device=device)
        t = prev.move_count.long().clamp(max=LEARN_MAX_GAME_LEN - 1)
        kept = active & (sl.states.move_count > 0)  # a board harvested this ply was reset
        check_ply(prev, kept, sl.buf.move[b, t].long(), sl.buf.pi[b, t], sl.states,
                  f"phase 7 trained ply {ply}")
    torch.cuda.synchronize()
    launches = point_liberties_batch.launches
    if launches <= 0:
        raise AssertionError("the liberty kernel was not launched by phase 7")
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9
    boards = check_scores(scored)
    wall = time.perf_counter() - t_phase
    log(f"phase 7: 2 plies with the trained weights: every move legal and superko-clean, "
        f"pi_improved sums to 1; harvested scores card == CPU on {boards} boards; liberty "
        f"launches {launches}; peak memory {peak_gb:.2f} GB; phase wall {wall:.1f} s")
    learn = {
        "model": LEARN_MODEL, "boards": LEARN_B, "train_batch": LEARN_TRAIN_B,
        "plies": plies, "play_s": play_s, "games": games, "harvests": len(harvests),
        "harvest_ms": harvest_ms, "harvest_ms_per_game": harvest_ms / games,
        "label_sweeps": sweeps[0], "benson_sweeps": sweeps[1],
        "prepare_batch_ms": prep_ms, "step_ms": step_ms,
        "examples_per_s": LEARN_TRAIN_B / step_ms * 1e3, **split,
        "profiled_step_busy_ms": busy, "profiled_step_wall_ms": prof_wall,
        "kernels_per_step": kernels_per_step, "device_ms_by_class": by_class,
        "fixed_batch_loss": fixed, "peak_memory_gb": peak_gb,
        "liberty_launches": launches, "phase_wall_s": wall, "card": smi,
    }
    return launches, learn


def gen_config():
    """config/b12-onegen.json with phase 8's cuts (GEN_CUTS)."""
    cfg = parse_run_config(GEN_CONFIG)
    return dataclasses.replace(cfg, **GEN_CUTS)


class GenSpies:
    """Records what phase 8 checks and times, by wrapping the loop's own
    calls (module functions it calls by name, and its methods): every ply's
    boards and moves, each harvest, each SGF text, each eval ply and the
    eval's final winners, and the wall time of each part (host clock after
    a synchronize)."""

    def __init__(self, loop: GenerationLoop):
        self.loop = loop
        self.plies, self.harvests, self.sgfs, self.finals = [], [], [], []
        self.seconds = {}
        self.eval_plies = 0
        self.train_steps = 0
        self.flushed = 0
        self.restarts = 0
        self._undo = []

    def _patch(self, owner, name, wrapper):
        real = getattr(owner, name)
        self._undo.append((owner, name, real, name in vars(owner)))
        setattr(owner, name, wrapper(real))

    def _timed(self, key):
        def wrap(real):
            def fn(*a, **kw):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = real(*a, **kw)
                torch.cuda.synchronize()
                self.seconds.setdefault(key, []).append(time.perf_counter() - t0)
                return out
            return fn
        return wrap

    def __enter__(self):
        loop, sp_cfg = self.loop, self.loop.sp_cfg

        def ply(real):
            def fn(states, buf, aux, *a, **kw):
                active = ~is_game_over(states)  # the boards the step records
                out = real(states, buf, aux, *a, **kw)
                b = torch.arange(states.stones.shape[0], device=states.stones.device)
                t = states.move_count.long().clamp(max=sp_cfg.max_game_len - 1)
                self.plies.append((states, active, out[1].move[b, t].long().clone(),
                                   out[1].pi[b, t].clone(), out[0]))
                return out
            return fn

        def harvest(real):
            def fn(done):
                idx = np.flatnonzero(done)
                self.harvests.append((len(self.plies), idx, loop._init_mv.copy(),
                                      len(self.sgfs)))
                self._timed("harvest")(real)(done)
                self.restarts += int((~loop._is_fresh[idx]).sum())
            return fn

        def sgf(real):
            def fn(*a, **kw):
                text = real(*a, **kw)
                self.sgfs.append(text)
                return text
            return fn

        def flush(real):
            def fn(model):
                n = real(model)
                self.flushed += n
                return n
            return fn

        def train(real):
            def fn(*a, **kw):
                step0 = loop.train_state.step
                out = real(*a, **kw)
                self.train_steps += loop.train_state.step - step0
                return out
            return fn

        def eval_ply(real):
            def fn(*a, **kw):
                self.eval_plies += 1
                return real(*a, **kw)
            return fn

        def finish(real):
            def fn(states, resigned, winner, cand_is_black):
                res = real(states, resigned, winner, cand_is_black)
                bs, ws, _ = score_boards(states)
                final = torch.where(winner != 0, winner.long(),
                                    torch.where(bs > ws, 1, -1))
                cand = torch.where(cand_is_black, 1, -1)
                self.finals.append((res, int((final == cand).sum()),
                                    int((final == -cand).sum())))
                return res
            return fn

        self._patch(rl_loop, "selfplay_step_tiered", ply)
        self._patch(rl_loop, "game_to_sgf", sgf)
        self._patch(harness, "_eval_ply", eval_ply)
        self._patch(harness, "_finish", finish)
        self._patch(loop, "_harvest", harvest)
        self._patch(loop.fork, "flush", flush)
        self._patch(loop.fork, "flush", self._timed("fork_flush"))
        self._patch(loop, "selfplay_games", self._timed("selfplay"))
        self._patch(loop, "train_epoch", train)
        self._patch(loop, "train_epoch", self._timed("train_epoch"))
        self._patch(loop, "build_candidate", self._timed("bn_refresh"))
        self._patch(loop, "validate", self._timed("validation"))
        self._patch(loop, "evaluate_candidate", self._timed("eval"))
        self._patch(loop, "save_resume", self._timed("checkpoint"))
        return self

    def __exit__(self, *exc):
        for owner, name, real, own in reversed(self._undo):
            if own:
                setattr(owner, name, real)
            else:
                delattr(owner, name)
        return False

    def total(self, key) -> float:
        return sum(self.seconds.get(key, ()))


def check_gen_sgfs(spies: GenSpies, B: int, max_len: int) -> int:
    """Each SGF the harvests wrote parses back with the port's parser into
    the moves its board played since its game began, and each file on disk
    is one of them. Returns the number of games checked.

    Two features of the record format, the JAX package's: rows before a
    restart's first move are empty records, and a board that reached the
    length cap goes on playing until its harvest, rewriting its last row,
    so that row holds the last move played."""
    log_np = [(prev.to_move.cpu().numpy(), active.cpu().numpy(), move.cpu().numpy())
              for prev, active, move, _, _ in spies.plies]
    started = np.zeros(B, np.int64)
    checked = 0
    for ply_idx, idx, init_mv, first_sgf in spies.harvests:
        for i, b in enumerate(idx):
            played = [(int(c[b]), int(m[b])) for c, a, m in log_np[started[b]:ply_idx] if a[b]]
            started[b] = ply_idx
            moves = extract_moves(parse_sgf(spies.sgfs[first_sgf + i]))
            rows = max(max_len - int(init_mv[b]), 0)
            if len(played) > rows:
                played = played[:rows - 1] + played[-1:] if rows else []
            if moves[int(init_mv[b]):] != played:
                raise AssertionError(
                    f"phase 8: board {b}'s SGF (from move {init_mv[b]}: "
                    f"{moves[int(init_mv[b]):][:8]}..., {len(moves)} rows) != the "
                    f"{len(played)} moves it played ({played[:8]}...)")
            checked += 1
    on_disk = set()
    for name in os.listdir(spies.loop.sgf_dir):
        with open(os.path.join(spies.loop.sgf_dir, name)) as f:
            on_disk.add(f.read())
    if not on_disk or not on_disk <= set(spies.sgfs):
        raise AssertionError("phase 8: an SGF on disk is none of the games written")
    return checked


def check_resume(loop: GenerationLoop, cfg, root: str, device):
    """A second loop on the same directory resumes bitwise: gen, golden,
    train params and BN statistics, optimizer state, step, generators,
    sel_mult base and both replay rings."""
    again = GenerationLoop(cfg, root_dir=root, seed=GEN_SEED, device=device)
    if not again.try_resume():
        raise AssertionError("phase 8: try_resume found nothing")
    same = lambda a, b: a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    ts, ts2 = loop.train_state, again.train_state
    checks = {
        "gen": again.gen == loop.gen == 1,
        "golden": same(again.golden.state_dict(), loop.golden.state_dict()),
        "params": same(ts2.params, ts.params),
        "batch_stats": same(ts2.batch_stats, ts.batch_stats),
        "opt_state": (ts2.opt_state["count"] == ts.opt_state["count"]
                      and same(ts2.opt_state["trace"], ts.opt_state["trace"])),
        "step": ts2.step == ts.step,
        "generator": torch.equal(again.generator.get_state(), loop.generator.get_state()),
        "np_rng": again._np_rng.bit_generator.state == loop._np_rng.bit_generator.state,
        "sel_mult_base": again.sel_mult_base == loop.sel_mult_base,
    }
    for name in ("replay", "val_replay"):
        r, r2 = getattr(loop, name), getattr(again, name)
        n = len(r)
        checks[name] = ((len(r2), r2.games_added, r2.total_added)
                        == (n, r.games_added, r.total_added)
                        and all(np.array_equal(r2._data[f][:n], a[:n]) for f, a in r._data.items()))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 8: resume is not bitwise for {bad}")
    return again


def phase_gen(device, smi, root):
    """Phase 8 (see the module docstring), in the empty directory `root`,
    which keeps model_0001 and the SGFs for phase 10. Returns (liberty
    launches of the generation, the {"gen": ...} measurements)."""
    t_phase = time.perf_counter()
    cfg = gen_config()
    B = cfg.selfplay_batch_size
    loop = GenerationLoop(cfg, root_dir=root, seed=GEN_SEED, device=device)
    loop.sgf_dir = os.path.join(root, "sgf")
    torch.cuda.reset_peak_memory_stats(device)
    for k in KERNELS:
        k.launches = 0
    with GenSpies(loop) as spies:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = loop.run_generation()
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
    launches = point_liberties_batch.launches
    peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

    for ply, check in enumerate(spies.plies):
        check_ply(*check, f"phase 8 self-play ply {ply}")
    games = check_gen_sgfs(spies, B, cfg.selfplay_max_game_len)
    stats = os.listdir(loop.stats_dir)
    res, wins, losses = spies.finals[-1]
    checks = {
        "gen == 1": info["gen"] == loop.gen == 1,
        "model_0001": os.path.isdir(os.path.join(root, "model_0001")),
        "elo_history.txt": os.path.exists(os.path.join(root, "elo_history.txt")),
        "one .stats file": len(stats) == 1 and stats[0].endswith(".stats"),
        "calibration": (compute_calibration(loop.stats_dir, 0) is not None
                        and os.path.exists(os.path.join(root, "sel_mult_calib.txt"))),
        "reuse buffer": len(loop.reuse) > 0,
        "fork flush": spies.flushed > 0,
        "eval wins + losses": (res.cand_wins == wins
                               and wins + losses == res.num_games == cfg.eval_games),
        "liberty kernel launched": launches > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 8: failed checks {bad}")
    restarts = spies.restarts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check_resume(loop, cfg, root, device)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0

    cuts = ", ".join(f"{k}={v}" for k, v in GEN_CUTS.items())
    parts = {
        "selfplay_s": spies.total("selfplay"), "selfplay_plies": len(spies.plies),
        "harvests": len(spies.harvests), "harvest_ms": 1e3 * spies.total("harvest"),
        "fork_flush_ms": 1e3 * spies.total("fork_flush"), "forks_flushed": spies.flushed,
        "train_epoch_s": spies.total("train_epoch"), "train_steps": spies.train_steps,
        "bn_refresh_s": spies.total("bn_refresh"), "validation_s": spies.total("validation"),
        "eval_s": spies.total("eval"), "eval_plies": spies.eval_plies,
        "checkpoint_s": spies.total("checkpoint"), "resume_s": resume_s,
    }
    log(f"phase 8: GenerationLoop(config/b12-onegen.json, bf16) with cuts {cuts}: "
        f"{games} games harvested and checked ({restarts} GoExploit/fork restarts), "
        f"every move legal and superko-clean, every SGF parses back into its moves; "
        f"eval {res.cand_wins:.0f} wins + {losses} losses of {res.num_games}, elo "
        f"{res.elo:.1f}; replay {len(loop.replay)} rows, val {len(loop.val_replay)}, reuse "
        f"buffer {len(loop.reuse)}; resume bitwise")
    log("phase 8: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                for k, v in parts.items())
        + f"; generation {gen_s:.2f} s; liberty launches {launches}; peak memory "
        f"{peak_gb:.2f} GB; phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")
    gen = {"config": "config/b12-onegen.json", "cuts": GEN_CUTS, "seed": GEN_SEED,
           "generation_s": gen_s, **parts, "games_checked": games, "restarts": restarts,
           "eval_elo": res.elo, "eval_cand_wins": res.cand_wins,
           "replay_rows": len(loop.replay), "liberty_launches": launches,
           "peak_memory_gb": peak_gb, "phase_wall_s": time.perf_counter() - t_phase,
           "card": smi}
    return launches, gen


def settled_boards(B: int, device, to_move=1):
    """B copies of a settled endgame built with from_stones: Black fills
    columns 0-9 and White columns 10-18, each group with two one-point
    eyes, so the side to move has two legal moves (filling an own eye) and
    the pass."""
    s = np.zeros((19, 19), np.int8)
    s[:, :10] = 1
    s[:, 10:] = -1
    for r, c in ((3, 3), (15, 3), (3, 15), (15, 15)):
        s[r, c] = 0
    return from_stones(np.repeat(s.reshape(1, -1), B, axis=0), 7.5, to_move,
                       device=device)


def search_config():
    """config/r4-b8c64-curve.json with phase 9's cuts and switches."""
    return dataclasses.replace(parse_run_config(SEARCH_CONFIG), **SEARCH_CUTS,
                               **SEARCH_SWITCHES)


def syncs_per_search(counts: dict) -> float:
    return sum(counts["syncs"].values()) / max(counts["searches"], 1)


def search_generation(device):
    """Phase 9 (a): one GenerationLoop generation with every self-play
    extra the configuration turns on. Returns its measurements."""
    cfg = search_config()
    B = cfg.selfplay_batch_size
    with tempfile.TemporaryDirectory() as root:
        loop = GenerationLoop(cfg, root_dir=root, seed=SEARCH_SEED, device=device)
        settled = torch.arange(B, device=device) % SEARCH_SETTLED_SHARE == 0
        loop.states = select_state(settled, settled_boards(B, device), loop.states)
        loop._bind_selfplay()
        params_sel, params_fast, _ = loop._sp
        budget = {"selected": visit_budget(params_sel), "fast": visit_budget(params_fast)}
        visits, used, sp_counts = [], [], {}
        b = torch.arange(B, device=device)

        def step_spy(real):
            def fn(states, buf, aux, *a, **kw):
                active = ~is_game_over(states)
                out = real(states, buf, aux, *a, **kw)
                t = states.move_count.long().clamp(max=cfg.selfplay_max_game_len - 1)
                visits.append(torch.where(active, out[1].visits[b, t], 0).max())
                used.append(out[-1].used.sum())
                return out
            return fn

        def selfplay_spy(real):
            def fn(*a, **kw):
                n = real(*a, **kw)
                sp_counts.update(search.COUNTERS.snapshot())
                return n
            return fn

        for k in KERNELS:
            k.launches = 0
        search.COUNTERS.reset()
        with GenSpies(loop) as spies:
            spies._patch(rl_loop, "selfplay_step_tiered", step_spy)
            spies._patch(loop, "selfplay_games", selfplay_spy)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = loop.run_generation()
            torch.cuda.synchronize()
            gen_s = time.perf_counter() - t0
        launches = point_liberties_batch.launches
        counts = search.COUNTERS.snapshot()
        for ply, check in enumerate(spies.plies):
            check_ply(*check, f"phase 9 self-play ply {ply}")
        res, wins, losses = spies.finals[-1]
        max_visits = int(torch.stack(visits).max())
        max_used = int(torch.stack(used).max())
        checks = {
            "gen == 1": info["gen"] == loop.gen == 1,
            "model_0001": os.path.isdir(os.path.join(root, "model_0001")),
            "eval wins + losses": (res.cand_wins == wins
                                   and wins + losses == res.num_games == cfg.eval_games),
            "visits within budget": max_visits <= max(budget.values()),
            "a round stopped early": sp_counts.get("early_stops", 0) > 0,
            "a bias slot filled": max_used > 0,
            "a leaf scored exactly": sp_counts["exact_scored"] > 0,
            "liberty kernel launched": launches > 0,
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"phase 9 (a): failed checks {bad}")
    plies = len(spies.plies)
    return {
        "config": "config/r4-b8c64-curve.json", "cuts": SEARCH_CUTS,
        "smoke_switches": SEARCH_SWITCHES, "seed": SEARCH_SEED, "generation_s": gen_s,
        "selfplay_s": spies.total("selfplay"), "selfplay_plies": plies,
        "harvests": len(spies.harvests), "harvest_ms": 1e3 * spies.total("harvest"),
        "train_epoch_s": spies.total("train_epoch"), "bn_refresh_s": spies.total("bn_refresh"),
        "validation_s": spies.total("validation"), "eval_s": spies.total("eval"),
        "eval_plies": spies.eval_plies, "checkpoint_s": spies.total("checkpoint"),
        "eval_cand_wins": res.cand_wins, "eval_games": res.num_games,
        "visit_budget": budget, "max_visits": max_visits, "max_bias_slots_used": max_used,
        "selfplay_searches": sp_counts["searches"], "selfplay_syncs": sp_counts["syncs"],
        "selfplay_syncs_per_search": syncs_per_search(sp_counts),
        "selfplay_syncs_per_ply": sum(sp_counts["syncs"].values()) / max(plies, 1),
        "early_stops": sp_counts.get("early_stops", 0),
        "exact_scored_leaves": sp_counts["exact_scored"],
        "syncs_with_eval": counts["syncs"], "liberty_launches": launches,
    }


def search_eval(device):
    """Phase 9 (b): run_eval of a PUCT player against a Gumbel player with
    MCGS and the integral utility. Returns its measurements."""
    gen_cpu = torch.Generator().manual_seed(SEARCH_SEED + 5)
    cand = seeded_model(SEARCH_MODEL, device, gen_cpu, torch.bfloat16)
    cur = seeded_model(SEARCH_MODEL, device, gen_cpu, torch.bfloat16)
    cfg = harness.EvalConfig(cand=PlayerSearchConfig(**EXTRAS_PUCT),
                             cur=PlayerSearchConfig(**EXTRAS_GUMBEL), **EXTRAS_EVAL)
    plies, finals, search_s = [], [], {"puct": [], "gumbel": []}
    real_ply, real_finish = harness._eval_ply, harness._finish
    real_puct, real_gumbel = harness.search_root_puct, harness.search_root

    def timed(real, key):
        def fn(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = real(*a, **kw)
            torch.cuda.synchronize()
            search_s[key].append(time.perf_counter() - t0)
            return out
        return fn

    def ply(generator, states, resigned, *a, **kw):
        out = real_ply(generator, states, resigned, *a, **kw)
        plies.append((states, out[0]))
        return out

    def finish(states, resigned, winner, cand_is_black):
        res = real_finish(states, resigned, winner, cand_is_black)
        bs, ws, _ = score_boards(states)
        final = torch.where(winner != 0, winner.long(), torch.where(bs > ws, 1, -1))
        cand = torch.where(cand_is_black, 1, -1)
        finals.append((res, int((final == cand).sum()), int((final == -cand).sum())))
        return res

    for k in KERNELS:
        k.launches = 0
    search.COUNTERS.reset()
    harness._eval_ply, harness._finish = ply, finish
    harness.search_root_puct = timed(real_puct, "puct")
    harness.search_root = timed(real_gumbel, "gumbel")
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = harness.run_eval(make_eval_fn(cand), make_eval_fn(cur), cfg,
                               generator=torch.Generator(device=device).manual_seed(3),
                               device=device)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
    finally:
        harness._eval_ply, harness._finish = real_ply, real_finish
        harness.search_root_puct, harness.search_root = real_puct, real_gumbel
    counts = search.COUNTERS.snapshot()
    for i, (prev, after) in enumerate(plies):
        moved = after.move_count > prev.move_count
        check_moves(prev, moved, after.last_moves[:, -1].long(), after,
                    f"phase 9 (b) eval ply {i}")
    _, wins, losses = finals[-1]
    if not (res.cand_wins == wins and wins + losses == res.num_games == cfg.num_games):
        raise AssertionError(f"phase 9 (b): {wins} wins + {losses} losses != {cfg.num_games}")
    if point_liberties_batch.launches <= 0:
        raise AssertionError("phase 9 (b): the liberty kernel was not launched")
    return {"games": res.num_games, "plies": len(plies), "eval_s": eval_s,
            "cand_wins": res.cand_wins, "by_resign": res.by_resign,
            "mcgs_hits": counts.get("mcgs_hits", 0), "searches": counts["searches"],
            "syncs": counts["syncs"], "syncs_per_search": syncs_per_search(counts),
            "puct": EXTRAS_PUCT, "gumbel": EXTRAS_GUMBEL,
            "puct_ms_per_move": 1e3 * statistics.median(search_s["puct"]),
            "gumbel_mcgs_ms_per_move": 1e3 * statistics.median(search_s["gumbel"]),
            "boards_per_search": cfg.num_games // 2,
            "liberty_launches": point_liberties_batch.launches}


def search_card_vs_cpu(device):
    """Phase 9 (c): one search_root with every Gumbel extra on, float32
    weights and one Gumbel draw, on the card and on the CPU; a first search
    on the card fills the bias table both then read. Returns the share of
    boards whose move and root visit counts agree, and timings."""
    gen = torch.Generator(device=device).manual_seed(SEARCH_SEED + 9)
    # Boards from random play and settled endgames, half of each one pass
    # from the end, so leaves reach finished games.
    lane = torch.arange(EXTRAS_B, device=device)
    boards = select_state(lane % 4 < 2, settled_boards(EXTRAS_B, device),
                          random_boards(EXTRAS_B, 120, device, gen))
    boards = boards._replace(consecutive_passes=torch.where(
        lane % 2 == 0, torch.ones_like(boards.consecutive_passes), boards.consecutive_passes))
    model = seeded_model(SEARCH_MODEL, device, torch.Generator().manual_seed(SEARCH_SEED + 11))
    model_cpu = copy.deepcopy(model).cpu()
    params = SearchParams(**EXTRAS_PARAMS)
    noise = search.gumbel((EXTRAS_B, NUM_MOVES), torch.Generator().manual_seed(1), "cpu")
    _, table = search.search_root(boards, make_eval_fn(model), params,
                                  gumbel_noise=(noise * 0.5).to(device),
                                  bias_table=make_bias_table(EXTRAS_B, 1024, device))
    out = {}
    for name, dev, net in (("card", device, model), ("cpu", torch.device("cpu"), model_cpu)):
        st = map_state(lambda t: t.to(dev), boards)
        tab = type(table)(*(t.to(dev) for t in table))
        search.COUNTERS.reset()
        for k in KERNELS:
            k.launches = 0
        t0 = time.perf_counter()
        res, _ = search.search_root(st, make_eval_fn(net), params, gumbel_noise=noise.to(dev),
                                    bias_table=tab)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[name] = (res, time.perf_counter() - t0, search.COUNTERS.snapshot(),
                     point_liberties_batch.launches)
    (rc, card_s, counts, launches), (rp, cpu_s, _, _) = out["card"], out["cpu"]
    if launches <= 0:
        raise AssertionError("phase 9 (c): the liberty kernel was not launched")
    # The bias branch alone on a leaf batch of the first round's width
    # (B * k boards): liberties, pattern keys, probe, correction.
    leaves = map_state(lambda t: t.repeat_interleave(params.k, dim=0), boards)
    legal = legal_mask_batch(leaves)

    def bias_branch():
        libs = point_liberties_batch(leaves.stones, leaves.chain_id)
        ill = (leaves.stones == 0) & ~legal[:, :PASS_MOVE]
        h0, h1, valid = local_pattern_keys(leaves.stones, libs == 1, ill,
                                           leaves.last_moves, leaves.to_move)
        num, den, _, _ = bias_probe(table, params.k, h0, h1, valid)
        return torch.where(den > 0, params.bias_lambda * num / den.clamp(min=1e-9), 0.0)
    bias_ms = wall_ms(bias_branch)
    same = ((rc.mcts_move.cpu() == rp.mcts_move)
            & (rc.root_child_visits.cpu() == rp.root_child_visits).all(dim=1))
    share = float(same.float().mean())
    if share < EXTRAS_AGREE_MIN:
        raise AssertionError(f"phase 9 (c): card and CPU agree on {share:.3f} of the "
                             f"boards (< {EXTRAS_AGREE_MIN})")
    for f in ("root_value", "pi_improved"):
        if not bool(torch.isfinite(getattr(rc, f)).all()):
            raise AssertionError(f"phase 9 (c): {f} not finite")
    return {"boards": EXTRAS_B, "params": EXTRAS_PARAMS, "agree_share": share,
            "max_abs_root_value_diff": float((rc.root_value.cpu() - rp.root_value).abs().max()),
            "card_s": card_s, "cpu_s": cpu_s, "card_counts": counts,
            "bias_branch_ms_per_leaf_batch": bias_ms, "liberty_launches": launches,
            "bias_leaf_batch": EXTRAS_B * params.k,
            "bias_slots_used": int(table.used.sum())}


def phase_search(device, smi):
    """Phase 9 (see the module docstring). Returns (liberty launches of
    (a), the {"search": ...} measurements)."""
    t_phase = time.perf_counter()
    gen = search_generation(device)
    launches = gen["liberty_launches"]
    log(f"phase 9 (a): GenerationLoop(config/r4-b8c64-curve.json, bf16) with cuts "
        + ", ".join(f"{k}={v}" for k, v in SEARCH_CUTS.items())
        + " and smoke switches " + ", ".join(f"{k}={v}" for k, v in SEARCH_SWITCHES.items())
        + f": every move legal and superko-clean; max visits {gen['max_visits']} <= budget "
        f"{gen['visit_budget']}; {gen['early_stops']} early stops; up to "
        f"{gen['max_bias_slots_used']} bias slots in use; {gen['exact_scored_leaves']} leaves "
        f"scored exactly; eval {gen['eval_cand_wins']:.0f} wins of {gen['eval_games']}")
    log(f"phase 9 (a): generation {gen['generation_s']:.2f} s: selfplay "
        f"{gen['selfplay_s']:.3f} s ({gen['selfplay_plies']} plies), harvest "
        f"{gen['harvest_ms']:.1f} ms, train {gen['train_epoch_s']:.3f} s, bn refresh "
        f"{gen['bn_refresh_s']:.3f} s, validation {gen['validation_s']:.3f} s, eval "
        f"{gen['eval_s']:.3f} s ({gen['eval_plies']} plies), checkpoint "
        f"{gen['checkpoint_s']:.3f} s; host syncs {gen['selfplay_syncs']} in "
        f"{gen['selfplay_searches']} self-play searches: "
        f"{gen['selfplay_syncs_per_search']:.2f} per searched move, "
        f"{gen['selfplay_syncs_per_ply']:.2f} per ply; liberty launches {launches} ({smi})")
    ev = search_eval(device)
    log(f"phase 9 (b): run_eval PUCT n={EXTRAS_PUCT['n']} vs Gumbel "
        f"n={EXTRAS_GUMBEL['n']}/k={EXTRAS_GUMBEL['k']} with MCGS and the integral "
        f"utility, {SEARCH_MODEL} bf16, tree reuse: {ev['games']} games, {ev['plies']} plies, every "
        f"move legal and superko-clean, {ev['cand_wins']:.0f} PUCT wins; MCGS hits "
        f"{ev['mcgs_hits']}; {ev['syncs_per_search']:.2f} host syncs per searched move; "
        f"PUCT {ev['puct_ms_per_move']:.1f} ms and Gumbel+MCGS "
        f"{ev['gumbel_mcgs_ms_per_move']:.1f} ms per move of {ev['boards_per_search']} "
        f"boards (medians); {ev['eval_s']:.2f} s ({smi})")
    cmp = search_card_vs_cpu(device)
    log(f"phase 9 (c): search_root with MCGS, bias, early stopping, exact terminals and "
        f"the integral utility at B={EXTRAS_B}, float32: card and CPU agree on move and "
        f"root visits for {cmp['agree_share']:.3f} of the boards (max |d root_value| "
        f"{cmp['max_abs_root_value_diff']:.2e}); card {cmp['card_s']:.2f} s, CPU "
        f"{cmp['cpu_s']:.2f} s; bias branch {cmp['bias_branch_ms_per_leaf_batch']:.3f} ms "
        f"per leaf batch of {cmp['bias_leaf_batch']}; phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")
    return launches, {"generation": gen, "eval": ev, "card_vs_cpu": cmp,
                      "phase_wall_s": time.perf_counter() - t_phase, "card": smi}


class GtpPipe:
    """`run_stdin_loop` on an os.pipe in a thread of its own, so its select()
    paths run: commands are written one at a time and each answer (up to
    its blank line) is read back before the next."""

    def __init__(self, svc: GtpService):
        r, self.w = os.pipe()
        self.infile = os.fdopen(r, "r")
        self.text, self.pos, self.error = "", 0, None
        self.cv = threading.Condition()
        self.thread = threading.Thread(target=self._serve, args=(svc,), daemon=True)
        self.thread.start()

    def _serve(self, svc):
        try:
            run_stdin_loop(svc, self.infile, self)
        except BaseException as e:  # handed to the driving thread
            with self.cv:
                self.error = e
                self.cv.notify_all()

    def write(self, s: str) -> None:
        with self.cv:
            self.text += s
            self.cv.notify_all()

    def flush(self) -> None:
        pass

    def _wait(self, pred, timeout: float) -> None:
        with self.cv:
            ok = self.cv.wait_for(lambda: self.error is not None or pred(), timeout)
        if self.error is not None:
            raise AssertionError(f"phase 10: the GTP loop failed: {self.error!r}")
        if not ok:
            raise AssertionError(f"phase 10: no answer within {timeout} s: "
                                 f"{self.text[self.pos:][-400:]!r}")

    def answer(self, timeout: float = 300.0) -> str:
        self._wait(lambda: "\n\n" in self.text[self.pos:], timeout)
        end = self.text.index("\n\n", self.pos) + 2
        resp, self.pos = self.text[self.pos:end], end
        return resp

    def send(self, cmd: str) -> str:
        os.write(self.w, (cmd + "\n").encode())
        return self.answer()

    def stream(self, cmd: str, stop: str):
        """A streamed command, stopped by `stop` once its first info line
        is out -> (the stream's answer, stop's answer)."""
        os.write(self.w, (cmd + "\n").encode())
        self._wait(lambda: "info move" in self.text[self.pos:], 300.0)
        os.write(self.w, (stop + "\n").encode())
        return self.answer(), self.answer()

    def close(self) -> str:
        resp = self.send("quit")
        self.thread.join(60)
        alive = self.thread.is_alive()
        os.close(self.w)
        self.infile.close()
        if alive:
            raise AssertionError("phase 10: the GTP loop did not stop at quit")
        return resp


def device_profile(fn):
    """(device busy ms, kernels, {class: ms}) of one call of `fn`, from a
    profile of the device alone: recording the host's operators too costs
    tens of seconds for a call of ~10^5 kernels."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_class, kernels = kernel_classes(prof, 1)
    busy = sum(by_class.values())
    if busy <= 0:
        log("phase 10: the device profile recorded no kernel")
    return busy, kernels, by_class


def same_state(a, b) -> bool:
    return all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))


def gtp_server(device, smi, ckpt: str, sgf_path: str, tmp: str):
    """Phase 10 (a): the GTP server over phase 8's model_0001, driven through
    run_stdin_loop on a pipe. Returns (liberty launches, measurements)."""
    model = load_model(GTP_MODEL, ckpt, device)
    svc = GtpService(make_eval_fn(model), GtpConfig(search=SearchParams(**GTP_SEARCH)),
                     device=device)
    analyze_ms, slices = [], []
    analyze, run_search = svc._analyze_batch, svc._run_search

    def timed_analyze():
        t0 = time.perf_counter()
        out = analyze()
        torch.cuda.synchronize()
        analyze_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    def recorded_search(n, st):
        t0 = time.perf_counter()
        res, work = run_search(n, st)
        visits = int(res.visits[0])
        slices.append((n, visits, 1e3 * (time.perf_counter() - t0), int(work.n[0, 0])))
        return res, work

    svc._analyze_batch, svc._run_search = timed_analyze, recorded_search
    point_liberties_batch.launches = 0
    pipe = GtpPipe(svc)
    answers, bad = [], []

    def send(cmd, expect="="):
        resp = pipe.send(cmd)
        answers.append((cmd, resp))
        if not resp.startswith(expect):
            bad.append((cmd, resp))
        return resp

    for cmd in ("protocol_version", "name", "list_commands", "boardsize 19",
                "clear_board", "komi 7.5"):
        send(cmd)
    genmove_ms, searched, moves, before_last = [], [], [], None
    color = 1
    search.COUNTERS.reset()
    for i in range(GTP_GENMOVES):
        searched.append(svc._as_mover(svc.state, color))
        if i == GTP_GENMOVES - 1:
            before_last = type(svc.state)(*[t.clone() for t in svc.state])
        t0 = time.perf_counter()
        resp = send(f"genmove {'b' if color == 1 else 'w'}")
        genmove_ms.append(1e3 * (time.perf_counter() - t0))
        moves.append(gtp_vertex_to_action(resp[2:].strip()))
        color = -color
        if i + 1 in GTP_PLAY_AFTER:
            st = svc._as_mover(svc.state, color)
            legal = full_legal_mask(st)[0, :PASS_MOVE].nonzero()[:, 0]
            v = int(legal[(i * 37) % legal.numel()])
            send(f"play {'b' if color == 1 else 'w'} {'ABCDEFGHJKLMNOPQRST'[v % 19]}{19 - v // 19}")
            color = -color
    counts = search.COUNTERS.snapshot()
    syncs = sum(counts["syncs"].values()) / GTP_GENMOVES
    # Every genmove's position in one batch: legal by the card's exact mask,
    # which equals the CPU's.
    positions = map_state(lambda *ts: torch.cat(ts), *searched)
    mask = full_legal_mask(positions)
    masks_equal = torch.equal(mask.cpu(), full_legal_mask(map_state(lambda t: t.cpu(), positions)))
    if not bool(mask[torch.arange(GTP_GENMOVES, device=device), torch.tensor(moves)].all()):
        bad.append(("illegal genmove", moves))
    occupied = int(svc.state.stones[0].nonzero()[0, 0])
    send(f"play b {'ABCDEFGHJKLMNOPQRST'[occupied % 19]}{19 - occupied // 19}", "?")
    send("undo")
    undo_ok = same_state(svc.state, before_last)
    send("lz-analyze")
    stream, after = pipe.stream("lz-analyze 10", "p3achygo-ownership")
    answers += [("lz-analyze 10", stream), ("p3achygo-ownership", after)]
    if not (stream.startswith("=\ninfo move") and after.startswith("=")):
        bad.append(("streamed lz-analyze", stream[:200] + after[:40]))
    streamed = sum(line.startswith("info move") for line in stream.splitlines())
    for cmd in ("final_score", "showboard", f"loadsgf {sgf_path}"):
        send(cmd)
    sgf_moves = extract_moves(parse_sgf(open(sgf_path).read()))
    out_path = os.path.join(tmp, "trees.sgf")
    send(f"p3achygo-serialize_sgf_with_trees {out_path}")
    back = extract_moves(parse_sgf(open(out_path).read()))
    sgf_ok = svc._moves == sgf_moves and back[:len(sgf_moves)] == sgf_moves
    send(f"time_settings 0 {GTP_BYOYOMI_S} 1")
    send(f"time_left b {GTP_BYOYOMI_S} 1")
    slices.clear()
    t0 = time.perf_counter()
    send("genmove b")
    byo_ms = 1e3 * (time.perf_counter() - t0)
    byo_slices = list(slices)
    last = pipe.close()
    launches = point_liberties_batch.launches
    # One untimed genmove under the profiler, outside the pipe: device busy
    # time and kernels per genmove, the idle share against the 16 genmoves'
    # median wall.
    svc._analyze_batch, svc._run_search = analyze, run_search
    svc.time_control = type(svc.time_control)()
    busy_ms, kernels, by_class = device_profile(lambda: svc.handle("genmove w"))
    budget_ms = 1000 * (GTP_BYOYOMI_S - 1)
    slice16_ms = 16 * max(ms / max(v, 1) for _, v, ms, _ in byo_slices)
    checks = {
        "every answer '=' but the illegal play's '?'": not bad and last == "=\n\n",
        "genmove masks on the card == the CPU's": masks_equal,
        "undo restores the state bit for bit": undo_ok,
        "lz-analyze streamed until the next command": streamed >= 1,
        "the SGF with trees parses back to the game's moves": sgf_ok,
        "byoyomi genmove within the budget plus one 16-visit slice":
            byo_ms <= budget_ms + slice16_ms,
        "liberty kernel launched": launches > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 10 (a): failed checks {failed}; bad answers {bad[:4]}")
    info = {"genmove_ms_median": statistics.median(genmove_ms), "genmove_ms_max": max(genmove_ms),
            "genmove_ms": genmove_ms, "host_syncs_per_genmove": syncs,
            "syncs_by_cause": counts["syncs"],
            "analyze_ms_per_batch": statistics.mean(analyze_ms), "analyze_batches": len(analyze_ms),
            "streamed_lines": streamed, "sgf_moves": len(sgf_moves),
            "byoyomi_budget_ms": budget_ms, "byoyomi_genmove_ms": byo_ms,
            "byoyomi_slices": [n for n, _, _, _ in byo_slices],
            "byoyomi_visits": sum(v for _, v, _, _ in byo_slices),
            "byoyomi_root_visits": byo_slices[-1][3], "slice16_ms": slice16_ms,
            "liberty_launches": launches, "profiled_genmove_busy_ms": busy_ms,
            "profiled_genmove_kernels": kernels, "profiled_genmove_by_class_ms": by_class,
            "genmove_idle_share": 1 - busy_ms / statistics.median(genmove_ms)}
    log(f"phase 10 (a): GtpService({GTP_MODEL} bf16, model_0001 of phase 8, "
        f"n={GTP_SEARCH['n']} k={GTP_SEARCH['k']}) over "
        f"run_stdin_loop on a pipe, {len(answers) + 1} commands; every check passed. genmove "
        f"median {info['genmove_ms_median']:.1f} ms, max {info['genmove_ms_max']:.1f} ms over "
        f"{GTP_GENMOVES}; {syncs:.1f} host syncs per genmove; lz-analyze "
        f"{info['analyze_ms_per_batch']:.1f} ms per batch of n={GTP_SEARCH['n']} ({len(analyze_ms)} batches, "
        f"{streamed} streamed lines); byoyomi genmove {byo_ms:.1f} ms for a {budget_ms} ms "
        f"budget, slices {info['byoyomi_slices']}, {info['byoyomi_visits']} visits; liberty "
        f"launches {launches}; a profiled genmove: {busy_ms:.1f} ms device busy, {kernels:.0f} "
        f"kernels, idle share {info['genmove_idle_share']:.3f} of the median ({smi})")
    return launches, info


def gtp_entry_point(ckpt: str) -> dict:
    """Phase 10 (b): `python -m p3achygo_tpu_torch.gtp` on the card (no
    --device) with phase 8's model_0001 answers a genmove."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "p3achygo_tpu_torch.gtp", "--model", GTP_MODEL,
         "--checkpoint", ckpt], input="genmove b\nquit\n", capture_output=True, text=True,
        timeout=600, cwd=root, env=env)
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not re.fullmatch(r"= ([A-HJ-T]\d{1,2}|pass)\n\n=\n\n", proc.stdout):
        raise AssertionError(f"phase 10 (b): rc {proc.returncode}, stdout {proc.stdout!r}, "
                             f"stderr {proc.stderr[-2000:]!r}")
    log(f"phase 10 (b): python -m p3achygo_tpu_torch.gtp --model {GTP_MODEL} --checkpoint "
        f"model_0001 answered {proc.stdout.split()[1]} and quit, rc 0, {wall:.1f} s wall with "
        f"start-up")
    return {"answer": proc.stdout.split()[1], "wall_s": wall}


def ladder_positions(device):
    stones = np.zeros((len(LADDER_POSITIONS), 361), np.int8)
    for i, (black, white, _) in enumerate(LADDER_POSITIONS):
        for color, pts in ((1, black), (-1, white)):
            for r, c in pts:
                stones[i, r * 19 + c] = color
    to_move = torch.tensor([m for _, _, m in LADDER_POSITIONS], dtype=torch.int8)
    return from_stones(stones, to_move=to_move.to(device), device=device)


def gtp_ladders(device, boards, model) -> tuple:
    """Phase 10 (c): the ladder planes on the card equal the CPU's; one
    eval with ladders is finite; times with and without ladders."""
    point_liberties_batch.launches = 0
    sub = map_state(lambda t: t[:LADDER_B].contiguous(), boards)
    cpu = lambda st: map_state(lambda t: t.cpu(), st)
    equal, marked = [], 0
    for st in (ladder_positions(device), sub):
        s0 = laddered_stones.syncs
        planes, scalars = batched_features(st, include_ladders=True)
        syncs = laddered_stones.syncs - s0
        t0 = time.perf_counter()
        want = batched_features(cpu(st), include_ladders=True)
        cpu_s = time.perf_counter() - t0
        equal.append(torch.equal(planes.cpu(), want[0]) and torch.equal(scalars.cpu(), want[1]))
        marked = int(planes[..., 13:].sum())
    out = make_eval_fn(model, include_ladders=True)(sub)
    launches = point_liberties_batch.launches
    finite = all(bool(torch.isfinite(x).all()) for x in out if x is not None)
    if not (all(equal) and finite and marked > 0 and launches > 0):
        raise AssertionError(f"phase 10 (c): card == CPU {equal}, finite {finite}, "
                             f"laddered stones {marked}, launches {launches}")
    with_ms = statistics.median(event_ms(lambda: batched_features(sub, include_ladders=True))
                                for _ in range(3))
    without_ms = wall_ms(lambda: batched_features(sub))
    busy_ms, kernels, _ = device_profile(lambda: batched_features(sub, include_ladders=True))
    info = {"boards": LADDER_B, "featurize_ms_ladders": with_ms,
            "featurize_ms_plain": without_ms, "ladder_syncs_per_call": syncs,
            "laddered_stones": marked, "liberty_launches": launches,
            "cpu_reference_s": cpu_s, "profiled_busy_ms": busy_ms, "profiled_kernels": kernels,
            "idle_share": 1 - busy_ms / with_ms}
    log(f"phase 10 (c): batched_features(include_ladders=True) card == CPU on the 6 ladder "
        f"positions and {LADDER_B} random-play boards ({marked} laddered stones); "
        f"make_eval_fn(include_ladders=True) finite; at B={LADDER_B}: {with_ms:.2f} ms per call "
        f"with ladders ({busy_ms:.1f} ms device busy, {kernels:.0f} kernels, idle share "
        f"{info['idle_share']:.3f}), {without_ms:.3f} ms without; {syncs} host syncs per call; "
        f"the CPU reference took {cpu_s:.1f} s")
    return launches, info


def gtp_tier_groups(device, model, gen) -> tuple:
    """Phase 10 (d): phase 4's mix with tier_groups=TIER_GROUPS for
    TIER_PLIES plies."""
    B = BENCH_B
    cfg = SelfplayConfig(batch_size=B, tier_groups=TIER_GROUPS)
    params_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24, visit_group=4)
    params_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24, visit_group=4)
    b_sel, _ = tier_sizes(B, cfg)
    eval_fn = make_eval_fn(model, serve_fold=True)
    states = new_state(B, cfg.komi, device=device)
    buf = make_game_buffer(B, cfg.max_game_len, device)
    aux = make_aux(B, gen, device=device)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, 64, device)
    b = torch.arange(B, device=device)
    point_liberties_batch.launches = 0
    per_group = []
    t0 = time.perf_counter()
    for ply in range(TIER_PLIES):
        prev = states
        active = ~finished_mask(prev, cfg)
        states, buf, aux, tree = selfplay_step_tiered(
            states, buf, aux, eval_fn, params_sel, params_fast, cfg, generator=gen,
            reuse_tree=tree, reuse_capacity=64)
        t = prev.move_count.long().clamp(max=cfg.max_game_len - 1)
        check_ply(prev, active, buf.move[b, t].long(), buf.pi[b, t], states,
                  f"phase 10 (d) ply {ply}")
        sel = buf.visits[b, t] > visit_budget(params_fast)
        per_group.append(sel.reshape(TIER_GROUPS, -1).sum(dim=1).tolist())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = point_liberties_batch.launches
    if any(n != b_sel // TIER_GROUPS for row in per_group for n in row) or launches <= 0:
        raise AssertionError(f"phase 10 (d): selected boards per group {per_group} "
                             f"(want {b_sel // TIER_GROUPS}), launches {launches}")
    log(f"phase 10 (d): selfplay_step_tiered with tier_groups={TIER_GROUPS} at B={B}, "
        f"{TIER_PLIES} plies in {dt:.2f} s: every move legal and superko-clean, pi_improved "
        f"sums to 1, {b_sel // TIER_GROUPS} selected boards in every group every ply")
    return launches, {"tier_groups": TIER_GROUPS, "plies": TIER_PLIES, "seconds": dt,
                      "selected_per_group": per_group, "liberty_launches": launches}


def phase_gtp(device, smi, gen_root: str, mix_model, boards, gen):
    """Phase 10 (see the module docstring). Returns ({part: liberty
    launches}, the {"gtp": ...} measurements)."""
    t_phase = time.perf_counter()
    ckpt = os.path.join(gen_root, "model_0001")
    sgf_dir = os.path.join(gen_root, "sgf")
    sgf_path = os.path.join(sgf_dir, sorted(os.listdir(sgf_dir))[0])
    launches, info, parts_s = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launches["server"], info["server"] = gtp_server(device, smi, ckpt, sgf_path, tmp)
        parts_s["server"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    info["entry_point"] = gtp_entry_point(ckpt)
    parts_s["entry_point"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["ladders"], info["ladders"] = gtp_ladders(
        device, boards, load_model(GTP_MODEL, ckpt, device))
    parts_s["ladders"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches["tier_groups"], info["tier_groups"] = gtp_tier_groups(device, mix_model, gen)
    parts_s["tier_groups"] = time.perf_counter() - t0
    info["parts_s"] = parts_s
    info["phase_wall_s"] = time.perf_counter() - t_phase
    info["card"] = smi
    log(f"phase 10: wall {info['phase_wall_s']:.1f} s: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in zip("abcd", parts_s.values())) + f" ({smi})")
    return launches, info


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs an NVIDIA card")
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    smi = smi_line()
    log(f"phase 0: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 0: torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    sources = (lib_ops.SOURCE, trunk_ops.SOURCE, trunk_ops.SEGMENT_SOURCE)
    t0 = time.perf_counter()
    cuda_build.build_libraries(sources)
    log(f"phase 1: built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, started together: " + ", ".join(
            f"{s} {cuda_build.build_seconds(s):.2f} s" for s in sources) + ")")
    hgmma = {}
    for src, kernel_widths in (
            (trunk_ops.SOURCE, [f"trunk_broadcast_kernel<{c}>"
                                for c in trunk_ops.BROADCAST_WIDTHS]),
            (trunk_ops.SEGMENT_SOURCE, [f"trunk_segment_kernel<{c},{cb}>"
                                        for c, cb in trunk_ops.SEGMENT_WIDTHS])):
        for line in cuda_build.build_log(src).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"phase 1: {line.strip()}")
        found = sass_counts(src)
        if found is None:
            log(f"phase 1: {src}: cuobjdump not found, HGMMA instructions not counted")
            continue
        counts, size = found
        hgmma.update(counts)
        log(f"phase 1: {src}: HGMMA (wgmma) instructions per kernel: {counts}; "
            f"SASS instructions per kernel: {size}")
        if any(counts.get(k, 0) <= 0 for k in kernel_widths):
            raise AssertionError(f"{src}: a kernel of {kernel_widths} has no wgmma: {counts}")

    gen = torch.Generator(device=device).manual_seed(0)
    boards, max_err, times = phase_kernel(device, gen)
    cpu_gen = torch.Generator().manual_seed(1)
    model, forward_batch = phase_forward(device, boards, cpu_gen)
    launches, plies_s, moves_s = phase_selfplay(
        device, model, gen, make_eval_fn(model, serve_fold=True), PLIES, 4)
    if launches["point_liberties_batch"] <= 0:
        raise AssertionError("the liberty kernel was not launched by phase 4")
    log(f"phase 4: {plies_s:.3f} plies/s, {moves_s:.1f} moves/s at B={BENCH_B} "
        f"(informative; {smi})")

    trunk_err, trunk_times, kernel_rows = phase_trunk(device, boards, model, forward_batch,
                                                      cpu_gen)
    fused_launches, f_plies_s, f_moves_s = phase_selfplay(
        device, model, gen, make_eval_fn(model, use_fused_trunk=True), FUSED_PLIES, 6)
    for k, n in fused_launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the fused self-play path")
    log(f"phase 6: {f_plies_s:.3f} plies/s, {f_moves_s:.1f} moves/s at B={BENCH_B} "
        f"with the fused trunk (informative; {smi})")

    learn_launches, learn = phase_learn(device, smi)
    print(json.dumps({"learn": learn}), flush=True)

    with tempfile.TemporaryDirectory() as gen_root:
        gen_launches, gen_info = phase_gen(device, smi, gen_root)
        print(json.dumps({"gen": gen_info}), flush=True)

        search_launches, search_info = phase_search(device, smi)
        print(json.dumps({"search": search_info}), flush=True)

        gtp_launches, gtp_info = phase_gtp(device, smi, gen_root, model, boards, gen)
        print(json.dumps({"gtp": gtp_info}), flush=True)

    if "jax" in sys.modules or "p3achygo_tpu" in sys.modules:
        raise AssertionError("the port loaded JAX or the JAX package")
    t_big = max(TIMED_BATCHES)
    n_big = max(TRUNK_TIMED)
    trunk_by_n = {k: {"ms": v[0], "wall_ms": v[1]}
                  for k, v in trunk_times.items() if "@" in k}
    kernels = [{
        "name": "point_liberties_batch",
        "route": "cuda",
        "source": f"p3achygo_tpu_torch/csrc/{lib_ops.SOURCE}",
        "replaces": "p3achygo_tpu/ops/liberties.py:46",
        "launches": launches["point_liberties_batch"],
        "launches_from": "phase 4 (serve_fold self-play)",
        "launches_phase7": learn_launches,
        "launches_phase8": gen_launches,
        "launches_phase9": search_launches,
        "launches_phase10": gtp_launches["server"],
        "launches_phase10_parts": gtp_launches,
        "max_abs_err": max_err,
        "ms": times[t_big][0],
        "plain_ms": times[t_big][1],
        # stones int8 + chain ids int32 in, liberties int32 out, per board
        **dict(zip(("bound_ms", "bound_by"), bound_ms(0, t_big * 361 * (1 + 4 + 4)))),
        "library_ms": None,
        "timed_batch": t_big,
        "timing": "device time per call from profiler kernel records",
        "by_batch": {str(k): {"ms": v[0], "plain_ms": v[1], "wall_ms": v[2],
                              "plain_wall_ms": v[3]} for k, v in times.items()},
    }]
    for name, source, replaces in (
            ("trunk_segment", trunk_ops.SEGMENT_SOURCE, "p3achygo_tpu/nn/trunk_kernel2.py:89"),
            ("trunk_broadcast", trunk_ops.SOURCE, "p3achygo_tpu/nn/trunk_kernel.py:146")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"p3achygo_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": fused_launches[name],
            "launches_from": "phase 6 (fused-trunk self-play)",
            "max_abs_err": trunk_err[name],
            "ms": trunk_times[name][0],
            "plain_ms": trunk_times[name + "_plain"][0],
            "wall_ms": trunk_times[name][1],
            "plain_wall_ms": trunk_times[name + "_plain"][1],
            "bound_ms": trunk_times[name + "_bound"][0],
            "bound_by": trunk_times[name + "_bound"][1],
            "library_ms": None,
            "hgmma": {k: v for k, v in hgmma.items() if k.startswith(name)},
            "timed_batch": n_big,
            "timing": "device time per call from profiler kernel records, "
                      "b12c128btl3, first call of the trunk",
            "library_products_ms": kernel_rows[f"{name}@{n_big}"]["library_products_ms"],
            "by_batch": {k: v for k, v in kernel_rows.items() if k.startswith(name + "@")},
        })
    kernels[1]["also_replaces"] = "p3achygo_tpu/nn/trunk_kernel.py:146 (btl branch)"
    kernels[1]["trunk_b12c128btl3"] = trunk_by_n
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
