"""Drive the PyTorch port's self-play, learning, generation, search, GTP,
store-bus, transformer, scale-out, int8-serving and wide fused-trunk paths
once on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  0 device   needs torch.cuda; prints the card's name and power limit and
             the TF32 switches (both off).
  1 build    compiles the liberty kernel (csrc/liberties.cu), the broadcast
             kernel (csrc/trunk_broadcast.cu), the segment kernel
             (csrc/trunk_segment.cu), the int8 conv kernel
             (csrc/conv_i8.cu) and the pre-activation kernel
             (csrc/preact.cu) with one nvcc each, started together;
             prints each build's seconds, ptxas' register/spill lines and
             each trunk kernel's count of HGMMA (wgmma), HMMA (mma.sync)
             and all SASS instructions from `cuobjdump -sass`: every width
             of both trunk kernels (at C = 256 and 384 the segment's
             cluster kernel and the broadcast block's three kernels,
             conv_first, the mix and conv_last; at tiny's the small
             kernels) must be there with a count > 0 of its route's
             instructions (`trunk_kernel_routes`: HGMMA, tiny's segment
             HMMA, tiny's broadcast both), each source held to its own
             counts
             (where cuobjdump is missing the line says so); for conv_i8
             every mode's count of IMMA and GMMA (s8 tensor-core)
             instructions must be > 0 and of IDP4A 0.
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
  3b preact  the pre-activation kernel (ops/preact.py): every call the bf16
             plain forward and ServeNet of phase 3's model make at N in
             {1, 7, 512, 2880} on the boards of phase 2 (channels_last
             ConvBlock inputs at C = 128 and 64, NCHW after each broadcast
             mix) against the eager ops on the same input, 0 differing
             bits, one call a ConvBlock and a broadcast mix; then bf16
             channels_last at C in {64, 128, 384}, N in {512, 2880}, and
             NCHW at C = 128, N = 2880: the kernel's and the eager chain's
             device ms, the byte bound (x read once, y written once) and
             the share of it.
  4 selfplay selfplay_step_tiered + finished_mask + reset_finished at the
             bench mix (25% n=128/k=8, 75% n=32/k=5, visit_group 4, tree
             reuse 64, b12c128btl3 bf16, serve_fold) on B=256 fresh games
             for 10 plies; checks every played move was legal and passed
             the superko guard, pi_improved is finite and sums to 1, and
             the liberty and pre-activation kernels were launched by this
             phase; one more ply under the profiler, in which each preact
             call ran one kernel. Prints plies/s and moves/s (informative,
             not a benchmark).
  4b plain   the same loop on make_eval_fn(model), the plain eager forward
             the generation loop serves through: the same checks, and the
             preact launches a ply of both routes.
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
             plain version; for the segment and broadcast kernels of both
             configurations at both N also their FLOP count, TFLOP/s,
             bound and share of it (b8c64's with the plain version's
             device ms), and library_products_ms: the same products alone (segment: bf16
             F.conv2d for the 3x3s, bf16 torch.matmul for the 1x1s;
             broadcast: bf16 torch.matmul for x.Wf, the batched WdT.m and
             z.Wl), a yardstick the port never calls, since no single
             PyTorch call computes a segment or a broadcast block.
  6 fused    the phase-4 loop with make_eval_fn(use_fused_trunk=True) in
             place of serve_fold, for 6 plies with one reset; the same
             checks, and all three kernels (segment, broadcast, liberty)
             must have been launched by this phase, and no preact kernel
             (the fused trunk replaces every call site). Then one more ply under
             the profiler: its CUDA kernel records by name, each wrapper's
             calls in it and the kernels a call launches (the kernels line's
             `kernels_profiled_ply`, as for phase 15's self-play).
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
             the liberty and pre-activation kernels launched; then a second
             loop on the same directory resumes bitwise (gen, golden, train state, optimizer,
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
             (b) run_eval of 16 games of at most 8 moves between two
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
             list_commands, boardsize, clear_board, komi; 8 alternating
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
             the first 128 of 1,024 boards of phase 2 (LADDER_CPU_B); one
             make_eval_fn(include_ladders=True) call finite; ms per
             featurizer call at B=1024 with and without ladders, ladder
             syncs per call. (d) phase 4's mix at
             B=256 with tier_groups=4 for 4 plies: every move legal and
             superko-clean, pi_improved summing to 1, B_sel/G selected
             boards in every group every ply.

  11 bus    the data formats, the store bus and the workers, in phase 8's
             directory, at phase 8's configuration and cuts plus BUS_CUTS
             (games_per_gen 6); prints the tfrecord codec in use:
             (a) in this process, on a LocalStore: the Learner publishes
             gen 0; the SelfplayActor syncs it (a second sync returns
             False), plays a B=128 round of 32-move games and publishes the
             chunk; the learner ingests it (a second ingest adds 0), trains,
             gates (phase 8's eval) and publishes model_0001; the actor
             hot-swaps it (its golden equal to the learner's bit for bit,
             loop.gen 1) and publishes a second chunk. Checks each chunk's
             name against CHUNK_FORMAT and its .done, a payload without
             .done unlisted, read_game_chunk equal to the games the actor
             sank under the format's reconstruction rules (z, weight,
             has_pi_aux_dist), the exported liberty planes equal to
             point_liberties_reference's, and the liberty kernel launched
             by the actor, the exporter and the learner; prints self-play
             s, export ms per game, bytes per chunk, ingest ms.
             (b) python -m p3achygo_tpu_torch.rl --role learner and --role
             actor as two processes (no --device) on one store and a
             config file with (a)'s cuts, --gens 1: both exit 0 within
             BUS_ENTRY_TIMEOUT_S and the store holds model_0001.done.
             (c) python -m p3achygo_tpu_torch.experiments visits_study on
             (a)'s first chunk with phase 8's model_0001 (BUS_STUDY): every
             KLD finite and >= 0, the report parses; play_games of 4 games
             of at most 16 moves with a BiasCallback: scored, heaps dumped.
             (d) build_sl_shards over phase 8's SGFs with 2 workers on the
             card: the shards hold exactly the records of the lockstep
             replay on the CPU, the .done report's counts match, four games
             replayed alone on the card equal their lockstep examples, and
             build_sl_replay feeds one prepare_batch. (e) anchor_match of
             model_0001 against the published gen 0 (BUS_ANCHOR).

  12 transformer  b14d96h3_transformer at its published widths (14
             blocks, embed 96, 3 heads of 32), seeded: (a) float32 on the
             card against float32 on the CPU at B=256 (max |d pi_logits|
             <= TRANSFORMER_F32_TOL), bf16 on the card against it (max |d
             value| <= TRANSFORMER_VALUE_TOL, top-1 >= TRANSFORMER_TOP1_MIN,
             every output finite), ms per bf16 forward at N=2880 and the
             attention's share of its device time (a profiler range per
             attention call); (b) phase 8's generation with model_config
             b14d96h3_transformer (the config file unedited) and phase 8's
             checks, resumed bitwise, the liberty kernel launched; (c) 4
             genmoves through GtpService over (b)'s model_0001, each legal.

  13 scale-out  python -m p3achygo_tpu_torch.parallel --nproc 1 (NCCL, one
             rank: NCCL takes no two ranks on one card) as a subprocess:
             the dry run's train-step loss equal to one process's within
             relative 1e-3, its sharded self-play's stones and moves equal
             and pi within 1e-4.

  14 serve_q  the int8-activation serving graph (nn/serve_q.py over the
             conv_i8 kernel) with phase 3's b12c128btl3 in bf16, about two
             minutes: (a) conv_i8 against its plain version at the conv
             sites of b12c128btl3 (SERVE_Q_SITES: 1x1 128->64 and 3x3
             64->64 in-chain, 1x1 64->128 and the broadcast block's 1x1
             128->128 chain-last) at N in {1, 7, 512, 2880}, and at the
             other conv configs' widths at N=64, in every epilogue mode
             (EPILOGUE_MODES: the site's own, float32 or int8, the residual
             RES with and without the next head, MISH in bf16 and float32):
             the int32 sums (raw mode) and every output must be equal; (b)
             calibration on bench.py's protocol (1,024 boards after 60
             random legal plies), the card's scales against the CPU's on
             the first 256 boards, the same sites, float32 within rtol 1e-4
             and bf16 within 1e-3 (SERVE_Q_CALIB_*); (c) serve_q_forward
             native against emulated on 512 positions (max |d pi_logits|
             <= 1e-4), the fused graph (int8 stream between blocks) against
             the plain graph (float32 stream, plain ops) on the same
             positions (last int8 stream and pi_logits equal), every output
             finite, and against ServeNet's bf16 forward (pi correlation,
             top-1, value; informative); (d) phase 4's loop with
             make_eval_fn(serve_q_scales=): phase 4's checks, the liberty
             and conv_i8 kernels both launched, conv_i8 in its I8, RES and
             MISH modes and never in F32, plies/s and moves/s beside phase
             4's; (e) at N = 512 and 2880 the fused and plain serve_q and
             ServeNet forwards (device and wall ms), the fused forward's
             device time by kernel class from a profile (conv_i8 by mode,
             elementwise, GEMMs and convs, copies), and for each site and
             the modes it runs in (SERVE_Q_TIMED_MODES) the kernel's device
             ms, int8 operations, bound (int8 ops over 1,979 TOP/s or bytes
             over 3.35 TB/s) and share of it, beside torch._int_mm on an
             int8 im2col (the im2col timed apart) and a bf16 F.conv2d of
             the same shape, yardsticks the port never calls.

  15 wide    the fused trunk at the widths whose board does not fit one
             block (the segment over a thread-block cluster, the broadcast
             block as three kernels): b12c256btl3 (segment (256, 128),
             broadcast 256) and b14c384btl3 ((384, 192), 384) with seeded
             weights and perturbed BN at full depth, on the stem
             activations of phase 2's boards: each segment and broadcast
             call against its plain version at N in {1, 7, 64, 512, 2880}
             (KERNEL_TOL), build_trunk_fn and build_trunk_fn_v2 against
             their plain trunks (TRUNK_TOL) at N in {1, 7, 64, 512}
             (WIDE_TRUNK_BATCHES), the fused model against the float32
             model on 512 positions (top-1 >= 0.95, every output finite;
             its agreement with the plain bf16 model, and that model's
             with float32, printed beside it: a seeded network's policy is
             near flat at these widths, so two bf16 evaluations part on
             near-ties); at N = 512 and 2880 each kernel's device and wall ms,
             FLOP, TFLOP/s, bound and share, library_products_ms, the plain
             version's device ms (WIDE_PLAIN_CALLS calls) and the fused
             trunk's ms, and the whole bf16 forward at N = 512 and 2880,
             the model on the fused trunk against ServeNet's folded forward
             (WIDE_FORWARD_CALLS calls, device ms); then the phase-4 loop on
             make_eval_fn(use_fused_trunk=True)
             for WIDE_PLIES plies with a reset after the WIDE_RESET_EVERY-th,
             phase 4's checks, the segment, broadcast and liberty kernels
             all launched, launches per ply; one more ply under the
             profiler, in which the cluster segment kernel and the three
             wide broadcast kernels must each have kernel records (the
             records and kernels per wrapper call are printed).
             Then tiny (16, 8) / 16 on its own kernels: the same kernel
             and trunk checks; each wrapper call runs exactly one kernel,
             tiny's own, and no other (no pad or slice); at N = 512 and
             2880 each kernel's row as above and its plain version's
             device ms; one fused eval finite; TINY_PLIES plies of fused
             self-play (launches per ply) and one profiled ply, whose
             trunk kernel records are tiny's two kernels alone, one a
             wrapper call.

Phases 7, 8, 9, 10, 11, 12, 13, 14 and 15 print {"learn": ...}, {"gen":
...}, {"search": ...}, {"gtp": ...}, {"bus": ...}, {"transformer": ...},
{"scale_out": ...}, {"serve_q": ...} and {"wide_trunk": ...} JSON lines of
their measurements.
Before the last line it prints the kernels JSON line (every kernel with
its bound: the larger of its operations over 989 TFLOP/s bf16, or 1,979
TOP/s int8 for conv_i8, and its bytes, each input read once and each output
written once, over 3.35 TB/s) and the nvidia-smi line; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io
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
from p3achygo_tpu_torch.data import tfrecord
from p3achygo_tpu_torch.data.example import decode_example
from p3achygo_tpu_torch.data.export import (CHUNK_FORMAT, examples_to_records,
                                            read_game_chunk)
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.data.replay import ReplayBuffer
from p3achygo_tpu_torch.data.sl import (build_sl_replay, build_sl_shards, iter_sgf_dir,
                                        sgf_to_examples)
from p3achygo_tpu_torch.data.store import (SP_CHUNKS_DIR, LocalStore, list_done_chunks,
                                           most_recent_model)
from p3achygo_tpu_torch.data.tfrecord import read_records
from p3achygo_tpu_torch.experiments.play_games import BiasCallback, play_games
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import (
    compute_chains,
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
from p3achygo_tpu_torch.models.blocks import BatchNorm, Broadcast, ConvBlock
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs, compute_losses
from p3achygo_tpu_torch.models.model import ModelOutputs, block_name, build_model, init_params
from p3achygo_tpu_torch.models.transformer import MultiHeadDotProductAttention
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.nn.serve_q import ServeQNet, calibrate
from p3achygo_tpu_torch.nn.trunk_kernel import build_trunk_fn, trunk_reference
from p3achygo_tpu_torch.nn.trunk_kernel2 import build_trunk_fn_v2
from p3achygo_tpu_torch.ops import conv_i8 as conv_ops
from p3achygo_tpu_torch.ops import cuda_build
from p3achygo_tpu_torch.ops import liberties as lib_ops
from p3achygo_tpu_torch.ops import preact as preact_ops
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
from p3achygo_tpu_torch.rl import workers as rl_workers
from p3achygo_tpu_torch.rl.slice import RLSlice, SliceConfig
from p3achygo_tpu_torch.rl.strength_curve import anchor_match
from p3achygo_tpu_torch.rl.workers import Learner, SelfplayActor
from p3achygo_tpu_torch.selfplay.records import GameExamples
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
KERNELS = (point_liberties_batch, trunk_ops.trunk_segment, trunk_ops.trunk_broadcast,
           preact_ops.preact)
# The kernels of the fused route; it replaces the whole trunk, so the
# pre-activation kernel (the plain and folded trunks') is not among them.
FUSED_KERNELS = ("point_liberties_batch", "trunk_segment", "trunk_broadcast")
# Phase 3b: the pre-activation kernel on the main path's activations (the
# plain and folded b12c128btl3 forwards in bf16) at these batches, and timed
# against the eager ops at these widths and batches.
PREACT_BATCHES = (1, 7, 512, 2880)
PREACT_TIMED_C = (64, 128, 384)
PREACT_TIMED_N = (512, 2880)
# Phase 15: the fused trunk at the widths whose kernels split a board over a
# thread-block cluster (segment (256, 128) and (384, 192), broadcast 256 and
# 384), full depth, and tiny (16, 8) / 16 on its own kernels. The plain
# versions at the wide widths take up to ~1 s a call at N = 2880, so they
# are timed over WIDE_PLAIN_CALLS calls.
WIDE_CONFIGS = ("b12c256btl3", "b14c384btl3")
WIDE_SEED = 15
# 4 plies a config (6 before the forwards and tiny's timings were added: a
# depth cut for the phase's time), with a reset after the third, so that
# reset_finished and a ply after it run at both widths.
WIDE_PLIES = 4
WIDE_RESET_EVERY = 3
WIDE_PLAIN_CALLS = 2
# The whole trunks against their plain trunks below N = 2880 (each kernel
# call is checked at every N of TRUNK_BATCHES): the plain b14c384btl3 trunk
# takes seconds at 2880.
WIDE_TRUNK_BATCHES = (1, 7, 64, 512)
TINY_CONFIG = "tiny"
# tiny's kernels, by the wrapper that launches them.
SMALL_KERNELS = {trunk_ops.trunk_segment: "trunk_segment_small_kernel<16,8>",
                 trunk_ops.trunk_broadcast: "trunk_broadcast_small_kernel<16>"}
# Phase 15 also times the whole bf16 forward at each wide config, the model
# with the fused trunk against ServeNet's folded forward, over this many
# calls a row, and tiny's kernels in self-play over TINY_PLIES plies.
WIDE_FORWARD_CALLS = 3
TINY_PLIES = 1
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
# Games of at most 8 moves (16 before phase 15 was added: a depth cut for
# its time; the eval's time is its plies, host-bound).
EXTRAS_EVAL = dict(num_games=16, max_game_len=8)
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
# 8 genmoves (16 before phase 15 was added: a depth cut for its time).
GTP_GENMOVES = 8
GTP_PLAY_AFTER = (2, 4, 6)  # a `play` follows these genmoves
# A byoyomi period of P s is budgeted P - 1 s per move (time_control.py), so
# a 1 s budget needs a 2 s period (a 1 s period would mean an untimed search).
GTP_BYOYOMI_S = 2
LADDER_B = 1024
# Boards of the LADDER_B batch that the CPU reference recomputes (a depth
# cut from all 1024, whose CPU reference took 18-27 s, to keep the script
# near half its time limit; 256 before phase 15 was added; each board's
# planes depend on that board alone).
LADDER_CPU_B = 128
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
# Phase 11: the bus (actor/learner over a LocalStore, the entry point's two
# roles, the experiments, SL shards, an anchor match), phase 8's
# configuration with its cuts. games_per_gen 512 -> 6: the learner waits for
# games_per_gen * 60 = 360 examples, one chunk of B=128 (phase 8's
# generation kept ~6.7 trainable examples per game of at most 32 moves;
# 12 before phase 15 was added, two chunks: a depth cut for its time).
BUS_CUTS = dict(games_per_gen=6)
BUS_ENTRY_TIMEOUT_S = 420
BUS_STUDY = ["--num_examples", "16", "--gt_n", "256", "--n_values", "32,64",
             "--seed_visits", "8"]
BUS_PLAY = dict(num_games=4, visit_count=32, k=4, max_moves=16)
BUS_SL_WORKERS = 2
BUS_ANCHOR = dict(num_games=8, n=16, k=4, max_game_len=16)
# Phase 12: the transformer trunk at full width (embed 96, 3 heads of 32,
# 14 blocks). (a) float32 on the card against float32 on the CPU (TF32 off:
# only summation order differs), bf16 on the card against float32 on the
# CPU at B=256 (bf16 rounds every product, the softmax and the residual
# stream over 14 blocks: the bounds leave room over what the same
# comparison gives between bf16 and float32 on the CPU), the policy output
# kernel sharpened so the top move is not a near-tie of a random network;
# (b) phase 8's generation at this network; (c) genmoves over (b)'s
# model_0001.
TRANSFORMER = "b14d96h3_transformer"
TRANSFORMER_B = 256
TRANSFORMER_SHARPEN = 30.0
TRANSFORMER_F32_TOL = 1e-3
TRANSFORMER_VALUE_TOL = 0.1
TRANSFORMER_TOP1_MIN = 0.7
TRANSFORMER_GENMOVES = 4
# Phase 13: the multi-rank dry run as one NCCL rank.
SCALE_OUT_TIMEOUT_S = 300
# Phase 14: the int8-activation serving graph at b12c128btl3 width, bf16.
# (a) the conv sites of b12c128btl3 as (site, k, Cin, Cout, in-chain) at
# SERVE_Q_BATCHES, and every other conv-family config's widths at N = 64;
# the kernel's int32 sums, float32 and int8 outputs equal to the plain
# version's (the same IEEE operations in the same order). (b) bench.py's
# calibration protocol (bench.py:88-105); the card's scales against the
# CPU's on the first SERVE_Q_CALIB_CPU_B boards: float32 at rtol 1e-4
# (record mode is float32 with TF32 off: only summation orders differ) and
# bf16 at 1e-3, since the broadcast mix's bf16 product rounds differently
# where its float32 sums run in another order, which moved the percentiles
# of the blocks after it by up to 1.2e-4 (PERF.md §6). (c) native
# against emulated at JAX's tolerance for that check. (d) phase 4's loop
# with make_eval_fn(serve_q_scales=). (e) times at SERVE_Q_TIMED.
SERVE_Q_SITES = (("reduce 1x1 128->64", 1, 128, 64, True),
                 ("inner 3x3 64->64", 3, 64, 64, True),
                 ("expand 1x1 64->128", 1, 64, 128, False),
                 ("broadcast 1x1 128->128", 1, 128, 128, False))
SERVE_Q_BATCHES = (1, 7, 512, 2880)
SERVE_Q_TIMED = (512, 2880)
SERVE_Q_WIDTHS = tuple(
    (cfg, k, cin, cout, chain)
    for cfg, c, cb in (("tiny", 16, 8), ("b8c64", 64, 32), ("b12c256btl3", 256, 128),
                       ("b14c384btl3", 384, 192))
    for k, cin, cout, chain in ((1, c, cb, True), (3, cb, cb, True), (1, cb, c, False),
                                (1, c, c, False))) + (
    ("b15c192_classic", 3, 192, 192, True), ("b15c192_classic", 3, 192, 192, False))
# Epilogue modes held against the plain version in (a): the site's own
# (float32 chain-last or int8 in-chain), RES with the next chain's head and
# without it (the last block), MISH in bf16 and float32.
EPILOGUE_MODES = ("site", "res", "res_last", "mish_bf16", "mish_f32")
# The modes each site runs in b12c128btl3's fused graph, timed in (e), and
# F32, the chain-last mode the graph ran before RES and MISH.
SERVE_Q_TIMED_MODES = {"reduce 1x1 128->64": ("site",),
                       "inner 3x3 64->64": ("site",),
                       "expand 1x1 64->128": ("res", "site"),
                       "broadcast 1x1 128->128": ("res", "mish_bf16", "site")}
SERVE_Q_CALIB_B = 1024
SERVE_Q_CALIB_PLIES = 60
SERVE_Q_CALIB_CPU_B = 256
SERVE_Q_CALIB_RTOL = 1e-4
SERVE_Q_CALIB_BF16_RTOL = 1e-3
SERVE_Q_FORWARD_B = 512
SERVE_Q_NATIVE_TOL = 1e-4  # JAX's test_native_matches_emulated_when_supported
# Published dense int8 tensor rate of one H100 SXM, for the int8 bound.
PEAK_INT8_OPS = 1979e12
# Kernel classes of a profile, by substrings of the kernel's name (first match).
CLASSES = (
    ("segment kernel", ("trunk_segment_",)),
    ("broadcast kernel", ("trunk_broadcast_",)),
    ("liberty kernel", ("point_liberties_kernel",)),
    ("int8 conv kernel", ("conv_i8_kernel",)),
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


def device_timing(fn, calls: int = 50, attempts: int = 3) -> tuple:
    """(device time per call, how it was timed): the CUDA kernels that
    `calls` calls ran, from the profiler's kernel records. CUPTI drops
    records now and then (most often one launch of a profile's first
    kernel), so each kernel counts its mean time a launch times its
    launches a call (its records over `calls`, rounded). A profile with no
    record, or with a kernel whose records are no near-whole multiple of
    `calls` (a larger loss), is taken again; after `attempts` such profiles
    the time comes from CUDA events around the calls instead, host gaps
    included, and a line says so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        records = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        per_call = [max(1, round(e.count / calls)) for e in records]
        if records and all(abs(e.count / calls - n) <= 0.25 for e, n in zip(records, per_call)):
            return (sum(e.self_device_time_total / e.count * n for e, n in zip(records, per_call))
                    / 1000.0, "profiler kernel records")
    log(f"device_ms: {attempts} profiles lost kernel records; CUDA-event time per call "
        f"used instead")
    return event_ms(lambda: [fn() for _ in range(calls)]) / calls, "CUDA events"


def device_ms(fn, calls: int = 50, attempts: int = 3) -> float:
    """Device time per call (`device_timing`)."""
    return device_timing(fn, calls, attempts)[0]


def device_ms_at_least(fn, floor_ms: float, calls: int = 10) -> tuple:
    """(device ms per call, how it was timed): device_timing, unless it is
    below `floor_ms`, the least time the work can take (the profiler
    dropped records), then CUDA events around the calls."""
    ms, how = device_timing(fn, calls)
    if ms >= floor_ms:
        return ms, how
    log(f"device_ms: {ms:.4f} ms is below the bound {floor_ms:.4f} ms (profiler records "
        f"dropped); CUDA-event time per call used instead")
    return event_ms(lambda: [fn() for _ in range(calls)]) / calls, "CUDA events"


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


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])


def phase_preact(device, boards, model, gen):
    """Phase 3b: the pre-activation kernel. (a) Every call the bf16 plain
    forward and ServeNet make at N in PREACT_BATCHES, on these boards'
    features, is held against the eager ops on the same input: 0 differing
    bits. Both layouts (channels_last ConvBlock inputs, NCHW after each
    broadcast mix) and both trunk widths must be among them, one call a
    ConvBlock and a broadcast mix a forward. (b) bf16 channels_last at C in
    PREACT_TIMED_C, N in PREACT_TIMED_N, and NCHW at C = 128, N = 2880:
    the kernel's and the eager chain's device ms, the byte bound and the
    share. Returns (calls checked, rows)."""
    kernel = preact_ops.preact
    seen, differ = {}, []

    def checked(x, a=None, b=None):
        y = kernel(x, a, b)
        key = (int(x.shape[1]), "nchw" if x.is_contiguous() else "nhwc")
        seen[key] = seen.get(key, 0) + 1
        n = int((_bits(y) != _bits(preact_ops.preact_reference(x, a, b))).sum())
        if n:
            differ.append((tuple(x.shape), key[1], n))
        return y

    cfg = model.config
    per_forward = sum(isinstance(mod, (ConvBlock, Broadcast))
                      for i in range(cfg.blocks)
                      for mod in getattr(model, block_name(cfg, i)).modules())
    net = ServeNet(model)
    # The kernel's wrapper counts into the module's `preact`, the spy here.
    checked.launches, checked.plain_calls = kernel.launches, kernel.plain_calls
    preact_ops.preact = checked
    try:
        for N in PREACT_BATCHES:
            sub = type(boards)(*[t[:N] for t in boards])
            planes, scalars = batched_features(sub, planes_dtype=model.dtype)
            model(planes, scalars)
            net(planes, scalars)
        torch.cuda.synchronize()
    finally:
        preact_ops.preact = kernel
        kernel.launches, kernel.plain_calls = checked.launches, checked.plain_calls
    calls = sum(seen.values())
    log(f"phase 3b: {calls} preact calls of the bf16 plain and ServeNet forwards at N in "
        f"{PREACT_BATCHES} against the eager ops, by (C, layout) {seen}: "
        f"{len(differ)} with differing bits {differ[:4]}")
    if differ:
        raise AssertionError(f"preact kernel != eager ops on the forward's activations: {differ}")
    if calls != 2 * per_forward * len(PREACT_BATCHES):
        raise AssertionError(f"phase 3b: {calls} preact calls, want {per_forward} a forward")
    widths = {cfg.channels, cfg.bottleneck_channels}
    if {k[1] for k in seen} != {"nchw", "nhwc"} or {k[0] for k in seen} != widths:
        raise AssertionError(f"phase 3b: the forwards ran the kernel at {sorted(seen)}; want "
                             f"both layouts at C in {widths}")

    rows = {}
    cases = [(C, N, "nhwc") for C in PREACT_TIMED_C for N in PREACT_TIMED_N]
    for C, N, layout in cases + [(128, max(PREACT_TIMED_N), "nchw")]:
        x = (4.0 * torch.randn(N, C, 19, 19, generator=gen, device=device)).bfloat16()
        if layout == "nhwc":
            x = x.contiguous(memory_format=torch.channels_last)
        a = 0.5 + torch.rand(C, generator=gen, device=device)
        b = torch.rand(C, generator=gen, device=device) - 0.5
        if not torch.equal(_bits(kernel(x, a, b)), _bits(preact_ops.preact_reference(x, a, b))):
            raise AssertionError(f"preact kernel != eager ops at C={C}, N={N}, {layout}")
        b_ms, b_by = bound_ms(0, 2 * x.numel() * x.element_size())
        ms, how = device_ms_at_least(lambda: kernel(x, a, b), b_ms, calls=50)
        plain = device_ms(lambda: preact_ops.preact_reference(x, a, b), 10)
        rows[f"C={C} N={N} {layout}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / ms, "x_eager": plain / ms, "timing": how}
        log(f"phase 3b: preact C={C} N={N} {layout}: kernel {ms:.4f} ms ({how}), eager chain "
            f"{plain:.4f} ms, x{plain / ms:.2f}; bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}%")
    return calls, rows


def check_fused_launches(launches, what):
    """The fused route launched its three kernels and no pre-activation
    kernel (its trunk_fn replaces the whole trunk)."""
    for k in FUSED_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched by {what}")
    if launches["preact"] != 0:
        raise AssertionError(f"{what} launched the preact kernel {launches['preact']} times")


def check_preact_ply(launches, profiled, what):
    """The plain and folded routes launched the pre-activation kernel, and
    in the profiled ply one kernel a wrapper call (a record CUPTI dropped
    reads one low)."""
    calls = profiled["wrapper_calls"]["preact"]
    records = sum(n for k, n in profiled["kernel_records"].items()
                  if k.startswith(KERNEL_PREFIX["preact"]))
    if launches["preact"] <= 0 or not (calls > 0 and calls - 1 <= records <= calls):
        raise AssertionError(f"{what}: preact launches {launches['preact']}; in the profiled "
                             f"ply {calls} calls ran {records} kernels")


def check_finite(out, fields, what):
    for f in fields:
        if not bool(torch.isfinite(getattr(out, f)).all()):
            raise AssertionError(f"{what} output {f} not finite")


def rel_err(got, want):
    d = float((got.float() - want.float()).abs().max())
    return d, d / float(want.float().abs().max())


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    """(least time on the card in ms, "operations" or "bytes"), the
    operations at `peak` per second."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
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


def trunk_kernel_routes(broadcast: bool) -> dict:
    """{kernel<widths>: the tensor-core instructions it must hold} of every
    width of the broadcast (or segment) kernels: HGMMA (wgmma) for all but
    tiny's, whose segment runs on HMMA (mma.sync) and whose broadcast block
    on both (the mix on wgmma, conv_first and conv_last on mma.sync)."""
    if broadcast:
        routes = {}
        for c in trunk_ops.BROADCAST_WIDTHS:
            if c == trunk_ops.BROADCAST_SMALL:
                routes[f"trunk_broadcast_small_kernel<{c}>"] = ("HGMMA", "HMMA")
            elif c in trunk_ops.BROADCAST_WIDE:
                routes.update({f"trunk_broadcast_{k}_kernel<{c}>": ("HGMMA",)
                               for k in ("first", "mix", "last")})
            else:
                routes[f"trunk_broadcast_kernel<{c}>"] = ("HGMMA",)
        return routes
    routes = {}
    for c, cb in trunk_ops.SEGMENT_WIDTHS:
        if (c, cb) == trunk_ops.SEGMENT_SMALL:
            routes[f"trunk_segment_small_kernel<{c},{cb}>"] = ("HMMA",)
        else:
            kind = "_cluster" if (c, cb) in trunk_ops.SEGMENT_CLUSTER else ""
            routes[f"trunk_segment{kind}_kernel<{c},{cb}>"] = ("HGMMA",)
    return routes


def sass_counts(source: str, ops=("HGMMA",)):
    """({kernel<widths>: instructions naming one of `ops`}, {kernel<widths>:
    SASS instructions}) in the built library of `source`, from `cuobjdump
    -sass`; None where cuobjdump is missing. The second says how much code
    a kernel streams through the instruction cache."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(cuda_build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", cuda_build.built_path(source)],
                          capture_output=True, text=True, check=True, timeout=120).stdout
    counts, size, name = {}, {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"(trunk_(?:segment|broadcast)(?:_cluster|_first|_mix|_last|_small)?"
                          r"_kernel"
                          r"|conv_i8_kernel)I((?:Li\d+E)+)", line)
            widths = ",".join(re.findall(r"Li(\d+)E", m.group(2))) if m else ""
            name = (f"{m.group(1)}<{widths}>" if m
                    else line.split("Function :")[1].strip())
            counts[name] = size[name] = 0
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", line):
            size[name] += 1
            counts[name] += any(op in line for op in ops)
    return counts, size


def stem_activations(model, boards, n: int) -> torch.Tensor:
    """The trunk input the main path gives the kernels: the bf16 stem output
    of the first `n` boards, [n, 361, C]."""
    sub = type(boards)(*[t[:n] for t in boards])
    planes, scalars = batched_features(sub, planes_dtype=model.dtype)
    with torch.no_grad():
        x = model.stem(planes, scalars).permute(0, 2, 3, 1)
    return x.reshape(n, 361, -1).to(torch.bfloat16).contiguous()


def check_trunk(name, model, stem, max_err, timed=(), rows=None, phase="5",
                trunk_batches=None):
    """Each segment and broadcast call of `model`'s fused trunk against its
    plain version at every N of TRUNK_BATCHES, on the bf16 stem activations
    stem[:N], each call fed the plain output of the call before
    (KERNEL_TOL), and build_trunk_fn / build_trunk_fn_v2 against their
    plain trunks (TRUNK_TOL) at every N of `trunk_batches` (default
    TRUNK_BATCHES). Raises on a miss; adds each kernel's max |d|
    to `max_err`. At each N of `timed`, the first call of each kernel gets
    kernel_row() in rows["<kernel>@N"]. Returns {kernel: (x, w)}: each
    kernel's first call at max(TRUNK_BATCHES)."""
    cfg = model.config
    trunk_batches = TRUNK_BATCHES if trunk_batches is None else trunk_batches
    trunk_fn = build_trunk_fn(cfg, model)
    trunk_v2 = build_trunk_fn_v2(cfg, model)
    kernel_rel, trunk_rel, first = 0.0, [0.0, 0.0], {}
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
            if N in timed and row_key not in rows:
                rows[row_key] = kernel_row(kern, w, x, phase)
            if N == max(TRUNK_BATCHES) and kern.__name__ not in first:
                first[kern.__name__] = (x, w)
            x = want
        if N not in trunk_batches:
            continue
        xs = x0.reshape(N, 19, 19, cfg.channels)
        for i, fn in enumerate((trunk_fn, trunk_v2)):
            got, want = fn(xs), trunk_reference(xs, fn.segments)
            torch.cuda.synchronize()
            d, rel = rel_err(got, want)
            if not (bool(torch.isfinite(got.float()).all()) and rel <= TRUNK_TOL):
                raise AssertionError(f"{name} N={N} trunk v{i + 1} vs plain: "
                                     f"max |d| {d}, relative {rel}")
            trunk_rel[i] = max(trunk_rel[i], rel)
    log(f"phase {phase}: {name}: kernel vs plain per call max relative {kernel_rel:.3e} "
        f"(bound {KERNEL_TOL}) at N in {list(TRUNK_BATCHES)}; trunk v1 {trunk_rel[0]:.3e}, "
        f"v2 {trunk_rel[1]:.3e} (bound {TRUNK_TOL}) at N in {list(trunk_batches)}")
    return first


def time_kernel_and_plain(kern, plain, w, x, plain_calls: int = 10):
    """(device ms, wall ms) of the kernel and of its plain version on x (the
    plain version's device time over `plain_calls` calls, its wall time
    only at 10 or more: None below), and the kernel's bound (ms, by)."""
    work = (segment_work if kern is trunk_ops.trunk_segment else broadcast_work)(w, x.shape[0])
    plain_wall = wall_ms(lambda: plain(x, w), 3, 5) if plain_calls >= 10 else None
    return ((device_ms(lambda: kern(x, w), 10), wall_ms(lambda: kern(x, w), 3, 5)),
            (device_ms(lambda: plain(x, w), plain_calls), plain_wall),
            bound_ms(*work))


def top1_agreement(a, b) -> float:
    return float((a.pi_logits.argmax(-1) == b.pi_logits.argmax(-1)).float().mean())


def check_fused_model(model, planes, scalars, ref_out, what: str, ref: str = "plain bf16"):
    """The model (bf16) with the fused trunk against the outputs `ref_out`
    of the `ref` model on the same positions: every output finite, policy
    top-1 agreement >= 0.95. Returns (fused outputs, top-1 agreement, max
    |d value|)."""
    fused = model(planes, scalars, trunk_fn=build_trunk_fn(model.config, model))
    check_finite(fused, ModelOutputs._fields, f"fused bf16 {what}")
    top1 = top1_agreement(fused, ref_out)
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    dv = float((value(fused) - value(ref_out)).abs().max())
    log(f"{what}: fused-trunk model vs {ref} model on {planes.shape[0]} "
        f"positions: top-1 agreement {top1:.4f}, max |d value| {dv:.3e}")
    if top1 < 0.95:
        raise AssertionError(f"{what}: fused-trunk top-1 agreement with the {ref} model "
                             f"{top1} < 0.95")
    return fused, top1, dv


def phase_trunk(device, boards, forward_model, forward_batch, gen):
    """Trunk kernels against their plain versions, the trunks against the
    plain trunks, the fused model against the plain bf16 model, and times.
    Inputs are stem activations of the boards of phase 2.
    Returns ({kernel name: max |d|}, {timed row: (device ms, wall ms)},
    {"<kernel>@N": each trunk kernel's row at each timed N}, {config:
    the same rows of each other config of TRUNK_CONFIGS, with the plain
    version's device ms})."""
    max_err = {"trunk_segment": 0.0, "trunk_broadcast": 0.0}
    times, kernel_rows, other_rows = {}, {}, {}
    plains = {trunk_ops.trunk_segment: trunk_ops.trunk_segment_reference,
              trunk_ops.trunk_broadcast: trunk_ops.trunk_broadcast_reference}
    for name in TRUNK_CONFIGS:
        model = (forward_model if name == TRUNK_CONFIGS[0]
                 else seeded_model(name, device, gen))
        model.dtype = torch.bfloat16
        stem = stem_activations(model, boards, max(TRUNK_BATCHES))
        rows = kernel_rows if name == TRUNK_CONFIGS[0] else other_rows.setdefault(name, {})
        first = check_trunk(name, model, stem, max_err, TRUNK_TIMED, rows)
        if name != TRUNK_CONFIGS[0]:
            for kern, plain in plains.items():
                x, w = first[kern.__name__]
                for N in TRUNK_TIMED:
                    k_t, p_t, _ = time_kernel_and_plain(kern, plain, w, x[:N])
                    rows[f"{kern.__name__}@{N}"].update(wall_ms=k_t[1], plain_ms=p_t[0])
                    log(f"phase 5: {name} {kern.__name__} N={N}: wall {k_t[1]:.4f} ms per "
                        f"call; plain device {p_t[0]:.3f} ms")
            continue
        for kern, plain in plains.items():
            x, w = first[kern.__name__]
            k_t, p_t, bound = time_kernel_and_plain(kern, plain, w, x[:max(TRUNK_TIMED)])
            times[kern.__name__], times[kern.__name__ + "_plain"] = k_t, p_t
            times[kern.__name__ + "_bound"] = bound

    # The bench model: fused trunk vs the plain bf16 model, then times.
    model = forward_model
    cfg = model.config
    planes, scalars, plain_out = forward_batch
    check_fused_model(model, planes, scalars, plain_out, "phase 5")
    trunk_fn = build_trunk_fn(cfg, model)
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
    return max_err, times, kernel_rows, other_rows


def kernel_row(kern, w, x, phase: str = "5"):
    """A trunk kernel (segment or broadcast) on x: device time per call,
    its work, bound and share of it, and its products alone in PyTorch
    (library_products_ms)."""
    n = x.shape[0]
    segment = kern is trunk_ops.trunk_segment
    flops, nbytes = (segment_work if segment else broadcast_work)(w, n)
    b_ms, b_by = bound_ms(flops, nbytes)
    ms, timing = device_ms_at_least(lambda: kern(x, w), b_ms)
    products = segment_library_products if segment else broadcast_library_products
    lib_ms, lib_timing = device_ms_at_least(products(w, x), bound_ms(flops, 0)[0])
    row = {"ms": ms, "gflop": flops / 1e9, "tflops": flops / ms / 1e9,
           "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms,
           "library_products_ms": lib_ms, "timing": timing, "library_timing": lib_timing}
    if segment:
        row["n_blocks"] = int(w.aff.shape[0])
        what = (f"trunk_segment N={n} ({row['n_blocks']} blocks)",
                "bf16 F.conv2d + torch.matmul; no single PyTorch call computes the segment")
    else:
        what = (f"trunk_broadcast N={n}", "bf16 torch.matmul x.Wf, WdT.m, z.Wl; no single "
                "PyTorch call computes the broadcast block")
    log(f"phase {phase}: {what[0]}: device {ms:.4f} ms, {row['gflop']:.1f} GFLOP, "
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


def cuda_kernel_counts(fn, calls: int = 10, attempts: int = 10) -> dict:
    """{kernel: launches per call} of every CUDA kernel that `calls` calls of
    `fn` run, from the profiler's kernel records: the port's kernels named
    as `kernel_records` names them, others by their profiler key. A kernel
    with any record counts at least 1, so a dropped record (device_timing)
    does not hide one, nor a kernel that ran once in the calls. CUPTI
    sometimes keeps no record of a whole profile: such a profile is taken
    again, up to `attempts` profiles."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
                continue
            m = re.search(r"((?:trunk|point)_\w*?kernel)(<[\d, ]+>)?", e.key)
            name = m.group(1) + (m.group(2) or "").replace(" ", "") if m else e.key
            out[name] = out.get(name, 0) + e.count
        if out:
            break
        log(f"cuda_kernel_counts: a profile of {calls} calls kept no kernel record; taken again")
    return {k: max(1, round(n / calls)) for k, n in out.items()}


def kernel_records(prof) -> dict:
    """{kernel<widths>: launches} of the port's own kernels (trunk_*,
    point_liberties, preact) in a profile, from its CUDA kernel records."""
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        m = re.search(r"((?:trunk|point|preact)_\w*?kernel)(<[\d, ]+>)?", e.key)
        if m:
            name = m.group(1) + (m.group(2) or "").replace(" ", "")
            out[name] = out.get(name, 0) + e.count
    return out


# The prefix of the CUDA kernel names each wrapper of KERNELS launches.
KERNEL_PREFIX = {"point_liberties_batch": "point_liberties_", "trunk_segment": "trunk_segment_",
                 "trunk_broadcast": "trunk_broadcast_", "preact": "preact_"}


def phase_selfplay(device, model, gen, eval_fn, plies, phase, kernels=KERNELS,
                   reset_every=RESET_EVERY, profiled_ply=False):
    """`plies` plies of the tiered self-play step, resetting finished games
    after every `reset_every`-th; returns (launches of each kernel in
    `kernels` during the run, plies/s, moves/s, profiled). With
    `profiled_ply`, one more ply, after the timed ones and held to the same
    checks, runs under the profiler: `profiled` = {"kernel_records":
    {kernel<widths>: launches in that ply}, "wrapper_calls": {wrapper: its
    count's rise in that ply}, "kernels_per_call": {wrapper: the records of
    its kernels over its calls}}; else None. CUPTI may drop a record now and
    then (see device_timing), so a count can read one low."""
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

    for k in kernels:
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
        if (ply + 1) % reset_every == 0:
            done = finished_mask(states, cfg)
            states, buf, aux, tree = reset_finished(
                states, buf, aux, done, cfg.komi, generator=gen,
                max_raw_policy_moves=0, reuse_tree=tree)
            resets += 1
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}

    profiled = None
    if profiled_ply:
        prev = states
        active = ~finished_mask(prev, cfg)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            states, buf, aux, tree = selfplay_step_tiered(
                states, buf, aux, eval_fn, params_sel, params_fast, cfg,
                generator=gen, reuse_tree=tree, reuse_capacity=reuse_capacity)
            torch.cuda.synchronize()
        t = prev.move_count.long().clamp(max=cfg.max_game_len - 1)
        checks.append((prev, active, buf.move[b, t].long(), buf.pi[b, t].clone(), states))
        records = kernel_records(prof)
        calls = {k.__name__: k.launches - launches[k.__name__] for k in kernels}
        per_call = {k: sum(n for name, n in records.items()
                           if name.startswith(KERNEL_PREFIX[k])) / calls[k]
                    for k in calls if calls[k] > 0}
        profiled = {"kernel_records": records, "wrapper_calls": calls,
                    "kernels_per_call": per_call}
        log(f"phase {phase}: one more ply under the profiler: kernel records {records}; "
            f"wrapper calls {calls}; kernels per call {per_call}")

    for ply, check in enumerate(checks):
        check_ply(*check, f"phase {phase} ply {ply}")
    log(f"phase {phase}: {plies} plies at B={B}, {resets} resets, {moves_played} moves "
        f"in {dt:.2f} s; every move legal and superko-clean, pi_improved sums to 1; "
        f"launches {launches}")
    return launches, plies / dt, moves_played / dt, profiled


def phase_wide_trunk(device, boards, gen):
    """Phase 15: the fused trunk at the widths whose kernels split a board
    over a thread-block cluster (WIDE_CONFIGS) and at tiny's (TINY_CONFIG),
    weights seeded from WIDE_SEED. Returns ({kernel: max |d|}, {config:
    measurements})."""
    cpu_gen = torch.Generator().manual_seed(WIDE_SEED)
    max_err = {"trunk_segment": 0.0, "trunk_broadcast": 0.0}
    info = {}
    sub = type(boards)(*[t[:512] for t in boards])
    planes, scalars = batched_features(sub, planes_dtype=torch.float32)
    plains = {trunk_ops.trunk_segment: trunk_ops.trunk_segment_reference,
              trunk_ops.trunk_broadcast: trunk_ops.trunk_broadcast_reference}
    for name in WIDE_CONFIGS:
        t0 = time.perf_counter()
        model = seeded_model(name, device, cpu_gen)
        model.dtype = torch.bfloat16
        stem = stem_activations(model, boards, max(TRUNK_BATCHES))
        rows = {}
        first = check_trunk(name, model, stem, max_err, TRUNK_TIMED, rows, phase="15",
                            trunk_batches=WIDE_TRUNK_BATCHES)
        for kern, plain in plains.items():
            x, w = first[kern.__name__]
            for N in TRUNK_TIMED:
                k_t, p_t, _ = time_kernel_and_plain(kern, plain, w, x[:N], WIDE_PLAIN_CALLS)
                row = rows[f"{kern.__name__}@{N}"]
                row.update(wall_ms=k_t[1], plain_ms=p_t[0])
                log(f"phase 15: {name} {kern.__name__} N={N}: wall {k_t[1]:.4f} ms per call; "
                    f"plain device {p_t[0]:.3f} ms")
        trunk_fn = build_trunk_fn(model.config, model)
        xs = stem.reshape(-1, 19, 19, model.config.channels)
        trunk_times = {}
        for N in TRUNK_TIMED:
            fn = lambda: trunk_fn(xs[:N])
            trunk_times[str(N)] = {"ms": device_ms(fn, 5), "wall_ms": wall_ms(fn, 3, 2)}
            log(f"phase 15: {name} N={N} fused_trunk: device {trunk_times[str(N)]['ms']:.3f} "
                f"ms, wall {trunk_times[str(N)]['wall_ms']:.3f} ms per call")
        del stem, xs, first
        # Which bf16 forward is faster at this width: the model with the
        # fused trunk, or ServeNet's folded forward (cuDNN convolutions).
        net = ServeNet(model)
        forwards = {}
        for N in TRUNK_TIMED:
            p_n, s_n = batched_features(type(boards)(*[t[:N] for t in boards]),
                                        planes_dtype=model.dtype)
            with torch.no_grad():
                for row, fn in (("fused_forward", lambda: model(p_n, s_n, trunk_fn=trunk_fn)),
                                ("servenet_forward", lambda: net(p_n, s_n))):
                    # CUDA events around single calls (tens to hundreds of ms a
                    # call, so the host's launch gaps are a small part).
                    forwards[f"{row}@{N}"] = wall_ms(fn, WIDE_FORWARD_CALLS, 1)
                    log(f"phase 15: {name} N={N} {row}: {forwards[f'{row}@{N}']:.3f} ms per "
                        f"call (CUDA events, median of {WIDE_FORWARD_CALLS})")
        del net, p_n, s_n
        # The fused model against the float32 model: at these widths a
        # seeded network's policy is near flat (a tenth of the positions
        # has its top two logits within 0.005), so two bf16 evaluations
        # part on near-ties; the plain bf16 model's own agreement with
        # float32 is printed beside the fused model's with it.
        model.dtype = torch.float32
        f32_out = model(planes, scalars)
        model.dtype = torch.bfloat16
        bf16_out = model(planes, scalars)
        fused, top1, dv = check_fused_model(model, planes, scalars, f32_out,
                                            f"phase 15 {name}", ref="float32")
        top1_bf16 = top1_agreement(fused, bf16_out)
        bf16_vs_f32 = top1_agreement(bf16_out, f32_out)
        log(f"phase 15 {name}: top-1 agreement on the same positions (informative): fused "
            f"vs plain bf16 model {top1_bf16:.4f}; plain bf16 model vs float32 "
            f"{bf16_vs_f32:.4f}")
        launches, plies_s, moves_s, profiled = phase_selfplay(
            device, model, gen, make_eval_fn(model, use_fused_trunk=True), WIDE_PLIES,
            f"15 {name}", reset_every=WIDE_RESET_EVERY, profiled_ply=True)
        check_fused_launches(launches, f"phase 15's {name} self-play")
        C, cb = model.config.channels, model.config.bottleneck_channels
        wide_kernels = [f"trunk_segment_cluster_kernel<{C},{cb}>"] + [
            f"trunk_broadcast_{part}_kernel<{C}>" for part in ("first", "mix", "last")]
        missing = [k for k in wide_kernels if profiled["kernel_records"].get(k, 0) <= 0]
        if missing:
            raise AssertionError(f"phase 15 {name}: the profiled ply ran none of {missing}")
        info[name] = {
            "rows": rows, "fused_trunk": trunk_times, "forwards": forwards, "top1_vs_f32": top1,
            "top1_vs_bf16": top1_bf16, "bf16_top1_vs_f32": bf16_vs_f32, "max_d_value": dv,
            "launches": launches,
            "launches_per_ply": {k: n / WIDE_PLIES for k, n in launches.items()},
            "profiled_ply": profiled,
            "plies_s": plies_s, "moves_s": moves_s, "seconds": time.perf_counter() - t0}
        log(f"phase 15: {name}: {plies_s:.3f} plies/s, {moves_s:.1f} moves/s at B={BENCH_B} "
            f"with the fused trunk (informative); {time.perf_counter() - t0:.1f} s")
        del model, trunk_fn, fused, f32_out, bf16_out
        torch.cuda.empty_cache()

    # tiny: its own kernels (SEGMENT_SMALL, BROADCAST_SMALL).
    t0 = time.perf_counter()
    model = seeded_model(TINY_CONFIG, device, cpu_gen)
    model.dtype = torch.bfloat16
    stem = stem_activations(model, boards, max(TRUNK_BATCHES))
    rows = {}
    first = check_trunk(TINY_CONFIG, model, stem, max_err, TRUNK_TIMED, rows, phase="15",
                        trunk_batches=WIDE_TRUNK_BATCHES)
    # One kernel a wrapper call, tiny's own, and no other (no pad or slice).
    calls_kernels = {}
    for kern, name in SMALL_KERNELS.items():
        x, w = first[kern.__name__]
        got = cuda_kernel_counts(lambda: kern(x, w), 10)
        if got != {name: 1}:
            raise AssertionError(f"phase 15 {TINY_CONFIG}: a {kern.__name__} call ran {got}, "
                                 f"not one {name}")
        calls_kernels[kern.__name__] = got
    log(f"phase 15: {TINY_CONFIG}: CUDA kernels a wrapper call {calls_kernels}")
    for kern, plain in plains.items():
        x, w = first[kern.__name__]
        for N in TRUNK_TIMED:
            k_t, p_t, _ = time_kernel_and_plain(kern, plain, w, x[:N], 10)
            row = rows[f"{kern.__name__}@{N}"]
            row.update(wall_ms=k_t[1], plain_ms=p_t[0])
            log(f"phase 15: {TINY_CONFIG} {kern.__name__} N={N}: wall {k_t[1]:.4f} ms per "
                f"call; plain device {p_t[0]:.3f} ms")
    before = {k: k.launches for k in plains}
    out = make_eval_fn(model, use_fused_trunk=True)(type(boards)(*[t[:64] for t in boards]))
    torch.cuda.synchronize()
    for f in out._fields:
        if not bool(torch.isfinite(getattr(out, f)).all()):
            raise AssertionError(f"phase 15 {TINY_CONFIG} fused eval {f} not finite")
    if any(k.launches <= before[k] for k in plains):
        raise AssertionError(f"phase 15 {TINY_CONFIG}: the fused eval launched no kernel")
    launches, plies_s, _, profiled = phase_selfplay(
        device, model, gen, make_eval_fn(model, use_fused_trunk=True), TINY_PLIES,
        f"15 {TINY_CONFIG}", profiled_ply=True)
    check_fused_launches(launches, f"phase 15's {TINY_CONFIG} self-play")
    # The profiled ply ran tiny's kernels and no other trunk kernel, one a
    # wrapper call (a dropped profiler record reads one low).
    records = {k: n for k, n in profiled["kernel_records"].items()
               if k.startswith("trunk_")}
    for kern, name in SMALL_KERNELS.items():
        calls = profiled["wrapper_calls"][kern.__name__]
        if not (calls > 0 and calls - 1 <= records.get(name, 0) <= calls):
            raise AssertionError(f"phase 15 {TINY_CONFIG}: the profiled ply's {kern.__name__} "
                                 f"calls {calls} ran {records}")
    if set(records) != set(SMALL_KERNELS.values()):
        raise AssertionError(f"phase 15 {TINY_CONFIG}: the profiled ply ran {records}")
    info[TINY_CONFIG] = {"seconds": time.perf_counter() - t0, "rows": rows,
                         "launches": launches,
                         "launches_per_ply": {k: n / TINY_PLIES for k, n in launches.items()},
                         "kernels_per_wrapper_call": calls_kernels,
                         "profiled_ply": profiled,
                         "plies_s": plies_s}
    log(f"phase 15: {TINY_CONFIG} on its own kernels: fused eval on 64 boards finite; "
        f"{plies_s:.3f} plies/s; {time.perf_counter() - t0:.1f} s")
    return max_err, info


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


def gen_config(**changes):
    """config/b12-onegen.json with phase 8's cuts (GEN_CUTS), and `changes`
    (phase 12 (b): the model configuration)."""
    cfg = parse_run_config(GEN_CONFIG)
    return dataclasses.replace(cfg, **GEN_CUTS, **changes)


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


def check_gen_sgfs(spies: GenSpies, B: int, max_len: int, label: str = "phase 8") -> int:
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
                    f"{label}: board {b}'s SGF (from move {init_mv[b]}: "
                    f"{moves[int(init_mv[b]):][:8]}..., {len(moves)} rows) != the "
                    f"{len(played)} moves it played ({played[:8]}...)")
            checked += 1
    on_disk = set()
    for name in os.listdir(spies.loop.sgf_dir):
        with open(os.path.join(spies.loop.sgf_dir, name)) as f:
            on_disk.add(f.read())
    if not on_disk or not on_disk <= set(spies.sgfs):
        raise AssertionError(f"{label}: an SGF on disk is none of the games written")
    return checked


def check_resume(loop: GenerationLoop, cfg, root: str, device, label: str = "phase 8"):
    """A second loop on the same directory resumes bitwise: gen, golden,
    train params and BN statistics, optimizer state, step, generators,
    sel_mult base and both replay rings."""
    again = GenerationLoop(cfg, root_dir=root, seed=GEN_SEED, device=device)
    if not again.try_resume():
        raise AssertionError(f"{label}: try_resume found nothing")
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
        raise AssertionError(f"{label}: resume is not bitwise for {bad}")
    return again


def phase_gen(device, smi, root, model_config=None):
    """Phase 8 (see the module docstring), in the empty directory `root`,
    which keeps model_0001 and the SGFs for phase 10; with `model_config`,
    phase 12 (b): the same generation at that network. Returns (liberty
    launches of the generation, the {"gen": ...} measurements)."""
    t_phase = time.perf_counter()
    label = "phase 8" if model_config is None else "phase 12 (b)"
    cfg = gen_config() if model_config is None else gen_config(model_config=model_config)
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
        check_ply(*check, f"{label} self-play ply {ply}")
    games = check_gen_sgfs(spies, B, cfg.selfplay_max_game_len, label)
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
        raise AssertionError(f"{label}: failed checks {bad}")
    restarts = spies.restarts

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    check_resume(loop, cfg, root, device, label)
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
    log(f"{label}: GenerationLoop(config/b12-onegen.json, {cfg.model_config} bf16) with "
        f"cuts {cuts}: "
        f"{games} games harvested and checked ({restarts} GoExploit/fork restarts), "
        f"every move legal and superko-clean, every SGF parses back into its moves; "
        f"eval {res.cand_wins:.0f} wins + {losses} losses of {res.num_games}, elo "
        f"{res.elo:.1f}; replay {len(loop.replay)} rows, val {len(loop.val_replay)}, reuse "
        f"buffer {len(loop.reuse)}; resume bitwise")
    log(f"{label}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                for k, v in parts.items())
        + f"; generation {gen_s:.2f} s; liberty launches {launches}; peak memory "
        f"{peak_gb:.2f} GB; phase wall {time.perf_counter() - t_phase:.1f} s ({smi})")
    gen = {"config": "config/b12-onegen.json", "model_config": cfg.model_config,
           "cuts": GEN_CUTS, "seed": GEN_SEED,
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
    # time and kernels per genmove, the idle share against the genmoves'
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
        raise AssertionError(f"phase 10 (a): failed checks {failed}; bad answers {bad[:4]}; "
                             f"byoyomi genmove {byo_ms:.1f} ms, budget {budget_ms} ms, "
                             f"16-visit slice {slice16_ms:.1f} ms, slices (n, visits, ms, "
                             f"root visits) {byo_slices}")
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
    for st, n in ((ladder_positions(device), len(LADDER_POSITIONS)), (sub, LADDER_CPU_B)):
        s0 = laddered_stones.syncs
        planes, scalars = batched_features(st, include_ladders=True)
        syncs = laddered_stones.syncs - s0
        t0 = time.perf_counter()
        want = batched_features(cpu(map_state(lambda t: t[:n], st)), include_ladders=True)
        cpu_s = time.perf_counter() - t0
        equal.append(torch.equal(planes[:n].cpu(), want[0])
                     and torch.equal(scalars[:n].cpu(), want[1]))
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
    info = {"boards": LADDER_B, "cpu_boards": LADDER_CPU_B, "featurize_ms_ladders": with_ms,
            "featurize_ms_plain": without_ms, "ladder_syncs_per_call": syncs,
            "laddered_stones": marked, "liberty_launches": launches,
            "cpu_reference_s": cpu_s, "profiled_busy_ms": busy_ms, "profiled_kernels": kernels,
            "idle_share": 1 - busy_ms / with_ms}
    log(f"phase 10 (c): batched_features(include_ladders=True) card == CPU on the 6 ladder "
        f"positions and the first {LADDER_CPU_B} of {LADDER_B} random-play boards ({marked} "
        f"laddered stones in all {LADDER_B}); "
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


def bus_config():
    """Phase 8's configuration (gen_config) with phase 11's cuts."""
    return dataclasses.replace(gen_config(), **BUS_CUTS)


@contextlib.contextmanager
def measured(stats: dict, key: str, owner, name: str):
    """While open, each call of `owner.name` appends its wall seconds (host
    clock between synchronizes) and its liberty launches to stats[key]."""
    real = getattr(owner, name)
    own = name in vars(owner)

    def fn(*a, **kw):
        torch.cuda.synchronize()
        n0, t0 = point_liberties_batch.launches, time.perf_counter()
        out = real(*a, **kw)
        torch.cuda.synchronize()
        rec = stats.setdefault(key, {"s": [], "launches": 0})
        rec["s"].append(time.perf_counter() - t0)
        rec["launches"] += point_liberties_batch.launches - n0
        return out

    setattr(owner, name, fn)
    try:
        yield
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def rebuilt_examples(games) -> GameExamples:
    """The sunk games as one batch after the chunk format's reconstruction
    rules: z = sign(margin), weight 1, has_pi_aux_dist = any(pi_aux_dist)."""
    cat = GameExamples(**{f.name: np.concatenate([getattr(g, f.name) for g in games])
                          for f in dataclasses.fields(GameExamples)})
    cat.z = np.where(cat.score_margin > 0, 1.0, -1.0).astype(np.float32)
    cat.weight = np.ones_like(cat.weight)
    cat.has_pi_aux_dist = np.abs(cat.pi_aux_dist).sum(-1) > 0
    return cat


def check_exported_planes(path: str) -> int:
    """The atari / two / three-liberty planes of each record of the chunk at
    `path` equal those of point_liberties_reference on its board (CPU).
    Returns the number of boards with a stone of at most three liberties."""
    recs = [decode_example(r) for r in read_records(path)]
    stones = torch.from_numpy(np.stack([np.frombuffer(d["board"], np.int8) for d in recs]))
    libs = point_liberties_reference(stones, compute_chains(stones)).numpy()
    s = stones.numpy()
    for key, n in (("stones_atari", 1), ("stones_two_liberties", 2),
                   ("stones_three_liberties", 3)):
        got = np.stack([np.frombuffer(d[key], np.int8) for d in recs])
        if not np.array_equal(got, np.where(libs == n, s, 0)):
            raise AssertionError(f"phase 11 (a): exported {key} != the plain liberties'")
    return int(((libs <= 3) & (s != 0)).any(axis=1).sum())


def bus_round_trip(device, root: str) -> dict:
    """Phase 11 (a): learner -> store -> actor -> chunk -> store -> learner
    -> store -> actor, in this process."""
    cfg = bus_config()
    store = LocalStore(os.path.join(root, "bus"))
    learner = Learner(cfg, store, run_dir=os.path.join(root, "learner"), seed=GEN_SEED,
                      device=device)
    learner.publish_golden()
    actor = SelfplayActor(cfg, store, worker_id="w0", scratch_dir=os.path.join(root, "actor"),
                          seed=GEN_SEED + 1, device=device)
    first_sync, second_sync = actor.sync_model(), actor.sync_model()
    sunk = []

    def sink(ex):
        sunk.append(ex)
        actor._pending.append(ex)

    actor.loop.game_sink = sink
    stats, chunks = {}, []
    with contextlib.ExitStack() as stack:
        stack.enter_context(measured(stats, "actor_selfplay", actor.loop, "selfplay_games"))
        stack.enter_context(measured(stats, "export", rl_workers, "write_game_chunk"))
        stack.enter_context(measured(stats, "ingest", learner, "ingest_new_chunks"))
        stack.enter_context(measured(stats, "learner_train_gate", learner.loop, "train_and_gate"))
        chunks.append((actor.play_and_publish(cfg.games_per_gen), list(sunk)))
        sunk.clear()
        ingested = learner.ingest_new_chunks()
        reingested = learner.ingest_new_chunks()
        train = learner.train_generation()
        swapped = actor.sync_model()
        want = learner.loop.golden.state_dict()
        have = actor.loop.golden.state_dict()
        same_golden = (have.keys() == want.keys()
                       and all(torch.equal(have[k], want[k]) for k in want))
        chunks.append((actor.play_and_publish(cfg.games_per_gen), list(sunk)))

    fmt = re.compile(r"gen(\d{3})_b(\d{3})_g(\d{3})_n(\d{5})_t\d+_w0\.tfrecord\.zz")
    names_ok, decoded_ok, sizes, planes_boards = True, True, [], 0
    for b, (name, games) in enumerate(chunks):
        m = fmt.fullmatch(os.path.basename(name))
        back = read_game_chunk(store.local_path(name))
        names_ok &= (m is not None and store.is_done(name)
                     and (int(m[1]), int(m[2]), int(m[3]), int(m[4]))
                     == (b, b, len(games), len(back)))
        want = rebuilt_examples(games)
        decoded_ok &= all(np.array_equal(getattr(back, f.name), getattr(want, f.name))
                          and getattr(back, f.name).dtype == getattr(want, f.name).dtype
                          for f in dataclasses.fields(GameExamples))
        sizes.append(os.path.getsize(store.local_path(name)))
        planes_boards += check_exported_planes(store.local_path(name))
    torn = f"{SP_CHUNKS_DIR}/" + CHUNK_FORMAT % (0, 99, 1, 1, 0, "w9")
    store.write_bytes(torn, b"a payload with no .done marker")
    listed = list_done_chunks(store)
    games = [len(g) for _, g in chunks]
    examples = [sum(len(g) for g in gs) for _, gs in chunks]
    checks = {
        "gen 0 synced, then nothing newer": first_sync and not second_sync,
        "chunk names and .done": names_ok,
        "chunks decode to the sunk games": decoded_ok,
        "payload without .done unlisted": (os.path.basename(torn) not in listed
                                           and all(os.path.basename(n) in listed
                                                   for n, _ in chunks)),
        "ingest = chunk 1's examples": ingested == examples[0],
        "re-ingest adds 0": reingested == 0,
        "model_0001 published": train["gen"] == 1 and most_recent_model(store) == 1,
        "hot swap bitwise": swapped and same_golden and actor.loop.gen == 1,
        "exporter launched the liberty kernel": stats["export"]["launches"] > 0,
        "actor and learner launched it": (stats["actor_selfplay"]["launches"] > 0
                                          and stats["learner_train_gate"]["launches"] > 0),
        "liberty planes not all empty": planes_boards > 0,
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 11 (a): failed checks {bad}")
    export_s = stats["export"]["s"]
    return {
        "chunks": [os.path.basename(n) for n, _ in chunks], "games": games,
        "examples": examples, "chunk_bytes": sizes,
        "actor_selfplay_s": stats["actor_selfplay"]["s"],
        "export_ms_per_game": [1e3 * s / g for s, g in zip(export_s, games)],
        "export_s": export_s, "ingest_ms": 1e3 * stats["ingest"]["s"][0],
        "learner_train_gate_s": stats["learner_train_gate"]["s"][0],
        "learner_elo": train["elo"], "learner_promoted": train["promoted"],
        "launches": {k: v["launches"] for k, v in stats.items()},
        "bus_dir": os.path.join(root, "bus"),
    }


def bus_entry_point(root: str) -> dict:
    """Phase 11 (b): `python -m p3achygo_tpu_torch.rl --role learner` and
    `--role actor`, two processes with no --device, one store, --gens 1."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cfg_path = os.path.join(root, "bus_cli.json")
    with open(cfg_path, "w") as f:
        json.dump(dataclasses.asdict(bus_config()), f)
    store_dir = os.path.join(root, "bus_cli")
    procs, logs = {}, {}
    t0 = time.perf_counter()
    try:
        for role in ("learner", "actor"):
            logs[role] = (os.path.join(root, f"cli_{role}.out"),
                          os.path.join(root, f"cli_{role}.err"))
            with open(logs[role][0], "w") as out, open(logs[role][1], "w") as err:
                procs[role] = subprocess.Popen(
                    [sys.executable, "-m", "p3achygo_tpu_torch.rl", "--config", cfg_path,
                     "--gens", "1", "--role", role, "--store", store_dir,
                     "--run-dir", os.path.join(root, f"cli_{role}")],
                    stdout=out, stderr=err, cwd=repo, env=env)
        rcs = {}
        for role, proc in procs.items():
            left = BUS_ENTRY_TIMEOUT_S - (time.perf_counter() - t0)
            rcs[role] = proc.wait(timeout=max(left, 1.0))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    out = {role: open(paths[0]).read() for role, paths in logs.items()}
    lines = {role: [json.loads(x) for x in text.splitlines() if x.startswith("{")]
             for role, text in out.items()}
    ok = (all(rc == 0 for rc in rcs.values())
          and os.path.exists(os.path.join(store_dir, "models", "model_0001.done"))
          and any(x.get("gen") == 1 for x in lines["learner"])
          and any(x.get("chunk") for x in lines["actor"]))
    if not ok:
        raise AssertionError(f"phase 11 (b): rcs {rcs}, stdout {out}, stderr tails " + str(
            {role: open(paths[1]).read()[-2000:] for role, paths in logs.items()}))
    return {"wall_s": wall, "actor_chunks": sum(1 for x in lines["actor"] if x.get("chunk")),
            "learner": lines["learner"][-1]}


def parse_study_report(text: str) -> dict:
    """The numbers of format_report's table: the prior line's four KLD
    statistics and each N row's KLD(GT||N), KLD(N||prior), nats/visit."""
    prior = re.search(r"KLD\(GT, prior\) -- mean: (\S+)  p75: (\S+)  p95: (\S+)  max: (\S+)",
                      text)
    rows = re.findall(r"^(\d+) +(\S+) +(\S+) +(\S+) *$", text, re.MULTILINE)
    examples = re.search(r"^Examples: +(\d+)$", text, re.MULTILINE)
    if prior is None or not rows or examples is None:
        raise AssertionError(f"phase 11 (c): the report does not parse: {text!r}")
    return {"examples": int(examples[1]), "prior": [float(x) for x in prior.groups()],
            "rows": [[int(r[0])] + [float(x) for x in r[1:]] for r in rows]}


def bus_experiments(device, gen_root: str, chunk: str) -> dict:
    """Phase 11 (c): the visits study as a subprocess on (a)'s first chunk
    with phase 8's model_0001; play_games in this process."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cfg = bus_config()
    ckpt = os.path.join(gen_root, "model_0001")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "p3achygo_tpu_torch.experiments", "visits_study",
         "--model_path", ckpt, "--model_config", cfg.model_config, "--chunk_path", chunk,
         *BUS_STUDY], capture_output=True, text=True, timeout=600, cwd=repo, env=env)
    study_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 11 (c): visits_study rc {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    report = parse_study_report(proc.stdout)
    klds = report["prior"] + [x for r in report["rows"] for x in r[1:3]]
    flag = lambda name: BUS_STUDY[BUS_STUDY.index(name) + 1]
    n_values = [int(x) for x in flag("--n_values").split(",")]
    if not (report["examples"] == int(flag("--num_examples"))
            and [r[0] for r in report["rows"]] == n_values
            and all(np.isfinite(x) and x >= 0 for x in klds)
            and all(np.isfinite(r[3]) for r in report["rows"])):
        raise AssertionError(f"phase 11 (c): bad study report {report}")

    model = load_model(cfg.model_config, ckpt, device)
    out = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n0 = point_liberties_batch.launches
    results = play_games(make_eval_fn(model), BUS_PLAY["num_games"], BUS_PLAY["visit_count"],
                         True, [BiasCallback(out=out)], k=BUS_PLAY["k"],
                         max_moves=BUS_PLAY["max_moves"], seed=GEN_SEED, device=device)
    torch.cuda.synchronize()
    play_s = time.perf_counter() - t0
    text = out.getvalue()
    ok = (len(results) == BUS_PLAY["num_games"]
          and all(r.winner in (1, -1) and np.isfinite([r.bscore, r.wscore]).all()
                  and 1 <= r.num_moves <= BUS_PLAY["max_moves"] for r in results)
          and text.count("Game Result:") == BUS_PLAY["num_games"]
          and "Dumping Most Biased Positions for Episode" in text
          and point_liberties_batch.launches > n0)
    if not ok:
        raise AssertionError(f"phase 11 (c): play_games {results}, {text[-500:]!r}")
    return {"study_s": study_s, "study": report, "play_games_s": play_s,
            "play_results": [str(r) for r in results],
            "play_moves": [r.num_moves for r in results]}


def bus_sl(device, root: str, gen_root: str) -> dict:
    """Phase 11 (d): SL shards from phase 8's SGFs, two workers on the card,
    against the lockstep replay on the CPU; build_sl_replay feeds one
    prepare_batch on the card."""
    sgf_dir = os.path.join(gen_root, "sgf")
    out_dir = os.path.join(root, "sl")
    t0 = time.perf_counter()
    rep = build_sl_shards(sgf_dir, out_dir, num_workers=BUS_SL_WORKERS, device=str(device))
    shards_s = time.perf_counter() - t0
    files = sorted(os.path.join(sgf_dir, n) for n in os.listdir(sgf_dir) if n.endswith(".sgf"))
    t0 = time.perf_counter()
    mem = list(iter_sgf_dir(sgf_dir, device="cpu"))
    want = [r for ex in mem for r in examples_to_records(ex, device="cpu")]
    cpu_s = time.perf_counter() - t0
    got = [r for name in rep["shards"] for r in read_records(os.path.join(out_dir, name))]
    with open(os.path.join(out_dir, "sl_shards.done")) as f:
        done = json.load(f)
    alone = [sgf_to_examples(open(p).read(), device=device) for p in files[:4]]
    replay = ReplayBuffer(capacity=1 << 16)
    n_games = build_sl_replay(sgf_dir, replay, device=device)
    n0 = point_liberties_batch.launches
    planes, scalars, _ = prepare_batch(replay.sample(LEARN_TRAIN_B), device=device)
    checks = {
        "shards == in-memory examples": sorted(got) == sorted(want),
        "report counts": ((rep["files"], rep["games"], rep["examples"], rep["workers"])
                          == (len(files), len(mem), len(want), BUS_SL_WORKERS)),
        ".done report": done == rep,
        "one game alone == its lockstep replay": all(
            a is not None and all(np.array_equal(getattr(a, f.name), getattr(b, f.name))
                                  for f in dataclasses.fields(GameExamples))
            for a, b in zip(alone, mem[:4])),
        "build_sl_replay": n_games == len(mem) and len(replay) == len(want),
        "prepare_batch": (bool(torch.isfinite(planes).all()) and bool(torch.isfinite(scalars).all())
                          and point_liberties_batch.launches > n0),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 11 (d): failed checks {bad}; report {rep}")
    return {"shards_s": shards_s, "cpu_reference_s": cpu_s, "report": rep}


def bus_anchor(device, gen_root: str, bus_dir: str) -> dict:
    """Phase 11 (e): anchor_match of phase 8's model_0001 against the gen-0
    weights the learner published (seed GEN_SEED, phase 8's initial ones)."""
    name = bus_config().model_config
    cand = load_model(name, os.path.join(gen_root, "model_0001"), device)
    cur = load_model(name, os.path.join(bus_dir, "models", "model_0000"), device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = anchor_match(cand, cur, seed=GEN_SEED, **BUS_ANCHOR)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (res.num_games == BUS_ANCHOR["num_games"]
            and 0 <= res.cand_wins <= res.num_games and np.isfinite(res.elo)):
        raise AssertionError(f"phase 11 (e): anchor match {res}")
    return {"wall_s": wall, "cand_wins": res.cand_wins, "games": res.num_games,
            "elo": res.elo}


def phase_bus(device, smi, gen_root: str):
    """Phase 11 (see the module docstring), in phase 8's directory. Returns
    (liberty launches of the phase in this process, {part: launches}, the
    {"bus": ...} measurements)."""
    t_phase = time.perf_counter()
    root = os.path.join(gen_root, "bus_phase")
    os.makedirs(root)
    codec = "native" if tfrecord.using_native() else "python"
    log(f"phase 11: tfrecord codec {codec} ({smi})")
    for k in KERNELS:
        k.launches = 0
    info, parts_s = {"codec": codec}, {}
    for key, fn in (("round_trip", lambda: bus_round_trip(device, root)),
                    ("entry_point", lambda: bus_entry_point(root)),
                    ("experiments", lambda: bus_experiments(
                        device, gen_root, os.path.join(info["round_trip"]["bus_dir"],
                                                       SP_CHUNKS_DIR,
                                                       info["round_trip"]["chunks"][0]))),
                    ("sl", lambda: bus_sl(device, root, gen_root)),
                    ("anchor", lambda: bus_anchor(device, gen_root,
                                                  info["round_trip"]["bus_dir"]))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info[key] = fn()
        torch.cuda.synchronize()
        parts_s[key] = time.perf_counter() - t0
    launches = point_liberties_batch.launches
    rt = info["round_trip"]
    log(f"phase 11 (a): bus round trip at {bus_config().model_config} bf16, B="
        f"{bus_config().selfplay_batch_size}: chunks {rt['chunks']} ({rt['games']} games, "
        f"{rt['examples']} examples, {rt['chunk_bytes']} bytes); actor self-play "
        + ", ".join(f"{s:.2f}" for s in rt["actor_selfplay_s"]) + " s; export "
        + ", ".join(f"{x:.2f}" for x in rt["export_ms_per_game"]) + " ms per game; ingest "
        f"{rt['ingest_ms']:.1f} ms; learner train + gate {rt['learner_train_gate_s']:.2f} s; "
        f"liberty launches by part {rt['launches']}; every check held ({smi})")
    ep, ex = info["entry_point"], info["experiments"]
    log(f"phase 11 (b): --role learner + --role actor (no --device), --gens 1: both rc 0, "
        f"model_0001.done on the store, {ep['actor_chunks']} actor chunks, "
        f"{ep['wall_s']:.1f} s wall with start-up ({smi})")
    log(f"phase 11 (c): visits_study subprocess {ex['study_s']:.1f} s, report {ex['study']}; "
        f"play_games {ex['play_results']} in {ex['play_games_s']:.2f} s ({smi})")
    sl, an = info["sl"], info["anchor"]
    log(f"phase 11 (d): SL shards {sl['report']['games']} games, {sl['report']['examples']} "
        f"examples in {len(sl['report']['shards'])} shards by {BUS_SL_WORKERS} workers on the "
        f"card in {sl['shards_s']:.1f} s (CPU reference {sl['cpu_reference_s']:.1f} s) ({smi})")
    log(f"phase 11 (e): anchor_match model_0001 vs gen 0: {an['cand_wins']:.1f} wins of "
        f"{an['games']}, elo {an['elo']:.1f}, {an['wall_s']:.2f} s ({smi})")
    info["parts_s"] = parts_s
    info["liberty_launches"] = launches
    info["phase_wall_s"] = time.perf_counter() - t_phase
    info["card"] = smi
    log(f"phase 11: wall {info['phase_wall_s']:.1f} s: " + ", ".join(
        f"({k}) {v:.1f} s" for k, v in zip("abcde", parts_s.values()))
        + f"; liberty launches {launches} ({smi})")
    return launches, rt["launches"], info


def attention_profile(model, planes, scalars):
    """(device ms of one forward, device ms of its attention, attention
    calls) from one profiled forward: every MultiHeadDotProductAttention
    call runs inside a record_function range named "attention", whose
    device time is the kernels launched inside it (the host-side range:
    on the card the profiler also mirrors each range onto the device's
    timeline as an event of its own, a span, which both sums leave out)."""
    forward = MultiHeadDotProductAttention.forward

    def labelled(self, x):
        with torch.profiler.record_function("attention"):
            return forward(self, x)

    with torch.no_grad():
        model(planes, scalars)
    torch.cuda.synchronize()
    MultiHeadDotProductAttention.forward = labelled
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                model(planes, scalars)
            torch.cuda.synchronize()
    finally:
        MultiHeadDotProductAttention.forward = forward
    events = prof.key_averages()
    total = sum(e.self_device_time_total for e in events
                if e.device_type == DeviceType.CUDA and e.key != "attention")
    attn = [e for e in events if e.key == "attention" and e.device_type == DeviceType.CPU]
    return (total / 1e3, sum(e.device_time_total for e in attn) / 1e3,
            sum(e.count for e in attn))


def transformer_forward(device, boards, gen):
    """Phase 12 (a): b14d96h3_transformer at full width with seeded weights
    (policy sharpened), float32 and bf16 on the card against float32 on the
    CPU; ms per bf16 forward at the widest leaf batch; the attention's
    share of the forward's device time."""
    model = seeded_model(TRANSFORMER, device, gen)
    with torch.no_grad():
        model.policy_head.output_moves.weight.mul_(TRANSFORMER_SHARPEN)
    cpu = build_model(get_config(TRANSFORMER), torch.float32, "cpu")
    cpu.load_state_dict(model.state_dict())
    sub = type(boards)(*[t[:TRANSFORMER_B] for t in boards])
    planes, scalars = batched_features(sub, planes_dtype=torch.float32)
    t0 = time.perf_counter()
    ref = cpu(planes.cpu(), scalars.cpu())
    cpu_s = time.perf_counter() - t0
    f32 = model(planes, scalars)
    d32 = float((f32.pi_logits.cpu() - ref.pi_logits).abs().max())
    model.dtype = torch.bfloat16
    b16 = model(planes, scalars)
    check_finite(b16, ModelOutputs._fields, "transformer bf16")
    value = lambda o: (o.outcome_probs[:, 1] - o.outcome_probs[:, 0]).float().cpu()
    dv = float((value(b16) - value(ref)).abs().max())
    top1 = float((b16.pi_logits.argmax(-1).cpu() == ref.pi_logits.argmax(-1)).float().mean())
    checks = {f"float32 card vs CPU: max |d pi_logits| {d32:.2e} <= {TRANSFORMER_F32_TOL}":
              d32 <= TRANSFORMER_F32_TOL,
              f"bf16 card vs float32 CPU: max |d value| {dv:.4f} <= {TRANSFORMER_VALUE_TOL}":
              dv <= TRANSFORMER_VALUE_TOL,
              f"bf16 top-1 agreement {top1:.4f} >= {TRANSFORMER_TOP1_MIN}":
              top1 >= TRANSFORMER_TOP1_MIN}
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase 12 (a): failed checks {bad}")

    n = max(TRUNK_TIMED)
    wide = type(boards)(*[t[:n] for t in boards])
    wp, ws = batched_features(wide, planes_dtype=torch.bfloat16)
    fwd = lambda: model(wp, ws)
    ms, wall = device_ms(fwd, calls=5), wall_ms(fwd, reps=3, inner=3)
    busy, attn, calls = attention_profile(model, wp, ws)
    if calls != get_config(TRANSFORMER).blocks:
        raise AssertionError(f"phase 12 (a): {calls} attention ranges in a profiled forward")
    info = {"config": TRANSFORMER, "B": TRANSFORMER_B, "f32_max_abs_d_pi_logits": d32,
            "bf16_max_abs_d_value": dv, "bf16_top1_agreement": top1, "cpu_reference_s": cpu_s,
            "forward_N": n, "forward_device_ms": ms, "forward_wall_ms": wall,
            "profiled_forward_ms": busy, "attention_ms": attn, "attention_share": attn / busy}
    log(f"phase 12 (a): {TRANSFORMER} seeded (policy x{TRANSFORMER_SHARPEN}) at B="
        f"{TRANSFORMER_B}: float32 card vs CPU max |d pi_logits| {d32:.2e}; bf16 card vs "
        f"float32 CPU max |d value| {dv:.4f}, top-1 agreement {top1:.4f}; bf16 forward at "
        f"N={n}: {ms:.2f} ms device, {wall:.2f} ms wall; attention {attn:.2f} of {busy:.2f} "
        f"device ms ({attn / busy:.3f})")
    return info


def transformer_gtp(device, ckpt: str):
    """Phase 12 (c): GtpService over (b)'s model_0001 at the transformer's
    width, TRANSFORMER_GENMOVES genmoves alternating colours; every answer
    a success and every move legal by full_legal_mask. Returns (liberty
    launches, measurements)."""
    svc = GtpService(make_eval_fn(load_model(TRANSFORMER, ckpt, device)),
                     GtpConfig(search=SearchParams(**GTP_SEARCH)), device=device)
    point_liberties_batch.launches = 0
    genmove_ms, bad = [], []
    for i in range(TRANSFORMER_GENMOVES):
        color = 1 if i % 2 == 0 else -1
        legal = full_legal_mask(svc._as_mover(svc.state, color))[0]
        t0 = time.perf_counter()
        ok, resp = svc.handle(f"genmove {'b' if color == 1 else 'w'}")
        torch.cuda.synchronize()
        genmove_ms.append(1e3 * (time.perf_counter() - t0))
        if not ok or not bool(legal[gtp_vertex_to_action(resp.strip())]):
            bad.append(resp)
    launches = point_liberties_batch.launches
    if bad or launches <= 0:
        raise AssertionError(f"phase 12 (c): bad genmoves {bad}, liberty launches {launches}")
    log(f"phase 12 (c): GtpService({TRANSFORMER} bf16, model_0001 of (b), n="
        f"{GTP_SEARCH['n']} k={GTP_SEARCH['k']}): {TRANSFORMER_GENMOVES} legal genmoves, "
        f"median {statistics.median(genmove_ms):.1f} ms, max {max(genmove_ms):.1f} ms; "
        f"liberty launches {launches}")
    return launches, {"genmove_ms": genmove_ms, "liberty_launches": launches}


def phase_transformer(device, smi, boards, gen):
    """Phase 12 (see the module docstring). Returns ({part: liberty
    launches}, the {"transformer": ...} measurements)."""
    t_phase = time.perf_counter()
    info = {"forward": transformer_forward(device, boards, gen)}
    with tempfile.TemporaryDirectory() as root:
        gen_launches, info["generation"] = phase_gen(device, smi, root,
                                                     model_config=TRANSFORMER)
        gtp_launches, info["gtp"] = transformer_gtp(device, os.path.join(root, "model_0001"))
    info["phase_wall_s"] = time.perf_counter() - t_phase
    info["card"] = smi
    log(f"phase 12: wall {info['phase_wall_s']:.1f} s ({smi})")
    return {"generation": gen_launches, "gtp": gtp_launches}, info


def phase_scale_out(smi):
    """Phase 13: `python -m p3achygo_tpu_torch.parallel --nproc 1` as a
    subprocess on the card (NCCL, no --device): the dry run's train-step
    and self-play parity checks pass. Returns the {"scale_out": ...}
    measurements."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "p3achygo_tpu_torch.parallel", "--nproc", "1"],
                          capture_output=True, text=True, env=env, cwd=root,
                          timeout=SCALE_OUT_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"dryrun_multichip"')]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"phase 13: the dry run failed (rc {proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    summary = json.loads(lines[0])["dryrun_multichip"]
    if summary["backend"] != "nccl" or summary["n_devices"] != 1:
        raise AssertionError(f"phase 13: not one NCCL rank: {summary}")
    log(f"phase 13: python -m p3achygo_tpu_torch.parallel --nproc 1 on NCCL: train loss "
        f"{summary['loss']:.6f} (one process {summary['loss_one_process']:.6f}), self-play "
        f"stones and moves equal, max |d pi| {summary['selfplay_pi_max_abs_err']:.2e}; "
        f"{wall:.1f} s with start-up ({smi})")
    return {**summary, "wall_s": wall, "card": smi}


def conv_i8_case(k: int, cin: int, cout: int, n: int, in_chain: bool, device, gen):
    """Random int8 activations and weights of one conv site, from `gen` (a
    generator on the card), with scales that put y = acc * s_in * s_w near
    unit size and, in-chain, mish(y) / s_next into the int8 range with a
    few clips: (x8, w8, s_in, s_w, bias, s_next)."""
    r = lambda *shape: torch.randint(-127, 128, shape, generator=gen, device=device,
                                     dtype=torch.int8)
    x8, w8 = r(n, 19, 19, cin), r(cout, k, k, cin)
    acc_std = (k * k * cin) ** 0.5 * 127 * 127 / 3
    u = lambda m: torch.rand(m, generator=gen, device=device)
    s_w = (0.5 + u(cout)) * (50.0 / acc_std)
    s_in = torch.full((), 0.02, device=device)
    if not in_chain:
        return x8, w8, s_in, s_w, None, None
    return x8, w8, s_in, s_w, 0.6 * (u(cout) - 0.5), torch.full((), 3.0 / 127, device=device)


def epilogue_case(k: int, cin: int, cout: int, n: int, in_chain: bool, mode: str, device,
                  gen):
    """(conv_i8's positional arguments, its epilogue keywords) of one site
    in one of EPILOGUE_MODES: "site" is the site's own (int8 in-chain,
    float32 chain-last); RES adds a random int8 stream at a scale that puts
    the sum r = q_prev * s_prev + y into the int8 range with a few clips,
    and "res" the next head's affine and scale; MISH takes a chain-last
    site's inputs."""
    if mode == "site":
        return conv_i8_case(k, cin, cout, n, in_chain, device, gen), {}
    case = conv_i8_case(k, cin, cout, n, False, device, gen)
    if mode.startswith("mish"):
        return case, {"mish_dtype": torch.bfloat16 if mode == "mish_bf16" else torch.float32}
    u = lambda m: torch.rand(m, generator=gen, device=device)
    full = lambda v: torch.full((), v, device=device)
    kw = {"q_prev": torch.randint(-127, 128, (n, 19, 19, cout), generator=gen, device=device,
                                  dtype=torch.int8),
          "s_prev": full(0.02), "s_res": full(3.5 / 127)}
    if mode == "res":
        kw.update(a0=0.5 + u(cout), b0=0.6 * (u(cout) - 0.5), s_head=full(3.0 / 127))
    return case, kw


def check_conv_i8(case, what: str, epilogue=None) -> float:
    """conv_i8 and conv_i8_acc against their plain versions on the card:
    the int32 sums and every output (float32, int8 or bf16) must be equal.
    Returns max |d| of the outputs (0.0)."""
    epilogue = epilogue or {}
    x8, w8 = case[:2]
    acc, acc_ref = conv_ops.conv_i8_acc(x8, w8), conv_ops.conv_i8_acc_reference(x8, w8)
    got = conv_ops.conv_i8(*case, **epilogue)
    want = conv_ops.conv_i8_reference(*case, **epilogue)
    torch.cuda.synchronize()
    if not torch.equal(acc, acc_ref):
        raise AssertionError(f"phase 14 (a) {what}: int32 sums differ in "
                             f"{int((acc != acc_ref).sum())} of {acc.numel()}")
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    err = 0.0
    for i, (g, w) in enumerate(pairs):
        if g is None and w is None:
            continue
        if g is None or w is None or g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"phase 14 (a) {what} output {i}: "
                                 f"{None if g is None else (g.dtype, tuple(g.shape))} vs "
                                 f"{None if w is None else (w.dtype, tuple(w.shape))}")
        if not torch.equal(g, w):
            d = (g.float() - w.float()).abs()
            raise AssertionError(f"phase 14 (a) {what} output {i}: differs in "
                                 f"{int((d > 0).sum())} of {d.numel()}, max |d| "
                                 f"{float(d.max())}")
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def site_mode(mode: str, in_chain: bool) -> str:
    """conv_i8's epilogue name (ops/conv_i8.py MODES) of an EPILOGUE_MODES
    entry."""
    if mode == "site":
        return "i8" if in_chain else "f32"
    return "res" if mode.startswith("res") else "mish"


def conv_i8_work(k: int, cin: int, cout: int, n: int, in_chain: bool, mode: str = "site"):
    """(int8 operations, bytes) of one conv_i8 call: 2 per multiply-add; x8
    and w8 read once, every output written once, the previous stream (RES)
    read once, the scales, bias and affines read once."""
    ops = 2 * n * 361 * cout * k * k * cin
    points = n * 361 * cout
    per_point = {"site": 1 if in_chain else 4, "res": 3, "res_last": 2, "mish_bf16": 2,
                 "mish_f32": 4}[mode]
    vectors = {"site": 2 if in_chain else 1, "res": 3, "res_last": 1, "mish_bf16": 1,
               "mish_f32": 1}[mode]
    nbytes = (n * 361 * cin + cout * k * k * cin + points * per_point
              + 4 * (cout * vectors + 4))
    return ops, nbytes


def im2col_i8(x8: torch.Tensor, k: int) -> torch.Tensor:
    """[N, 19, 19, C] int8 -> the [N*361, k*k*C] rows of a 'SAME' conv, tap
    by tap, channels innermost (w8.reshape(Cout, -1)'s order)."""
    if k == 1:
        return x8.reshape(-1, x8.shape[3])
    xp = F.pad(x8, (0, 0, 1, 1, 1, 1))
    return torch.cat([xp[:, dy:dy + 19, dx:dx + 19] for dy in range(3) for dx in range(3)],
                     dim=3).reshape(-1, 9 * x8.shape[3])


def conv_i8_row(name: str, k: int, cin: int, cout: int, in_chain: bool, n: int, device, gen,
                with_plain: bool, mode: str = "site", yardsticks: bool = True):
    """Times of one conv site at n boards in one epilogue mode: the kernel
    (device ms per call), its work and bound at the int8 tensor rate, and
    (with `yardsticks`) the kernel's raw mode (int32 sums, no epilogue) and
    two yardsticks the port never calls: torch._int_mm on an int8 im2col of
    the same conv (the im2col timed apart) and a bf16 F.conv2d of the same
    shape."""
    case, kw = epilogue_case(k, cin, cout, n, in_chain, mode, device, gen)
    x8, w8 = case[:2]
    ms = device_ms(lambda: conv_ops.conv_i8(*case, **kw), 10)
    ops, nbytes = conv_i8_work(k, cin, cout, n, in_chain, mode)
    b_ms, b_by = bound_ms(ops, nbytes, PEAK_INT8_OPS)
    row = {"site": name, "mode": site_mode(mode, in_chain) + ("_last" if mode == "res_last"
                                                              else ""),
           "n": n, "ms": ms, "gops": ops / 1e9, "tops": ops / ms / 1e9,
           "bytes": nbytes, "bound_ms": b_ms, "bound_by": b_by, "share_of_bound": b_ms / ms}
    text = ""
    if yardsticks:
        a = im2col_i8(x8, k)
        wm = w8.reshape(cout, -1).t()
        xb = x8.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = w8.to(torch.bfloat16).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        row.update(im2col_ms=device_ms(lambda: im2col_i8(x8, k), 10) if k > 1 else 0.0,
                   int_mm_ms=device_ms(lambda: torch._int_mm(a, wm), 10),
                   bf16_conv_ms=device_ms(lambda: F.conv2d(xb, wb, padding=k // 2), 10),
                   acc_ms=device_ms(lambda: conv_ops.conv_i8_acc(x8, w8), 10))
        text = (f"; raw int32 sums (no epilogue) {row['acc_ms']:.4f} ms; yardsticks: _int_mm "
                f"{row['int_mm_ms']:.4f} ms + im2col {row['im2col_ms']:.4f} ms, bf16 conv2d "
                f"{row['bf16_conv_ms']:.4f} ms")
    if with_plain:
        row["plain_ms"] = device_ms(lambda: conv_ops.conv_i8_reference(*case, **kw), 5)
        text += f"; plain {row['plain_ms']:.4f} ms"
    log(f"phase 14 (e): {name} {row['mode']} N={n}: kernel {ms:.4f} ms, {row['gops']:.1f} G "
        f"int8 ops, {row['tops']:.1f} TOP/s; bound {b_ms:.4f} ms ({b_by}), "
        f"{100 * row['share_of_bound']:.1f}% of it" + text)
    return row


def conv_i8_sass():
    """Phase 1's tensor-core count of the conv_i8 library: IMMA (mma.sync
    s8) and GMMA (wgmma) instructions per kernel<K, mode>, which must be
    > 0 in every kernel, and IDP4A, which must be 0 (no dp4a main loop)."""
    for line in cuda_build.build_log(conv_ops.SOURCE).splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"phase 1: {line.strip()}")
    found = sass_counts(conv_ops.SOURCE, ("IMMA", "GMMA"))
    if found is None:
        log(f"phase 1: {conv_ops.SOURCE}: cuobjdump not found, tensor-core instructions "
            f"not counted")
        return None
    tc, size = found
    dp4a = sass_counts(conv_ops.SOURCE, ("IDP4A",))[0]
    tc = {k: v for k, v in tc.items() if k.startswith("conv_i8_kernel")}
    log(f"phase 1: {conv_ops.SOURCE}: IMMA/GMMA (s8 tensor-core) instructions per "
        f"kernel<K,mode>: {tc}; IDP4A: {sum(dp4a.values())}; SASS instructions per "
        f"kernel: {size}")
    if len(tc) != 12 or any(v <= 0 for v in tc.values()):
        raise AssertionError(f"{conv_ops.SOURCE}: a conv_i8 kernel has no s8 tensor-core "
                             f"instruction: {tc}")
    if any(dp4a.values()):
        raise AssertionError(f"{conv_ops.SOURCE}: IDP4A instructions left: {dp4a}")
    return {"tensor_core_instructions": tc, "idp4a": sum(dp4a.values()),
            "sass_instructions": {k: v for k, v in size.items() if k in tc}}


CONV_MODE_NAMES = ("acc", "f32", "i8", "res", "mish_f32", "mish_bf16")


def forward_classes(fn, calls: int = 3):
    """({class: device ms per call}, kernels per call) of `calls` calls of
    `fn`, the conv_i8 kernel split by its mode (the second template
    argument of conv_i8_kernel<K, mode>)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    by_class, kernels = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        kernels += e.count
        name = e.key.lower()
        m = re.search(r"conv_i8_kernel<(\d+), ?(\d+)>", name)
        if m:
            cls = f"conv_i8 {m.group(1)}x{m.group(1)} {CONV_MODE_NAMES[int(m.group(2))]}"
        else:
            cls = next((c for c, keys in CLASSES if any(k in name for k in keys)),
                       "other, copies")
        by_class[cls] = by_class.get(cls, 0.0) + e.self_device_time_total / 1e3 / calls
    return by_class, kernels / calls


def calibration_boards(B: int, plies: int, device, gen):
    """bench.py's calibration positions (bench.py:88-105): B games after
    `plies` moves drawn uniformly from the legal ones, pass included."""
    states = new_state(B, 7.5, device=device)
    for _ in range(plies):
        legal = legal_mask_batch(states)
        score = torch.rand(legal.shape, generator=gen, device=device)
        states, _ = step(states, torch.where(legal, score, -1.0).argmax(dim=1))
    return states


def phase_serve_q(device, smi, model, gen, fold_rates):
    """Phase 14 (see the module docstring) on phase 3's bf16 b12c128btl3.
    Returns (launches of the liberty and int8 conv kernels by the self-play
    slice, the {"serve_q": ...} measurements)."""
    t_phase = time.perf_counter()
    info = {"card": smi, "model": "b12c128btl3 bf16 seeded"}
    # (a) the kernel against its plain version, every epilogue mode.
    max_err, checked = 0.0, 0
    cases = [(f"{name} N={N}", k, cin, cout, chain, N) for N in SERVE_Q_BATCHES
             for name, k, cin, cout, chain in SERVE_Q_SITES]
    cases += [(f"{cfg} {k}x{k} {cin}->{cout} N=64", k, cin, cout, chain, 64)
              for cfg, k, cin, cout, chain in SERVE_Q_WIDTHS]
    for what, k, cin, cout, chain, N in cases:
        for mode in EPILOGUE_MODES:
            case, kw = epilogue_case(k, cin, cout, N, chain, mode, device, gen)
            max_err = max(max_err, check_conv_i8(case, f"{what} {mode}", kw))
            checked += 1
    log(f"phase 14 (a): conv_i8 == plain (int32 sums, float32, int8 and bf16 outputs) on "
        f"{checked} cases: b12c128btl3's sites at N in {list(SERVE_Q_BATCHES)}, the other "
        f"configs' widths at N=64, each in the modes {list(EPILOGUE_MODES)}")
    info["kernel_cases"], info["max_abs_err"] = checked, max_err

    # (b) calibration on bench.py's protocol, card against CPU.
    states = calibration_boards(SERVE_Q_CALIB_B, SERVE_Q_CALIB_PLIES, device, gen)
    planes, scalars = batched_features(states, planes_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scales = calibrate(model, planes, scalars)
    torch.cuda.synchronize()
    info["calibrate_s"] = time.perf_counter() - t0
    nc = SERVE_Q_CALIB_CPU_B
    m32 = copy.deepcopy(model)
    m32.dtype = torch.float32
    info["sites"], info["calib_max_rel"] = len(scales), {}
    for m, dt, bound in ((m32, "float32", SERVE_Q_CALIB_RTOL),
                         (model, "bf16", SERVE_Q_CALIB_BF16_RTOL)):
        card = calibrate(m, planes[:nc], scalars[:nc])
        t0 = time.perf_counter()
        cpu = calibrate(copy.deepcopy(m).cpu(), planes[:nc].cpu(), scalars[:nc].cpu())
        info[f"calibrate_cpu_{dt}_s"] = time.perf_counter() - t0
        if set(card) != set(cpu) or set(card) != set(scales):
            raise AssertionError(f"phase 14 (b): site sets differ: {set(card) ^ set(cpu)}")
        rel, site = max((abs(float(card[k]) - float(cpu[k])) / float(cpu[k]), k) for k in cpu)
        if not rel <= bound:
            raise AssertionError(f"phase 14 (b): {dt} card scales vs CPU: max relative {rel} "
                                 f"at {site} (bound {bound})")
        info["calib_max_rel"][dt] = rel
        log(f"phase 14 (b): {dt}: card vs CPU scales on the first {nc} boards: max relative "
            f"{rel:.2e} at {site} (bound {bound})")
    log(f"phase 14 (b): calibrated {len(scales)} sites on {SERVE_Q_CALIB_B} boards after "
        f"{SERVE_Q_CALIB_PLIES} random legal plies in {info['calibrate_s']:.2f} s")

    # (c) native against emulated, and against ServeNet's bf16 forward.
    net, fold = ServeQNet(model), ServeNet(model)
    p, sc = planes[:SERVE_Q_FORWARD_B], scalars[:SERVE_Q_FORWARD_B]
    nat, emu, ref = net(p, sc, scales, True), net(p, sc, scales, False), fold(p, sc)
    torch.cuda.synchronize()
    served = ("pi_logits", "outcome_probs", "score_probs", "q6_err", "gamma")
    for out, what in ((nat, "native"), (emu, "emulated")):
        check_finite(out, served, f"phase 14 (c) serve_q {what}")
    d_nat = float((nat.pi_logits - emu.pi_logits).abs().max())
    if not d_nat <= SERVE_Q_NATIVE_TOL:
        raise AssertionError(f"phase 14 (c): native vs emulated max |d pi_logits| {d_nat}")
    plain = net(p, sc, scales, fused=False)
    stream_f, stream_p = net.stream(p, sc, scales), net.stream(p, sc, scales, fused=False)
    torch.cuda.synchronize()
    if not torch.equal(stream_f, stream_p) or not torch.equal(nat.pi_logits, plain.pi_logits):
        raise AssertionError(
            f"phase 14 (c): the fused graph differs from the plain graph: last stream in "
            f"{int((stream_f != stream_p).sum())} of {stream_f.numel()}, max |d pi_logits| "
            f"{float((nat.pi_logits - plain.pi_logits).abs().max())}")
    info["fused_equals_plain"] = True
    log(f"phase 14 (c): fused graph (int8 stream between blocks) == plain graph (float32 "
        f"stream, plain ops) on {SERVE_Q_FORWARD_B} positions: last int8 stream and "
        f"pi_logits equal")
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    info["native_vs_emulated"] = d_nat
    info["vs_servenet"] = {
        "pi_corr": float(np.corrcoef(nat.pi_logits.float().cpu().numpy().ravel(),
                                     ref.pi_logits.float().cpu().numpy().ravel())[0, 1]),
        "top1": float((nat.pi_logits.argmax(-1) == ref.pi_logits.argmax(-1)).float().mean()),
        "value_max_abs_d": float((value(nat) - value(ref)).abs().max())}
    log(f"phase 14 (c): native vs emulated on {SERVE_Q_FORWARD_B} positions: max |d "
        f"pi_logits| {d_nat:.3e} (bound {SERVE_Q_NATIVE_TOL}); vs ServeNet bf16 "
        f"(informative): {info['vs_servenet']}")

    # (d) the slice: phase 4's loop through the int8 graph.
    conv_ops.reset_launches()
    launches, plies_s, moves_s, _ = phase_selfplay(
        device, model, gen, make_eval_fn(model, serve_q_scales=scales), PLIES, 14,
        kernels=(point_liberties_batch, conv_ops.conv_i8))
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched by the serve_q self-play slice")
    by_mode = dict(conv_ops.conv_i8.mode_launches)
    if min(by_mode["i8"], by_mode["res"], by_mode["mish"]) <= 0 or by_mode["f32"] != 0:
        raise AssertionError(f"phase 14 (d): conv_i8 launches by mode {by_mode}: want I8, "
                             f"RES and MISH, and no float32 stream")
    launches["conv_i8_by_mode"] = by_mode
    info["selfplay"] = {"plies_s": plies_s, "moves_s": moves_s, "launches": launches,
                        "conv_i8_launches_per_ply": launches["conv_i8"] / PLIES,
                        "serve_fold_plies_s": fold_rates[0], "serve_fold_moves_s": fold_rates[1]}
    log(f"phase 14 (d): {plies_s:.3f} plies/s, {moves_s:.1f} moves/s at B={BENCH_B} through "
        f"serve_q (phase 4, serve_fold: {fold_rates[0]:.3f} plies/s, {fold_rates[1]:.1f} "
        f"moves/s; informative; {smi})")

    # (e) times.
    info["forward"], info["convs"], info["forward_classes"] = {}, [], {}
    for N in SERVE_Q_TIMED:
        st = calibration_boards(N, SERVE_Q_CALIB_PLIES, device, gen)
        p_n, s_n = batched_features(st, planes_dtype=torch.bfloat16)
        for row, fn in (("serve_q", lambda: net(p_n, s_n, scales)),
                        ("serve_q_plain_graph", lambda: net(p_n, s_n, scales, fused=False)),
                        ("servenet", lambda: fold(p_n, s_n))):
            t = info["forward"][f"{row}@{N}"] = {"ms": device_ms(fn, 10),
                                                 "wall_ms": wall_ms(fn, 3, 5)}
            log(f"phase 14 (e): N={N} {row} forward: device {t['ms']:.3f} ms, wall "
                f"{t['wall_ms']:.3f} ms per call")
        classes, per_call = forward_classes(lambda: net(p_n, s_n, scales))
        info["forward_classes"][str(N)] = {"ms": classes, "kernels_per_call": per_call}
        log(f"phase 14 (e): N={N} serve_q forward by kernel class (device ms per call, "
            f"{per_call:.0f} kernels): " + ", ".join(
                f"{c} {v:.3f}" for c, v in sorted(classes.items(), key=lambda kv: -kv[1])))
        for name, k, cin, cout, chain in SERVE_Q_SITES:
            for j, mode in enumerate(SERVE_Q_TIMED_MODES[name]):
                info["convs"].append(conv_i8_row(
                    name, k, cin, cout, chain, N, device, gen,
                    with_plain=N == max(SERVE_Q_TIMED), mode=mode, yardsticks=j == 0))
    info["phase_wall_s"] = time.perf_counter() - t_phase
    log(f"phase 14: wall {info['phase_wall_s']:.1f} s ({smi})")
    return launches, info


def main() -> int:
    t_script = time.perf_counter()
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

    sources = (lib_ops.SOURCE, trunk_ops.SOURCE, trunk_ops.SEGMENT_SOURCE, conv_ops.SOURCE,
               preact_ops.SOURCE)
    t0 = time.perf_counter()
    cuda_build.build_libraries(sources)
    log(f"phase 1: built {', '.join(sources)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc, started together: " + ", ".join(
            f"{s} {cuda_build.build_seconds(s):.2f} s" for s in sources) + ")")
    tensor_core = {}
    for src, routes in ((trunk_ops.SOURCE, trunk_kernel_routes(broadcast=True)),
                        (trunk_ops.SEGMENT_SOURCE, trunk_kernel_routes(broadcast=False))):
        for line in cuda_build.build_log(src).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"phase 1: {line.strip()}")
        found = {op: sass_counts(src, (op,)) for op in ("HGMMA", "HMMA")}
        if found["HGMMA"] is None:
            log(f"phase 1: {src}: cuobjdump not found, tensor-core instructions not counted")
            continue
        size = found["HGMMA"][1]
        counts = {k: {op: found[op][0][k] for op in found} for k in size}
        tensor_core.update(counts)
        log(f"phase 1: {src}: HGMMA (wgmma) and HMMA (mma.sync) instructions per kernel: "
            f"{counts}; SASS instructions per kernel: {size}")
        short = {k: ops for k, ops in routes.items()
                 if any(counts.get(k, {}).get(op, 0) <= 0 for op in ops)}
        if short:
            raise AssertionError(f"{src}: kernels without their tensor-core instructions "
                                 f"{short}: {counts}")
    for src in (conv_ops.SOURCE, preact_ops.SOURCE):
        for line in cuda_build.build_log(src).splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"phase 1: {line.strip()}")
    conv_sass = conv_i8_sass()

    gen = torch.Generator(device=device).manual_seed(0)
    boards, max_err, times = phase_kernel(device, gen)
    cpu_gen = torch.Generator().manual_seed(1)
    model, forward_batch = phase_forward(device, boards, cpu_gen)
    preact_calls, preact_rows = phase_preact(device, boards, model, gen)
    launches, plies_s, moves_s, profiled = phase_selfplay(
        device, model, gen, make_eval_fn(model, serve_fold=True), PLIES, 4,
        profiled_ply=True)
    if launches["point_liberties_batch"] <= 0:
        raise AssertionError("the liberty kernel was not launched by phase 4")
    check_preact_ply(launches, profiled, "phase 4")
    log(f"phase 4: {plies_s:.3f} plies/s, {moves_s:.1f} moves/s at B={BENCH_B} "
        f"(informative; {smi})")
    plain_launches, _, _, plain_profiled = phase_selfplay(
        device, model, gen, make_eval_fn(model), PLIES, "4b", profiled_ply=True)
    check_preact_ply(plain_launches, plain_profiled, "phase 4b")
    preact_ply = {route: {"launches_per_ply": n["preact"] / PLIES,
                          "profiled_ply_calls": p["wrapper_calls"]["preact"],
                          "profiled_ply_kernel_records": {
                              k: v for k, v in p["kernel_records"].items()
                              if k.startswith(KERNEL_PREFIX["preact"])}}
                  for route, n, p in (("fold", launches, profiled),
                                      ("plain", plain_launches, plain_profiled))}
    log(f"phases 4, 4b: preact launches at B={BENCH_B}: {preact_ply}")

    trunk_err, trunk_times, kernel_rows, other_rows = phase_trunk(device, boards, model,
                                                                  forward_batch,
                                                      cpu_gen)
    fused_launches, f_plies_s, f_moves_s, fused_profiled = phase_selfplay(
        device, model, gen, make_eval_fn(model, use_fused_trunk=True), FUSED_PLIES, 6,
        profiled_ply=True)
    check_fused_launches(fused_launches, "the fused self-play path")
    log(f"phase 6: {f_plies_s:.3f} plies/s, {f_moves_s:.1f} moves/s at B={BENCH_B} "
        f"with the fused trunk (informative; {smi})")

    learn_launches, learn = phase_learn(device, smi)
    print(json.dumps({"learn": learn}), flush=True)

    with tempfile.TemporaryDirectory() as gen_root:
        gen_launches, gen_info = phase_gen(device, smi, gen_root)
        gen_preact = preact_ops.preact.launches
        if gen_preact <= 0:
            raise AssertionError("the generation loop's plain eval launched no preact kernel")
        print(json.dumps({"gen": gen_info}), flush=True)

        search_launches, search_info = phase_search(device, smi)
        print(json.dumps({"search": search_info}), flush=True)

        gtp_launches, gtp_info = phase_gtp(device, smi, gen_root, model, boards, gen)
        print(json.dumps({"gtp": gtp_info}), flush=True)

        bus_launches, bus_parts, bus_info = phase_bus(device, smi, gen_root)
        print(json.dumps({"bus": bus_info}), flush=True)

    transformer_launches, transformer_info = phase_transformer(device, smi, boards, cpu_gen)
    print(json.dumps({"transformer": transformer_info}), flush=True)

    print(json.dumps({"scale_out": phase_scale_out(smi)}), flush=True)

    q_launches, q_info = phase_serve_q(device, smi, model, gen, (plies_s, moves_s))
    print(json.dumps({"serve_q": q_info}), flush=True)

    t0 = time.perf_counter()
    wide_err, wide_info = phase_wide_trunk(device, boards, gen)
    log(f"phase 15: {time.perf_counter() - t0:.1f} s ({smi})")
    print(json.dumps({"wide_trunk": wide_info}), flush=True)

    if "jax" in sys.modules or "p3achygo_tpu" in sys.modules:
        raise AssertionError("the port loaded JAX or the JAX package")
    log(f"phases 0-15: {time.perf_counter() - t_script:.1f} s ({smi})")
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
        "launches_phase11": bus_launches,
        "launches_phase11_parts": bus_parts,
        "launches_phase12": transformer_launches,
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
            "max_abs_err": max(trunk_err[name], wide_err[name]),
            "ms": trunk_times[name][0],
            "plain_ms": trunk_times[name + "_plain"][0],
            "wall_ms": trunk_times[name][1],
            "plain_wall_ms": trunk_times[name + "_plain"][1],
            "bound_ms": trunk_times[name + "_bound"][0],
            "bound_by": trunk_times[name + "_bound"][1],
            "library_ms": None,
            "tensor_core_instructions": {k: v for k, v in tensor_core.items()
                                         if k.startswith(name)},
            "timed_batch": n_big,
            "timing": "device time per call from profiler kernel records, "
                      "b12c128btl3, first call of the trunk",
            "library_products_ms": kernel_rows[f"{name}@{n_big}"]["library_products_ms"],
            "by_batch": {k: v for k, v in kernel_rows.items() if k.startswith(name + "@")},
            "by_width": {
                **{cfg: {"launches_phase15": wide_info[cfg]["launches"][name],
                         "launches_per_ply": wide_info[cfg]["launches_per_ply"][name],
                         **{k: v for k, v in wide_info[cfg]["rows"].items()
                            if k.startswith(name + "@")}}
                   for cfg in WIDE_CONFIGS + (TINY_CONFIG,)},
                **{cfg: {k: v for k, v in rows.items() if k.startswith(name + "@")}
                   for cfg, rows in other_rows.items()}},
        })
    kernels[1]["also_replaces"] = "p3achygo_tpu/nn/trunk_kernel.py:146 (btl branch)"
    # Kernel launches per wrapper call and per ply, from the CUDA kernel
    # records of one profiled ply of each fused self-play (phases 6, 15).
    profiled = {TRUNK_CONFIGS[0]: fused_profiled,
                **{cfg: wide_info[cfg]["profiled_ply"] for cfg in WIDE_CONFIGS + (TINY_CONFIG,)}}
    for entry in kernels[:3]:
        name = entry["name"]
        entry["kernels_profiled_ply"] = {cfg: {
            "kernel_records": {k: n for k, n in p["kernel_records"].items()
                               if k.startswith(KERNEL_PREFIX[name])},
            "wrapper_calls": p["wrapper_calls"][name],
            "kernels_per_call": p["kernels_per_call"].get(name)} for cfg, p in profiled.items()}
    rows = {(r["site"], r["n"], r["mode"]): r for r in q_info["convs"]}
    main_row = rows[(SERVE_Q_SITES[1][0], max(SERVE_Q_TIMED), "i8")]
    kernels.append({
        "name": "conv_i8",
        "route": "cuda",
        "source": f"p3achygo_tpu_torch/csrc/{conv_ops.SOURCE}",
        "replaces": "p3achygo_tpu/nn/serve_q.py:68 (not a TPU kernel: XLA's int32 "
                    "convolution and the output fusion of _chain_q, serve_q.py:100-133)",
        "launches": q_launches["conv_i8"],
        "launches_from": "phase 14 (d) (serve_q self-play)",
        "launches_per_ply": q_launches["conv_i8"] / PLIES,
        "max_abs_err": q_info["max_abs_err"],
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
        "timed_shape": f"{main_row['site']}, N={main_row['n']}",
        "timing": "device time per call from profiler kernel records",
        "library_yardsticks": "int_mm_ms (+ im2col_ms) and bf16_conv_ms per site; no "
                              "single PyTorch call computes an int8 conv with its epilogue",
        "tensor_cores": "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (IMMA) with "
                        "ldmatrix fragments; implicit GEMM over a haloed board plane",
        "sass": conv_sass,
        "launches_by_mode": q_launches["conv_i8_by_mode"],
        "by_mode": {f"{r['site']} {r['mode']}": {
            key: r.get(key) for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                        "share_of_bound")}
            for r in q_info["convs"] if r["n"] == max(SERVE_Q_TIMED)},
        "by_site": q_info["convs"],
    })
    preact_main = preact_rows[f"C=128 N={max(PREACT_TIMED_N)} nhwc"]
    kernels.append({
        "name": "preact",
        "route": "cuda",
        "source": f"p3achygo_tpu_torch/csrc/{preact_ops.SOURCE}",
        "replaces": "not a TPU kernel: the eager BatchNorm affine + mish of "
                    "p3achygo_tpu_torch/models/blocks.py ConvBlock and nn/serve.py "
                    "(XLA fuses p3achygo_tpu/models/blocks.py:20's mish into its neighbours)",
        "launches": launches["preact"],
        "launches_from": "phase 4 (serve_fold self-play)",
        "launches_phase4b": plain_launches["preact"],
        "launches_phase8": gen_preact,
        "by_route_at_bench_b": preact_ply,
        "calls_checked_phase3b": preact_calls,
        "max_abs_err": 0.0,
        "ms": preact_main["ms"],
        "plain_ms": preact_main["plain_ms"],
        "bound_ms": preact_main["bound_ms"],
        "bound_by": preact_main["bound_by"],
        "library_ms": None,
        "timed_shape": f"bf16 channels_last C=128, N={max(PREACT_TIMED_N)}, a and b float32",
        "timing": "device time per call from profiler kernel records; plain_ms is the "
                  "eager chain it replaces (preact_reference)",
        "by_shape": preact_rows,
    })
    kernels[1]["trunk_b12c128btl3"] = trunk_by_n
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
