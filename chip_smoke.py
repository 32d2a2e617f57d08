"""Drive the PyTorch port's self-play path once on an NVIDIA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero; there is no CPU
fallback):
  0 device   needs torch.cuda; prints the card's name and power limit and
             the TF32 switches (both off).
  1 build    compiles the liberty kernel (csrc/liberties.cu) with nvcc.
  2 kernel   boards from random legal play with the port's `step`; the
             kernel must equal its plain PyTorch version exactly at
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

Before the last line it prints the kernels JSON line and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from p3achygo_tpu_torch.constants import NUM_MOVES, PASS_MOVE
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import (
    legal_mask_batch,
    legal_mask_from_libs,
    new_state,
    step,
    superko_violation,
)
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.blocks import BatchNorm
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model, init_params
from p3achygo_tpu_torch.nn.serve import ServeNet
from p3achygo_tpu_torch.ops import cuda_build
from p3achygo_tpu_torch.ops.liberties import (
    SOURCE,
    point_liberties_batch,
    point_liberties_reference,
)
from p3achygo_tpu_torch.selfplay.loop import (
    SelfplayConfig,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step_tiered,
)

BENCH_B = 256
PLIES = 10
RESET_EVERY = 5
CHECK_BATCHES = (1, 7, 64, 192, 1024, 2048, 2880, 8192)
TIMED_BATCHES = (1024, 8192)


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


def device_ms(fn, calls: int = 50) -> float:
    """Device time per call: the summed duration of the CUDA kernels that
    `calls` calls ran, from the profiler's kernel records."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return us / calls / 1000.0


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


def phase_forward(device, boards, gen):
    cfg = get_config("b12c128btl3")
    model = build_model(cfg, torch.float32, device)
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
    for f in ModelOutputs._fields:
        t = getattr(plain, f)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"plain bf16 output {f} not finite")
    for f in ("pi_logits", "outcome_probs", "score_probs", "q6_err", "gamma"):
        if not bool(torch.isfinite(getattr(served, f)).all()):
            raise AssertionError(f"served bf16 output {f} not finite")
    top1 = float((served.pi_logits.argmax(-1) == plain.pi_logits.argmax(-1)).float().mean())
    value = lambda o: o.outcome_probs[:, 1] - o.outcome_probs[:, 0]
    dv = float((value(served) - value(plain)).abs().max())
    log(f"phase 3: bf16 serve vs plain on {planes.shape[0]} positions: top-1 "
        f"agreement {top1:.4f}, max |d value| {dv:.3e}")
    return model


def phase_selfplay(device, model, gen):
    B = BENCH_B
    cfg = SelfplayConfig(batch_size=B)
    params_sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24,
                              visit_group=4)
    params_fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24,
                               visit_group=4)
    reuse_capacity = 64
    eval_fn = make_eval_fn(model, serve_fold=True)
    states = new_state(B, cfg.komi, device=device)
    buf = make_game_buffer(B, cfg.max_game_len, device)
    aux = make_aux(B, gen, device=device)
    aux = aux._replace(raw_until=aux.raw_until * 0)  # full search, as bench
    tree = make_tree(B, reuse_capacity, device)
    b = torch.arange(B, device=device)

    point_liberties_batch.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    moves_played = 0
    resets = 0
    checks = []
    for ply in range(PLIES):
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
    launches = point_liberties_batch.launches

    for ply, (prev, active, move, pi, after) in enumerate(checks):
        libs = point_liberties_reference(prev.stones, prev.chain_id)
        legal = legal_mask_from_libs(prev, libs)
        ok_legal = legal[b, move]
        ok_superko = ~superko_violation(prev, move)
        on_board = move < PASS_MOVE
        placed = after.stones[b, move.clamp(max=PASS_MOVE - 1)] == prev.to_move
        bad = active & ~(ok_legal & ok_superko & (~on_board | placed))
        if bool(bad.any()):
            raise AssertionError(f"ply {ply}: illegal move on boards "
                                 f"{b[bad].tolist()[:8]}")
        pis = pi[active]
        if not bool(torch.isfinite(pis).all()):
            raise AssertionError(f"ply {ply}: pi_improved not finite")
        err = float((pis.sum(-1) - 1.0).abs().max())
        if err > 1e-4 or pis.shape[1] != NUM_MOVES:
            raise AssertionError(f"ply {ply}: pi_improved sums off by {err}")
    if launches <= 0:
        raise AssertionError("the liberty kernel was not launched by the main path")
    log(f"phase 4: {PLIES} plies at B={B}, {resets} resets, {moves_played} moves "
        f"in {dt:.2f} s; every move legal and superko-clean, pi_improved sums to 1; "
        f"liberty kernel launches {launches}")
    return launches, PLIES / dt, moves_played / dt


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

    t0 = time.perf_counter()
    cuda_build.load_library(SOURCE)
    log(f"phase 1: built {SOURCE} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_seconds(SOURCE):.2f} s)")

    gen = torch.Generator(device=device).manual_seed(0)
    boards, max_err, times = phase_kernel(device, gen)
    cpu_gen = torch.Generator().manual_seed(1)
    model = phase_forward(device, boards, cpu_gen)
    launches, plies_s, moves_s = phase_selfplay(device, model, gen)
    log(f"phase 4: {plies_s:.3f} plies/s, {moves_s:.1f} moves/s at B={BENCH_B} "
        f"(informative; {smi})")

    if "jax" in sys.modules or "p3achygo_tpu" in sys.modules:
        raise AssertionError("the port loaded JAX or the JAX package")
    t_big = max(TIMED_BATCHES)
    print(json.dumps({"kernels": [{
        "name": "point_liberties_batch",
        "route": "cuda",
        "source": f"p3achygo_tpu_torch/csrc/{SOURCE}",
        "replaces": "p3achygo_tpu/ops/liberties.py:46",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times[t_big][0],
        "plain_ms": times[t_big][1],
        "timed_batch": t_big,
        "timing": "device time per call from profiler kernel records",
        "by_batch": {str(k): {"ms": v[0], "plain_ms": v[1], "wall_ms": v[2],
                              "plain_wall_ms": v[3]} for k, v in times.items()},
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
