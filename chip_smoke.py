"""Drive the PyTorch port's self-play paths once on an NVIDIA card.

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

Phase 7 prints a {"learn": ...} JSON line of its measurements. Before the
last line it prints the kernels JSON line (every kernel with
its bound: the larger of its operations over 989 TFLOP/s bf16 and its bytes,
each input read once and each output written once, over 3.35 TB/s) and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import copy
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from p3achygo_tpu_torch.constants import NUM_MOVES, PASS_MOVE
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.features import batched_features
from p3achygo_tpu_torch.game.board import (
    legal_mask_batch,
    legal_mask_from_libs,
    map_state,
    min_labels,
    new_state,
    step,
    superko_violation,
)
from p3achygo_tpu_torch.game.scoring import pass_alive_for_color
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
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
from p3achygo_tpu_torch.rl import slice as rl_slice
from p3achygo_tpu_torch.rl.slice import RLSlice, SliceConfig
from p3achygo_tpu_torch.selfplay.loop import (
    SelfplayConfig,
    final_scores,
    finished_mask,
    make_aux,
    make_game_buffer,
    reset_finished,
    selfplay_step_tiered,
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


def seeded_model(name: str, device, gen: torch.Generator):
    """float32 model of config `name` with random weights from `gen` (a CPU
    generator) and BN statistics perturbed so no fold is an identity."""
    model = build_model(get_config(name), torch.float32, device)
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


def check_ply(prev, active, move, pi, after, what: str) -> None:
    """Every active board's move was legal and superko-clean (and placed its
    stone), its pi_improved finite and summing to 1."""
    b = torch.arange(prev.stones.shape[0], device=prev.stones.device)
    libs = point_liberties_reference(prev.stones, prev.chain_id)
    ok_legal = legal_mask_from_libs(prev, libs)[b, move]
    ok_superko = ~superko_violation(prev, move)
    on_board = move < PASS_MOVE
    placed = after.stones[b, move.clamp(max=PASS_MOVE - 1)] == prev.to_move
    bad = active & ~(ok_legal & ok_superko & (~on_board | placed))
    if bool(bad.any()):
        raise AssertionError(f"{what}: illegal move on boards {b[bad].tolist()[:8]}")
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
