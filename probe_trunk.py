"""Measure the fused trunk on an NVIDIA card, beyond what chip_smoke.py prints.

    python3 probe_trunk.py segment [--baseline PATH | --packed-baseline PATH]
    python3 probe_trunk.py broadcast [--baseline PATH]
    python3 probe_trunk.py wide --earlier-tree DIR
    python3 probe_trunk.py tiny --earlier-tree DIR
    python3 probe_trunk.py ply
    python3 probe_trunk.py preact

segment: the segment kernel at the b12c128btl3 widths (C=128, Cb=64, a run
of 3 blocks of 3 inner layers), the b8c64 widths (C=64, Cb=32, 3 blocks
of 2), the cluster widths of b12c256btl3 and b14c384btl3 ((256, 128)
and (384, 192), 3 blocks of 3) and tiny's (16, 8) (3 blocks of 1, the
small kernel; no baseline takes it), seeded Gaussian inputs and weights, N in
{512, 2880}, with the persistent grid's blocks: max |d| /
max |ref| against the plain version, and device time per call (CUDA events,
median of 5 runs of 10 calls). With --baseline, the segment kernel of that
source file, which must have the C interface of the earlier wmma segment
kernel (csrc/trunk.cu before the segment kernel moved to
csrc/trunk_segment.cu: p3_trunk_segment(x, out, aff, wr, w9, we, N,
n_blocks, inner, C, Cb, stream)), is timed in turns with this one:
baseline, kernel, kernel, baseline. With --packed-baseline, a segment
source with this kernel's C interface (the packed weight stream, e.g. an
earlier commit's csrc/trunk_segment.cu with its headers beside it) is timed
in turns with this one the same way. Then a build of csrc/trunk_segment.cu
with -DP3_SEGMENT_PROFILE gives the clock cycles per board-block of each
phase (consumer warpgroup 0, warp 0; of rank 0 in a cluster) at every
width, and for the cluster kernel the cycles spent waiting for weight
items.

broadcast: the broadcast kernel at the b12c128btl3 (C=128), b8c64 (C=64),
wide (C=256, 384: three kernels) and tiny (C=16: the small kernel, its
phases per group of SMALL_GROUP boards) widths, seeded Gaussian inputs and
weights, N in {512, 2880}, with the persistent grid's blocks: max
|d| / max |ref| against the plain version and device time per call (CUDA
events, median of 5 runs of 10 calls; at the wide widths also each of the
three kernels' device time from profiler kernel records). With --baseline, the broadcast
kernel of that source file, which must have the C interface of the earlier
wmma broadcast kernel (csrc/trunk.cu before the redesign:
p3_trunk_broadcast(x, out, f_aff, wf, wdt [368, 368], bd, l_aff, wl, N, C,
stream)), is timed in turns with this one: baseline, kernel, kernel,
baseline. Then a build of csrc/trunk_broadcast.cu with
-DP3_BROADCAST_PROFILE gives the clock cycles per board of each phase
(consumer warpgroup 0, warp 0) at C <= 128, among them the wait for the
previous board's mix to free the single-buffered m, and at C = 256, 384
the clock cycles per unit of each stage of the three kernels (thread 0 of
each block: conv_first per 64-position tile, the mix per board and 128
channels, conv_last per tile).

wide: the wide kernels of this tree against those of an earlier tree of the
repo (DIR, e.g. an earlier commit unpacked by `git archive`: its
p3achygo_tpu_torch/csrc kernels built with nvcc, its weights packed by its
own ops/trunk.py) and against their library products
(chip_smoke.segment_library_products / broadcast_library_products), on
the same seeded inputs and weights: the segment at (256, 128) with 4 blocks
and (384, 192) with 5 (phase 15's b12c256btl3 and b14c384btl3 segments),
the broadcast block at C = 256 and 384, N in {512, 2880}. Device time per
call as chip_smoke.py phase 15 takes it (chip_smoke.device_timing over 10
calls), in WIDE_ROUNDS rounds of the three in turns (earlier, this,
library; then library, this, earlier; ...), every reading printed with the
ratios this / earlier and this / library of each round. Both trees' outputs
are held against the plain version at N = 512 first.

tiny: tiny's kernels (ops.trunk SEGMENT_SMALL, BROADCAST_SMALL): the
segment at (16, 8) with 3 blocks of one 3x3 layer (tiny's first segment)
and the broadcast block at C = 16, against the route an earlier tree of the
repo (DIR) took at that width, through that tree's own ops/trunk.py
wrappers and kernels (at cb45cc3: the (64, 32) / 64 kernels zero-padded,
the wrapper's pad and slice included), and against their library products,
on the same seeded inputs and weights, N in {512, 2880}: both trees held
against the plain version at every N first, then WIDE_ROUNDS rounds in
turns as for wide, with the bound and this tree's share of it.

ply: chip_smoke.py's self-play step (the bench mix, b12c128btl3 bf16 with
seeded weights, B=256 fresh games) with the fused trunk and with
serve_fold, in turns (fused, serve_fold, fused, serve_fold): 3 warm plies,
4 plies timed one by one (host clock around synchronised plies), 2 plies
under the profiler: device busy ms/ply (summed kernel time), wall ms/ply,
idle share, kernels/ply and device time by class of kernel.

preact: the pre-activation kernel (ops/preact.py, csrc/preact.cu) against
the eager ops it replaces (`preact_reference`), bf16 x at C in {64, 128,
384} and N in {512, 2880}, channels_last as the trunk's activations lie,
with float32 a and b as the plain model's BatchNorm passes them (and one
contiguous NCHW line, the call after a broadcast mix): device ms per call
in WIDE_ROUNDS rounds in turns (chip_smoke.device_timing over 10 calls),
the byte bound (x read and y written once at 3.35 TB/s), the kernel's
share of it and the eager chain's time over the kernel's. Then the
b12c128btl3 bf16 forward at N = 2880 (the plain model and ServeNet),
with the kernel and with the eager ops (`ops.preact.engages` held false),
in turns: device ms per forward, kernels per forward and device ms by
class of kernel.

Every line names the card and its power limit. Needs a card; there is no
CPU mode. Builds go to a temporary directory.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import importlib.util
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from p3achygo_tpu_torch.game.board import new_state
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.ops import cuda_build
from p3achygo_tpu_torch.ops import trunk as ops
from p3achygo_tpu_torch.selfplay.loop import (
    SelfplayConfig,
    make_aux,
    make_game_buffer,
    selfplay_step_tiered,
)

WIDTHS = ((128, 64, 3), (64, 32, 2), (256, 128, 3), (384, 192, 3),
          (16, 8, 1))  # (C, Cb, inner), 3 blocks
BROADCAST_WIDTHS = (128, 64, 256, 384, 16)
N_TIMED = (512, 2880)
PHASES = ("block-0 reduce", "3x3 products", "3x3 epilogues", "expand (+ next reduce)")
SMALL_PHASES = ("x wait + block-0 reduce", "layer barriers", "3x3 layers before the last",
                "last 3x3 + expand + next reduce")
CLUSTER_PHASES = ("reduce + store + push", "3x3 products", "3x3 exchange + store + push",
                  "expand + barrier")
BROADCAST_PHASES = ("conv_first", "wait for m free", "barrier after conv_first",
                    "mix products", "mix epilogue + conv_last + store")
WIDE_SEGMENTS = ((256, 128, 3, 4), (384, 192, 3, 5))  # (C, Cb, inner, blocks), phase 15's
WIDE_ROUNDS = 3
WIDE_BROADCAST_STAGES = (("conv_first", ("x load + act(x)", "products", "mish + m store"), 0, 3),
                         ("mix", ("products", "act(z) + store"), 4, 6),
                         ("conv_last", ("act(z) load", "products", "residual + store"), 7, 10))


def log(msg: str) -> None:
    print(msg, flush=True)


def build(source: str, out_dir: str, *defines: str) -> ctypes.CDLL:
    so = os.path.join(out_dir, os.path.basename(source) + "".join(defines) + ".so")
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, *defines, "-o", so,
                    source], check=True, capture_output=True, text=True)
    return ctypes.CDLL(so)


def kernel_fn(lib: ctypes.CDLL, name: str, n_pointers: int, n_ints: int):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def seeded_segment(C: int, cb: int, inner: int, gen: torch.Generator, blocks: int = 3):
    dev = torch.device("cuda")
    r = lambda *s: torch.rand(*s, generator=gen, device=dev)
    n = lambda *s: torch.randn(*s, generator=gen, device=dev)
    aff = torch.stack([0.7 + 0.6 * r(blocks, 2 + inner, C),
                       0.2 * (r(blocks, 2 + inner, C) - 0.5)], dim=2)
    w = ops.SegmentWeights(aff.contiguous(), (n(blocks, C, cb) / C ** 0.5).bfloat16(),
                           (n(blocks, inner, 9 * cb, cb) / (9 * cb) ** 0.5).bfloat16(),
                           (n(blocks, cb, C) / cb ** 0.5).bfloat16())
    return ops.with_packed_segment(w)


def seeded_broadcast(C: int, gen: torch.Generator):
    dev = torch.device("cuda")
    r = lambda *s: torch.rand(*s, generator=gen, device=dev)
    n = lambda *s: torch.randn(*s, generator=gen, device=dev)
    aff = lambda: torch.stack([0.7 + 0.6 * r(C), 0.2 * (r(C) - 0.5)]).contiguous()
    wdt = torch.zeros((ops.MIX_PAD, ops.MIX_PAD), device=dev)
    wdt[:361, :361] = n(361, 361) / 19.0
    w = ops.BroadcastWeights(aff(), (n(C, C) / C ** 0.5).bfloat16(), wdt.bfloat16(),
                             0.1 * n(361), aff(), (n(C, C) / C ** 0.5).bfloat16())
    return ops.with_packed_broadcast(w)


def event_ms(fn, reps: int = 5, inner: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def call(fn, x, out, args) -> None:
    rc = fn(x.data_ptr(), out.data_ptr(), *args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {rc}")


def phase_cycles(lib: ctypes.CDLL, name: str, fn, x, out, args, n: int):
    """Per-unit clock cycles of each of a profile build's n counters but the
    one that counts the units (the segment kernel's counter 4 of 6, the
    broadcast kernel's last), over 10 calls after a warm-up."""
    read = getattr(lib, name)
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    call(fn, x, out, args)
    torch.cuda.synchronize()
    read(None, 1)
    for _ in range(10):
        call(fn, x, out, args)
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * n)()
    if read(cycles, 0) != 0:
        raise RuntimeError("reading the phase clocks failed")
    units = 4 if n == 6 and name.startswith("p3_trunk_segment") else n - 1
    return [c / cycles[units] for i, c in enumerate(cycles) if i != units]


def wide_cycles(lib: ctypes.CDLL, fn, x, out, args):
    """The 11 clock counters of the wide broadcast kernels (profile build)
    over 10 calls after a warm-up."""
    read = lib.p3_trunk_broadcast_wide_cycles
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    call(fn, x, out, args)
    torch.cuda.synchronize()
    read(None, 1)
    for _ in range(10):
        call(fn, x, out, args)
    torch.cuda.synchronize()
    cycles = (ctypes.c_ulonglong * 11)()
    if read(cycles, 0) != 0:
        raise RuntimeError("reading the wide kernels' clocks failed")
    return list(cycles)


def kernel_ms(fn, calls: int = 10) -> dict:
    """{kernel name: device ms per call} of `fn` from profiler kernel records."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(trunk_\w+?_kernel)<", e.key)
            name = m.group(1) if m else e.key[:40]
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / calls
    return out


def grid_blocks(lib: ctypes.CDLL, name: str, *widths: int) -> int:
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_int] * len(widths)
    fn.restype = ctypes.c_int
    return fn(*widths)


def phase_line(names, per) -> str:
    return ", ".join(f"{name} {p:.0f} ({100 * p / sum(per):.0f}%)"
                     for name, p in zip(names, per)) + f"; total {sum(per):.0f}"


def probe_segment(baseline: str | None, smi: str, packed_baseline: str | None = None) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        base = kernel_fn(build(baseline, tmp), "p3_trunk_segment", 6, 5) if baseline else None
        packed_base = (kernel_fn(build(packed_baseline, tmp), "p3_trunk_segment", 4, 5)
                       if packed_baseline else None)
        prof_lib = build(os.path.join(cuda_build.CSRC_DIR, ops.SEGMENT_SOURCE), tmp,
                         "-DP3_SEGMENT_PROFILE")
        prof_fn = kernel_fn(prof_lib, "p3_trunk_segment", 4, 5)
        for C, cb, inner in WIDTHS:
            w = seeded_segment(C, cb, inner, gen)
            for N in N_TIMED:
                x = torch.randn(N, 361, C, generator=gen, device="cuda").bfloat16()
                out = torch.empty_like(x)
                kernel = lambda: ops.trunk_segment(x, w)
                _, rel = chip_smoke.rel_err(kernel(), ops.trunk_segment_reference(x, w))
                gflop = chip_smoke.segment_work(w, N)[0] / 1e9
                row = f"C={C} Cb={cb} 3x{inner} N={N} ({gflop:.1f} GFLOP): max rel {rel:.3e}"
                small = (C, cb) == ops.SEGMENT_SMALL  # no earlier source takes it
                if packed_base is not None and not small:
                    base_args = (w.aff.data_ptr(), w.packed.data_ptr(), N, 3, inner, C, cb)
                    old = lambda: call(packed_base, x, out, base_args)
                    t = [event_ms(old), event_ms(kernel), event_ms(kernel), event_ms(old)]
                    row += (f"; packed baseline {t[0]:.4f}/{t[3]:.4f} ms, kernel {t[1]:.4f}/"
                            f"{t[2]:.4f} ms ({gflop / min(t[1], t[2]):.1f} TFLOP/s)")
                elif base is not None and not small:
                    old = lambda: call(base, x, out, (w.aff.data_ptr(), w.wr.data_ptr(),
                                                      w.w9.data_ptr(), w.we.data_ptr(),
                                                      N, 3, inner, C, cb))
                    t = [event_ms(old), event_ms(kernel), event_ms(kernel), event_ms(old)]
                    row += (f"; baseline {t[0]:.4f}/{t[3]:.4f} ms, kernel {t[1]:.4f}/{t[2]:.4f}"
                            f" ms ({gflop / min(t[1], t[2]):.1f} TFLOP/s)")
                else:
                    t = event_ms(kernel)
                    row += f"; kernel {t:.4f} ms ({gflop / t:.1f} TFLOP/s)"
                row += f"; grid {grid_blocks(prof_lib, 'p3_trunk_segment_grid', C, cb)} blocks"
                log(f"segment: {row} [{smi}]")
                args = (w.aff.data_ptr(), w.packed.data_ptr(), N, 3, inner, C, cb)
                per = phase_cycles(prof_lib, "p3_trunk_segment_phase_cycles", prof_fn, x, out,
                                   args, 6)
                cluster = (C, cb) in ops.SEGMENT_CLUSTER
                names = SMALL_PHASES if small else CLUSTER_PHASES if cluster else PHASES
                line = phase_line(names, per[:4])
                if cluster:
                    line += f"; of them waiting for weight items {per[4]:.0f}"
                if small:
                    line += f"; output stores {per[4]:.0f}"
                log(f"segment phases C={C} N={N}, clock cycles per board-block: {line} [{smi}]")


def probe_broadcast(baseline: str | None, smi: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        base = (kernel_fn(build(baseline, tmp), "p3_trunk_broadcast", 8, 2)
                if baseline else None)
        prof_lib = build(os.path.join(cuda_build.CSRC_DIR, ops.SOURCE), tmp,
                         "-DP3_BROADCAST_PROFILE")
        prof_fn = kernel_fn(prof_lib, "p3_trunk_broadcast", 7, 2)
        for C in BROADCAST_WIDTHS:
            w = seeded_broadcast(C, gen)
            wdt368 = w.wdt[:368, :368].contiguous()  # the wmma kernel's padding
            for N in N_TIMED:
                x = torch.randn(N, 361, C, generator=gen, device="cuda").bfloat16()
                out = torch.empty_like(x)
                kernel = lambda: ops.trunk_broadcast(x, w)
                _, rel = chip_smoke.rel_err(kernel(), ops.trunk_broadcast_reference(x, w))
                gflop = chip_smoke.broadcast_work(w, N)[0] / 1e9
                row = f"C={C} N={N} ({gflop:.1f} GFLOP): max rel {rel:.3e}"
                if base is not None and C != ops.BROADCAST_SMALL:
                    old = lambda: call(base, x, out, (w.f_aff.data_ptr(), w.wf.data_ptr(),
                                                      wdt368.data_ptr(), w.bd.data_ptr(),
                                                      w.l_aff.data_ptr(), w.wl.data_ptr(),
                                                      N, C))
                    t = [event_ms(old), event_ms(kernel), event_ms(kernel), event_ms(old)]
                    row += (f"; baseline {t[0]:.4f}/{t[3]:.4f} ms, kernel {t[1]:.4f}/{t[2]:.4f}"
                            f" ms ({gflop / min(t[1], t[2]):.1f} TFLOP/s)")
                else:
                    t = event_ms(kernel)
                    row += f"; kernel {t:.4f} ms ({gflop / t:.1f} TFLOP/s)"
                row += f"; grid {grid_blocks(prof_lib, 'p3_trunk_broadcast_grid', C)} blocks"
                wide = C in ops.BROADCAST_WIDE
                if wide:
                    row += "; " + ", ".join(f"{name} {ms:.4f} ms"
                                            for name, ms in kernel_ms(kernel).items())
                log(f"broadcast: {row} [{smi}]")
                m = (torch.empty(N * ops.MIX_PAD * C, dtype=torch.bfloat16, device="cuda")
                     if wide else None)
                args = (w.f_aff.data_ptr(), w.packed.data_ptr(), w.bd.data_ptr(),
                        w.l_aff.data_ptr(), None if m is None else m.data_ptr(), N, C)
                if not wide:
                    per = phase_cycles(prof_lib, "p3_trunk_broadcast_phase_cycles", prof_fn, x,
                                       out, args, 6)
                    unit = (f"group of {ops.SMALL_GROUP} boards" if C == ops.BROADCAST_SMALL
                            else "board")
                    log(f"broadcast phases C={C} N={N}, clock cycles per {unit}: "
                        f"{phase_line(BROADCAST_PHASES, per)} [{smi}]")
                    continue
                cyc = wide_cycles(prof_lib, prof_fn, x, out, args)
                for stage, names, first, units in WIDE_BROADCAST_STAGES:
                    per = [c / cyc[units] for c in cyc[first:units]]
                    log(f"broadcast stages C={C} N={N}, {stage}, clock cycles per unit: "
                        f"{phase_line(names, per)} [{smi}]")


def earlier_kernels(tree: str, tmp: str):
    """(the earlier tree's ops/trunk.py as a module, its segment entry point,
    its broadcast entry point), its two kernel sources built at once. The
    earlier broadcast has no m scratch argument (6 pointers)."""
    spec = importlib.util.spec_from_file_location(
        "earlier_trunk", os.path.join(tree, "p3achygo_tpu_torch", "ops", "trunk.py"))
    old_ops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_ops)
    csrc = os.path.join(tree, "p3achygo_tpu_torch", "csrc")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        seg = pool.submit(build, os.path.join(csrc, old_ops.SEGMENT_SOURCE), tmp)
        bc = pool.submit(build, os.path.join(csrc, old_ops.SOURCE), tmp)
        return (old_ops, kernel_fn(seg.result(), "p3_trunk_segment", 4, 5),
                kernel_fn(bc.result(), "p3_trunk_broadcast", 6, 2))


def turns(fns: dict, smi: str, what: str) -> dict:
    """WIDE_ROUNDS rounds of chip_smoke.device_timing (10 calls) of each fn
    in `fns` (among them "this"), in turns, the order reversed every other
    round; logs every reading and each round's ratios of "this" to the
    others, and returns the readings ({name: [ms]})."""
    names = list(fns)
    got = {k: [] for k in names}
    for i in range(WIDE_ROUNDS):
        for k in (names if i % 2 == 0 else names[::-1]):
            ms, how = chip_smoke.device_timing(fns[k], 10)
            got[k].append(ms)
            if how != "profiler kernel records":
                log(f"wide: {what} {k} round {i} timed by {how}")
    ratio = lambda a, b: [x / y for x, y in zip(got[a], got[b])]
    span = lambda v: f"{min(v):.4f}-{max(v):.4f}"
    log(f"wide: {what}: " + "; ".join(f"{k} {'/'.join(f'{t:.4f}' for t in got[k])} ms"
                                      for k in names)
        + "".join(f"; this/{k} {span(ratio('this', k))}" for k in names if k != "this")
        + f" (device ms per call, device_timing, {WIDE_ROUNDS} rounds in turns) [{smi}]")
    return got


def probe_wide(tree: str, smi: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        old_ops, old_seg, old_bc = earlier_kernels(tree, tmp)
        for C, cb, inner, blocks in WIDE_SEGMENTS:
            w = seeded_segment(C, cb, inner, gen, blocks)
            old_packed = old_ops.pack_segment(w)
            for N in N_TIMED:
                x = torch.randn(N, 361, C, generator=gen, device="cuda").bfloat16()
                out = torch.empty_like(x)
                args = (w.aff.data_ptr(), old_packed.data_ptr(), N, blocks, inner, C, cb)
                fns = {"earlier": lambda: call(old_seg, x, out, args),
                       "this": lambda: ops.trunk_segment(x, w),
                       "library": chip_smoke.segment_library_products(w, x)}
                what = f"segment C={C} Cb={cb} {blocks}x{inner} N={N}"
                if N == min(N_TIMED):
                    want = ops.trunk_segment_reference(x, w)
                    fns["earlier"]()
                    rel = (chip_smoke.rel_err(out, want)[1],
                           chip_smoke.rel_err(fns["this"](), want)[1])
                    log(f"wide: {what}: max rel vs plain, earlier {rel[0]:.3e}, this "
                        f"{rel[1]:.3e}")
                turns(fns, smi, what)
        for C in ops.BROADCAST_WIDE:
            w = seeded_broadcast(C, gen)
            old_packed = old_ops.pack_broadcast(w)
            for N in N_TIMED:
                x = torch.randn(N, 361, C, generator=gen, device="cuda").bfloat16()
                out = torch.empty_like(x)
                args = (w.f_aff.data_ptr(), old_packed.data_ptr(), w.bd.data_ptr(),
                        w.l_aff.data_ptr(), N, C)
                fns = {"earlier": lambda: call(old_bc, x, out, args),
                       "this": lambda: ops.trunk_broadcast(x, w),
                       "library": chip_smoke.broadcast_library_products(w, x)}
                what = f"broadcast C={C} N={N}"
                if N == min(N_TIMED):
                    want = ops.trunk_broadcast_reference(x, w)
                    fns["earlier"]()
                    rel = (chip_smoke.rel_err(out, want)[1],
                           chip_smoke.rel_err(fns["this"](), want)[1])
                    log(f"wide: {what}: max rel vs plain, earlier {rel[0]:.3e}, this "
                        f"{rel[1]:.3e}")
                turns(fns, smi, what)


def earlier_wrappers(tree: str, tmp: str):
    """The earlier tree's ops/trunk.py as a module whose wrappers launch
    that tree's kernels, built from its sources (segment: 4 pointers, the
    broadcast 7: the interface of cb45cc3 and later)."""
    spec = importlib.util.spec_from_file_location(
        "earlier_trunk", os.path.join(tree, "p3achygo_tpu_torch", "ops", "trunk.py"))
    old_ops = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(old_ops)
    csrc = os.path.join(tree, "p3achygo_tpu_torch", "csrc")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        seg = pool.submit(build, os.path.join(csrc, old_ops.SEGMENT_SOURCE), tmp)
        bc = pool.submit(build, os.path.join(csrc, old_ops.SOURCE), tmp)
        seg_fn = kernel_fn(seg.result(), "p3_trunk_segment", 4, 5)
        bc_fn = kernel_fn(bc.result(), "p3_trunk_broadcast", 7, 2)
    old_ops._segment_kernel = lambda: seg_fn
    old_ops._broadcast_kernel = lambda: bc_fn
    return old_ops


def probe_tiny(tree: str, smi: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    C, cb = ops.SEGMENT_SMALL
    with tempfile.TemporaryDirectory() as tmp:
        old_ops = earlier_wrappers(tree, tmp)
        seg = seeded_segment(C, cb, 1, gen)
        bc = seeded_broadcast(ops.BROADCAST_SMALL, gen)
        cases = (
            ("segment", seg, ops.trunk_segment, ops.trunk_segment_reference,
             old_ops.trunk_segment, old_ops.with_packed_segment(old_ops.SegmentWeights(*seg[:4])),
             chip_smoke.segment_library_products, chip_smoke.segment_work),
            ("broadcast", bc, ops.trunk_broadcast, ops.trunk_broadcast_reference,
             old_ops.trunk_broadcast,
             old_ops.with_packed_broadcast(old_ops.BroadcastWeights(*bc[:6])),
             chip_smoke.broadcast_library_products, chip_smoke.broadcast_work))
        for name, w, kern, plain, old_kern, old_w, library, work in cases:
            for N in N_TIMED:
                x = torch.randn(N, 361, C, generator=gen, device="cuda").bfloat16()
                what = f"tiny {name} N={N}"
                want = plain(x, w)
                rel = (chip_smoke.rel_err(old_kern(x, old_w), want)[1],
                       chip_smoke.rel_err(kern(x, w), want)[1])
                log(f"tiny: {what}: max rel vs plain, earlier {rel[0]:.3e}, this {rel[1]:.3e}")
                got = turns({"earlier": lambda: old_kern(x, old_w), "this": lambda: kern(x, w),
                             "library": library(w, x)}, smi, what)
                b_ms, b_by = chip_smoke.bound_ms(*work(w, N))
                log(f"tiny: {what}: bound {b_ms:.4f} ms ({b_by}); this "
                    f"{100 * b_ms / max(got['this']):.1f}-{100 * b_ms / min(got['this']):.1f}% "
                    f"of it [{smi}]")


def ply_run(eval_fn, seed: int):
    """(ms of 4 timed plies, profiled {class: ms/ply}, busy, wall, kernels/ply)."""
    device = torch.device("cuda")
    B = chip_smoke.BENCH_B
    cfg = SelfplayConfig(batch_size=B)
    sel = SearchParams(n=128, k=8, noise_scale=1.0, max_depth=24, visit_group=4)
    fast = SearchParams(n=32, k=5, noise_scale=1.0, max_depth=24, visit_group=4)
    gen = torch.Generator(device=device).manual_seed(seed)
    states = new_state(B, cfg.komi, device=device)
    buf = make_game_buffer(B, cfg.max_game_len, device)
    aux = make_aux(B, gen, device=device)
    aux = aux._replace(raw_until=aux.raw_until * 0)
    tree = make_tree(B, 64, device)

    def ply():
        nonlocal states, buf, aux, tree
        states, buf, aux, tree = selfplay_step_tiered(
            states, buf, aux, eval_fn, sel, fast, cfg, generator=gen, reuse_tree=tree,
            reuse_capacity=64)

    for _ in range(3):
        ply()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ply()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            ply()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 2
    by_class, kernels = chip_smoke.kernel_classes(prof, 2)
    return times, by_class, sum(by_class.values()), wall, kernels


def probe_ply(smi: str) -> None:
    model = chip_smoke.seeded_model("b12c128btl3", torch.device("cuda"),
                                    torch.Generator().manual_seed(1))
    model.dtype = torch.bfloat16
    evals = {"fused": make_eval_fn(model, use_fused_trunk=True),
             "serve_fold": make_eval_fn(model, serve_fold=True)}
    for mode in ("fused", "serve_fold", "fused", "serve_fold"):
        times, by_class, busy, wall, kernels = ply_run(evals[mode], seed=0)
        log(f"ply@{chip_smoke.BENCH_B} {mode}: {statistics.median(times):.1f} ms/ply (median of "
            f"4: {', '.join(f'{t:.1f}' for t in times)}); profiled: busy {busy:.1f} of "
            f"{wall:.1f} ms/ply wall (idle {100 * (1 - busy / wall):.0f}%), {kernels:.0f} "
            f"kernels/ply [{smi}]")
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            log(f"  {mode} {cls}: {ms:.1f} ms/ply ({100 * ms / busy:.1f}%)")


def probe_preact(smi: str) -> None:
    from p3achygo_tpu_torch.features import batched_features
    from p3achygo_tpu_torch.nn.serve import ServeNet
    from p3achygo_tpu_torch.ops import preact as pa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(C, N, torch.channels_last) for C in (64, 128, 384) for N in N_TIMED]
    for C, N, fmt in cases + [(128, 2880, torch.contiguous_format)]:
        x = (4.0 * torch.randn(N, C, 19, 19, generator=gen, device=dev)).bfloat16()
        x = x.contiguous(memory_format=fmt)
        a = 0.5 + torch.rand(C, generator=gen, device=dev)
        b = torch.rand(C, generator=gen, device=dev) - 0.5
        if not torch.equal(pa.preact(x, a, b).view(torch.int16),
                           pa.preact_reference(x, a, b).view(torch.int16)):
            raise AssertionError(f"preact: kernel != eager ops at C={C}, N={N}")
        bound = 2 * x.numel() * x.element_size() / 3.35e12 * 1e3
        got = turns({"this": lambda: pa.preact(x, a, b),
                     "eager": lambda: pa.preact_reference(x, a, b)}, smi,
                    f"preact C={C} N={N} {'nhwc' if fmt is torch.channels_last else 'nchw'}")
        k, e = statistics.median(got["this"]), statistics.median(got["eager"])
        log(f"preact: C={C} N={N} {'channels_last' if fmt is torch.channels_last else 'NCHW'}: "
            f"kernel {k:.4f} ms (median), eager chain {e:.4f} ms, x{e / k:.2f}; bound "
            f"{bound:.4f} ms (bytes), share {100 * bound / k:.1f}% [{smi}]")
    model = chip_smoke.seeded_model("b12c128btl3", dev, torch.Generator().manual_seed(1),
                                    dtype=torch.bfloat16)
    boards = chip_smoke.random_boards(2880, 150, dev, gen)
    planes, scalars = batched_features(boards, planes_dtype=torch.bfloat16)
    net = ServeNet(model)
    forwards = {"plain": lambda: model(planes, scalars), "fold": lambda: net(planes, scalars)}
    engages = pa.engages
    for _ in range(2):
        for route, fwd in forwards.items():
            for mode in ("kernel", "eager"):
                pa.engages = engages if mode == "kernel" else (lambda x: False)
                try:
                    ms, how = chip_smoke.device_timing(fwd, 5)
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        for _ in range(2):
                            fwd()
                        torch.cuda.synchronize()
                finally:
                    pa.engages = engages
                by_class, kernels = chip_smoke.kernel_classes(prof, 2)
                log(f"preact: b12c128btl3 N=2880 {route} forward, {mode}: {ms:.3f} device "
                    f"ms ({how}), {kernels:.0f} kernels; " + ", ".join(
                        f"{c} {v:.3f}" for c, v in sorted(by_class.items(),
                                                         key=lambda kv: -kv[1]))
                    + f" [{smi}]")


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("segment", "broadcast", "wide", "tiny", "ply",
                                         "preact"))
    parser.add_argument("--baseline",
                        help="an earlier kernel source: for segment, one with the wr/w9/we "
                             "C interface; for broadcast, one with the wf/wdt/wl C interface")
    parser.add_argument("--packed-baseline",
                        help="for segment: an earlier segment source with this kernel's C "
                             "interface (the packed weight stream)")
    parser.add_argument("--earlier-tree",
                        help="for wide and tiny: the root of an earlier tree of this repo")
    args = parser.parse_args()
    if args.what in ("wide", "tiny") and not args.earlier_tree:
        parser.error(f"{args.what} needs --earlier-tree")
    if not torch.cuda.is_available():
        raise SystemExit("probe_trunk: needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    if args.what == "segment":
        probe_segment(args.baseline, smi, args.packed_baseline)
    elif args.what == "broadcast":
        probe_broadcast(args.baseline, smi)
    elif args.what == "wide":
        probe_wide(args.earlier_tree, smi)
    elif args.what == "tiny":
        probe_tiny(args.earlier_tree, smi)
    elif args.what == "preact":
        probe_preact(smi)
    else:
        probe_ply(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
