"""Measure the fused trunk on an NVIDIA card, beyond what chip_smoke.py prints.

    python3 probe_trunk.py segment [--baseline PATH]
    python3 probe_trunk.py broadcast [--baseline PATH]
    python3 probe_trunk.py ply

segment: the segment kernel at the b12c128btl3 widths (C=128, Cb=64, a run
of 3 blocks of 3 inner layers) and the b8c64 widths (C=64, Cb=32, 3 blocks
of 2), seeded Gaussian inputs and weights, N in {512, 2880}: max |d| /
max |ref| against the plain version, and device time per call (CUDA events,
median of 5 runs of 10 calls). With --baseline, the segment kernel of that
source file, which must have the C interface of the earlier wmma segment
kernel (csrc/trunk.cu before the segment kernel moved to
csrc/trunk_segment.cu: p3_trunk_segment(x, out, aff, wr, w9, we, N,
n_blocks, inner, C, Cb, stream)), is timed in turns with this one:
baseline, kernel, kernel, baseline. Then a build of csrc/trunk_segment.cu
with -DP3_SEGMENT_PROFILE gives the clock cycles per board-block of each
phase (consumer warpgroup 0, warp 0) at the b12c128btl3 widths.

broadcast: the broadcast kernel at the b12c128btl3 (C=128) and b8c64
(C=64) widths, seeded Gaussian inputs and weights, N in {512, 2880}: max
|d| / max |ref| against the plain version and device time per call (CUDA
events, median of 5 runs of 10 calls). With --baseline, the broadcast
kernel of that source file, which must have the C interface of the earlier
wmma broadcast kernel (csrc/trunk.cu before the redesign:
p3_trunk_broadcast(x, out, f_aff, wf, wdt [368, 368], bd, l_aff, wl, N, C,
stream)), is timed in turns with this one: baseline, kernel, kernel,
baseline. Then a build of csrc/trunk_broadcast.cu with
-DP3_BROADCAST_PROFILE gives the clock cycles per board of each phase
(consumer warpgroup 0, warp 0) at C=128, among them the wait for the
previous board's mix to free the single-buffered m.

ply: chip_smoke.py's self-play step (the bench mix, b12c128btl3 bf16 with
seeded weights, B=256 fresh games) with the fused trunk and with
serve_fold, in turns (fused, serve_fold, fused, serve_fold): 3 warm plies,
4 plies timed one by one (host clock around synchronised plies), 2 plies
under the profiler: device busy ms/ply (summed kernel time), wall ms/ply,
idle share, kernels/ply and device time by class of kernel.

Every line names the card and its power limit. Needs a card; there is no
CPU mode. Builds go to a temporary directory.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch
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

WIDTHS = ((128, 64, 3), (64, 32, 2))  # (C, Cb, inner), 3 blocks each
BROADCAST_WIDTHS = (128, 64)
N_TIMED = (512, 2880)
PHASES = ("block-0 reduce", "3x3 products", "3x3 epilogues", "expand (+ next reduce)")
BROADCAST_PHASES = ("conv_first", "wait for m free", "barrier after conv_first",
                    "mix products", "mix epilogue + conv_last + store")


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


def seeded_segment(C: int, cb: int, inner: int, gen: torch.Generator):
    dev = torch.device("cuda")
    r = lambda *s: torch.rand(*s, generator=gen, device=dev)
    n = lambda *s: torch.randn(*s, generator=gen, device=dev)
    aff = torch.stack([0.7 + 0.6 * r(3, 2 + inner, C), 0.2 * (r(3, 2 + inner, C) - 0.5)], dim=2)
    w = ops.SegmentWeights(aff.contiguous(), (n(3, C, cb) / C ** 0.5).bfloat16(),
                           (n(3, inner, 9 * cb, cb) / (9 * cb) ** 0.5).bfloat16(),
                           (n(3, cb, C) / cb ** 0.5).bfloat16())
    return w._replace(packed=ops.pack_segment(w))


def seeded_broadcast(C: int, gen: torch.Generator):
    dev = torch.device("cuda")
    r = lambda *s: torch.rand(*s, generator=gen, device=dev)
    n = lambda *s: torch.randn(*s, generator=gen, device=dev)
    aff = lambda: torch.stack([0.7 + 0.6 * r(C), 0.2 * (r(C) - 0.5)]).contiguous()
    wdt = torch.zeros((ops.MIX_PAD, ops.MIX_PAD), device=dev)
    wdt[:361, :361] = n(361, 361) / 19.0
    w = ops.BroadcastWeights(aff(), (n(C, C) / C ** 0.5).bfloat16(), wdt.bfloat16(),
                             0.1 * n(361), aff(), (n(C, C) / C ** 0.5).bfloat16())
    return w._replace(packed=ops.pack_broadcast(w))


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
    """Per-unit clock cycles of each of the n - 1 phases of a profile build
    (counter n - 1 counts the units), over 10 calls after a warm-up."""
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
    return [c / cycles[n - 1] for c in cycles[:n - 1]]


def phase_line(names, per) -> str:
    return ", ".join(f"{name} {p:.0f} ({100 * p / sum(per):.0f}%)"
                     for name, p in zip(names, per)) + f"; total {sum(per):.0f}"


def probe_segment(baseline: str | None, smi: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        base = kernel_fn(build(baseline, tmp), "p3_trunk_segment", 6, 5) if baseline else None
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
                if base is not None:
                    old = lambda: call(base, x, out, (w.aff.data_ptr(), w.wr.data_ptr(),
                                                      w.w9.data_ptr(), w.we.data_ptr(),
                                                      N, 3, inner, C, cb))
                    t = [event_ms(old), event_ms(kernel), event_ms(kernel), event_ms(old)]
                    row += (f"; baseline {t[0]:.4f}/{t[3]:.4f} ms, kernel {t[1]:.4f}/{t[2]:.4f}"
                            f" ms ({gflop / min(t[1], t[2]):.1f} TFLOP/s)")
                else:
                    t = event_ms(kernel)
                    row += f"; kernel {t:.4f} ms ({gflop / t:.1f} TFLOP/s)"
                log(f"segment: {row} [{smi}]")
                if C != WIDTHS[0][0]:
                    continue
                args = (w.aff.data_ptr(), w.packed.data_ptr(), N, 3, inner, C, cb)
                per = phase_cycles(prof_lib, "p3_trunk_segment_phase_cycles", prof_fn, x, out,
                                   args, 5)
                log(f"segment phases C={C} N={N}, clock cycles per board-block: "
                    f"{phase_line(PHASES, per)} [{smi}]")


def probe_broadcast(baseline: str | None, smi: str) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        base = (kernel_fn(build(baseline, tmp), "p3_trunk_broadcast", 8, 2)
                if baseline else None)
        prof_lib = build(os.path.join(cuda_build.CSRC_DIR, ops.SOURCE), tmp,
                         "-DP3_BROADCAST_PROFILE")
        prof_fn = kernel_fn(prof_lib, "p3_trunk_broadcast", 6, 2)
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
                if base is not None:
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
                log(f"broadcast: {row} [{smi}]")
                if C != BROADCAST_WIDTHS[0]:
                    continue
                args = (w.f_aff.data_ptr(), w.packed.data_ptr(), w.bd.data_ptr(),
                        w.l_aff.data_ptr(), N, C)
                per = phase_cycles(prof_lib, "p3_trunk_broadcast_phase_cycles", prof_fn, x,
                                   out, args, 6)
                log(f"broadcast phases C={C} N={N}, clock cycles per board: "
                    f"{phase_line(BROADCAST_PHASES, per)} [{smi}]")


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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("what", choices=("segment", "broadcast", "ply"))
    parser.add_argument("--baseline",
                        help="an earlier kernel source: for segment, one with the wr/w9/we "
                             "C interface; for broadcast, one with the wf/wdt/wl C interface")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe_trunk: needs an NVIDIA card (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.smi_line()
    if args.what == "segment":
        probe_segment(args.baseline, smi)
    elif args.what == "broadcast":
        probe_broadcast(args.baseline, smi)
    else:
        probe_ply(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
