"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Cells, metrics and bounds are in BENCHMARK.json at the root of the
checkout; each cell's configuration, traffic and check limits, and each
per-layer metric's reader, are files under portbench/ found by name
(portbench/harness/cells.py). The program measured is p3achygo_tpu_torch on
one NVIDIA card; the run refuses to start without one. With --trace 0 the
result carries the cell's end-to-end metrics, with --trace 1 its per-layer
metrics, the device's busy seconds over the profiled plies and a
breakdown. The last line of standard output is one JSON object; the
numbers the correctness check compared, each with its limit, are the last
lines of standard error and the result's last key, `checks`.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Kernel caches of anything the program compiles, at fixed paths inside the
# checkout (the program builds its own CUDA libraries into its _build/).
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "p3achygo_tpu")


def forbidden_modules(names=None) -> list:
    """Loaded modules (or `names`) whose top-level name is JAX's, flax's or
    the JAX package's (whole names compared: p3achygo_tpu_torch is the
    port)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench.harness.cells import load_cell

    cell = load_cell(args.workload)
    import torch

    chips = cell["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"portbench: the cell needs {chips} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"portbench: {args.workload} seed {args.seed} seconds {args.seconds} trace "
        f"{args.trace}; card: {power_line()}; torch {torch.__version__} CUDA "
        f"{torch.version.cuda}")
    from portbench.harness.runner import run_cell

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T_START, log)
    bad = forbidden_modules()
    if bad:
        log(f"portbench: the run loaded {bad}: the benchmark measures p3achygo_tpu_torch "
            f"alone")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
