"""RL loop binary: python -m p3achygo_tpu_torch.rl --config config/<run>.json
(port of p3achygo_tpu/rl/__main__.py; reference
`python -m python.rl_loop.train_sp_eval`, train_sp_eval.py:145).

--role both (the default) runs the single-process combined loop. The
distributed roles (actor, learner) need the store bus and workers, which
are not ported: asking for one is an error. Every search option of a run
configuration runs (early stopping, exact terminal scoring, the value-bias
cache). --device picks the device the loop runs on (the card unless the
caller asks for the CPU).
"""
from __future__ import annotations

import argparse
import json
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m p3achygo_tpu_torch.rl")
    ap.add_argument("--config", required=True)
    ap.add_argument("--run-dir", default="runs/local")
    ap.add_argument("--gens", type=int, default=0,
                    help="override num_generations")
    ap.add_argument("--sgf-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-resume", action="store_true",
                    help="start fresh even if run-dir has resume state")
    ap.add_argument("--role", choices=("both", "actor", "learner"),
                    default="both")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.role != "both":
        ap.error(f"--role {args.role} needs rl/workers.py and data/store.py, "
                 "which the port does not have yet; use --role both")

    from p3achygo_tpu_torch.rl.config import parse
    from p3achygo_tpu_torch.rl.loop import GenerationLoop

    cfg = parse(args.config)
    gens = args.gens or cfg.num_generations
    loop = GenerationLoop(cfg, root_dir=args.run_dir, seed=args.seed,
                          device=args.device)
    # Elastic recovery (train_sp_eval.py:213-215 + fs_utils.py:25-65): a
    # restarted process picks the run up from the last completed generation.
    if not args.no_resume and loop.try_resume():
        print(json.dumps({"resumed_at_gen": loop.gen}), flush=True)
    if args.sgf_dir:
        loop.sgf_dir = args.sgf_dir
    while loop.gen < gens:
        t0 = time.time()
        info = loop.run_generation()
        info["wall_s"] = round(time.time() - t0, 1)
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)


if __name__ == "__main__":
    main()
