"""RL loop binary: python -m p3achygo_tpu_torch.rl --config config/<run>.json
(port of p3achygo_tpu/rl/__main__.py; reference
`python -m python.rl_loop.train_sp_eval`, train_sp_eval.py:145).

--role splits the combined loop into the reference's distributed worker
deployment over a store bus (--store <dir|gs://...>):
  --role actor    selfplay worker (cc/selfplay/main.cc + sp_loop.py): waits
                  for a golden on the bus, plays games_per_gen games per
                  chunk and publishes it, hot-swaps each newer golden, and
                  exits once the bus holds generation --gens
  --role learner  trainer/gater (train_sp_eval.py minus sp_loop): publishes
                  gen 0 if the bus has no model, then per generation waits
                  for games_per_gen * 60 examples, trains, gates and
                  publishes the golden
  --role both     single-process combined loop (default)
Every search option of a run configuration runs (early stopping, exact
terminal scoring, the value-bias cache). --device picks the device the
process runs on (the card unless the caller asks for the CPU).
--trace-spans (combined loop) turns `p3achygo_tpu_torch.tracing` on and adds
to each generation's line `spans`, by span name its count, total and self
seconds and host syncs, `sync_wait_s`, the seconds the searches' own
syncs blocked, by cause, and `preact`, the generation's launches of the
pre-activation kernel and its CUDA calls that ran the eager ops
(`ops.preact`).
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
    ap.add_argument("--store", default="",
                    help="store bus path or gs:// url (actor/learner)")
    ap.add_argument("--worker-id", default="w0")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-spans", action="store_true",
                    help="time the self-play ply by span (combined loop)")
    args = ap.parse_args(argv)
    if args.role != "both" and not args.store:
        ap.error("--role actor/learner requires --store")
    if args.trace_spans and args.role != "both":
        ap.error("--trace-spans reports on the combined loop (--role both)")

    from p3achygo_tpu_torch import tracing
    from p3achygo_tpu_torch.mcts.gumbel import COUNTERS
    from p3achygo_tpu_torch.ops.preact import preact
    from p3achygo_tpu_torch.rl.config import parse
    from p3achygo_tpu_torch.rl.loop import GenerationLoop

    cfg = parse(args.config)
    gens = args.gens or cfg.num_generations
    if args.role == "actor":
        _run_actor(cfg, args, gens)
        return
    if args.role == "learner":
        _run_learner(cfg, args, gens)
        return
    loop = GenerationLoop(cfg, root_dir=args.run_dir, seed=args.seed,
                          device=args.device)
    # Elastic recovery (train_sp_eval.py:213-215 + fs_utils.py:25-65): a
    # restarted process picks the run up from the last completed generation.
    if not args.no_resume and loop.try_resume():
        print(json.dumps({"resumed_at_gen": loop.gen}), flush=True)
    if args.sgf_dir:
        loop.sgf_dir = args.sgf_dir
    if args.trace_spans:
        tracing.enable()
    while loop.gen < gens:
        t0 = time.time()
        preact_before = preact.launches, preact.plain_calls
        info = loop.run_generation()
        info["wall_s"] = round(time.time() - t0, 1)
        if args.trace_spans:
            info["spans"] = {name: {k: (round(v, 6) if isinstance(v, float) else v)
                                    for k, v in d.items()}
                             for name, d in tracing.summary().items()}
            info["sync_wait_s"] = {cause: round(ns / 1e9, 6)
                                   for cause, ns in COUNTERS.sync_wait_ns.items()}
            info["preact"] = {"launches": preact.launches - preact_before[0],
                              "plain_calls": preact.plain_calls - preact_before[1]}
            tracing.reset()
            COUNTERS.sync_wait_ns.clear()
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)


def _run_actor(cfg, args, gens: int) -> None:
    from p3achygo_tpu_torch.data.store import make_store
    from p3achygo_tpu_torch.rl.workers import SelfplayActor

    actor = SelfplayActor(cfg, make_store(args.store), worker_id=args.worker_id,
                          scratch_dir=args.run_dir, seed=args.seed,
                          device=args.device)
    while True:
        swapped = actor.sync_model()
        if actor.model_gen >= gens:
            return
        if actor.model_gen < 0:
            time.sleep(1.0)  # no golden published yet
            continue
        name = actor.play_and_publish(cfg.games_per_gen)
        print(json.dumps({"actor_gen": actor.model_gen, "chunk": name,
                          "model_swapped": swapped}), flush=True)


def _run_learner(cfg, args, gens: int) -> None:
    from p3achygo_tpu_torch.data.store import make_store, most_recent_model
    from p3achygo_tpu_torch.rl.workers import Learner

    store = make_store(args.store)
    learner = Learner(cfg, store, run_dir=args.run_dir, seed=args.seed,
                      device=args.device)
    if most_recent_model(store) < 0:
        learner.publish_golden()  # seed the bus with gen 0
    while learner.loop.gen < gens:
        learner.wait_for_examples(cfg.games_per_gen * 60, timeout_s=3600.0)
        info = learner.train_generation()
        print(json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                          for k, v in info.items()}), flush=True)


if __name__ == "__main__":
    main()
