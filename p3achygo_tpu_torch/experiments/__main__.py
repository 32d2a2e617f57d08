"""Experiments CLI (port of p3achygo_tpu/experiments/__main__.py;
reference cc/experiments/main.cc + gumbel_visits_study.cc flags).

  python -m p3achygo_tpu_torch.experiments play_games \\
      --model_path runs/demo/model_0001 --num_games 4 \\
      --visit_count 64 --seq_halving --bias_callback

  python -m p3achygo_tpu_torch.experiments visits_study \\
      --model_path runs/demo/model_0001 \\
      --chunk_path runs/demo/chunks/gen000_b000_g004_n00128_t0_w0.tfrecord.zz \\
      --num_examples 64 --seed_visits 30 --gt_n 2048

`--model_path` is a checkpoint directory of the port (model_%04d, holding
state.pt with {"model": state_dict}), read as `python -m
p3achygo_tpu_torch.gtp --checkpoint` reads it; `--model_config` with no
`--model_path` runs the port's seeded init (harness smoke tests).
`--device` picks the device (default: the card).
"""
from __future__ import annotations

import argparse
import sys


def _load_eval_fn(model_path: str, model_config: str, device):
    from p3achygo_tpu_torch.gtp.__main__ import load_model
    from p3achygo_tpu_torch.mcts.gumbel import make_eval_fn
    return make_eval_fn(load_model(model_config, model_path, device))


def _pool(reports, n_values):
    """Pool batch reports: the pooled samples are gone, so batch means are
    weighted by size and max-of-p75/p95/max are conservative aggregates."""
    total = sum(r["examples"] for r in reports)

    def mean(get):
        return sum(get(r) * r["examples"] for r in reports) / total

    def worst(get):
        return max(get(r) for r in reports)

    agg = dict(reports[0])
    agg["examples"] = total
    agg["prior"] = {"mean": mean(lambda r: r["prior"]["mean"]),
                    **{q: worst(lambda r, q=q: r["prior"][q])
                       for q in ("p75", "p95", "max")}}
    per_n = []
    for ni, n in enumerate(n_values):
        mean_gt = mean(lambda r: r["per_n"][ni]["kld_gt"]["mean"])
        per_n.append({
            "n": n,
            "kld_gt": {"mean": mean_gt,
                       **{q: worst(lambda r, q=q: r["per_n"][ni]["kld_gt"][q])
                          for q in ("p75", "p95", "max")}},
            "kld_prior": {"mean": mean(lambda r: r["per_n"][ni]["kld_prior"]["mean"]),
                          "p75": 0.0, "p95": 0.0, "max": 0.0},
            "nats_per_visit": (agg["prior"]["mean"] - mean_gt) / n,
        })
    agg["per_n"] = per_n
    return agg


def main(argv=None):
    parser = argparse.ArgumentParser(prog="python -m p3achygo_tpu_torch.experiments")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pg = sub.add_parser("play_games")
    pg.add_argument("--model_path", default="")
    pg.add_argument("--model_config", default="b8c64")
    pg.add_argument("--num_games", type=int, default=1)
    pg.add_argument("--visit_count", type=int, default=400)
    pg.add_argument("--seq_halving", action="store_true")
    pg.add_argument("--bias_callback", action="store_true")
    pg.add_argument("--print_callback", action="store_true", default=True)
    pg.add_argument("--max_moves", type=int, default=600)
    pg.add_argument("--seed", type=int, default=0)
    pg.add_argument("--device", default="cuda")

    vs = sub.add_parser("visits_study")
    vs.add_argument("--model_path", default="")
    vs.add_argument("--model_config", default="b8c64")
    vs.add_argument("--chunk_path", required=True)
    vs.add_argument("--num_examples", type=int, default=500)
    vs.add_argument("--batch", type=int, default=64)
    vs.add_argument("--seed_visits", type=int, default=30)
    vs.add_argument("--gt_n", type=int, default=10000,
                    help="ground-truth visit budget (gumbel_visits_study.cc:87 "
                         "uses 10000)")
    vs.add_argument("--n_values", default="64,100,150,200,300,400,800")
    vs.add_argument("--use_gumbel", action=argparse.BooleanOptionalAction,
                    default=True)
    vs.add_argument("--verbose", action="store_true")
    vs.add_argument("--seed", type=int, default=0)
    vs.add_argument("--device", default="cuda")

    args = parser.parse_args(argv)
    eval_fn = _load_eval_fn(args.model_path, args.model_config, args.device)

    if args.cmd == "play_games":
        from p3achygo_tpu_torch.experiments.play_games import (BiasCallback,
                                                               PrintCallback,
                                                               play_games)
        cbs = []
        if args.print_callback:
            cbs.append(PrintCallback())
        if args.bias_callback:
            cbs.append(BiasCallback())
        results = play_games(eval_fn, args.num_games, args.visit_count,
                             args.seq_halving, cbs, max_moves=args.max_moves,
                             seed=args.seed, device=args.device)
        for r in results:
            print(f"game {r.game_idx}: {r} in {r.num_moves} moves")
        return 0

    from p3achygo_tpu_torch.experiments.visits_study import (format_report,
                                                             load_chunk_examples,
                                                             run_visits_study,
                                                             states_from_examples)
    examples = load_chunk_examples(args.chunk_path, args.num_examples)
    if not examples:
        print(f"no examples in {args.chunk_path}", file=sys.stderr)
        return 1
    n_values = [int(x) for x in args.n_values.split(",") if x]

    # Device-sized batches; the per-position KLD samples are pooled across
    # batches (the reference streams one example at a time).
    reports = []
    for lo in range(0, len(examples), args.batch):
        states = states_from_examples(examples[lo:lo + args.batch], args.device)
        reports.append(run_visits_study(
            eval_fn, states, n_values=n_values, gt_n=args.gt_n,
            seed_visits=args.seed_visits, use_gumbel=args.use_gumbel,
            seed=args.seed + lo))
        print(f"processed {min(lo + args.batch, len(examples))}"
              f"/{len(examples)} examples", file=sys.stderr)
    print(format_report(_pool(reports, n_values)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
