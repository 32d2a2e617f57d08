"""GTP binary: python -m p3achygo_tpu_torch.gtp [--model b12c128btl3]
[--n 128] [--k 8] [--checkpoint DIR] [--device cuda|cpu]
(port of p3achygo_tpu/gtp/__main__.py).

Serves one board over GTP on stdin/stdout with the bf16 network behind
make_eval_fn (symmetrized, plain forward), searching n visits over k
root candidates with no root noise.
"""
from __future__ import annotations

import argparse

import torch


def load_model(name: str, checkpoint: str, device):
    """The bf16 network of config `name` on `device`: the port's seeded init
    (seed 0), then the weights of the port checkpoint directory
    `checkpoint` (a {"model": state_dict} state.pt) when one is given."""
    from p3achygo_tpu_torch.models.config import get_config
    from p3achygo_tpu_torch.models.model import build_model, init_params
    from p3achygo_tpu_torch.train.checkpoint import restore_checkpoint

    model = build_model(get_config(name), torch.bfloat16, device)
    init_params(model, torch.Generator().manual_seed(0))
    if checkpoint:
        model.load_state_dict(
            restore_checkpoint(checkpoint, map_location=device)["model"])
    return model


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m p3achygo_tpu_torch.gtp",
        description="GTP engine of the PyTorch port. Without --checkpoint the "
        "weights are the port's seeded init (seed 0), which differs from the "
        "JAX package's init: play with a trained checkpoint.")
    ap.add_argument("--checkpoint", default="",
                    help="a checkpoint directory of the port (model_%%04d or live, "
                    "holding state.pt with {'model': state_dict}, as the port's "
                    "GenerationLoop writes it)")
    ap.add_argument("--model", default="b12c128btl3")
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="the device the engine runs on (default: the card)")
    args = ap.parse_args(argv)

    from p3achygo_tpu_torch.gtp.service import GtpConfig, GtpService, run_stdin_loop
    from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn

    device = torch.device(args.device)
    model = load_model(args.model, args.checkpoint, device)
    cfg = GtpConfig(search=SearchParams(n=args.n, k=args.k, noise_scale=0.0))
    run_stdin_loop(GtpService(make_eval_fn(model), cfg, device=device))


if __name__ == "__main__":
    main()
