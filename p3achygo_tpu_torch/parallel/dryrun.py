"""Multi-rank dry run: the port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip` (:40-200).

On a (data, model) mesh of every rank of the process group, at the `tiny`
config and tiny shapes:

1. one data x tensor parallel train step (sgd_nesterov 1e-3, RL loss
   weights): parameters, BN statistics and optimizer state placed by the
   TP rule, the batch sharded over 'data'; its loss must be within
   relative 1e-3 of the same step in one process on the whole batch;
2. two tiered self-play steps (n=4/k=2 selected, n=2/k=2 fast, half the
   boards selected) with the boards sharded over 'data' and the trained
   weights replicated; stones and recorded moves must equal, and the
   policy targets be within 1e-4 of, the same two steps in one process.

Run it with `python -m p3achygo_tpu_torch.parallel --nproc N [--device
cpu]`, which starts the N ranks; `dryrun_multichip` itself runs inside
each rank.
"""
from __future__ import annotations

import json
import traceback
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from p3achygo_tpu_torch.constants import NUM_MOVES
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.game.board import new_state
from p3achygo_tpu_torch.mcts.gumbel import SearchParams, make_eval_fn
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.parallel.distributed import init_multihost, make_sharded_train_step
from p3achygo_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, shard_batch, shard_params
from p3achygo_tpu_torch.selfplay.loop import (
    BatchShard,
    SelfplayConfig,
    draw_step,
    make_aux,
    make_game_buffer,
    map_state,
    selfplay_step_tiered,
)
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import TrainState, batch_stats_of, make_train_step

LOSS_RTOL = 1e-3
PI_ATOL = 1e-4


def dryrun_batch(B: int) -> Dict[str, np.ndarray]:
    """The JAX dry run's replay rows (__graft_entry__.py:76-101), seed 0."""
    rng = np.random.default_rng(0)
    z = lambda dtype=np.float32, *shape: np.zeros((B,) + shape, dtype)
    return {
        "stones": rng.integers(-1, 2, (B, 361)).astype(np.int8),
        "last_moves": rng.integers(-1, 362, (B, 5)).astype(np.int16),
        "color": rng.choice([-1, 1], (B,)).astype(np.int8),
        "komi": np.full((B,), 7.5, np.float32),
        "pi": np.full((B, NUM_MOVES), 1.0 / NUM_MOVES, np.float32),
        "pi_aux": z(np.int16),
        "pi_aux_dist": np.full((B, NUM_MOVES), 1.0 / NUM_MOVES, np.float32),
        "has_pi_aux_dist": np.ones((B,), bool),
        "own": z(np.int8, 361),
        "score_margin": z(), "z": np.ones((B,), np.float32),
        "q6": z(), "q16": z(), "q50": z(),
        "q6_score": z(), "q16_score": z(), "q50_score": z(),
        "weight": np.ones((B,), np.float32),
        "mcts_value_dist": z(np.int32, 51),
    }


def _gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The whole batch of a tensor whose rows the ranks of the 'data'
    `group` hold in order (integers travel as int64: gloo takes no int16
    or bool)."""
    x = t if t.is_floating_point() else t.to(torch.int64)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts).to(t.dtype)


def dryrun_multichip(n_devices: int) -> dict:
    """Full DP x TP train step and two sharded self-play steps on an
    n-rank mesh, each held against one process (see the module
    docstring). Call in every rank of a process group of n_devices ranks;
    raises on a failed check, returns the summary on every rank."""
    if dist.get_world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of "
                         f"{dist.get_world_size()} ranks")
    model_parallel = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(n_devices, model_parallel=model_parallel)
    dev = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
           else torch.device("cpu"))
    data_group = mesh.get_group(DATA_AXIS)
    dp, data_rank = mesh.size(0), mesh.get_coordinate()[0]

    model = build_model(get_config("tiny"), device=dev)
    init_params(model, torch.Generator().manual_seed(0))
    tx = sgd_nesterov(1e-3)
    coeffs = LossCoeffs.rl()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    stats = {k: b.clone() for k, b in batch_stats_of(model).items()}
    state = TrainState(params=shard_params(params, mesh, model_parallel),
                       batch_stats=shard_params(stats, mesh, model_parallel),
                       opt_state=shard_params(tx.init(params), mesh, model_parallel), step=0)

    B = 2 * n_devices
    planes, scalars, targets = prepare_batch(
        dryrun_batch(B), augment=True, generator=torch.Generator(device=dev).manual_seed(1),
        device=dev)
    s_planes, s_scalars, s_targets = shard_batch((planes, scalars, targets), mesh)
    if s_planes.device_mesh.size() != n_devices or s_planes.to_local().shape[0] != B // dp:
        raise AssertionError("the batch is not sharded over the mesh")
    state, losses = make_sharded_train_step(model, tx, coeffs, mesh, model_parallel)(
        state, s_planes, s_scalars, s_targets)
    loss = float(losses["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"sharded train loss {loss}")

    # The same step in one process on the whole batch, from the same state.
    one = build_model(get_config("tiny"), device=dev)
    one.load_state_dict({**params, **stats})
    one_state = TrainState(params=dict(one.named_parameters()),
                           batch_stats=batch_stats_of(one), opt_state=tx.init(params), step=0)
    _, losses_1d = make_train_step(one, tx, coeffs)(one_state, planes, scalars, targets)
    loss_1d = float(losses_1d["loss"])
    if not abs(loss - loss_1d) <= LOSS_RTOL * max(1.0, abs(loss_1d)):
        raise AssertionError(f"sharded train loss {loss} != one-process {loss_1d}")

    # Self-play with the trained weights (the model holds them, full, on
    # every rank: the golden broadcast), boards sharded over 'data'.
    B_sp = 4 * n_devices
    cfg = SelfplayConfig(batch_size=B_sp, max_game_len=16, tree_reuse=False,
                         trainable_move_prob=0.5)
    p_sel = SearchParams(n=4, k=2, max_depth=4, visit_group=2)
    p_fast = SearchParams(n=2, k=2, max_depth=4)
    eval_fn = make_eval_fn(model)
    lo, B_loc = data_rank * (B_sp // dp), B_sp // dp
    rows = lambda tree: map_state(lambda t: t[lo:lo + B_loc].clone(), tree)

    def play(sharded: bool):
        gen = torch.Generator(device=dev).manual_seed(2)
        states = new_state(B_sp, 7.5, device=dev)
        buf = make_game_buffer(B_sp, cfg.max_game_len, device=dev)
        aux = make_aux(B_sp, max_raw_moves=0, device=dev)
        if sharded:
            states, buf, aux = rows(states), rows(buf), rows(aux)
        for _ in range(2):
            draws = draw_step(B_sp, cfg, gen, dev)
            shard = BatchShard(lo, _gather_rows(aux.force_sel, data_group)) if sharded else None
            states, buf, aux = selfplay_step_tiered(states, buf, aux, eval_fn, p_sel, p_fast,
                                                    cfg, draws=draws, shard=shard)
        return states, buf

    sp_states, sp_buf = play(sharded=True)
    if not bool((sp_states.move_count == 2).all()):
        raise AssertionError("sharded self-play did not play two moves")
    stones = _gather_rows(sp_states.stones, data_group)
    moves = _gather_rows(sp_buf.move, data_group)
    pi = _gather_rows(sp_buf.pi, data_group)
    one_states, one_buf = play(sharded=False)
    if not torch.equal(stones, one_states.stones):
        raise AssertionError("sharded self-play diverged from one process (stones)")
    if not torch.equal(moves, one_buf.move):
        raise AssertionError("sharded self-play diverged (recorded moves)")
    pi_err = float((pi - one_buf.pi).abs().max())
    if not pi_err <= PI_ATOL:
        raise AssertionError(f"sharded self-play diverged (policy targets, max |d| {pi_err})")
    return {"n_devices": n_devices, "dp": dp, "tp": model_parallel,
            "backend": dist.get_backend(), "loss": loss, "loss_one_process": loss_1d,
            "selfplay_pi_max_abs_err": pi_err, "boards": B_sp, "train_batch": B}


def run_rank(rank: int, nproc: int, port: int, device: str, errors) -> None:
    """One rank of `python -m p3achygo_tpu_torch.parallel`: join the group,
    run the dry run, leave the group; rank 0 prints the summary as a JSON
    line. A failure's traceback goes to the `errors` queue and re-raises."""
    try:
        if device == "cpu":
            # N ranks share the host's cores: one intra-op thread each.
            torch.set_num_threads(1)
        init_multihost(f"localhost:{port}", nproc, rank, device=device)
        try:
            summary = dryrun_multichip(nproc)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            print(json.dumps({"dryrun_multichip": summary}), flush=True)
    except BaseException:
        errors.put((rank, traceback.format_exc()))
        raise
