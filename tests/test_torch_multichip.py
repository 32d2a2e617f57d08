"""The port's scale-out layer (p3achygo_tpu_torch/parallel) on the CPU:
the mesh-shape and partition-rule cases of tests/test_multichip.py on the
same shapes, `dryrun_multichip(4)` over 4 gloo ranks (dp 2 x tp 2) through
its entry point, tests/test_multihost.py's flow over 2 gloo ranks, and the
port's one-process loss on the dry run's batch against JAX's
make_train_step loss on the same variables."""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from p3achygo_tpu.data.pipeline import prepare_batch as jax_prepare_batch
from p3achygo_tpu.models import LossCoeffs as JaxCoeffs
from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.train.optimizer import sgd_nesterov as jax_sgd
from p3achygo_tpu.train.step import create_train_state as jax_create_train_state
from p3achygo_tpu.train.step import make_train_step as jax_make_train_step
from p3achygo_tpu_torch.bridge import state_dict_to_flax
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.parallel import make_mesh, param_partition_spec
from p3achygo_tpu_torch.parallel.dryrun import dryrun_batch
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import create_train_state, make_train_step

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN_TIMEOUT_S = 300
SHARDED = (Replicate(), Shard(0))
REPLICATED = (Replicate(), Replicate())


def _env():
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env["PYTHONPATH"] = ROOT
    return env


def test_mesh_shapes():
    """make_mesh(8, model_parallel=2) is a (data 4, model 2) mesh, in a
    process group of 8 ranks of torch's fake backend (no communication)."""
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = make_mesh(8, model_parallel=2)
        assert tuple(mesh.mesh.shape) == (4, 2)
        assert mesh.mesh_dim_names == ("data", "model")
        with pytest.raises(ValueError):
            make_mesh(6, model_parallel=4)
    finally:
        dist.destroy_process_group()


def test_param_partition_rule():
    """The JAX rule on the same flax shapes, read through the port's
    layouts: flax [128, 64] is the port's Dense weight [64, 128]."""
    big = torch.zeros(64, 128)
    assert param_partition_spec(big, 2, "embed.weight") == SHARDED
    assert param_partition_spec(torch.zeros(5), 2, "a.bias") == REPLICATED
    assert param_partition_spec(torch.zeros(4, 3), 2, "a.weight") == REPLICATED
    assert param_partition_spec(big, 1, "embed.weight") == REPLICATED
    # Conv OIHW out channels, an attention kernel [C, H, D] on D, its
    # [H, D] bias (>= 2-D, so the rule takes it as JAX does), score_pre_s.
    assert param_partition_spec(torch.zeros(32, 16, 3, 3), 2, "c.weight") == SHARDED
    assert param_partition_spec(torch.zeros(96, 3, 32), 2, "q.weight") == (Replicate(), Shard(2))
    assert param_partition_spec(torch.zeros(3, 32), 2, "q.bias") == (Replicate(), Shard(1))
    assert param_partition_spec(torch.zeros(1, 64), 2, "v.score_pre_s") == (Replicate(), Shard(1))
    assert param_partition_spec(torch.zeros(96, 3, 32), 8, "q.weight") == REPLICATED


def test_dryrun_multichip_four_gloo_ranks():
    """`python -m p3achygo_tpu_torch.parallel --nproc 4 --device cpu`: a
    (data 2, model 2) mesh; the sharded train loss within relative 1e-3 of
    one process's, self-play stones and moves equal and pi within 1e-4
    (dryrun_multichip raises otherwise; the summary is checked again)."""
    out = subprocess.run([sys.executable, "-m", "p3achygo_tpu_torch.parallel", "--nproc", "4",
                          "--device", "cpu"], capture_output=True, text=True, env=_env(),
                         cwd=ROOT, timeout=RUN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith('{"dryrun_multichip"')]
    assert len(lines) == 1, out.stdout
    s = json.loads(lines[0])["dryrun_multichip"]
    assert (s["n_devices"], s["dp"], s["tp"], s["backend"]) == (4, 2, 2, "gloo")
    assert abs(s["loss"] - s["loss_one_process"]) <= 1e-3 * max(1.0, abs(s["loss_one_process"]))
    assert s["selfplay_pi_max_abs_err"] <= 1e-4


_WORKER = r"""
import sys
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
pid, port = int(sys.argv[1]), sys.argv[2]
from p3achygo_tpu_torch.parallel.distributed import (
    global_mesh, host_local_to_global, init_multihost, local_shards, replicate)
init_multihost(f"localhost:{port}", num_processes=2, process_id=pid,
               local_device_count=4, device="cpu")
assert dist.get_world_size() == 2

from p3achygo_tpu_torch.constants import NUM_MOVES
from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.losses import LossCoeffs
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.parallel.dryrun import make_sharded_train_step
from p3achygo_tpu_torch.train.optimizer import sgd_nesterov
from p3achygo_tpu_torch.train.step import TrainState, batch_stats_of, make_train_step

mesh = global_mesh(model_parallel=1)
model = build_model(get_config("tiny"), device="cpu")
# Each rank draws its own weights: replicate() must hand out rank 0's.
init_params(model, torch.Generator().manual_seed(pid))
tx = sgd_nesterov(1e-3)
params = {k: p.detach() for k, p in model.named_parameters()}
state = TrainState(params=replicate(params, mesh),
                   batch_stats=replicate(batch_stats_of(model), mesh),
                   opt_state=replicate(tx.init(params), mesh), step=0)

def rows(seed, B=8):
    rng = np.random.default_rng(seed)
    return {
        "stones": rng.integers(-1, 2, (B, 361)).astype(np.int8),
        "last_moves": rng.integers(-1, 362, (B, 5)).astype(np.int16),
        "color": rng.choice([-1, 1], (B,)).astype(np.int8),
        "komi": np.full((B,), 7.5, np.float32),
        "pi": np.full((B, NUM_MOVES), 1.0 / NUM_MOVES, np.float32),
        "pi_aux": np.zeros((B,), np.int16),
        "pi_aux_dist": np.full((B, NUM_MOVES), 1.0 / NUM_MOVES, np.float32),
        "has_pi_aux_dist": np.ones((B,), bool),
        "own": np.zeros((B, 361), np.int8),
        "score_margin": np.zeros((B,), np.float32),
        "z": np.ones((B,), np.float32),
        **{k: np.zeros((B,), np.float32) for k in
           ("q6", "q16", "q50", "q6_score", "q16_score", "q50_score")},
        "weight": np.ones((B,), np.float32),
        "mcts_value_dist": np.zeros((B, 51), np.int32),
    }

# Each rank contributes its own 8 rows of the global 16-row batch.
gbatch = host_local_to_global(rows(100 + pid), mesh)
assert gbatch["stones"].shape == (16, 361)
mine = local_shards(gbatch)
assert np.array_equal(mine["stones"], rows(100 + pid)["stones"])
planes, scalars, targets = prepare_batch(mine, augment=False, device="cpu")
step = make_sharded_train_step(model, tx, LossCoeffs.rl(), mesh, 1)
new_state, losses = step(state, *host_local_to_global((planes, scalars, targets), mesh))
loss = float(losses["loss"])
assert np.isfinite(loss)

# The same step in one process on both ranks' rows, from rank 0's weights.
one = build_model(get_config("tiny"), device="cpu")
init_params(one, torch.Generator().manual_seed(0))
both = {k: np.concatenate([rows(100)[k], rows(101)[k]]) for k in rows(100)}
p1, s1, t1 = prepare_batch(both, augment=False, device="cpu")
_, l1 = make_train_step(one, tx, LossCoeffs.rl())(
    TrainState(dict(one.named_parameters()), batch_stats_of(one),
               tx.init(dict(one.named_parameters())), 0), p1, s1, t1)
d = max(float((new_state.params[k].full_tensor() - p).abs().max())
        for k, p in one.named_parameters())
print(f"MULTIHOST_OK pid={pid} loss={loss:.6f} one_process={float(l1['loss']):.6f} "
      f"param_max_abs_diff={d:.3e}", flush=True)
dist.destroy_process_group()
"""


def test_two_rank_multihost_flow(tmp_path):
    """tests/test_multihost.py's flow over 2 gloo ranks: init_multihost,
    replicate (rank 0's weights), host_local_to_global, local_shards and
    one sharded train step; both ranks report the same loss, equal to
    one process's on the 16 rows within relative 1e-5, and new parameters
    within 1e-6 of that step's (the averaged gradient sums in another
    order)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=_env(), cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-4000:]}"
    reports = [dict(kv.split("=") for kv in ln.split()[1:])
               for out in outs for ln in out.splitlines() if ln.startswith("MULTIHOST_OK")]
    assert len(reports) == 2 and reports[0]["loss"] == reports[1]["loss"], reports
    for r in reports:
        loss, one = float(r["loss"]), float(r["one_process"])
        assert abs(loss - one) <= 1e-5 * abs(one), r
        assert float(r["param_max_abs_diff"]) <= 1e-6, r


def test_one_process_loss_matches_jax():
    """The port's train step on the dry run's batch (B=8, tiny, seeded
    weights, sgd_nesterov 1e-3, RL weights, JAX's symmetries) gives JAX
    make_train_step's loss on the same variables, float32 on both sides,
    within relative 1e-4."""
    tm = build_model(get_config("tiny"), device="cpu")
    init_params(tm, torch.Generator().manual_seed(0))
    variables = jax.tree_util.tree_map(jnp.asarray, state_dict_to_flax(tm.state_dict()))
    rows = dryrun_batch(8)
    key = jax.random.PRNGKey(1)
    jrows = {k: jnp.asarray(v) for k, v in rows.items() if k != "mcts_value_dist"}
    jp, js, jt = jax.jit(jax_prepare_batch, static_argnames=("augment",))(key, jrows,
                                                                        augment=True)
    jm, jtx = jax_build(jax_get_config("tiny")), jax_sgd(1e-3)
    _, jl = jax.jit(jax_make_train_step(jm, jtx, JaxCoeffs.rl()))(
        jax_create_train_state(variables, jtx), jp, js, jt)
    syms = torch.tensor(np.asarray(jax.random.randint(jax.random.split(key)[1], (8,), 0, 8)))
    planes, scalars, targets = prepare_batch(rows, syms=syms, device="cpu")
    np.testing.assert_array_equal(planes.numpy(), np.asarray(jp))
    tx = sgd_nesterov(1e-3)
    _, tl = make_train_step(tm, tx, LossCoeffs.rl())(create_train_state(tm, tx), planes,
                                                     scalars, targets)
    np.testing.assert_allclose(float(tl["loss"]), float(jl["loss"]), rtol=1e-4)
