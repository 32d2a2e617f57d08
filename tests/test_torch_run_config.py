"""The port's run configuration (p3achygo_tpu_torch/rl/config.py) held
against the JAX package: the dataclass defaults, `parse` of every
config/*.json (by path and by run id), and the per-generation growth
schedules (Gumbel n/k, eval n, eval games, the LR) for generations 0-20
of each, plus RunConfigs with growth windows."""
import dataclasses
import glob
import os

import pytest

from p3achygo_tpu.rl import config as jc
from p3achygo_tpu.train.lr_schedule import lr_for_gen as jax_lr_for_gen
from p3achygo_tpu_torch.rl import config as tc
from p3achygo_tpu_torch.train.lr_schedule import lr_for_gen

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "config", "*.json")))


def _growth_cfgs(mod):
    return [mod.RunConfig(),
            mod.RunConfig(eval_games=128, min_eval_games=64, eval_games_growth_window=8,
                          eval_n=32, min_eval_n=4, eval_n_growth_window=10, eval_k=4),
            mod.RunConfig(min_train_selected_n=48, max_train_selected_n=128,
                          min_train_selected_k=4, max_train_selected_k=8,
                          min_train_default_n=16, max_train_default_n=32,
                          min_train_default_k=4, max_train_default_k=5,
                          n_growth_window=7, k_growth_window=13,
                          lr_growth_window=5, lr_schedule=[(0, 1e-2), (9, 3e-3)],
                          lr_transition_window=3)]


def _schedule(mod, lr_fn, cfg):
    return [(mod.gumbel_params_for_gen(cfg, g, True), mod.gumbel_params_for_gen(cfg, g, False),
             mod.eval_n_for_gen(cfg, g), mod.eval_games_for_gen(cfg, g), lr_fn(cfg, g))
            for g in range(21)]


def test_defaults_match_jax():
    assert dataclasses.asdict(tc.RunConfig()) == dataclasses.asdict(jc.RunConfig())


def test_configs_found():
    assert len(CONFIGS) >= 6


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_parse_and_schedules_match_jax(path):
    run_id = os.path.splitext(os.path.basename(path))[0]
    t = tc.parse(path)
    assert dataclasses.asdict(t) == dataclasses.asdict(jc.parse(path))
    assert dataclasses.asdict(tc.parse(run_id, os.path.join(ROOT, "config"))) == \
        dataclasses.asdict(t)
    assert _schedule(tc, lr_for_gen, t) == _schedule(jc, jax_lr_for_gen, jc.parse(path))


def test_growth_schedules_match_jax():
    for t, j in zip(_growth_cfgs(tc), _growth_cfgs(jc)):
        assert _schedule(tc, lr_for_gen, t) == _schedule(jc, jax_lr_for_gen, j)
