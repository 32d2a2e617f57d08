"""The check against planted faults, on the CPU: a run of a cell at a
small size (the card's look skipped, the program's plain CPU paths under
the harness) comes out correct as it stands and not correct with each
fault a self-play cell can have planted under the timed path: a step that
returns its state unchanged, half of a leaf batch left out of the
evaluation, a policy target altered where it is produced, a move altered
where it is chosen, a search that runs half its simulations, one that
weighs its completed Q by another sigma, and one that returns the prior as
its target. (The exchange between chips is no
fault of a one-card cell.)"""
from __future__ import annotations

import copy
import dataclasses
import time

import pytest
import torch

from portbench.harness.cells import load_cell
from portbench.harness.runner import run_cell

SEED = 2 ** 31 + 4242


def small_cell():
    cell = copy.deepcopy(load_cell("sp.b12c128btl3.refmix.b1024.fused"))
    cell["config"].update(blocks=6, broadcast_interval=4, inner_bottleneck_layers=1,
                          channels=16, bottleneck_channels=8, head_channels=8, c_val=16)
    tr = cell["traffic"]
    tr.update(batch=8, warm_plies=2, reset_every=2, start_plies_max=60)
    tr["selected"], tr["fast"] = {"n": 8, "k": 4}, {"n": 4, "k": 2}
    # bf16 on the CPU reads a few hundredths or less at this size (0.024 /
    # 0.003 at this seed at the widest row): the limits keep a margin.
    cell["limits"].update(leaf_logp_gap=0.1, leaf_logp_q75=0.05, leaf_value_gap=0.05,
                          leaf_value_q75=0.02)
    return cell


CHECK = {"boards": 6, "leaf_call_every": 2, "leaf_rows_per_call": 4, "leaf_rows_max": 64}


def run(**kw):
    logs = []
    res = run_cell(small_cell(), SEED, 0.05, False, torch.device("cpu"), time.perf_counter(),
                   logs.append, check=CHECK, **kw)
    return res, logs


def keep_states(step):
    def stuck(states, buf, aux, *args, **kwargs):
        _, buf, aux, tree = step(states, buf, aux, *args, **kwargs)
        return states, buf, aux, tree
    return stuck


def half_batch(fn):
    def half(states):
        n = states.stones.shape[0]
        h = max(1, n // 2)
        out = fn(type(states)(*[t[:h] for t in states]))
        idx = torch.arange(n) % h
        return type(out)(*[None if t is None else t[idx] for t in out])
    return half


def wrap_search(monkeypatch, change):
    """Plants `change(search_root, *args, **kwargs)` under the step's
    search calls."""
    from p3achygo_tpu_torch.selfplay import loop

    search = loop.search_root
    monkeypatch.setattr(loop, "search_root", lambda *a, **kw: change(search, *a, **kw))


def half_simulations(search, states, eval_fn, params, *args, **kwargs):
    return search(states, eval_fn, dataclasses.replace(params, n=params.n // 2), *args, **kwargs)


def other_sigma(search, states, eval_fn, params, *args, **kwargs):
    return search(states, eval_fn, dataclasses.replace(params, c_visit=params.c_visit / 2),
                  *args, **kwargs)


def prior_target(search, *args, **kwargs):
    out = search(*args, **kwargs)
    res = out if hasattr(out, "pi_improved") else out[0]
    res = res._replace(pi_improved=res.root_priors)
    return res if hasattr(out, "pi_improved") else (res,) + tuple(out[1:])


def altered_targets(step):
    def altered(states, buf, aux, *args, **kwargs):
        out = step(states, buf, aux, *args, **kwargs)
        buf.pi.copy_(buf.pi.roll(1, dims=2))
        return out
    return altered


@pytest.mark.parametrize("route", ["fused", "fold", "plain"])
def test_sound_run_is_correct(route):
    res, logs = run(route=route)
    assert res["correct"], (res["checks"], logs)
    assert res["checks"]["rules_mismatches"]["value"] == 0
    assert res["checks"]["search_mismatches"]["value"] == 0


@pytest.mark.parametrize("fault", ["state unchanged", "half the batch", "target altered",
                                   "move altered", "half the simulations", "other sigma",
                                   "prior as target"])
def test_each_fault_fails_the_check(fault, monkeypatch):
    kw = {}
    if fault == "half the simulations":
        wrap_search(monkeypatch, half_simulations)
    elif fault == "other sigma":
        wrap_search(monkeypatch, other_sigma)
    elif fault == "prior as target":
        wrap_search(monkeypatch, prior_target)
    elif fault == "state unchanged":
        kw["step_wrap"] = keep_states
    elif fault == "half the batch":
        kw["eval_wrap"] = half_batch
    elif fault == "target altered":
        kw["step_wrap"] = altered_targets
    else:
        from p3achygo_tpu_torch.selfplay import loop

        choose = loop._choose_move

        def occupied(states, res, raw_until, raw_gumbel):
            move, sampling_raw, over = choose(states, res, raw_until, raw_gumbel)
            stone = (states.stones != 0).to(torch.int8).argmax(dim=1)
            has = (states.stones != 0).any(dim=1)
            return torch.where(has, stone, move), sampling_raw, over

        monkeypatch.setattr(loop, "_choose_move", occupied)
    res, logs = run(**kw)
    assert not res["correct"], (fault, res["checks"])
