"""The port's constructors build on the card unless the caller asks for the
CPU: each defaults to device="cuda", and where there is no card a call that
leaves the device out fails instead of quietly building CPU tensors."""
import inspect

import numpy as np
import pytest
import torch

from p3achygo_tpu_torch.data.pipeline import prepare_batch
from p3achygo_tpu_torch.data.replay import _FIELDS
from p3achygo_tpu_torch.game.board import new_state
from p3achygo_tpu_torch.mcts.gumbel import SearchParams
from p3achygo_tpu_torch.mcts.tree import make_tree
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.heads import score_bins
from p3achygo_tpu_torch.models.model import build_model
from p3achygo_tpu_torch.rl.slice import RLSlice, SliceConfig
from p3achygo_tpu_torch.selfplay.loop import SelfplayConfig, make_aux, make_game_buffer


def _rows():
    """Two all-zero replay rows."""
    return {k: np.zeros((2,) + shape, dtype) for k, (dtype, shape) in _FIELDS.items()}


def _slice(**kw):
    return RLSlice(SliceConfig(model="tiny", batch_size=2, dtype="float32",
                               search=SearchParams(n=2, k=2),
                               selfplay=SelfplayConfig(max_game_len=4)), **kw)

CONSTRUCTORS = {
    "new_state": (new_state, lambda **kw: new_state(2, **kw)),
    "make_tree": (make_tree, lambda **kw: make_tree(2, 4, **kw)),
    "make_game_buffer": (make_game_buffer, lambda **kw: make_game_buffer(2, 3, **kw)),
    "make_aux": (make_aux, lambda **kw: make_aux(2, **kw)),
    "build_model": (build_model, lambda **kw: build_model(get_config("tiny"), **kw)),
    "score_bins": (score_bins, lambda **kw: score_bins(**kw)),
    "prepare_batch": (prepare_batch, lambda **kw: prepare_batch(_rows(), **kw)),
    "RLSlice": (RLSlice, _slice),
}


def _a_tensor(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, torch.nn.Module):
        return next(out.parameters())
    if isinstance(out, RLSlice):
        return out.states.stones
    return next(t for t in out if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_defaults_to_the_card(name):
    fn, _ = CONSTRUCTORS[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("name", sorted(CONSTRUCTORS))
def test_constructor_without_device(name):
    """On the card the default lands there; without one it raises."""
    _, call = CONSTRUCTORS[name]
    assert _a_tensor(call(device="cpu")).device.type == "cpu"
    if torch.cuda.is_available():
        assert _a_tensor(call()).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
