"""flax variables -> the port's state dict.

Takes the JAX package's `variables` (`{"params": ..., "batch_stats": ...}`)
as plain nested dicts of numpy arrays, so this module imports no JAX
(reading an orbax checkpoint into such dicts stays with the caller, e.g.
through `p3achygo_tpu.train.checkpoint.restore_checkpoint`). Module paths
are the same on both sides (models/blocks.py names its attributes after
the flax tree); the leaves map as:

  params  .../kernel  4-D HWIO conv kernel -> .../weight OIHW
  params  .../kernel  2-D [in, out] Dense  -> .../weight [out, in]
  params  .../bias                          -> .../bias
  params  .../scale   BatchNorm             -> .../weight
  params  value_head/score_pre_s            -> value_head.score_pre_s
  batch_stats .../mean, .../var             -> .../running_mean, running_var
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(val)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Map flax `variables` (numpy leaves) to a torch state dict."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _leaves(variables["params"]):
        *mod, leaf = path
        arr = np.asarray(arr, np.float32)
        if leaf == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif leaf == "scale":
            name = "weight"
        elif leaf in ("bias", "score_pre_s"):
            name = leaf
        else:
            raise KeyError(f"unmapped flax param {'/'.join(path)}")
        out[".".join(mod + [name])] = torch.tensor(arr)
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        out[".".join(mod + [stat_names[leaf]])] = torch.tensor(
            np.asarray(arr, np.float32))
    return out


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax `variables` into `model` in place; every parameter and
    buffer must be covered and every flax leaf used."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model
