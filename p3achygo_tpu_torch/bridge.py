"""flax variables <-> the port's state dict.

Takes the JAX package's `variables` (`{"params": ..., "batch_stats": ...}`)
as plain nested dicts of numpy arrays, so this module imports no JAX
(reading an orbax checkpoint into such dicts stays with the caller, e.g.
through `p3achygo_tpu.train.checkpoint.restore_checkpoint`). Module paths
are the same on both sides (models/blocks.py names its attributes after
the flax tree); the leaves map as:

  params  .../kernel  4-D HWIO conv kernel -> .../weight OIHW
  params  .../kernel  2-D [in, out] Dense  -> .../weight [out, in]
  params  .../kernel  3-D attention kernel  -> .../weight, as it is
          (query/key/value [C, H, D], out [H, D, C])
  params  .../bias    any shape             -> .../bias, as it is
  params  .../scale   BatchNorm, LayerNorm  -> .../weight
  params  value_head/score_pre_s            -> value_head.score_pre_s
  params  pos_embed/pos_embed [19, 19, C]   -> pos_embed.pos_embed
  batch_stats .../mean, .../var             -> .../running_mean, running_var

`state_dict_to_flax` is the inverse (tests compare parameters and BN
statistics after a training step under the flax names), and
`to_flax_layout` / `from_flax_layout` give one tensor in the flax layout,
which the Muon optimizer's flattening and leaf test assume.
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
        t = torch.tensor(np.asarray(arr, np.float32))
        if leaf == "kernel" and t.dim() in (2, 3, 4):
            name = ".".join(mod + ["weight"])
            t = from_flax_layout(t, name).contiguous()
        elif leaf in ("scale", "bias", "score_pre_s", "pos_embed"):
            name = ".".join(mod + ["weight" if leaf == "scale" else leaf])
        else:
            raise KeyError(f"unmapped flax param {'/'.join(path)}")
        out[name] = t
    stat_names = {"mean": "running_mean", "var": "running_var"}
    for path, arr in _leaves(variables.get("batch_stats", {})):
        *mod, leaf = path
        out[".".join(mod + [stat_names[leaf]])] = torch.tensor(
            np.asarray(arr, np.float32))
    return out


def flax_dims(dim: int, name: str) -> Tuple[int, ...]:
    """The permutation p with to_flax_layout(t, name) == t.permute(p) for a
    parameter `name` of `dim` dimensions: an OIHW conv weight goes to HWIO
    and an [out, in] Dense weight to [in, out]; every other leaf (biases
    of any shape, the 3-D attention kernels and the positional embedding,
    already in flax's layout, `score_pre_s` [1, c_val] on both sides, 1-D
    leaves) stays as it is."""
    if dim == 4:
        return (2, 3, 1, 0)
    if dim == 2 and name.endswith(".weight"):
        return (1, 0)
    return tuple(range(dim))


def to_flax_layout(t: torch.Tensor, name: str) -> torch.Tensor:
    """Parameter `name` in the flax layout (see `flax_dims`)."""
    return t.permute(flax_dims(t.dim(), name))


def from_flax_layout(t: torch.Tensor, name: str) -> torch.Tensor:
    """Inverse of `to_flax_layout`."""
    perm = flax_dims(t.dim(), name)
    return t.permute(tuple(perm.index(i) for i in range(len(perm))))


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """The port's state dict -> flax `variables` ({"params": ...,
    "batch_stats": ...} of nested dicts of float32 numpy arrays)."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, arr):
        for key in path[:-1]:
            tree = tree.setdefault(key, {})
        tree[path[-1]] = arr

    for name, t in state_dict.items():
        *mod, leaf = name.split(".")
        arr = t.detach().float().cpu()
        if leaf in ("running_mean", "running_var"):
            put(stats, mod + [leaf[len("running_"):]], arr.numpy())
        elif leaf == "weight" and arr.dim() == 1:
            put(params, mod + ["scale"], arr.numpy())
        elif leaf == "weight":
            put(params, mod + ["kernel"], to_flax_layout(arr, name).contiguous().numpy())
        elif leaf in ("bias", "score_pre_s", "pos_embed"):
            put(params, mod + [leaf], arr.numpy())
        else:
            raise KeyError(f"unmapped state dict entry {name}")
    return {"params": params, "batch_stats": stats}


def load_flax_variables(model: nn.Module, variables: Mapping) -> nn.Module:
    """Copy flax `variables` into `model` in place; every parameter and
    buffer must be covered and every flax leaf used."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def scales_from_jax(scales: Mapping, device="cpu") -> Dict[str, torch.Tensor]:
    """The JAX package's serve_q scale dict (site -> scalar array) as the
    port's: site -> 0-d float32 tensor on `device` (nn/serve_q.py)."""
    return {site: torch.tensor(np.asarray(v, np.float32).reshape(()), device=device)
            for site, v in scales.items()}
