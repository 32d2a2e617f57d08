"""Checkpoints with torch.save (the port's counterpart of
p3achygo_tpu/train/checkpoint.py, which uses orbax): the same directory
naming, model_%04d and live under one root (rl_loop/fs_utils.py:25-65
discovery semantics), each a directory holding one `state.pt`.

A checkpoint is any tree torch.save stores and `torch.load(weights_only=
True)` reads back: dicts of tensors, ints and floats, such as
{"model": model.state_dict(), "opt_state": ..., "step": ...}.
"""
from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

MODEL_FMT = "model_%04d"
LIVE_NAME = "live"
STATE_FILE = "state.pt"


def save_named(root: str, name: str, tree: Any) -> str:
    """Save `tree` under root/name (overwrites); the file is written beside
    and renamed into place, so a reader never sees half of it."""
    path = os.path.join(os.path.abspath(root), name)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(tree, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    return path


def save_checkpoint(root: str, gen: int, tree: Any, live: bool = True) -> str:
    """Save `tree` as model_%04d (and update `live`)."""
    path = save_named(root, MODEL_FMT % gen, tree)
    if live:
        save_named(root, LIVE_NAME, tree)
    return path


def restore_checkpoint(path: str, map_location=None) -> Any:
    """The tree saved under `path`, its tensors on `map_location` (default:
    where they were saved)."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=map_location,
                      weights_only=True)


def latest_generation(root: str) -> Optional[int]:
    """Most recent model_%04d in `root` (get_most_recent_model parity)."""
    if not os.path.isdir(root):
        return None
    gens = [int(m.group(1)) for name in os.listdir(root)
            if (m := re.fullmatch(r"model_(\d{4})", name))]
    return max(gens) if gens else None
