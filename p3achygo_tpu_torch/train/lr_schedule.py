"""LR schedules (port of p3achygo_tpu/train/lr_schedule.py; reference
python/lr_schedule.py:7-118) as functions of an integer step."""
from __future__ import annotations

import math


def constant_lr(lr: float):
    return lambda step: float(lr)


def cyclic_lr(min_lr: float, max_lr: float, cycle_len: int):
    """Triangular cyclic LR (arXiv 1803.09820)."""
    half = cycle_len // 2 if cycle_len % 2 == 0 else cycle_len // 2 + 1
    delta = (max_lr - min_lr) / half

    def fn(step: int) -> float:
        s = step % cycle_len
        return min_lr + delta * (min(s, half) - max(0, s - half))

    return fn


def cyclic_lr_decay(min_lr: float, max_lr: float, cycle_len: int,
                    decay_bound: float = 0.95):
    """One-cycle with final decay to 0.25 * min_lr."""
    main_len = int(cycle_len * decay_bound)
    half = cycle_len // 2 if cycle_len % 2 == 0 else cycle_len // 2 + 1
    decay_len = max(cycle_len - main_len, 1)
    delta = (max_lr - min_lr) / half
    lr_final = min_lr * 0.25
    decay_delta = (min_lr - lr_final) / decay_len

    def fn(step: int) -> float:
        cycle_step = step % main_len if step < main_len else 0
        decay_step = step - main_len if step >= main_len else 0
        ninc = min(cycle_step, half)
        ndec = max(0, cycle_step - half)
        return min_lr + delta * (ninc - ndec) - decay_delta * decay_step

    return fn


def lr_for_gen(config, model_gen: int) -> float:
    """Per-generation LR (rl_loop/train.py:33-49 get_lr): 0.1 -> 1.0 scale
    over `lr_growth_window` generations, base LR from the piecewise
    `lr_schedule` [(gen, lr), ...] with a half-cosine transition toward the
    next scheduled LR over the last `lr_transition_window` generations."""
    if getattr(config, "lr_growth_window", 0) > 0:
        lr_scale = 0.1 + 0.9 * min(1.0, model_gen / config.lr_growth_window)
    else:
        lr_scale = 1.0

    lr = config.lr
    next_gen, next_lr = None, None
    for gen, gen_lr in (config.lr_schedule or []):
        if gen > model_gen:
            next_gen, next_lr = gen, gen_lr
            break
        lr = gen_lr

    window = getattr(config, "lr_transition_window", 0)
    if window > 0 and next_gen is not None and (next_gen - model_gen) <= window:
        t = 0.5 * (1.0 - math.cos(
            math.pi * (1.0 - (next_gen - model_gen) / window)))
        lr = lr + t * (next_lr - lr)
    return lr_scale * lr


def gen_growth_scale(gen: int, growth_gens: int = 10,
                     transition_gens: int = 10) -> float:
    """Per-generation LR warm-up: 0.1 -> 1.0 over `growth_gens`, then 1.0
    (the JAX function's transition window also returns 1.0)."""
    if gen < growth_gens:
        return 0.1 + 0.9 * gen / growth_gens
    return 1.0
