"""Optimizers (port of p3achygo_tpu/train/optimizer.py): SGD + Nesterov +
global-norm clipping (RLSlice's and RunConfig's default; rl_loop/train.py
:115-119) and ConvMuon (python/optimizer.py:7-147).

Each is an optax-style pair of pure functions over dicts of tensors keyed
by parameter name: `init(params) -> state` and `update(grads, state,
params) -> (updates, state)`; `apply_updates` adds the updates to the
parameters in place. States are dicts of tensors and ints, so `torch.save`
stores them. optax's formulas are written out:

- `clip_by_global_norm` scales by max_norm / norm only when norm >=
  max_norm, with no epsilon (unlike torch.nn.utils.clip_grad_norm_), as
  one factor on the device (no host sync);
- the Nesterov trace is t = g + mu * t; u = g + mu * t, then times -lr,
  with lr(count) for a schedule, count starting at 0.

ConvMuon's leaf test, flattening and RMS scale assume flax layouts (a conv
kernel [H, W, in, out] flattened to [H*W*in, out], a dense kernel
[in, out]); the port's weights are [out, in, H, W] and [out, in], so each
gradient is taken to the flax layout for the Newton-Schulz step and back.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch

from p3achygo_tpu_torch.bridge import from_flax_layout, to_flax_layout

Tensors = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]


class GradientTransformation(NamedTuple):
    init: Callable[[Tensors], dict]
    update: Callable[[Tensors, dict, Optional[Tensors]], Tuple[Tensors, dict]]


def _lr_fn(learning_rate: Schedule) -> Callable[[int], float]:
    return learning_rate if callable(learning_rate) else (lambda _: learning_rate)


def global_norm(tensors: Tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm),
    from one multi-tensor norm launch."""
    norms = torch._foreach_norm([t.float() for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
def apply_updates(params: Tensors, updates: Tensors) -> None:
    """params += updates, in place (optax.apply_updates)."""
    torch._foreach_add_(list(params.values()), [updates[k] for k in params])


def sgd_nesterov(learning_rate: Schedule, momentum: float = 0.9,
                 clipnorm: float = 1.0) -> GradientTransformation:
    """optax.chain(clip_by_global_norm(clipnorm), sgd(lr, momentum,
    nesterov=True))."""
    lr_fn = _lr_fn(learning_rate)

    def init(params: Tensors) -> dict:
        return {"count": 0, "trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads: Tensors, state: dict, params: Optional[Tensors] = None):
        # Multi-tensor (foreach) operations: a handful of launches for all
        # parameters in place of several per parameter tensor.
        names = list(grads)
        g_norm = global_norm(grads)
        scale = torch.where(g_norm < clipnorm, 1.0, clipnorm / g_norm)
        g = torch._foreach_mul([grads[k] for k in names], scale)
        t = torch._foreach_mul([state["trace"][k] for k in names], momentum)
        torch._foreach_add_(t, g)  # t = g + mu * t
        u = torch._foreach_mul(t, momentum)
        torch._foreach_add_(u, g)  # u = g + mu * t
        torch._foreach_mul_(u, -lr_fn(state["count"]))
        return dict(zip(names, u)), {"count": state["count"] + 1,
                                     "trace": dict(zip(names, t))}

    return GradientTransformation(init, update)


def _newton_schulz5(G: torch.Tensor, steps: int = 5, eps: float = 1e-7) -> torch.Tensor:
    """Quintic Newton-Schulz orthogonalization of a 2D matrix."""
    a, b, c = 3.4445, -4.7750, 2.0315
    transpose = G.shape[0] > G.shape[1]
    X = G.t() if transpose else G
    X = X / (torch.linalg.norm(X) + eps)
    for _ in range(steps):
        A = X @ X.t()
        B = b * A + c * (A @ A)
        X = a * X + B @ X
    return X.t() if transpose else X


def _is_muon_leaf(shape) -> bool:
    """Flax-layout shape: >= 2-D with both effective 2D dims > 4."""
    if len(shape) < 2:
        return False
    return shape[-1] > 4 and math.prod(shape[:-1]) > 4


def conv_muon(learning_rate: Schedule, momentum: float = 0.95,
              nesterov: bool = True, ns_steps: int = 5, rms_rate: float = 0.2,
              weight_decay: float = 1e-4, wd_lr_exponent: Optional[float] = 0.70,
              wd_lr_max: Optional[float] = None, adam_b1: float = 0.9,
              adam_b2: float = 0.999, adam_eps: float = 1e-8,
              adam_weight_decay: float = 0.0) -> GradientTransformation:
    """Muon with conv flattening for leaves whose flax-layout 2D dims are
    both > 4, AdamW for the rest; Moonlight RMS scaling rms_rate *
    sqrt(max(flat_dim, out_dim)), decoupled weight decay scaled by the same
    factor and by (lr / wd_lr_max)^wd_lr_exponent."""
    lr_fn = _lr_fn(learning_rate)

    def init(params: Tensors) -> dict:
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(grads: Tensors, state: dict, params: Optional[Tensors] = None):
        if params is None:
            raise ValueError("conv_muon needs the parameters")
        count = state["count"] + 1
        lr = lr_fn(count)
        if wd_lr_exponent is not None and wd_lr_max is not None:
            wd_lr_scale = min(lr / wd_lr_max, 1.0) ** wd_lr_exponent
        else:
            wd_lr_scale = 1.0
        # Bias corrections in float32, as optax computes them.
        f32 = lambda v: torch.tensor(v, dtype=torch.float32)
        bc1 = float(1.0 - f32(adam_b1) ** count)
        bc2 = float(1.0 - f32(adam_b2) ** count)
        updates, mu, nu = {}, {}, {}
        for k, g in grads.items():
            m, v, p = state["mu"][k], state["nu"][k], params[k]
            flax_shape = to_flax_layout(g, k).shape
            if _is_muon_leaf(flax_shape):
                m_new = momentum * m + g
                g_eff = g + momentum * m_new if nesterov else m_new
                g2d = to_flax_layout(g_eff, k).reshape(-1, flax_shape[-1])
                ortho = from_flax_layout(
                    _newton_schulz5(g2d, ns_steps).reshape(flax_shape), k)
                scale = rms_rate * max(g2d.shape) ** 0.5
                updates[k] = (-lr * scale * ortho
                              - lr * weight_decay * scale * wd_lr_scale * p)
                mu[k], nu[k] = m_new, v
                continue
            m_new = adam_b1 * m + (1 - adam_b1) * g
            v_new = adam_b2 * v + (1 - adam_b2) * (g * g)
            m_hat = m_new / bc1
            v_hat = v_new / bc2
            updates[k] = -lr * (m_hat / (torch.sqrt(v_hat) + adam_eps)
                                + adam_weight_decay * p)
            mu[k], nu[k] = m_new, v_new
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)
