"""Plain float32 forward of a p3achygo bottleneck ("btl") network, and the
evaluation that search reads from it, for judging the program.

The architecture is p3achygo's (python/model.py of github.com/p3achyjr/
p3achygo: P3achyGoModel, the bottleneck and broadcast residual blocks, the
policy and value heads), written out layer by layer in plain torch, NCHW,
float32, with TF32 off. Parameters are named as the published flax tree
names them (`bottleneck_res_0.reduce.Conv_0.weight`, ...); `parameter_shapes`
lists them. BatchNorm is pre-activation and reads running statistics with
eps 1e-3; this module folds each into a per-channel scale and shift itself.
mish is x * tanh(softplus(x)).

The evaluation applies the D4 symmetry the JAX package picks from the
position's additive Zobrist hash (`hash[0] % 8`; the table from numpy's
generator seeded 0x9E3779B97F4A7C15 mod 2**32, as the JAX package builds
it), builds the 15 input planes and 8 scalars of the JAX featurizer (own
and opponent stones, the last five moves, own and opponent stones in
chains of 1, 2 and 3 liberties, the ladder planes left zero, the colour to
move, pass flags and komi / 15 signed for the colour to move), runs the
forward and maps the policy back.

Nothing here imports the program or JAX.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.rules import BLACK, BOARD, POINTS, batch_point_liberties

BN_EPS = 1e-3
INPUT_PLANES = 15
INPUT_SCALARS = 8
SCORE_LOGITS = 800
VALUE_BUCKETS = 51


def is_broadcast(cfg: dict, i: int) -> bool:
    return i % cfg["broadcast_interval"] == cfg["broadcast_interval"] - 1


def parameter_shapes(cfg: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every parameter and BatchNorm statistic of the network, by name."""
    C, cb, hc, cv = (cfg["channels"], cfg["bottleneck_channels"], cfg["head_channels"],
                     cfg["c_val"])
    k = cfg["conv_size"]
    out: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()

    def bn(prefix, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            out[f"{prefix}.{s}"] = (c,)

    def conv_block(prefix, cin, cout, kk):
        bn(f"{prefix}.BatchNorm_0", cin)
        out[f"{prefix}.Conv_0.weight"] = (cout, cin, kk, kk)

    def dense(prefix, cin, cout):
        out[f"{prefix}.weight"] = (cout, cin)
        out[f"{prefix}.bias"] = (cout,)

    out["init_board_conv.weight"] = (C, INPUT_PLANES, k + 2, k + 2)
    dense("init_game_layer", INPUT_SCALARS, C)
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            p = f"broadcast_res_{i}"
            conv_block(f"{p}.conv_first", C, C, 1)
            dense(f"{p}.mix.Dense_0", POINTS, POINTS)
            conv_block(f"{p}.conv_last", C, C, 1)
        else:
            p = f"bottleneck_res_{i}"
            conv_block(f"{p}.reduce", C, cb, 1)
            for j in range(cfg["inner_bottleneck_layers"]):
                conv_block(f"{p}.inner_{j}", cb, cb, k)
            conv_block(f"{p}.expand", cb, C, 1)
    ph = "policy_head"
    out[f"{ph}.conv_p.weight"] = (hc, C, 1, 1)
    out[f"{ph}.conv_g.weight"] = (hc, C, 1, 1)
    bn(f"{ph}.gpool.batch_norm_gpool", hc)
    dense(f"{ph}.gpool.Dense_0", 2 * hc, hc)
    out[f"{ph}.output_moves.weight"] = (2, hc, 1, 1)
    dense(f"{ph}.output_pass", 2 * hc, 2)
    out[f"{ph}.soft_moves.weight"] = (1, hc, 1, 1)
    dense(f"{ph}.soft_pass", 2 * hc, 1)
    out[f"{ph}.optimistic_moves.weight"] = (1, hc, 1, 1)
    dense(f"{ph}.optimistic_pass", 2 * hc, 1)
    vh = "value_head"
    out[f"{vh}.score_pre_s"] = (1, cv)
    out[f"{vh}.conv.weight"] = (hc, C, 1, 1)
    dense(f"{vh}.outcome_q_embed", 2 * hc, cv)
    dense(f"{vh}.outcome_q_output", cv, 14)
    dense(f"{vh}.outcome_mcts_dist", cv, VALUE_BUCKETS)
    out[f"{vh}.conv_ownership.weight"] = (1, hc, 1, 1)
    dense(f"{vh}.gamma_pre", 2 * hc, cv)
    dense(f"{vh}.gamma_output", cv, 1)
    dense(f"{vh}.score_pre_v", 2 * hc, cv)
    dense(f"{vh}.score_output", cv, 1)
    return out


# --- symmetry and hash (the JAX package's conventions) ---

def _zobrist_lane0() -> np.ndarray:
    rng = np.random.default_rng(0x9E3779B97F4A7C15 % (2 ** 32))
    z = rng.integers(0, 2 ** 32, size=(POINTS + 1, 3, 2), dtype=np.uint64)
    return z[:POINTS, :, 0].astype(np.int64)  # [361, 3]: white, empty, black


ZOBRIST_LANE0 = _zobrist_lane0()


def symmetry_index(stones: np.ndarray) -> np.ndarray:
    """int64[N]: the first hash lane of each position mod 8."""
    idx = np.asarray(stones, np.int64) + 1
    picked = ZOBRIST_LANE0[np.arange(POINTS)[None, :], idx]
    return (picked.sum(axis=1) % (2 ** 32)) % 8


def _sym_tables() -> Tuple[np.ndarray, np.ndarray]:
    """(gather, scatter) [8, 361]: symmetry s is a flip across the vertical
    line for s >= 4, then s % 4 quarter turns (np.rot90)."""
    grid = np.arange(POINTS).reshape(BOARD, BOARD)
    gather = np.zeros((8, POINTS), np.int64)
    scatter = np.zeros((8, POINTS), np.int64)
    for s in range(8):
        g = grid[:, ::-1] if s >= 4 else grid
        t = np.rot90(g, k=s % 4).reshape(-1)
        gather[s] = t
        scatter[s][t] = np.arange(POINTS)
    return gather, scatter


SYM_GATHER, SYM_SCATTER = _sym_tables()


def features(stones: np.ndarray, to_move: np.ndarray, last_moves: np.ndarray,
             komi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(planes float32[N, 15, 19, 19], scalars float32[N, 8]) of positions
    already in the frame the network sees."""
    N = stones.shape[0]
    libs = batch_point_liberties(stones)
    c = to_move[:, None]
    own, opp = stones == c, stones == -c
    lm = np.asarray(last_moves, np.int64)
    onehots = np.zeros((N, 5, POINTS), bool)
    on = (lm >= 0) & (lm < POINTS)
    r, j = np.nonzero(on)
    onehots[r, j, lm[r, j]] = True
    planes = np.stack([own, opp, *[onehots[:, i] for i in range(5)],
                       own & (libs == 1), opp & (libs == 1),
                       own & (libs == 2), opp & (libs == 2),
                       own & (libs == 3), opp & (libs == 3),
                       np.zeros_like(own), np.zeros_like(own)], axis=1)
    is_black = (to_move == BLACK).astype(np.float32)
    sign = np.where(to_move == BLACK, -1.0, 1.0)
    scalars = np.concatenate([is_black[:, None], 1.0 - is_black[:, None],
                              (lm == POINTS).astype(np.float32),
                              (sign * komi / 15.0)[:, None]], axis=1)
    return (planes.reshape(N, INPUT_PLANES, BOARD, BOARD).astype(np.float32),
            scalars.astype(np.float32))


# --- the network ---

def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class Evaluation(NamedTuple):
    log_priors: torch.Tensor  # [N, 362]
    value: torch.Tensor  # [N] E[win] - E[loss]
    score_est: torch.Tensor  # [N]
    score_var: torch.Tensor  # [N]
    err_est: torch.Tensor  # [N] sqrt of the q6 error head


class Network:
    """The float32 forward over a dict of parameters (`parameter_shapes`),
    copied to float32 on `device`. `round_fn`, when given, is applied to
    every product's two inputs (the lower-precision control)."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], device, round_fn=None):
        self.cfg = cfg
        self.p = {k: v.detach().to(device=device, dtype=torch.float32)
                  for k, v in params.items()}
        self.round = round_fn or (lambda t: t)
        self.device = device

    def _bn(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.p[f"{name}.weight"], self.p[f"{name}.bias"]
        mean, var = self.p[f"{name}.running_mean"], self.p[f"{name}.running_var"]
        scale = w / torch.sqrt(var + BN_EPS)
        shift = b - mean * scale
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * scale.reshape(shape) + shift.reshape(shape)

    def _conv(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.p[name]
        return F.conv2d(self.round(x), self.round(w), padding=w.shape[-1] // 2)

    def _dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.round(x), self.round(self.p[f"{name}.weight"]),
                        self.p[f"{name}.bias"])

    def _conv_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self._conv(f"{name}.Conv_0.weight", mish(self._bn(f"{name}.BatchNorm_0", x)))

    @staticmethod
    def _pool(x: torch.Tensor) -> torch.Tensor:
        return torch.cat([x.mean(dim=(2, 3)), x.amax(dim=(2, 3))], dim=1)

    def forward(self, planes: torch.Tensor, scalars: torch.Tensor) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        x = self._conv("init_board_conv.weight", planes)
        x = x + self._dense("init_game_layer", scalars)[:, :, None, None]
        for i in range(cfg["blocks"]):
            if is_broadcast(cfg, i):
                p = f"broadcast_res_{i}"
                y = self._conv_block(f"{p}.conv_first", x)
                n, c = y.shape[:2]
                y = self._dense(f"{p}.mix.Dense_0", mish(y).reshape(n, c, POINTS))
                x = x + self._conv_block(f"{p}.conv_last", y.reshape(n, c, BOARD, BOARD))
            else:
                p = f"bottleneck_res_{i}"
                y = self._conv_block(f"{p}.reduce", x)
                for j in range(cfg["inner_bottleneck_layers"]):
                    y = self._conv_block(f"{p}.inner_{j}", y)
                x = x + self._conv_block(f"{p}.expand", y)
        n = x.shape[0]
        # Policy head.
        pp = self._conv("policy_head.conv_p.weight", x)
        g = self._conv("policy_head.conv_g.weight", x)
        g_pooled = self._pool(mish(self._bn("policy_head.gpool.batch_norm_gpool", g)))
        pp = mish(pp + self._dense("policy_head.gpool.Dense_0", g_pooled)[:, :, None, None])
        moves = self._conv("policy_head.output_moves.weight", pp).reshape(n, 2, POINTS)
        pass_logit = self._dense("policy_head.output_pass", g_pooled)[:, 0:1] - 3.0
        pi = torch.cat([moves[:, 0], pass_logit], dim=1)
        # Value head.
        v_pooled = self._pool(self._conv("value_head.conv.weight", x))
        embed = mish(self._dense("value_head.outcome_q_embed", v_pooled))
        go = self._dense("value_head.outcome_q_output", embed)
        gamma = self._dense("value_head.gamma_output",
                            mish(self._dense("value_head.gamma_pre", v_pooled)))
        u = self._dense("value_head.score_pre_v", v_pooled)
        bins = 0.05 * torch.arange(-SCORE_LOGITS // 2, SCORE_LOGITS // 2,
                                   dtype=torch.float32, device=x.device) + 0.025
        h = mish(u[:, None, :] + bins[None, :, None] * self.p["value_head.score_pre_s"][None])
        score = self._dense("value_head.score_output", h)[..., 0]
        score = torch.clamp(F.softplus(gamma), max=10.0) * score
        return {"pi_logits": pi, "outcome_logits": go[:, 0:2], "score_logits": score,
                "q6_err": 4.0 * torch.sigmoid(go[:, 5])}

    def evaluate(self, stones: np.ndarray, to_move: np.ndarray, last_moves: np.ndarray,
                 komi: np.ndarray, block: int = 256) -> Evaluation:
        """Search's view of the network on positions in the board's own
        frame, in blocks of `block` positions."""
        parts = []
        for lo in range(0, stones.shape[0], block):
            sl = slice(lo, lo + block)
            parts.append(self._evaluate(stones[sl], to_move[sl], last_moves[sl], komi[sl]))
        return Evaluation(*[torch.cat(t) for t in zip(*parts)])

    @torch.no_grad()
    def _evaluate(self, stones, to_move, last_moves, komi) -> Evaluation:
        stones = np.asarray(stones, np.int8)
        lm = np.asarray(last_moves, np.int64)
        sym = symmetry_index(stones)
        st = np.take_along_axis(stones, SYM_GATHER[sym], axis=1)
        on = (lm >= 0) & (lm < POINTS)
        lm_s = np.where(on, SYM_SCATTER[sym[:, None], np.clip(lm, 0, POINTS - 1)], lm)
        planes, scalars = features(st, np.asarray(to_move, np.int8), lm_s,
                                   np.asarray(komi, np.float32))
        dev = self.device
        out = self.forward(torch.from_numpy(planes).to(dev), torch.from_numpy(scalars).to(dev))
        pi = out["pi_logits"]
        back = torch.from_numpy(SYM_SCATTER[sym]).to(dev)
        pi = torch.cat([pi[:, :POINTS].gather(1, back), pi[:, POINTS:]], dim=1)
        probs = torch.softmax(out["outcome_logits"], dim=-1)
        sp = torch.softmax(out["score_logits"], dim=-1)
        sv = torch.arange(SCORE_LOGITS, dtype=torch.float32, device=dev) - SCORE_LOGITS // 2 + 0.5
        est = (sp * sv).sum(-1)
        var = ((sp * sv * sv).sum(-1) - est * est).clamp(min=0.0)
        return Evaluation(torch.log_softmax(pi, dim=-1), probs[:, 1] - probs[:, 0], est, var,
                          torch.sqrt(out["q6_err"].clamp(min=0.0)))


def float32_exact():
    """Context for the reference: float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
