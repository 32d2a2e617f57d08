"""Move-selection multiplier (sel_mult) signals, [B]-vectorized (port of
p3achygo_tpu/selfplay/move_sel.py; reference
cc/selfplay/move_sel_manager.h:39-177 and SelMultCalibration,
self_play_thread.h:23-36)."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# MoveSelFlags (move_sel_manager.h:11-17).
STDDEV_BONUS = 1 << 0
STDDEV_PENALTY = 1 << 1
KLD_BONUS = 1 << 2
KLD_PENALTY = 1 << 3
NN_MCTS_BONUS = 1 << 4
DEFAULT_FLAGS = NN_MCTS_BONUS | KLD_PENALTY  # self_play_thread.cc:315-316

STD_BIN_CAP = 200
NUM_STD_BINS = STD_BIN_CAP // 5 + 1  # 41


class SelMultCalibration(NamedTuple):
    """Per-generation percentile thresholds (scalars as Python floats);
    `expected_std_by_n[i]` is the mean pre-search stddev for visit bin 5*i
    (0 = no data)."""

    std_adj_p01: float
    std_adj_p50: float
    std_adj_p80: float
    std_adj_p99: float
    pre_kld_p05: float
    pre_kld_p70: float
    pre_kld_p95: float
    nn_mcts_p70: float
    nn_mcts_p99: float
    expected_std_by_n: torch.Tensor  # f32[NUM_STD_BINS]


def default_calibration() -> SelMultCalibration:
    """The reference's hardcoded fallbacks (move_sel_manager.h:128-172)."""
    return SelMultCalibration(
        std_adj_p01=0.02, std_adj_p50=0.64, std_adj_p80=1.52, std_adj_p99=4.96,
        pre_kld_p05=0.0001, pre_kld_p70=0.310, pre_kld_p95=1.166,
        nn_mcts_p70=0.1463, nn_mcts_p99=0.6500,
        expected_std_by_n=torch.zeros(NUM_STD_BINS, dtype=torch.float32))


def calibration_from_dict(calib: dict) -> SelMultCalibration:
    """A SelMultCalibration from a flat {'field.pct': value} dict (the
    format the calibration loop writes; main.cc ParseCalibrationFile
    :71-121). Missing keys keep the defaults; values round to float32, as
    the JAX package stores them."""
    d = default_calibration()
    g = lambda key, dflt: float(np.float32(calib.get(key, dflt)))
    expected = np.zeros((NUM_STD_BINS,), np.float32)
    for key, val in calib.items():
        if key.startswith("expected_std.n"):
            try:
                bin_n = int(key[len("expected_std.n"):])
            except ValueError:
                continue
            if 0 <= bin_n <= STD_BIN_CAP and bin_n % 5 == 0:
                expected[bin_n // 5] = val
    return SelMultCalibration(
        std_adj_p01=g("v_outcome_stddev_adj.p01", d.std_adj_p01),
        std_adj_p50=g("v_outcome_stddev_adj.p50", d.std_adj_p50),
        std_adj_p80=g("v_outcome_stddev_adj.p80", d.std_adj_p80),
        std_adj_p99=g("v_outcome_stddev_adj.p99", d.std_adj_p99),
        pre_kld_p05=g("pre_kld.p05", d.pre_kld_p05),
        pre_kld_p70=g("pre_kld.p70", d.pre_kld_p70),
        pre_kld_p95=g("pre_kld.p95", d.pre_kld_p95),
        nn_mcts_p70=g("nn_mcts_diff.p70", d.nn_mcts_p70),
        nn_mcts_p99=g("nn_mcts_diff.p99", d.nn_mcts_p99),
        expected_std_by_n=torch.from_numpy(expected),
    )


class MoveSelResult(NamedTuple):
    modifier: torch.Tensor
    modifier_unscaled: torch.Tensor
    sel_bonus: torch.Tensor
    sel_penalty: torch.Tensor
    sel_std_bonus: torch.Tensor
    sel_std_penalty: torch.Tensor
    sel_kld_bonus: torch.Tensor
    sel_kld_penalty: torch.Tensor
    sel_nn_mcts_bonus: torch.Tensor
    sel_q_adjust: torch.Tensor
    std_adj: torch.Tensor
    std_adj_att: torch.Tensor


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _expected_std(n_pre: torch.Tensor, calib: SelMultCalibration) -> torch.Tensor:
    """4-nearest-populated-bin interpolation of expected_std_by_n
    (move_sel_manager.h:76-105); 0 when the table is empty. Ties at equal
    distance go to the lower bin."""
    dev = n_pre.device
    vals = calib.expected_std_by_n.to(dev)
    bins = torch.arange(NUM_STD_BINS, dtype=torch.int32, device=dev) * 5
    query = torch.clamp((n_pre // 5) * 5, max=STD_BIN_CAP)
    dist = (bins[None, :] - query[:, None]).abs().float()
    score = torch.where((vals > 0.0)[None, :], -dist, -torch.inf)
    order = torch.sort(score, dim=1, descending=True, stable=True).indices[:, :4]
    top = score.gather(1, order)
    usable = torch.isfinite(top)
    d = torch.where(usable, -top, 0.0)
    w = torch.where(usable, 1.0 / (d + 5.0), 0.0)
    v = vals[order]
    sum_w = w.sum(dim=1)
    return torch.where(sum_w > 0, (w * v).sum(dim=1) / sum_w.clamp(min=1e-10), 0.0)


def compute_move_sel(n_pre: torch.Tensor, std_dev: torch.Tensor,
                     pre_kld: torch.Tensor, nn_mcts_diff: torch.Tensor,
                     q_canonical: torch.Tensor, sel_mult_scale_factor: float,
                     calib: SelMultCalibration,
                     flags: int = DEFAULT_FLAGS) -> MoveSelResult:
    """MoveSelManager::Compute (move_sel_manager.h:39-73)."""
    c = lambda x: _f32(x, std_dev)
    expected = _expected_std(n_pre, calib)
    std_adj = torch.where((std_dev > 0) & (expected > 0),
                          std_dev / expected.clamp(min=1e-10), 0.0)
    att = torch.clamp(0.2 + 0.8 * torch.pow(
        n_pre.float().clamp(min=0.0) / 40.0, 0.54), max=1.0)
    std_adj_att = torch.where(std_adj == 0.0, 0.0, 1.0 + (std_adj - 1.0) * att)
    base = 1.0 - torch.clamp((q_canonical.abs() - 0.5) / 0.4, 0.0, 1.0)
    sel_q_adjust = torch.pow(base.clamp(min=0.0), 0.4)

    sa = std_adj_att
    lb, ub = c(calib.std_adj_p80), c(calib.std_adj_p99)
    std_bonus = torch.where((sa == 0.0) | (sa <= lb) | (ub <= lb), 1.0,
                            1.0 + 0.5 * (sa - lb) / (ub - lb).clamp(min=1e-10))
    lb, ub = c(calib.std_adj_p01), c(calib.std_adj_p50)
    floor = 0.3
    std_penalty = torch.where(
        sa == 0.0, 1.0,
        torch.where(sa >= ub, 1.0,
                    torch.where((sa <= lb) | (ub <= lb), floor,
                                1.0 - (1.0 - floor) * (ub - sa)
                                / (ub - lb).clamp(min=1e-10))))
    lb, ub = c(calib.pre_kld_p70), c(calib.pre_kld_p95)
    kld_bonus = torch.where(
        (pre_kld == 0.0) | (pre_kld <= lb) | (ub <= lb), 1.0,
        torch.clamp(1.0 + 0.5 * (pre_kld - lb) / (ub - lb).clamp(min=1e-10),
                    max=1.5))
    lb, kub = c(calib.pre_kld_p05), c(0.06)
    kld_penalty = torch.where(
        (pre_kld == 0.0) | (pre_kld >= kub), 1.0,
        torch.where((pre_kld <= lb) | (kub <= lb), floor,
                    1.0 - (1.0 - floor) * (kub - pre_kld)
                    / (kub - lb).clamp(min=1e-10)))
    lb, ub = c(calib.nn_mcts_p70), c(calib.nn_mcts_p99)
    nn_mcts_bonus = torch.where(
        (nn_mcts_diff == 0.0) | (nn_mcts_diff <= lb) | (ub <= lb), 1.0,
        1.0 + 0.60 * (nn_mcts_diff - lb) / (ub - lb).clamp(min=1e-10))

    one = torch.ones_like(std_bonus)
    raw_bonus = torch.clamp(torch.maximum(
        torch.maximum(std_bonus if flags & STDDEV_BONUS else one,
                      kld_bonus if flags & KLD_BONUS else one),
        nn_mcts_bonus if flags & NN_MCTS_BONUS else one), max=2.5)
    raw_penalty = torch.minimum(std_penalty if flags & STDDEV_PENALTY else one,
                                kld_penalty if flags & KLD_PENALTY else one)
    sel_bonus = 1.0 + sel_q_adjust * (raw_bonus - 1.0)
    sel_penalty = 1.0 + sel_q_adjust * (raw_penalty - 1.0)
    modifier_unscaled = sel_bonus * sel_penalty
    modifier = 1.0 + sel_mult_scale_factor * (modifier_unscaled - 1.0)
    return MoveSelResult(
        modifier=modifier, modifier_unscaled=modifier_unscaled,
        sel_bonus=sel_bonus, sel_penalty=sel_penalty,
        sel_std_bonus=std_bonus, sel_std_penalty=std_penalty,
        sel_kld_bonus=kld_bonus, sel_kld_penalty=kld_penalty,
        sel_nn_mcts_bonus=nn_mcts_bonus, sel_q_adjust=sel_q_adjust,
        std_adj=std_adj, std_adj_att=std_adj_att)
