"""Per-move search-statistics aggregation and the sel_mult calibration loop
(port of p3achygo_tpu/selfplay/stats.py, a copy).

Mirrors the .stats pipeline:
- cc/recorder/move_search_stats.h:16-33 — the per-move diagnostic record;
- cc/recorder/tf_recorder.cc:313-461 — percentile table + expected-std
  bins + sel_mult_mean written per selfplay batch as a .stats text file;
- python/rl_loop/sel_mult_calibration.py — the RL loop averages .stats
  files per generation into a {field.pct: value} calibration dict, writes
  it as a key=value file, and derives sel_mult_base = 1 / sel_mult_mean so
  the average training-selection probability stays at the base rate.

Here selfplay emits per-move stat rows at harvest time (host side);
`write_stats_file` produces the identical text format, and
`compute_calibration`/`write_calibration_file` reproduce the Python loop.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from p3achygo_tpu_torch.selfplay.move_sel import NUM_STD_BINS, STD_BIN_CAP

# Percentile labels: p01, p05, ..., p95, p99 (tf_recorder.cc:355-361).
PCT_LABELS = ["p01"] + [f"p{i:02d}" for i in range(5, 100, 5)] + ["p99"]
PCT_VALUES = [1.0] + [float(i) for i in range(5, 100, 5)] + [99.0]

STATS_FIELDS = [
    "nn_q", "mcts_q", "nn_mcts_diff", "v_outcome_stddev", "prior_entropy",
    "nn_uncertainty", "kld", "pre_kld", "sel_mult_modifier", "visit_count",
]


@dataclasses.dataclass
class MoveStatsBatch:
    """Columns of per-move diagnostics (each np.float32[M]); rows where
    sampled_raw_policy is True are excluded from every aggregate, like the
    reference's collect_stats filter (tf_recorder.cc:326-337)."""

    sampled_raw_policy: np.ndarray
    nn_q: np.ndarray
    mcts_q: np.ndarray
    nn_mcts_diff: np.ndarray
    v_outcome_stddev: np.ndarray
    prior_entropy: np.ndarray
    nn_uncertainty: np.ndarray
    kld: np.ndarray
    pre_kld: np.ndarray
    sel_mult_modifier: np.ndarray
    sel_mult_modifier_weight: np.ndarray
    visit_count: np.ndarray
    visit_count_pre: np.ndarray

    def __post_init__(self):
        for f in dataclasses.fields(self):
            setattr(self, f.name,
                    np.asarray(getattr(self, f.name)).reshape(-1))

    @staticmethod
    def concatenate(batches: List["MoveStatsBatch"]) -> "MoveStatsBatch":
        assert batches
        return MoveStatsBatch(**{
            f.name: np.concatenate([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(MoveStatsBatch)})


def compute_percentiles(vals: np.ndarray) -> List[float]:
    """Nearest-rank percentiles at PCT_VALUES (tf_recorder.cc:26-41)."""
    vals = np.sort(np.asarray(vals, np.float64))
    n = vals.size
    if n == 0:
        return [0.0] * len(PCT_VALUES)
    # floor(x + 0.5): match C++ std::round (Python's round() is half-to-even)
    idx = [int(np.clip(np.floor(p / 100.0 * (n - 1) + 0.5), 0, n - 1))
           for p in PCT_VALUES]
    return [float(vals[i]) for i in idx]


def _collect(stats: MoveStatsBatch, field: str) -> np.ndarray:
    """Skip sampled-raw-policy, zero, and non-finite values
    (tf_recorder.cc:326-337)."""
    v = getattr(stats, field).astype(np.float64)
    keep = (~stats.sampled_raw_policy.astype(bool)) & (v != 0.0) \
        & np.isfinite(v)
    return v[keep]


def expected_std_bins(stats: MoveStatsBatch) -> np.ndarray:
    """Mean v_outcome_stddev per visit_count_pre bin of 5, n >= 200
    collapsed into the cap bin (tf_recorder.cc:400-428). -> f32[41],
    0 where a bin has no data."""
    out = np.zeros((NUM_STD_BINS,), np.float64)
    cnt = np.zeros((NUM_STD_BINS,), np.int64)
    std = stats.v_outcome_stddev.astype(np.float64)
    npre = stats.visit_count_pre.astype(np.int64)
    keep = (~stats.sampled_raw_policy.astype(bool)) & (std > 0) \
        & np.isfinite(std) & (npre > 0)
    bins = np.minimum(npre[keep] // 5 * 5, STD_BIN_CAP) // 5
    np.add.at(out, bins, std[keep])
    np.add.at(cnt, bins, 1)
    return np.where(cnt > 0, out / np.maximum(cnt, 1), 0.0).astype(np.float32)


def _std_adj_values(stats: MoveStatsBatch, bins: np.ndarray) -> np.ndarray:
    """Self-consistent std_adj values (tf_recorder.cc:430-441): each move's
    stddev divided by its own bin's expected value (no interpolation)."""
    std = stats.v_outcome_stddev.astype(np.float64)
    npre = stats.visit_count_pre.astype(np.int64)
    keep = (~stats.sampled_raw_policy.astype(bool)) & (std > 0) & (npre > 0)
    b = np.minimum(npre // 5 * 5, STD_BIN_CAP) // 5
    expected = bins[np.clip(b, 0, NUM_STD_BINS - 1)]
    vals = np.where(keep & (expected > 0), std / np.maximum(expected, 1e-12),
                    0.0)
    vals = vals[(vals != 0.0) & np.isfinite(vals)]
    return vals


def sel_mult_mean(stats: MoveStatsBatch) -> float:
    """Weighted mean modifier (tf_recorder.cc:448-460)."""
    keep = (~stats.sampled_raw_policy.astype(bool)) \
        & np.isfinite(stats.sel_mult_modifier)
    w = stats.sel_mult_modifier_weight[keep].astype(np.float64)
    m = stats.sel_mult_modifier[keep].astype(np.float64)
    return float(np.sum(w * m) / np.sum(w)) if np.sum(w) > 0 else 1.0


def write_stats_file(path, stats: MoveStatsBatch,
                     freq_weights: Optional[np.ndarray] = None) -> None:
    """Write the .stats text file (tf_recorder.cc:313-461 format)."""
    n_stats = int(stats.nn_q.size)
    lines = [f"# percentiles: p01 p05 p10 ... p95 p99 ({n_stats} moves)"]
    header = f"{'field':<24}" + "".join(f" {l:>9}" for l in PCT_LABELS)
    lines.append(header)

    def row(name, pcts):
        lines.append(f"{name:<24}" + "".join(f" {v:9.6f}" for v in pcts))

    for field in STATS_FIELDS:
        row(field, compute_percentiles(_collect(stats, field)))
    if freq_weights is not None:
        fw = np.asarray(freq_weights, np.float64).reshape(-1)
        fw = fw[(fw != 0.0) & np.isfinite(fw)]
        row("freq_weight", compute_percentiles(fw))

    bins = expected_std_bins(stats)
    row("v_outcome_stddev_adj",
        compute_percentiles(_std_adj_values(stats, bins)))
    for i in range(NUM_STD_BINS):
        if bins[i] > 0:
            lines.append(f"expected_std.n{i * 5}={bins[i]:.6f}")
    lines.append(f"sel_mult_mean={sel_mult_mean(stats):.6f}")
    Path(path).write_text("\n".join(lines) + "\n")


def parse_stats_file(path) -> tuple:
    """-> (percentiles {field: {pct: val}}, metadata {key: val})
    (sel_mult_calibration.py:_parse_stats_file)."""
    percentiles: Dict[str, Dict[str, float]] = {}
    metadata: Dict[str, float] = {}
    labels: List[str] = []
    header_found = False
    for line in Path(path).read_text(errors="replace").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if "=" in line and " " not in line:
            key, _, val = line.partition("=")
            try:
                metadata[key] = float(val)
            except ValueError:
                pass
            continue
        parts = line.split()
        if not header_found:
            if parts[0] == "field":
                labels = parts[1:]
                header_found = True
            continue
        if len(parts) - 1 != len(labels):
            continue
        percentiles[parts[0]] = {
            l: float(v) for l, v in zip(labels, parts[1:])}
    return percentiles, metadata


def compute_calibration(stats_dir, gen: int) -> Optional[Dict[str, float]]:
    """Average all gen{gen:03d}_*.stats files into a flat
    {'field.pct': value, 'expected_std.nN': value, 'sel_mult_mean': value}
    dict (sel_mult_calibration.py:compute_calibration)."""
    files = sorted(Path(stats_dir).glob(f"gen{gen:03d}_*.stats"))
    if not files:
        return None
    pctl_acc: Dict[str, Dict[str, List[float]]] = {}
    meta_acc: Dict[str, List[float]] = {}
    for f in files:
        pctls, meta = parse_stats_file(f)
        for field, labels in pctls.items():
            for label, val in labels.items():
                pctl_acc.setdefault(field, {}).setdefault(label,
                                                          []).append(val)
        for key, val in meta.items():
            meta_acc.setdefault(key, []).append(val)
    calib: Dict[str, float] = {}
    for field, labels in pctl_acc.items():
        for label, vals in labels.items():
            calib[f"{field}.{label}"] = sum(vals) / len(vals)
    for key, vals in meta_acc.items():
        calib[key] = sum(vals) / len(vals)
    return calib or None


def compute_sel_mult_base(calib: Dict[str, float]) -> Optional[float]:
    """1 / sel_mult_mean (sel_mult_calibration.py:compute_sel_mult_base)."""
    mean = calib.get("sel_mult_mean")
    if mean is None or mean <= 0.0:
        return None
    return 1.0 / mean


def write_calibration_file(calib: Dict[str, float], path) -> None:
    with open(path, "w") as f:
        for key, val in sorted(calib.items()):
            f.write(f"{key}={val:.6f}\n")
