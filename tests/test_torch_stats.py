"""The port's .stats pipeline and sel_mult calibration
(p3achygo_tpu_torch/selfplay/stats.py, move_sel.calibration_from_dict)
held against the JAX package: the .stats and calibration files byte for
byte, their parse, the per-generation calibration dict and sel_mult base
equal, and the calibration the port builds from the dict equal to the JAX
one in float32, down to the move-selection modifiers it gives."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.selfplay import move_sel as jms
from p3achygo_tpu.selfplay import stats as jstats
from p3achygo_tpu_torch.selfplay import move_sel as tms
from p3achygo_tpu_torch.selfplay import stats as tstats

torch.set_num_threads(2)


def _batch(mod, seed: int, M: int = 400):
    """Per-move stats of M moves with raw-policy rows, zeros and the odd
    non-finite value, as harvests produce them."""
    rng = np.random.default_rng(seed)
    f = lambda lo, hi: rng.uniform(lo, hi, M).astype(np.float32)
    cols = dict(
        sampled_raw_policy=rng.random(M) < 0.2, nn_q=f(-1, 1), mcts_q=f(-1, 1),
        nn_mcts_diff=f(0, 0.8), v_outcome_stddev=f(0, 0.5), prior_entropy=f(0, 5),
        nn_uncertainty=f(0, 0.3), kld=f(0, 2), pre_kld=f(0, 1.5),
        sel_mult_modifier=f(0.3, 2.5), sel_mult_modifier_weight=f(0, 1),
        visit_count=rng.integers(0, 130, M).astype(np.float32),
        visit_count_pre=rng.integers(0, 260, M).astype(np.float32))
    for k in ("pre_kld", "nn_mcts_diff", "v_outcome_stddev"):
        cols[k][rng.random(M) < 0.1] = 0.0
    cols["kld"][3] = np.nan
    return mod.MoveStatsBatch(**cols)


def test_stats_constants_match_jax():
    assert tstats.PCT_LABELS == jstats.PCT_LABELS and tstats.PCT_VALUES == jstats.PCT_VALUES
    assert tstats.STATS_FIELDS == jstats.STATS_FIELDS
    assert (tms.NUM_STD_BINS, tms.STD_BIN_CAP) == (jms.NUM_STD_BINS, jms.STD_BIN_CAP)


@pytest.mark.parametrize("seed", [0, 1])
def test_stats_file_byte_equal(tmp_path, seed):
    parts_t = [_batch(tstats, seed * 10 + i) for i in range(3)]
    parts_j = [_batch(jstats, seed * 10 + i) for i in range(3)]
    st, sj = tstats.MoveStatsBatch.concatenate(parts_t), jstats.MoveStatsBatch.concatenate(parts_j)
    fw = np.random.default_rng(seed).uniform(0.5, 1.5, 50)
    for kw in ({}, {"freq_weights": fw}):
        tstats.write_stats_file(tmp_path / "t.stats", st, **kw)
        jstats.write_stats_file(tmp_path / "j.stats", sj, **kw)
        assert (tmp_path / "t.stats").read_bytes() == (tmp_path / "j.stats").read_bytes()
        assert tstats.parse_stats_file(tmp_path / "t.stats") == \
            jstats.parse_stats_file(tmp_path / "j.stats")
    np.testing.assert_array_equal(tstats.expected_std_bins(st), jstats.expected_std_bins(sj))
    assert tstats.sel_mult_mean(st) == jstats.sel_mult_mean(sj)


def test_calibration_matches_jax(tmp_path):
    """compute_calibration over two generations' files, sel_mult base,
    the calibration file, and calibration_from_dict in float32."""
    dirs = {}
    for name, mod in (("t", tstats), ("j", jstats)):
        d = tmp_path / name
        d.mkdir()
        for gen in (0, 1):
            for w in range(2):
                mod.write_stats_file(d / f"gen{gen:03d}_b000_g000_n00400_t{w}_w{w}.stats",
                                     _batch(mod, 7 + 3 * gen + w))
        dirs[name] = d
    for gen in (0, 1):
        ct = tstats.compute_calibration(dirs["t"], gen)
        cj = jstats.compute_calibration(dirs["j"], gen)
        assert ct == cj and any(k.startswith("expected_std.n") for k in ct)
        assert tstats.compute_sel_mult_base(ct) == jstats.compute_sel_mult_base(cj)
        tstats.write_calibration_file(ct, tmp_path / "t.txt")
        jstats.write_calibration_file(cj, tmp_path / "j.txt")
        assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
    assert tstats.compute_calibration(dirs["t"], 5) is None
    assert tstats.compute_sel_mult_base({"sel_mult_mean": 0.0}) is None
    assert tstats.compute_sel_mult_base({}) is None


def _calib_dicts():
    with_bins = {"pre_kld.p05": 0.002, "pre_kld.p70": 0.41, "pre_kld.p95": 1.3,
                 "nn_mcts_diff.p70": 0.2, "nn_mcts_diff.p99": 0.71,
                 "v_outcome_stddev_adj.p01": 0.1, "v_outcome_stddev_adj.p50": 0.9,
                 "v_outcome_stddev_adj.p80": 1.3, "v_outcome_stddev_adj.p99": 3.3,
                 "expected_std.n0": 0.31, "expected_std.n5": 0.27, "expected_std.n40": 0.2,
                 "expected_std.n200": 0.1, "expected_std.n7": 9.0, "expected_std.nx": 9.0,
                 "expected_std.n205": 9.0, "sel_mult_mean": 1.1}
    return [{}, with_bins, {"pre_kld.p70": 0.1, "nn_mcts_diff.p99": 1 / 3}]


@pytest.mark.parametrize("case", range(3))
def test_calibration_from_dict_matches_jax(case):
    calib = _calib_dicts()[case]
    t, j = tms.calibration_from_dict(calib), jms.calibration_from_dict(calib)
    for f in t._fields:
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        np.testing.assert_array_equal(np.asarray(a, np.float32), b, err_msg=f)
        assert a == float(b) if f != "expected_std_by_n" else a.dtype == torch.float32
    # The modifiers it gives on the same pre-search signals, float32.
    rng = np.random.default_rng(case)
    B = 256
    n_pre = rng.integers(0, 260, B).astype(np.int32)
    sig = [rng.uniform(0, hi, B).astype(np.float32) for hi in (0.6, 1.6, 0.9)]
    for s in sig:
        s[rng.random(B) < 0.1] = 0.0
    q = rng.uniform(-1, 1, B).astype(np.float32)
    got = tms.compute_move_sel(torch.from_numpy(n_pre), *map(torch.from_numpy, sig),
                               torch.from_numpy(q), 1.0, t)
    want = jms.compute_move_sel(jnp.asarray(n_pre), *map(jnp.asarray, sig), jnp.asarray(q),
                                1.0, j)
    for f in ("modifier", "sel_bonus", "sel_penalty", "std_adj"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_move_stats_batch_concatenate():
    parts = [_batch(tstats, i, M=5 + i) for i in range(3)]
    cat = tstats.MoveStatsBatch.concatenate(parts)
    assert cat.nn_q.shape == (18,)
    for f in dataclasses.fields(tstats.MoveStatsBatch):
        np.testing.assert_array_equal(getattr(cat, f.name)[:5], getattr(parts[0], f.name))
