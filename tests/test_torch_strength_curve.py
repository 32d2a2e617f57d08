"""The port's strength-curve run (rl/strength_curve.py) on `tiny`
networks on the CPU: anchor_match plays the eval harness's games between
two networks from a seeded generator, and `main` runs a generation, keeps
the gen-0 anchor, logs generations.jsonl and writes anchors.json."""
import dataclasses
import json
import os

import torch

from p3achygo_tpu_torch.eval.harness import EvalConfig, EvalRunner
from p3achygo_tpu_torch.mcts.gumbel import SearchParams
from p3achygo_tpu_torch.models.config import get_config
from p3achygo_tpu_torch.models.model import build_model, init_params
from p3achygo_tpu_torch.rl import strength_curve
from test_torch_workers import tiny_run_cfg

torch.set_num_threads(2)


def _tiny(seed):
    m = build_model(get_config("tiny"), torch.float32, "cpu")
    init_params(m, torch.Generator().manual_seed(seed))
    return m


def test_anchor_match_is_the_eval_harness():
    cand, cur = _tiny(1), _tiny(2)
    res = strength_curve.anchor_match(cand, cur, num_games=4, n=4, k=2, max_game_len=8,
                                      seed=9)
    want = EvalRunner(EvalConfig(num_games=4, max_game_len=8, search=SearchParams(
        n=4, k=2, noise_scale=1.0, tau=0.0))).run(cand, cur, torch.Generator().manual_seed(9))
    assert dataclasses.asdict(res) == dataclasses.asdict(want)
    assert res.num_games == 4 and 0.0 <= res.cand_wins <= 4


def test_main_writes_the_curve_and_anchors(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(dataclasses.asdict(tiny_run_cfg(eval_games=2, eval_max_game_len=6))))
    run = tmp_path / "run"
    strength_curve.main(["--config", str(cfg), "--run-dir", str(run), "--gens", "1",
                         "--anchor-games", "2", "--device", "cpu"])
    assert os.path.exists(run / "gen0" / "state.pt")
    rows = [json.loads(x) for x in open(run / "generations.jsonl")]
    assert [r["gen"] for r in rows] == [1]
    anchors = json.load(open(run / "anchors.json"))
    assert set(anchors) == {"final_vs_gen0", "final_vs_mid", "mid_vs_gen0"}
    assert all(a["games"] == 2 and 0 <= a["wins"] <= 2 for a in anchors.values())
    assert "anchors written" in capsys.readouterr().out
    # A second call resumes at gen 1 and only replays the anchors.
    strength_curve.main(["--config", str(cfg), "--run-dir", str(run), "--gens", "1",
                         "--anchor-games", "2", "--anchors-only", "--device", "cpu"])
    assert "resumed=True" in capsys.readouterr().out
