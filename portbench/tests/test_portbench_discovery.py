"""Discovery by name on the CPU: every cell of BENCHMARK.json is found with
its pieces; a cell of another trunk type (classic), with its
configuration, traffic mix, limits, metric and reference trunk added as
files (and entries) in a copy, is found with no other file edited and
runs end to end, correct as it stands and not correct with a trunk weight
of the program altered; and nothing the harness imports is JAX, flax or
the JAX package."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from portbench.harness import cells, work
from portbench.harness.check import NUMBERS
from portbench.harness.runner import run_cell

ROOT = cells.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "p3achygo_tpu")
SEED = 2 ** 31 + 5151

# p3achygo's classic trunk (python/model.py ClassicResidualBlock): x plus two
# KxK conv blocks at C, a broadcast block every broadcast_interval-th.
CLASSIC_TRUNK = '''"""The classic trunk, as a trunk module of reference/network.py."""
from collections import OrderedDict

from portbench.harness.work import broadcast_work
from portbench.reference import network
from portbench.reference.network import POINTS, conv_block_shapes
from portbench.reference.trunks.btl import broadcast_block, broadcast_shapes, is_broadcast

draw_rule = network.draw_rule


def parameter_shapes(cfg):
    out = OrderedDict()
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            broadcast_shapes(out, f"broadcast_res_{i}", cfg["channels"])
            continue
        for j in range(2):
            conv_block_shapes(out, f"classic_res_{i}.conv_{j}", cfg["channels"],
                              cfg["channels"], cfg["conv_size"])
    return out


def forward(net, cfg, x):
    for i in range(cfg["blocks"]):
        if is_broadcast(cfg, i):
            x = broadcast_block(net, f"broadcast_res_{i}", x)
            continue
        y = x
        for j in range(2):
            y = net._conv_block(f"classic_res_{i}.conv_{j}", y)
        x = x + y
    return x


def flops(cfg):
    C, k = cfg["channels"], cfg["conv_size"]
    return sum(broadcast_work(1, C)[0] if is_broadcast(cfg, i) else 2 * 2 * POINTS * k * k * C * C
               for i in range(cfg["blocks"]))


def head_width(cfg):
    return cfg["channels"]
'''
TINY_CLASSIC = {"name": "throwaway_cfg", "trunk_block_type": "classic", "blocks": 4,
                "conv_size": 3, "broadcast_interval": 3, "channels": 16, "head_channels": 8,
                "c_val": 16, "dtype": "bfloat16"}
# bf16 on the CPU at this size reads a few hundredths at most: the limits
# keep a margin (as test_portbench_faults.py's).
TINY_LIMITS = {"rules_mismatches": 0, "search_mismatches": 0, "pi_illegal_mass": 0.0,
               "leaf_logp_gap": 0.1, "leaf_logp_q75": 0.05, "leaf_value_gap": 0.05,
               "leaf_value_q75": 0.02}
CHECK = {"boards": 6, "leaf_call_every": 2, "leaf_rows_per_call": 4, "leaf_rows_max": 64}


def test_every_cell_of_the_benchmark_is_found_with_its_pieces():
    bench = cells.load_benchmark()
    names = cells.cell_names()
    assert names == [w["name"] for w in bench["workloads"]] and len(names) >= 1
    for name in names:
        cell = cells.load_cell(name)
        assert cell["config"]["name"] == cell["workload"]["config"]
        assert cell["traffic"]["name"] == cell["workload"]["traffic"]
        assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s", "selfplay_moves_per_s"}
        assert cell["per_layer"], name
        for m in cell["per_layer"]:
            assert callable(cells.metric_reader(m["name"]))
        assert set(cell["limits"]) <= set(NUMBERS)
        assert cell["limits"]["rules_mismatches"] == 0 and cell["limits"]["pi_illegal_mass"] == 0
    for c in bench["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))


def _digest(root):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            p = os.path.join(base, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _checkout_with_a_classic_cell(tmp_path):
    """A copy of the benchmark with the cell "sp.throwaway" added as files
    and entries: a tiny classic configuration, its reference trunk, a mix
    at batch 8 through the plain route, its limits and a metric. Returns
    (root, the digests of the copy's files before the additions)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "portbench")
    pb = root / "portbench"
    (pb / "configs" / "throwaway_cfg.json").write_text(json.dumps(TINY_CLASSIC))
    (pb / "reference" / "trunks" / "classic.py").write_text(CLASSIC_TRUNK)
    mix = json.loads((pb / "traffic" / "refmix.b1024.plain.json").read_text())
    mix.update(name="throwaway_mix", batch=8, warm_plies=2, reset_every=2, start_plies_max=60,
               selected={"n": 8, "k": 4}, fast={"n": 4, "k": 2})
    (pb / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "throwaway.metric.py").write_text(
        "def read(rec):\n    return rec.window['plies'] * 2.0\n")
    (pb / "limits" / "sp.throwaway.json").write_text(json.dumps(TINY_LIMITS))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "throwaway_cfg", "source": "https://example.org",
                             "file": "portbench/configs/throwaway_cfg.json", "reduced": [],
                             "why": "test"})
    bench["workloads"].append({"name": "sp.throwaway", "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "throwaway.metric", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "selfplay_moves_per_s", "workloads": ["sp.throwaway"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, before


def run_throwaway(root, **kw):
    logs = []
    res = run_cell(cells.load_cell("sp.throwaway", str(root)), SEED, 0.05, False,
                   torch.device("cpu"), time.perf_counter(), logs.append, check=CHECK, **kw)
    return res, logs


def test_a_cell_added_as_files_is_found_without_editing_a_file(tmp_path):
    root, before = _checkout_with_a_classic_cell(tmp_path)
    assert "sp.throwaway" in cells.cell_names(str(root))
    cell = cells.load_cell("sp.throwaway", str(root))
    assert cell["config"]["name"] == "throwaway_cfg" and cell["traffic"]["batch"] == 8
    names = [m["name"] for m in cell["per_layer"]]
    assert "throwaway.metric" in names
    assert "trunk_segment.roofline" not in names  # listed for other cells only
    rec = type("Rec", (), {"window": {"plies": 3}})()
    assert cells.metric_reader("throwaway.metric", cell["bench_dir"])(rec) == 6.0
    # The cells that were there keep their pieces.
    assert cells.load_cell("sp.b12c128btl3.refmix.b1024.fused", str(root))["config"]["channels"] == 128
    # The classic trunk is found by the configuration's trunk_block_type,
    # counted, and run end to end through the program and the check.
    assert cells.trunk_module(cell["config"], cell["bench_dir"]).__file__.endswith("classic.py")
    trunk = 3 * 2 * 2 * 361 * 9 * 16 * 16 + work.broadcast_work(1, 16)[0]
    no_trunk = work.model_flops({**TINY_CLASSIC, "blocks": 0}, cell["bench_dir"])
    assert work.model_flops(cell["config"], cell["bench_dir"]) == no_trunk + trunk
    res, logs = run_throwaway(root)
    assert res["correct"], (res["checks"], logs)
    assert res["checks"]["leaf_logp_gap"]["value"] > 0  # bf16 against float32
    after = _digest(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_fault_in_a_trunk_weight_of_an_added_cell_fails_the_check(tmp_path, monkeypatch):
    """The program's first classic conv kernel scaled by 1.5 after the
    weights are loaded: the reference, on the weights as drawn, tells."""
    from p3achygo_tpu_torch.mcts import gumbel

    root, _ = _checkout_with_a_classic_cell(tmp_path)
    make_eval_fn = gumbel.make_eval_fn

    def altered(model, **kw):
        with torch.no_grad():
            model.classic_res_0.conv_0.Conv_0.weight.mul_(1.5)
        return make_eval_fn(model, **kw)

    monkeypatch.setattr(gumbel, "make_eval_fn", altered)
    res, logs = run_throwaway(root)
    assert not res["correct"], res["checks"]
    assert res["checks"]["rules_mismatches"]["value"] == 0


def test_the_harness_imports_no_jax():
    """In a fresh process: the entry point, the harness, every metric
    reader and the program's modules that a run drives."""
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
import portbench.run as run
from portbench.harness import cells, cellrun, check, runner, trace, weights, work
from portbench.reference import network, rules
for name in cells.cell_names():
    cell = cells.load_cell(name)
    cells.trunk_module(cell["config"])
    for m in cell["per_layer"]:
        cells.metric_reader(m["name"])
import p3achygo_tpu_torch.selfplay.loop, p3achygo_tpu_torch.mcts.gumbel
import p3achygo_tpu_torch.models.model, p3achygo_tpu_torch.nn.serve_q
import p3achygo_tpu_torch.nn.trunk_kernel, p3achygo_tpu_torch.game.board
print(sorted({{m.split(".")[0] for m in sys.modules}} & set({FORBIDDEN!r})))
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "[]"], out.stdout


def test_the_guard_compares_whole_top_level_names():
    import portbench.run as run

    assert run.forbidden_modules(["p3achygo_tpu_torch.ops.trunk", "jaxtyping", "flaxen"]) == []
    assert run.forbidden_modules(["p3achygo_tpu.models", "jax.numpy", "flax"]) == [
        "flax", "jax", "p3achygo_tpu"]
