"""Discovery by name on the CPU: every cell of BENCHMARK.json is found with
its pieces; a cell, configuration, traffic mix and metric added as files
(and entries) in a copy are found with no other file edited; and nothing
the harness imports is JAX, flax or the JAX package."""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench.harness import cells
from portbench.harness.check import NUMBERS

ROOT = cells.ROOT
FORBIDDEN = ("jax", "jaxlib", "flax", "p3achygo_tpu")


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


def test_a_cell_added_as_files_is_found_without_editing_a_file(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = _digest(root / "portbench")
    pb = root / "portbench"
    cfg = json.loads((pb / "configs" / "b12c128btl3.json").read_text())
    cfg["name"] = "throwaway_cfg"
    (pb / "configs" / "throwaway_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((pb / "traffic" / "refmix.b256.fused.json").read_text())
    mix.update(name="throwaway_mix", batch=64)
    (pb / "traffic" / "throwaway_mix.json").write_text(json.dumps(mix))
    (pb / "metrics" / "throwaway.metric.py").write_text(
        "def read(rec):\n    return rec.window['plies'] * 2.0\n")
    limits = json.loads((pb / "limits" / "sp.b12c128btl3.refmix.b1024.fused.json").read_text())
    (pb / "limits" / "sp.throwaway.json").write_text(json.dumps(limits))
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

    assert "sp.throwaway" in cells.cell_names(str(root))
    cell = cells.load_cell("sp.throwaway", str(root))
    assert cell["config"]["name"] == "throwaway_cfg" and cell["traffic"]["batch"] == 64
    names = [m["name"] for m in cell["per_layer"]]
    assert "throwaway.metric" in names
    assert "trunk_segment.roofline" not in names  # listed for other cells only
    rec = type("Rec", (), {"window": {"plies": 3}})()
    assert cells.metric_reader("throwaway.metric", cell["bench_dir"])(rec) == 6.0
    # The cells that were there keep their pieces.
    assert cells.load_cell("sp.b12c128btl3.refmix.b1024.fused", str(root))["config"]["channels"] == 128
    after = _digest(root / "portbench")
    assert {k: v for k, v in after.items() if k in before} == before


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
