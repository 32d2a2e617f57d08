"""The controls. On the CPU: the "e4m3" route rounds what it should and
gives other outputs than the plain route, on a btl and on a transformer
network, and control.py refuses "serveq" on a transformer, where the
program serves the plain forward in its place. On the card: the check
passes the program as each cell runs it and fails its lower-precision
controls, the program's own int8 serving path and e4m3, at a batch a test
run holds (64 boards; the cells' own sizes are measured by
portbench/control.py, PERF.md gives the readings).

    python -m pytest -o addopts= -p no:cacheprovider -m cuda portbench/tests -q
"""
from __future__ import annotations

import copy

import pytest
import torch

from portbench.control import readings, same_forward
from portbench.harness.cellrun import build_eval_fn, start_positions, to_e4m3
from portbench.harness.cells import cell_names, load_cell
from portbench.harness.weights import make_weights

SEEDS = (2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303)
CPU = torch.device("cpu")

# The transformer trunk's parameters and their draws (models/transformer.py's
# names, flax's projection layouts), as a trunk module: enough for the
# weights; these tests run no reference forward of it.
TRANSFORMER_WEIGHTS = '''from collections import OrderedDict

from portbench.reference import network
from portbench.reference.network import BOARD, dense_shapes


def parameter_shapes(cfg):
    C, E, H = cfg["channels"], cfg["embed_dim"], cfg["num_heads"]
    out = OrderedDict()
    dense_shapes(out, "embed", C, E)
    out["pos_embed.pos_embed"] = (BOARD, BOARD, E)
    for i in range(cfg["blocks"]):
        p = f"transformer_{i}"
        for s in ("weight", "bias"):
            out[f"{p}.LayerNorm_0.{s}"] = (E,)
        a = f"{p}.MultiHeadDotProductAttention_0"
        for proj in ("query", "key", "value"):
            out[f"{a}.{proj}.weight"] = (E, H, E // H)
            out[f"{a}.{proj}.bias"] = (H, E // H)
        out[f"{a}.out.weight"] = (H, E // H, E)
        out[f"{a}.out.bias"] = (E,)
        for s in ("weight", "bias"):
            out[f"{p}.LayerNorm_1.{s}"] = (E,)
        dense_shapes(out, f"{p}.Dense_0", E, 4 * E)
        dense_shapes(out, f"{p}.Dense_1", 4 * E, E)
    return out


def draw_rule(name, shape):
    if ".LayerNorm_" in name:
        return ("stat", name.rsplit(".", 1)[-1])
    if name.endswith(("query.weight", "key.weight", "value.weight")):
        return ("fan_in", shape[0])
    if name.endswith("out.weight"):
        return ("fan_in", shape[0] * shape[1])
    if name.startswith("pos_embed"):
        return ("scale", 0.02)
    return network.draw_rule(name, shape)


def head_width(cfg):
    return cfg["embed_dim"]
'''


def tiny_cell(tmp_path, transformer: bool) -> dict:
    """A cell dict at a CPU's size: btl (the benchmark's own trunk file) or
    a transformer (trunk file above, in `tmp_path`)."""
    cell = copy.deepcopy(load_cell("sp.b12c128btl3.refmix.b1024.plain"))
    cell["traffic"].update(batch=8, start_plies_max=60)
    if transformer:
        trunks = tmp_path / "reference" / "trunks"
        trunks.mkdir(parents=True)
        (trunks / "transformer.py").write_text(TRANSFORMER_WEIGHTS)
        cell["bench_dir"] = str(tmp_path)
        cell["config"] = {"trunk_block_type": "transformer", "is_transformer": True,
                          "blocks": 2, "conv_size": 3, "channels": 16, "embed_dim": 16,
                          "num_heads": 2, "head_channels": 8, "c_val": 16}
    else:
        cell["config"].update(blocks=6, broadcast_interval=4, inner_bottleneck_layers=1,
                              channels=16, bottleneck_channels=8, head_channels=8, c_val=16)
    return cell


def test_e4m3_keeps_its_grid_and_rounds_the_rest():
    exact = torch.tensor([448.0, -448.0, 1.0, 0.5, -3.5, 0.0])
    assert torch.equal(to_e4m3(exact), exact)
    x = torch.randn(4096, generator=torch.Generator().manual_seed(1)) * 3
    err = (to_e4m3(x) - x).abs()
    assert err.max() > 0
    big = x.abs() > x.abs().max() / 2 ** 6  # normal range: 3 mantissa bits
    assert (err[big] <= x.abs()[big] * 2 ** -4).all()
    assert to_e4m3(x.to(torch.bfloat16)).dtype == torch.bfloat16


@pytest.mark.parametrize("transformer", [False, True], ids=["btl", "transformer"])
def test_the_e4m3_route_differs_from_the_plain_route(tmp_path, transformer):
    from p3achygo_tpu_torch.game.board import from_stones

    cell = tiny_cell(tmp_path, transformer)
    seed = SEEDS[0]
    params = make_weights(cell["config"], seed, CPU, cell["bench_dir"])
    drawn = {k: v.clone() for k, v in params.items()}
    plain_model, plain = build_eval_fn(cell, params, "plain", seed, CPU)
    e4m3_model, e4m3 = build_eval_fn(cell, params, "e4m3", seed, CPU)
    # The model's own copy is rounded; the dict the reference reads is not.
    assert all(torch.equal(params[k], drawn[k]) for k in params)
    conv = "init_board_conv.weight"
    assert not torch.equal(e4m3_model.state_dict()[conv], plain_model.state_dict()[conv])
    st, tm = start_positions(8, 60, seed)
    states = from_stones(torch.from_numpy(st), 7.5, torch.from_numpy(tm), device=CPU)
    a, b = plain(states), e4m3(states)
    gap = (a.log_priors - b.log_priors).abs().max()
    assert gap > 0 and torch.isfinite(b.log_priors).all(), gap
    assert not same_forward(cell, "e4m3", seed, CPU)


def test_serveq_on_a_transformer_is_refused(tmp_path):
    """make_eval_fn serves the plain forward where the int8 path does not
    take the configuration: the "control" would be the sound run."""
    assert same_forward(tiny_cell(tmp_path, True), "serveq", SEEDS[1], CPU)


def small(name):
    cell = copy.deepcopy(load_cell(name))
    cell["traffic"]["batch"] = 64
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", cell_names())
def test_program_passes_and_int8_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cell = small(name)
    sound = readings(name, SEEDS[:2], 3.0, None, dev, cell=cell, check={"boards": 32})
    assert all(ok for _, ok, _, _ in sound), sound
    control = readings(name, SEEDS, 3.0, "serveq", dev, cell=cell, check={"boards": 32})
    assert not any(ok for _, ok, _, _ in control), control


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sp.b12c128btl3.refmix.b1024.plain",
                                  "sp.b12c128btl3.refmix.b1024.fused"])
def test_e4m3_control_fails(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    cell = small(name)
    assert not same_forward(cell, "e4m3", SEEDS[0], dev)
    control = readings(name, SEEDS, 3.0, "e4m3", dev, cell=cell, check={"boards": 32})
    assert not any(ok for _, ok, _, _ in control), control
