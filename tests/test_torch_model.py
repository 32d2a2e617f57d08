"""Network of the PyTorch port held against the JAX package in float32:
the bridged `tiny` model (all 25 outputs and the folded serving forward)
and the committed trained golden results/curve-r4/model_0016 (b8c64)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p3achygo_tpu.models import build_model as jax_build
from p3achygo_tpu.models import get_config as jax_get_config
from p3achygo_tpu.models.config import _CONFIGS as JAX_CONFIGS
from p3achygo_tpu.nn.serve import serve_forward as jax_serve
from p3achygo_tpu_torch.bridge import flax_to_state_dict, load_flax_variables
from p3achygo_tpu_torch.models.config import _CONFIGS, get_config
from p3achygo_tpu_torch.models.model import ModelOutputs, build_model, init_params
from p3achygo_tpu_torch.nn.serve import serve_forward

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "results", "curve-r4", "model_0016")
SERVED = ("pi_logits", "outcome_logits", "outcome_probs", "score_logits",
          "score_probs", "gamma", "q6_err")


def _numpy_vars(variables, rng=None):
    """flax variables -> numpy; with `rng`, BN statistics and affine
    parameters are perturbed so the BN fold is not an identity."""
    def conv(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = conv(v)
                continue
            a = np.asarray(v, np.float32)
            if rng is not None and k in ("mean", "bias", "scale"):
                a = a + rng.normal(0, 0.1, a.shape).astype(np.float32)
            elif rng is not None and k == "var":
                a = a * rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
            out[k] = a
        return out
    return {"params": conv(variables["params"]),
            "batch_stats": conv(variables["batch_stats"])}


def _jax_init(jm, seed):
    return jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 19, 19, 15)), jnp.zeros((1, 8)),
        train=False)


def _jax_apply(jm, v, planes, scalars):
    return jax.jit(lambda v, p, s: jm.apply(v, p, s, train=False))(v, planes, scalars)


def _jax_serve(jm, v, planes, scalars):
    return jax.jit(lambda v, p, s: jax_serve(jm, v, p, s))(v, planes, scalars)


def _inputs(B, seed):
    rng = np.random.default_rng(seed)
    planes = (rng.random((B, 19, 19, 15)) < 0.3).astype(np.float32)
    scalars = rng.normal(size=(B, 8)).astype(np.float32)
    return planes, scalars


def _close(got, want, tol, name):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=name)


@pytest.fixture(scope="module")
def tiny():
    jm = jax_build(jax_get_config("tiny"))
    v = _numpy_vars(_jax_init(jm, 3), np.random.default_rng(0))
    tm = load_flax_variables(build_model(get_config("tiny")), v)
    return jm, v, tm


def test_configs_match_jax_package():
    assert set(_CONFIGS) == set(JAX_CONFIGS)
    for name, cfg in _CONFIGS.items():
        assert cfg.__dict__ == JAX_CONFIGS[name].__dict__, name


def test_bridge_covers_every_tensor(tiny):
    _, v, tm = tiny
    sd = flax_to_state_dict(v)
    assert set(sd) == set(tm.state_dict())
    for k, t in tm.state_dict().items():
        assert tuple(sd[k].shape) == tuple(t.shape), k


@pytest.mark.parametrize("seed", [0, 1])
def test_tiny_all_outputs(tiny, seed):
    jm, v, tm = tiny
    planes, scalars = _inputs(4, seed)
    jo = _jax_apply(jm, v, planes, scalars)
    to = tm(torch.from_numpy(planes), torch.from_numpy(scalars))
    assert len(ModelOutputs._fields) == 25
    for f in ModelOutputs._fields:
        assert getattr(to, f).dtype == torch.float32, f
        _close(getattr(to, f), getattr(jo, f), 1e-4, f)


@pytest.mark.parametrize("B", [1, 4])
def test_tiny_serve_forward(tiny, B):
    jm, v, tm = tiny
    planes, scalars = _inputs(B, 7)
    js = _jax_serve(jm, v, planes, scalars)
    ts = serve_forward(tm, torch.from_numpy(planes), torch.from_numpy(scalars))
    for f in SERVED:
        _close(getattr(ts, f), getattr(js, f), 1e-4, f)
    assert ts.ownership is None and ts.pi_logits_aux is None


@pytest.mark.parametrize("trunk", ["classic", "nbt"])
def test_other_trunks_serve_forward(trunk):
    from p3achygo_tpu.models.config import ModelConfig as JaxConfig
    from p3achygo_tpu_torch.models.config import ModelConfig

    kw = dict(blocks=3, broadcast_interval=3, channels=8, bottleneck_channels=4,
              head_channels=4, c_val=8, trunk_block_type=trunk)
    jm = jax_build(JaxConfig(**kw))
    v = _numpy_vars(_jax_init(jm, 1), np.random.default_rng(2))
    tm = load_flax_variables(build_model(ModelConfig(**kw)), v)
    planes, scalars = _inputs(2, 3)
    jo = _jax_apply(jm, v, planes, scalars)
    to = tm(torch.from_numpy(planes), torch.from_numpy(scalars))
    ts = serve_forward(tm, torch.from_numpy(planes), torch.from_numpy(scalars))
    for f in SERVED:
        _close(getattr(to, f), getattr(jo, f), 1e-4, f)
        _close(getattr(ts, f), getattr(jo, f), 1e-4, f)


def test_golden_b8c64():
    from p3achygo_tpu.train.checkpoint import restore_checkpoint

    jm = jax_build(jax_get_config("b8c64"))
    tmpl = _jax_init(jm, 0)
    restored = restore_checkpoint(GOLDEN, {"params": tmpl["params"],
                                           "batch_stats": tmpl["batch_stats"],
                                           "step": jnp.int32(0)})
    v = _numpy_vars(restored)
    tm = load_flax_variables(build_model(get_config("b8c64")), v)
    planes, scalars = _inputs(4, 11)
    jo = _jax_apply(jm, v, planes, scalars)
    to = tm(torch.from_numpy(planes), torch.from_numpy(scalars))
    for f in ModelOutputs._fields:
        _close(getattr(to, f), getattr(jo, f), 1e-3, f)
    js = _jax_serve(jm, v, planes, scalars)
    ts = serve_forward(tm, torch.from_numpy(planes), torch.from_numpy(scalars))
    for f in SERVED:
        _close(getattr(ts, f), getattr(js, f), 1e-3, f)
    np.testing.assert_array_equal(ts.pi_logits.argmax(-1).numpy(),
                                  np.asarray(jo.pi_logits).argmax(-1))


def test_random_init_is_seeded_and_finite():
    a = build_model(get_config("tiny"))
    b = build_model(get_config("tiny"))
    init_params(a, torch.Generator().manual_seed(5))
    init_params(b, torch.Generator().manual_seed(5))
    for (ka, ta), (kb, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(ta, tb), ka
    planes, scalars = _inputs(2, 0)
    out = a(torch.from_numpy(planes), torch.from_numpy(scalars))
    assert all(torch.isfinite(getattr(out, f)).all() for f in ModelOutputs._fields)
