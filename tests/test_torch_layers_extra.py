"""The layers and helpers of ``vit_tpu`` that no model of either package
needs (``PEG``, ``DepthWiseConv2d``, ``Downsample``, ``batchnorm``,
``PreNorm``, ``Residual``; ``group_dict_by_key`` and its two kin), and the
draws the port's models share (``dropout``, ``DropPath``, the ``MLP``'s
dropout from a generator, ``dropout_mask``), against ``vit_tpu`` in f32 on
the CPU: weights drawn with numpy from a seed and carried by
``state_dict_from_flax``, within 1e-4; masks injected into both packages
call for call (``jax.random.bernoulli`` for the test's scope, the port's
``layers.common.dropout_mask``).  ``DepthWiseConv2d`` with its BatchNorm is
held in eval mode and in training mode, where the running statistics move
as Flax's ``batch_stats`` do.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from torch_parity import TOL, loaded, maxdiff, random_variables  # noqa: E402
from vit_tpu.core import helpers as jax_helpers  # noqa: E402
from vit_tpu.layers import common as jax_common  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.core import helpers  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import nest  # noqa: E402

CPU = dict(device="cpu")


def _map(seed=0, shape=(2, 9, 9, 16)):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _variables(module, x, seed=1, **kw):
    """``random_variables`` with every BatchNorm variance drawn positive."""
    v = random_variables(module, x, np.random.default_rng(seed), **kw)
    if "batch_stats" in v:
        v = dict(v, batch_stats=jax.tree_util.tree_map_with_path(
            lambda path, a: np.abs(a) + 0.5 if path[-1].key == "var" else a, v["batch_stats"]))
    return v


def _port_out(port, x, **kw):
    with torch.no_grad():
        return port(torch.from_numpy(x), **kw)


@pytest.mark.parametrize("name", ["PEG", "Downsample", "DepthWiseConv2d", "DepthWiseConv2d-bn",
                                  "DepthWiseConv2d-stride2-nobias", "PreNorm", "Residual"])
def test_layer_matches_jax_in_eval_mode(name):
    x = _map()
    mlp = dict(jax=lambda: jax_common.MLP(16, 32), port=lambda: common.MLP(16, 32, **CPU))
    layers = {
        "PEG": (jax_common.PEG(16), lambda: common.PEG(16, **CPU)),
        "Downsample": (jax_common.Downsample(24), lambda: common.Downsample(16, 24, **CPU)),
        "DepthWiseConv2d": (jax_common.DepthWiseConv2d(16, 24, 3),
                            lambda: common.DepthWiseConv2d(16, 24, 3, **CPU)),
        "DepthWiseConv2d-bn": (jax_common.DepthWiseConv2d(16, 24, 3, use_bn=True),
                               lambda: common.DepthWiseConv2d(16, 24, 3, use_bn=True, **CPU)),
        "DepthWiseConv2d-stride2-nobias": (
            jax_common.DepthWiseConv2d(16, 24, 5, stride=2, use_bias=False),
            lambda: common.DepthWiseConv2d(16, 24, 5, 2, use_bias=False, **CPU)),
        "PreNorm": (jax_common.PreNorm(mlp["jax"]()),
                    lambda: common.PreNorm(16, mlp["port"](), **CPU)),
        "Residual": (jax_common.Residual(mlp["jax"]()), lambda: common.Residual(mlp["port"]())),
    }
    module, build = layers[name]
    v = _variables(module, x)
    want = np.asarray(module.apply(v, jnp.asarray(x)))
    got = _port_out(loaded(build(), v).eval(), x)
    assert got.shape == want.shape and maxdiff(got, want) <= TOL


def test_depthwise_conv_with_batch_norm_in_training_moves_the_statistics_as_flax():
    """``DepthWiseConv2d(use_bn=True)`` in training mode: the output from the
    batch statistics and the running statistics after one call, Keras'
    momentum 0.99 (the port's 0.01) and eps 1e-3, within 1e-4 of Flax's
    ``batch_stats``."""
    x = _map(seed=2)
    module = jax_common.DepthWiseConv2d(16, 24, 3, stride=2, use_bn=True)
    v = _variables(module, x, training=False)
    want, stats = module.apply(v, jnp.asarray(x), training=True, mutable=["batch_stats"])
    port = loaded(common.DepthWiseConv2d(16, 24, 3, 2, use_bn=True, **CPU), v).train()
    got = _port_out(port, x)
    assert maxdiff(got, want) <= TOL
    new = state_dict_from_flax({"params": v["params"], "batch_stats": stats["batch_stats"]})
    for key in ("bn.running_mean", "bn.running_var"):
        assert not torch.equal(port.state_dict()[key], torch.from_numpy(
            np.asarray(v["batch_stats"]["bn"][key.split("_")[-1]])))
        assert maxdiff(port.state_dict()[key], new[key]) <= TOL, key
    assert port.bn.momentum == 0.01 and port.bn.eps == 1e-3


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_batchnorm_is_keras_parity(training):
    x = _map(seed=3, shape=(4, 5, 5, 8))
    v = _variables(jax_common.batchnorm(False), x)
    want = jax_common.batchnorm(training).apply(v, jnp.asarray(x), mutable=["batch_stats"])[0]
    port = loaded(common.batchnorm(8, **CPU), v).train(training)
    assert maxdiff(_port_out(port, x), want) <= TOL


def test_residual_and_prenorm_pass_keywords_through():
    seen = []

    class Probe(torch.nn.Module):
        def forward(self, x, scale=1.0):
            seen.append(scale)
            return x * scale

    x = torch.ones(1, 2, 4)
    assert torch.equal(common.Residual(Probe())(x, scale=3.0), 4 * x)
    pre = common.PreNorm(4, Probe(), **CPU)
    assert pre(x, scale=2.0).shape == x.shape and seen == [3.0, 2.0]


def test_group_helpers_match_jax():
    d = {"s1_emb_dim": 64, "s1_depth": 1, "s2_emb_dim": 192, "heads": 3, "s1x": None}
    for fn in ("group_by_key_prefix", "group_by_key_prefix_and_remove_prefix"):
        assert getattr(helpers, fn)("s1_", d) == getattr(jax_helpers, fn)("s1_", d)
    cond = lambda k: len(k) > 5  # noqa: E731
    assert helpers.group_dict_by_key(cond, d) == jax_helpers.group_dict_by_key(cond, d)
    assert helpers.group_by_key_prefix_and_remove_prefix("s1_", d) == (
        {"emb_dim": 64, "depth": 1}, {"s2_emb_dim": 192, "heads": 3, "s1x": None})


def _inject(monkeypatch_jax, seed=201):
    """Numpy masks by call index for both packages; returns the recorders."""
    jax_draws, port_draws = [], []

    def mask(i, shape, keep):
        return np.random.default_rng(seed + i).random(tuple(int(s) for s in shape)) < keep

    def jax_bernoulli(key, p=0.5, shape=None):
        jax_draws.append((tuple(int(s) for s in shape), float(p)))
        return jnp.asarray(mask(len(jax_draws) - 1, shape, p))

    def port_mask(generator, shape, keep):
        port_draws.append((tuple(int(s) for s in shape), float(keep)))
        return torch.from_numpy(mask(len(port_draws) - 1, shape, keep))

    monkeypatch_jax.setattr(jax.random, "bernoulli", jax_bernoulli)
    return jax_draws, port_draws, port_mask


@pytest.mark.parametrize("name", ["DropPath", "MLP"])
def test_draws_match_flax_on_injected_masks(monkeypatch, name):
    """``DropPath(0.3)`` (one ``(b, 1, 1)`` mask) and the ``MLP``'s dropout
    at 0.3 given a generator (two element-wise masks) in training mode,
    against ``vit_tpu``'s ``DropPath`` and ``MLP`` (Flax's ``nn.Dropout``) on
    the same masks: the outputs within 1e-5, the draws' shapes and keep rates
    equal."""
    x = _map(seed=4, shape=(8, 6, 16))
    if name == "DropPath":
        module, port = jax_common.DropPath(0.3), common.DropPath(0.3)
        v = {}
    else:
        module, port = jax_common.MLP(16, 32, dropout=0.3), common.MLP(16, 32, 0.3, **CPU)
        v = _variables(module, x)
        port = loaded(port, v)
    with pytest.MonkeyPatch.context() as mp:
        jax_draws, port_draws, port_mask = _inject(mp)
        want = np.asarray(module.apply(v, jnp.asarray(x), training=True,
                                       rngs={"dropout": jax.random.PRNGKey(0)}))
    monkeypatch.setattr(common, "dropout_mask", port_mask)
    got = _port_out(port.train(), x, generator=torch.Generator())
    assert port_draws == jax_draws and len(port_draws) == (1 if name == "DropPath" else 2)
    assert maxdiff(got, want) <= 1e-5 and (got == 0).any()


def test_dropout_and_drop_path_rules():
    """The identity in eval mode and at rate 0 (no draw); a draw without a
    generator raises; one seed gives one mask whatever the dtype (the draws
    are f32), so a bf16 and an f32 model drop the same elements; the keep
    rate holds over many draws."""
    x = torch.randn(64, 8, 16, generator=torch.Generator().manual_seed(5)) + 4.0
    drop = common.DropPath(0.25)
    assert drop.eval()(x) is x and common.DropPath(0.0).train()(x) is x
    assert common.dropout(x, 0.25, False, None) is x and common.dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="explicit generator"):
        drop.train()(x)
    with pytest.raises(ValueError, match="explicit generator"):
        common.dropout(x, 0.25, True, None)
    for fn in (lambda t, g: drop.train()(t, g), lambda t, g: common.dropout(t, 0.25, True, g)):
        f32 = fn(x, torch.Generator().manual_seed(6))
        b16 = fn(x.to(torch.bfloat16), torch.Generator().manual_seed(6))
        assert b16.dtype == torch.bfloat16 and torch.equal(f32 == 0, b16 == 0)
        assert torch.allclose(b16.float(), f32, rtol=1e-2)
        kept = (f32 != 0).float().mean().item()
        assert 0.65 < kept < 0.85 and torch.allclose(f32[f32 != 0], x[f32 != 0] / 0.75)
    assert torch.equal(common.dropout(x, 1.0, True, None), torch.zeros_like(x))
    mask = common.dropout_mask(torch.Generator().manual_seed(7), (1000,), 0.9)
    assert mask.dtype == torch.bool and 0.85 < mask.float().mean().item() < 0.95


def test_max_pool_same_is_shared_with_nest():
    """NesT keeps its name for the pool, which now lives in
    ``layers.common`` for CCT and NesT alike."""
    assert nest.max_pool_same is common.max_pool_same
    x = torch.arange(2 * 8 * 8 * 3, dtype=torch.float32).reshape(2, 8, 8, 3)
    out = common.max_pool_same(x)
    assert out.shape == (2, 4, 4, 3) and torch.equal(out[:, -1, -1], x[:, -1, -1])
