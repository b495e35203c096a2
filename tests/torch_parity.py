"""Helpers shared by the dense-token family's parity tests
(``test_torch_deepvit.py``, ``test_torch_patch_merger.py``,
``test_torch_cross_vit.py``, ``test_torch_cait.py``,
``test_torch_parallel_vit.py``, ``test_torch_ats_vit.py``,
``test_torch_cct.py``, ``test_torch_layers_extra.py``): Flax variables drawn from a seed, one SGD
step in each package, the comparisons, and the CPU kernel route.

The port is held to ``vit_tpu`` within ``TOL`` (1e-4) in f32: logits and
losses absolutely, each gradient within ``TOL`` of ``max(1, its largest
entry)`` (:func:`grad_diff`), as gradients that grow past 1 part from their
f32 summation order by a share of their size.
"""

import numpy as np
import torch

import jax  # noqa: E402  (the callers skip without JAX first)
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

TOL = 1e-4
LR = 0.1
# Leaves drawn at unit scale: the tokens, the position embeddings, the
# patch merger's queries and the (heads, heads) head mixes.
UNIT = ("cls_token", "pos_embedding", "queries", "reattn_weights", "mix_heads_pre_attn",
        "mix_heads_post_attn")


def maxdiff(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def grad_diff(got, want) -> float:
    """max|got - want| over ``max(1, max|want|)``."""
    return maxdiff(got, want) / max(1.0, float(np.max(np.abs(np.asarray(want)))))


def random_variables(model, img, rng, **kw):
    """Flax variables of ``model`` on the shapes its init gives (traced, not
    run), every leaf drawn from ``rng``: the LayerNorms' scales around 1,
    the biases around 0, the LayerScales around 0.1, the :data:`UNIT` leaves
    at unit scale, the kernels scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a, **kw),
                            jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name == "bias":
            return (0.1 * draw).astype(np.float32)
        if name.startswith("layerscale_"):
            return (0.1 + 0.02 * draw).astype(np.float32)
        if name in UNIT:
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_sgd_step(apply, variables, img, labels):
    """One SGD step of ``vit_tpu``'s ``make_train_step`` (its inner step,
    jitted) on ``apply(variables, images, training=True)``: the loss, each
    parameter's gradient and the updated parameters, as the port's
    ``state_dict`` keys."""
    tx = optax.sgd(LR)
    step, _ = jax_train.make_train_step(
        lambda p, images, rng_key: apply({"params": p}, images, training=True), tx, mesh=None)
    state = jax_train.create_train_state(variables["params"], tx)
    new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                       jax.random.PRNGKey(1))
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR,
                         variables["params"], new_state.params)
    return dict(loss=float(metrics["loss"]), grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(jax.tree.map(np.asarray, new_state.params)))


def check_sgd_step(model, img, labels, want, nonzero=(), generator=None):
    """One SGD step of the port's ``make_train_step`` against
    :func:`jax_sgd_step`'s ``want``: the loss, every gradient (those named in
    ``nonzero`` checked to be nonzero) and the updated parameters; the step
    given ``generator``, where one is."""
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(torch.from_numpy(img), torch.from_numpy(labels).long(),
                      generator=generator)["loss"])
    assert abs(loss - want["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(want["grads"])
    for k in nonzero:
        assert float(grads[k].abs().max()) > 0, k
    diffs = {k: grad_diff(grads[k], want["grads"][k]) for k in grads}
    assert max(diffs.values()) <= TOL, diffs
    state = model.state_dict()
    diffs = {k: maxdiff(state[k], w) for k, w in want["updated"].items()}
    assert max(diffs.values()) <= TOL, diffs


def port_logits(model, img) -> np.ndarray:
    with torch.no_grad():
        return model.eval()(torch.from_numpy(img)).numpy()


def loaded(model, variables):
    """``model`` with the converted ``variables`` loaded strictly."""
    model.load_state_dict(state_dict_from_flax(variables), strict=True)
    return model


def open_kernel_gate(monkeypatch, calls):
    """Let the f32 CPU tensors through the fused MLP's gate
    (``kernel_activation`` in ``vit_tpu_torch.layers.common``) and record
    each call into the op (which then runs its plain version) by its rows'
    token count."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    monkeypatch.setattr(common, "fused_mlp", lambda *a, f=common.fused_mlp, **k:
                        calls.append(a[0].shape[1]) or f(*a, **k))
