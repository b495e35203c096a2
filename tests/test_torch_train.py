"""The training slice: the port's ViT gradients and train step against
``vit_tpu``, the compute-dtype policy, the default device and the training
dispatch gate.

Gradients: ``jax.grad`` of ``vit_tpu.parallel.train.cross_entropy_loss``
through ``vit_tpu.ViT`` — at n = 145 with both Pallas block kernels in the
interpreter, so that JAX's gradient goes through their backward kernels; at
n = 17 with ``"never"`` (there ``"interpret"`` routes to the hybrid tier,
``vit_tpu/layers/common.py:275-281``, held in ``test_torch_fused_hybrid.py``).
The port's f32 CPU ``ViT`` carries the same weights through
``state_dict_from_flax``, and JAX's gradient tree goes through the same
mapping (Dense kernel ↔ ``weight.T``).  Every gradient, loss and parameter
within 1e-4, the bar ``vit_tpu`` held against TF.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu import ViT as JaxViT  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.layers.common import MLP, Attention, LayerNorm, Transformer  # noqa: E402
from vit_tpu_torch.parallel.train import (  # noqa: E402
    cross_entropy_loss, make_train_step,
)

TOL = 1e-4

SMALL = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
             heads=2, mlp_dim=128)                       # n = 17
LONG = dict(image_size=48, patch_size=4, num_classes=10, dim=64, depth=2,
            heads=2, dim_head=32, mlp_dim=128)           # n = 145


def _batch(kw, b=2, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((b, kw["image_size"], kw["image_size"], 3)).astype(np.float32)
    return img, (np.arange(b) * 3 % kw["num_classes"]).astype(np.int32)


def _flax_init(kw, img, **mode):
    model = JaxViT(**kw, **mode)
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(img))["params"]


def _port(kw, params, **extra):
    model = ViT(**kw, device="cpu", **extra)
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)), strict=True)
    return model


def _max_diff(port_tensors: dict, flax_tree) -> dict:
    want = state_dict_from_flax(jax.tree.map(np.asarray, flax_tree))
    assert set(want) == set(port_tensors)
    return {k: float((port_tensors[k] - want[k]).abs().max()) for k in want}


@pytest.mark.parametrize("kw,mode", [
    (LONG, dict(fused_attention="interpret", fused_mlp="interpret")),
    (SMALL, dict(fused_attention="never", fused_mlp="never")),
    (dict(SMALL, pool="mean"), dict(fused_attention="never", fused_mlp="never")),
])
def test_vit_gradients_match_jax(kw, mode):
    img, labels = _batch(kw)
    model, params = _flax_init(kw, img, **mode)

    def loss_of(p):
        return jax_train.cross_entropy_loss(model.apply({"params": p}, jnp.asarray(img)),
                                            jnp.asarray(labels))

    loss_want, grads = jax.value_and_grad(loss_of)(params)
    port = _port(kw, params)
    loss = cross_entropy_loss(port(torch.from_numpy(img)), torch.from_numpy(labels).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_want)) <= TOL
    diffs = _max_diff({k: p.grad for k, p in port.named_parameters()}, grads)
    assert max(diffs.values()) <= TOL, diffs


def _jax_steps(kw, params, img, labels, n_steps, accum_steps):
    model = JaxViT(**kw, fused_attention="never", fused_mlp="never")
    tx = optax.sgd(1e-3)
    step, _ = jax_train.make_train_step(
        lambda p, images, rng: model.apply({"params": p}, images), tx, mesh=None,
        accum_steps=accum_steps)
    state = jax_train.create_train_state(params, tx)
    losses = []
    for _ in range(n_steps):
        state, metrics = step(state, jnp.asarray(img), jnp.asarray(labels),
                              jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return losses, state.params, int(state.step)


def _port_steps(kw, params, img, labels, n_steps, accum_steps):
    model = _port(kw, params, fused_attention="never", fused_mlp="never")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3),
                           accum_steps=accum_steps)
    metrics = [step(torch.from_numpy(img), torch.from_numpy(labels).long())
               for _ in range(n_steps)]
    return [float(m["loss"]) for m in metrics], model, metrics[-1]["step"]


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_steps_match_jax(accum_steps):
    """Two SGD steps on one batch: losses and every parameter after them."""
    img, labels = _batch(SMALL, b=4)
    _, params = _flax_init(SMALL, img)
    want_losses, want_params, want_step = _jax_steps(SMALL, params, img, labels, 2,
                                                     accum_steps)
    losses, model, step = _port_steps(SMALL, params, img, labels, 2, accum_steps)
    assert step == want_step == 2
    assert np.max(np.abs(np.array(losses) - np.array(want_losses))) <= TOL
    assert losses[1] < losses[0]
    diffs = _max_diff(dict(model.state_dict()), want_params)
    assert max(diffs.values()) <= TOL, diffs


def test_accumulation_equals_the_full_batch():
    """``accum_steps=2`` takes the step ``accum_steps=1`` takes, on both
    sides (f32: the mean gradient summed in another order)."""
    img, labels = _batch(SMALL, b=4, seed=1)
    _, params = _flax_init(SMALL, img)
    jax_one, jax_two = (_jax_steps(SMALL, params, img, labels, 1, a) for a in (1, 2))
    one, two = (_port_steps(SMALL, params, img, labels, 1, a) for a in (1, 2))
    assert abs(jax_one[0][0] - jax_two[0][0]) <= 1e-6
    assert abs(one[0][0] - two[0][0]) <= 1e-6
    for a, b in zip(jax.tree.leaves(jax_one[1]), jax.tree.leaves(jax_two[1])):
        assert np.max(np.abs(np.asarray(a) - np.asarray(b))) <= 1e-6
    for (k, a), b in zip(one[1].state_dict().items(), two[1].state_dict().values()):
        assert float((a - b).abs().max()) <= 1e-6, k


def test_accumulation_refuses_a_batch_that_does_not_divide():
    model = ViT(**SMALL, device="cpu")
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3),
                           accum_steps=3)
    with pytest.raises(ValueError, match="divide"):
        step(torch.zeros(4, 32, 32, 3), torch.zeros(4, dtype=torch.long))


def test_bf16_compute_keeps_f32_parameters_and_gradients():
    """``compute_dtype=bf16`` with f32 parameters: the parameters and their
    ``.grad`` stay f32 (the weights are cast inside autograd), the logits
    come out in bf16 and agree with the f32 model of the same weights to a
    few bf16 units (2^-8 relative each) of the largest logit."""
    img, labels = _batch(SMALL, b=4, seed=2)
    g = torch.Generator().manual_seed(0)
    f32 = ViT(**SMALL, device="cpu", generator=g)
    bf16 = ViT(**SMALL, device="cpu", compute_dtype=torch.bfloat16)
    bf16.load_state_dict(f32.state_dict())
    images = torch.from_numpy(img)
    with torch.no_grad():
        want = f32(images)
    got = bf16(images)
    assert got.dtype == torch.bfloat16
    assert float((got.detach().float() - want).abs().max()) <= 4 * 2.0 ** -8 * float(want.abs().max())
    cross_entropy_loss(got, torch.from_numpy(labels).long()).backward()
    assert all(p.dtype == torch.float32 for p in bf16.parameters())
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in bf16.parameters())


def test_modules_build_on_the_card_unless_asked_otherwise():
    """``device=None`` means CUDA: without a CUDA device it raises, and never
    builds on the CPU unasked; ``device="cpu"`` builds on the CPU."""
    builds = [lambda **kw: ViT(**SMALL, **kw), lambda **kw: Transformer(64, 1, 2, 32, 128, **kw),
              lambda **kw: LayerNorm(64, **kw), lambda **kw: MLP(64, 128, **kw),
              lambda **kw: Attention(64, 2, 32, **kw)]
    for build in builds:
        if torch.cuda.is_available():
            assert all(p.is_cuda for p in build().parameters())
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        assert all(p.device.type == "cpu" for p in build(device="cpu").parameters())


def _count_calls(monkeypatch, name):
    calls = []
    fn = getattr(common, name)
    monkeypatch.setattr(common, name, lambda *a: calls.append(1) or fn(*a))
    return calls


@pytest.mark.parametrize("dropout,train,fused", [
    (0.1, True, False),   # active dropout: the plain modules, as vit_tpu
    (0.1, False, True),   # eval: dropout inactive, the kernels
    (0.0, True, True),    # training with a rate of 0: the kernels
])
def test_training_dispatch_gate(monkeypatch, dropout, train, fused):
    """The gate of ``"auto"`` given an activation the kernels take (the
    16-bit CUDA test is patched to accept this CPU one, whose ops then run
    their plain versions): kernels unless dropout is active in training."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    attn_calls = _count_calls(monkeypatch, "apply_fused_attention_block")
    mlp_calls = _count_calls(monkeypatch, "apply_fused_mlp_block")
    g = torch.Generator().manual_seed(0)
    stack = Transformer(32, 3, 2, 16, 64, dropout=dropout, device="cpu", generator=g)
    stack.train(train)
    stack(torch.randn(2, 9, 32, generator=g))
    assert (len(attn_calls), len(mlp_calls)) == ((3, 3) if fused else (0, 0))


def test_kernel_path_under_autograd_matches_the_plain_modules(monkeypatch):
    """With the gate open on the CPU, a training step's forward and gradients
    go through the ops' autograd Functions (plain training forward, plain
    backward) and match the plain modules in f32."""
    g = torch.Generator().manual_seed(1)
    kernels = ViT(**SMALL, device="cpu", generator=g)
    plain = ViT(**SMALL, device="cpu", fused_attention="never", fused_mlp="never")
    plain.load_state_dict(kernels.state_dict())
    img = torch.randn(3, 32, 32, 3, generator=g)
    labels = torch.tensor([1, 4, 7])
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for model in (kernels, plain):
        cross_entropy_loss(model.train()(img), labels).backward()
    for (k, a), b in zip(kernels.named_parameters(), plain.parameters()):
        assert float((a.grad - b.grad).abs().max()) <= 1e-5, k
