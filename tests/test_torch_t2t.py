"""T2T-ViT and ``DistillableT2TViT`` against ``vit_tpu``'s, on the CPU in f32,
through the same weights (``state_dict_from_flax``): logits, the distillation
token's output, losses and every gradient within 1e-4, at 32 px (64 tokens
147 wide in the first token transformer, 16 tokens 1323 wide in the second,
4 of 11907 into the patch embedding; encoder depth 2).

The kernel routes of the token transformers, opened on the CPU (the kernel
wrappers run their plain versions there), as the card takes them: the first
one's attention on the flash op with its head of 147 padded to 192, the
second one's on the plain path below the gate, both MLPs on the fused MLP at
147 and 1323, the encoder's blocks on the fused block; and the logits and
gradients through those routes against ``vit_tpu``'s.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu.models import t2t as jax_t2t  # noqa: E402
from vit_tpu.objectives import distill as jax_distill  # noqa: E402
from vit_tpu_torch import DistillableT2TViT, DistillWrapper, T2TViT  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models import t2t  # noqa: E402
from vit_tpu_torch.ops import attention  # noqa: E402

TOL = 1e-4
CFG = dict(image_size=32, num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)


def _image(seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, 32, 32, 3)).astype(np.float32)


def _converted(jax_model, *args, **kwargs):
    variables = jax_model.init(jax.random.PRNGKey(0), *args, **kwargs)
    return variables, state_dict_from_flax(jax.tree.map(np.asarray, variables))


def _jax_loss_and_grads(module, variables, *args, reduce=None):
    def loss_of(p):
        out = module.apply({"params": p}, *args)
        return out if reduce is None else reduce(out)

    loss, grads = jax.value_and_grad(loss_of)(variables["params"])
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, grads))


def _check_grads(port, loss, want_loss, want_grads):
    loss.backward()
    assert abs(loss.item() - want_loss) <= TOL, (loss.item(), want_loss)
    got = dict(port.named_parameters())
    assert set(want_grads) <= set(got)
    for k, want in want_grads.items():
        g = got[k].grad
        g = torch.zeros_like(got[k]) if g is None else g
        assert float((g - want).abs().max()) <= TOL, k


def _weights(classes=10, seed=5):
    return np.random.default_rng(seed).standard_normal((2, classes)).astype(np.float32)


def test_token_transformer_widths_and_lengths():
    """At the default t2t_layers: 147 and 1323 wide over 64 and 16 tokens at
    32 px (3136 and 784 at 224), the last unfold 11907 wide."""
    port = T2TViT(**CFG, device="cpu")
    widths = [port.t2t_transformer_0.layers[0].mlp.fc1.weight.shape,
              port.t2t_transformer_1.layers[0].mlp.fc1.weight.shape]
    assert widths == [(147, 147), (1323, 1323)]
    assert port.patch_embedding.weight.shape == (64, 11907)
    assert port.pos_embedding.shape == (1, 5, 64)  # 2 x 2 patches and the CLS token
    assert t2t.same_output_size(224, 4) == 56 and t2t.same_output_size(15, 2) == 8
    assert not hasattr(port, "t2t_transformer_2")
    attn = port.t2t_transformer_0.layers[0].attn
    assert not attn.project_out and attn.heads == 1 and attn.dim_head == 147


@pytest.mark.parametrize("pool", ["cls", "mean"])
def test_t2t_logits_and_gradients_match_jax(pool):
    img = _image(1)
    w = _weights()
    jax_model = jax_t2t.T2TViT(**CFG, pool=pool)
    variables, state = _converted(jax_model, jnp.asarray(img))
    want = np.asarray(jax_model.apply(variables, jnp.asarray(img)))
    want_loss, want_grads = _jax_loss_and_grads(
        jax_model, variables, jnp.asarray(img), reduce=lambda out: jnp.sum(out * w))
    port = T2TViT(**CFG, pool=pool, device="cpu").eval()
    port.load_state_dict(state, strict=True)
    logits = port(torch.from_numpy(img))
    assert float((logits.detach() - torch.tensor(want)).abs().max()) <= TOL
    _check_grads(port, (logits * torch.from_numpy(w)).sum(), want_loss, want_grads)
    assert all(p.grad is not None for p in port.parameters())


def _open_kernel_routes(monkeypatch, calls):
    """The card's routes on CPU tensors: the kernel gates take f32 CPU
    activations, the flash tier starts at 64 tokens (3136 at 224 px, where
    the gate is 1024: the first token transformer above it, the second
    below), and each route records the widths it takes."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    monkeypatch.setattr(attention, "flash_tensor", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)

    def recorded(name, fn, width):
        def call(*args, **kw):
            calls.append((name, width(*args)))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(attention, "flash_attention", recorded(
        "flash", attention.flash_attention, lambda q, *a: (q.shape[2], q.shape[-1])))
    monkeypatch.setattr(attention, "plain_attention", recorded(
        "plain attention", attention.plain_attention, lambda q, *a: (q.shape[2], q.shape[-1])))
    monkeypatch.setattr(common, "fused_mlp", recorded(
        "fused_mlp", common.fused_mlp, lambda x, *a: (x.shape[1], x.shape[-1])))
    monkeypatch.setattr(common, "fused_attention_block", recorded(
        "fused_attention_block", common.fused_attention_block,
        lambda x, *a: (x.shape[1], x.shape[-1])))


def test_token_transformers_take_the_kernel_routes(monkeypatch):
    """Where the card runs kernels: flash at 147 padded to 192 over the
    first token transformer's 64 tokens, the plain path over the second's
    16, the fused MLP at 147 and 1323, the fused block in each encoder layer
    (5 tokens); and through those routes the logits and gradients still
    match ``vit_tpu``'s."""
    img = _image(2)
    w = _weights()
    jax_model = jax_t2t.T2TViT(**CFG)
    variables, state = _converted(jax_model, jnp.asarray(img))
    want_loss, want_grads = _jax_loss_and_grads(
        jax_model, variables, jnp.asarray(img), reduce=lambda out: jnp.sum(out * w))
    port = T2TViT(**CFG, device="cpu").eval()
    port.load_state_dict(state, strict=True)
    calls = []
    _open_kernel_routes(monkeypatch, calls)
    logits = port(torch.from_numpy(img))
    assert calls == [("flash", (64, 192)), ("fused_mlp", (64, 147)),
                     ("plain attention", (16, 1323)), ("fused_mlp", (16, 1323)),
                     ("fused_attention_block", (5, 64)), ("fused_mlp", (5, 64)),
                     ("fused_attention_block", (5, 64)), ("fused_mlp", (5, 64))]
    _check_grads(port, (logits * torch.from_numpy(w)).sum(), want_loss, want_grads)


def test_never_keeps_the_token_attention_off_the_flash_tier(monkeypatch):
    """``fused_attention="never"`` (the smoke's plain path) runs the plain
    attention at every length, the first token transformer's too."""
    calls = []
    _open_kernel_routes(monkeypatch, calls)
    port = T2TViT(**CFG, device="cpu").eval()
    for m in port.modules():
        if isinstance(m, common.Transformer):
            m.fused_attention = m.fused_mlp = "never"
    with torch.no_grad():
        port(torch.from_numpy(_image(3)))
    # the two token transformers' and the two encoder layers' attention
    assert calls == [("plain attention", (64, 147)), ("plain attention", (16, 1323)),
                     ("plain attention", (5, 32)), ("plain attention", (5, 32))]


def test_t2t_refuses_what_it_cannot_build():
    with pytest.raises(ValueError, match="scan_layers"):
        T2TViT(**CFG, scan_layers=True, device="cpu")
    with pytest.raises(ValueError, match="depth, heads, and mlp_dim"):
        T2TViT(image_size=32, num_classes=10, dim=64, device="cpu")
    with pytest.raises(ValueError, match="pool"):
        T2TViT(**CFG, pool="max", device="cpu")


def test_t2t_takes_a_custom_transformer():
    encoder = common.Transformer(64, 1, 2, 32, 128, device="cpu")
    port = T2TViT(image_size=32, num_classes=10, dim=64, transformer=encoder, device="cpu")
    assert port.transformer is encoder
    with torch.no_grad():
        assert port(torch.from_numpy(_image(4))).shape == (2, 10)


@pytest.mark.parametrize("with_token", [True, False], ids=["distill-token", "no-token"])
def test_distillable_t2t_matches_jax(with_token):
    """The distillation token appended last, after the CLS token and the
    positions: the logits and its output with a token, the logits alone
    without one."""
    img = _image(6)
    token = np.random.default_rng(7).standard_normal((1, 1, 64)).astype(np.float32)
    kwargs = dict(distill_token=jnp.asarray(token)) if with_token else {}
    jax_model = jax_distill.DistillableT2TViT(**CFG)
    variables, state = _converted(jax_model, jnp.asarray(img), **kwargs)
    want = jax_model.apply(variables, jnp.asarray(img), **kwargs)
    port = DistillableT2TViT(**CFG, device="cpu").eval()
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(img),
                   distill_token=torch.from_numpy(token) if with_token else None)
    if with_token:
        assert isinstance(got, tuple) and len(got) == 2
        for g, w in zip(got, want):
            assert float(np.max(np.abs(g.numpy() - np.asarray(w)))) <= TOL
    else:
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) <= TOL


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_distill_wrapper_over_t2t_matches_jax(hard):
    """``DistillWrapper(T2TViT teacher, DistillableT2TViT student)``: the loss
    and every gradient within 1e-4 of ``vit_tpu``'s; the teacher gets none."""
    img = _image(8)
    labels = np.array([1, 7], np.int32)
    student_cfg = dict(CFG, depth=1)
    jw = jax_distill.DistillWrapper(teacher=jax_t2t.T2TViT(**CFG),
                                    student=jax_distill.DistillableT2TViT(**student_cfg),
                                    temperature=3.0, alpha=0.5, hard=hard)
    batch = (jnp.asarray(img), jnp.asarray(labels))
    variables = jw.init(jax.random.PRNGKey(0), batch)
    want_loss, want_grads = _jax_loss_and_grads(jw, variables, batch)
    port = DistillWrapper(T2TViT(**CFG, device="cpu"),
                          DistillableT2TViT(**student_cfg, device="cpu"), temperature=3.0,
                          alpha=0.5, hard=hard, device="cpu")
    state = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    missing, unexpected = port.load_state_dict(state, strict=False)
    assert not missing and not unexpected, (missing, unexpected)
    port.eval()
    loss = port((torch.from_numpy(img), torch.from_numpy(labels).long()))
    _check_grads(port, loss, want_loss, want_grads)
    assert all(p.grad is None for p in port.teacher.parameters())
    assert all(p.grad is not None for p in port.student.parameters())


@pytest.mark.parametrize("cls", [T2TViT, DistillableT2TViT])
def test_t2t_builds_on_the_card_unless_asked_otherwise(cls):
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in cls(**CFG).parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(**CFG)
    assert all(p.device.type == "cpu" for p in cls(**CFG, device="cpu").parameters())


def test_no_module_of_the_port_imports_jax():
    """The T2T modules, like the rest of the port, import torch and never
    JAX or ``vit_tpu``."""
    import re
    from pathlib import Path

    import vit_tpu_torch

    root = Path(vit_tpu_torch.__file__).parent
    bad = [str(p) for p in root.rglob("*.py")
           if re.search(r"^\s*(import|from)\s+(jax|vit_tpu)\b(?!_torch)", p.read_text(), re.M)]
    assert not bad
