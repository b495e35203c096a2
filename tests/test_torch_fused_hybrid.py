"""The hybrid layer's ops and tier against ``vit_tpu``, in f32 on the CPU,
where the port's ops run their plain versions and the JAX kernels run in
interpret mode (as ``tests/unit/test_fused_hybrid.py`` runs them).

- The ops: ``ln_gemm`` (t 133, d 96 → 192, also as q|k|v), ``attention_nb``
  (n 33, b 18, 4 heads of 32) and ``proj_mlp`` (t 133, d 96, inner 64,
  hidden 160), forward and VJP, within 1e-5 of max(1, max|ref|), the JAX
  tests' own bar.
- The tier: ``Transformer(fused_attention="hybrid")`` at dim 64, depth 2, 4
  heads of 32, mlp 128 on x (64, 65, 64), where the port's gate holds (the
  16-bit CUDA test patched to take this CPU tensor), against ``vit_tpu``'s
  ``fused_attention="interpret", fused_mlp="interpret"`` (its hybrid tier in
  the interpreter), forward and every gradient within 1e-4; a whole tiny ViT
  converted with ``state_dict_from_flax``, its logits and one SGD step of
  ``make_train_step``, within 1e-4, the port's bar against ``vit_tpu``.  The
  calls into the three ops are counted.
- The gate's edges, in the port alone: b = 63, n = 128, a head geometry
  ``_attn_pack`` refuses and active dropout fall back to ``"auto"``'s route;
  ``fused_mlp="never"`` skips the tier.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from vit_tpu import ViT as JaxViT  # noqa: E402
from vit_tpu.layers.common import Transformer as JaxTransformer  # noqa: E402
from vit_tpu.ops import fused_hybrid as jfh  # noqa: E402
from vit_tpu.parallel import train as jax_train  # noqa: E402
from vit_tpu_torch import ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.layers.common import Transformer  # noqa: E402
from vit_tpu_torch.ops import fused_hybrid as fh  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

OP_TOL = 1e-5
TOL = 1e-4
STACK = dict(dim=64, depth=2, heads=4, dim_head=32, mlp_dim=128)
VIT = dict(image_size=32, patch_size=4, num_classes=10, **STACK)  # n = 65
BATCH = 64
LR = 0.1
INTERPRET = dict(fused_attention="interpret", fused_mlp="interpret")
OPS = ("ln_gemm", "attention_nb", "proj_mlp")


def _rn(rng, *shape, scale=1.0, shift=0.0):
    return (shift + scale * rng.standard_normal(shape)).astype(np.float32)


def _close(got, want, name, tol=OP_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * max(1.0, float(np.max(np.abs(want)))), (name, err)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("nsplit", [1, 3])
def test_ln_gemm_matches_jax_kernel(nsplit):
    rng = np.random.default_rng(0)
    x, gamma, beta = _rn(rng, 133, 96), _rn(rng, 96, scale=0.1, shift=1.0), _rn(rng, 96, scale=0.1)
    w = _rn(rng, 96, 192, scale=0.05)  # vit_tpu's (in, out) kernel
    cots = [_rn(rng, 133, 192 // nsplit) for _ in range(nsplit)]

    def jax_op(*a):
        out = jfh.ln_gemm(*a, 1e-3, 64, True, nsplit)
        return tuple(out) if nsplit > 1 else out

    want, vjp = jax.vjp(jax_op, *map(jnp.asarray, (x, gamma, beta, w)))
    grads_want = vjp(tuple(map(jnp.asarray, cots)) if nsplit > 1 else jnp.asarray(cots[0]))
    inputs = [_t(a).requires_grad_() for a in (x, gamma, beta, w.T)]
    out = fh.ln_gemm(*inputs, 1e-3, nsplit)
    outs = out if nsplit > 1 else (out,)
    for i, (got, w_) in enumerate(zip(outs, want if nsplit > 1 else (want,))):
        _close(got.detach(), w_, f"out {i}")
    grads = torch.autograd.grad(outs, inputs, [_t(c) for c in cots])
    for name, got, w_ in zip(("dx", "dgamma", "dbeta", "dw"),
                             (grads[0], grads[1], grads[2], grads[3].t()), grads_want):
        _close(got, w_, name)


def test_attention_nb_matches_jax_kernel():
    n, b, heads, dh = 33, 18, 4, 32
    assert fh._attn_pack(heads, dh) == jfh._attn_pack(heads, dh) == 4
    rng = np.random.default_rng(1)
    q, k, v, g = (_rn(rng, n, b, heads * dh) for _ in range(4))
    want, vjp = jax.vjp(lambda *a: jfh.attention_nb(*a, heads, dh, None, True),
                        *map(jnp.asarray, (q, k, v)))
    grads_want = vjp(jnp.asarray(g))
    counts = (fh.attention_nb.launches, fh.attention_nb_backward.launches)
    inputs = [_t(a).requires_grad_() for a in (q, k, v)]
    out = fh.attention_nb(*inputs, heads, dh)
    grads = torch.autograd.grad(out, inputs, _t(g))
    assert (fh.attention_nb.launches, fh.attention_nb_backward.launches) == counts
    _close(out.detach(), want, "o")
    for name, got, w_ in zip(("dq", "dk", "dv"), grads, grads_want):
        _close(got, w_, name)


def test_proj_mlp_matches_jax_kernel():
    rng = np.random.default_rng(2)
    t, d, inner, hidden = 133, 96, 64, 160
    args = (_rn(rng, t, d), _rn(rng, t, inner), _rn(rng, inner, d, scale=0.05),
            _rn(rng, d, scale=0.05), _rn(rng, d, scale=0.1, shift=1.0), _rn(rng, d, scale=0.1),
            _rn(rng, d, hidden, scale=0.05), _rn(rng, hidden, scale=0.05),
            _rn(rng, hidden, d, scale=0.05), _rn(rng, d, scale=0.05))
    g = _rn(rng, t, d)
    want, vjp = jax.vjp(lambda *a: jfh.proj_mlp(*a, 1e-3, 64, True, "exact"),
                        *map(jnp.asarray, args))
    grads_want = vjp(jnp.asarray(g))
    x, o, wo, bo, gamma, beta, w1, b1, w2, b2 = args
    inputs = [_t(a).requires_grad_() for a in (x, o, wo.T, bo, gamma, beta, w1.T, b1, w2.T, b2)]
    out = fh.proj_mlp(*inputs, 1e-3)
    _close(out.detach(), want, "z")
    grads = list(torch.autograd.grad(out, inputs, _t(g)))
    for i in (2, 6, 8):  # nn.Linear weights against vit_tpu's (in, out) kernels
        grads[i] = grads[i].t()
    names = ("dx", "do", "dwo", "dbo", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2")
    for name, got, w_ in zip(names, grads, grads_want):
        _close(got, w_, name)


def _random_variables(model, x, rng):
    """Flax variables on the shapes ``model.init`` gives (traced, not run),
    every leaf drawn from ``rng``: the norms' scales around 1, shifts and
    biases around 0, kernels scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(x))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name == "bias":
            return (0.1 * draw).astype(np.float32)
        if name in ("cls_token", "pos_embedding"):
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _count_ops(monkeypatch):
    """Let the f32 CPU tensors through the kernel gate and count the calls
    into the three ops (which then run their plain versions)."""
    calls = []
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    for name in OPS:
        monkeypatch.setattr(common, name, lambda *a, f=getattr(common, name), name=name, **kw:
                            calls.append(name) or f(*a, **kw))
    return calls


def _tally(calls):
    return {name: calls.count(name) for name in set(calls)}


@pytest.fixture(scope="module")
def jax_stack():
    """``vit_tpu``'s Transformer on its hybrid tier in the interpreter: the
    output and the VJP of a cotangent, on random variables."""
    rng = np.random.default_rng(3)
    x = _rn(rng, BATCH, 65, STACK["dim"])
    model = JaxTransformer(**STACK, **INTERPRET)
    v = _random_variables(model, x, rng)
    g = _rn(rng, BATCH, 65, STACK["dim"])
    y, vjp = jax.vjp(jax.jit(lambda p, a: model.apply({"params": p}, a)), v["params"],
                     jnp.asarray(x))
    dparams, dx = vjp(jnp.asarray(g))
    return dict(x=x, g=g, params=jax.tree.map(np.asarray, v["params"]), y=np.asarray(y),
                dparams=state_dict_from_flax(jax.tree.map(np.asarray, dparams)), dx=np.asarray(dx))


def test_transformer_hybrid_tier_matches_jax(jax_stack, monkeypatch):
    calls = _count_ops(monkeypatch)
    stack = Transformer(STACK["dim"], STACK["depth"], STACK["heads"], STACK["dim_head"],
                        STACK["mlp_dim"], fused_attention="hybrid", device="cpu")
    stack.load_state_dict(state_dict_from_flax(jax_stack["params"]), strict=True)
    x = _t(jax_stack["x"]).requires_grad_()
    y = stack(x)
    assert _tally(calls) == {name: STACK["depth"] for name in OPS}
    _close(y.detach(), jax_stack["y"], "y", TOL)
    y.backward(_t(jax_stack["g"]))
    _close(x.grad, jax_stack["dx"], "dx", TOL)
    for key, p in stack.named_parameters():
        _close(p.grad, jax_stack["dparams"][key], key, TOL)


@pytest.fixture(scope="module")
def jax_vit():
    """``vit_tpu.ViT`` on its hybrid tier in the interpreter: eval logits and
    one SGD step (loss, gradient, updated parameters)."""
    rng = np.random.default_rng(4)
    img = _rn(rng, BATCH, VIT["image_size"], VIT["image_size"], 3)
    labels = (np.arange(BATCH) % VIT["num_classes"]).astype(np.int32)
    model = JaxViT(**VIT, **INTERPRET)
    v = _random_variables(model, img, rng)
    logits = jax.jit(model.apply)(v, jnp.asarray(img))
    tx = optax.sgd(LR)
    step, _ = jax_train.make_train_step(
        lambda p, images, rng_key: model.apply({"params": p}, images), tx, mesh=None)
    state = jax_train.create_train_state(v["params"], tx)
    new_state, metrics = jax.jit(step)(state, jnp.asarray(img), jnp.asarray(labels),
                                       jax.random.PRNGKey(1))
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b)) / LR, v["params"],
                         new_state.params)
    return dict(img=img, labels=labels, variables=jax.tree.map(np.asarray, v),
                logits=np.asarray(logits), loss=float(metrics["loss"]),
                grads=state_dict_from_flax(grads),
                updated=state_dict_from_flax(jax.tree.map(np.asarray, new_state.params)))


def _port_vit(jax_vit):
    model = ViT(**VIT, fused_attention="hybrid", device="cpu")
    model.load_state_dict(state_dict_from_flax(jax_vit["variables"]), strict=True)
    return model


def test_vit_hybrid_logits_match_jax(jax_vit, monkeypatch):
    calls = _count_ops(monkeypatch)
    with torch.no_grad():
        logits = _port_vit(jax_vit).eval()(_t(jax_vit["img"]))
    assert _tally(calls) == {name: VIT["depth"] for name in OPS}
    _close(logits, jax_vit["logits"], "logits", TOL)


def test_vit_hybrid_train_step_matches_jax(jax_vit, monkeypatch):
    """One SGD step: the loss, every parameter's gradient and the updated
    parameters."""
    calls = _count_ops(monkeypatch)
    model = _port_vit(jax_vit)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR))
    loss = float(step(_t(jax_vit["img"]), _t(jax_vit["labels"]).long())["loss"])
    assert _tally(calls) == {name: VIT["depth"] for name in OPS}
    assert abs(loss - jax_vit["loss"]) <= TOL
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(jax_vit["grads"])
    for key, grad in grads.items():
        _close(grad, jax_vit["grads"][key], key, TOL)
    state = model.state_dict()
    for key, want in jax_vit["updated"].items():
        _close(state[key], want, key, TOL)


def _routes(monkeypatch):
    """Count the tier's layers and ``"auto"``'s block calls."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    calls = []
    for name in ("apply_fused_hybrid_layer", "apply_fused_attention_block",
                 "apply_fused_mlp_block"):
        monkeypatch.setattr(common, name, lambda *a, f=getattr(common, name), name=name:
                            calls.append(name) or f(*a))
    return calls


@pytest.mark.parametrize("b,n,heads,dim_head,kw,route", [
    (64, 65, 4, 32, {}, "hybrid"),
    (63, 65, 4, 32, {}, "auto"),                        # b < 64
    (64, 128, 4, 32, {}, "auto"),                       # n < 128 only
    (32, 65, 4, 32, {}, "auto"),                        # b·n < 2048 (and b < 64)
    (64, 65, 3, 64, {}, "auto"),                        # _attn_pack: 3 heads of 64 do not pair
    (64, 65, 4, 16, {}, "auto"),                        # _attn_pack: 4 heads of 16 fill no lane tile
    (64, 65, 4, 32, dict(dropout=0.1), "plain"),        # dropout active in training
    (64, 65, 4, 32, dict(fused_mlp="never"), "no mlp"),  # the tier needs the fused MLP
])
def test_hybrid_gate(monkeypatch, b, n, heads, dim_head, kw, route):
    calls = _routes(monkeypatch)
    g = torch.Generator().manual_seed(5)
    stack = Transformer(32, 2, heads, dim_head, 64, fused_attention="hybrid", device="cpu",
                        generator=g, **kw).train()
    x = torch.randn(b, n, 32, generator=g)
    y = stack(x)
    want = {"hybrid": {"apply_fused_hybrid_layer": 2},
            "auto": {"apply_fused_attention_block": 2, "apply_fused_mlp_block": 2},
            "plain": {},
            "no mlp": {"apply_fused_attention_block": 2}}[route]
    assert _tally(calls) == want
    assert y.shape == x.shape
    if route == "hybrid":  # the tier computes the plain modules' function
        plain = Transformer(32, 2, heads, dim_head, 64, fused_attention="never",
                            fused_mlp="never", device="cpu")
        plain.load_state_dict(stack.state_dict())
        assert float((plain(x) - y).detach().abs().max()) <= 1e-5


def test_ln_gemm_joins_the_attention_gradient_without_a_copy(monkeypatch):
    """Through the layer, ``ln_gemm``'s backward receives dq, dk and dv as
    column views of the one buffer ``attention_nb``'s backward wrote, and
    uses it as it lies."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    joined = []
    monkeypatch.setattr(fh, "_joined", lambda douts, f=fh._joined: joined.append(
        (f(douts), douts)) or joined[-1][0])
    g = torch.Generator().manual_seed(6)
    stack = Transformer(32, 1, 4, 32, 64, fused_attention="hybrid", device="cpu", generator=g)
    stack(torch.randn(64, 40, 32, generator=g)).sum().backward()
    (buf, douts), = joined
    assert buf.data_ptr() == douts[0].data_ptr() and buf.shape == (64 * 40, 3 * 128)
    assert all(torch.equal(buf[:, 128 * i:128 * (i + 1)], d) for i, d in enumerate(douts))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_proj_mlp_forward_is_the_gemm_chain(dtype):
    """The CUDA forward chains ``gemm_wgmma.cu``'s epilogues (bias + residual,
    LayerNorm, bias + GELU keeping h, bias + residual); the plain GEMM
    (:func:`~vit_tpu_torch.ops.fused_hybrid.gemm_reference`, what
    ``gemm_wgmma`` runs on a CPU tensor) chained the same way gives
    ``proj_mlp``'s plain forward bit for bit, in bf16 (every rounding point)
    and f32, and its store epilogue ``ln_gemm``'s GEMM."""
    rng = np.random.default_rng(9)
    t, d, inner, hidden, eps = 133, 96, 64, 160, 1e-3

    def rn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(_rn(rng, *shape, scale=scale, shift=shift)).to(dtype)

    x, o = rn(t, d), rn(t, inner)
    wo, bo = rn(d, inner, scale=inner ** -0.5), rn(d, scale=0.1)
    gamma, beta = rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1)
    w1, b1 = rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1)
    w2, b2 = rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1)
    z, y, xn, h = fh.proj_mlp_forward_reference(x, o, wo, bo, gamma, beta, w1, b1, w2, b2, eps)
    y2, _ = fh.gemm_wgmma(o, wo, "bias_residual", bo, x)
    _, xn2 = fh.ln_gemm_forward_reference(y2, gamma, beta, w1, eps)
    g2, h2 = fh.gemm_wgmma(xn2, w1, "bias_gelu_save", b1)
    served, none = fh.gemm_wgmma(xn2, w1, "bias_gelu", b1)
    z2, _ = fh.gemm_wgmma(g2, w2, "bias_residual", b2, y2)
    for got, want in ((y2, y), (xn2, xn), (h2, h), (z2, z), (served, g2)):
        assert torch.equal(got, want)
    assert none is None
    qkv, xn1 = fh.ln_gemm_forward_reference(x, gamma, beta, w1, eps)
    assert torch.equal(fh.gemm_wgmma(xn1, w1, "store")[0], qkv)
