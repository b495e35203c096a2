"""The flash-attention op of the port against ``vit_tpu``'s Pallas kernels,
in f32 on the CPU, where the port's op runs its plain versions and the JAX
kernels run in interpret mode (``pltpu.force_tpu_interpret_mode()``, as
``tests/unit/test_flash_attention.py`` runs them).

- The forward, out and lse, against ``_flash_forward``, and the VJP against
  ``jax.grad`` through ``flash_attention``: n_q ≠ n_k at lengths that are not
  block multiples (70 against 130; CvT's 3136 against 784 scaled down to 196
  against 49), d ∈ {32, 64, 96}.  ``flash_attention_v2`` against ``vit_tpu``'s
  with small blocks; ``flash_backward`` against ``vit_tpu``'s, fed the same
  lse and out.  The tolerances are that file's: 2e-5 for out and lse, 5e-5
  for the gradients.
- The dispatcher: d = 40 zero-padded against ``vit_tpu``'s padded dispatch;
  ``"force"`` with a bias or mask raises; the tier decisions as a table, with
  the CUDA check patched to take CPU tensors.
- The channel-packed op against ``vit_tpu``'s ``flash_attention_packed(...,
  interpret=True)``, forward and VJP, at that kernel's test shapes, with
  dk != dv (32 / 48, where ``vit_tpu`` recomputes the backward through XLA,
  and ScalableViT's 40 / 32), within 1e-5 of max(1, max|ref|); and
  ``packed_window_attention``'s routes against ``vit_tpu``'s.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from vit_tpu.ops import attention as jax_attention  # noqa: E402
from vit_tpu.ops import flash_attention as jax_fa  # noqa: E402
from vit_tpu.ops.flash_attention_v2 import flash_attention_v2 as jax_flash_v2  # noqa: E402
from vit_tpu.ops.flash_attention_packed import flash_attention_packed as jax_packed  # noqa: E402
from vit_tpu.ops.flash_backward import flash_backward as jax_flash_backward  # noqa: E402
from vit_tpu_torch.ops import attention  # noqa: E402
from vit_tpu_torch.ops import flash_attention_packed as fap  # noqa: E402
from vit_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_forward, flash_attention_forward_reference,
    flash_attention_v2, flash_backward, flash_backward_reference,
)

TOL_OUT = 2e-5
TOL_GRAD = 5e-5
# (b, h, n_q, n_k, d)
CASES = [
    (1, 2, 70, 130, 64),   # ragged ends on both sides, n_q < n_k
    (2, 1, 196, 49, 64),   # CvT stage 1's 3136 x 784, scaled down by 16
    (1, 2, 33, 100, 32),
    (1, 1, 80, 48, 96),
]


def _qkvg(b, h, n_q, n_k, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, n_q, d)).astype(np.float32),
            rng.standard_normal((b, h, n_k, d)).astype(np.float32),
            rng.standard_normal((b, h, n_k, d)).astype(np.float32),
            rng.standard_normal((b, h, n_q, d)).astype(np.float32))


def _maxdiff(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _port_vjp(op, q, k, v, g, **kw):
    """The port's output and input gradients for cotangent ``g``."""
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = op(*inputs, **kw)
    return out.detach(), torch.autograd.grad(out, inputs, torch.from_numpy(g))


@pytest.mark.parametrize("b,h,n_q,n_k,d", CASES)
def test_flash_forward_and_vjp_match_jax_kernel(b, h, n_q, n_k, d):
    q, k, v, g = _qkvg(b, h, n_q, n_k, d)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out_want, lse_want = jax_fa._flash_forward(*map(jnp.asarray, (q, k, v)), scale)
        _, vjp = jax.vjp(lambda *a: jax_fa.flash_attention(*a, scale), *map(jnp.asarray, (q, k, v)))
        grads_want = vjp(jnp.asarray(g))
    counts = (flash_attention.launches, flash_backward.launches)
    out, lse = flash_attention_forward(*map(torch.from_numpy, (q, k, v)), scale)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n_q)
    assert _maxdiff(out, out_want) <= TOL_OUT
    assert _maxdiff(lse, lse_want) <= TOL_OUT
    out, grads = _port_vjp(flash_attention, q, k, v, g, scale=scale)
    assert (flash_attention.launches, flash_backward.launches) == counts  # CPU: plain versions
    assert _maxdiff(out, out_want) <= TOL_OUT
    for name, got, want in zip("qkv", grads, grads_want):
        assert got.shape == want.shape and _maxdiff(got, want) <= TOL_GRAD, name


def test_flash_v2_matches_jax_v2_with_small_blocks():
    q, k, v, g = _qkvg(1, 2, 300, 300, 64, seed=3)
    scale = 64 ** -0.5
    with pltpu.force_tpu_interpret_mode():
        out_want, vjp = jax.vjp(lambda *a: jax_flash_v2(*a, scale, 128, 128),
                                *map(jnp.asarray, (q, k, v)))
        grads_want = vjp(jnp.asarray(g))
    out, grads = _port_vjp(flash_attention_v2, q, k, v, g, scale=scale)
    assert _maxdiff(out, out_want) <= TOL_OUT
    for name, got, want in zip("qkv", grads, grads_want):
        assert _maxdiff(got, want) <= TOL_GRAD, name


@pytest.mark.parametrize("b,h,n_q,n_k,d", CASES[:2])
def test_flash_backward_matches_jax_backward(b, h, n_q, n_k, d):
    """Both backwards fed the same out and lse (JAX's forward's) and cotangent."""
    q, k, v, g = _qkvg(b, h, n_q, n_k, d, seed=5)
    scale = d ** -0.5
    with pltpu.force_tpu_interpret_mode():
        o, lse = jax_fa._flash_forward(*map(jnp.asarray, (q, k, v)), scale)
        want = jax_flash_backward(*map(jnp.asarray, (q, k, v)), o, lse, jnp.asarray(g), scale,
                                  interpret=True)
    t = torch.from_numpy
    got = flash_backward(t(q), t(k), t(v), t(np.array(o)), t(np.array(lse)), t(g), scale)
    for name, a, w in zip("qkv", got, want):
        assert a.shape == w.shape and _maxdiff(a, w) <= TOL_GRAD, name


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32, where no rounding point rounds: autograd through the plain
    forward against the plain backward, to f32 precision."""
    q, k, v, g = _qkvg(2, 2, 37, 21, 32, seed=7)
    inputs = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out, lse = flash_attention_forward_reference(*inputs, 0.3)
    want = torch.autograd.grad(out, inputs, torch.from_numpy(g))
    got = flash_backward_reference(*(t.detach() for t in inputs), out.detach(), lse.detach(),
                                   torch.from_numpy(g), 0.3)
    for a, w in zip(got, want):
        assert _maxdiff(a, w) <= 1e-5


def test_dispatch_pads_a_head_width_off_the_32_grid():
    """ScalableViT's dim_key 40: zero-padded to 64 and sliced back, against
    vit_tpu's padded dispatch, forward and gradients."""
    q, k, v, g = _qkvg(2, 2, 64, 48, 40, seed=9)
    scale = 40 ** -0.5

    def jax_op(*a):
        return jax_attention.scaled_dot_product_attention(*a, scale=scale, use_flash="force")

    with pltpu.force_tpu_interpret_mode():
        out_want, vjp = jax.vjp(jax_op, *map(jnp.asarray, (q, k, v)))
        grads_want = vjp(jnp.asarray(g))
    calls = []

    def counted(*a, f=attention.flash_attention):
        calls.append(a[0].shape)
        return f(*a)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(attention, "flash_attention", counted)
        out, grads = _port_vjp(attention.scaled_dot_product_attention, q, k, v, g,
                               scale=scale, use_flash="force")
    assert calls == [(2, 2, 64, 64)] and out.shape == (2, 2, 64, 40)
    assert _maxdiff(out, out_want) <= TOL_OUT
    for name, got, want in zip("qkv", grads, grads_want):
        assert got.shape == want.shape and _maxdiff(got, want) <= TOL_GRAD, name


def test_force_with_a_bias_or_a_mask_raises():
    q = torch.zeros(1, 1, 16, 32)
    with pytest.raises(ValueError, match="bias or mask"):
        attention.scaled_dot_product_attention(q, q, q, bias=torch.zeros(1, 1, 16, 16),
                                               use_flash="force")
    with pytest.raises(ValueError, match="bias or mask"):
        attention.scaled_dot_product_attention(q, q, q, mask=torch.ones(1, 1, 16, 16, dtype=bool),
                                               use_flash="force")
    with pytest.raises(ValueError, match="use_flash"):
        attention.scaled_dot_product_attention(q, q, q, use_flash="interpret")


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,n_q,n_k,d,d_v,extra,flash", [
    (BF16, 1024, 1024, 32, 32, None, True),     # the 16-bit tier at its edge
    (F16, 3136, 784, 64, 64, None, True),       # CvT-13 stage 1 @224: the larger n counts
    (BF16, 64, 1024, 64, 64, None, True),
    (BF16, 2048, 2048, 40, 40, None, True),     # an odd width rides flash, padded
    (BF16, 1023, 1023, 32, 32, None, False),    # below the tier
    (BF16, 784, 196, 64, 64, None, False),      # CvT-13 stage 2 @224
    (F32, 2048, 2048, 32, 32, None, False),     # f32: plain on the port (vit_tpu: flash)
    (F32, 9216, 2304, 64, 64, None, False),
    (BF16, 2048, 2048, 32, 32, "bias", False),  # bias and mask ride the plain path
    (BF16, 2048, 2048, 32, 32, "mask", False),
    (BF16, 2048, 2048, 32, 48, None, False),    # q and v of different widths
])
def test_flash_tier_decisions(monkeypatch, dtype, n_q, n_k, d, d_v, extra, flash):
    """``_use_flash`` with the CUDA check patched to take a CPU tensor of a
    16-bit dtype (expanded zero-stride tensors: no memory is touched)."""
    monkeypatch.setattr(attention, "flash_tensor", lambda t: t.dtype in (BF16, F16))
    q = torch.zeros(()).to(dtype).expand(1, 2, n_q, d)
    k = torch.zeros(()).to(dtype).expand(1, 2, n_k, d)
    v = torch.zeros(()).to(dtype).expand(1, 2, n_k, d_v)
    bias = torch.zeros(1, 1, 1, 1) if extra == "bias" else None
    mask = torch.ones(1, 1, 1, 1, dtype=torch.bool) if extra == "mask" else None
    assert attention._use_flash(q, k, v, bias, mask) == flash


def test_cpu_tensors_take_the_plain_path_at_the_tier():
    """Unpatched, a CPU tensor never reaches the flash op, whatever n."""
    q = torch.zeros(()).to(BF16).expand(1, 1, 4096, 32)
    assert not attention._use_flash(q, q, q, None, None)


# (b, n, heads, dk, dv) for the channel-packed op.
PACKED_CASES = [
    (1, 256, 2, 32, 32),  # tests/unit/test_flash_packed.py's shapes, one image
    (1, 200, 2, 32, 32),  # a ragged last tile
    (1, 128, 2, 32, 48),  # dk != dv: vit_tpu's XLA-recompute backward
    (1, 96, 2, 40, 32),   # ScalableViT's SSA widths
]
PACKED_TOL = 1e-5


def _packed(b, n, heads, dk, dv, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, heads * d)).astype(np.float32)
                 for d in (dk, dk, dv, dv))


def _packed_close(got, want, name):
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    err = _maxdiff(got, want)
    assert err <= PACKED_TOL * max(1.0, float(np.max(np.abs(want)))), (name, err)


@pytest.mark.parametrize("b,n,heads,dk,dv", PACKED_CASES)
def test_packed_forward_and_vjp_match_jax_kernel(b, n, heads, dk, dv):
    q, k, v, g = _packed(b, n, heads, dk, dv)
    scale = dk ** -0.5
    out_want, vjp = jax.vjp(lambda *a: jax_packed(*a, heads, scale, True),
                            *map(jnp.asarray, (q, k, v)))
    grads_want = vjp(jnp.asarray(g))
    counts = (fap.flash_attention_packed.launches, flash_backward.launches)
    out, grads = _port_vjp(fap.flash_attention_packed, q, k, v, g, heads=heads, scale=scale)
    assert (fap.flash_attention_packed.launches, flash_backward.launches) == counts
    _packed_close(out, out_want, "out")
    for name, got, want in zip("qkv", grads, grads_want):
        _packed_close(got, want, f"d{name}")


def test_packed_lse_is_the_head_major_ops():
    q, k, v, _ = _packed(2, 70, 2, 40, 32, seed=1)
    t = torch.from_numpy
    out, lse = fap.flash_attention_packed_forward(t(q), t(k), t(v), 2)
    want_out, want_lse = flash_attention_forward(
        *(fap.split_heads(t(a), 2) for a in (q, k, v)), 40 ** -0.5)
    assert torch.equal(out, fap.merge_heads(want_out)) and torch.equal(lse, want_lse)


def _open_packed_gate(monkeypatch, calls):
    """Let f32 CPU calls at n >= 64 through the flash tier, counting the
    packed op's and the head-major op's calls; the ops then run their plain
    versions."""
    monkeypatch.setattr(attention, "flash_tensor", lambda t: True)
    monkeypatch.setattr(attention, "FLASH_MIN_SEQ", 64)
    for name in ("flash_attention_packed", "flash_attention"):
        monkeypatch.setattr(attention, name, lambda *a, f=getattr(attention, name), name=name:
                            calls.append((name, a[0].shape)) or f(*a))


@pytest.mark.parametrize("route,dk,dv,launched", [
    ("auto", 32, 32, ("flash_attention_packed", (1, 64, 64))),
    ("auto", 32, 48, ("flash_attention", (1, 2, 64, 64))),   # no (32, 48) instance: padded
    ("force", 16, 16, ("flash_attention", (1, 2, 64, 64))),  # 16 padded to 64
    ("never", 32, 32, None),
])
def test_packed_window_attention_routes_match_jax(monkeypatch, route, dk, dv, launched):
    """Each route against ``vit_tpu``'s packed dispatcher on the same inputs:
    its interpret mode (the packed kernel) for the flash routes, ``"never"``
    for the plain one."""
    q, k, v, g = _packed(1, 64, 2, dk, dv, seed=2)
    scale = dk ** -0.5
    mode = "never" if route == "never" else "interpret"
    out_want, vjp = jax.vjp(
        lambda *a: jax_attention.packed_window_attention(*a, 2, scale=scale, mode=mode),
        *map(jnp.asarray, (q, k, v)))
    grads_want = vjp(jnp.asarray(g))
    calls = []
    _open_packed_gate(monkeypatch, calls)
    out, grads = _port_vjp(attention.packed_window_attention, q, k, v, g, heads=2, scale=scale,
                           mode=route)
    assert calls == ([launched] if launched else [])
    _packed_close(out, out_want, "out")
    for name, got, want in zip("qkv", grads, grads_want):
        _packed_close(got, want, f"d{name}")


@pytest.mark.parametrize("dtype,n,n_k,dk,dv,mode,route", [
    (BF16, 4096, 4096, 32, 32, "auto", "packed"),   # ScalableViT stage-1 IWSA
    (BF16, 1024, 1024, 32, 32, "auto", "packed"),   # stage 2: the 16-bit tier's edge
    (F16, 256, 1024, 40, 32, "auto", "packed"),     # the larger n counts
    (BF16, 8192, 8192, 32, 32, "auto", "packed"),   # no n_k <= 4096 cap (vit_tpu: VMEM)
    (BF16, 1024, 1024, 16, 16, "auto", "padded"),   # widths without an instance
    (BF16, 1023, 1023, 32, 32, "auto", "plain"),    # below the tier
    (BF16, 256, 256, 32, 32, "auto", "plain"),      # stage 3
    (F32, 4096, 4096, 32, 32, "auto", "plain"),     # f32: plain on the port
    (BF16, 4096, 4096, 32, 32, "never", "plain"),
    (F32, 64, 64, 32, 32, "force", "packed"),
])
def test_packed_tier_decisions(monkeypatch, dtype, n, n_k, dk, dv, mode, route):
    """The route ``packed_window_attention`` takes, with the CUDA check
    patched to take a CPU tensor of a 16-bit dtype and the ops replaced by
    recorders (expanded zero-stride inputs: no memory is touched)."""
    taken = []
    monkeypatch.setattr(attention, "flash_tensor", lambda t: t.dtype in (BF16, F16))
    for name, tag in (("flash_attention_packed", "packed"), ("_flash", "padded"),
                      ("scaled_dot_product_attention", "plain")):
        monkeypatch.setattr(attention, name, lambda q, *a, tag=tag, **kw: taken.append(tag) or q)
    heads = 2
    q = torch.zeros(()).to(dtype).expand(1, n, heads * dk)
    k = torch.zeros(()).to(dtype).expand(1, n_k, heads * dk)
    v = torch.zeros(()).to(dtype).expand(1, n_k, heads * dv)
    attention.packed_window_attention(q, k, v, heads, mode=mode)
    assert taken == [route]


def test_packed_window_attention_refuses_tpu_modes_and_bad_heads():
    q = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="TPU-only"):
        attention.packed_window_attention(q, q, q, 2, mode="interpret")
    with pytest.raises(ValueError, match="mode"):
        attention.packed_window_attention(q, q, q, 2, mode="sometimes")
    with pytest.raises(ValueError, match="heads"):
        attention.packed_window_attention(q, q, q, 3)
