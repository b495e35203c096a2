"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (from a fixture) where there is no CUDA device.
On a machine with a card and without JAX, run with
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py``.

Tolerance: ``chip_smoke.block_error``.  Both sides take the same bf16/f16
inputs and round at the same points; they differ by f32 summation order, which
can flip a rounding of an intermediate (xn, qkv, P, the attention output,
gelu(h); in the backward doattn, T(p), ds, dh) by one unit.  Each block
returns ``T(x + T(f(x)))``, so an element may differ by one unit of the output
(the final add's rounding) plus ``2e-2 · max|ref - x|``, a few units of the
block's own output; the residual x ~ N(0, 1) does not widen the bound.  The
backward's outputs are held the same way: dx = T(dy + T(dx_ln)) against its
residual dy, the others (dh, gact, dqkv and the f32 sums) against 0.  The
biased block's dbias, an f32 sum over images and heads, has its own bound
(``chip_smoke.check_dbias``).
"""

import pytest
import torch

from chip_smoke import block_error, check_dbias, check_outputs
from vit_tpu_torch import ViT, cast_params
from vit_tpu_torch.models import vit_for_small_dataset
from vit_tpu_torch.ops import fused_attention_block as fused_attention_block_ops
from vit_tpu_torch.ops import fused_mlp as fused_mlp_ops
from vit_tpu_torch.ops.fused_attention_block import (
    fused_attention_block, fused_attention_block_backward,
    fused_attention_block_backward_reference, fused_attention_block_bias,
    fused_attention_block_bias_backward, fused_attention_block_forward_reference,
    fused_attention_block_reference,
)
from vit_tpu_torch.ops.fused_mlp import (
    fused_mlp, fused_mlp_backward, fused_mlp_backward_reference, fused_mlp_forward_reference,
    fused_mlp_reference,
)
from vit_tpu_torch.parallel.train import make_train_step

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _mlp_args(shape, hidden, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    d = shape[-1]

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    return (rn(*shape).to(dtype), (1.0 + rn(d, scale=0.1)).to(dtype),
            rn(d, scale=0.1).to(dtype), rn(hidden, d, scale=d ** -0.5).to(dtype), rn(hidden, scale=0.1).to(dtype),
            rn(d, hidden, scale=hidden ** -0.5).to(dtype), rn(d, scale=0.1).to(dtype))


def _attn_args(b, n, d, heads, dh, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    inner = heads * dh

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=device) * scale

    return (rn(b, n, d).to(dtype), (1.0 + rn(d, scale=0.1)).to(dtype),
            rn(d, scale=0.1).to(dtype), rn(3 * inner, d, scale=d ** -0.5).to(dtype),
            rn(d, inner, scale=inner ** -0.5).to(dtype), rn(d, scale=0.1).to(dtype))


def _close(out, ref, x):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    _, excess, tol = block_error(torch, out, ref, x)
    assert excess <= tol, (excess, tol)


@pytest.mark.parametrize("shape,hidden,dtype", [
    ((2, 17, 64), 128, torch.bfloat16),
    ((3, 67, 96), 160, torch.bfloat16),
    ((3, 67, 96), 160, torch.float16),
    ((2, 33, 104), 200, torch.bfloat16),  # partial k tiles (104, 200) and n tiles
    ((520, 1024), 2048, torch.bfloat16),
    ((8, 65, 1024), 2048, torch.bfloat16),
    ((64, 197, 768), 3072, torch.bfloat16),
])
def test_fused_mlp_kernel_matches_plain(cuda, shape, hidden, dtype):
    args = _mlp_args(shape, hidden, dtype, cuda)
    with torch.inference_mode():
        before = fused_mlp.launches
        out = fused_mlp(*args)
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        _close(out, fused_mlp_reference(*args), args[0])


@pytest.mark.parametrize("b,n,d,heads,dh,dtype", [
    (3, 67, 96, 3, 32, torch.bfloat16),
    (3, 67, 96, 3, 32, torch.float16),
    (2, 145, 256, 4, 64, torch.bfloat16),
    (2, 70, 256, 2, 128, torch.bfloat16),
    (1, 1, 64, 2, 32, torch.bfloat16),
    (2, 33, 40, 1, 32, torch.bfloat16),     # d=40: a partial k tile in the QKV GEMM
    (1, 1000, 64, 2, 64, torch.bfloat16),   # 16 key tiles of online softmax
    (8, 65, 1024, 16, 64, torch.bfloat16),
    (64, 197, 768, 12, 64, torch.bfloat16),
])
def test_fused_attention_block_kernel_matches_plain(cuda, b, n, d, heads, dh, dtype):
    args = _attn_args(b, n, d, heads, dh, dtype, cuda)
    with torch.inference_mode():
        before = fused_attention_block.launches
        out = fused_attention_block(*args, heads, dh)
        torch.cuda.synchronize()
        assert fused_attention_block.launches == before + 1
        _close(out, fused_attention_block_reference(*args, heads, dh), args[0])


@pytest.mark.parametrize("shape,hidden,dtype", [
    ((2, 17, 64), 128, torch.bfloat16),
    ((3, 67, 96), 160, torch.float16),
    ((2, 33, 104), 200, torch.bfloat16),  # partial k and n tiles of the dgrad GEMMs
    ((520, 1024), 2048, torch.bfloat16),
    ((64, 197, 768), 3072, torch.bfloat16),
])
def test_fused_mlp_backward_kernel_matches_plain(cuda, shape, hidden, dtype):
    args = _mlp_args(shape, hidden, dtype, cuda, seed=1)
    x, gamma, beta, w1, b1, w2, b2 = args
    h = fused_mlp_forward_reference(*args)[2]
    dy = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(dtype)
    before = fused_mlp_backward.launches
    out = fused_mlp_backward(dy, x, h, gamma, w1, w2)
    torch.cuda.synchronize()
    assert fused_mlp_backward.launches == before + 1
    ref = fused_mlp_backward_reference(dy, x, h, gamma, w1, w2)
    check_outputs(torch, "fused_mlp_bwd", out, ref, {0: dy})


@pytest.mark.parametrize("b,n,d,heads,dh,dtype", [
    (3, 67, 96, 3, 32, torch.bfloat16),
    (3, 67, 96, 3, 32, torch.float16),
    (2, 145, 256, 4, 64, torch.bfloat16),
    (2, 70, 256, 2, 128, torch.bfloat16),
    (1, 1, 64, 2, 32, torch.bfloat16),
    (2, 33, 40, 1, 32, torch.bfloat16),     # d=40: partial tiles in the dgrad GEMMs
    (1, 1000, 64, 2, 64, torch.bfloat16),   # 16 key and query tiles
    (2, 257, 1024, 16, 64, torch.bfloat16), # ViT-L/14 @224's n
    (8, 65, 1024, 16, 64, torch.bfloat16),
    (64, 197, 768, 12, 64, torch.bfloat16),
])
def test_fused_attention_block_backward_kernel_matches_plain(cuda, b, n, d, heads, dh, dtype):
    args = _attn_args(b, n, d, heads, dh, dtype, cuda, seed=1)
    x, gamma, beta, wqkv, wo, bo = args
    qkv = fused_attention_block_forward_reference(*args, heads, dh)[2]
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(dtype)
    before = fused_attention_block_backward.launches
    out = fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh)
    torch.cuda.synchronize()
    assert fused_attention_block_backward.launches == before + 1
    ref = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh)
    check_outputs(torch, "fused_attention_block_bwd", out, ref, {0: dy})


@pytest.mark.parametrize("shape,hidden,dtype", [
    ((2, 17, 64), 128, torch.bfloat16),
    ((3, 67, 96), 160, torch.float16),
    ((2, 33, 104), 200, torch.bfloat16),
    ((128, 65, 1024), 2048, torch.bfloat16),
])
def test_fused_mlp_training_forward_keeps_the_plain_residuals(cuda, shape, hidden, dtype):
    """The training forward (what grad mode launches) returns y, xn and the
    pre-activation h as the plain version computes them."""
    args = _mlp_args(shape, hidden, dtype, cuda, seed=3)
    out = fused_mlp_ops._launch_forward(*args, 1e-3, save_residuals=True)
    check_outputs(torch, "fused_mlp training forward", out,
                  fused_mlp_forward_reference(*args), {0: args[0]})


@pytest.mark.parametrize("b,n,d,heads,dh,dtype", [
    (3, 67, 96, 3, 32, torch.bfloat16),
    (3, 67, 96, 3, 32, torch.float16),
    (2, 70, 256, 2, 128, torch.bfloat16),
    (128, 65, 1024, 16, 64, torch.bfloat16),
])
def test_fused_attention_block_training_forward_keeps_the_plain_residuals(cuda, b, n, d, heads,
                                                                          dh, dtype):
    """The training forward returns y, xn, qkv and oattn as the plain version
    computes them."""
    args = _attn_args(b, n, d, heads, dh, dtype, cuda, seed=3)
    out = fused_attention_block_ops._launch_forward(*args, heads, dh, dh ** -0.5, 1e-3)
    check_outputs(torch, "fused_attention_block training forward", out,
                  fused_attention_block_forward_reference(*args, heads, dh), {0: args[0]})


def test_grad_mode_runs_the_forward_and_backward_kernels(cuda):
    """Under grad the training forward kernels run and keep their residuals,
    and the gradients flow to every input through the backward kernels and
    the weight-gradient GEMMs."""
    args = [t.requires_grad_() for t in _mlp_args((2, 33, 96), 192, torch.bfloat16, cuda)]
    counts = (fused_mlp.launches, fused_mlp_backward.launches)
    y = fused_mlp(*args)
    y.float().square().sum().backward()
    assert (fused_mlp.launches - counts[0], fused_mlp_backward.launches - counts[1]) == (1, 1)
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)
    args = [t.requires_grad_() for t in _attn_args(2, 33, 96, 3, 32, torch.bfloat16, cuda)]
    counts = (fused_attention_block.launches, fused_attention_block_backward.launches)
    y = fused_attention_block(*args, 3, 32)
    y.float().square().sum().backward()
    assert (fused_attention_block.launches - counts[0],
            fused_attention_block_backward.launches - counts[1]) == (1, 1)
    assert all(a.grad is not None and torch.isfinite(a.grad).all() for a in args)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x, *rest = _attn_args(2, 9, 96, 2, 48, torch.bfloat16, cuda)
    with torch.inference_mode(), pytest.raises(ValueError):
        fused_attention_block(x, *rest, 2, 48)  # dim_head 48 has no instance
    with pytest.raises(ValueError):
        fused_attention_block(x.requires_grad_(), *rest, 2, 48)  # nor under grad
    args = _mlp_args((2, 9, 64), 128, torch.float32, cuda)
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_mlp(*args)  # f32 has no kernel
    args = _mlp_args((2, 9, 60), 128, torch.bfloat16, cuda)
    args[3].requires_grad_(True)
    with pytest.raises(ValueError):
        fused_mlp(*args)  # d = 60: rows of 16 bytes only for multiples of 8


def _tiny_vit(cuda, **kw):
    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=96, depth=2,
               heads=3, mlp_dim=192, **kw)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = cast_params(ViT(**cfg, device=cuda, generator=g), torch.bfloat16).eval()
    return model, torch.randn(2, 32, 32, 3, generator=g, device=cuda)


def test_auto_runs_the_kernels_at_every_layer(cuda):
    model, img = _tiny_vit(cuda, dim_head=32)
    counts = (fused_attention_block.launches, fused_mlp.launches)
    with torch.inference_mode():
        out = model(img)
    assert (fused_attention_block.launches - counts[0],
            fused_mlp.launches - counts[1]) == (2, 2)
    assert out.shape == (2, 10) and torch.isfinite(out).all()


def _launches():
    return (fused_attention_block.launches, fused_mlp.launches,
            fused_attention_block_backward.launches, fused_mlp_backward.launches)


def test_auto_raises_instead_of_running_plain(cuda):
    """A 16-bit CUDA model never swaps in the plain modules where the kernels
    apply: a head width without a kernel instance raises, in inference and in
    training; a call under grad runs the forward and backward kernels."""
    model, img = _tiny_vit(cuda, dim_head=48)
    with torch.inference_mode(), pytest.raises(ValueError, match="dim_head"):
        model(img)
    with pytest.raises(ValueError, match="dim_head"):
        model.train()(img)
    model, img = _tiny_vit(cuda, dim_head=32)
    counts = _launches()
    model(img).float().sum().backward()  # grad mode on, eval
    assert [a - b for a, b in zip(_launches(), counts)] == [2, 2, 2, 2]


def test_training_gate_follows_dropout(cuda):
    """Training with dropout 0 runs the kernels; active dropout runs the
    plain modules, as vit_tpu's gate."""
    for dropout, expect in ((0.0, [2, 2, 2, 2]), (0.1, [0, 0, 0, 0])):
        model, img = _tiny_vit(cuda, dim_head=32, dropout=dropout)
        counts = _launches()
        model.train()(img).float().sum().backward()
        assert [a - b for a, b in zip(_launches(), counts)] == expect


def test_train_step_on_the_card(cuda):
    """f32 parameters, bf16 compute: f32 gradients, every kernel launched
    depth times per step, a falling loss."""
    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=96, depth=2, heads=3,
               dim_head=32, mlp_dim=192)
    g = torch.Generator(device=cuda).manual_seed(0)
    model = ViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    assert all(p.is_cuda and p.dtype == torch.float32 for p in model.parameters())
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05))
    img = torch.randn(8, 32, 32, 3, generator=g, device=cuda)
    labels = torch.arange(8, device=cuda) % 10
    losses = []
    for _ in range(3):
        counts = _launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(_launches(), counts)] == [2, 2, 2, 2]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert losses[2] < losses[0]


def _bias(kind, heads, n, device, seed=5):
    """A ``(1, n, n)`` or ``(heads, n, n)`` f32 logits bias, or LSA's mask."""
    if kind == "lsa":
        return vit_for_small_dataset.lsa_bias(n, device)
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(1 if kind == "shared" else heads, n, n, generator=g, device=device) * 0.5


@pytest.mark.parametrize("n", [65, 197, 257])
@pytest.mark.parametrize("kind", ["shared", "per-head"])
def test_fused_attention_block_bias_kernels_match_plain(cuda, n, kind):
    """Serving forward, training forward and backward (dbias included) of the
    biased block against their plain versions."""
    b, d, heads, dh = 2, 256, 4, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=4)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias(kind, heads, n, cuda)
    with torch.inference_mode():
        before = (fused_attention_block.launches, fused_attention_block_bias.launches)
        out = fused_attention_block_bias(*args, bias, heads, dh)
        torch.cuda.synchronize()
        assert (fused_attention_block.launches,
                fused_attention_block_bias.launches) == (before[0], before[1] + 1)
        _close(out, fused_attention_block_reference(*args, heads, dh, bias=bias), x)
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, dh ** -0.5, 1e-3, bias)
    check_outputs(torch, "biased training forward", fwd,
                  fused_attention_block_forward_reference(*args, heads, dh, bias=bias), {0: x})
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda).to(torch.bfloat16)
    before = (fused_attention_block_backward.launches, fused_attention_block_bias_backward.launches)
    got = fused_attention_block_bias_backward(dy, x, fwd[2], gamma, wqkv, wo, bias, heads, dh)
    torch.cuda.synchronize()
    assert (fused_attention_block_backward.launches,
            fused_attention_block_bias_backward.launches) == (before[0], before[1] + 1)
    ref = fused_attention_block_backward_reference(dy, x, fwd[2], gamma, wqkv, wo, heads, dh,
                                                   bias=bias)
    check_outputs(torch, "biased backward", got[:5], ref[:5], {0: dy})
    check_dbias(torch, "biased backward", got[5], ref[5])


@pytest.mark.parametrize("hb", [1, 4])
def test_dbias_is_the_same_bits_every_run(cuda, hb):
    b, n, d, heads, dh = 8, 257, 256, 4, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=7)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias("shared" if hb == 1 else "per-head", heads, n, cuda)
    qkv = fused_attention_block_forward_reference(*args, heads, dh, bias=bias)[2]
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(8),
                     device=cuda).to(torch.bfloat16)
    runs = [fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh)[5]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("n", [65, 257])
def test_lsa_bias_gives_finite_outputs_one_past_a_key_tile(cuda, n):
    """LSA's -f32.max diagonal at n ≡ 1 (mod 64), where the last key tile's
    only key is the last query's own masked one: finite, and as the plain
    version computes it, forward and backward."""
    b, d, heads, dh = 2, 256, 4, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=9)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias("lsa", heads, n, cuda)
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, 1.0, 1e-3, bias)
    check_outputs(torch, "LSA training forward", fwd,
                  fused_attention_block_forward_reference(*args, heads, dh, 1.0, bias=bias),
                  {0: x})
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(10),
                     device=cuda).to(torch.bfloat16)
    got = fused_attention_block_bias_backward(dy, x, fwd[2], gamma, wqkv, wo, bias, heads, dh,
                                              1.0, need_dbias=False)
    assert got[5] is None
    ref = fused_attention_block_backward_reference(dy, x, fwd[2], gamma, wqkv, wo, heads, dh,
                                                   1.0, bias=bias, need_dbias=False)
    check_outputs(torch, "LSA backward", got[:5], ref[:5], {0: dy})


def test_bias_that_the_kernel_does_not_take_raises_on_the_card(cuda):
    x, *rest = _attn_args(2, 9, 96, 3, 32, torch.bfloat16, cuda)
    xg = x.detach().requires_grad_()
    for bad in (torch.zeros(1, 9, 9, device=cuda, dtype=torch.bfloat16),
                torch.zeros(2, 9, 9, device=cuda), torch.zeros(1, 9, 10, device=cuda),
                torch.zeros(1, 9, 9)):
        with torch.inference_mode(), pytest.raises(ValueError, match="bias"):
            fused_attention_block_bias(x, *rest, bad, 3, 32)
        with pytest.raises(ValueError, match="bias"):
            fused_attention_block_bias(xg, *rest, bad, 3, 32)


def _bias_launches():
    return (fused_attention_block.launches, fused_attention_block_bias.launches,
            fused_mlp.launches, fused_attention_block_backward.launches,
            fused_attention_block_bias_backward.launches, fused_mlp_backward.launches)


def test_small_dataset_vit_runs_the_biased_kernel_at_every_layer(cuda):
    """Serving and a train step of the small-dataset ViT: the biased kernels
    and the MLP kernels depth times each, the unbiased block never; f32
    gradients, the temperatures' included, and a falling loss."""
    cfg = dict(image_size=32, patch_size=4, num_classes=10, dim=96, depth=2, heads=3,
               dim_head=32, mlp_dim=192)  # n = 65
    g = torch.Generator(device=cuda).manual_seed(0)
    model = vit_for_small_dataset.ViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    img = torch.randn(8, 32, 32, 3, generator=g, device=cuda)
    with torch.inference_mode():
        counts = _bias_launches()
        out = model.eval()(img)
    assert [a - b for a, b in zip(_bias_launches(), counts)] == [0, 2, 2, 0, 0, 0]
    assert out.shape == (8, 10) and torch.isfinite(out).all()
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05))
    labels = torch.arange(8, device=cuda) % 10
    losses = []
    for _ in range(3):
        counts = _bias_launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(_bias_launches(), counts)] == [0, 2, 2, 0, 2, 2]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(float(layer["attn"].temperature.grad) != 0 for layer in model.layers)
    assert losses[2] < losses[0]
