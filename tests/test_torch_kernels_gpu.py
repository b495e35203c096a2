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
(``chip_smoke.check_dbias``).  The flash kernels' outputs are held against
their plain versions the same way, with no residual (out; dq, dk, dv fed
the kernel's own out and lse), and lse within ``chip_smoke.LSE_ABS_TOL``; so
are the channel-packed op and the cross-attention block (y against its
residual x; q, oattn, dxn, dq, dk, dv against 0; dbo, an f32 sum over the
batch, within ``chip_smoke.DBIAS_REL_TOL``), the short-attention op and the
hybrid layer's three (z against its residual y, y against x, dy against dz;
the rest, f32 sums included, against 0).
"""

import pytest
import torch

from chip_smoke import LSE_ABS_TOL, block_error, check_dbias, check_outputs, flash_inputs
from vit_tpu_torch import CvT, ScalableViT, ViT, cast_params
from vit_tpu_torch.models import vit_for_small_dataset
from vit_tpu_torch.ops import attention as attention_ops
from vit_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_forward, flash_attention_forward_reference, flash_backward,
    flash_backward_reference,
)
from vit_tpu_torch.ops import flash_attention_packed as fap
from vit_tpu_torch.ops import fused_attention_block as fused_attention_block_ops
from vit_tpu_torch.ops import fused_cross_attention as fca
from vit_tpu_torch.ops import fused_mlp as fused_mlp_ops
from vit_tpu_torch.ops import fused_hybrid as fh
from vit_tpu_torch.ops import short_attention as sa
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


def _twice(got, again):
    assert all(a is b_ is None or torch.equal(a, b_) for a, b_ in zip(got, again))


def _close(out, ref, x):
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out).all()
    _, excess, tol = block_error(torch, out, ref, x)
    assert excess <= tol, (excess, tol)


# The fused MLP's forward at the shapes of its two GEMM kernels: fc1 and fc2
# on gemm_wgmma from n = 256, on linear.cu below it (launch_forward_gemm).
MLP_FORWARD_SHAPES = [
    ((2, 17, 64), 128, torch.bfloat16),   # both GEMMs below n 256: linear.cu
    ((3, 67, 96), 160, torch.bfloat16),
    ((3, 67, 96), 160, torch.float16),
    ((2, 33, 104), 200, torch.bfloat16),  # partial k tiles (104, 200) and n tiles
    ((2, 33, 104), 264, torch.bfloat16),  # fc1 on gemm_wgmma at a ragged n and k, fc2 not
    ((520, 1024), 2048, torch.bfloat16),  # the entry's serving batch, 2-d rows
    ((8, 65, 1024), 2048, torch.bfloat16),
    ((128, 65, 1024), 2048, torch.bfloat16),  # bench.py's B/32 step
    ((64, 197, 768), 3072, torch.bfloat16),   # B/16
    ((2, 600, 256), 1024, torch.bfloat16),
    ((4, 1024, 64), 256, torch.bfloat16),   # ScalableViT's stage 1: fc1 at k 64, fc2 at n 64
    ((4, 256, 128), 512, torch.bfloat16),   # stage 2: fc2 at n 128
    ((64, 16, 1024), 2048, torch.bfloat16),  # the objectives' encoder: MAE's 16 visible tokens
    ((64, 64, 512), 2048, torch.bfloat16),   # MAE's decoder
]
# The attention block's forward on both attention routes (attention_route).
ATTN_FORWARD_SHAPES = [
    (3, 67, 96, 3, 32, torch.bfloat16),
    (3, 67, 96, 3, 32, torch.float16),
    (2, 145, 256, 4, 64, torch.bfloat16),
    (2, 70, 256, 2, 128, torch.bfloat16),
    (1, 1, 64, 2, 32, torch.bfloat16),
    (2, 33, 40, 1, 32, torch.bfloat16),     # d=40: a partial k tile in the QKV GEMM
    (4, 33, 256, 4, 64, torch.bfloat16),    # a ragged n on gemm_wgmma and short_fwd
    (1, 1000, 64, 2, 64, torch.bfloat16),   # 16 key tiles of online softmax: the mha route
    (2, 600, 256, 4, 64, torch.bfloat16),   # past 512 tokens: the mha route
    # the mha route on the flash kernels: PiT's stage 1 (962 = 15·64 + 2), dh
    # 32 and 128 at 577 (9·64 + 1: a one-key last tile), f16
    (64, 962, 256, 16, 64, torch.bfloat16),
    (2, 577, 64, 2, 32, torch.bfloat16),
    (2, 577, 256, 2, 128, torch.bfloat16),
    (2, 700, 256, 4, 64, torch.float16),
    (8, 65, 1024, 16, 64, torch.bfloat16),  # the entry's serving batch, 520 rows
    (128, 65, 1024, 16, 64, torch.bfloat16),  # bench.py's B/32 step
    (64, 197, 768, 12, 64, torch.bfloat16),   # B/16
    # the objectives' blocks, 8 heads of 64 in a wider model (QKV N 1536 over
    # K 1024; the out-projection's K 512): MAE's encoder at 16 visible tokens,
    # its decoder at 64 tokens 512 wide
    (64, 16, 1024, 8, 64, torch.bfloat16),
    (64, 64, 512, 8, 64, torch.bfloat16),
]


@pytest.mark.parametrize("shape,hidden,dtype", MLP_FORWARD_SHAPES)
def test_fused_mlp_kernel_matches_plain(cuda, shape, hidden, dtype):
    """The serving forward against the plain version, the same bits twice."""
    args = _mlp_args(shape, hidden, dtype, cuda)
    with torch.inference_mode():
        before = fused_mlp.launches
        out = fused_mlp(*args)
        torch.cuda.synchronize()
        assert fused_mlp.launches == before + 1
        _close(out, fused_mlp_reference(*args), args[0])
        assert torch.equal(out, fused_mlp(*args))


def _forward_routes():
    return {r: c.launches for r, c in fused_attention_block_ops.FORWARD_ROUTES.items()}


@pytest.mark.parametrize("b,n,d,heads,dh,dtype", ATTN_FORWARD_SHAPES)
def test_fused_attention_block_kernel_matches_plain(cuda, b, n, d, heads, dh, dtype):
    """The serving forward against the plain version (the TPU kernel's late
    divide) and, on the short route, against its own plain version (p
    normalised before P·V); the same bits twice; the route by shape."""
    args = _attn_args(b, n, d, heads, dh, dtype, cuda)
    route = fused_attention_block_ops.attention_route(n)
    with torch.inference_mode():
        before, routes = fused_attention_block.launches, _forward_routes()
        out = fused_attention_block(*args, heads, dh)
        torch.cuda.synchronize()
        assert fused_attention_block.launches == before + 1
        routes[route] += 1
        assert _forward_routes() == routes
        _close(out, fused_attention_block_reference(*args, heads, dh), args[0])
        if route == "short":
            _close(out, fused_attention_block_ops.fused_attention_block_short_forward_reference(
                *args, heads, dh)[0], args[0])
        assert torch.equal(out, fused_attention_block(*args, heads, dh))


@pytest.mark.parametrize("shape,hidden,dtype", [
    ((2, 17, 64), 128, torch.bfloat16),   # both dgrads below n 256: linear.cu
    ((3, 67, 96), 160, torch.float16),
    ((2, 33, 104), 200, torch.bfloat16),  # partial k and n tiles of the dgrad GEMMs
    ((2, 33, 104), 264, torch.bfloat16),  # dy·W2 on gemm_wgmma at a ragged n, dh·W1 not
    ((520, 1024), 2048, torch.bfloat16),
    ((2, 600, 256), 1024, torch.bfloat16),
    ((128, 65, 1024), 2048, torch.bfloat16),  # bench.py's B/32 step
    ((64, 197, 768), 3072, torch.bfloat16),   # B/16
    ((4, 1024, 64), 256, torch.bfloat16),     # ScalableViT's stage 1: dh·W1 at n 64
    ((64, 16, 1024), 2048, torch.bfloat16),   # the objectives' encoder (MAE: 16 tokens)
    ((64, 64, 512), 2048, torch.bfloat16),    # MAE's decoder: the LN epilogue on 2-CTA clusters
])
def test_fused_mlp_backward_kernel_matches_plain(cuda, shape, hidden, dtype):
    """Every output against the plain backward, and the same bits twice (db1
    and the LayerNorm's sums in a fixed order)."""
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
    _twice(out, fused_mlp_backward(dy, x, h, gamma, w1, w2))


@pytest.mark.parametrize("b,n,d,heads,dh,dtype", [
    (3, 67, 96, 3, 32, torch.bfloat16),
    (3, 67, 96, 3, 32, torch.float16),
    (2, 145, 256, 4, 64, torch.bfloat16),
    (2, 70, 256, 2, 128, torch.bfloat16),
    (1, 1, 64, 2, 32, torch.bfloat16),
    (2, 33, 40, 1, 32, torch.bfloat16),     # d=40: partial tiles in the dgrad GEMMs
    (1, 1000, 64, 2, 64, torch.bfloat16),   # 16 key and query tiles: the mha route
    (2, 600, 256, 4, 64, torch.bfloat16),   # past 512 tokens: the mha route
    # the mha route on the flash kernels: PiT's stage 1, dh 32 and 128, f16
    (64, 962, 256, 16, 64, torch.bfloat16),
    (2, 577, 64, 2, 32, torch.bfloat16),
    (2, 577, 256, 2, 128, torch.bfloat16),
    (2, 700, 256, 4, 64, torch.float16),
    (2, 257, 1024, 16, 64, torch.bfloat16), # ViT-L/14 @224's n: three short key blocks
    (2, 300, 512, 8, 64, torch.bfloat16),   # a ragged n between them
    (8, 65, 1024, 16, 64, torch.bfloat16),
    (128, 65, 1024, 16, 64, torch.bfloat16),  # bench.py's B/32 step
    (64, 197, 768, 12, 64, torch.bfloat16),   # B/16
    # inner 512 in 1024 (dqkv·Wqkv's K 1536 into the LN epilogue on a
    # four-CTA cluster; doattn 512 wide), one short key block at n 16; MAE's
    # decoder at 512
    (64, 16, 1024, 8, 64, torch.bfloat16),
    (64, 64, 512, 8, 64, torch.bfloat16),
])
def test_fused_attention_block_backward_kernel_matches_plain(cuda, b, n, d, heads, dh, dtype):
    """Fed the plain training forward's residuals (oattn and lse): every
    output against the plain backward (the TPU kernel's dsum = Σ dp·p) and
    against the card's own plain version on either route (p from lse, D =
    rowsum(dO∘O)), and the same bits twice; the route by shape."""
    args = _attn_args(b, n, d, heads, dh, dtype, cuda, seed=1)
    x, gamma, beta, wqkv, wo, bo = args
    _, _, qkv, oattn = fused_attention_block_forward_reference(*args, heads, dh)
    lse = fused_attention_block_ops.attention_lse_reference(qkv, heads, dh)
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(dtype)
    route = fused_attention_block_ops.attention_route(n)
    assert route == ("short" if n <= 512 else "mha")
    routes = fused_attention_block_ops.BACKWARD_ROUTES
    before = (fused_attention_block_backward.launches, routes[route].launches)
    out = fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, oattn=oattn,
                                         lse=lse)
    torch.cuda.synchronize()
    assert (fused_attention_block_backward.launches, routes[route].launches) == \
        (before[0] + 1, before[1] + 1)
    ref = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh)
    check_outputs(torch, "fused_attention_block_bwd", out, ref, {0: dy})
    check_outputs(torch, f"fused_attention_block_bwd, {route} route", out,
                  fused_attention_block_ops.fused_attention_block_lse_backward_reference(
                      dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh), {0: dy})
    _twice(out, fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                               oattn=oattn, lse=lse))


def test_short_route_needs_the_training_forwards_residuals(cuda):
    args = _attn_args(2, 65, 96, 3, 32, torch.bfloat16, cuda)
    x, gamma, beta, wqkv, wo, bo = args
    qkv = fused_attention_block_forward_reference(*args, 3, 32)[2]
    with pytest.raises(ValueError, match="short route"):
        fused_attention_block_backward(x, x, qkv, gamma, wqkv, wo, 3, 32)


def test_mha_route_needs_the_training_forwards_residuals(cuda):
    """Past 512 tokens the flash backward reads the training forward's lse
    and oattn too: without them it raises, before any launch."""
    args = _attn_args(2, 577, 96, 3, 32, torch.bfloat16, cuda)
    x, gamma, beta, wqkv, wo, bo = args
    _, _, qkv, oattn = fused_attention_block_forward_reference(*args, 3, 32)
    before = fused_attention_block_backward.launches
    for kept in ({}, {"oattn": oattn}, {"lse": torch.zeros(2, 3, 577, device=cuda)}):
        with pytest.raises(ValueError, match="mha route"):
            fused_attention_block_backward(x, x, qkv, gamma, wqkv, wo, 3, 32, **kept)
    assert fused_attention_block_backward.launches == before


@pytest.mark.parametrize("shape,hidden,dtype", MLP_FORWARD_SHAPES)
def test_fused_mlp_training_forward_keeps_the_plain_residuals(cuda, shape, hidden, dtype):
    """The training forward (what grad mode launches) returns y, xn and the
    pre-activation h as the plain version computes them, the same bits
    twice."""
    args = _mlp_args(shape, hidden, dtype, cuda, seed=3)
    out = fused_mlp_ops._launch_forward(*args, 1e-3, save_residuals=True)
    check_outputs(torch, "fused_mlp training forward", out,
                  fused_mlp_forward_reference(*args), {0: args[0]})
    _twice(out, fused_mlp_ops._launch_forward(*args, 1e-3, save_residuals=True))


@pytest.mark.parametrize("b,n,d,heads,dh,dtype,biased", [
    (*shape, False) for shape in ATTN_FORWARD_SHAPES] + [
    (2, 257, 1024, 16, 64, torch.bfloat16, True),  # the small-dataset ViT's LSA
    (2, 577, 1024, 16, 64, torch.bfloat16, True),  # and at 384 px, on the mha route
])
def test_fused_attention_block_training_forward_keeps_the_plain_residuals(cuda, b, n, d, heads,
                                                                          dh, dtype, biased):
    """The training forward returns y, xn, qkv and oattn as the plain version
    computes them and, on the short route (n <= 512, with or without a
    bias), also as that route's own plain version does; on either route lse
    (kept for the backward) within LSE_ABS_TOL of the plain lse of its own
    qkv.  The same bits twice; the route by shape; serving keeps no lse."""
    args = _attn_args(b, n, d, heads, dh, dtype, cuda, seed=3)
    bias = vit_for_small_dataset.lsa_bias(n, cuda) if biased else None
    scale = 1.0 if biased else dh ** -0.5
    route = fused_attention_block_ops.attention_route(n)
    routes = _forward_routes()
    out = fused_attention_block_ops._launch_forward(*args, heads, dh, scale, 1e-3, bias,
                                                    training=True)
    routes[route] += 1
    assert _forward_routes() == routes
    check_outputs(torch, "fused_attention_block training forward", out[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, 1e-3, bias),
                  {0: args[0]})
    if route == "short":
        short = fused_attention_block_ops.fused_attention_block_short_forward_reference(
            *args, heads, dh, scale, 1e-3, bias)
        check_outputs(torch, "fused_attention_block training forward, short route", out[:4],
                      short[:4], {0: args[0]})
    lse = fused_attention_block_ops.attention_lse_reference(out[2], heads, dh, scale, bias)
    assert out[4].dtype == torch.float32 and tuple(out[4].shape) == (b, heads, n)
    assert (out[4] - lse).abs().max() <= LSE_ABS_TOL
    _twice(out, fused_attention_block_ops._launch_forward(*args, heads, dh, scale, 1e-3, bias,
                                                          training=True))
    assert fused_attention_block_ops._launch_forward(*args, heads, dh, scale, 1e-3,
                                                     bias)[4] is None


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
    short = (fused_attention_block_ops.FORWARD_ROUTES["short"],
             fused_attention_block_ops.BACKWARD_ROUTES["short"])
    counts = (fused_attention_block.launches, fused_attention_block_backward.launches,
              short[0].launches, short[1].launches)
    y = fused_attention_block(*args, 3, 32)
    y.float().square().sum().backward()
    assert (fused_attention_block.launches - counts[0],
            fused_attention_block_backward.launches - counts[1],
            short[0].launches - counts[2], short[1].launches - counts[3]) == (1, 1, 1, 1)
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
    # d = 60 rows are not 16 bytes: the kernels take them through zero-padded
    # copies (test_fused_mlp_kernels_at_widths_off_8); rows that are not
    # contiguous they refuse, under grad as in inference.
    args = _mlp_args((2, 9, 120), 128, torch.bfloat16, cuda)
    args = (args[0][..., :60],) + tuple(t[:60] if t.dim() == 1 else t for t in args[1:3]) + \
        (args[3][:, :60], args[4], args[5][:60], args[6][:60])
    args[3].requires_grad_(True)
    with pytest.raises(ValueError, match="contiguous"):
        fused_mlp(*args)


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


def test_objectives_train_on_the_block_kernels(cuda):
    """MAE and distillation steps (``make_loss_train_step``, f32 parameters,
    bf16 compute): every block of the encoder and the decoder on rows 1-4,
    the teacher's forward on the serving kernels only, finite falling losses
    on one batch and one mask draw."""
    from vit_tpu_torch import MAE, DistillableViT, DistillWrapper
    from vit_tpu_torch.parallel.train import make_loss_train_step

    cfg = dict(image_size=32, patch_size=8, num_classes=10, dim=128, depth=2, heads=2,
               dim_head=64, mlp_dim=256)
    g = torch.Generator(device=cuda).manual_seed(0)
    bf16 = dict(compute_dtype=torch.bfloat16, generator=g)
    img = torch.randn(8, 32, 32, 3, generator=g, device=cuda)
    mae = MAE(ViT(**cfg, **bf16), decoder_dim=64, decoder_depth=2, decoder_heads=2,
              decoder_dim_head=32, **bf16)
    wrapper = DistillWrapper(ViT(**cfg, **bf16), DistillableViT(**cfg, **bf16), **bf16)
    masks = torch.Generator(device=cuda)
    for model, batch, draws, per_step in (
            (mae, img, True, [4, 4, 4, 4]),
            (wrapper, (img, torch.arange(8, device=cuda) % 10), False, [4, 4, 2, 2])):
        step = make_loss_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
        losses = []
        for _ in range(3):
            counts = _launches()
            kw = dict(generator=masks.manual_seed(1)) if draws else {}
            losses.append(float(step(batch, **kw)["loss"]))
            assert [a - b for a, b in zip(_launches(), counts)] == per_step
        assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    assert all(p.grad is None for p in wrapper.teacher.parameters())


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


@pytest.mark.parametrize("n", [65, 197, 257, 577, 600])
@pytest.mark.parametrize("kind", ["shared", "per-head"])
def test_fused_attention_block_bias_kernels_match_plain(cuda, n, kind):
    """Serving forward, training forward and backward (dbias included; fed the
    training forward's residuals, oattn and lse) of the biased block against
    their plain versions: the TPU kernel's rounding points, and the card's
    own on either route (with dbias, dsum = Σ p·dp from the row statistics
    it takes first); dbias against both, within DBIAS_REL_TOL."""
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
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, dh ** -0.5, 1e-3, bias,
                                                    training=True)
    check_outputs(torch, "biased training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, bias=bias), {0: x})
    _, _, qkv, oattn, lse = fwd
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda).to(torch.bfloat16)
    before = (fused_attention_block_backward.launches, fused_attention_block_bias_backward.launches)
    got = fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                              oattn=oattn, lse=lse)
    torch.cuda.synchronize()
    assert (fused_attention_block_backward.launches,
            fused_attention_block_bias_backward.launches) == (before[0], before[1] + 1)
    ref = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                                   bias=bias)
    check_outputs(torch, "biased backward", got[:5], ref[:5], {0: dy})
    own = fused_attention_block_ops.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, bias=bias)
    check_outputs(torch, "biased backward, its route", got[:5], own[:5], {0: dy})
    check_dbias(torch, "biased backward", got[5], own[5])
    check_dbias(torch, "biased backward, TPU rounding points", got[5], ref[5])
    _twice(got, fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads,
                                                    dh, oattn=oattn, lse=lse))


@pytest.mark.parametrize("hb", [1, 4])
def test_dbias_is_the_same_bits_every_run(cuda, hb):
    b, n, d, heads, dh = 8, 257, 256, 4, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=7)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias("shared" if hb == 1 else "per-head", heads, n, cuda)
    ops = fused_attention_block_ops
    _, _, qkv, oattn, lse = ops.fused_attention_block_short_forward_reference(
        *args, heads, dh, bias=bias)
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(8),
                     device=cuda).to(torch.bfloat16)
    runs = [fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                oattn=oattn, lse=lse)[5] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("n", [65, 257, 577])
def test_lsa_bias_gives_finite_outputs_one_past_a_key_tile(cuda, n):
    """LSA's -f32.max diagonal at n ≡ 1 (mod 64), where the last key tile's
    only key is the last query's own masked one: finite, and as the plain
    version computes it, forward and backward."""
    b, d, heads, dh = 2, 256, 4, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=9)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias("lsa", heads, n, cuda)
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, 1.0, 1e-3, bias,
                                                    training=True)
    check_outputs(torch, "LSA training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, 1.0, bias=bias),
                  {0: x})
    _, _, qkv, oattn, lse = fwd
    assert torch.isfinite(lse).all()
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(10),
                     device=cuda).to(torch.bfloat16)
    got = fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                              1.0, need_dbias=False, oattn=oattn, lse=lse)
    assert got[5] is None
    ref = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                                   1.0, bias=bias, need_dbias=False)
    check_outputs(torch, "LSA backward", got[:5], ref[:5], {0: dy})


@pytest.mark.parametrize("kind", ["lsa", "shared", "per-head"])
def test_biased_block_at_the_small_dataset_shape(cuda, kind):
    """The small-dataset ViT's block (64 images of 257 tokens, d 1024, 16
    heads of 64: two 144-key tiles forward, two 144-key blocks backward) with
    LSA's mask (scale 1), a shared and a per-head bias: serving and training
    forwards against both plain versions (the TPU kernel's rounding points,
    the short route's own), lse within LSE_ABS_TOL, the backward fed the
    training forward's residuals against both, dbias against the route's own
    within DBIAS_REL_TOL; each twice, bit for bit; only the short route
    counted."""
    b, n, d, heads, dh = 64, 257, 1024, 16, 64
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=12)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias(kind, heads, n, cuda, seed=13)
    scale = 1.0 if kind == "lsa" else dh ** -0.5
    ops = fused_attention_block_ops
    assert ops.attention_route(n) == "short"
    routes = [dict((k, r.launches) for k, r in rt.items())
              for rt in (ops.FORWARD_ROUTES, ops.BACKWARD_ROUTES)]
    with torch.inference_mode():
        out = fused_attention_block_bias(*args, bias, heads, dh, scale)
        _close(out, fused_attention_block_reference(*args, heads, dh, scale, bias=bias), x)
        _close(out, ops.fused_attention_block_short_forward_reference(
            *args, heads, dh, scale, bias=bias)[0], x)
        assert torch.equal(out, fused_attention_block_bias(*args, bias, heads, dh, scale))
    fwd = ops._launch_forward(*args, heads, dh, scale, 1e-3, bias, training=True)
    check_outputs(torch, "biased training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, bias=bias),
                  {0: x})
    check_outputs(torch, "biased training forward, short route", fwd[:4],
                  ops.fused_attention_block_short_forward_reference(
                      *args, heads, dh, scale, bias=bias)[:4], {0: x})
    _twice(fwd, ops._launch_forward(*args, heads, dh, scale, 1e-3, bias, training=True))
    _, _, qkv, oattn, lse = fwd
    assert (lse - ops.attention_lse_reference(qkv, heads, dh, scale, bias)).abs().max() <= \
        LSE_ABS_TOL
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(14),
                     device=cuda).to(torch.bfloat16)
    need = kind != "lsa"
    got = fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                              scale, need_dbias=need, oattn=oattn, lse=lse)
    check_outputs(torch, "biased backward", got[:5], fused_attention_block_backward_reference(
        dy, x, qkv, gamma, wqkv, wo, heads, dh, scale, bias=bias, need_dbias=False)[:5],
        {0: dy})
    own = ops.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, scale, bias=bias, need_dbias=need)
    check_outputs(torch, "biased backward, short route", got[:5], own[:5], {0: dy})
    if need:
        check_dbias(torch, "biased backward", got[5], own[5])
    else:
        assert got[5] is None
    _twice(got, fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                    scale, need_dbias=need, oattn=oattn,
                                                    lse=lse))
    assert [dict((k, r.launches) for k, r in rt.items())
            for rt in (ops.FORWARD_ROUTES, ops.BACKWARD_ROUTES)] == [
        {"short": routes[0]["short"] + 4, "mha": routes[0]["mha"]},
        {"short": routes[1]["short"] + 2, "mha": routes[1]["mha"]}]


@pytest.mark.parametrize("kind", ["lsa", "shared", "per-head"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_biased_block_past_512_tokens(cuda, kind, dtype):
    """The small-dataset ViT's block at 384 px (16 images of 577 tokens, d
    1024, 16 heads of 64: the mha route, the biased flash instances, a
    one-key last tile) with LSA's mask (scale 1), a shared and a per-head
    bias: serving and training forwards against the plain version, lse
    within LSE_ABS_TOL, the backward fed the training forward's residuals
    against the TPU kernel's rounding points and the route's own, dbias
    (shared, per-head) against the route's own within DBIAS_REL_TOL; each
    twice, bit for bit; only the mha route counted."""
    b, n, d, heads, dh = 16, 577, 1024, 16, 64
    args = _attn_args(b, n, d, heads, dh, dtype, cuda, seed=15)
    x, gamma, beta, wqkv, wo, bo = args
    bias = _bias(kind, heads, n, cuda, seed=16)
    scale = 1.0 if kind == "lsa" else dh ** -0.5
    ops = fused_attention_block_ops
    assert ops.attention_route(n) == "mha"
    routes = [dict((k, r.launches) for k, r in rt.items())
              for rt in (ops.FORWARD_ROUTES, ops.BACKWARD_ROUTES)]
    with torch.inference_mode():
        out = fused_attention_block_bias(*args, bias, heads, dh, scale)
        _close(out, fused_attention_block_reference(*args, heads, dh, scale, bias=bias), x)
        assert torch.equal(out, fused_attention_block_bias(*args, bias, heads, dh, scale))
    fwd = ops._launch_forward(*args, heads, dh, scale, 1e-3, bias, training=True)
    check_outputs(torch, "biased training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, bias=bias),
                  {0: x})
    _twice(fwd, ops._launch_forward(*args, heads, dh, scale, 1e-3, bias, training=True))
    _, _, qkv, oattn, lse = fwd
    assert (lse - ops.attention_lse_reference(qkv, heads, dh, scale, bias)).abs().max() <= \
        LSE_ABS_TOL
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(17),
                     device=cuda).to(dtype)
    need = kind != "lsa"
    got = fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                              scale, need_dbias=need, oattn=oattn, lse=lse)
    check_outputs(torch, "biased backward", got[:5], fused_attention_block_backward_reference(
        dy, x, qkv, gamma, wqkv, wo, heads, dh, scale, bias=bias, need_dbias=False)[:5],
        {0: dy})
    own = ops.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, scale, bias=bias, need_dbias=need)
    check_outputs(torch, "biased backward, mha route", got[:5], own[:5], {0: dy})
    if need:
        check_dbias(torch, "biased backward", got[5], own[5])
    else:
        assert got[5] is None
    _twice(got, fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                    scale, need_dbias=need, oattn=oattn,
                                                    lse=lse))
    assert [dict((k, r.launches) for k, r in rt.items())
            for rt in (ops.FORWARD_ROUTES, ops.BACKWARD_ROUTES)] == [
        {"short": routes[0]["short"], "mha": routes[0]["mha"] + 4},
        {"short": routes[1]["short"], "mha": routes[1]["mha"] + 2}]


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


def _check_flash(q, k, v, do):
    """Forward, lse and backward of the flash kernels against their plain
    versions; the backward twice, bit for bit; one launch each."""
    scale = q.shape[-1] ** -0.5
    before = (flash_attention.launches, flash_backward.launches)
    out, lse = flash_attention_forward(q, k, v, scale)
    grads = flash_backward(q, k, v, out, lse, do, scale)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_backward.launches) == (before[0] + 1, before[1] + 1)
    ref_out, ref_lse = flash_attention_forward_reference(q, k, v, scale)
    check_outputs(torch, "flash forward", (out,), (ref_out,), {})
    assert lse.dtype == torch.float32 and (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
    check_outputs(torch, "flash backward", grads,
                  flash_backward_reference(q, k, v, out, lse, do, scale), {})
    again = flash_backward(q, k, v, out, lse, do, scale)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))


@pytest.mark.parametrize("b,h,n_q,n_k,d", [
    (8, 1, 3136, 784, 64),  # CvT-13 stage 1 @224 at batch 8: 784 = 12·64 + 16 keys
    (2, 3, 70, 130, 32),    # ragged on both sides
    (2, 3, 70, 130, 64),
    (2, 3, 130, 70, 96),
    (2, 3, 70, 130, 128),
    (1, 2, 1, 1, 64),  # one key (with more query rows, dq is rounding noise on both sides)
    # key blocks of 128 (two warpgroups of 64) and query steps of 64 or 32: one
    # key short of a block, a whole block, one past it; one query row, one past a step
    (2, 2, 65, 127, 64),
    (2, 2, 1, 128, 32),
    (2, 2, 65, 129, 128),
    (2, 2, 1, 129, 96),
])
def test_flash_kernels_match_plain(cuda, b, h, n_q, n_k, d):
    """Strided operands as CvT gives them (views of channels-last maps and of
    the two halves of the k/v projection)."""
    _check_flash(*flash_inputs(torch, b, h, n_q, n_k, d, seed=n_q + d))


@pytest.mark.parametrize("d", [32, 64, 96, 128])
def test_flash_kernels_take_f16_and_contiguous_operands(cuda, d):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(2, 2, n, d, generator=g, device=cuda).half()
                   for n in (100, 77, 77, 100))
    _check_flash(q, k, v, do)


def test_dispatcher_launches_flash_at_the_tier_and_raises_on_what_it_refuses(cuda):
    """``"auto"``: a bf16 call at max(n_q, n_k) >= 1024 launches the kernel
    (d = 40 padded to 64), below it or in f32 the plain path runs; a width
    or a stride the kernel does not take raises instead of running plain."""
    sdpa = attention_ops.scaled_dot_product_attention
    g = torch.Generator(device=cuda).manual_seed(4)

    def rn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    cases = [((1, 2, 1024, 64), torch.bfloat16, 1), ((1, 2, 64, 40), torch.bfloat16, 0),
             ((1, 2, 1500, 40), torch.bfloat16, 1), ((1, 2, 1023, 64), torch.bfloat16, 0),
             ((1, 2, 2048, 64), torch.float32, 0)]
    for shape, dtype, launched in cases:
        q = rn(*shape, dtype=dtype)
        before = flash_attention.launches
        with torch.inference_mode():
            out = sdpa(q, q, q)
        assert flash_attention.launches - before == launched, (shape, dtype)
        ref = attention_ops.plain_attention(q.float(), q.float(), q.float(),
                                            scale=shape[-1] ** -0.5)
        assert out.shape == q.shape and (out.float() - ref).abs().max().item() < 5e-2
    with torch.inference_mode():
        with pytest.raises(ValueError, match="head width"):
            sdpa(*(rn(1, 2, 1024, 160),) * 3)  # 160: on the 32 grid, no instance
        wide = rn(1, 2, 1024, 128)
        with pytest.raises(ValueError, match="strides"):
            sdpa(wide[..., ::2], wide[..., ::2], wide[..., ::2])  # d = 64 at stride 2
        with pytest.raises(TypeError):
            sdpa(*(rn(1, 2, 64, 64, dtype=torch.float32),) * 3, use_flash="force")


def test_cvt_serves_and_trains_through_the_flash_kernels(cuda):
    """A narrow CvT at 128 px (stage 1: 1024 queries, 256 keys): serving
    launches the flash forward once; each train step the forward and the
    backward once; f32 gradients, running statistics that move, a falling
    loss."""
    cfg = dict(num_classes=10, s1_emb_dim=32, s2_emb_dim=48, s3_emb_dim=64, s1_depth=1,
               s2_depth=1, s3_depth=1, s2_heads=2, s3_heads=2)
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.randn(8, 128, 128, 3, generator=g, device=cuda)
    served = cast_params(CvT(**cfg, generator=g), torch.bfloat16).eval()
    before = flash_attention.launches
    with torch.inference_mode():
        out = served(img)
    assert flash_attention.launches - before == 1
    assert out.shape == (8, 10) and torch.isfinite(out).all()
    model = CvT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05))
    labels = torch.arange(8, device=cuda) % 10
    stats = {k: b.clone() for k, b in model.named_buffers()}
    losses = []
    for _ in range(3):
        before = (flash_attention.launches, flash_backward.launches)
        losses.append(float(step(img, labels)["loss"]))
        assert (flash_attention.launches - before[0], flash_backward.launches - before[1]) \
            == (1, 1)
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(not torch.equal(b, stats[k]) and torch.isfinite(b).all()
               for k, b in model.named_buffers())
    assert losses[2] < losses[0]


def _forward_inputs(cuda, b, h, n_q, n_k, dk, dv, dtype, seed):
    """Seeded q, k, v in ``dtype`` as their callers hand them over: with one
    width, CvT's channels-last q and the two halves of one k/v projection
    (``flash_inputs``' views); with two, ScalableViT's channel-packed q, k
    and v (``fap.split_heads`` of ``(b, n, h·d)`` maps)."""
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*shape):
        return torch.randn(*shape, generator=g, device=cuda).to(dtype)

    def fold(t, d):
        return t.reshape(b, t.shape[1], h, d).permute(0, 2, 1, 3)

    if dk == dv:
        k, v = (fold(t, dk) for t in rn(b, n_k, 2 * h * dk).chunk(2, dim=-1))
        return fold(rn(b, n_q, h * dk), dk), k, v
    return tuple(fap.split_heads(rn(b, n, h * d), h) for n, d in ((n_q, dk), (n_k, dk), (n_k, dv)))


def _check_flash_forward(q, k, v):
    """The forward kernel against its plain version, out and lse; one launch."""
    scale = q.shape[-1] ** -0.5
    before = flash_attention.launches
    out, lse = flash_attention_forward(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref_out, ref_lse = flash_attention_forward_reference(q, k, v, scale)
    check_outputs(torch, "flash forward", (out,), (ref_out,), {})
    assert lse.dtype == torch.float32 and (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dk,dv", [(32, 32), (40, 32), (64, 64), (96, 96), (128, 128)])
def test_flash_forward_matches_plain_at_each_width(cuda, dk, dv, dtype):
    """Every (dk, dv) instance in both dtypes, 200 query rows (one 128-row
    block and a ragged one) against 333 keys (a ragged last key tile), on
    the strided views their callers pass; 96 pads v to 128 in the map."""
    _check_flash_forward(*_forward_inputs(cuda, 2, 3, 200, 333, dk, dv, dtype, seed=dk + dv))


@pytest.mark.parametrize("b,h,n_q,n_k", [
    (1, 2, 1, 1),      # one query row, one key
    (2, 2, 33, 1),     # one key: p = 1 at every row
    (2, 2, 50, 64),    # fewer than 64 queries: one warpgroup
    (2, 2, 129, 65),   # one row past a 128-row block, one key past a 64-key tile
    (2, 2, 64, 129),   # one key past a 128-key tile
    (1, 2, 300, 4097),  # n_k past 4096 (vit_tpu's flash_attention_v2 tier)
    (1, 1, 64, 8192),
])
def test_flash_forward_matches_plain_at_ragged_sizes(cuda, b, h, n_q, n_k):
    _check_flash_forward(*_forward_inputs(cuda, b, h, n_q, n_k, 64, 64, torch.bfloat16,
                                          seed=n_q + n_k))


def _packed_inputs(cuda, b, n_q, n_k, heads, dk, dv, seed=0):
    """Seeded bf16 channel-packed q (b, n_q, heads·dk), k, v and a cotangent."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, n, heads * d, generator=g, device=cuda).to(torch.bfloat16)
                 for n, d in ((n_q, dk), (n_k, dk), (n_k, dv), (n_q, dv)))


@pytest.mark.parametrize("b,h,n_q,n_k,dk,dv", [
    (2, 3, 70, 130, 40, 32),   # q/k zero-filled from 40 to 64 in shared memory
    (2, 2, 130, 70, 40, 32),
    (4, 2, 1000, 64, 40, 32),  # ScalableViT's SSA: 64 keys, a ragged query tile
    (1, 1, 1, 1, 40, 32),
    (2, 2, 65, 129, 40, 32),
    (2, 3, 1, 127, 40, 32),
])
def test_flash_kernels_with_two_widths_match_plain(cuda, b, h, n_q, n_k, dk, dv):
    """The (dk, dv) = (40, 32) instances on packed strides.  The 8 columns
    after a head's 40 are the next head's (or the next token's), non-zero: a
    kernel that read them into the zero padding of its 64-wide tiles would
    add them to every logit."""
    q, k, v, do = (fap.split_heads(t, h) for t in _packed_inputs(cuda, b, n_q, n_k, h, dk, dv))
    _check_flash(q, k, v, do)


@pytest.mark.parametrize("b,n,heads,dk,dv", [
    (8, 4096, 2, 32, 32),   # ScalableViT's IWSA stage 1 at batch 8
    (8, 1024, 4, 32, 32),   # stage 2
    (2, 1000, 2, 40, 32),
])
def test_packed_flash_matches_plain(cuda, b, n, heads, dk, dv):
    """The packed op under autograd: forward against its plain version, the
    backward (one flash_backward launch) against the plain backward on the
    kernel's own out and lse, twice bit for bit."""
    q, k, v, do = _packed_inputs(cuda, b, n, n, heads, dk, dv, seed=n)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (fap.flash_attention_packed.launches, flash_attention.launches,
              flash_backward.launches)
    out = fap.flash_attention_packed(*leaves, heads)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (fap.flash_attention_packed.launches, flash_attention.launches,
            flash_backward.launches) == (before[0] + 1, before[1], before[2] + 1)
    ref_out, ref_lse = fap.flash_attention_packed_forward_reference(q, k, v, heads)
    check_outputs(torch, "packed forward", (out.detach(),), (ref_out,), {})
    _, lse = fap.flash_attention_packed_forward(q, k, v, heads)
    assert (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
    check_outputs(torch, "packed backward", grads, fap.flash_attention_packed_backward_reference(
        q, k, v, out.detach(), lse, do, heads), {})
    again = torch.autograd.grad(fap.flash_attention_packed(*leaves, heads), leaves, do)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


def _cross_args(cuda, b, n, c, heads, n_k, dh_k, dh_v, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * scale).to(torch.bfloat16)

    hk, hv = heads * dh_k, heads * dh_v
    return (rn(b, n, c), rn(b, n, c), rn(hk, c, scale=c ** -0.5), rn(b, n_k, hk),
            rn(b, n_k, hv), rn(c, hv, scale=hv ** -0.5), rn(c, scale=0.1)), rn(b, n, c, scale=0.1)


@pytest.mark.parametrize("b,n,c,heads,n_k,dh_k,dh_v", [
    (4, 4096, 64, 2, 64, 40, 32),    # ScalableViT's SSA stages 1-4 at batch 4
    (4, 1024, 128, 4, 64, 40, 32),
    (4, 256, 256, 8, 64, 40, 32),
    (4, 64, 512, 16, 64, 32, 32),
    (1, 4096, 64, 2, 64, 40, 32),    # one image: one CTA a span
    (2, 1000, 128, 4, 64, 40, 32),   # stage 2's widths at a ragged n
    (2, 196, 64, 2, 49, 40, 32),     # 7 x 7 keys
    (3, 100, 72, 3, 9, 40, 32),      # ragged rows, n_k, c and the q GEMM's n = 120
    (2, 70, 96, 3, 130, 64, 64),     # n_k past 128: the three-launch forward
    (2, 130, 64, 2, 100, 64, 64),    # a 128-key tile, (64, 64) heads
    (2, 64, 512, 16, 64, 40, 32),    # (40, 32) at c 512: cross_fwd, then the y GEMM
    (2, 200, 256, 8, 49, 40, 32),    # stage 3's widths, ragged n and 49 keys
    # Twins-SVT's global attention at its four stages (8 heads of 64: the
    # backward split past heads·dh_k 256 at every c), 64, 16, 4 and 1 keys
    (2, 3136, 64, 8, 64, 64, 64),
    (2, 784, 128, 8, 16, 64, 64),
    (2, 196, 256, 8, 4, 64, 64),
    (2, 49, 512, 8, 1, 64, 64),
])
def test_fused_cross_attention_kernels_match_plain(cuda, b, n, c, heads, n_k, dh_k, dh_v):
    """Serving forward (one cross_fwd launch keeping no residual below c 256,
    cross_fwd and the y GEMM from it, keeping oattn only, the three launches
    past n_k 128), training forward (y, q, oattn, lse) and backward (dxn, dq,
    dk, dv, dbo; fed the training forward's residuals: one cross_bwd kernel
    up to c 128, cross_bwd between two GEMMs from 129, the four steps past
    n_k 128, each route asserted and counted; cross_bwd keeps dxn only up
    to heads·dh_k 256) against their plain versions; each twice, bit for
    bit."""
    args, dy = _cross_args(cuda, b, n, c, heads, n_k, dh_k, dh_v, seed=n)
    x, xn, wq, k, v, wo, bo = args
    cfg = (heads, dh_k, dh_v)
    from vit_tpu_torch.ops import _build
    route = _build.load().vit_fused_cross_attention_fused(b, n, n_k, c, heads, dh_k, dh_v)
    assert route == (0 if n_k > 128 else 1 if c < 256 else 2)
    bwd_route = fca.backward_route(b, n, n_k, c, heads, dh_k, dh_v)
    assert bwd_route == (0 if n_k > 128 else 1 if c <= 128 and heads * dh_k <= 256 else 2)
    with torch.inference_mode():
        before = fca.fused_cross_attention.launches
        out = fca.fused_cross_attention(*args, *cfg)
        torch.cuda.synchronize()
        assert fca.fused_cross_attention.launches == before + 1
        _close(out, fca.fused_cross_attention_reference(*args, *cfg), x)
        assert torch.equal(out, fca.fused_cross_attention(*args, *cfg))
        served = fca._launch_forward(*args, *cfg, dh_k ** -0.5)
        assert [t is None for t in served[1:]] == [route != 0, route == 1, route != 0]
    fwd = fca._launch_forward(*args, *cfg, dh_k ** -0.5, training=True)
    assert all(torch.equal(a, b_) for a, b_ in
               zip(fwd, fca._launch_forward(*args, *cfg, dh_k ** -0.5, training=True)))
    ref = fca.fused_cross_attention_forward_reference(*args, *cfg)
    check_outputs(torch, "cross-attention training forward", fwd[:3], ref[:3], {0: x})
    _, q, oattn, lse = fwd
    # lse on the kernel's own q (a one-unit flip of q moves the logits).
    ref_lse = fap.flash_attention_packed_forward_reference(q, k, v, heads, dh_k ** -0.5)[1]
    assert (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
    before = fca.fused_cross_attention_backward.launches
    on_route = fca.BACKWARD_ROUTES[bwd_route].launches
    got = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg)
    torch.cuda.synchronize()
    assert fca.fused_cross_attention_backward.launches == before + 1
    assert fca.BACKWARD_ROUTES[bwd_route].launches == on_route + 1
    want = fca.fused_cross_attention_backward_reference(dy, q, k, v, oattn, lse, wq, wo, *cfg,
                                                        stored_output_d=bwd_route == 0)
    check_outputs(torch, "cross-attention backward", got[:4], want[:4], {})
    check_dbias(torch, "cross-attention backward", got[4], want[4], "dbo")
    again = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


@pytest.mark.parametrize("route", [0, 2])
@pytest.mark.parametrize("b,n,c,heads,n_k,dh_k,dh_v", [
    (4, 4096, 64, 2, 64, 40, 32),    # ScalableViT's SSA stages 1 and 2, whose own route is 1
    (2, 1000, 128, 4, 64, 40, 32),
    (2, 64, 512, 16, 64, 32, 32),    # stage 4, whose own route is 2
])
def test_cross_attention_backward_routes_asked_for_match_plain(cuda, b, n, c, heads, n_k, dh_k,
                                                               dh_v, route):
    """The backward on a route the card's comparison asks for: the four
    steps (D from the stored output) and the split cross_bwd, at shapes
    whose own route is another, against the plain version with that route's
    dsum; twice bit for bit.  A route the shape cannot take raises."""
    args, dy = _cross_args(cuda, b, n, c, heads, n_k, dh_k, dh_v, seed=n + route)
    x, xn, wq, k, v, wo, bo = args
    cfg = (heads, dh_k, dh_v)
    _, q, oattn, lse = fca._launch_forward(*args, *cfg, dh_k ** -0.5, training=True)
    assert fca.backward_route(b, n, n_k, c, heads, dh_k, dh_v, route) == route
    got = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg, route=route)
    want = fca.fused_cross_attention_backward_reference(dy, q, k, v, oattn, lse, wq, wo, *cfg,
                                                        stored_output_d=route == 0)
    check_outputs(torch, f"cross-attention backward, route {route}", got[:4], want[:4], {})
    check_dbias(torch, f"cross-attention backward, route {route}", got[4], want[4], "dbo")
    again = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg, route=route)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    if c > 128:
        assert fca.backward_route(b, n, n_k, c, heads, dh_k, dh_v, 1) == -1
        with pytest.raises(ValueError, match="route 1"):
            fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, *cfg, route=1)


def test_cross_attention_and_packed_ops_refuse_what_they_do_not_take(cuda):
    args, _ = _cross_args(cuda, 2, 16, 48, 2, 4, 16, 24)
    with torch.inference_mode(), pytest.raises(ValueError, match="dh_k"):
        fca.fused_cross_attention(*args, 2, 16, 24)  # (16, 24) has no flash instance
    args, _ = _cross_args(cuda, 2, 16, 60, 2, 4, 40, 32)
    with pytest.raises(ValueError, match="c % 8"):
        fca.fused_cross_attention(*(a.requires_grad_() for a in args), 2, 40, 32)
    q, k, v, _ = _packed_inputs(cuda, 1, 64, 64, 2, 48, 48)
    with torch.inference_mode(), pytest.raises(ValueError, match="head widths"):
        fap.flash_attention_packed(q, k, v, 2)  # 48 has no instance
    q, k, v, _ = _packed_inputs(cuda, 1, 64, 64, 2, 32, 32)
    with pytest.raises(TypeError):
        fap.flash_attention_packed(q.float(), k.float(), v.float(), 2)


def _scalable_launches():
    return (fca.fused_cross_attention.launches, fap.flash_attention_packed.launches,
            fused_mlp.launches, fca.fused_cross_attention_backward.launches,
            flash_backward.launches, fused_mlp_backward.launches, flash_attention.launches)


def test_scalable_vit_serves_and_trains_through_its_kernels(cuda):
    """A narrow ScalableViT at 128 px (stage 1: a whole-map IWSA window of
    1024 tokens, SSA keys 40 wide): each forward launches the cross-attention
    block and the two conv-MLPs once per block and the packed flash op once;
    each train step their backwards as often; f32 gradients, a falling loss."""
    cfg = dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 2), reduction_factor=(4, 2),
               window_size=(32, None), ssa_dim_key=(40, 40))
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.randn(8, 128, 128, 3, generator=g, device=cuda)
    served = cast_params(ScalableViT(**cfg, generator=g), torch.bfloat16).eval()
    before = _scalable_launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(_scalable_launches(), before)] == [2, 1, 4, 0, 0, 0, 0]
    assert out.shape == (8, 10) and torch.isfinite(out).all()
    model = ScalableViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.05))
    labels = torch.arange(8, device=cuda) % 10
    losses = []
    for _ in range(3):
        before = _scalable_launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(_scalable_launches(), before)] == [2, 1, 4, 2, 1, 4, 0]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert losses[2] < losses[0]


def _short_inputs(cuda, b, h, n_q, n_k, d, dtype=torch.bfloat16, seed=0):
    """Seeded (b, h, n, d) q, k, v and a cotangent."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(b, h, n, d, generator=g, device=cuda).to(dtype)
                 for n in (n_q, n_k, n_k, n_q))


@pytest.mark.parametrize("b,h,n_q,n_k,d,dtype", [
    (2, 2, 65, 130, 32, torch.bfloat16),   # ragged cross-attention, two key blocks
    (2, 2, 512, 512, 128, torch.bfloat16),  # MAX_SEQ at d 128: four key blocks, 32-row steps
    (4, 3, 197, 197, 64, torch.bfloat16),
    (3, 2, 17, 33, 64, torch.float16),
    (2, 2, 1, 7, 64, torch.bfloat16),  # one query row (with one key, dq is rounding noise)
    (2, 2, 197, 197, 128, torch.float16),
    (2, 2, 65, 65, 32, torch.float16),
    (2, 2, 161, 161, 64, torch.float16),  # one 208-key tile
] + [
    # the forward's key tiles (csrc/short_attention.cu's fwd_tiles): 80 at 65-73, 128 at
    # 100, 208 at 197 at d <= 64 (2 x 128 at d 128), 2 x 128 at 256, 2 x 144 at 257-288,
    # 3 and 4 x 128 at 289 and 512, on one and two query warpgroups; the backward's two
    # 144-key blocks at 257-288
    (2, 2, n, n, d, torch.bfloat16) for n in (65, 72, 73, 100, 197, 256, 257, 280, 288, 289,
                                              512)
    for d in (32, 64, 128)
] + [
    # the backward's key blocks (csrc/short_attention.cu's bwd_key_block): 64 up to 64 keys,
    # 80 up to 80 (one 80-row query step), 128 up to 128 on mma.sync, 256 up to 256 at
    # d <= 64 on wgmma (and 256 above), 144- and 128-key blocks with dq partials past them
    (2, 2, n, n, d, torch.bfloat16) for n in (64, 80, 81, 128, 129, 208, 209)
    for d in (32, 64, 128)
] + [
    (2, 2, 300, 80, 64, torch.bfloat16),  # four 80-row steps through the 2-stage ring
    (3, 2, 257, 208, 64, torch.float16),  # five 64-row steps on the wgmma backward
])
def test_short_attention_kernels_match_plain(cuda, b, h, n_q, n_k, d, dtype):
    """The op under autograd: forward (out, lse) against its plain version,
    the backward against the plain backward fed the kernel's out and lse,
    twice bit for bit."""
    q, k, v, do = _short_inputs(cuda, b, h, n_q, n_k, d, dtype, seed=n_q)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = (sa.short_attention.launches, sa.short_attention_backward.launches)
    out = sa.short_attention(*leaves)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert (sa.short_attention.launches, sa.short_attention_backward.launches) == \
        (before[0] + 1, before[1] + 1)
    fwd, lse = sa.short_attention_forward(q, k, v)
    assert torch.equal(fwd, out.detach())
    ref_out, ref_lse = sa.short_attention_forward_reference(q, k, v)
    check_outputs(torch, "short attention forward", (fwd,), (ref_out,), {})
    assert (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
    check_outputs(torch, "short attention backward", grads,
                  sa.short_attention_backward_reference(q, k, v, fwd, lse, do, d ** -0.5), {})
    again = torch.autograd.grad(sa.short_attention(*leaves), leaves, do)
    assert all(torch.equal(a, b_) for a, b_ in zip(grads, again))


def test_short_attention_refuses_what_it_does_not_take(cuda):
    q, k, v, _ = _short_inputs(cuda, 1, 2, 513, 513, 64)
    with torch.inference_mode(), pytest.raises(ValueError, match="512"):
        sa.short_attention(q, k, v)
    q, k, v, _ = _short_inputs(cuda, 1, 2, 64, 64, 48)
    with torch.inference_mode(), pytest.raises(ValueError, match="d in"):
        sa.short_attention(q, k, v)
    q, k, v, _ = _short_inputs(cuda, 1, 2, 64, 64, 64, torch.float32)
    with torch.inference_mode(), pytest.raises(TypeError):
        sa.short_attention(q, k, v)


def _hybrid_args(cuda, t, d, inner, hidden, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=cuda) * scale).to(torch.bfloat16)

    ln = (rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1))
    return dict(x=rn(t, d), ln1=ln, wqkv=rn(3 * inner, d, scale=d ** -0.5),
                wo=rn(d, inner, scale=inner ** -0.5), bo=rn(d, scale=0.1),
                ln2=(rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1)),
                mlp=(rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
                     rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1)),
                dz=rn(t, d, scale=0.1))


@pytest.mark.parametrize("b,n,d,heads,dh,hidden", [
    (128, 65, 1024, 16, 64, 2048),  # ViT-B/32 at bench.py's batch
    (3, 67, 1024, 16, 64, 2048),    # B/32's widths at 201 rows: proj_mlp's dgrads on gemm_wgmma
    (64, 33, 96, 3, 32, 160),       # three heads of 32; ragged rows and widths
])
def test_hybrid_layer_kernels_match_plain(cuda, b, n, d, heads, dh, hidden):
    """ln_gemm, attention_nb and proj_mlp chained as the layer chains them:
    each training forward against its plain version, each backward fed its
    forward's residuals against the plain backward, twice bit for bit; the
    attention's gradient lands in one (t, 3·inner) buffer."""
    t, inner, eps = b * n, heads * dh, 1e-3
    a = _hybrid_args(cuda, t, d, inner, hidden, seed=n)
    x, (g1, b1n), (g2, b2n), (w1, _, w2, _) = a["x"], a["ln1"], a["ln2"], a["mlp"]
    before = (fh.ln_gemm.launches, fh.attention_nb.launches, fh.proj_mlp.launches)
    qkv, xn1 = fh._launch_ln_gemm(x, g1, b1n, a["wqkv"], eps)
    check_outputs(torch, "ln_gemm", (qkv, xn1),
                  fh.ln_gemm_forward_reference(x, g1, b1n, a["wqkv"], eps), {})
    q, k, v = (c.reshape(n, b, inner) for c in qkv.chunk(3, -1))
    o, lse = fh.attention_nb_forward(q, k, v, heads, dh)
    ref_o, ref_lse = fh.attention_nb_forward_reference(q, k, v, heads, dh)
    check_outputs(torch, "attention_nb", (o,), (ref_o,), {})
    assert (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
    o2 = o.reshape(t, inner)
    fwd = fh._launch_proj_mlp(x, o2, a["wo"], a["bo"], g2, b2n, *a["mlp"], eps, True)
    ref = fh.proj_mlp_forward_reference(x, o2, a["wo"], a["bo"], g2, b2n, *a["mlp"], eps)
    check_outputs(torch, "proj_mlp", fwd, ref, {0: ref[1], 1: x})
    assert (fh.ln_gemm.launches, fh.attention_nb.launches, fh.proj_mlp.launches) == \
        tuple(c + 1 for c in before)
    _, y, _, h = fwd

    def proj_bwd():
        return fh.proj_mlp_backward(a["dz"], y, h, g2, a["wo"], w1, w2, eps)

    got = proj_bwd()
    check_outputs(torch, "proj_mlp backward", got, fh.proj_mlp_backward_reference(
        a["dz"], y, h, g2, a["wo"], w1, w2, eps), {0: a["dz"]})
    _twice(got, proj_bwd())
    do = got[1].reshape(n, b, inner)
    grads = fh.attention_nb_backward(do, q, k, v, o, lse, heads, dh)
    check_outputs(torch, "attention_nb backward", grads, fh.attention_nb_backward_reference(
        do, q, k, v, o, lse, heads, dh), {})
    _twice(grads, fh.attention_nb_backward(do, q, k, v, o, lse, heads, dh))
    dqkv = fh._joined([g_.reshape(t, inner) for g_ in grads])
    assert dqkv.data_ptr() == grads[0].data_ptr()
    got = fh.ln_gemm_backward(dqkv, x, g1, a["wqkv"], eps)
    check_outputs(torch, "ln_gemm backward", got,
                  fh.ln_gemm_backward_reference(dqkv, x, g1, a["wqkv"], eps), {})
    _twice(got, fh.ln_gemm_backward(dqkv, x, g1, a["wqkv"], eps))


@pytest.mark.parametrize("rows,d,n_out,dtype", [
    (8320 + 13, 72, 200, torch.bfloat16),  # no extent a multiple of its tile
    (8320 + 13, 72, 200, torch.float16),
    (129, 1024, 3072, torch.float16),
    (8320, 1024, 3072, torch.bfloat16),    # ViT-B/32's QKV at batch 128
])
def test_ln_gemm_forward_matches_plain(cuda, rows, d, n_out, dtype):
    """ln_gemm's forward (LayerNorm pass, then the wgmma GEMM) against its
    plain version, out and xn, where rows, d and n_out are not multiples of
    the GEMM's 128 x 128 x 64 tiles; the same bits on two runs."""
    g = torch.Generator(device=cuda).manual_seed(rows + d)

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=cuda) * scale).to(dtype)

    x, gamma, beta = rn(rows, d), rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1)
    w = rn(n_out, d, scale=d ** -0.5)
    before = fh.ln_gemm.launches
    got = fh._launch_ln_gemm(x, gamma, beta, w, 1e-3)
    torch.cuda.synchronize()
    assert fh.ln_gemm.launches == before + 1
    check_outputs(torch, "ln_gemm", got, fh.ln_gemm_forward_reference(x, gamma, beta, w, 1e-3),
                  {})
    _twice(got, fh._launch_ln_gemm(x, gamma, beta, w, 1e-3))


# (rows, n, k) of proj_mlp's out-projection, fc1 and fc2 at ViT-B/32's layer
# (batch 128, n 65) and at the ragged layer (2112 rows, d 96, hidden 160: n
# below 256 and k no multiple of 64, so the maps fill zeros and the stores are
# predicated).
GEMM_SHAPES = [(8320, 1024, 1024), (8320, 2048, 1024), (8320, 1024, 2048),
               (2112, 96, 96), (2112, 160, 96), (2112, 96, 160)]
# (rows, n, k) of the blocks' dgrads over W (k, n) as it lies: dy·Wo, dy·W2,
# dh·W1 and dqkv·Wqkv at bench.py's B/32 step (8320 rows), dy·W2 and dh·W1 at
# B/16 (12,608 rows: n 3072 and 768), ragged rows at n 1024, ScalableViT's
# stage-1 dh·W1 (n 64), and n 264 (a partial 64-column box).
DGRAD_SHAPES = [(8320, 1024, 1024), (8320, 2048, 1024), (8320, 1024, 2048), (8320, 1024, 3072),
                (12608, 3072, 768), (12608, 768, 3072), (2111, 1024, 96), (4096, 64, 256),
                (1000, 264, 136)]
GEMM_CASES = [("nk", e, shape) for e in fh.GEMM_EPILOGUES for shape in GEMM_SHAPES] + \
    [("kn", e, shape) for e in fh.DGRAD_EPILOGUES if e != "ln_bwd" for shape in DGRAD_SHAPES]


@pytest.mark.parametrize("layout,epilogue,shape", GEMM_CASES)
def test_gemm_wgmma_epilogue_matches_plain(cuda, layout, epilogue, shape):
    """Each epilogue of the GEMM, over an (n, k) weight (the forward's) and
    over a (k, n) one read as it lies (B MN-major: the dgrads'), against its
    plain version (out, and h where it keeps h; dh, gact and db1 for dGELU;
    bias + residual held against its residual), the same bits on two runs."""
    rows, n, k = shape
    g = torch.Generator(device=cuda).manual_seed(rows + n + k)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=cuda) * scale).to(torch.bfloat16)

    a, bias, res, h = rn(rows, k), rn(n, scale=0.1), rn(rows, n), rn(rows, n)
    w = rn(n, k, scale=k ** -0.5) if layout == "nk" else rn(k, n, scale=k ** -0.5)
    before = fh.gemm_wgmma.launches
    got = fh.gemm_wgmma(a, w, epilogue, bias, res, h, layout)
    torch.cuda.synchronize()
    assert fh.gemm_wgmma.launches == before + 1
    ref = fh.gemm_reference(a, w, epilogue, bias, res, h, layout)
    kept = [i for i, r in enumerate(ref) if r is not None]
    assert [i for i, o in enumerate(got) if o is not None] == kept
    check_outputs(torch, f"gemm {layout} {epilogue}", [got[i] for i in kept],
                  [ref[i] for i in kept], {0: res} if epilogue == "bias_residual" else {})
    again = fh.gemm_wgmma(a, w, epilogue, bias, res, h, layout)
    _twice([got[i] for i in kept], [again[i] for i in kept])


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("rows", [8320, 12608, 1000])
@pytest.mark.parametrize("d", [256, 512, 768, 1024])
def test_ln_bwd_epilogue_matches_plain(cuda, d, rows, residual):
    """The dgrad whose epilogue is the LayerNorm backward (kEpiLnBwd, a
    cluster of d / 256 CTAs), with the residual dy (rows 2, 4 and 14) and
    without (row 12), at B/32's and B/16's rows and a ragged count: dx held
    against its residual, dγ, dβ and Σ dy within DBIAS_REL_TOL·max|ref|, the
    same bits on two runs."""
    g = torch.Generator(device=cuda).manual_seed(rows + d)

    def rn(*shape, scale=1.0, shift=0.0):
        return (shift + torch.randn(*shape, generator=g, device=cuda) * scale).to(torch.bfloat16)

    k = 2 * d
    a, w = rn(rows, k, scale=0.1), rn(k, d, scale=k ** -0.5)
    x, gamma = rn(rows, d, shift=0.5), rn(d, scale=0.1, shift=1.0)
    dy = rn(rows, d, scale=0.1) if residual else None
    before = fh.gemm_wgmma.launches
    got = fh.gemm_wgmma(a, w, "ln_bwd", layout="kn", x=x, gamma=gamma, dy=dy)
    torch.cuda.synchronize()
    assert fh.gemm_wgmma.launches == before + 1
    ref = fh.gemm_reference(a, w, "ln_bwd", layout="kn", x=x, gamma=gamma, dy=dy)
    assert (got[3] is None) == (ref[3] is None) == (not residual)
    check_outputs(torch, f"ln_bwd d={d}", got[:1], ref[:1], {0: dy} if residual else {})
    for name, o, r in zip(("dgamma", "dbeta", "dsum"), got[1:], ref[1:]):
        if r is not None:
            check_dbias(torch, f"ln_bwd d={d}", o, r, name)
    again = fh.gemm_wgmma(a, w, "ln_bwd", layout="kn", x=x, gamma=gamma, dy=dy)
    _twice([o for o in got if o is not None], [o for o in again if o is not None])


def test_ln_bwd_fused_is_the_c_predicate(cuda):
    """C chooses the LayerNorm-backward dgrad by the widths the Python
    wrappers allocate by, and runs each of its cluster sizes."""
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.ops._shared import ln_bwd_fused

    lib = _build.load()
    assert all(bool(lib.vit_ln_bwd_fused(d)) == ln_bwd_fused(d) for d in range(8, 4097, 8))
    assert all(lib.vit_ln_bwd_clusters(d) > 0 for d in range(256, 2049, 256))
    with pytest.raises(ValueError, match="ln_bwd"):
        z = torch.zeros(64, 64, dtype=torch.bfloat16, device=cuda)
        fh.gemm_wgmma(z, torch.zeros(64, 192, dtype=torch.bfloat16, device=cuda), "ln_bwd",
                      layout="kn", x=z, gamma=z[0])


def test_library_counts_its_launches_where_it_makes_them(cuda):
    """``vit_take_launch_count`` (csrc/kernels.cuh Counted: gemm_wgmma.cu's
    kernel, its LayerNorm-backward instance, layernorm.cu's backward passes,
    linear.cu's GEMM, launch_forward_gemm's f32 partial sums) moves by one for
    each launch of its kind and no other, and a take sets it back to 0."""
    from vit_tpu_torch.ops import _build

    lib = _build.load()
    kinds = range(4)

    def take():
        torch.cuda.synchronize()
        return [lib.vit_take_launch_count(i) for i in kinds]

    g = torch.Generator(device=cuda).manual_seed(0)
    a, x, w = (torch.randn(rows, 512, generator=g, device=cuda).to(torch.bfloat16)
               for rows in (256, 256, 512))  # w (k, n) as the dgrads read it
    take()
    fh.gemm_wgmma(a, w, "store", layout="kn")
    assert take() == [1, 0, 0, 0]
    fh.gemm_wgmma(a, w, "store", layout="kn", kernel="mma_sync")
    assert take() == [0, 0, 0, 1]
    fh.gemm_wgmma(a, w, "ln_bwd", layout="kn", x=x, gamma=x[0], dy=x)
    fh.gemm_wgmma(a, w, "ln_bwd", layout="kn", x=x, gamma=x[0], dy=x)
    assert take() == [2, 2, 0, 0]
    # The fused MLP's backward at d 64, outside ln_bwd_fused: dh·W1 keeps the
    # f32 dxn and the LayerNorm backward's passes run once.
    rows, d, hidden = 256, 64, 256
    dy, xm, hm = (torch.randn(rows, c, generator=g, device=cuda).to(torch.bfloat16)
                  for c in (d, d, hidden))
    w1, w2 = (torch.randn(*shape, generator=g, device=cuda).to(torch.bfloat16) * 0.05
              for shape in ((hidden, d), (d, hidden)))
    fused_mlp_ops.fused_mlp_backward(dy, xm, hm, xm[0], w1, w2)
    counts = take()
    assert counts[1] == 0 and counts[2] == 1
    # The split MLP's forward: fc1 on gemm_wgmma (n 256), fc2's f32 partial on
    # linear.cu (n 64), counted as the f32 partial sum too.
    fused_mlp_ops.fused_mlp_partial_forward(xm, xm[0], xm[0], w1, hm[0], w2)
    assert take() == [1, 0, 0, 1] and lib.vit_take_launch_count(4) == 1
    assert take() == [0, 0, 0, 0] and lib.vit_take_launch_count(4) == 0
    assert lib.vit_take_launch_count(5) == -1


@pytest.mark.parametrize("b,n,heads,dh", [(128, 65, 16, 64), (64, 33, 3, 32), (8, 80, 4, 64),
                                          (8, 81, 4, 64)])
def test_attention_nb_backward_matches_plain(cuda, b, n, heads, dh):
    """attention_nb's backward over (n, b, heads·dh) column views of one q|k|v
    projection (ViT-B/32's layer at bench.py's batch, the ragged layer, and
    either side of the 80-key block) against its plain backward fed the
    kernel's own out and lse, twice bit for bit, into one (n, b, 3·inner)
    buffer."""
    g = torch.Generator(device=cuda).manual_seed(n)
    inner = heads * dh
    qkv = torch.randn(n, b, 3 * inner, generator=g, device=cuda).to(torch.bfloat16)
    q, k, v = qkv.chunk(3, -1)
    do = torch.randn(n, b, inner, generator=g, device=cuda).to(torch.bfloat16)
    o, lse = fh.attention_nb_forward(q, k, v, heads, dh)
    before = fh.attention_nb_backward.launches
    grads = fh.attention_nb_backward(do, q, k, v, o, lse, heads, dh)
    torch.cuda.synchronize()
    assert fh.attention_nb_backward.launches == before + 1
    check_outputs(torch, "attention_nb backward", grads,
                  fh.attention_nb_backward_reference(do, q, k, v, o, lse, heads, dh), {})
    _twice(grads, fh.attention_nb_backward(do, q, k, v, o, lse, heads, dh))
    assert fh._joined([t.reshape(n * b, inner) for t in grads]).data_ptr() == grads[0].data_ptr()


def _hybrid_launches():
    return (fh.ln_gemm.launches, fh.attention_nb.launches, fh.proj_mlp.launches,
            fh.ln_gemm_backward.launches, fh.attention_nb_backward.launches,
            fh.proj_mlp_backward.launches, fused_attention_block.launches, fused_mlp.launches)


def test_vit_hybrid_tier_serves_and_trains_through_its_kernels(cuda):
    """ViT-B/32's widths at depth 2, batch 64 (n 65): each forward launches
    ln_gemm, attention_nb and proj_mlp once per layer and none of the block
    kernels; each train step their backwards as often; f32 gradients, and
    SGD(1e-3) losses that fall and stay within 1e-2 of the plain path's from
    the same weights."""
    cfg = dict(image_size=256, patch_size=32, num_classes=10, dim=1024, depth=2, heads=16,
               mlp_dim=2048, fused_attention="hybrid")
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.randn(64, 256, 256, 3, generator=g, device=cuda)
    served = cast_params(ViT(**cfg, generator=g), torch.bfloat16).eval()
    before = _hybrid_launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(_hybrid_launches(), before)] == [2, 2, 2, 0, 0, 0, 0, 0]
    assert out.shape == (64, 10) and torch.isfinite(out).all()
    model = ViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    plain = ViT(**{**cfg, "fused_attention": "never", "fused_mlp": "never"},
                compute_dtype=torch.bfloat16)
    plain.load_state_dict(model.state_dict())
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    plain_step = make_train_step(plain, torch.optim.SGD(plain.parameters(), lr=1e-3))
    labels = torch.arange(64, device=cuda) % 10
    losses, plain_losses = [], []
    for _ in range(3):
        before = _hybrid_launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(_hybrid_launches(), before)] == [2, 2, 2, 2, 2, 2, 0, 0]
        plain_losses.append(float(plain_step(img, labels)["loss"]))
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert losses[2] < losses[0]
    assert all(abs(a - b) <= 1e-2 * abs(b) for a, b in zip(losses, plain_losses)), \
        (losses, plain_losses)


# T2T-ViT's widths, off 8: its token transformers' MLPs (d = hidden = 147 and
# 1323), a hidden width alone off 8, a model width alone off 8.
MLP_OFF_8_SHAPES = [
    ((2, 33, 147), 147, torch.bfloat16),
    ((3, 17, 147), 147, torch.float16),
    ((2, 9, 1323), 1323, torch.bfloat16),  # fc1 and the dgrads on gemm_wgmma at n 1328
    ((2, 17, 64), 100, torch.bfloat16),
    ((2, 9, 60), 128, torch.bfloat16),
]


@pytest.mark.parametrize("shape,hidden,dtype", MLP_OFF_8_SHAPES)
def test_fused_mlp_kernels_at_widths_off_8(cuda, shape, hidden, dtype):
    """Serving and training forwards and the backward at widths off 8 against
    the plain versions (xn and h at the padded widths, their pad columns 0),
    the same bits twice; under autograd, the parameters' gradients at their
    own shapes."""
    args = _mlp_args(shape, hidden, dtype, cuda, seed=3)
    x, gamma, beta, w1, b1, w2, b2 = args
    d = shape[-1]
    with torch.inference_mode():
        out = fused_mlp(*args)
        _close(out, fused_mlp_reference(*args), x)
        assert torch.equal(out, fused_mlp(*args))
    y, xn, h = fused_mlp_ops._launch_forward(*args, 1e-3, save_residuals=True)
    ref = fused_mlp_forward_reference(*args)
    check_outputs(torch, "fused_mlp training forward", (y, xn[..., :d], h[..., :hidden]), ref,
                  {0: x})
    assert not xn[..., d:].any() and not h[..., hidden:].any()
    dy = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(dtype)
    before = fused_mlp_backward.launches
    got = fused_mlp_backward(dy, x, h, gamma, w1, w2)
    assert fused_mlp_backward.launches == before + 1
    check_outputs(torch, "fused_mlp_bwd", got,
                  fused_mlp_backward_reference(dy, x, ref[2], gamma, w1, w2), {0: dy})
    _twice(got, fused_mlp_backward(dy, x, h, gamma, w1, w2))
    params = [t.detach().float().requires_grad_() for t in args[1:]]
    xg = x.detach().requires_grad_()
    fused_mlp(xg, *(p.to(dtype) for p in params)).float().square().sum().backward()
    assert xg.grad.shape == x.shape and all(p.grad.shape == p.shape for p in params)
    assert all(torch.isfinite(p.grad).all() for p in params)


@pytest.mark.parametrize("b,h,n_q,n_k,dtype", [
    (2, 1, 1000, 1100, torch.bfloat16),  # ragged key tiles and query blocks
    (1, 2, 64, 200, torch.float16),      # one query block of one warpgroup
    (1, 1, 129, 65, torch.bfloat16),     # one key past a block, one row past a block
])
def test_flash_kernels_at_192(cuda, b, h, n_q, n_k, dtype):
    """The (192, 192) instance, from 147-wide q, k, v zero-padded as the
    dispatcher pads them: forward, lse and the backward (dk and dv in two
    launches) against the plain versions; the pad columns of every output 0."""
    g = torch.Generator(device=cuda).manual_seed(n_q)
    q, k, v, do = (torch.nn.functional.pad(
        torch.randn(b, h, n, 147, generator=g, device=cuda).to(dtype), (0, 45))
        for n in (n_q, n_k, n_k, n_q))
    _check_flash(q, k, v, do)
    out, lse = flash_attention_forward(q, k, v)
    assert not out[..., 147:].any()
    assert not any(t[..., 147:].any() for t in flash_backward(q, k, v, out, lse, do, 147 ** -0.5))


def test_flash_refuses_a_width_without_an_instance(cuda):
    """A 16-bit CUDA call at a head width with no instance raises, at the op
    and through the dispatcher (1323 is padded to 1344: no instance)."""
    q = torch.zeros(1, 1, 1024, 160, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="no kernel instance"):
        flash_attention(q, q, q)
    q = torch.zeros(1, 1, 1024, 1323, dtype=torch.bfloat16, device=cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="no kernel instance"):
        attention_ops.scaled_dot_product_attention(q, q, q)


def test_t2t_serves_and_trains_through_its_kernels(cuda):
    """A narrow T2T-ViT at 128 px (its first token transformer over 32² =
    1024 tokens, 147 wide: the flash tier; its second over 256, 1323 wide:
    the plain attention): serving launches the flash forward once, the fused
    MLP at both token widths and every encoder layer, the fused block at every
    encoder layer; a train step each backward as often; the distillable
    student through DistillWrapper."""
    from vit_tpu_torch import DistillableT2TViT, DistillWrapper, T2TViT
    from vit_tpu_torch.parallel.train import make_loss_train_step

    cfg = dict(image_size=128, num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128,
               dim_head=32)
    g = torch.Generator(device=cuda).manual_seed(5)
    img = torch.randn(2, 128, 128, 3, generator=g, device=cuda)
    counters = (flash_attention, fused_mlp, fused_attention_block, flash_backward,
                fused_mlp_backward, fused_attention_block_backward)

    def launches():
        return [c.launches for c in counters]

    model = cast_params(T2TViT(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        logits = model(img)
    assert [a - b for a, b in zip(launches(), before)] == [1, 4, 2, 0, 0, 0]
    assert logits.shape == (2, 10) and torch.isfinite(logits).all()
    model = T2TViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    before = launches()
    losses = [step(img, labels)["loss"].item() for _ in range(3)]
    assert [a - b for a, b in zip(launches(), before)] == [3, 12, 6, 3, 12, 6]
    assert all(torch.isfinite(torch.tensor(losses))) and losses[-1] < losses[0]
    wrapper = DistillWrapper(T2TViT(**cfg, compute_dtype=torch.bfloat16, generator=g),
                             DistillableT2TViT(**cfg, compute_dtype=torch.bfloat16, generator=g),
                             compute_dtype=torch.bfloat16, generator=g)
    step = make_loss_train_step(wrapper, torch.optim.AdamW(wrapper.parameters(), lr=1e-3))
    before = launches()
    loss = step((img, labels))["loss"].item()
    assert [a - b for a, b in zip(launches(), before)] == [2, 8, 4, 1, 4, 2]
    assert loss == loss and all(p.grad is None for p in wrapper.teacher.parameters())


# Twins-SVT's local attention at its three stages, batch 8: (groups, n, c)
# with the 7 x 7 windows folded into the batch, 8 heads of 64 (inner 512
# above c), the ChannelLayerNorm's eps.
TWINS_EPS = 1e-5


@pytest.mark.parametrize("groups,c", [(512, 64), (128, 128), (32, 256)])
def test_twins_window_block_kernels_match_plain(cuda, groups, c):
    """The block over folded 7 x 7 windows (49 tokens: one ragged 64-key
    tile on the short route) at eps 1e-5: the serving and the training
    forward and the backward fed the training forward's residuals against
    their plain versions, twice bit for bit; its LayerNorm backward on
    layernorm.cu's passes at c 64 and 128 and as the dgrad's epilogue at
    256."""
    from chip_smoke import counted_launches

    b, n, heads, dh = groups, 49, 8, 64
    args = _attn_args(b, n, c, heads, dh, torch.bfloat16, cuda, seed=c)
    x = args[0]
    scale = dh ** -0.5
    with torch.inference_mode():
        out = fused_attention_block(*args, heads, dh, eps=TWINS_EPS)
        _close(out, fused_attention_block_reference(*args, heads, dh, eps=TWINS_EPS), x)
        assert torch.equal(out, fused_attention_block(*args, heads, dh, eps=TWINS_EPS))
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, scale, TWINS_EPS,
                                                    training=True)
    check_outputs(torch, "twins window training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, TWINS_EPS),
                  {0: x})
    _, xn, qkv, oattn, lse = fwd
    dy = torch.randn(b, n, c, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda).to(torch.bfloat16)
    x, gamma, _, wqkv, wo, _ = args

    def kernel():
        return fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale,
                                              TWINS_EPS, oattn=oattn, lse=lse)

    got = kernel()
    check_outputs(torch, "twins window backward", got,
                  fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                           dh, scale, TWINS_EPS), {0: dy})
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == ((1, 0) if c == 256 else (0, 1))


def test_twins_local_fold_past_the_grid_is_cut_into_launches(cuda, monkeypatch):
    """A fold past MAX_WINDOW_GROUPS (here lowered to 3) goes in launches of
    at most that many groups, each on the kernel, joined to what one launch
    gives; the op itself refuses a batch past the short route's grid."""
    from vit_tpu_torch.layers.common import ChannelLayerNorm
    from vit_tpu_torch.models import twins_svt

    g = torch.Generator(device=cuda).manual_seed(9)
    norm = ChannelLayerNorm(64, device=cuda)
    attn = twins_svt.LocalAttention(64, generator=g, device=cuda)
    x = torch.randn(2, 14, 14, 64, generator=g, device=cuda).to(torch.bfloat16)
    with torch.inference_mode():
        whole = twins_svt.local_attention_residual(x, norm, attn)
        monkeypatch.setattr(twins_svt, "MAX_WINDOW_GROUPS", 3)
        before = fused_attention_block.launches
        cut = twins_svt.local_attention_residual(x, norm, attn)
        assert fused_attention_block.launches == before + 3
    assert torch.equal(cut, whole)
    args = _attn_args(fused_attention_block_ops.SHORT_MAX_BATCH + 1, 1, 64, 1, 64,
                      torch.bfloat16, cuda)
    with torch.inference_mode(), pytest.raises(ValueError, match="at most 65535 images"):
        fused_attention_block(*args, 1, 64)


def test_twins_svt_serves_and_trains_through_its_kernels(cuda):
    """Twins-SVT at its widths (64/128/256/512, 8 heads of 64), depth 1 a
    stage, 224 px, batch 2: a forward launches the block over the folded
    windows at each local attention (6), the cross-attention block at each
    global one (8: stage 4's one key included) and the fused MLP at each
    conv-MLP (14); a train step their backwards as often, the
    cross-attention backward split at all of them; f32 gradients, a falling
    loss."""
    from vit_tpu_torch import TwinsSVT

    cfg = dict(num_classes=10, s3_depth=1, s4_depth=1)
    g = torch.Generator(device=cuda).manual_seed(11)
    img = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    counters = (fused_attention_block, fca.fused_cross_attention, fused_mlp,
                fused_attention_block_backward, fca.fused_cross_attention_backward,
                fused_mlp_backward, fca.BACKWARD_ROUTES[2])

    def launches():
        return [c.launches for c in counters]

    served = cast_params(TwinsSVT(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(launches(), before)] == [6, 8, 14, 0, 0, 0, 0]
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    model = TwinsSVT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    losses = []
    for _ in range(3):
        before = launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(launches(), before)] == [6, 8, 14, 6, 8, 14, 8]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert losses[2] < losses[0]


# CrossFormer's windows at its four stages, batch 4: (groups, n, c), heads of
# 32 (c / 32 of them), a (1, n, n) position bias the heads share, eps 1e-5.
# Short 7 x 7 windows (49 tokens) at c 64, 128, 256 and 512; long dilated
# windows of 8 x 8 and 4 x 4 tokens at c 64 and 128.
CROSSFORMER_WINDOWS = [(256, 49, 64), (64, 49, 128), (16, 49, 256), (4, 49, 512),
                       (196, 64, 64), (196, 16, 128)]


@pytest.mark.parametrize("groups,n,c", CROSSFORMER_WINDOWS)
def test_crossformer_window_block_kernels_match_plain(cuda, groups, n, c):
    """The biased block at dh 32 over folded windows (one 64-key tile, ragged
    at 16 and 49 tokens) with a shared bias that asks for dbias: the serving
    and the training forward and the backward fed the training forward's
    residuals against their plain versions (the TPU kernel's rounding points,
    and the short route's own: with dbias, dsum = Σ p·dp from the row
    statistics it takes first), dbias within DBIAS_REL_TOL of both; the
    backward twice bit for bit,
    its LayerNorm backward as the dgrad's epilogue at c 256 and 512 and on
    layernorm.cu's passes at 64 and 128."""
    from chip_smoke import counted_launches

    heads, dh, eps = c // 32, 32, 1e-5
    args = _attn_args(groups, n, c, heads, dh, torch.bfloat16, cuda, seed=n + c)
    x, gamma, _, wqkv, wo, _ = args
    bias = _bias("shared", heads, n, cuda)
    scale = dh ** -0.5
    with torch.inference_mode():
        out = fused_attention_block_bias(*args, bias, heads, dh, scale, eps)
        _close(out, fused_attention_block_reference(*args, heads, dh, scale, eps, bias), x)
        assert torch.equal(out, fused_attention_block_bias(*args, bias, heads, dh, scale, eps))
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, scale, eps, bias,
                                                    training=True)
    check_outputs(torch, "crossformer window training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, eps, bias),
                  {0: x})
    _, _, qkv, oattn, lse = fwd
    lse_ref = fused_attention_block_ops.attention_lse_reference(qkv, heads, dh, scale, bias)
    assert (lse - lse_ref).abs().max().item() <= LSE_ABS_TOL
    dy = torch.randn(groups, n, c, generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                   scale, eps, oattn=oattn, lse=lse)

    got = kernel()
    tpu = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale,
                                                   eps, bias)
    check_outputs(torch, "crossformer window backward", got[:5], tpu[:5], {0: dy})
    own = fused_attention_block_ops.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, scale, eps, bias)
    check_outputs(torch, "crossformer window backward, short route", got[:5], own[:5], {0: dy})
    check_dbias(torch, "crossformer window backward", got[5], own[5])
    check_dbias(torch, "crossformer window backward, TPU rounding points", got[5], tpu[5])
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == ((1, 0) if c >= 256 else (0, 1))


def test_crossformer_serves_and_trains_through_its_kernels(cuda):
    """CrossFormer at its widths (64/128/256/512, heads of 32), depth 1 a
    stage, 224 px, batch 2: a forward launches the biased block at each
    short attention (4) and at the long ones of 8 x 8 and 4 x 4 windows (2;
    stages 3-4's 2 x 2 and 1 x 1 take the plain modules), the fused MLP at
    each MLP (8); a train step their backwards as often, dbias at each; f32
    gradients, the position-bias MLPs' among them, and a falling loss."""
    from vit_tpu_torch import CrossFormer

    cfg = dict(num_classes=10, depth=(1, 1, 1, 1))
    g = torch.Generator(device=cuda).manual_seed(12)
    img = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    counters = (fused_attention_block_bias, fused_mlp, fused_attention_block_bias_backward,
                fused_mlp_backward, fused_attention_block, fused_attention_block_backward)

    def launches():
        return [c.launches for c in counters]

    served = cast_params(CrossFormer(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(launches(), before)] == [6, 8, 0, 0, 0, 0]
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    model = CrossFormer(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    losses = []
    for _ in range(3):
        before = launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(launches(), before)] == [6, 8, 6, 8, 0, 0]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert model.short_attn_0_0.dpb.fc0.weight.grad.abs().max() > 0
    assert losses[2] < losses[0]


# RegionViT's attentions at its four stages, batch 4, 4 heads of 32, eps
# 1e-3: the region self-attention on the block, one group an image of 64, 16,
# 4 and 1 tokens (c 64, 128, 256, 512); the joint attention on the biased
# block, 50 tokens (a region token and its 7 x 7 window) over 4 images'
# windows, a per-head (4, 50, 50) bias that asks for dbias.
REGIONVIT_REGIONS = [(4, 64, 64), (4, 16, 128), (4, 4, 256), (4, 1, 512)]
REGIONVIT_JOINTS = [(256, 64), (64, 128), (16, 256), (4, 512)]


@pytest.mark.parametrize("groups,n,c", REGIONVIT_REGIONS)
def test_regionvit_region_block_kernels_match_plain(cuda, groups, n, c):
    """The unbiased block at dh 32 over 64, 16, 4 and 1 tokens (one 64-key
    tile, mostly padding): the serving and the training forward and the
    backward fed the training forward's residuals against their plain
    versions (the TPU kernel's rounding points and the short route's own),
    twice bit for bit; over one key dq and dk are 0 exactly, as the TPU
    kernel's softmax over one key gives them."""
    heads, dh, inner = 4, 32, 128
    args = _attn_args(groups, n, c, heads, dh, torch.bfloat16, cuda, seed=n + c)
    x, gamma, _, wqkv, wo, _ = args
    with torch.inference_mode():
        out = fused_attention_block(*args, heads, dh)
        _close(out, fused_attention_block_reference(*args, heads, dh), x)
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, dh ** -0.5, 1e-3,
                                                    training=True)
    check_outputs(torch, "regionvit region training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh), {0: x})
    _, _, qkv, oattn, lse = fwd
    dy = torch.randn(groups, n, c, generator=torch.Generator(device=cuda).manual_seed(3),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                              oattn=oattn, lse=lse)

    got = kernel()
    check_outputs(torch, "regionvit region backward", got,
                  fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                           dh), {0: dy})
    check_outputs(torch, "regionvit region backward, short route", got,
                  fused_attention_block_ops.fused_attention_block_lse_backward_reference(
                      dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh), {0: dy})
    _twice(got, kernel())
    if n == 1:
        assert torch.count_nonzero(got[1][..., :2 * inner]) == 0


@pytest.mark.parametrize("groups,c", REGIONVIT_JOINTS)
def test_regionvit_joint_block_kernels_match_plain(cuda, groups, c):
    """The biased block at dh 32 over 50 tokens with a per-head bias that asks
    for dbias (hb = heads): the forwards and the backward against their plain
    versions, dbias within DBIAS_REL_TOL of both, the backward twice bit for
    bit."""
    heads, dh, n = 4, 32, 50
    args = _attn_args(groups, n, c, heads, dh, torch.bfloat16, cuda, seed=c)
    x, gamma, _, wqkv, wo, _ = args
    bias = _bias("per-head", heads, n, cuda)
    with torch.inference_mode():
        out = fused_attention_block_bias(*args, bias, heads, dh)
        _close(out, fused_attention_block_reference(*args, heads, dh, bias=bias), x)
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, dh ** -0.5, 1e-3, bias,
                                                    training=True)
    check_outputs(torch, "regionvit joint training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, bias=bias), {0: x})
    _, _, qkv, oattn, lse = fwd
    dy = torch.randn(groups, n, c, generator=torch.Generator(device=cuda).manual_seed(4),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                   oattn=oattn, lse=lse)

    got = kernel()
    tpu = fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                                   bias=bias)
    own = fused_attention_block_ops.fused_attention_block_lse_backward_reference(
        dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, bias=bias)
    check_outputs(torch, "regionvit joint backward", got[:5], tpu[:5], {0: dy})
    check_outputs(torch, "regionvit joint backward, short route", got[:5], own[:5], {0: dy})
    check_dbias(torch, "regionvit joint backward", got[5], own[5])
    check_dbias(torch, "regionvit joint backward, TPU rounding points", got[5], tpu[5])
    assert got[5].shape == (heads, n, n)
    _twice(got, kernel())


def test_regionvit_serves_and_trains_through_its_kernels(cuda):
    """RegionViT at its widths (64/128/256/512, 4 heads of 32), depth 1 a
    stage, 224 px, batch 2, served first (the position index made under
    inference mode serves training after it): a forward launches the block
    at each region self-attention (4) and the biased block at each joint
    attention (4), a train step their backwards as often, dbias at each; f32
    gradients, the position tables' of stages 1-3 among them, and a falling
    loss."""
    from vit_tpu_torch import RegionViT

    cfg = dict(num_classes=10, depth=(1, 1, 1, 1))
    g = torch.Generator(device=cuda).manual_seed(13)
    img = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    counters = (fused_attention_block, fused_attention_block_bias, fused_attention_block_backward,
                fused_attention_block_bias_backward, fused_mlp, fused_mlp_backward)

    def launches():
        return [c.launches for c in counters]

    served = cast_params(RegionViT(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(launches(), before)] == [4, 4, 0, 0, 0, 0]
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    model = RegionViT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    losses = []
    for _ in range(3):
        before = launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(launches(), before)] == [4, 4, 4, 4, 0, 0]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(getattr(model, f"transformer_{s}").local_rel_pos_bias.weight.grad.abs().max() > 0
               for s in range(3))
    assert losses[2] < losses[0]


# NesT's blocks at its three hierarchies: (groups, c, heads), 196 tokens (a
# 14 x 14 block) a group, heads of 32 (inner = c), the ChannelLayerNorm's
# eps; at 224 px and batch 64 the folds hold 1024, 256 and 64 groups, cut
# here to 64, 16 and 4.  Its conv-MLPs over the same rows, c / 4c wide.
NEST_EPS = 1e-5
NEST_BLOCKS = [(64, 96, 3), (16, 192, 6), (4, 384, 12)]


@pytest.mark.parametrize("groups,c,heads", NEST_BLOCKS)
def test_nest_block_kernels_match_plain(cuda, groups, c, heads):
    """The unbiased block at dh 32 over 196 tokens (``short_fwd``'s 208-key
    tile, ``short_bwd_wg``) at eps 1e-5: the serving and the training forward
    and the backward fed the training forward's residuals against their plain
    versions (the TPU kernel's rounding points and the short route's own),
    twice bit for bit, each on the short route; its LayerNorm backward on
    layernorm.cu's passes (96, 192 and 384 are not multiples of 256)."""
    from chip_smoke import counted_launches

    n, dh = 196, 32
    args = _attn_args(groups, n, c, heads, dh, torch.bfloat16, cuda, seed=c)
    x, gamma, _, wqkv, wo, _ = args
    scale = dh ** -0.5
    with torch.inference_mode():
        before, routes = fused_attention_block.launches, _forward_routes()
        out = fused_attention_block(*args, heads, dh, eps=NEST_EPS)
        routes["short"] += 1
        assert fused_attention_block.launches == before + 1 and _forward_routes() == routes
        _close(out, fused_attention_block_reference(*args, heads, dh, eps=NEST_EPS), x)
        _close(out, fused_attention_block_ops.fused_attention_block_short_forward_reference(
            *args, heads, dh, eps=NEST_EPS)[0], x)
        assert torch.equal(out, fused_attention_block(*args, heads, dh, eps=NEST_EPS))
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, scale, NEST_EPS,
                                                    training=True)
    check_outputs(torch, "nest block training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale, NEST_EPS),
                  {0: x})
    _, _, qkv, oattn, lse = fwd
    dy = torch.randn(groups, n, c, generator=torch.Generator(device=cuda).manual_seed(5),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale,
                                              NEST_EPS, oattn=oattn, lse=lse)

    short = fused_attention_block_ops.BACKWARD_ROUTES["short"]
    before = short.launches
    got = kernel()
    assert short.launches == before + 1
    check_outputs(torch, "nest block backward", got,
                  fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                           dh, scale, NEST_EPS), {0: dy})
    check_outputs(torch, "nest block backward, short route", got,
                  fused_attention_block_ops.fused_attention_block_lse_backward_reference(
                      dy, x, qkv, oattn, lse, gamma, wqkv, wo, heads, dh, scale, NEST_EPS),
                  {0: dy})
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == (0, 1)


# (n, d): rows 1-2 at the dense family's new shapes, batch 64, hidden 2048:
# CrossViT's two encoders (fc2 on linear.cu at d 192; the LayerNorm backward
# on layernorm.cu's passes at 192 and 384) and the patch merger's layers after
# the merger (512 rows at d 1024, the LN-backward dgrad).
DENSE_MLP_SHAPES = [(257, 192), (17, 384), (8, 1024)]


# (n, d): rows 1-2 at two of ATS-ViT@256's token counts, batch 64, hidden
# 2048: layer 2's 129 slots and layer 6's 9 (576 rows), d 1024.
ATS_MLP_SHAPES = [(129, 1024), (9, 1024)]


@pytest.mark.parametrize("n,d", DENSE_MLP_SHAPES)
def test_dense_family_mlp_kernels_match_plain(cuda, n, d):
    """The fused MLP at CrossViT's and the patch merger's shapes: the
    serving and the training forward and the backward fed the training
    forward's h against their plain versions, twice bit for bit; the
    LayerNorm backward on the dgrad's epilogue at d 1024, on the passes at
    192 and 384."""
    _check_mlp_at(cuda, n, d)


@pytest.mark.parametrize("n,d", ATS_MLP_SHAPES)
def test_ats_vit_mlp_kernels_match_plain(cuda, n, d):
    """The fused MLP at ATS-ViT's 64·129 and 64·9 rows (d 1024), as
    :func:`test_dense_family_mlp_kernels_match_plain` holds it: the
    LayerNorm backward on the dgrad's epilogue."""
    _check_mlp_at(cuda, n, d)


def _check_mlp_at(cuda, n, d):
    from chip_smoke import counted_launches

    shape, hidden, eps = (64, n, d), 2048, 1e-3
    args = _mlp_args(shape, hidden, torch.bfloat16, cuda, seed=d)
    x, gamma, beta, w1, b1, w2, b2 = args
    with torch.inference_mode():
        out = fused_mlp(*args, eps)
        _close(out, fused_mlp_reference(*args, eps), x)
        assert torch.equal(out, fused_mlp(*args, eps))
    fwd = fused_mlp_ops._launch_forward(*args, eps, save_residuals=True)
    check_outputs(torch, "dense mlp training forward", fwd,
                  fused_mlp_forward_reference(*args, eps), {0: x})
    h = fwd[2]
    dy = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(7),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_mlp_backward(dy, x, h, gamma, w1, w2, eps)

    got = kernel()
    check_outputs(torch, "dense mlp backward",
                  got, fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, eps), {0: dy})
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == ((1, 0) if d == 1024 else (0, 1))


@pytest.mark.parametrize("groups,c,heads", NEST_BLOCKS)
def test_nest_mlp_kernels_match_plain(cuda, groups, c, heads):
    """The fused MLP at NesT's widths (96 / 384, 192 / 768, 384 / 1536) over
    its blocks' rows at eps 1e-5: the serving and the training forward and
    the backward fed the training forward's h against their plain versions,
    twice bit for bit; the LayerNorm backward on layernorm.cu's passes."""
    from chip_smoke import counted_launches

    shape, hidden = (groups, 196, c), 4 * c
    args = _mlp_args(shape, hidden, torch.bfloat16, cuda, seed=c)
    x, gamma, beta, w1, b1, w2, b2 = args
    with torch.inference_mode():
        out = fused_mlp(*args, NEST_EPS)
        _close(out, fused_mlp_reference(*args, NEST_EPS), x)
        assert torch.equal(out, fused_mlp(*args, NEST_EPS))
    fwd = fused_mlp_ops._launch_forward(*args, NEST_EPS, save_residuals=True)
    check_outputs(torch, "nest mlp training forward", fwd,
                  fused_mlp_forward_reference(*args, NEST_EPS), {0: x})
    h = fwd[2]
    dy = torch.randn(shape, generator=torch.Generator(device=cuda).manual_seed(6),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_mlp_backward(dy, x, h, gamma, w1, w2, NEST_EPS)

    got = kernel()
    check_outputs(torch, "nest mlp backward",
                  got, fused_mlp_backward_reference(dy, x, h, gamma, w1, w2, NEST_EPS), {0: dy})
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == (0, 1)


def test_nest_serves_and_trains_through_its_kernels(cuda):
    """NesT at its widths (96/192/384, heads 3/6/12 of 32), block repeats
    (1, 1, 2), 224 px, batch 2: a forward launches the block (every
    attention on the short route) and the fused MLP once a transformer
    layer (4 each), a train step their backwards as often; f32 gradients,
    the three ``pos_emb`` vectors' among them, and a falling loss."""
    from vit_tpu_torch import NesT

    cfg = dict(image_size=224, patch_size=4, num_classes=10, dim=96, heads=3,
               num_hierarchies=3, block_repeats=(1, 1, 2))
    g = torch.Generator(device=cuda).manual_seed(17)
    img = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    routes = fused_attention_block_ops.FORWARD_ROUTES, fused_attention_block_ops.BACKWARD_ROUTES
    counters = (fused_attention_block, fused_mlp, fused_attention_block_backward,
                fused_mlp_backward, routes[0]["short"], routes[1]["short"])

    def launches():
        return [c.launches for c in counters]

    served = cast_params(NesT(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(launches(), before)] == [4, 4, 0, 0, 4, 0]
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    model = NesT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    losses = []
    for _ in range(3):
        before = launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(launches(), before)] == [4, 4, 4, 4, 4, 4]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    assert all(getattr(model, f"transformer_{i}").pos_emb.grad.abs().max() > 0 for i in range(3))
    assert losses[2] < losses[0]


# PiT's blocks at its three stages: (tokens, d), 16 heads of 64 (inner 1024),
# mlp 2048, eps 1e-3; batch 64 at 224 px, cut here to 4.  962 tokens take the
# block's mha route, 257 and 65 its short one.
PIT_BLOCKS = [(962, 256), (257, 512), (65, 1024)]


@pytest.mark.parametrize("n,d", PIT_BLOCKS)
def test_pit_block_kernels_match_plain(cuda, n, d):
    """The block at PiT's stage shapes: the serving and the training forward
    and the backward fed the training forward's residuals against their
    plain versions, twice bit for bit, on the route ``attention_route``
    gives (the flash kernels at 962 tokens: 15 full 64-key tiles and one of
    2); its LayerNorm backward on the dgrad's epilogue (d % 256 == 0)."""
    from chip_smoke import counted_launches

    b, heads, dh = 4, 16, 64
    route = fused_attention_block_ops.attention_route(n)
    assert route == ("mha" if n > 512 else "short")
    args = _attn_args(b, n, d, heads, dh, torch.bfloat16, cuda, seed=n)
    x, gamma, _, wqkv, wo, _ = args
    scale = dh ** -0.5
    with torch.inference_mode():
        before, routes = fused_attention_block.launches, _forward_routes()
        out = fused_attention_block(*args, heads, dh)
        routes[route] += 1
        assert fused_attention_block.launches == before + 1 and _forward_routes() == routes
        _close(out, fused_attention_block_reference(*args, heads, dh), x)
        assert torch.equal(out, fused_attention_block(*args, heads, dh))
    fwd = fused_attention_block_ops._launch_forward(*args, heads, dh, scale, 1e-3, training=True)
    check_outputs(torch, "pit block training forward", fwd[:4],
                  fused_attention_block_forward_reference(*args, heads, dh, scale), {0: x})
    _, _, qkv, oattn, lse = fwd
    dy = torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda).to(torch.bfloat16)

    def kernel():
        return fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale,
                                              oattn=oattn, lse=lse)

    counter = fused_attention_block_ops.BACKWARD_ROUTES[route]
    before = counter.launches
    got = kernel()
    assert counter.launches == before + 1
    check_outputs(torch, "pit block backward", got,
                  fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads,
                                                           dh, scale), {0: dy})
    _twice(got, kernel())
    counts = counted_launches(torch, kernel)
    assert (counts["ln_epilogue"], counts["ln_passes"]) == (1, 0)


def test_pit_serves_and_trains_through_its_kernels(cuda):
    """PiT at its widths (256/512/1024, 16 heads of 64, mlp 2048), depth (1,
    1, 1), 224 px, batch 2: a forward launches the block and the fused MLP
    once a stage (3 each; stage 1's 962 tokens on the mha route, the others
    on the short one), a train step their backwards as often; f32 gradients,
    the position embedding's, the cls token's and the pools' among them, and
    a falling loss."""
    from vit_tpu_torch import PiT

    cfg = dict(image_size=224, patch_size=14, num_classes=10, dim=256, depth=(1, 1, 1),
               heads=16, mlp_dim=2048)
    g = torch.Generator(device=cuda).manual_seed(19)
    img = torch.randn(2, 224, 224, 3, generator=g, device=cuda)
    routes = fused_attention_block_ops.FORWARD_ROUTES, fused_attention_block_ops.BACKWARD_ROUTES
    counters = (fused_attention_block, fused_mlp, fused_attention_block_backward,
                fused_mlp_backward, routes[0]["mha"], routes[0]["short"], routes[1]["mha"],
                routes[1]["short"])

    def launches():
        return [c.launches for c in counters]

    served = cast_params(PiT(**cfg, generator=g), torch.bfloat16).eval()
    before = launches()
    with torch.inference_mode():
        out = served(img)
    assert [a - b for a, b in zip(launches(), before)] == [3, 3, 0, 0, 1, 2, 0, 0]
    assert out.shape == (2, 10) and torch.isfinite(out).all()
    model = PiT(**cfg, compute_dtype=torch.bfloat16, generator=g)
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=1e-3))
    labels = torch.tensor([1, 2], device=cuda)
    losses = []
    for _ in range(3):
        before = launches()
        losses.append(float(step(img, labels)["loss"]))
        assert [a - b for a, b in zip(launches(), before)] == [3, 3, 3, 3, 1, 2, 1, 2]
    assert all(p.grad.dtype == torch.float32 for p in model.parameters())
    for p in (model.pos_embedding, model.cls_token, model.pool_0.downsample_grouped.weight,
              model.pool_1.cls_ff.weight):
        assert p.grad.abs().max() > 0
    assert losses[2] < losses[0]


# ---- the serving kernel ops as registered ops (torch.export) ---------------------------------

from torch_op_cases import NAMES as OP_NAMES, case as op_case, fake_output  # noqa: E402
from vit_tpu_torch.interop.export import export_forward, load_forward, model_params  # noqa: E402


@pytest.mark.parametrize("name", OP_NAMES)
def test_serving_op_is_the_direct_launch(cuda, name):
    """Each registered op gives exactly its launcher's output on the card,
    and its fake implementation the kernel output's shape, dtype, strides
    and device (what an exported program's graph records)."""
    c = op_case(name, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        got = c.entry(*c.args, **c.kwargs)
        want = c.direct(*c.args, **c.kwargs)
    assert torch.equal(got, want)
    fake = fake_output(c.op, c.op_args)
    assert (fake.shape, fake.dtype, fake.stride(), fake.device) == \
        (got.shape, got.dtype, got.stride(), got.device)


@pytest.mark.parametrize("bake", [False, True])
def test_export_round_trip_on_the_card(cuda, bake):
    """A bf16 ViT's artifact holds the block ops, gives the eager model's
    output bit for bit, and launches the kernels as often (2 layers: rows 1
    and 3 twice each)."""
    torch.manual_seed(0)
    model = ViT(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2,
                mlp_dim=128, dim_head=32, compute_dtype=torch.bfloat16)
    img = torch.randn(4, 32, 32, 3, device=cuda)
    served = load_forward(export_forward(model, img.shape, bake_params=bake))
    counters = (fused_attention_block, fused_mlp)
    with torch.no_grad():
        for c in counters:
            c.launches = 0
        want = model.eval()(img)
        eager = [c.launches for c in counters]
        for c in counters:
            c.launches = 0
        got = served(img) if bake else served(model_params(model), img)
    assert eager == [2, 2] and [c.launches for c in counters] == eager
    assert torch.equal(got, want)


# ---- tensor parallelism: rows 1-4's split forms --------------------------------

# (b, n, d, heads, dim_head, hidden) of the whole block, split over two ranks:
# the short route with every GEMM on gemm_wgmma (n >= 256), the mha route past
# 512 tokens with the out-projection's and fc2's f32 partials on linear.cu (d 64).
SPLIT_SHAPES = [(4, 65, 256, 8, 32, 512), (2, 577, 64, 2, 32, 128)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_blocks_match_plain_and_unsplit(cuda, shape):
    """Each rank's split forward and backward of both blocks against their
    plain versions, twice bit for bit; the two ranks' partials summed, then
    the pass (forward) or the LayerNorm backward (backward), against the
    unsplit kernels' y, dx and sums."""
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.parallel.sharding import COLUMN, QKV, ROW, shard_tensor

    b, n, d, heads, dh, hidden = shape
    t, dt, scale = 2, torch.bfloat16, dh ** -0.5
    x, gamma, beta, wqkv, wo, bo = _attn_args(b, n, d, heads, dh, dt, cuda, seed=7)
    _, _, _, w1, b1, w2, b2 = _mlp_args((b, n, d), hidden, dt, cuda, seed=8)
    dy = (torch.randn(b, n, d, generator=torch.Generator(device=cuda).manual_seed(9),
                      device=cuda) * 0.1).to(dt)
    fab, fm = fused_attention_block_ops, fused_mlp_ops
    attn_parts, mlp_parts = [], []
    for r in range(t):
        wq, wp = shard_tensor(wqkv, QKV, r, t), shard_tensor(wo, ROW, r, t)
        fwd = fab.fused_attention_block_partial_forward(x, gamma, beta, wq, wp, heads // t, dh,
                                                        scale, training=True)
        _twice(fwd, fab.fused_attention_block_partial_forward(x, gamma, beta, wq, wp, heads // t,
                                                              dh, scale, training=True))
        ref = fab.fused_attention_block_partial_forward_reference(x, gamma, beta, wq, wp,
                                                                  heads // t, dh, scale)
        check_outputs(torch, "split attention forward", fwd[:4], ref[:4], {})
        lse = fused_attention_block_ops.attention_lse_reference(fwd[2], heads // t, dh, scale)
        assert (fwd[4] - lse).abs().max().item() <= LSE_ABS_TOL  # on the kernel's own qkv
        bwd = fab.fused_attention_block_partial_backward(dy, *fwd[2:], wq, wp, heads // t, dh,
                                                         scale)
        _twice(bwd, fab.fused_attention_block_partial_backward(dy, *fwd[2:], wq, wp, heads // t,
                                                               dh, scale))
        check_outputs(torch, "split attention backward", bwd,
                      fab.fused_attention_block_partial_backward_reference(
                          dy, *fwd[2:], wq, wp, heads // t, dh, scale), {})
        attn_parts.append((fwd[0], bwd[0]))

        m1, c1, m2 = (shard_tensor(w1, COLUMN, r, t), shard_tensor(b1, COLUMN, r, t),
                      shard_tensor(w2, ROW, r, t))
        fwd = fm.fused_mlp_partial_forward(x, gamma, beta, m1, c1, m2, training=True)
        _twice(fwd, fm.fused_mlp_partial_forward(x, gamma, beta, m1, c1, m2, training=True))
        check_outputs(torch, "split MLP forward", fwd,
                      fm.fused_mlp_partial_forward_reference(x, gamma, beta, m1, c1, m2), {})
        bwd = fm.fused_mlp_partial_backward(dy, fwd[2], m1, m2)
        _twice(bwd, fm.fused_mlp_partial_backward(dy, fwd[2], m1, m2))
        ref = fm.fused_mlp_partial_backward_reference(dy, fwd[2], m1, m2)
        check_outputs(torch, "split MLP backward", bwd[:3], ref[:3], {})
        check_dbias(torch, "split MLP backward", bwd[3], ref[3], "db1")
        mlp_parts.append((fwd[0], bwd[0]))

    y, _, qkv, oattn, lse = fab._launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dh, scale,
                                                1e-3, training=True)
    check_outputs(torch, "two ranks' attention block",
                  [tp.bias_residual(attn_parts[0][0] + attn_parts[1][0], bo, x)], [y], {0: x})
    full = fab.fused_attention_block_backward(dy, x, qkv, gamma, wqkv, wo, heads, dh, scale,
                                              oattn=oattn, lse=lse)
    got = tp.ln_backward(x, attn_parts[0][1] + attn_parts[1][1], gamma, dy)
    check_outputs(torch, "two ranks' attention backward", got[:1], full[:1], {0: dy})
    for i, j in ((1, 2), (2, 3), (3, 4)):
        check_dbias(torch, "two ranks' attention backward", got[i], full[j], f"sum {i}")
    y, _, h = fm._launch_forward(x, gamma, beta, w1, b1, w2, b2, 1e-3, save_residuals=True)
    check_outputs(torch, "two ranks' MLP",
                  [tp.bias_residual(mlp_parts[0][0] + mlp_parts[1][0], b2, x)], [y], {0: x})
    full = fm.fused_mlp_backward(dy, x, h, gamma, w1, w2)
    got = tp.ln_backward(x, mlp_parts[0][1] + mlp_parts[1][1], gamma, dy)
    check_outputs(torch, "two ranks' MLP backward", got[:1], full[:1], {0: dy})
    for i, j in ((1, 3), (2, 4), (3, 6)):
        check_dbias(torch, "two ranks' MLP backward", got[i], full[j], f"sum {i}")


# Row 5's split form: (b, n, d, heads, dim_head, bias kind), the short route
# (CrossFormer's 49-token windows with the shared table, RegionViT's 50-token
# joint rows with the per-head one, LSA's mask at 65) and the mha route at 577.
SPLIT_BIASED = [(4, 49, 64, 2, 32, "shared"), (4, 50, 64, 4, 32, "per-head"),
                (2, 65, 256, 8, 32, "lsa"), (2, 577, 64, 2, 32, "per-head")]


@pytest.mark.parametrize("shape", SPLIT_BIASED)
def test_split_biased_block_matches_plain_and_unsplit(cuda, shape):
    """Each rank's split biased forward and backward against their plain
    versions, twice bit for bit, dbias within check_dbias; the two ranks'
    partials summed, then the pass or the LayerNorm backward, against the
    unsplit biased kernels' y, dx, sums and dbias (summed for a shared
    bias, joined for a per-head one)."""
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.parallel.sharding import QKV, ROW, shard_tensor

    b, n, d, heads, dh, kind = shape
    t, dt, hl = 2, torch.bfloat16, heads // 2
    scale = 1.0 if kind == "lsa" else dh ** -0.5
    need = kind != "lsa"
    x, gamma, beta, wqkv, wo, bo = _attn_args(b, n, d, heads, dh, dt, cuda, seed=n)
    g = torch.Generator(device=cuda).manual_seed(n + 1)
    dy = (torch.randn(b, n, d, generator=g, device=cuda) * 0.1).to(dt)
    bias = vit_for_small_dataset.lsa_bias(n, cuda) if kind == "lsa" else \
        torch.randn(heads if kind == "per-head" else 1, n, n, generator=g, device=cuda) * 0.5
    fab = fused_attention_block_ops
    parts = []
    for r in range(t):
        wq, wp = shard_tensor(wqkv, QKV, r, t), shard_tensor(wo, ROW, r, t)
        br = bias[r * hl:(r + 1) * hl].contiguous() if kind == "per-head" else bias
        before = fab.fused_attention_block_bias_partial_forward.launches
        fwd = fab.fused_attention_block_bias_partial_forward(x, gamma, beta, wq, wp, br, hl, dh,
                                                             scale, training=True)
        assert fab.fused_attention_block_bias_partial_forward.launches == before + 1
        _twice(fwd, fab.fused_attention_block_bias_partial_forward(x, gamma, beta, wq, wp, br,
                                                                   hl, dh, scale, training=True))
        check_outputs(torch, "split biased forward", fwd[:4],
                      fab.fused_attention_block_partial_forward_reference(
                          x, gamma, beta, wq, wp, hl, dh, scale, bias=br)[:4], {})
        lse = fab.attention_lse_reference(fwd[2], hl, dh, scale, br)
        assert (fwd[4] - lse).abs().max().item() <= LSE_ABS_TOL  # on the kernel's own qkv
        bwd = fab.fused_attention_block_bias_partial_backward(dy, *fwd[2:], wq, wp, br, hl, dh,
                                                              scale, need)
        again = fab.fused_attention_block_bias_partial_backward(dy, *fwd[2:], wq, wp, br, hl,
                                                                dh, scale, need)
        _twice(bwd[:3], again[:3])
        ref = fab.fused_attention_block_partial_backward_reference(dy, *fwd[2:], wq, wp, hl, dh,
                                                                   scale, br, need)
        check_outputs(torch, "split biased backward", bwd[:3], ref[:3], {})
        if need:
            assert torch.equal(bwd[3], again[3])
            check_dbias(torch, "split biased backward", bwd[3], ref[3])
        else:
            assert bwd[3] is None
        parts.append((fwd[0], bwd[0], bwd[3]))

    y, _, qkv, oattn, lse = fab._launch_forward(x, gamma, beta, wqkv, wo, bo, heads, dh, scale,
                                                1e-3, bias, training=True)
    check_outputs(torch, "two ranks' biased block",
                  [tp.bias_residual(parts[0][0] + parts[1][0], bo, x)], [y], {0: x})
    full = fab.fused_attention_block_bias_backward(dy, x, qkv, gamma, wqkv, wo, bias, heads, dh,
                                                   scale, need_dbias=need, oattn=oattn, lse=lse)
    got = tp.ln_backward(x, parts[0][1] + parts[1][1], gamma, dy)
    check_outputs(torch, "two ranks' biased backward", got[:1], full[:1], {0: dy})
    for i, j in ((1, 2), (2, 3), (3, 4)):
        check_dbias(torch, "two ranks' biased backward", got[i], full[j], f"sum {i}")
    if need:
        pieces = [p[2] for p in parts]
        dbias = torch.cat(pieces) if kind == "per-head" else pieces[0] + pieces[1]
        check_dbias(torch, "two ranks' biased backward", dbias, full[5])


@pytest.mark.parametrize("rows, d", [(8320, 1024), (1000, 72)])
def test_bias_residual_and_ln_backward_match_plain(cuda, rows, d):
    """The pass that ends a split forward and the LayerNorm backward that
    ends a split backward, against their plain versions, twice bit for
    bit, counted."""
    from vit_tpu_torch.ops import tensor_parallel as tp

    g = torch.Generator(device=cuda).manual_seed(rows + d)

    def rn(*s, scale=1.0):
        return torch.randn(*s, generator=g, device=cuda) * scale

    x, dy = rn(rows, d).to(torch.bfloat16), (rn(rows, d) * 0.1).to(torch.bfloat16)
    s, bias, gamma, dxn = rn(rows, d), rn(d).to(torch.bfloat16), \
        (1.0 + rn(d, scale=0.1)).to(torch.bfloat16), rn(rows, d, scale=0.1)
    before = (tp.bias_residual.launches, tp.ln_backward.launches)
    y = tp.bias_residual(s, bias, x)
    _twice([y], [tp.bias_residual(s, bias, x)])
    check_outputs(torch, "bias_residual", [y], [tp.bias_residual_reference(s, bias, x)], {0: x})
    got = tp.ln_backward(x, dxn, gamma, dy)
    _twice(got, tp.ln_backward(x, dxn, gamma, dy))
    ref = tp.ln_backward_residual_reference(x, dxn, gamma, dy)
    check_outputs(torch, "ln_backward", got[:1], ref[:1], {0: dy})
    for i in (1, 2, 3):
        check_dbias(torch, "ln_backward", got[i], ref[i], f"sum {i}")
    assert (tp.bias_residual.launches, tp.ln_backward.launches) == (before[0] + 2,
                                                                    before[1] + 2)


# ---- tensor parallelism: row 6's split form -------------------------------------

# (b, n, n_k, c, heads, dh_k, dh_v) of the whole block, split over two ranks:
# Twins-SVT's c 64 at a ragged 197 tokens over 16 keys (cross_fwd writing oattn,
# the f32-partial GEMM on linear.cu; the backward on route 2), and 144 keys at c
# 256 (the three launches forward, the four steps backward, the GEMM on
# gemm_wgmma); ScalableViT's SSA widths (40, 32) over 64 keys at stage 1's c 64
# (one head a rank) and stage 3's c 256 (four a rank).
SPLIT_CROSS_SHAPES = [(4, 197, 16, 64, 8, 64, 64), (2, 196, 144, 256, 4, 64, 64),
                      (4, 1024, 64, 64, 2, 40, 32), (2, 256, 64, 256, 8, 40, 32)]


@pytest.mark.parametrize("shape", SPLIT_CROSS_SHAPES)
def test_split_cross_attention_matches_plain_and_unsplit(cuda, shape):
    """Each rank's split forward and backward of row 6 against their plain
    versions, twice bit for bit, counted; the two ranks' partials summed,
    then the pass (forward) or one rounding (dxn), against the unsplit
    kernels' y, dxn and dbo."""
    from vit_tpu_torch.ops import tensor_parallel as tp
    from vit_tpu_torch.ops.flash_attention_packed import flash_attention_packed_forward_reference
    from vit_tpu_torch.parallel.sharding import COLUMN, ROW, shard_tensor

    b, n, n_k, c, heads, dh_k, dh_v = shape
    t, dt, scale, hk, hv = 2, torch.bfloat16, dh_k ** -0.5, heads * dh_k, heads * dh_v
    widths = (dh_k, dh_v, scale)
    g = torch.Generator(device=cuda).manual_seed(n_k + c)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=g, device=cuda) * scale).to(dt)

    x, xn, dy = rn(b, n, c), rn(b, n, c), rn(b, n, c, scale=0.1)
    wq, wo, bo = rn(hk, c, scale=c ** -0.5), rn(c, hv, scale=hv ** -0.5), rn(c, scale=0.1)
    k, v = rn(b, n_k, hk), rn(b, n_k, hv)
    stored_d = fca.partial_backward_route(b, n, n_k, c, heads // t, dh_k, dh_v) == 0
    counts = (fca.fused_cross_attention_partial_forward.launches,
              fca.fused_cross_attention_partial_backward.launches)
    parts = []
    for r in range(t):
        kc, vc = slice(r * hk // t, (r + 1) * hk // t), slice(r * hv // t, (r + 1) * hv // t)
        w = (shard_tensor(wq, COLUMN, r, t), k[..., kc].contiguous(),
             v[..., vc].contiguous(), shard_tensor(wo, ROW, r, t))
        fwd = fca.fused_cross_attention_partial_forward(xn, *w, heads // t, *widths,
                                                        training=True)
        _twice(fwd, fca.fused_cross_attention_partial_forward(xn, *w, heads // t, *widths,
                                                              training=True))
        ref = fca.fused_cross_attention_partial_forward_reference(xn, *w, heads // t, *widths)
        check_outputs(torch, "split cross-attention forward", fwd[:3], ref[:3], {})
        lse = flash_attention_packed_forward_reference(fwd[1], w[1], w[2], heads // t, scale)[1]
        assert (fwd[3] - lse).abs().max().item() <= LSE_ABS_TOL  # on the kernel's own q
        bwd = fca.fused_cross_attention_partial_backward(dy, fwd[1], w[1], w[2], fwd[2], fwd[3],
                                                         w[0], w[3], heads // t, *widths)
        _twice(bwd, fca.fused_cross_attention_partial_backward(
            dy, fwd[1], w[1], w[2], fwd[2], fwd[3], w[0], w[3], heads // t, *widths))
        ref = fca.fused_cross_attention_partial_backward_reference(
            dy, fwd[1], w[1], w[2], fwd[2], fwd[3], w[0], w[3], heads // t, *widths,
            stored_output_d=stored_d)
        assert bwd[0].dtype == torch.float32
        check_outputs(torch, "split cross-attention backward", bwd[:4], ref[:4], {})
        check_dbias(torch, "split cross-attention backward", bwd[4], ref[4], "dbo")
        parts.append((fwd[0], bwd[0], bwd[4]))
    assert (fca.fused_cross_attention_partial_forward.launches,
            fca.fused_cross_attention_partial_backward.launches) == (counts[0] + 2 * t,
                                                                     counts[1] + 2 * t)
    y, q, oattn, lse = fca._launch_forward(x, xn, wq, k, v, wo, bo, heads, *widths,
                                           training=True)
    check_outputs(torch, "two ranks' cross-attention",
                  [tp.bias_residual(parts[0][0] + parts[1][0], bo, x)], [y], {0: x})
    full = fca.fused_cross_attention_backward(dy, q, k, v, oattn, lse, wq, wo, heads, *widths)
    check_outputs(torch, "two ranks' cross-attention backward",
                  [(parts[0][1] + parts[1][1]).to(dt)], [full[0]], {})
    assert torch.equal(parts[0][2], parts[1][2])
    check_dbias(torch, "two ranks' cross-attention backward", parts[0][2], full[4], "dbo")


# ---- tensor parallelism: row 10 over a rank's heads -------------------------------

# (b, n, heads) of ScalableViT's IWSA windows at (32, 32), split over two ranks:
# stage 1's 4096 tokens (one head a rank) and stage 2's 1024 (two a rank).
SPLIT_PACKED_SHAPES = [(4, 4096, 2), (4, 1024, 4)]


@pytest.mark.parametrize("b,n,heads", SPLIT_PACKED_SHAPES)
def test_packed_flash_over_local_heads_matches_plain_and_unsplit(cuda, b, n, heads):
    """The packed op under autograd on each rank's contiguous columns (its
    heads of q, k, v and the cotangent, as IWSA's split convolutions give
    them) against its plain version, twice bit for bit, one launch each way;
    the two ranks' outputs and gradients concatenated against the unsplit op
    at every head."""
    t, d = 2, 32
    hl = heads // t
    q, k, v, do = _packed_inputs(cuda, b, n, n, heads, d, d, seed=n + heads)

    def run(tensors, h):
        leaves = [x.detach().requires_grad_() for x in tensors[:3]]
        out = fap.flash_attention_packed(*leaves, h)
        return out.detach(), torch.autograd.grad(out, leaves, tensors[3])

    outs, grads = [], []
    for r in range(t):
        part = [x[..., r * hl * d:(r + 1) * hl * d].contiguous() for x in (q, k, v, do)]
        before = (fap.flash_attention_packed.launches, flash_backward.launches)
        out, g = run(part, hl)
        torch.cuda.synchronize()
        assert (fap.flash_attention_packed.launches, flash_backward.launches) == (
            before[0] + 1, before[1] + 1)
        again = run(part, hl)
        assert torch.equal(out, again[0]) and all(torch.equal(a, b_) for a, b_ in zip(g, again[1]))
        ref_out, ref_lse = fap.flash_attention_packed_forward_reference(*part[:3], hl)
        check_outputs(torch, "split packed forward", (out,), (ref_out,), {})
        _, lse = fap.flash_attention_packed_forward(*part[:3], hl)
        assert (lse - ref_lse).abs().max().item() <= LSE_ABS_TOL
        check_outputs(torch, "split packed backward", g,
                      fap.flash_attention_packed_backward_reference(*part[:3], out, lse, part[3],
                                                                    hl), {})
        outs.append(out)
        grads.append(g)
    full_out, full_grads = run((q, k, v, do), heads)
    check_outputs(torch, "two ranks' packed forward", (torch.cat(outs, -1),), (full_out,), {})
    check_outputs(torch, "two ranks' packed backward",
                  [torch.cat([g[i] for g in grads], -1) for i in range(3)], full_grads, {})
