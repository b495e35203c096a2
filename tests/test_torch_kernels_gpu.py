"""Hand-written CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: each test skips (from a fixture) where there is no CUDA device.
On a machine with a card and without JAX, run with
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py``.

Tolerance: ``chip_smoke.block_error``.  Both sides take the same bf16/f16
inputs and round at the same points; they differ by f32 summation order, which
can flip a rounding of an intermediate (xn, qkv, P, the attention output,
gelu(h)) by one unit.  Each block returns ``T(x + T(f(x)))``, so an element may
differ by one unit of the output (the final add's rounding) plus
``2e-2 · max|ref - x|``, a few units of the block's own output; the residual
x ~ N(0, 1) does not widen the bound.
"""

import pytest
import torch

from chip_smoke import block_error
from vit_tpu_torch import ViT, cast_params
from vit_tpu_torch.ops.fused_attention_block import (
    fused_attention_block, fused_attention_block_reference,
)
from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference

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


def test_kernels_refuse_what_they_do_not_take(cuda):
    x, *rest = _attn_args(2, 9, 96, 2, 48, torch.bfloat16, cuda)
    with torch.inference_mode(), pytest.raises(ValueError):
        fused_attention_block(x, *rest, 2, 48)  # dim_head 48 has no instance
    args = _mlp_args((2, 9, 64), 128, torch.float32, cuda)
    with torch.inference_mode(), pytest.raises(TypeError):
        fused_mlp(*args)  # f32 has no kernel
    args = _mlp_args((2, 9, 64), 128, torch.bfloat16, cuda)
    args[3].requires_grad_(True)
    with pytest.raises(NotImplementedError):
        fused_mlp(*args)  # no backward kernel yet


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


def test_auto_raises_instead_of_running_plain(cuda):
    """An eval-mode 16-bit CUDA model never swaps in the plain modules: a
    head width without a kernel instance, or a call that autograd would have
    to differentiate, raises."""
    model, img = _tiny_vit(cuda, dim_head=48)
    with torch.inference_mode(), pytest.raises(ValueError, match="dim_head"):
        model(img)
    model, img = _tiny_vit(cuda, dim_head=32)
    with pytest.raises(NotImplementedError, match="no backward"):
        model(img)  # grad mode on, parameters require grad
    counts = (fused_attention_block.launches, fused_mlp.launches)
    with torch.no_grad():
        model.train()(img)  # training keeps the plain modules
    assert (fused_attention_block.launches, fused_mlp.launches) == counts
