"""The port as a package, on the CPU: no JAX inside it, the TPU-only modes
refused, the kernel wrappers taking their plain versions for CPU tensors, and
the build module importable without nvcc.  No JAX is needed here."""

import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vit_tpu_torch import ViT, cast_params
from vit_tpu_torch.layers.common import (
    MLP, Attention, LayerNorm, Transformer, fused_mlp_residual,
)
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.fused_attention_block import (
    fused_attention_block, fused_attention_block_reference,
    fused_attention_block_supported,
)
from vit_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference, fused_mlp_supported

REPO = Path(__file__).resolve().parents[1]
PACKAGE = REPO / "vit_tpu_torch"
TINY = dict(image_size=16, patch_size=4, num_classes=5, dim=32, depth=2, heads=2,
            dim_head=16, mlp_dim=64, device="cpu")


def test_import_leaves_jax_out():
    code = ("import sys, vit_tpu_torch, vit_tpu_torch.ops._build; "
            "bad = [m for m in ('jax', 'flax') if m in sys.modules]; "
            "sys.exit(f'imported {bad}' if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr + proc.stdout


def test_sources_never_import_jax():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax)\b", re.M)
    offenders = [str(p.relative_to(REPO)) for p in PACKAGE.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders


@pytest.mark.parametrize("knob", ["fused_attention", "fused_mlp"])
@pytest.mark.parametrize("mode", ["interpret", "hybrid", "bmajor"])
def test_tpu_only_modes_raise(knob, mode):
    with pytest.raises(ValueError, match="TPU-only"):
        ViT(**TINY, **{knob: mode})


def test_unknown_mode_and_scan_layers_raise():
    with pytest.raises(ValueError, match="must be one of"):
        Transformer(32, 1, 2, 16, 64, fused_mlp="sometimes", device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        ViT(**TINY, scan_layers=True)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(NotImplementedError, match="flash"):
        scaled_dot_product_attention(q, q, q, use_flash="force")


def _block_weights(d=32, heads=2, dh=16, hidden=64, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dtype)

    norm = (1 + rn(d, scale=0.1), rn(d, scale=0.1))
    mlp = (rn(hidden, d, scale=d ** -0.5), rn(hidden, scale=0.1),
           rn(d, hidden, scale=hidden ** -0.5), rn(d, scale=0.1))
    attn = (rn(3 * heads * dh, d, scale=d ** -0.5), rn(d, heads * dh, scale=0.2),
            rn(d, scale=0.1))
    return rn(3, 11, d), norm, mlp, attn


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrappers_take_the_plain_version_on_cpu(dtype):
    x, norm, mlp, attn = _block_weights(dtype=dtype)
    counts = (fused_mlp.launches, fused_attention_block.launches)
    y_mlp = fused_mlp(x, *norm, *mlp)
    y_attn = fused_attention_block(x, *norm, *attn, 2, 16)
    assert (fused_mlp.launches, fused_attention_block.launches) == counts
    assert torch.equal(y_mlp, fused_mlp_reference(x, *norm, *mlp))
    assert torch.equal(y_attn, fused_attention_block_reference(x, *norm, *attn, 2, 16))
    assert y_mlp.dtype == y_attn.dtype == dtype


def test_plain_versions_match_the_modules():
    """The kernels' plain versions compute what the unfused modules compute
    (f32: same math, different association of the GEMM sums)."""
    x, (gamma, beta), mlp_w, attn_w = _block_weights()
    cpu = torch.device("cpu")
    ln, mlp, attn = (LayerNorm(32, device=cpu), MLP(32, 64, device=cpu),
                     Attention(32, 2, 16, device=cpu))
    with torch.no_grad():
        ln.weight.copy_(gamma)
        ln.bias.copy_(beta)
        for p, w in zip((mlp.fc1.weight, mlp.fc1.bias, mlp.fc2.weight, mlp.fc2.bias), mlp_w):
            p.copy_(w)
        for p, w in zip((attn.to_qkv.weight, attn.to_out[0].weight, attn.to_out[0].bias),
                        attn_w):
            p.copy_(w)
        assert torch.allclose(fused_mlp_reference(x, gamma, beta, *mlp_w),
                              x + mlp(ln(x)), atol=1e-5, rtol=0)
        assert torch.allclose(fused_attention_block_reference(x, gamma, beta, *attn_w, 2, 16),
                              x + attn(ln(x)), atol=1e-5, rtol=0)
        assert torch.equal(fused_mlp_residual(x, ln, mlp, "auto"), x + mlp(ln(x)))


def test_auto_dispatch_takes_the_plain_path_on_cpu():
    g = torch.Generator().manual_seed(0)
    auto = cast_params(ViT(**TINY, generator=g), torch.bfloat16).eval()
    never = ViT(**TINY, fused_attention="never", fused_mlp="never",
                dtype=torch.bfloat16).eval()
    never.load_state_dict(auto.state_dict())
    img = torch.randn(2, 16, 16, 3, generator=g)
    counts = (fused_mlp.launches, fused_attention_block.launches)
    with torch.inference_mode():
        out = auto(img)
        assert torch.equal(out, never(img))
    assert (fused_mlp.launches, fused_attention_block.launches) == counts
    assert out.dtype == torch.bfloat16 and out.shape == (2, 5)


def test_kernel_width_limits():
    assert fused_mlp_supported(768, 3072) and not fused_mlp_supported(27, 64)
    assert fused_attention_block_supported(768, 12, 64)
    assert fused_attention_block_supported(96, 3, 32)
    assert not fused_attention_block_supported(96, 2, 48)
    assert not fused_attention_block_supported(100, 2, 64)


def test_cast_params_and_seeded_init():
    a = ViT(**TINY, generator=torch.Generator().manual_seed(7))
    b = ViT(**TINY, generator=torch.Generator().manual_seed(7))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    sd = a.state_dict()
    assert torch.count_nonzero(sd["transformer.layers.0.mlp.fc1.bias"]) == 0
    limit = (6 / (32 + 64)) ** 0.5  # glorot-uniform bound of fc1 (32 -> 64)
    assert sd["transformer.layers.0.mlp.fc1.weight"].abs().max() <= limit
    cast_params(a, torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in a.parameters())


def test_build_module_needs_no_nvcc(tmp_path, monkeypatch):
    assert [p.name for p in _build.sources()] == sorted(
        p.name for p in (PACKAGE / "csrc").glob("*.cu"))
    assert re.fullmatch(r"[0-9a-f]{16}", _build.source_hash())
    monkeypatch.setenv("VIT_TPU_TORCH_BUILD_DIR", str(tmp_path))
    assert _build.library_path().parent == tmp_path
    assert _build.library_path().name.endswith(f"{_build.source_hash()}.so")
    # Every entry point is declared with pointer-wide arguments for pointers;
    # the others take only integers (an error code, a row count, shapes).
    for name, (argtypes, _) in _build.SIGNATURES.items():
        assert name.startswith("vit_")
        assert ctypes.c_void_p in argtypes or set(argtypes) == {ctypes.c_int}
    if not _build.shutil.which("nvcc") and not os.environ.get("CUDA_HOME") \
            and not Path("/usr/local/cuda/bin/nvcc").is_file():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.find_nvcc()
