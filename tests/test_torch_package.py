"""The port as a package, on the CPU: no JAX inside it, the TPU-only modes
refused, the kernel wrappers taking their plain versions for CPU tensors, and
the build module importable without nvcc.  No JAX is needed here."""

import ast
import ctypes
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch import nn

import vit_tpu_torch
from vit_tpu_torch import ScalableViT, ViT, cast_params
from vit_tpu_torch.core.helpers import cast_tuple
from vit_tpu_torch.layers.common import (
    MLP, Attention, LayerNorm, Transformer, fused_mlp_residual,
)
from vit_tpu_torch.models import efficient
from vit_tpu_torch.ops import _build
from vit_tpu_torch.ops.attention import scaled_dot_product_attention
from vit_tpu_torch.ops.fused_attention_block import (
    fused_attention_block, fused_attention_block_reference,
    fused_attention_block_supported,
)
from vit_tpu_torch.ops.flash_attention_packed import (
    flash_attention_packed, flash_attention_packed_forward_reference,
)
from vit_tpu_torch.ops.fused_cross_attention import (
    fused_cross_attention, fused_cross_attention_reference,
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


@pytest.mark.parametrize("knob,mode", [
    ("fused_attention", "interpret"), ("fused_attention", "bmajor"),
    ("fused_mlp", "interpret"), ("fused_mlp", "hybrid"), ("fused_mlp", "bmajor"),
])
def test_tpu_only_modes_raise(knob, mode):
    with pytest.raises(ValueError, match="TPU-only"):
        ViT(**TINY, **{knob: mode})


def test_hybrid_is_the_vit_attention_tier_only():
    """``fused_attention="hybrid"`` builds a ViT (the short-sequence tier, as
    ``vit_tpu``'s); as ``fused_mlp``, or on another model's attention, it
    stays a TPU-only mode."""
    model = ViT(**TINY, fused_attention="hybrid")
    assert model.transformer.fused_attention == "hybrid"
    with pytest.raises(ValueError, match="TPU-only"):
        ViT(**TINY, fused_mlp="hybrid")
    with pytest.raises(ValueError, match="TPU-only"):
        ScalableViT(num_classes=5, dim=16, depth=(1,), heads=2, reduction_factor=2,
                    fused_attention="hybrid", device="cpu")


def test_unknown_mode_and_scan_layers_raise():
    with pytest.raises(ValueError, match="must be one of"):
        Transformer(32, 1, 2, 16, 64, fused_mlp="sometimes", device="cpu")
    with pytest.raises(ValueError, match="scan_layers"):
        ViT(**TINY, scan_layers=True)
    q = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="flash"):
        scaled_dot_product_attention(q, q, q, bias=torch.zeros(1, 1, 4, 4), use_flash="force")
    with pytest.raises(ValueError, match="use_flash"):
        scaled_dot_product_attention(q, q, q, use_flash="sometimes")


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
    # widths off 8 (T2T-ViT's 147 and 1323, 27) run at zero-padded widths
    assert fused_mlp_supported(768, 3072) and fused_mlp_supported(27, 64)
    assert fused_mlp_supported(147, 147) and not fused_mlp_supported(0, 64)
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


def vit_tpu_all(module: str) -> list:
    """``__all__`` of a ``vit_tpu`` module, read from its source (a literal
    list) without importing JAX."""
    tree = ast.parse((REPO / module.replace(".", "/") / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and [t.id for t in node.targets] == ["__all__"]:
            return ast.literal_eval(node.value)
    raise AssertionError(f"{module} has no __all__")


JAX_ONLY = {"bind", "BoundModel", "enable_compile_cache"}  # Flax binding, XLA compile cache


def test_package_exports():
    """Every name of ``vit_tpu.__all__`` but the three JAX-only ones, then
    the port's own: the converter and the modules whose model class is
    named ``ViT``."""
    names = set(vit_tpu_all("vit_tpu"))
    assert JAX_ONLY <= names
    assert sorted(vit_tpu_torch.__all__) == sorted(
        (names - JAX_ONLY) | {"state_dict_from_flax", "ats_vit", "parallel_vit",
                              "vit_for_small_dataset", "vit_with_patch_merger"})
    assert len(vit_tpu_torch.__all__) == len(set(vit_tpu_torch.__all__))
    assert all(hasattr(vit_tpu_torch, name) for name in vit_tpu_torch.__all__)
    assert cast_tuple(3, 4) == (3, 3, 3, 3) and cast_tuple((1, 2), 4) == (1, 2)


def test_models_package_mirrors_vit_tpu_models():
    """``vit_tpu_torch.models`` exports every name of
    ``vit_tpu.models.__all__``: the 20 modules, the classes and the CCT
    factories; the top-level names are the same objects."""
    from vit_tpu_torch import models

    names = vit_tpu_all("vit_tpu.models")
    assert sorted(models.__all__) == sorted(names) and len(names) == len(set(names))
    for name in names:
        obj = getattr(models, name)
        if isinstance(obj, type(models)):
            assert obj.__name__ == f"vit_tpu_torch.models.{name}"
        elif name in vit_tpu_torch.__all__:
            assert obj is getattr(vit_tpu_torch, name)
    assert sum(isinstance(getattr(models, n), type(models)) for n in names) == 20
    for name in ("CaiT", "CrossViT", "DeepViT", "PatchMerger", "parallel_vit",
                 "vit_with_patch_merger", "ats_vit", "CCT", "cct_14", "SPT", "LSA"):
        assert name in models.__all__ and getattr(models, name) is getattr(vit_tpu_torch, name)
    assert models.parallel_vit.ViT is not ViT and models.vit_with_patch_merger.ViT is not ViT
    assert models.ats_vit.ViT is not ViT and models.ViT is ViT


def test_scalable_vit_builds_on_the_card_unless_asked_otherwise():
    cfg = dict(num_classes=5, dim=16, depth=(1,), heads=2, reduction_factor=2)
    if torch.cuda.is_available():
        assert all(p.is_cuda for p in ScalableViT(**cfg).parameters())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ScalableViT(**cfg)
    assert all(p.device.type == "cpu" for p in ScalableViT(**cfg, device="cpu").parameters())


@pytest.mark.parametrize("build", [
    lambda **kw: efficient.ViT(image_size=TINY["image_size"], patch_size=TINY["patch_size"],
                               num_classes=5, dim=TINY["dim"],
                               transformer=nn.Identity(), **kw),
    lambda **kw: vit_tpu_torch.MAE(ViT(**TINY), decoder_dim=16, **kw),
    lambda **kw: vit_tpu_torch.SimMIM(ViT(**TINY), **kw),
    lambda **kw: vit_tpu_torch.MPP(ViT(**TINY), patch_size=4, **kw),
    lambda **kw: vit_tpu_torch.DistillWrapper(
        ViT(**TINY), vit_tpu_torch.DistillableViT(**TINY), **kw),
], ids=["EfficientViT", "MAE", "SimMIM", "MPP", "DistillWrapper"])
def test_objectives_build_on_the_card_unless_asked_otherwise(build):
    """Their own parameters (the objectives' heads, tokens and decoders, the
    Efficient ViT's embeddings and head; the encoders here are built on the
    CPU)
    follow ``resolve_device``, as every module of the port does."""
    def own(module):
        return [p for name, p in module.named_parameters()
                if not name.startswith(("encoder.", "transformer.", "teacher.", "student."))]

    if torch.cuda.is_available():
        assert all(p.is_cuda for p in own(build()))
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    assert all(p.device.type == "cpu" for p in build(device="cpu").parameters())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalable_vit_ops_take_the_plain_version_on_cpu(dtype):
    g = torch.Generator().manual_seed(0)

    def rn(*s, scale=1.0):
        return (torch.randn(*s, generator=g) * scale).to(dtype)

    x, xn = rn(2, 16, 32), rn(2, 16, 32)
    cross = (x, xn, rn(80, 32, scale=0.2), rn(2, 4, 80), rn(2, 4, 64), rn(32, 64, scale=0.2),
             rn(32, scale=0.1))
    q, k, v = rn(2, 16, 64), rn(2, 16, 64), rn(2, 16, 64)
    counts = (fused_cross_attention.launches, flash_attention_packed.launches)
    with torch.no_grad():
        y = fused_cross_attention(*cross, 2, 40, 32)
        out = flash_attention_packed(q, k, v, 2)
    assert (fused_cross_attention.launches, flash_attention_packed.launches) == counts
    assert torch.equal(y, fused_cross_attention_reference(*cross, 2, 40, 32))
    assert torch.equal(out, flash_attention_packed_forward_reference(q, k, v, 2)[0])
    assert y.dtype == out.dtype == dtype and out.shape == (2, 16, 64)


def vit_tpu_public_names(module: str) -> set:
    """The public names a ``vit_tpu`` module defines (functions, classes and
    assignments at its top level, no imports), read from its source."""
    tree = ast.parse((REPO / (module.replace(".", "/") + ".py")).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


# vit_tpu's public names without a counterpart in the port, each with its reason.
NO_COUNTERPART = {
    "vit_tpu.parallel.train": {
        # The BatchNorm step: the port's make_train_step updates the running
        # statistics in place (and, under a mesh, synchronises them).
        "TrainStateWithModelState", "create_bn_train_state", "make_bn_train_step",
    },
}


@pytest.mark.parametrize("module", [
    "vit_tpu.interop.checkpoint", "vit_tpu.interop.export", "vit_tpu.parallel.mesh",
    "vit_tpu.parallel.sharding", "vit_tpu.parallel.train", "vit_tpu.utils.data",
    "vit_tpu.utils.debug",
    "vit_tpu.utils.metrics", "vit_tpu.utils.profiling",
])
def test_infrastructure_modules_have_counterparts(module):
    """Every public name of ``vit_tpu``'s training, checkpoint, export and
    utility modules has a counterpart in the port's module of the same path,
    but those listed in ``NO_COUNTERPART``, which the port does not have."""
    import importlib

    port = importlib.import_module(module.replace("vit_tpu", "vit_tpu_torch", 1))
    names = vit_tpu_public_names(module)
    skipped = NO_COUNTERPART.get(module, set())
    assert skipped <= names
    missing = sorted(n for n in names - skipped if not hasattr(port, n))
    assert not missing, f"{port.__name__} lacks {missing}"
    assert not any(hasattr(port, n) for n in skipped)


@pytest.mark.parametrize("path", ["vit_tpu_torch", "chip_smoke.py",
                                  "examples/train_classifier_torch.py"])
def test_port_imports_neither_jax_nor_vit_tpu_nor_their_formats(path):
    """No JAX, Flax, ``vit_tpu``, safetensors or orbax import in the port's
    package, its smoke or its example trainer."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|vit_tpu|safetensors|orbax)(\.|\s|$)",
                         re.M)
    root = REPO / path
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    assert not [str(p.relative_to(REPO)) for p in files if pattern.search(p.read_text())]
