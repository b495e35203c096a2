"""Serving export of the port on the CPU (mirrors ``tests/unit/test_export.py``):
the artifact's output equals the live model's exactly in both layouts, and it
refuses another input shape; each of the ten serving kernel ops exports as a
graph node of its own (``vit_tpu_torch::<name>``) whose fake implementation
gives the real one's shape, dtype and strides.  No JAX."""

import io

import pytest
import torch

from torch_op_cases import NAMES, OneOp, case, fake_output
from vit_tpu_torch import ViT
from vit_tpu_torch.interop.export import (
    export_forward, load_forward, load_forward_file, model_params, save_forward,
)
from vit_tpu_torch.layers import common

TINY = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=2, mlp_dim=64,
            dim_head=16, device="cpu")
SHAPE = (2, 32, 32, 3)


def _model(seed=0):
    torch.manual_seed(seed)
    return ViT(**TINY)


def _eager(model, img):
    with torch.no_grad():
        return model.eval()(img)


def _kernel_ops(data: bytes) -> list:
    graph = torch.export.load(io.BytesIO(data)).graph
    return [str(node.target) for node in graph.nodes
            if str(node.target).startswith("vit_tpu_torch.")]


def test_export_round_trip_with_params():
    model = _model()
    img = torch.randn(*SHAPE)
    data = export_forward(model, SHAPE)
    assert isinstance(data, bytes) and data
    served = load_forward(data)
    with torch.no_grad():
        assert torch.equal(served(model_params(model), img), _eager(model, img))
        # One artifact serves every checkpoint: other weights, the other model's output.
        other = _model(seed=1)
        assert torch.equal(served(model_params(other), img), _eager(other, img))


def test_export_round_trip_baked_params(tmp_path):
    model = _model()
    img = torch.randn(*SHAPE)
    path = str(tmp_path / "vit.pt2")
    save_forward(path, model, SHAPE, bake_params=True)
    served = load_forward_file(path)
    with torch.no_grad():
        assert torch.equal(served(img), _eager(model, img))


def test_export_keeps_the_training_mode():
    model = _model().train()
    export_forward(model, SHAPE, bake_params=True)
    assert model.training


@pytest.mark.parametrize("bake", [False, True])
def test_export_rejects_other_shapes(bake):
    model = _model()
    served = load_forward(export_forward(model, SHAPE, bake_params=bake))
    bad = torch.zeros(3, 32, 32, 3)
    with pytest.raises(Exception), torch.no_grad():
        served(bad) if bake else served(model_params(model), bad)


def test_exported_vit_holds_the_kernel_ops(monkeypatch):
    """With the kernel route opened on the CPU, the artifact holds the block
    ops, one node a layer each, and runs them as the eager model does."""
    monkeypatch.setattr(common, "kernel_activation", lambda x: True)
    model = _model()
    img = torch.randn(*SHAPE)
    data = export_forward(model, SHAPE, bake_params=True)
    ops = _kernel_ops(data)
    assert sorted(ops) == sorted(["vit_tpu_torch.fused_attention_block.default",
                                  "vit_tpu_torch.fused_mlp.default"] * TINY["depth"])
    with torch.no_grad():
        assert torch.equal(load_forward(data)(img), _eager(model, img))


@pytest.mark.parametrize("name", NAMES)
def test_kernel_op_exports_as_one_node(name):
    c = case(name)
    module = OneOp(c.entry, c.kwargs)
    with torch.no_grad():
        program = torch.export.export(module, c.args)
        buffer = io.BytesIO()
        torch.export.save(program, buffer)
        loaded = torch.export.load(io.BytesIO(buffer.getvalue())).module()
        got = loaded(*c.args)
        eager = module(*c.args)
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"
             and str(n.target).startswith("vit_tpu_torch.")]
    assert nodes == [f"{c.op._qualname.replace('::', '.')}.default"]
    assert torch.equal(got, eager) and torch.equal(got, c.plain(*c.args, **c.kwargs))


@pytest.mark.parametrize("name", NAMES)
def test_kernel_op_fake_matches_the_real_one(name):
    """The fake implementation gives the CPU implementation's shape, dtype and
    strides (also ``torch.library.opcheck``'s schema and fake-tensor tests)."""
    c = case(name)
    real, fake = c.op(*c.op_args), fake_output(c.op, c.op_args)
    assert (fake.shape, fake.dtype, fake.stride()) == (real.shape, real.dtype, real.stride())
    torch.library.opcheck(c.op, c.op_args, test_utils=("test_schema", "test_faketensor"))
