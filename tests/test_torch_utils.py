"""The port's debug, metrics and profiling utilities on the CPU (mirrors
``tests/unit/test_utils.py``'s and ``vit_tpu/utils/profiling.py``'s
contracts).  No JAX."""

import io
import json

import pytest
import torch

from vit_tpu_torch import ViT
from vit_tpu_torch.ops.fused_mlp import fused_mlp
from vit_tpu_torch.utils.debug import assert_finite, checked
from vit_tpu_torch.utils.metrics import MetricLogger
from vit_tpu_torch.utils.profiling import (
    benchmark, benchmark_throughput, named_scope, op_breakdown, trace,
)


def test_checked_raises_on_nan_naming_the_op():
    @checked
    def bad(x):
        return torch.log(x) * 2

    with pytest.raises(FloatingPointError, match="aten.log"):
        bad(torch.tensor([1.0, -1.0]))


def test_checked_names_a_registered_kernel_op():
    """A NaN made inside the port's kernel op is named by that op."""
    x = torch.randn(2, 3, 8)
    w1, w2 = torch.randn(16, 8), torch.randn(8, 16)
    w1[0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="vit_tpu_torch.fused_mlp"):
        checked(fused_mlp)(x, torch.ones(8), torch.zeros(8), w1, torch.zeros(16), w2,
                           torch.zeros(8))


@pytest.mark.parametrize("value, kind", [(float("inf"), "inf"), (float("nan"), "NaN")])
def test_checked_tells_nan_from_inf(value, kind):
    with pytest.raises(FloatingPointError, match=kind):
        checked(lambda x: x * 1.0)(torch.tensor([value]))


def test_checked_returns_the_value_when_finite():
    out = checked(lambda x, y=1.0: torch.exp(x) + y)(torch.zeros(3), y=2.0)
    assert torch.equal(out, torch.full((3,), 3.0))


def test_checked_model_forward_passes():
    model = ViT(image_size=16, patch_size=8, num_classes=3, dim=16, depth=1, heads=2,
                mlp_dim=32, dim_head=8, device="cpu").eval()
    with torch.no_grad():
        out = checked(model)(torch.randn(2, 16, 16, 3))
    assert out.shape == (2, 3)


def test_assert_finite_names_the_key():
    assert_finite({"a": torch.ones(2), "b": [torch.zeros(1)]})
    with pytest.raises(FloatingPointError, match="params:layer/w"):
        assert_finite({"layer": {"w": torch.tensor([float("nan")])}}, "params")
    with pytest.raises(FloatingPointError, match="tree:b/1"):
        assert_finite({"b": [torch.zeros(1), torch.tensor([float("inf")])]})


def test_assert_finite_over_a_module():
    model = torch.nn.Linear(2, 2)
    assert_finite(model, "model")
    with torch.no_grad():
        model.bias[1] = float("inf")
    with pytest.raises(FloatingPointError, match="model:bias"):
        assert_finite(model, "model")


class _Counted(torch.Tensor):
    """A tensor that counts the host reads (``.item()``, ``.tolist()``,
    ``float()``) made of it or of what is derived from it."""

    reads = 0

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.__float__):
            cls.reads += 1
        return super().__torch_function__(func, types, args, kwargs or {})


def test_metric_logger_reads_tensors_only_at_flush():
    stream = io.StringIO()
    logger = MetricLogger(every=10, stream=stream)
    _Counted.reads = 0
    for step in (1, 2, 3):
        logger.log(step, {"loss": torch.tensor(float(step)).as_subclass(_Counted), "lr": 0.1})
    assert stream.getvalue() == "" and _Counted.reads == 0
    logger.flush()
    assert _Counted.reads == 1  # one read for the three queued steps
    lines = [json.loads(line) for line in stream.getvalue().splitlines()]
    assert [line["step"] for line in lines] == [1, 2, 3]
    assert [line["loss"] for line in lines] == [1.0, 2.0, 3.0]
    assert all(line["lr"] == 0.1 and "wall_s" in line for line in lines)


def test_metric_logger_flushes_every_n_steps():
    stream = io.StringIO()
    logger = MetricLogger(every=2, stream=stream)
    logger.log(1, {"loss": torch.tensor(0.5)})
    assert stream.getvalue() == ""
    logger.log(2, {"loss": torch.tensor(0.25)})
    assert [json.loads(line)["step"] for line in stream.getvalue().splitlines()] == [1, 2]


def test_trace_and_op_breakdown_on_the_cpu(tmp_path):
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with trace(str(tmp_path)):
        with named_scope("matmuls"):
            for _ in range(3):
                torch.mm(a, b)
    rows = op_breakdown(str(tmp_path), top=5)
    assert rows and set(rows[0]) == {"name", "occurrences", "total_ms", "pct"}
    mm = next(r for r in rows if r["name"] == "aten::mm")
    assert mm["occurrences"] == 3 and mm["total_ms"] > 0
    assert all(r["pct"] >= 0 for r in rows)


def test_op_breakdown_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        op_breakdown(str(tmp_path))


def test_benchmark_keys():
    out = benchmark(torch.mm, torch.randn(8, 8), torch.randn(8, 8), iters=3, warmup=1)
    assert set(out) == {"mean_s", "median_s", "min_s", "iters"} and out["iters"] == 3
    assert 0 < out["min_s"] <= out["median_s"]
    tp = benchmark_throughput(torch.mm, torch.randn(8, 8), torch.randn(8, 8), batch=8, iters=3,
                              warmup=1)
    assert set(tp) == {"sec_per_step", "items_per_sec", "iters"}
    assert tp["items_per_sec"] == pytest.approx(8 / tp["sec_per_step"])
