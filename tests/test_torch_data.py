"""The port's input pipeline on the CPU (mirrors ``tests/unit/test_data.py``):
prefetch order and content, the batch's placement without a group, the
local batch size, the threaded loader.  No JAX."""

import numpy as np
import pytest
import torch

from vit_tpu_torch.utils.data import (
    ThreadedLoader, prefetch, process_local_batch_size, shard_batch,
)


def test_prefetch_preserves_order_and_content():
    batches = [{"x": np.full((4,), i)} for i in range(7)]
    out = list(prefetch(iter(batches), size=3))
    assert len(out) == 7
    for i, b in enumerate(out):
        assert isinstance(b["x"], torch.Tensor)
        assert torch.equal(b["x"], torch.full((4,), i))


def test_prefetch_takes_a_device_put():
    batches = [(np.full((2,), i, np.float32), [np.arange(3)]) for i in range(4)]
    out = list(prefetch(iter(batches), size=2,
                        device_put=lambda b: shard_batch(b, device="cpu")))
    assert [float(x[0]) for x, _ in out] == [0.0, 1.0, 2.0, 3.0]
    assert all(isinstance(rest, list) and torch.equal(rest[0], torch.arange(3))
               for _, rest in out)


def test_shard_batch_without_a_group_places_the_whole_batch():
    batch = {"image": np.zeros((16, 8, 8, 3), np.float32), "label": np.arange(16),
             "extra": (torch.ones(16, 2),)}
    placed = shard_batch(batch, None, device="cpu")
    assert placed["image"].shape == (16, 8, 8, 3) and placed["image"].dtype == torch.float32
    assert torch.equal(placed["label"], torch.arange(16))
    assert isinstance(placed["extra"], tuple) and placed["extra"][0].shape == (16, 2)


def test_process_local_batch_size():
    assert process_local_batch_size(64) == 64
    assert process_local_batch_size(7) == 7


def test_process_local_batch_size_must_divide(monkeypatch):
    from vit_tpu_torch.utils import data

    monkeypatch.setattr(data, "_world", lambda: 4)
    assert process_local_batch_size(64) == 16
    with pytest.raises(ValueError, match="divide evenly"):
        process_local_batch_size(10)


def test_threaded_loader():
    loader = ThreadedLoader(lambda step: {"s": np.asarray(step)}, num_steps=5, queue_size=2)
    assert [int(b["s"]) for b in loader] == [0, 1, 2, 3, 4]


def test_threaded_loader_through_prefetch():
    loader = ThreadedLoader(lambda step: {"s": np.full((2,), step)}, num_steps=6, queue_size=2)
    out = [int(b["s"][0]) for b in prefetch(iter(loader), size=2)]
    assert out == list(range(6))
