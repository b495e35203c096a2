"""Checkpoints of the port on the CPU (mirrors ``tests/unit/test_utils.py:19-64``):
a ``TrainState`` with AdamW's state round-trips exactly, the rolling manager
keeps ``max_to_keep``, an async save is whole after ``wait``.  No JAX."""

import pytest
import torch

from vit_tpu_torch import ViT
from vit_tpu_torch.interop import checkpoint as ckpt
from vit_tpu_torch.parallel.train import create_train_state, make_train_step

TINY = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=1, heads=2,
            mlp_dim=64, dim_head=16, device="cpu")


def _trained(seed=0, steps=1):
    """A tiny ViT and its AdamW after ``steps`` steps: moments and step count
    in the optimizer's state."""
    torch.manual_seed(seed)
    model = ViT(**TINY)
    step = make_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        step(torch.randn(2, 32, 32, 3, generator=g), torch.tensor([1, 3]))
    return step.state


def _fresh(seed=42):
    torch.manual_seed(seed)
    model = ViT(**TINY)
    return create_train_state(model, torch.optim.AdamW(model.parameters(), lr=1e-3))


def _assert_equal_states(a, b):
    assert a.step == b.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"]
    assert oa["state"].keys() == ob["state"].keys()
    for i, state in oa["state"].items():
        assert state.keys() == ob["state"][i].keys()
        assert all(torch.equal(v, ob["state"][i][k]) for k, v in state.items())


def test_train_state_round_trip_with_adamw_state(tmp_path):
    state = _trained()
    assert state.optimizer.state_dict()["state"]  # AdamW's moments are there
    path = str(tmp_path / "ckpt.pt")
    ckpt.save_checkpoint(path, state)
    restored = ckpt.restore_checkpoint(path, target=_fresh())
    _assert_equal_states(state, restored)


def test_resumed_state_continues_as_the_original(tmp_path):
    """One more step on the original and on its restored copy: equal."""
    state = _trained()
    ckpt.save_checkpoint(str(tmp_path / "ckpt.pt"), state)
    resumed = ckpt.restore_checkpoint(str(tmp_path / "ckpt.pt"), target=_fresh())
    images, labels = torch.randn(2, 32, 32, 3), torch.tensor([0, 4])
    for s in (state, resumed):
        step = make_train_step(s.model, s.optimizer)
        step.state.step = s.step
        step(images, labels)
    _assert_equal_states(state, resumed)


@pytest.mark.parametrize("kind", ["module", "dict"])
def test_module_and_dict_round_trip(tmp_path, kind):
    model = _trained().model
    state = model if kind == "module" else {"params": dict(model.state_dict()), "epoch": 3}
    path = str(tmp_path / "x.pt")
    ckpt.save_checkpoint(path, state)
    target = _fresh().model if kind == "module" else {
        "params": {k: torch.zeros_like(v) for k, v in model.state_dict().items()}, "epoch": 0}
    restored = ckpt.restore_checkpoint(path, target=target)
    assert restored is target
    got = restored.state_dict() if kind == "module" else restored["params"]
    assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    if kind == "dict":
        assert restored["epoch"] == 3


def test_restore_without_target_returns_the_raw_dict(tmp_path):
    state = _trained()
    ckpt.save_checkpoint(str(tmp_path / "c.pt"), state)
    raw = ckpt.restore_checkpoint(str(tmp_path / "c.pt"))
    assert isinstance(raw, dict) and set(raw) == {"model", "optimizer", "step"}
    assert raw["step"] == 1
    assert all(t.device.type == "cpu" for t in raw["model"].values())


def test_manager_keeps_the_last_two(tmp_path):
    state = _trained()
    manager = ckpt.CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    for step in (1, 2, 3):
        state.step = step
        manager.save(step, state)
    assert manager.latest_step() == 3
    assert sorted(p.name for p in (tmp_path / "run").iterdir()) == [
        "checkpoint_2.pt", "checkpoint_3.pt"]
    assert manager.restore(target=_fresh()).step == 3
    assert manager.restore(step=2)["step"] == 2


def test_async_save_then_wait_restores_equal(tmp_path):
    state = _trained(steps=2)
    manager = ckpt.CheckpointManager(str(tmp_path / "run_async"), max_to_keep=2)
    manager.save(7, state, wait=False)
    # The snapshot was taken before save returned: a later change is not in it.
    first = next(state.model.parameters())
    saved = first.detach().clone()
    with torch.no_grad():
        first.add_(1.0)
    manager.wait()
    assert manager.latest_step() == 7
    restored = manager.restore(target=_fresh())
    with torch.no_grad():
        first.copy_(saved)
    _assert_equal_states(state, restored)


def test_restore_with_nothing_saved_raises(tmp_path):
    manager = ckpt.CheckpointManager(str(tmp_path / "empty"))
    assert manager.latest_step() is None
    with pytest.raises(ValueError, match="no checkpoints"):
        manager.restore()


def test_writes_leave_no_temporary_file(tmp_path):
    ckpt.save_checkpoint(str(tmp_path / "a.pt"), {"w": torch.ones(2)})
    assert [p.name for p in tmp_path.iterdir()] == ["a.pt"]
