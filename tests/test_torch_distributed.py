"""The port's data-parallel train step over two gloo ranks on the CPU.

One spawn of two ranks (``torch_distributed_worker.run``) runs every
distributed check; the parent computes the references and holds the ranks'
results to them:

- the small ViT of ``tests/multidevice/test_sharded_train.py:20-26`` in f32,
  SGD(1e-2), 2 steps on a batch of 8 (4 a rank): losses and parameters within
  1e-5 of the port's single-process step on the whole batch, and within
  1e-4 of ``vit_tpu``'s ``make_train_step`` on a one-device mesh from the
  same weights (``state_dict_from_flax``); rank 1 starts from other weights,
  which the step replaces by rank 0's;
- ``accum_steps=2`` under the mesh against the whole batch;
- MobileViT at ``test_sharded_train.py:266-267``'s config in training:
  loss, parameters and BatchNorm running statistics within 1e-5 of the
  single-process step, and equal on both ranks;
- MAE training under the mesh with its encoder's head unused;
- ``CheckpointManager`` under the group: rank 0 writes, both restore its state;
- ``make_mesh`` under the group (a ``model`` axis over both ranks) and its
  refusals.

The group has a 60 s timeout and the ranks a join deadline, so a failed rank
fails the test instead of hanging it.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_distributed_worker as worker  # noqa: E402
from torch_parity import loaded, random_variables  # noqa: E402
from vit_tpu_torch import MobileViT, ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from vit_tpu_torch.parallel.train import make_train_step  # noqa: E402

WORLD = 2
JOIN_TIMEOUT_S = 180
BATCH = 8


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _single_process(build, state, optimizer_of, images, labels):
    model = build()
    model.load_state_dict(state)
    step = make_train_step(model, optimizer_of(model))
    losses = [float(step(images, labels)["loss"]) for _ in range(worker.STEPS)]
    return {"losses": losses, "state": {k: v.detach().clone()
                                        for k, v in model.state_dict().items()}}


def _jax_steps(variables, images, labels):
    """``vit_tpu``'s ``make_train_step`` on a one-device mesh: the losses and
    the parameters after ``worker.STEPS`` steps, as the port's keys."""
    from vit_tpu import ViT as JaxViT
    from vit_tpu.parallel import mesh as mesh_lib
    from vit_tpu.parallel import train as jax_train

    model, tx = JaxViT(**worker.SMALL_VIT), optax.sgd(worker.VIT_LR)
    mesh = mesh_lib.make_mesh(devices=jax.devices()[:1])
    _, compile_step = jax_train.make_train_step(
        lambda p, x, rng: model.apply({"params": p}, x), tx, mesh, donate=False)
    state = jax_train.create_train_state(variables["params"], tx)
    step = compile_step(state)
    state = jax.device_put(state, jax_train.state_shardings(mesh, state))
    losses = []
    for _ in range(worker.STEPS):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                              jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    return {"losses": losses,
            "state": state_dict_from_flax(jax.tree.map(np.asarray, state.params))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((BATCH, 32, 32, 3)).astype(np.float32)
    labels = (np.arange(BATCH) % 10).astype(np.int32)
    variables = random_variables(__import__("vit_tpu").ViT(**worker.SMALL_VIT), images, rng)
    vit_state = loaded(ViT(**worker.SMALL_VIT, device="cpu"), variables).state_dict()
    torch.manual_seed(0)
    mobilevit_state = MobileViT(**worker.MOBILEVIT, device="cpu").state_dict()
    inputs = {
        "images": torch.from_numpy(images), "labels": torch.from_numpy(labels).long(),
        "vit_state": vit_state, "mobilevit_state": mobilevit_state,
        "mobilevit_images": torch.from_numpy(
            rng.standard_normal((BATCH, 64, 64, 3)).astype(np.float32)),
        "mobilevit_labels": torch.arange(BATCH) % 6,
        "mae_images": torch.from_numpy(
            rng.standard_normal((4, 64, 64, 3)).astype(np.float32)),
    }
    workdir = tmp_path_factory.mktemp("ranks")
    torch.save(inputs, workdir / "inputs.pt")
    ctx = mp.start_processes(worker.run, args=(WORLD, _free_port(), str(workdir)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]

    def sgd(lr):
        return lambda m: torch.optim.SGD(m.parameters(), lr=lr)

    whole = _single_process(lambda: ViT(**worker.SMALL_VIT, device="cpu"), vit_state,
                            sgd(worker.VIT_LR), inputs["images"], inputs["labels"])
    mobilevit = _single_process(lambda: MobileViT(**worker.MOBILEVIT, device="cpu"),
                                mobilevit_state, sgd(worker.MOBILEVIT_LR),
                                inputs["mobilevit_images"], inputs["mobilevit_labels"])
    return {"ranks": ranks, "whole": whole, "mobilevit": mobilevit,
            "jax": _jax_steps(variables, images, labels)}


def _diff(got, want) -> float:
    return max([abs(a - b) for a, b in zip(got["losses"], want["losses"])]
               + [float((got["state"][k].float() - v.float()).abs().max())
                  for k, v in want["state"].items()])


@pytest.mark.parametrize("tag", ["vit", "vit accum"])
def test_data_parallel_step_matches_the_whole_batch(runs, tag):
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(runs["whole"]["state"])
        assert _diff(rank[tag], runs["whole"]) <= 1e-5


def test_data_parallel_step_matches_vit_tpu(runs):
    for rank in runs["ranks"]:
        assert _diff(rank["vit"], runs["jax"]) <= 1e-4


@pytest.mark.parametrize("tag", ["vit", "vit accum", "mobilevit", "mae"])
def test_ranks_hold_equal_states(runs, tag):
    first, second = (rank[tag]["state"] for rank in runs["ranks"])
    assert all(torch.equal(first[k], second[k]) for k in first)


def test_mobilevit_batch_norm_is_synchronised(runs):
    ranks, want = runs["ranks"], runs["mobilevit"]
    stats = [k for k in want["state"] if "running" in k]
    assert stats and all(not torch.equal(want["state"][k], torch.zeros_like(want["state"][k]))
                         for k in stats if k.endswith("running_mean"))
    for rank in ranks:
        assert _diff(rank["mobilevit"], want) <= 1e-5


def test_mae_trains_with_its_head_unused(runs):
    for rank in runs["ranks"]:
        mae = rank["mae"]
        assert np.isfinite(mae["loss"])
        # MAE's encoder reads neither its class token nor its head.
        unused = ("encoder.cls_token", "encoder.head")
        assert mae["no_grad"] and all(k.startswith(unused) for k in mae["no_grad"])
        assert any(k.startswith("decoder") for k in mae["moved"])
        assert not any(k.startswith(unused) for k in mae["moved"])


def test_checkpoint_manager_writes_on_rank_zero(runs):
    for rank in runs["ranks"]:
        ckpt = rank["ckpt"]
        assert ckpt["files"] == ["checkpoint_7.pt"] and ckpt["latest"] == 7
        assert ckpt["restored"]["step"] == 0
        assert torch.equal(ckpt["restored"]["w"], torch.zeros(3))


def test_make_mesh_under_the_group(runs):
    for rank in runs["ranks"]:
        assert rank["mesh_shape"] == (WORLD, 1)
        assert rank["mesh (1, 2)"] == (1, 2)
        assert rank["mesh (3, 1)"] == "ValueError"


def test_one_process_needs_no_group(monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    assert port_mesh.initialize_distributed(num_processes=1) == (0, 1)
    assert port_mesh.initialize_distributed() == (0, 1)
    assert not torch.distributed.is_initialized()
    assert port_mesh.make_mesh() is None
    with pytest.raises(ValueError, match="does not cover 1 process"):
        port_mesh.make_mesh((1, 2))
    with pytest.raises(ValueError, match="does not cover"):
        port_mesh.make_mesh((2, 1))
    assert port_mesh.data_size(None) == 1 and port_mesh.data_group(None) is None
