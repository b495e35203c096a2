"""The ranks of ``test_torch_distributed.py``: spawned processes on the CPU
(gloo), each training its slice of the batch under the port's mesh and
writing what it saw to ``rank<r>.pt`` in the test's directory.  Imports no
JAX, so that a rank starts in seconds; pytest does not collect it."""

import os
import traceback

import torch

SMALL_VIT = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2,
                 mlp_dim=128, dim_head=32)
MOBILEVIT = dict(image_size=(64, 64), dims=(16, 24, 32),
                 channels=(8, 8, 12, 12, 16, 16, 24, 24, 32, 32, 48), num_classes=6)
MAE_ENCODER = dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=2,
                   mlp_dim=128, dim_head=32)
VIT_LR, MOBILEVIT_LR, STEPS = 1e-2, 1e-3, 2


def _local(t, rank, world):
    size = t.shape[0] // world
    return t[rank * size:(rank + 1) * size]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _train(model, optimizer, images, labels, mesh, rank, world, accum_steps=1):
    from vit_tpu_torch.parallel.train import make_train_step

    step = make_train_step(model, optimizer, accum_steps=accum_steps, mesh=mesh)
    losses = [float(step(_local(images, rank, world), _local(labels, rank, world))["loss"])
              for _ in range(STEPS)]
    return {"losses": losses, "state": _state(model)}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vit_tpu_torch import MAE, MobileViT, ViT
    from vit_tpu_torch.interop.checkpoint import CheckpointManager
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.train import make_loss_train_step

    torch.set_num_threads(2)
    results = {}
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=60) == (rank, world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        mesh = make_mesh(device_type="cpu")
        results["mesh_shape"] = tuple(mesh.shape)
        for shape, error in (((1, 2), NotImplementedError), ((world + 1, 1), ValueError)):
            try:
                make_mesh(shape, device_type="cpu")
                results[f"mesh {shape}"] = "no error"
            except error as e:
                results[f"mesh {shape}"] = type(e).__name__

        images, labels = inputs["images"], inputs["labels"]
        for tag, accum in (("vit", 1), ("vit accum", 2)):
            model = ViT(**SMALL_VIT, device="cpu")
            model.load_state_dict(inputs["vit_state"])
            if rank:  # the step must start every rank from rank 0's weights
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)
            results[tag] = _train(model, torch.optim.SGD(model.parameters(), lr=VIT_LR), images,
                                  labels, mesh, rank, world, accum)

        model = MobileViT(**MOBILEVIT, device="cpu")
        model.load_state_dict(inputs["mobilevit_state"])
        results["mobilevit"] = _train(model, torch.optim.SGD(model.parameters(),
                                                             lr=MOBILEVIT_LR),
                                      inputs["mobilevit_images"], inputs["mobilevit_labels"],
                                      mesh, rank, world)

        torch.manual_seed(0)
        mae = MAE(ViT(**MAE_ENCODER, device="cpu"), decoder_dim=32, device="cpu")
        before = _state(mae)
        step = make_loss_train_step(mae, torch.optim.SGD(mae.parameters(), lr=VIT_LR), mesh=mesh)
        g = torch.Generator().manual_seed(rank)
        loss = step(_local(inputs["mae_images"], rank, world), generator=g)["loss"]
        results["mae"] = {
            "loss": float(loss), "state": _state(mae),
            "moved": [k for k, v in _state(mae).items() if not torch.equal(v, before[k])],
            "no_grad": sorted(k for k, p in mae.named_parameters() if p.grad is None)}

        # Rank 0 writes; each rank offers a state of its own.
        manager = CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=2)
        state = {"w": torch.full((3,), float(rank)), "step": rank}
        manager.save(7, state, wait=False)
        manager.wait()
        results["ckpt"] = {"files": sorted(os.listdir(os.path.join(workdir, "ckpt"))),
                           "restored": manager.restore(), "latest": manager.latest_step()}
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        dist.destroy_process_group()
