"""The ranks of ``test_torch_tensor_parallel.py``: four spawned processes on
the CPU (gloo) over a (2, 2) ``data`` x ``model`` mesh, each training its
data rank's slice of the batch with its model rank's slice of the model and
writing what it saw to ``rank<r>.pt`` in the test's directory.  Imports no
JAX, so that a rank starts in seconds; pytest does not collect it."""

import contextlib
import io
import os
import runpy
import sys
import traceback

import torch

SMALL_VIT = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2,
                 mlp_dim=128, dim_head=32)
DROPOUT_VIT = dict(SMALL_VIT, dropout=0.1, emb_dropout=0.1)
MAE_ENCODER = dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=2,
                   mlp_dim=128, dim_head=32)
SCALABLE = dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 2), reduction_factor=(4, 2),
                window_size=(8, None), ssa_dim_key=(40, 40), ssa_dim_value=(32, 32))
# What shard_params once refused, now split or run whole: three heads and a
# 24-wide MLP over two ranks (those units whole), ScalableViT (split, IWSA's
# to_v whole); each from one seed, against the one-process steps.
WHOLE_RULE = {"heads": ("ViT", dict(SMALL_VIT, heads=3)),
              "hidden": ("ViT", dict(SMALL_VIT, mlp_dim=24)),
              "scalable": ("ScalableViT", SCALABLE)}
WHOLE_SEED = 300
MESH = (2, 2)
LR, STEPS = 1e-2, 2
DROPOUT_SEED, MAE_SEED = 100, 200
EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples",
                       "train_classifier_torch.py")
EXAMPLE_ARGS = ["--model", "vit", "--steps", "2", "--batch", "4", "--image-size", "32",
                "--num-classes", "10", "--cpu", "--log-every", "1", "--tp", "2"]


def data_slice(t, data_rank):
    size = t.shape[0] // MESH[0]
    return t[data_rank * size:(data_rank + 1) * size]


def _refusal(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


@contextlib.contextmanager
def kernel_route(calls):
    """The blocks' kernel route on the CPU (``kernel_activation`` accepting
    any tensor), each call into the block ops recorded with whether it
    passed a model group."""
    from vit_tpu_torch.layers import common

    saved = (common.kernel_activation, common.fused_attention_block, common.fused_mlp)

    def record(name, op):
        def call(*args, group=None, **kwargs):
            calls.append((name, group is not None))
            return op(*args, group=group, **kwargs)
        return call

    common.kernel_activation = lambda x: True
    common.fused_attention_block = record("attention", saved[1])
    common.fused_mlp = record("mlp", saved[2])
    try:
        yield
    finally:
        common.kernel_activation, common.fused_attention_block, common.fused_mlp = saved


def whole_rule_run(name, mesh, images, labels, inputs):
    """:data:`WHOLE_RULE`'s ``name`` from :data:`WHOLE_SEED`, split over
    ``mesh`` on this rank's slice, and on one process on the whole batch:
    STEPS SGD steps each, the losses, the gathered state and the plan's
    whole units and replicated parameters."""
    import vit_tpu_torch
    from vit_tpu_torch.interop.checkpoint import full_state_dict
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    cls, cfg = WHOLE_RULE[name]

    def trained(mesh, images, labels):
        model = getattr(vit_tpu_torch, cls)(**cfg, device="cpu",
                                            generator=torch.Generator().manual_seed(WHOLE_SEED))
        shard_params(mesh, model)
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
        return model, [float(step(images, labels)["loss"]) for _ in range(STEPS)]

    model, losses = trained(mesh, images, labels)
    one, one_losses = trained(None, inputs["images"], inputs["labels"])
    plan = model.tensor_parallel
    return {"losses": losses, "state": full_state_dict(model), "whole": list(plan.whole),
            "replicated": list(plan.replicated),
            "one process": {"losses": one_losses, "state": one.state_dict()}}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vit_tpu_torch import MAE, ViT
    from vit_tpu_torch.interop.checkpoint import (
        CheckpointManager, full_state_dict, restore_checkpoint,
    )
    from vit_tpu_torch.parallel.mesh import (
        data_size, initialize_distributed, make_mesh, model_rank, model_size,
    )
    from vit_tpu_torch.parallel.sharding import shard_params, shard_tensor
    from vit_tpu_torch.parallel.train import (
        TrainState, make_loss_train_step, make_train_step, state_shardings,
    )

    torch.set_num_threads(1)
    results = {}
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=60) == (rank, world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        mesh = make_mesh(MESH, device_type="cpu")
        d_rank = rank // MESH[1]
        results["mesh"] = {"shape": tuple(mesh.shape), "data": data_size(mesh),
                           "model": model_size(mesh), "model_rank": model_rank(mesh)}
        results["mesh (1, 2)"] = _refusal(lambda: make_mesh((1, 2), device_type="cpu"))
        images = data_slice(inputs["images"], d_rank)
        labels = data_slice(inputs["labels"], d_rank)

        def split_vit(cfg, state, **kw):
            model = ViT(**cfg, device="cpu", **kw)
            model.load_state_dict(state)
            if rank:  # the ranks must start from rank 0's weights
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)
            return shard_params(mesh, model)

        for tag in ("vit", "vit kernels"):
            model = split_vit(SMALL_VIT, inputs["vit_state"])
            step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
            calls = []
            with kernel_route(calls) if tag == "vit kernels" else contextlib.nullcontext():
                losses = [float(step(images, labels)["loss"]) for _ in range(STEPS)]
            results[tag] = {
                "losses": losses, "state": full_state_dict(model), "calls": calls,
                "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
                "heads": [layer["attn"].heads for layer in model.transformer.layers]}

        model = split_vit(DROPOUT_VIT, inputs["vit_state"])
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
        g = torch.Generator().manual_seed(DROPOUT_SEED + d_rank)
        losses = [float(step(images, labels, generator=g)["loss"]) for _ in range(STEPS)]
        results["dropout"] = {"losses": losses, "state": full_state_dict(model)}
        model = split_vit(DROPOUT_VIT, inputs["vit_state"])
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=LR), mesh=mesh)
        results["dropout without a generator"] = _refusal(lambda: step(images, labels))

        mae = MAE(ViT(**MAE_ENCODER, device="cpu"), decoder_dim=32, device="cpu")
        mae.load_state_dict(inputs["mae_state"])
        shard_params(mesh, mae)
        step = make_loss_train_step(mae, torch.optim.SGD(mae.parameters(), lr=LR), mesh=mesh)
        g = torch.Generator().manual_seed(MAE_SEED + d_rank)
        loss = step(data_slice(inputs["mae_images"], d_rank), generator=g)["loss"]
        results["mae"] = {"losses": [float(loss)], "state": full_state_dict(mae),
                          "split": sorted(mae.tensor_parallel.kinds)}

        results["refusals"] = {
            "hybrid": _refusal(lambda: shard_params(mesh, ViT(**SMALL_VIT, device="cpu",
                                                              fused_attention="hybrid"))),
            "unsplit step": _refusal(lambda: make_train_step(
                ViT(**SMALL_VIT, device="cpu"), torch.optim.SGD([torch.zeros(1)], lr=LR),
                mesh=mesh)),
        }
        results["whole rule"] = {name: whole_rule_run(name, mesh, images, labels, inputs)
                                 for name in WHOLE_RULE}

        # A one-process checkpoint restored into the split model, then saved
        # from it: every rank gathers, rank 0 writes.
        model = shard_params(mesh, ViT(**SMALL_VIT, device="cpu"))
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=LR, momentum=0.9))
        restore_checkpoint(os.path.join(workdir, "one.pt"), state)
        whole = torch.load(os.path.join(workdir, "one.pt"), weights_only=True)
        plan = model.tensor_parallel
        names = [n for n, _ in model.named_parameters()]
        momentum = {names[i]: s["momentum_buffer"] for i, s in state.optimizer.state_dict()
                    ["state"].items()}
        sliced = [torch.equal(v, shard_tensor(whole["model"][k], plan.kinds[k], plan.shard.rank,
                                              plan.shard.size) if k in plan.kinds
                              else whole["model"][k]) for k, v in model.state_dict().items()]
        sliced += [torch.equal(momentum[k], shard_tensor(
            whole["optimizer"]["state"][names.index(k)]["momentum_buffer"], plan.kinds[k],
            plan.shard.rank, plan.shard.size) if k in plan.kinds
            else whole["optimizer"]["state"][names.index(k)]["momentum_buffer"])
            for k in momentum]
        CheckpointManager(os.path.join(workdir, "ckpt"), max_to_keep=1).save(5, state)
        placements = state_shardings(mesh, state)
        results["checkpoint"] = {
            "sliced": sliced,
            "placements": {k: [str(p) for p in v] for k, v in placements["params"].items()},
            "momentum placements": {names[i]: [str(p) for p in v["momentum_buffer"]]
                                    for i, v in placements["opt_state"].items()}}

        # The example trainer with --tp 2 over this group; it ends the group.
        out = io.StringIO()
        argv = sys.argv
        sys.argv = [EXAMPLE, *EXAMPLE_ARGS, "--ckpt-dir", os.path.join(workdir, "example"),
                    "--export", os.path.join(workdir, "example.pt2")]
        try:
            with contextlib.redirect_stdout(out):
                runpy.run_path(EXAMPLE, run_name="__main__")
        finally:
            sys.argv = argv
        results["example"] = out.getvalue()
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
