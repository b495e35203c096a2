"""The ranks of ``test_torch_tensor_parallel_biased.py``: four spawned
processes on the CPU (gloo), each training its slice of the small-dataset
ViT, CrossFormer, RegionViT and NesT over a (2, 2) ``data`` x ``model`` mesh
(the first three also on their split Functions' kernel route),
then each model over a (1, 4) mesh, then a share of the one-process
references, and writing what it saw to ``rank<r>.pt`` in the test's
directory.  Imports no JAX, so that a rank starts in seconds; pytest does
not collect it."""

import contextlib
import os
import traceback

import torch

MESH = (2, 2)
WIDE = (1, 4)
STEPS = 2
BATCH = 8
# Each model's own test's configuration (tests/test_torch_small_dataset.py,
# test_torch_crossformer.py, test_torch_regionvit.py, test_torch_nest.py):
# (class, constructor arguments, image side, SGD rate).
SMALL_DATASET = dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2, heads=2,
                     dim_head=32, mlp_dim=128)
CROSSFORMER = dict(dim=(32, 64, 96, 128), depth=(1, 1, 1, 1), global_window_size=(4, 2, 2, 1),
                   local_window_size=4, cross_embed_kernel_sizes=((2, 4),) * 4,
                   cross_embed_strides=(4, 2, 2, 2), num_classes=6)
REGIONVIT = dict(dim=(32, 48, 64, 96), depth=(1, 1, 1, 1), window_size=4, local_patch_size=4,
                 num_classes=8)
NEST = dict(image_size=64, patch_size=4, num_classes=8, dim=64, heads=2, num_hierarchies=3,
            block_repeats=(1, 1, 2))
MODELS = {
    "small-dataset ViT": ("vit_for_small_dataset.ViT", SMALL_DATASET, 32, 1e-2),
    "crossformer": ("CrossFormer", CROSSFORMER, 128, 1e-2),
    "regionvit": ("RegionViT", REGIONVIT, 128, 1e-2),
    "nest": ("NesT", NEST, 64, 1e-2),
}
KERNEL_ROUTE = ("small-dataset ViT", "crossformer", "regionvit")
CHECKPOINTED = "regionvit"
# The replicated parameters whose step-1 gradients each rank reports: LSA's
# temperatures and CrossFormer's position-bias MLPs.
REPORTED = ("temperature", ".dpb.")
# NesT@224's head counts (3, 6, 12) at a narrow width: hierarchy 1 runs whole
# at tp 2.
NEST_THREE_HEADS = dict(image_size=32, patch_size=4, num_classes=5, dim=48, heads=3,
                        num_hierarchies=2, block_repeats=(1, 1))


def model_class(name):
    import vit_tpu_torch

    module, _, cls = MODELS[name][0].rpartition(".")
    owner = getattr(vit_tpu_torch, module) if module else vit_tpu_torch
    return getattr(owner, cls)


def build(name, **kw):
    """A CPU model of ``MODELS[name]``'s class and configuration."""
    return model_class(name)(**MODELS[name][1], device="cpu", **kw)


def data_slice(t, data_rank, mesh=MESH):
    size = t.shape[0] // mesh[0]
    return t[data_rank * size:(data_rank + 1) * size]


def reported(model) -> dict:
    """The step's gradients of the replicated parameters of REPORTED."""
    return {k: p.grad.clone() for k, p in model.named_parameters()
            if any(r in k for r in REPORTED) and p.grad is not None}


def one_process(name, data):
    """The port's one-process SGD steps on the whole batch from ``data``'s
    weights: the losses, the REPORTED gradients of step 1 and the state
    after them."""
    from vit_tpu_torch.parallel.train import make_train_step

    model = build(name)
    model.load_state_dict(data["state"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=MODELS[name][3]))
    losses, grads = [], {}
    for i in range(STEPS):
        losses.append(float(step(data["images"], data["labels"])["loss"]))
        if i == 0:
            grads = reported(model)
    return {"losses": losses, "grads": grads, "state": model.state_dict()}


@contextlib.contextmanager
def kernel_route(calls):
    """The block ops' route on the CPU (``kernel_activation`` accepting any
    tensor in ``layers.common`` and ``models.vit_for_small_dataset``), each
    call into them recorded with whether it passed a model group."""
    from vit_tpu_torch.layers import common
    from vit_tpu_torch.models import crossformer, regionvit, vit_for_small_dataset

    owners = [(common, "fused_mlp"), (crossformer, "fused_attention_block_bias"),
              (regionvit, "fused_attention_block"), (regionvit, "fused_attention_block_bias"),
              (vit_for_small_dataset, "fused_attention_block_bias")]
    saved = [common.kernel_activation] + [getattr(m, n) for m, n in owners]

    def record(name, op):
        def call(*args, group=None, **kwargs):
            calls.append((name, group is not None))
            return op(*args, group=group, **kwargs)
        return call

    common.kernel_activation = vit_for_small_dataset.kernel_activation = lambda x: True
    for (module, name), op in zip(owners, saved[1:]):
        setattr(module, name, record(name, op))
    try:
        yield
    finally:
        common.kernel_activation = vit_for_small_dataset.kernel_activation = saved[0]
        for (module, name), op in zip(owners, saved[1:]):
            setattr(module, name, op)


def split_run(name, mesh, data, rank, kernels=False):
    """STEPS split steps of ``name`` over ``mesh`` on this rank's data slice,
    every rank but 0 starting from other weights (the split broadcasts rank
    0's): the losses, the gathered state, the REPORTED gradients of step 1,
    the recorded op calls, the local shapes and the plan."""
    from vit_tpu_torch.interop.checkpoint import full_state_dict
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    model = build(name)
    model.load_state_dict(data["state"])
    if rank:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    shard_params(mesh, model)
    optimizer = torch.optim.SGD(model.parameters(), lr=MODELS[name][3])
    step = make_train_step(model, optimizer, mesh=mesh)
    d_rank = rank // mesh.shape[1]
    images, labels = (data_slice(data[k], d_rank, tuple(mesh.shape))
                      for k in ("images", "labels"))
    calls, losses, grads = [], [], {}
    with kernel_route(calls) if kernels else contextlib.nullcontext():
        for i in range(STEPS):
            losses.append(float(step(images, labels)["loss"]))
            if i == 0:
                grads = reported(model)
    plan = model.tensor_parallel
    return model, optimizer, {
        "losses": losses, "state": full_state_dict(model), "grads": grads, "calls": calls,
        "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
        "kinds": dict(plan.kinds), "whole": list(plan.whole),
        "replicated": list(plan.replicated)}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    import vit_tpu_torch
    from vit_tpu_torch.interop.checkpoint import CheckpointManager
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import TrainState

    torch.set_num_threads(1)
    results = {}
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=60) == (rank, world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        mesh = make_mesh(MESH, device_type="cpu")
        for tag in (*MODELS, *(f"{k} kernels" for k in KERNEL_ROUTE)):
            name = tag.removesuffix(" kernels")
            model, optimizer, results[tag] = split_run(name, mesh, inputs[name], rank,
                                                       kernels=tag.endswith("kernels"))
            if tag == CHECKPOINTED:
                CheckpointManager(os.path.join(workdir, f"ckpt {tag}"), max_to_keep=1).save(
                    STEPS, TrainState(model, optimizer, STEPS))

        wide = make_mesh(WIDE, device_type="cpu")
        for name in MODELS:
            results[f"{name} tp 4"] = split_run(name, wide, inputs[name], rank)[2]

        results["one process"] = {name: one_process(name, inputs[name])
                                  for i, name in enumerate(MODELS) if i % world == rank}
        three = shard_params(mesh, vit_tpu_torch.NesT(**NEST_THREE_HEADS, device="cpu"))
        results["nest three heads"] = {"whole": list(three.tensor_parallel.whole),
                                       "kinds": dict(three.tensor_parallel.kinds)}
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
