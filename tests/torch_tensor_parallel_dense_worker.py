"""The ranks of ``test_torch_tensor_parallel_dense.py``: four spawned
processes on the CPU (gloo), each training its slice of CaiT, DeepViT,
Parallel ViT, the patch merger's ViT and CrossViT over a (2, 2) ``data`` x
``model`` mesh (DeepViT, the merger's ViT and CrossViT also on their split
Functions' kernel route), then each model over a (1, 4) mesh, then each at
dropout 0.1 with a generator per data rank, then a share of the one-process
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
# Each model's own test's configuration (tests/test_torch_cait.py,
# test_torch_deepvit.py, test_torch_parallel_vit.py, test_torch_patch_merger.py,
# test_torch_cross_vit.py): (class, constructor arguments, image side, SGD rate).
CAIT = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=3, cls_depth=2, heads=4,
            dim_head=8, mlp_dim=64)
DEEPVIT = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=4, dim_head=8,
               mlp_dim=64)
PARALLEL_VIT = dict(image_size=32, patch_size=8, num_classes=5, dim=32, depth=2, heads=4,
                    dim_head=8, mlp_dim=64)
PATCH_MERGER = dict(image_size=32, patch_size=4, num_classes=5, dim=32, depth=4, heads=2,
                    dim_head=16, mlp_dim=64, patch_merge_layer=2, patch_merge_num_tokens=3)
CROSSVIT = dict(image_size=32, num_classes=5, sm_dim=16, lg_dim=24, sm_patch_size=4,
                lg_patch_size=16, sm_enc_depth=1, sm_enc_heads=2, sm_enc_mlp_dim=32,
                sm_enc_dim_head=8, lg_enc_depth=2, lg_enc_heads=2, lg_enc_mlp_dim=32,
                lg_enc_dim_head=8, cross_attn_depth=1, cross_attn_heads=2, cross_attn_dim_head=8,
                depth=2, dropout=0.0, emb_dropout=0.0)
MODELS = {
    "cait": ("CaiT", CAIT, 32, 1e-2),
    "deepvit": ("DeepViT", DEEPVIT, 32, 1e-2),
    "parallel vit": ("parallel_vit.ViT", PARALLEL_VIT, 32, 1e-2),
    "patch merger": ("vit_with_patch_merger.ViT", PATCH_MERGER, 32, 1e-2),
    "crossvit": ("CrossViT", CROSSVIT, 32, 1e-2),
}
KERNEL_ROUTE = ("deepvit", "patch merger", "crossvit")
CHECKPOINTED = "cait"
# Dropout under the model axis: every dropout at 0.1 (CaiT's layer dropout
# too), each data rank's forward drawing from its own seed.
DROPOUT = dict(dropout=0.1, emb_dropout=0.1)
DROPOUT_EXTRA = {"cait": dict(layer_dropout=0.2)}
DROPOUT_SEED = 29


def model_class(name):
    import vit_tpu_torch

    module, _, cls = MODELS[name][0].rpartition(".")
    owner = getattr(vit_tpu_torch, module) if module else vit_tpu_torch
    return getattr(owner, cls)


def build(name, **kw):
    """A CPU model of ``MODELS[name]``'s class and configuration."""
    return model_class(name)(**{**MODELS[name][1], **kw}, device="cpu")


def dropout_kw(name) -> dict:
    return {**DROPOUT, **DROPOUT_EXTRA.get(name, {})}


def data_slice(t, data_rank, mesh=MESH):
    size = t.shape[0] // mesh[0]
    return t[data_rank * size:(data_rank + 1) * size]


def one_process(name, data):
    """The port's one-process SGD steps on the whole batch from ``data``'s
    weights: the losses and the state after them."""
    from vit_tpu_torch.parallel.train import make_train_step

    model = build(name)
    model.load_state_dict(data["state"])
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=MODELS[name][3]))
    losses = [float(step(data["images"], data["labels"])["loss"]) for _ in range(STEPS)]
    return {"losses": losses, "state": model.state_dict()}


def one_process_dropout(name, data):
    """:func:`one_process` with every dropout active: each step the mean loss
    of the data ranks' slices, each forward drawing from its own generator
    (one a data rank), as the split step computes it."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    model = build(name, **dropout_kw(name))
    model.load_state_dict(data["state"])
    optimizer = torch.optim.SGD(model.parameters(), lr=MODELS[name][3])
    gens = [torch.Generator().manual_seed(DROPOUT_SEED + d) for d in range(MESH[0])]
    losses = []
    for _ in range(STEPS):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = sum(cross_entropy_loss(model(data_slice(data["images"], d), generator=g),
                                      data_slice(data["labels"], d))
                   for d, g in enumerate(gens)) / len(gens)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    return {"losses": losses, "state": model.state_dict()}


@contextlib.contextmanager
def kernel_route(calls):
    """The fused MLP's route on the CPU (``kernel_activation`` accepting any
    tensor in ``layers.common``), each call recorded with whether it passed
    a model group."""
    from vit_tpu_torch.layers import common

    saved = (common.kernel_activation, common.fused_mlp)

    def call(*args, group=None, **kwargs):
        calls.append(("fused_mlp", group is not None))
        return saved[1](*args, group=group, **kwargs)

    common.kernel_activation, common.fused_mlp = (lambda x: True), call
    try:
        yield
    finally:
        common.kernel_activation, common.fused_mlp = saved


def _refusal(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


def split_run(name, mesh, data, rank, kernels=False, dropout=False):
    """STEPS split steps of ``name`` over ``mesh`` on this rank's data slice,
    every rank but 0 starting from other weights (the split broadcasts rank
    0's): the losses, the gathered state, the recorded op calls, the local
    shapes and the plan; with ``dropout``, every dropout active and one
    generator a data rank."""
    from vit_tpu_torch.interop.checkpoint import full_state_dict
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    model = build(name, **(dropout_kw(name) if dropout else {}))
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
    g = torch.Generator().manual_seed(DROPOUT_SEED + d_rank) if dropout else None
    calls = []
    with kernel_route(calls) if kernels else contextlib.nullcontext():
        losses = [float(step(images, labels, generator=g)["loss"]) for _ in range(STEPS)]
    plan = model.tensor_parallel
    return model, optimizer, {
        "losses": losses, "state": full_state_dict(model), "calls": calls,
        "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
        "kinds": dict(plan.kinds), "whole": list(plan.whole),
        "heads": {k: m.heads for k, m in model.named_modules() if hasattr(m, "heads")}}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vit_tpu_torch.interop.checkpoint import CheckpointManager
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import TrainState, make_train_step

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
        for name in MODELS:
            results[f"{name} dropout"] = split_run(name, mesh, inputs[name], rank,
                                                   dropout=True)[2]
            model = shard_params(mesh, build(name, **dropout_kw(name)))
            step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                   mesh=mesh)
            images, labels = (data_slice(inputs[name][k], rank // MESH[1])
                              for k in ("images", "labels"))
            results[f"{name} without a generator"] = _refusal(lambda: step(images, labels))

        jobs = [(name, one_process) for name in MODELS] + \
            [(f"{name} dropout", one_process_dropout) for name in MODELS]
        results["one process"] = {tag: fn(tag.removesuffix(" dropout"),
                                          inputs[tag.removesuffix(" dropout")])
                                  for i, (tag, fn) in enumerate(jobs) if i % world == rank}
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
