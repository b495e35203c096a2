"""The ranks of ``test_torch_tensor_parallel_rest.py``: four spawned
processes on the CPU (gloo), each training its slice of ATS-ViT, CCT,
ScalableViT and T2T-ViT over a (2, 2) ``data`` x ``model`` mesh (ATS-ViT,
ScalableViT and T2T-ViT also on their split Functions' kernel route), then
each model over a (1, 4) mesh, then each at dropout 0.1 with a generator
per data rank, then a share of the one-process references, and writing what
it saw to ``rank<r>.pt`` in the test's directory.  ATS-ViT draws its Gumbel
noise from :func:`gumbel_table` (the rows of the whole batch's table that
its data slice holds), as the test injects it into ``vit_tpu``.  Imports no
JAX, so that a rank starts in seconds; pytest does not collect it."""

import contextlib
import os
import traceback

import numpy as np
import torch

MESH = (2, 2)
WIDE = (1, 4)
STEPS = 2
BATCH = 8
# Each model's own test's configuration (tests/test_torch_ats_vit.py,
# test_torch_cct.py at its rates 0, test_torch_scalable_vit.py,
# test_torch_t2t.py): (class, constructor arguments, image side, SGD rate).
ATS = dict(image_size=64, patch_size=8, num_classes=13, dim=64, depth=3,
           max_tokens_per_depth=(32, 16, 8), heads=2, mlp_dim=128, dim_head=32)
CCT = dict(img_size=32, embedding_dim=32, n_conv_layers=2, kernel_size=3, stride=1, in_planes=8,
           num_layers=2, num_heads=2, mlp_ratio=2.0, num_classes=5, attention_dropout=0.0,
           stochastic_depth_rate=0.0)
SCALABLE = dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 2), reduction_factor=(4, 2),
                window_size=(8, None), ssa_dim_key=(40, 40), ssa_dim_value=(32, 32))
T2T = dict(image_size=32, num_classes=10, dim=64, depth=2, heads=2, mlp_dim=128, dim_head=32)
MODELS = {
    "ats": ("ats_vit.ViT", ATS, 64, 1e-2),
    "cct": ("CCT", CCT, 32, 1e-2),
    "scalable": ("ScalableViT", SCALABLE, 64, 1e-2),
    "t2t": ("T2TViT", T2T, 32, 1e-2),
}
# Built for the units test only: T2T-ViT's distillation student.
EXTRA = {"distill t2t": ("DistillableT2TViT", T2T)}
KERNEL_ROUTE = {"ats": dict(fused_mlp="auto"), "scalable": {}, "t2t": {}}
# Dropout under the model axis: every dropout at 0.1 (CCT's attention
# dropout and stochastic depth too), each data rank's forward drawing from
# its own seed.
DROPOUT = {"ats": dict(dropout=0.1, emb_dropout=0.1),
           "cct": dict(dropout_rate=0.1, attention_dropout=0.1, stochastic_depth_rate=0.1),
           "scalable": dict(dropout=0.1), "t2t": dict(dropout=0.1, emb_dropout=0.1)}
DROPOUT_SEED = 31
# The row of the whole batch's Gumbel table where this process's forward
# starts (its data slice's first image).
GUMBEL_ROW = [0]


def gumbel_table(shape) -> np.ndarray:
    """One Gumbel table for each shape ``(b, k, n)``, from a seed the shape
    gives (``test_torch_ats_vit.py``'s)."""
    b, k, n = (int(s) for s in shape)
    u = np.random.default_rng(1_000_000 * b + 1000 * k + n).uniform(1e-3, 1 - 1e-3, (b, k, n))
    return (-np.log(-np.log(u + 1e-6) + 1e-6)).astype(np.float32)


def _sample_gumbel(generator, shape, eps=1e-6):
    """The rows of ``gumbel_table((BATCH, k, n))`` of this forward's images."""
    b, k, n = shape
    row = GUMBEL_ROW[0]
    return torch.from_numpy(gumbel_table((BATCH, k, n))[row:row + b])


def model_class(name):
    import vit_tpu_torch

    module, _, cls = {**MODELS, **EXTRA}[name][0].rpartition(".")
    owner = getattr(vit_tpu_torch, module) if module else vit_tpu_torch
    return getattr(owner, cls)


def build(name, **kw):
    """A CPU model of ``MODELS[name]``'s (or ``EXTRA[name]``'s) class and
    configuration."""
    return model_class(name)(**{**{**MODELS, **EXTRA}[name][1], **kw}, device="cpu")


def data_slice(t, data_rank, mesh=MESH):
    size = t.shape[0] // mesh[0]
    return t[data_rank * size:(data_rank + 1) * size]


def sampled_ids(model, images):
    """ATS-ViT's ids after its last layer, in eval."""
    was = model.training
    with torch.no_grad():
        ids = model.eval()(images, return_sampled_token_ids=True)[1]
    model.train(was)
    return ids


def one_process(name, data):
    """The port's one-process SGD steps on the whole batch from ``data``'s
    weights: the losses and the state after them (ATS-ViT's sampled ids
    before them)."""
    from vit_tpu_torch.parallel.train import make_train_step

    model = build(name)
    model.load_state_dict(data["state"])
    GUMBEL_ROW[0] = 0
    ids = sampled_ids(model, data["images"]) if name == "ats" else None
    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=MODELS[name][3]))
    losses = [float(step(data["images"], data["labels"])["loss"]) for _ in range(STEPS)]
    return {"losses": losses, "state": model.state_dict(), "ids": ids}


def one_process_dropout(name, data):
    """:func:`one_process` with every dropout active: each step the mean loss
    of the data ranks' slices, each forward drawing from its own generator
    (one a data rank), as the split step computes it."""
    from vit_tpu_torch.parallel.train import cross_entropy_loss

    model = build(name, **DROPOUT[name])
    model.load_state_dict(data["state"])
    optimizer = torch.optim.SGD(model.parameters(), lr=MODELS[name][3])
    gens = [torch.Generator().manual_seed(DROPOUT_SEED + d) for d in range(MESH[0])]
    losses = []
    for _ in range(STEPS):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = 0.0
        for d, g in enumerate(gens):
            images = data_slice(data["images"], d)
            GUMBEL_ROW[0] = d * images.shape[0]
            loss = loss + cross_entropy_loss(model(images, generator=g),
                                             data_slice(data["labels"], d))
        loss = loss / len(gens)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    return {"losses": losses, "state": model.state_dict()}


@contextlib.contextmanager
def kernel_route(calls):
    """The split Functions' route on the CPU (``kernel_activation``
    accepting any tensor in ``layers.common`` and ``models.scalable_vit``),
    each call into the block ops recorded with whether it passed a model
    group."""
    from vit_tpu_torch.layers import common
    from vit_tpu_torch.models import scalable_vit

    saved = (common.kernel_activation, scalable_vit.kernel_activation, common.fused_mlp,
             common.fused_attention_block, scalable_vit.fused_cross_attention)

    def record(name, op):
        def call(*args, group=None, **kwargs):
            calls.append((name, group is not None))
            return op(*args, group=group, **kwargs)
        return call

    common.kernel_activation = scalable_vit.kernel_activation = lambda x: True
    common.fused_mlp = record("mlp", saved[2])
    common.fused_attention_block = record("attention", saved[3])
    scalable_vit.fused_cross_attention = record("ssa", saved[4])
    try:
        yield
    finally:
        (common.kernel_activation, scalable_vit.kernel_activation, common.fused_mlp,
         common.fused_attention_block, scalable_vit.fused_cross_attention) = saved


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
    shapes and the plan (ATS-ViT's sampled ids before the steps); with
    ``dropout``, every dropout active and one generator a data rank."""
    from vit_tpu_torch.interop.checkpoint import full_state_dict
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    kw = {**(DROPOUT[name] if dropout else {}), **(KERNEL_ROUTE[name] if kernels else {})}
    model = build(name, **kw)
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
    GUMBEL_ROW[0] = d_rank * images.shape[0]
    ids = sampled_ids(model, images) if name == "ats" else None
    g = torch.Generator().manual_seed(DROPOUT_SEED + d_rank) if dropout else None
    calls = []
    with kernel_route(calls) if kernels else contextlib.nullcontext():
        losses = [float(step(images, labels, generator=g)["loss"]) for _ in range(STEPS)]
    plan = model.tensor_parallel
    return {"losses": losses, "state": full_state_dict(model), "calls": calls,
            "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
            "kinds": dict(plan.kinds), "whole": list(plan.whole),
            "replicated": list(plan.replicated), "ids": (GUMBEL_ROW[0], ids),
            "heads": {k: m.heads for k, m in model.named_modules() if hasattr(m, "heads")}}


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    from vit_tpu_torch.models import ats_vit
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step

    torch.set_num_threads(1)
    ats_vit.sample_gumbel = _sample_gumbel
    results = {}
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=60) == (rank, world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        mesh = make_mesh(MESH, device_type="cpu")
        for tag in (*MODELS, *(f"{k} kernels" for k in KERNEL_ROUTE)):
            name = tag.removesuffix(" kernels")
            results[tag] = split_run(name, mesh, inputs[name], rank,
                                     kernels=tag.endswith("kernels"))
        wide = make_mesh(WIDE, device_type="cpu")
        for name in MODELS:
            results[f"{name} tp 4"] = split_run(name, wide, inputs[name], rank)
        for name in MODELS:
            results[f"{name} dropout"] = split_run(name, mesh, inputs[name], rank, dropout=True)
            model = shard_params(mesh, build(name, **DROPOUT[name]))
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
