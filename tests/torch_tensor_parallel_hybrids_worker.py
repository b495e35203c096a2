"""The ranks of ``test_torch_tensor_parallel_hybrids.py``: four spawned
processes on the CPU (gloo) over a (2, 2) ``data`` x ``model`` mesh, each
training its data rank's slice of the batch with its model rank's slice of
Twins-SVT, CvT, LeViT (two configurations) and MobileViT, then Twins-SVT,
CvT and LeViT with dropout, then each a share of the one-process
references, and writing what it saw to ``rank<r>.pt`` in the test's
directory.  Imports no JAX, so that a rank starts in seconds; pytest does
not collect it."""

import contextlib
import os
import traceback

import torch

MESH = (2, 2)
STEPS = 2
BATCH = 8
# tests/multidevice/test_sharded_train.py's configurations: (class, constructor
# arguments, image side, SGD rate); the rates are vit_tpu's there (Twins-SVT's
# 1e-3 keeps its step out of the divergent regime it notes at 1e-2).
TWINS = dict(num_classes=6, s1_emb_dim=32, s1_patch_size=4, s1_local_patch_size=4,
             s1_global_k=4, s1_depth=1, s2_emb_dim=32, s2_patch_size=2, s2_local_patch_size=4,
             s2_global_k=4, s2_depth=1, s3_emb_dim=32, s3_patch_size=2, s3_local_patch_size=2,
             s3_global_k=2, s3_depth=1, s4_emb_dim=32, s4_patch_size=2, s4_local_patch_size=2,
             s4_global_k=2, s4_depth=1)
CVT = dict(num_classes=6, s1_emb_dim=32, s1_heads=1, s1_depth=1, s2_emb_dim=48, s2_heads=2,
           s2_depth=1, s3_emb_dim=64, s3_heads=2, s3_depth=1)
LEVIT = dict(image_size=32, num_classes=6, stages=1, dim=32, depth=1, heads=2, mlp_mult=2,
             dim_key=8, dim_value=16)
LEVIT_AUDIT = dict(image_size=64, num_classes=5, stages=2, dim=(32, 48), depth=1, heads=(2, 3),
                   mlp_mult=2, dim_key=8, dim_value=16)
MOBILEVIT = dict(image_size=(64, 64), dims=(16, 24, 32),
                 channels=(8, 8, 12, 12, 16, 16, 24, 24, 32, 32, 48), num_classes=6)
MODELS = {
    "twins": ("TwinsSVT", TWINS, 64, 1e-3),
    "cvt": ("CvT", CVT, 64, 1e-3),
    "levit": ("LeViT", LEVIT, 32, 1e-2),
    "levit audit": ("LeViT", LEVIT_AUDIT, 64, 1e-2),
    "mobilevit": ("MobileViT", MOBILEVIT, 64, 1e-3),
}
CHECKPOINTED = ("twins", "levit audit")
# Dropout under the model axis: each rank feeds data rank 0's slice and
# draws from one seed, so the split step equals the one-process step on that
# slice with that generator (synchronised BatchNorm over two equal halves
# takes that slice's statistics).  CvT's one-head stage 1 runs whole.
DROPOUT = ("twins", "cvt", "levit")
DROPOUT_RATE, DROPOUT_SEED = 0.1, 7
# CvT-13's heads (1, 3, 6) at narrow widths: stages 1-2 run whole at tp 2.
CVT13_HEADS = dict(num_classes=5, s1_emb_dim=16, s2_emb_dim=24, s3_emb_dim=48, s2_depth=1,
                   s3_depth=1)
# What shard_params still refuses, each at its own test's configuration:
# (class, or module.class, in vit_tpu_torch; constructor arguments).
REFUSED = {
    "hybrid tier": ("ViT", dict(image_size=32, patch_size=8, num_classes=10, dim=64, depth=2,
                                heads=2, mlp_dim=128, dim_head=32, fused_attention="hybrid")),
    "ScalableViT": ("ScalableViT", dict(num_classes=10, dim=32, depth=(1, 1), heads=(2, 2),
                                        reduction_factor=(4, 2), window_size=(8, None),
                                        ssa_dim_key=(40, 40), ssa_dim_value=(32, 32))),
    "ATS-ViT": ("ats_vit.ViT", dict(image_size=64, patch_size=8, num_classes=13, dim=64,
                                    depth=3, max_tokens_per_depth=(32, 16, 8), heads=2,
                                    mlp_dim=128, dim_head=32)),
    "CCT": ("CCT", dict(img_size=32, embedding_dim=32, n_conv_layers=2, kernel_size=3,
                        stride=1, in_planes=8, num_layers=2, num_heads=2, mlp_ratio=2.0,
                        num_classes=5)),
    "T2T-ViT": ("T2TViT", dict(image_size=32, num_classes=10, dim=64, depth=2, heads=2,
                               mlp_dim=128, dim_head=32)),
}


def data_slice(t, data_rank):
    size = t.shape[0] // MESH[0]
    return t[data_rank * size:(data_rank + 1) * size]


def build(name, **kw):
    """A CPU model of ``MODELS[name]``'s class and configuration."""
    import vit_tpu_torch

    cls, cfg, _, _ = MODELS[name]
    return getattr(vit_tpu_torch, cls)(**cfg, device="cpu", **kw)


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
    """:func:`one_process` at :data:`DROPOUT_RATE` on data rank 0's slice,
    each step drawing from a generator seeded :data:`DROPOUT_SEED`, and the
    first loss at rate 0 on that slice."""
    from vit_tpu_torch.parallel.train import make_train_step

    images, labels = (data_slice(data[k], 0) for k in ("images", "labels"))
    out = {}
    for rate in (0.0, DROPOUT_RATE):
        model = build(name, dropout=rate)
        model.load_state_dict(data["state"])
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=MODELS[name][3]))
        g = torch.Generator().manual_seed(DROPOUT_SEED)
        out[rate] = [float(step(images, labels, generator=g)["loss"]) for _ in range(STEPS)]
    return {"losses": out[DROPOUT_RATE], "state": model.state_dict(), "rate 0": out[0.0][0]}


def refused(name):
    """A CPU model of ``REFUSED[name]``."""
    import vit_tpu_torch

    path, cfg = REFUSED[name]
    module, _, cls = path.rpartition(".")
    owner = getattr(vit_tpu_torch, module) if module else vit_tpu_torch
    return getattr(owner, cls)(**cfg, device="cpu")


def _refusal(fn) -> str:
    try:
        fn()
    except (NotImplementedError, ValueError) as e:
        return f"{type(e).__name__}: {e}"
    return "no error"


@contextlib.contextmanager
def kernel_route(calls):
    """Twins-SVT's kernel route on the CPU (``kernel_activation`` accepting
    any tensor in ``layers.common`` and ``models.twins_svt``), each call into
    the block ops recorded with whether it passed a model group."""
    from vit_tpu_torch.layers import common
    from vit_tpu_torch.models import twins_svt

    saved = (common.kernel_activation, twins_svt.kernel_activation, common.fused_mlp,
             twins_svt.fused_attention_block, twins_svt.fused_cross_attention)

    def record(name, op):
        def call(*args, group=None, **kwargs):
            calls.append((name, group is not None))
            return op(*args, group=group, **kwargs)
        return call

    common.kernel_activation = twins_svt.kernel_activation = lambda x: True
    common.fused_mlp = record("mlp", saved[2])
    twins_svt.fused_attention_block = record("local", saved[3])
    twins_svt.fused_cross_attention = record("global", saved[4])
    try:
        yield
    finally:
        (common.kernel_activation, twins_svt.kernel_activation, common.fused_mlp,
         twins_svt.fused_attention_block, twins_svt.fused_cross_attention) = saved


def run(rank: int, world: int, port: int, workdir: str) -> None:
    import torch.distributed as dist

    import vit_tpu_torch
    from vit_tpu_torch.interop.checkpoint import CheckpointManager, full_state_dict
    from vit_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import TrainState, bn_state_shardings, make_train_step

    torch.set_num_threads(1)
    results = {}
    assert initialize_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  timeout_s=60) == (rank, world)
    try:
        inputs = torch.load(os.path.join(workdir, "inputs.pt"), weights_only=True)
        mesh = make_mesh(MESH, device_type="cpu")
        d_rank = rank // MESH[1]

        for tag in (*MODELS, "twins kernels"):
            name = tag.replace(" kernels", "")
            data = inputs[name]
            model = build(name)
            model.load_state_dict(data["state"])
            if rank:  # the ranks must start from rank 0's weights
                with torch.no_grad():
                    for p in model.parameters():
                        p.add_(1.0)
            shard_params(mesh, model)
            optimizer = torch.optim.SGD(model.parameters(), lr=MODELS[name][3])
            step = make_train_step(model, optimizer, mesh=mesh)
            images, labels = (data_slice(data[k], d_rank) for k in ("images", "labels"))
            calls = []
            with kernel_route(calls) if tag.endswith("kernels") else contextlib.nullcontext():
                losses = [float(step(images, labels)["loss"]) for _ in range(STEPS)]
            plan = model.tensor_parallel
            results[tag] = {
                "losses": losses, "state": full_state_dict(model), "calls": calls,
                "local": {k: tuple(v.shape) for k, v in model.state_dict().items()},
                "kinds": dict(plan.kinds), "whole": list(plan.whole)}
            if name == "levit audit" and not tag.endswith("kernels"):
                placed = bn_state_shardings(mesh, TrainState(model, optimizer, STEPS))
                results[tag]["placements"] = {
                    k: [str(p) for p in v] for part in ("params", "model_state")
                    for k, v in placed[part].items()}
            if tag in CHECKPOINTED:
                CheckpointManager(os.path.join(workdir, f"ckpt {tag}"), max_to_keep=1).save(
                    STEPS, TrainState(model, optimizer, STEPS))

        def dropout_step(name):
            model = build(name, dropout=DROPOUT_RATE)
            model.load_state_dict(inputs[name]["state"])
            shard_params(mesh, model)
            return model, make_train_step(model, torch.optim.SGD(model.parameters(),
                                                                 lr=MODELS[name][3]), mesh=mesh)

        for name in DROPOUT:
            images, labels = (data_slice(inputs[name][k], 0) for k in ("images", "labels"))
            model, step = dropout_step(name)
            g = torch.Generator().manual_seed(DROPOUT_SEED)
            losses = [float(step(images, labels, generator=g)["loss"]) for _ in range(STEPS)]
            results[f"{name} dropout"] = {"losses": losses, "state": full_state_dict(model)}
        # CvT's first active dropout is its whole stage-1 attention's.
        _, step = dropout_step("cvt")
        images, labels = (data_slice(inputs["cvt"][k], 0) for k in ("images", "labels"))
        results["dropout without a generator"] = _refusal(lambda: step(images, labels))

        # The one-process steps on the whole batch, each model on one rank.
        results["one process"] = {name: one_process(name, inputs[name])
                                  for i, name in enumerate(MODELS) if i % world == rank}
        results["one process dropout"] = {
            name: one_process_dropout(name, inputs[name])
            for i, name in enumerate(DROPOUT) if (i + len(MODELS)) % world == rank}
        cvt13 = shard_params(mesh, vit_tpu_torch.CvT(**CVT13_HEADS, device="cpu"))
        results["cvt13 whole"] = list(cvt13.tensor_parallel.whole)
        results["refusals"] = {name: _refusal(lambda: shard_params(mesh, refused(name)))
                               for name in REFUSED}
    except BaseException:
        results["error"] = traceback.format_exc()
        raise
    finally:
        torch.save(results, os.path.join(workdir, f"rank{rank}.pt"))
        if dist.is_initialized():
            dist.destroy_process_group()
