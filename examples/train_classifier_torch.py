"""End-to-end classifier training with the PyTorch port: process group, mesh,
data-parallel train step, prefetch, metrics, checkpoints and a serving
artifact, on synthetic data.

    python examples/train_classifier_torch.py --model vit --steps 50 --batch 64
    torchrun --nproc_per_node=4 examples/train_classifier_torch.py --model vit --bf16

One process per card: under ``torchrun`` every rank trains data-parallel
over the mesh's ``data`` axis, each on its ``batch / world`` slice of the
global batch; a plain ``python`` run is one process on one card.  ``--tp N``
lays a ``model`` axis of N under the data axis, as
``examples/train_classifier.py``'s: ``make_mesh((world // N, N))``, the
model split over each group of N consecutive ranks (``shard_params``, before
the optimizer), which feed one ``batch / (world / N)`` slice (the ViT only:
the others have no split form).  The models and their configurations are
``examples/train_classifier.py``'s.  Each data rank draws its dropout (and
CaiT's layer dropout) from a generator seeded from ``(42, data rank)``,
which the ranks of its model group share; the JAX example's replicated key
gives masks that these per-rank draws do not reproduce.  A split model
exports through an unsplit copy of its gathered weights.  ``--cpu`` runs the
same on the CPU (gloo ranks).

    torchrun --nproc_per_node=4 examples/train_classifier_torch.py --model vit --bf16 --tp 2
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch


def build_model(name: str, image_size: int, num_classes: int, compute_dtype, device):
    import vit_tpu_torch as vt

    kw = dict(compute_dtype=compute_dtype, device=device)
    registry = {
        "vit": lambda: vt.ViT(image_size=image_size, patch_size=16, num_classes=num_classes,
                              dim=384, depth=6, heads=6, mlp_dim=1536, dropout=0.1,
                              emb_dropout=0.1, **kw),
        "deepvit": lambda: vt.DeepViT(image_size=image_size, patch_size=16,
                                      num_classes=num_classes, dim=384, depth=6, heads=6,
                                      mlp_dim=1536, **kw),
        "cait": lambda: vt.CaiT(image_size=image_size, patch_size=16, num_classes=num_classes,
                                dim=384, depth=6, cls_depth=2, heads=6, mlp_dim=1536,
                                layer_dropout=0.05, **kw),
        "nest": lambda: vt.NesT(image_size=image_size, patch_size=4, num_classes=num_classes,
                                dim=96, heads=3, num_hierarchies=3, block_repeats=(2, 2, 4),
                                **kw),
    }
    return registry[name]()


def synthetic_batches(batch: int, image_size: int, num_classes: int, steps: int,
                      seed: int = 0):
    rng = np.random.RandomState(seed)
    for _ in range(steps):
        yield {
            "image": rng.randn(batch, image_size, image_size, 3).astype(np.float32),
            "label": rng.randint(0, num_classes, size=(batch,)),
        }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="vit")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=64, help="the global batch")
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--num-classes", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute with f32 parameters")
    ap.add_argument("--tp", type=int, default=1,
                    help="model-axis size (tensor parallel)")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches per step")
    ap.add_argument("--export", default=None,
                    help="write a baked serving artifact (torch.export) here at the end")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (gloo ranks)")
    args = ap.parse_args()

    from vit_tpu_torch.interop.checkpoint import CheckpointManager, full_state_dict
    from vit_tpu_torch.parallel import mesh as mesh_lib
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.train import make_train_step
    from vit_tpu_torch.utils.data import (
        ThreadedLoader, prefetch, process_local_batch_size, shard_batch,
    )
    from vit_tpu_torch.utils.metrics import MetricLogger

    rank, world = mesh_lib.initialize_distributed(backend="gloo" if args.cpu else None)
    device = torch.device("cpu") if args.cpu else torch.device("cuda", torch.cuda.current_device())
    if world % args.tp:
        raise SystemExit(f"--tp {args.tp} does not divide {world} processes")
    dp = world // args.tp
    mesh = mesh_lib.make_mesh((dp, args.tp), device_type=device.type)
    compute_dtype = torch.bfloat16 if args.bf16 else None
    # The ranks of one model group feed the same slice of the global batch.
    data_rank = rank // args.tp
    local_batch = process_local_batch_size(args.batch) * args.tp
    if rank == 0:
        print(f"processes={world} mesh=dp{dp}xtp{args.tp} device={device.type} "
              f"compute={'bfloat16' if args.bf16 else 'float32'}", flush=True)

    # Every rank builds the same initial weights; the step broadcasts rank 0's.
    torch.manual_seed(0)
    model = build_model(args.model, args.image_size, args.num_classes, compute_dtype, device)
    if rank == 0:
        n_params = sum(p.numel() for p in model.parameters())
        print(f"model={args.model} params={n_params / 1e6:.1f}M", flush=True)
    shard_params(mesh, model)  # in place, before the optimizer: a no-op at --tp 1

    optimizer = torch.optim.AdamW(model.parameters(), lr=args.lr, weight_decay=1e-4)
    step_fn = make_train_step(model, optimizer, accum_steps=args.accum, mesh=mesh)
    ckpt_mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    # Per-rank draws: the device's default generator (the modules' dropout)
    # and one passed to the step (the models that take a generator).
    seed = 42 * 1_000_003 + data_rank
    torch.manual_seed(seed)
    generator = torch.Generator(device=device).manual_seed(seed)

    def local_slice(i):
        batch = next(host)
        return {k: v[data_rank * local_batch:(data_rank + 1) * local_batch]
                for k, v in batch.items()}

    host = synthetic_batches(args.batch, args.image_size, args.num_classes, args.steps)
    logger = MetricLogger(every=args.log_every, stream=sys.stdout)
    batches = prefetch(iter(ThreadedLoader(local_slice, args.steps)), size=2,
                       device_put=functools.partial(shard_batch, mesh=mesh, device=device))
    for i, batch in enumerate(batches):
        metrics = step_fn(batch["image"], batch["label"], generator=generator)
        if rank == 0:
            logger.log(i + 1, {"loss": metrics["loss"]})
        if ckpt_mgr is not None and (i + 1) % 50 == 0:
            # async: the write overlaps the next training steps
            ckpt_mgr.save(i + 1, step_fn.state, wait=False)
    if ckpt_mgr is not None:
        if step_fn.state.step % 50:
            ckpt_mgr.save(step_fn.state.step, step_fn.state, wait=False)
        ckpt_mgr.wait()
    if rank == 0:
        logger.flush()
    serving = model
    if args.export and args.tp > 1:  # a split model exports through an unsplit copy
        weights = full_state_dict(model)
        if rank == 0:
            torch.manual_seed(0)
            serving = build_model(args.model, args.image_size, args.num_classes, compute_dtype,
                                  device)
            serving.load_state_dict(weights)
    if args.export and rank == 0:
        from vit_tpu_torch.interop.export import save_forward

        save_forward(args.export, serving,
                     (local_batch, args.image_size, args.image_size, 3),
                     dtype=compute_dtype or torch.float32, bake_params=True)
        print(f"serving artifact: {args.export}", flush=True)
    if world > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    if rank == 0:
        print("done", flush=True)


if __name__ == "__main__":
    main()
