"""Tensor parallelism in the port, on the CPU.

- The rule table (``vit_tpu_torch.parallel.sharding.param_specs``) against
  ``vit_tpu``'s on the five models of
  ``tests/multidevice/test_sharded_train.py::test_sharding_rules_cover_the_zoo``:
  each Flax leaf drawn with its sharded axis numbered (zeros elsewhere),
  carried to the port's names and layouts by ``state_dict_from_flax``, so
  that the axis along which a port parameter varies is the one ``vit_tpu``
  shards.
- The split ops in one process: t in {2, 4} ranks emulated by slicing the
  weights, summing the ranks' f32 partials and ending the block with the
  pass (forward) or the LayerNorm backward (backward), held within 1e-5 of
  the unsplit plain ops in f32, the gradients gathered, and within 1e-4 of
  ``vit_tpu``'s ``fused_attention_block`` / ``fused_mlp_3d`` in the Pallas
  interpreter.
- One spawn of four gloo ranks over a (2, 2) ``data`` x ``model`` mesh
  (``torch_tensor_parallel_worker.run``): the small ViT of
  ``test_sharded_train.py:20-26``, 2 steps of SGD(1e-2) on a batch of 8, on
  the plain modules and on the blocks' kernel route (their split
  Functions), losses and gathered parameters within 1e-5 of the port's
  one-process step and within 1e-4 of ``vit_tpu``'s ``make_train_step`` on a
  (2, 2) mesh of the virtual CPU devices, from the same Flax weights;
  dropout 0.1 with a generator per data rank against the one-process steps
  on the same slices and generators; MAE through ``make_loss_train_step``;
  ``shard_params``' refusal of the hybrid tier and the units it runs whole
  (three heads, a 24-wide MLP), ScalableViT split, each step against the
  one-process step; a one-process checkpoint restored into the
  split model and saved from it; the state's placements; the example
  trainer with ``--tp 2``.

The group has a 60 s timeout and the ranks a join deadline, as
``test_torch_distributed.py``'s, so a failed rank fails the test instead of
hanging it.
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

import torch_tensor_parallel_worker as worker  # noqa: E402
from torch_parity import loaded, random_variables  # noqa: E402
from vit_tpu.ops import fused_attention_block as jax_attn  # noqa: E402
from vit_tpu.ops import fused_mlp as jax_mlp  # noqa: E402
from vit_tpu_torch import MAE, ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.interop.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from vit_tpu_torch.ops import fused_attention_block as fab  # noqa: E402
from vit_tpu_torch.ops import fused_mlp as fm  # noqa: E402
from vit_tpu_torch.ops._shared import weight_grad  # noqa: E402
from vit_tpu_torch.ops.tensor_parallel import (  # noqa: E402
    bias_residual_reference, ln_backward_residual_reference,
)
from vit_tpu_torch.parallel import sharding  # noqa: E402
from vit_tpu_torch.parallel.train import (  # noqa: E402
    TrainState, cross_entropy_loss, make_train_step,
)

WORLD = 4
JOIN_TIMEOUT_S = 180
BATCH = 8
TOL, JAX_TOL = 1e-5, 1e-4


def _diff(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    got, want = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float64)
                 for t in (got, want))
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# --- the rule table ---------------------------------------------------------

ZOO = {
    "vit": ("ViT", dict(image_size=32, patch_size=8, num_classes=5, dim=64, depth=2, heads=2,
                        mlp_dim=128), (1, 32, 32, 3)),
    "cait": ("CaiT", dict(image_size=32, patch_size=8, num_classes=5, dim=64, depth=1,
                          cls_depth=1, heads=2, mlp_dim=128), (1, 32, 32, 3)),
    "cvt": ("CvT", dict(num_classes=5, s1_emb_dim=32, s1_heads=1, s1_depth=1, s2_emb_dim=48,
                        s2_heads=2, s2_depth=1, s3_emb_dim=64, s3_heads=2, s3_depth=1),
            (1, 64, 64, 3)),
    "twins": ("TwinsSVT", dict(num_classes=5, s1_emb_dim=32, s1_patch_size=4,
                               s1_local_patch_size=4, s1_global_k=4, s1_depth=1,
                               s2_emb_dim=32, s2_patch_size=2, s2_local_patch_size=4,
                               s2_global_k=4, s2_depth=1, s3_emb_dim=32, s3_patch_size=2,
                               s3_local_patch_size=2, s3_global_k=2, s3_depth=1,
                               s4_emb_dim=32, s4_patch_size=2, s4_local_patch_size=2,
                               s4_global_k=2, s4_depth=1), (1, 128, 128, 3)),
    "levit": ("LeViT", dict(image_size=64, num_classes=5, stages=2, dim=(32, 48), depth=1,
                            heads=(2, 3), mlp_mult=2, dim_key=8, dim_value=16), (1, 64, 64, 3)),
}


@pytest.mark.parametrize("name", list(ZOO))
def test_rule_table_matches_vit_tpu(name):
    import vit_tpu
    import vit_tpu_torch
    from torch.distributed.tensor import Replicate, Shard
    from vit_tpu.parallel.sharding import param_specs as jax_specs

    cls, cfg, shape = ZOO[name]
    params = jax.eval_shape(lambda a: getattr(vit_tpu, cls)(**cfg).init(
        jax.random.PRNGKey(0), a), jnp.zeros(shape))["params"]

    def numbered(leaf, spec):  # the sharded axis numbered from 1, zeros elsewhere
        axes = [i for i, a in enumerate(spec) if a is not None]
        if not axes:
            return np.zeros(leaf.shape, np.float32)
        index = np.arange(1, leaf.shape[axes[0]] + 1, dtype=np.float32)
        view = [1] * len(leaf.shape)
        view[axes[0]] = -1
        return np.broadcast_to(index.reshape(view), leaf.shape).copy()

    tree = state_dict_from_flax(jax.tree.map(numbered, params, jax_specs(params)))
    model = getattr(vit_tpu_torch, cls)(**cfg, device="cpu")
    specs = sharding.param_specs(model)
    assert set(specs) == set(tree), set(specs) ^ set(tree)
    shards = 0
    for key, spec in specs.items():
        arr = np.asarray(tree[key])
        varies = [a for a in range(arr.ndim) if arr.shape[a] > 1
                  and not np.all(arr == arr.take([0], axis=a))]
        want = Shard(varies[0]) if varies else Replicate()
        assert spec == want, f"{name} {key}: port {spec}, vit_tpu's {want}"
        shards += isinstance(spec, Shard)
    assert shards > 0


def test_param_shardings_over_the_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard

    model = ViT(**worker.SMALL_VIT, device="cpu")
    specs = sharding.param_specs(model)
    assert specs["transformer.layers.0.attn.to_qkv.weight"] == Shard(0)
    assert specs["transformer.layers.0.attn.to_out.0.weight"] == Shard(1)
    assert specs["transformer.layers.0.attn.to_out.0.bias"] == Replicate()
    assert specs["transformer.layers.1.mlp.fc1.bias"] == Shard(0)
    assert specs["transformer.layers.1.mlp.fc2.weight"] == Shard(1)
    assert specs["head.weight"] == specs["transformer.layers.0.attn_norm.weight"] == Replicate()
    assert sharding.param_shardings(None, model)["head.weight"] == (Replicate(),)


# --- the split ops, emulated in one process ---------------------------------

def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _join(pieces, kind):
    """The whole tensor from the ranks' slices (the inverse of
    ``sharding.shard_tensor``)."""
    shape = list(pieces[0].shape)
    shape[1 if kind == sharding.ROW else 0] *= len(pieces)
    full = torch.zeros(shape)
    for r, piece in enumerate(pieces):
        views, dim = sharding._views(full, kind, r, len(pieces))
        for view, part in zip(views, piece.split(views[0].shape[dim], dim)):
            view.copy_(part)
    return full


ATTN = (2, 17, 64, 4, 32)  # b, n, d, heads, dim_head: odd n, inner 128 over d 64
MLP = ((2, 17, 64), 128)


@pytest.mark.parametrize("t", [2, 4])
def test_split_attention_block_matches_unsplit_and_vit_tpu(t):
    b, n, d, heads, dh = ATTN
    rng = np.random.default_rng(t)
    inner = heads * dh
    flax = (_f32(rng, b, n, d), _f32(rng, d, scale=0.1, shift=1.0), _f32(rng, d, scale=0.1),
            _f32(rng, d, 3 * inner, scale=0.05), _f32(rng, inner, d, scale=0.05),
            _f32(rng, d, scale=0.05))
    dy = torch.from_numpy(_f32(rng, b, n, d))
    x, gamma, beta = (torch.from_numpy(a) for a in flax[:3])
    wqkv, wo, bo = torch.from_numpy(flax[3].T.copy()), torch.from_numpy(flax[4].T.copy()), \
        torch.from_numpy(flax[5])

    parts = []
    for r in range(t):
        w_r = (sharding.shard_tensor(wqkv, sharding.QKV, r, t),
               sharding.shard_tensor(wo, sharding.ROW, r, t))
        parts.append((w_r, fab.fused_attention_block_partial_forward_reference(
            x, gamma, beta, *w_r, heads // t, dh)))
    y = bias_residual_reference(sum(p[1][0] for p in parts), bo, x)
    xn = parts[0][1][1]
    backs = [fab.fused_attention_block_partial_backward_reference(
        dy, out[2], out[3], out[4], *w_r, heads // t, dh) for w_r, out in parts]
    dx, dgamma, dbeta, dbo = ln_backward_residual_reference(x, sum(bk[0] for bk in backs),
                                                            gamma, dy)
    dwqkv = _join([weight_grad(bk[1], xn) for bk in backs], sharding.QKV)
    dwo = _join([weight_grad(dy, out[3]) for _, out in parts], sharding.ROW)
    got = dict(y=y, dx=dx, dgamma=dgamma, dbeta=dbeta, dwqkv=dwqkv, dwo=dwo, dbo=dbo)

    y_ref, xn_ref, qkv, oattn = fab.fused_attention_block_forward_reference(
        x, gamma, beta, wqkv, wo, bo, heads, dh)
    dx_ref, dqkv, dgamma_ref, dbeta_ref, dbo_ref = fab.fused_attention_block_backward_reference(
        dy, x, qkv, gamma, wqkv, wo, heads, dh)
    want = dict(y=y_ref, dx=dx_ref, dgamma=dgamma_ref, dbeta=dbeta_ref,
                dwqkv=weight_grad(dqkv, xn_ref), dwo=weight_grad(dy, oattn), dbo=dbo_ref)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _diff(got[k], want[k]) <= TOL, (k, _diff(got[k], want[k]))

    y_jax, vjp = jax.vjp(lambda *a: jax_attn.fused_attention_block(*a, heads, dh, None, 1e-3,
                                                                   True), *map(jnp.asarray, flax))
    grads = vjp(jnp.asarray(dy.numpy()))
    assert _diff(y, y_jax) <= JAX_TOL
    for k, g in zip(("dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo"), grads):
        g = np.asarray(g)
        g = g.T if k in ("dwqkv", "dwo") else g
        assert _diff(got[k], g) <= JAX_TOL, (k, _diff(got[k], g))


@pytest.mark.parametrize("t", [2, 4])
def test_split_mlp_matches_unsplit_and_vit_tpu(t):
    shape, hidden = MLP
    d = shape[-1]
    rng = np.random.default_rng(10 + t)
    flax = (_f32(rng, *shape), _f32(rng, d, scale=0.1, shift=1.0), _f32(rng, d, scale=0.1),
            _f32(rng, d, hidden, scale=0.05), _f32(rng, hidden, scale=0.05),
            _f32(rng, hidden, d, scale=0.05), _f32(rng, d, scale=0.05))
    dy = torch.from_numpy(_f32(rng, *shape))
    x, gamma, beta = (torch.from_numpy(a) for a in flax[:3])
    w1, b1 = torch.from_numpy(flax[3].T.copy()), torch.from_numpy(flax[4])
    w2, b2 = torch.from_numpy(flax[5].T.copy()), torch.from_numpy(flax[6])

    parts = []
    for r in range(t):
        w_r = (sharding.shard_tensor(w1, sharding.COLUMN, r, t),
               sharding.shard_tensor(b1, sharding.COLUMN, r, t),
               sharding.shard_tensor(w2, sharding.ROW, r, t))
        parts.append((w_r, fm.fused_mlp_partial_forward_reference(x, gamma, beta, *w_r)))
    y = bias_residual_reference(sum(p[1][0] for p in parts), b2, x)
    xn = parts[0][1][1]
    backs = [fm.fused_mlp_partial_backward_reference(dy, out[2], w_r[0], w_r[2])
             for w_r, out in parts]
    dx, dgamma, dbeta, db2 = ln_backward_residual_reference(x, sum(bk[0] for bk in backs),
                                                            gamma, dy)
    got = dict(y=y, dx=dx, dgamma=dgamma, dbeta=dbeta,
               dw1=_join([weight_grad(bk[1], xn) for bk in backs], sharding.COLUMN),
               db1=_join([bk[3] for bk in backs], sharding.COLUMN),
               dw2=_join([weight_grad(dy, bk[2]) for bk in backs], sharding.ROW), db2=db2)

    y_ref, xn_ref, h = fm.fused_mlp_forward_reference(x, gamma, beta, w1, b1, w2, b2)
    dx_ref, dh, gact, dgamma_ref, dbeta_ref, db1_ref, db2_ref = \
        fm.fused_mlp_backward_reference(dy, x, h, gamma, w1, w2)
    want = dict(y=y_ref, dx=dx_ref, dgamma=dgamma_ref, dbeta=dbeta_ref,
                dw1=weight_grad(dh, xn_ref), db1=db1_ref, dw2=weight_grad(dy, gact), db2=db2_ref)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert _diff(got[k], want[k]) <= TOL, (k, _diff(got[k], want[k]))

    y_jax, vjp = jax.vjp(lambda *a: jax_mlp.fused_mlp_3d(*a, 1e-3, 64, True, "exact"),
                         *map(jnp.asarray, flax))
    grads = vjp(jnp.asarray(dy.numpy()))
    assert _diff(y, y_jax) <= JAX_TOL
    for k, g in zip(("dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"), grads):
        g = np.asarray(g)
        g = g.T if k in ("dw1", "dw2") else g
        assert _diff(got[k], g) <= JAX_TOL, (k, _diff(got[k], g))


# --- four gloo ranks over a (2, 2) mesh -------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _one_process(cfg, state, images, labels, seeds=None):
    """The port's one-process SGD(LR) steps on the whole batch; with
    ``seeds``, each step the mean loss of the data ranks' slices, each
    forward drawing from its own generator (one a data rank), as the split
    step computes it."""
    model = ViT(**cfg, device="cpu")
    model.load_state_dict(state)
    if seeds is None:
        step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=worker.LR))
        losses = [float(step(images, labels)["loss"]) for _ in range(worker.STEPS)]
        return {"losses": losses, "state": _state(model)}
    optimizer = torch.optim.SGD(model.parameters(), lr=worker.LR)
    gens = [torch.Generator().manual_seed(s) for s in seeds]
    losses = []
    for _ in range(worker.STEPS):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        loss = sum(cross_entropy_loss(model(worker.data_slice(images, d), generator=g),
                                      worker.data_slice(labels, d))
                   for d, g in enumerate(gens)) / len(gens)
        loss.backward()
        optimizer.step()
        losses.append(loss.item())
    return {"losses": losses, "state": _state(model)}


def _jax_steps(variables, images, labels):
    """``vit_tpu``'s ``make_train_step`` on a (2, 2) mesh of the virtual
    CPU devices, the parameters placed by its rule table."""
    from vit_tpu import ViT as JaxViT
    from vit_tpu.parallel import mesh as mesh_lib
    from vit_tpu.parallel import train as jax_train

    model, tx = JaxViT(**worker.SMALL_VIT), optax.sgd(worker.LR)
    mesh = mesh_lib.make_mesh(worker.MESH, devices=jax.devices()[:WORLD])
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
    mae = MAE(ViT(**worker.MAE_ENCODER, device="cpu"), decoder_dim=32, device="cpu")
    mae_images = torch.from_numpy(rng.standard_normal((4, 64, 64, 3)).astype(np.float32))
    inputs = {"images": torch.from_numpy(images), "labels": torch.from_numpy(labels).long(),
              "vit_state": vit_state, "mae_state": _state(mae), "mae_images": mae_images}
    workdir = tmp_path_factory.mktemp("ranks")
    torch.save(inputs, workdir / "inputs.pt")
    # A one-process checkpoint with optimizer state: one SGD step with momentum.
    one = ViT(**worker.SMALL_VIT, device="cpu")
    one.load_state_dict(vit_state)
    optimizer = torch.optim.SGD(one.parameters(), lr=worker.LR, momentum=0.9)
    make_train_step(one, optimizer)(inputs["images"], inputs["labels"])
    save_checkpoint(str(workdir / "one.pt"), TrainState(one, optimizer, 1))

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

    # MAE's one-process reference: the data ranks' slices, each masked from
    # its own generator, one SGD step on the mean loss.
    mae.train()
    mae_opt = torch.optim.SGD(mae.parameters(), lr=worker.LR)
    mae_loss = sum(mae(worker.data_slice(mae_images, d),
                       generator=torch.Generator().manual_seed(worker.MAE_SEED + d))
                   for d in range(worker.MESH[0])) / worker.MESH[0]
    mae_loss.backward()
    mae_opt.step()
    seeds = [worker.DROPOUT_SEED + d for d in range(worker.MESH[0])]
    return {"ranks": ranks, "workdir": workdir,
            "whole": _one_process(worker.SMALL_VIT, vit_state, inputs["images"],
                                  inputs["labels"]),
            "dropout": _one_process(worker.DROPOUT_VIT, vit_state, inputs["images"],
                                    inputs["labels"], seeds),
            "mae": {"losses": [mae_loss.item()], "state": _state(mae)},
            "jax": _jax_steps(variables, images, labels)}


def _run_diff(got, want) -> float:
    return max([abs(a - b) for a, b in zip(got["losses"], want["losses"])]
               + [_diff(got["state"][k], v) for k, v in want["state"].items()])


def test_ranks_finished(runs):
    for rank in runs["ranks"]:
        assert "error" not in rank, rank.get("error")


def test_mesh_is_data_by_model(runs):
    for r, rank in enumerate(runs["ranks"]):
        assert rank["mesh"] == {"shape": (2, 2), "data": 2, "model": 2, "model_rank": r % 2}
        assert rank["mesh (1, 2)"].startswith("ValueError: mesh shape (1, 2) does not cover 4")


def test_shard_params_keeps_local_heads_and_units(runs):
    for rank in runs["ranks"]:
        local, inner = rank["vit"]["local"], 2 * 32
        assert rank["vit"]["heads"] == [1, 1]
        assert local["transformer.layers.0.attn.to_qkv.weight"] == (3 * inner // 2, 64)
        assert local["transformer.layers.0.attn.to_out.0.weight"] == (64, inner // 2)
        assert local["transformer.layers.0.attn.to_out.0.bias"] == (64,)
        assert local["transformer.layers.1.mlp.fc1.weight"] == (64, 64)
        assert local["transformer.layers.1.mlp.fc1.bias"] == (64,)
        assert local["transformer.layers.1.mlp.fc2.weight"] == (64, 64)
        assert local["head.weight"] == (10, 64)


@pytest.mark.parametrize("tag", ["vit", "vit kernels"])
def test_split_step_matches_one_process(runs, tag):
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(runs["whole"]["state"])
        assert _run_diff(rank[tag], runs["whole"]) <= TOL


def test_split_step_matches_vit_tpu(runs):
    for rank in runs["ranks"]:
        assert _run_diff(rank["vit"], runs["jax"]) <= JAX_TOL


def test_kernel_route_runs_the_split_blocks(runs):
    depth = worker.SMALL_VIT["depth"]
    for rank in runs["ranks"]:
        calls = rank["vit kernels"]["calls"]
        assert sorted(set(calls)) == [("attention", True), ("mlp", True)]
        assert len(calls) == 2 * depth * worker.STEPS


@pytest.mark.parametrize("tag", ["vit", "vit kernels", "dropout", "mae"])
def test_ranks_hold_equal_gathered_states(runs, tag):
    first = runs["ranks"][0][tag]["state"]
    for rank in runs["ranks"][1:]:
        assert all(torch.equal(first[k], v) for k, v in rank[tag]["state"].items())


def test_dropout_matches_one_process_with_its_generators(runs):
    for rank in runs["ranks"]:
        assert _run_diff(rank["dropout"], runs["dropout"]) <= TOL
        assert rank["dropout without a generator"].startswith("ValueError: dropout")


def test_mae_trains_split(runs):
    for rank in runs["ranks"]:
        assert _run_diff(rank["mae"], runs["mae"]) <= TOL
        split = rank["mae"]["split"]
        assert any(k.startswith("encoder.transformer.") for k in split)
        assert any(k.startswith("decoder.") for k in split)


def test_shard_params_refusals(runs):
    """The hybrid tier still raises; three heads and a 24-wide MLP over two
    ranks run whole (the plan lists them), ScalableViT splits with IWSA's
    ``to_v`` whole (``plan.replicated``), and each step equals the
    one-process step."""
    layers = range(worker.SMALL_VIT["depth"])
    for rank in runs["ranks"]:
        refusals = rank["refusals"]
        assert refusals["hybrid"].startswith("NotImplementedError") and \
            "fused_attention='hybrid'" in refusals["hybrid"]
        assert refusals["unsplit step"].startswith("ValueError: make_train_step")
        rule = rank["whole rule"]
        assert rule["heads"]["whole"] == [f"transformer.layers.{i}.attn" for i in layers]
        assert rule["hidden"]["whole"] == [f"transformer.layers.{i}.mlp" for i in layers]
        assert rule["scalable"]["whole"] == []
        assert rule["scalable"]["replicated"] == [f"stage_{i}.layers.0.iwsa.to_v.weight"
                                                  for i in range(2)]
        for name, run in rule.items():
            assert _run_diff(run, run["one process"]) <= TOL, name


def test_checkpoint_of_a_split_model_is_whole(runs):
    """A one-process checkpoint restored into the split model hands each
    rank its slices; saved from it, the file is the one-process one; and
    it restores into a one-process model."""
    for rank in runs["ranks"]:
        assert all(rank["checkpoint"]["sliced"])
    workdir = runs["workdir"]
    one = torch.load(workdir / "one.pt", weights_only=True)
    split = torch.load(workdir / "ckpt" / "checkpoint_5.pt", weights_only=True)
    assert split["step"] == one["step"] == 1
    assert set(split["model"]) == set(one["model"])
    assert all(torch.equal(split["model"][k], v) for k, v in one["model"].items())
    for i, entry in one["optimizer"]["state"].items():
        assert torch.equal(split["optimizer"]["state"][i]["momentum_buffer"],
                           entry["momentum_buffer"])
    model = ViT(**worker.SMALL_VIT, device="cpu")
    state = restore_checkpoint(str(workdir / "ckpt" / "checkpoint_5.pt"), TrainState(
        model, torch.optim.SGD(model.parameters(), lr=worker.LR, momentum=0.9)))
    assert all(torch.equal(v, one["model"][k]) for k, v in model.state_dict().items())
    assert state.step == 1


def test_state_placements_follow_the_rule_table(runs):
    for rank in runs["ranks"]:
        placed = rank["checkpoint"]["placements"]
        momentum = rank["checkpoint"]["momentum placements"]
        qkv = "transformer.layers.0.attn.to_qkv.weight"
        out = "transformer.layers.0.attn.to_out.0.weight"
        assert placed[qkv] == momentum[qkv] == ["R", "S(0)"]  # (data, model)
        assert placed[out] == momentum[out] == ["R", "S(1)"]
        assert placed["head.weight"] == momentum["head.weight"] == ["R", "R"]


def test_example_trains_split(runs):
    import json
    import math

    from vit_tpu_torch.interop.export import load_forward_file

    out = runs["ranks"][0]["example"]
    lines = [json.loads(line) for line in out.splitlines() if line.startswith("{")]
    assert [line["step"] for line in lines] == [1, 2]
    assert all(math.isfinite(line["loss"]) for line in lines)
    assert "processes=4 mesh=dp2xtp2" in out and out.rstrip().endswith("done")
    workdir = runs["workdir"]
    assert [p.name for p in (workdir / "example").iterdir()] == ["checkpoint_2.pt"]
    with torch.no_grad():
        logits = load_forward_file(str(workdir / "example.pt2"))(torch.randn(2, 32, 32, 3))
    assert logits.shape == (2, 10) and bool(torch.isfinite(logits).all())
