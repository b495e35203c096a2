"""Tensor parallelism for the conv hybrids that ``vit_tpu``'s mesh tests
shard (Twins-SVT, CvT, LeViT, MobileViT), on the CPU.

- Row 6's split form (the fused cross-attention block over a rank's heads)
  with t in {2, 4} ranks emulated in one process: the weights, k and v cut
  into the ranks' heads, the ranks' f32 partials summed, the forward ended
  by the pass and the backward's dxn summed before one rounding, held within
  1e-5 of the unsplit plain op in f32 and within 1e-4 of ``vit_tpu``'s
  ``fused_cross_attention_block`` in the Pallas interpreter, at Twins-like
  shapes (8 heads of 64; c 64 and 256; 16, 4 and 1 keys).
- One spawn of four gloo ranks over a (2, 2) ``data`` x ``model`` mesh
  (``torch_tensor_parallel_hybrids_worker.run``, which also takes the
  port's one-process steps, a share a rank): the configurations of
  ``tests/multidevice/test_sharded_train.py`` (Twins-SVT ``:210-246``, CvT
  ``:404-406``, LeViT ``:134-135`` and the zoo audit's ``:363-365``,
  MobileViT ``:260-270``), two SGD steps on a batch of 8 from the same Flax
  weights, held within 1e-5 of the port's one-process step and within 1e-4
  of ``vit_tpu``'s ``make_train_step`` / ``make_bn_train_step`` on a (2, 2)
  mesh of the virtual CPU devices, losses and gathered parameters and
  running statistics; Twins-SVT also on its split Functions' kernel route.
  The ranks' gathered states bit for bit equal; the attentions that run
  whole; checkpoints of the split Twins-SVT and LeViT written whole and
  restored into unsplit models; the placements of LeViT's split BatchNorm
  buffers; what ``shard_params`` still refuses (the hybrid tier, ScalableViT,
  ATS-ViT, CCT and T2T-ViT, each naming its module).  Twins-SVT, CvT and LeViT
  also train at dropout 0.1 with one generator seed on every rank, on data
  rank 0's slice, against the one-process step on that slice with the same
  generator (1e-5), and raise without a generator.

The group has a 60 s timeout and the ranks a join deadline, as
``test_torch_tensor_parallel.py``'s, so a failed rank fails the test instead
of hanging it.
"""

import functools
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

import torch_tensor_parallel_hybrids_worker as worker  # noqa: E402
from vit_tpu.ops.fused_cross_attention import fused_cross_attention_block  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.interop.checkpoint import restore_checkpoint  # noqa: E402
from vit_tpu_torch.ops import fused_cross_attention as fca  # noqa: E402
from vit_tpu_torch.ops._shared import weight_grad  # noqa: E402
from vit_tpu_torch.ops.tensor_parallel import bias_residual_reference  # noqa: E402
from vit_tpu_torch.parallel import sharding  # noqa: E402
from vit_tpu_torch.parallel.train import TrainState  # noqa: E402

WORLD = 4
JOIN_TIMEOUT_S = 180
TOL, JAX_TOL = 1e-5, 1e-4


def _diff(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    got, want = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float64)
                 for t in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


# --- row 6's split form, emulated in one process ----------------------------

# (b, n, n_k, c, heads, dh): Twins-SVT's global attention, 8 heads of 64, at a
# ragged 49 tokens over the key counts of its stages 2-4 and the widths of its
# stages 1 and 3.
CROSS_SHAPES = [(2, 49, 16, 64, 8, 64), (2, 49, 4, 256, 8, 64), (2, 49, 1, 256, 8, 64)]


def _cross_inputs(b, n, n_k, c, heads, dh):
    """x, xn, wq, k, v, wo, bo in vit_tpu's layout (wq (c, hk), wo (hv, c))
    and a cotangent, f32 numpy arrays."""
    rng = np.random.default_rng(n_k + c)

    def rn(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    args = (rn(b, n, c), rn(b, n, c), rn(c, heads * dh, scale=0.1), rn(b, n_k, heads * dh),
            rn(b, n_k, heads * dh), rn(heads * dh, c, scale=0.1), rn(c, scale=0.1))
    return args, rn(b, n, c)


@functools.lru_cache(maxsize=None)
def _jax_cross(shape):
    """``vit_tpu``'s block and its VJP in the Pallas interpreter."""
    b, n, n_k, c, heads, dh = shape
    args, g = _cross_inputs(*shape)
    y, vjp = jax.vjp(lambda *a: fused_cross_attention_block(*a, heads, dh, dh, dh ** -0.5, True),
                     *map(jnp.asarray, args))
    return np.asarray(y), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _heads_of(t: torch.Tensor, r: int, size: int) -> torch.Tensor:
    """Rank r's heads' columns of a channel-packed (b, n_k, heads·dh) k or v."""
    width = t.shape[-1] // size
    return t[..., r * width:(r + 1) * width].contiguous()


def _join_heads(pieces) -> torch.Tensor:
    return torch.cat(pieces, dim=-1)


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("shape", CROSS_SHAPES)
def test_split_cross_attention_matches_unsplit_and_vit_tpu(t, shape):
    b, n, n_k, c, heads, dh = shape
    scale = dh ** -0.5
    args, g = _cross_inputs(*shape)
    x, xn, k, v, bo = (torch.from_numpy(args[i]) for i in (0, 1, 3, 4, 6))
    wq, wo = torch.from_numpy(args[2].T.copy()), torch.from_numpy(args[5].T.copy())
    dy = torch.from_numpy(g)

    parts = []
    for r in range(t):
        w_r = (sharding.shard_tensor(wq, sharding.COLUMN, r, t), _heads_of(k, r, t),
               _heads_of(v, r, t), sharding.shard_tensor(wo, sharding.ROW, r, t))
        out = fca.fused_cross_attention_partial_forward(xn, *w_r, heads // t, dh, dh, scale,
                                                        training=True)
        back = fca.fused_cross_attention_partial_backward(dy, out[1], w_r[1], w_r[2], out[2],
                                                          out[3], w_r[0], w_r[3], heads // t,
                                                          dh, dh, scale)
        parts.append((out, back))
    y = bias_residual_reference(sum(p[0][0] for p in parts), bo, x)
    backs = [p[1] for p in parts]
    assert all(bk[0].dtype == torch.float32 for bk in backs)  # the partial dxn, unrounded
    got = dict(
        y=y, dx=dy, dxn=sum(bk[0] for bk in backs),
        dwq=torch.cat([weight_grad(bk[1], xn) for bk in backs]),
        dk=_join_heads([bk[2] for bk in backs]), dv=_join_heads([bk[3] for bk in backs]),
        dwo=torch.cat([weight_grad(dy, p[0][2]) for p in parts], dim=1), dbo=backs[0][4])
    assert all(torch.equal(bk[4], backs[0][4]) for bk in backs)  # dbo from the whole dy

    y_ref, q, oattn, lse = fca.fused_cross_attention_forward_reference(x, xn, wq, k, v, wo, bo,
                                                                       heads, dh, dh, scale)
    dxn, dq, dk, dv, dbo = fca.fused_cross_attention_backward_reference(
        dy, q, k, v, oattn, lse, wq, wo, heads, dh, dh, scale)
    want = dict(y=y_ref, dx=dy, dxn=dxn, dwq=weight_grad(dq, xn), dk=dk, dv=dv,
                dwo=weight_grad(dy, oattn), dbo=dbo)
    for key in want:
        assert _diff(got[key], want[key]) <= TOL, (key, _diff(got[key], want[key]))

    y_jax, grads = _jax_cross(shape)
    assert _diff(y, y_jax) <= JAX_TOL
    for key, g_jax in zip(("dx", "dxn", "dwq", "dk", "dv", "dwo", "dbo"), grads):
        g_jax = g_jax.T if key in ("dwq", "dwo") else g_jax
        assert _diff(got[key], g_jax) <= JAX_TOL, (key, _diff(got[key], g_jax))


def test_split_cross_attention_function_sums_over_its_group(monkeypatch):
    """``fused_cross_attention(..., group=)`` under autograd on the CPU: the
    split form's partial through the group's sum (a recorder here, one
    rank), the pass, and xn's gradient the f32 partial in xn's dtype."""
    from vit_tpu_torch.ops import tensor_parallel

    shape = CROSS_SHAPES[0]
    b, n, n_k, c, heads, dh = shape
    args, g = _cross_inputs(*shape)
    x, xn, k, v, bo = (torch.from_numpy(args[i]).requires_grad_() for i in (0, 1, 3, 4, 6))
    wq = torch.from_numpy(args[2].T.copy()).requires_grad_()
    wo = torch.from_numpy(args[5].T.copy()).requires_grad_()
    sums = []
    monkeypatch.setattr(fca, "all_reduce_sum", lambda s, group: sums.append(group) or s)
    counts = (fca.fused_cross_attention_partial_forward.launches,
              fca.fused_cross_attention_partial_backward.launches,
              tensor_parallel.bias_residual.launches)
    y = fca.fused_cross_attention(x, xn, wq, k, v, wo, bo, heads, dh, dh, group="model")
    grads = torch.autograd.grad(y, (x, xn, wq, k, v, wo, bo), torch.from_numpy(g))
    assert sums == ["model"]
    assert counts == (fca.fused_cross_attention_partial_forward.launches,
                      fca.fused_cross_attention_partial_backward.launches,
                      tensor_parallel.bias_residual.launches)  # CPU: plain versions
    y_jax, grads_jax = _jax_cross(shape)
    assert _diff(y, y_jax) <= JAX_TOL
    for got, want, key in zip(grads, grads_jax, ("dx", "dxn", "dwq", "dk", "dv", "dwo", "dbo")):
        want = want.T if key in ("dwq", "dwo") else want
        assert _diff(got, want) <= JAX_TOL, key
    with torch.no_grad():
        served = fca.fused_cross_attention(x, xn, wq, k, v, wo, bo, heads, dh, dh, group="model")
    assert torch.equal(served, y.detach()) and sums == ["model", "model"]


# --- shard_params without a group -------------------------------------------

@pytest.mark.parametrize("name", list(worker.MODELS))
def test_units_cover_the_rule_table(name):
    """Every parameter the rule table shards belongs to a module
    ``shard_params`` splits (or keeps whole), and each attention's cuts
    name its heads' projections."""
    from torch.distributed.tensor import Shard

    model = worker.build(name)
    units, transformers = sharding._units(model)
    sharding._refuse(model, 2, units, transformers)
    covered = {f"{u.path}.{k}" for u in units for k in u.cuts}
    sharded = {k for k, spec in sharding.param_specs(model).items() if isinstance(spec, Shard)}
    assert sharded <= covered, sharded - covered
    for u in units:
        assert set(u.cuts) <= {k for k, _ in [*u.module.named_parameters(),
                                              *u.module.named_buffers()]}, u.path


def test_shard_params_refuses_a_hidden_width_that_does_not_divide():
    model = worker.build("levit")
    model.stage_0.mlp_0.fc1.weight.data = torch.zeros(63, 32, 1, 1)
    units, transformers = sharding._units(model)
    with pytest.raises(NotImplementedError, match=r"stage_0\.mlp_0\.fc1's hidden width 63"):
        sharding._refuse(model, 2, units, transformers)


# --- four gloo ranks over a (2, 2) mesh -------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _variables(model, img, rng):
    """Flax variables drawn from ``rng`` on the shapes the init gives: the
    norms' scales around 1 and biases around 0, running means around 0 and
    variances in [0.5, 1.5], LeViT's position tables at 0.5, the kernels
    scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * draw).astype(np.float32)
        if name == "embedding":
            return (0.5 * draw).astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return {k: dict(v) for k, v in jax.tree_util.tree_map_with_path(leaf, shapes).items()}


def _jax_steps(name, variables, images, labels):
    """``vit_tpu``'s step on a (2, 2) mesh of the virtual CPU devices, the
    parameters placed by its rule table: ``make_bn_train_step`` for the
    BatchNorm models."""
    import vit_tpu
    from vit_tpu.parallel import mesh as mesh_lib
    from vit_tpu.parallel import train as jax_train

    cls, cfg, _, lr = worker.MODELS[name]
    model, tx = getattr(vit_tpu, cls)(**cfg), optax.sgd(lr)
    mesh = mesh_lib.make_mesh(worker.MESH, devices=jax.devices()[:WORLD])
    if "batch_stats" in variables:
        def apply_fn(p, ms, x, rng):
            out, new = model.apply({"params": p, "batch_stats": ms}, x, training=True,
                                   mutable=["batch_stats"])
            return out, new["batch_stats"]

        _, compile_step = jax_train.make_bn_train_step(apply_fn, tx, mesh, donate=False)
        state = jax_train.create_bn_train_state(variables["params"], variables["batch_stats"],
                                                tx)
        step = compile_step(state)
        state = jax.device_put(state, jax_train.bn_state_shardings(mesh, state))
    else:
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
    tree = {"params": state.params}
    if "batch_stats" in variables:
        tree["batch_stats"] = state.model_state
    return {"losses": losses, "state": state_dict_from_flax(jax.tree.map(np.asarray, tree))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import vit_tpu

    rng = np.random.default_rng(0)
    inputs, flax = {}, {}
    for name, (cls, cfg, side, _) in worker.MODELS.items():
        images = rng.standard_normal((worker.BATCH, side, side, 3)).astype(np.float32)
        labels = (np.arange(worker.BATCH) % cfg["num_classes"]).astype(np.int32)
        variables = _variables(getattr(vit_tpu, cls)(**cfg), images, rng)
        model = worker.build(name)
        model.load_state_dict(state_dict_from_flax(variables), strict=True)
        inputs[name] = {"images": torch.from_numpy(images),
                        "labels": torch.from_numpy(labels).long(),
                        "state": {k: v.detach().clone() for k, v in model.state_dict().items()}}
        flax[name] = (variables, images, labels)
    workdir = tmp_path_factory.mktemp("ranks")
    torch.save(inputs, workdir / "inputs.pt")
    ctx = mp.start_processes(worker.run, args=(WORLD, _free_port(), str(workdir)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        jax_runs = {name: _jax_steps(name, *flax[name]) for name in worker.MODELS}
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise AssertionError(f"the ranks did not finish in {JOIN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    whole = {k: v for rank in ranks for k, v in rank.get("one process", {}).items()}
    whole.update({f"{k} dropout": v for rank in ranks
                  for k, v in rank.get("one process dropout", {}).items()})
    return {"ranks": ranks, "workdir": workdir, "whole": whole, "jax": jax_runs,
            "inputs": inputs}


def _run_diff(got, want) -> float:
    """The largest :func:`_diff` of the losses and of the state (Twins-SVT's
    first loss at these weights is about 17: each against its own scale)."""
    return max([_diff(a, b) for a, b in zip(got["losses"], want["losses"])]
               + [_diff(got["state"][k], v) for k, v in want["state"].items()])


TAGS = [*worker.MODELS, "twins kernels"]


def test_ranks_finished(runs):
    for rank in runs["ranks"]:
        assert "error" not in rank, rank.get("error")


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_matches_one_process(runs, tag):
    want = runs["whole"][tag.replace(" kernels", "")]
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(want["state"])
        assert _run_diff(rank[tag], want) <= TOL, _run_diff(rank[tag], want)


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_matches_vit_tpu(runs, tag):
    want = runs["jax"][tag.replace(" kernels", "")]
    for rank in runs["ranks"]:
        assert _run_diff(rank[tag], want) <= JAX_TOL, _run_diff(rank[tag], want)


DROPOUT_TAGS = [f"{name} dropout" for name in worker.DROPOUT]


@pytest.mark.parametrize("tag", DROPOUT_TAGS)
def test_split_dropout_matches_one_process_with_its_generator(runs, tag):
    """Dropout 0.1, split and whole modules alike, draws the one-process
    forward's masks from the generator given to the step: the split step
    equals the one-process step on the same slice and generator (and the
    dropout moved the loss)."""
    want = runs["whole"][tag]
    assert want["losses"][0] != want["rate 0"]
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(want["state"])
        assert _run_diff(rank[tag], want) <= TOL, _run_diff(rank[tag], want)


def test_split_dropout_without_a_generator_raises(runs):
    for rank in runs["ranks"]:
        refusal = rank["dropout without a generator"]
        assert refusal.startswith("ValueError: dropout in training draws from an explicit "
                                  "generator"), refusal


@pytest.mark.parametrize("tag", TAGS + DROPOUT_TAGS)
def test_ranks_hold_equal_gathered_states(runs, tag):
    first = runs["ranks"][0][tag]["state"]
    for rank in runs["ranks"][1:]:
        assert all(torch.equal(first[k], v) for k, v in rank[tag]["state"].items())
    assert runs["ranks"][0][tag]["losses"] == runs["ranks"][1][tag]["losses"]


@pytest.mark.parametrize("name", ["cvt", "levit", "levit audit", "mobilevit"])
def test_batch_norm_statistics_gathered_whole(runs, name):
    """The running statistics, split with their heads or whole, come back
    whole, moved by the two steps as the one-process step moves them."""
    before = runs["inputs"][name]["state"]
    want = runs["whole"][name]["state"]
    for rank in runs["ranks"]:
        state = rank[name]["state"]
        stats = [k for k in state if k.endswith(("running_mean", "running_var"))]
        assert stats and all(state[k].shape == before[k].shape for k in stats)
        assert all(_diff(state[k], want[k]) <= TOL for k in stats)
        assert any(not torch.equal(state[k], before[k]) for k in stats)


def test_split_modules_keep_their_heads_and_units(runs):
    for rank in runs["ranks"]:
        local = rank["twins"]["local"]
        # 8 heads of 64 at dim 32: 4 heads a rank, 2 x 4 x 64 rows of to_kv
        assert local["s1_transformer.layers.0.local_attn.to_q.weight"] == (256, 32, 1, 1)
        assert local["s1_transformer.layers.0.global_attn.to_kv.weight"] == (512, 32, 4, 4)
        assert local["s1_transformer.layers.0.global_attn.to_out.0.weight"] == (32, 256, 1, 1)
        assert local["s1_transformer.layers.0.global_attn.to_out.0.bias"] == (32,)
        assert local["s1_transformer.layers.0.ff1.fc1.weight"] == (64, 32, 1, 1)
        assert local["s1_transformer.layers.0.ff2.fc2.weight"] == (32, 64, 1, 1)
        kinds = rank["twins"]["kinds"]
        assert kinds["s1_transformer.layers.0.global_attn.to_kv.weight"] == sharding.KV
        assert rank["twins"]["whole"] == []

        local, kinds = rank["levit audit"]["local"], rank["levit audit"]["kinds"]
        for t in "qkv":  # stage_0: 2 heads, one a rank, with its BatchNorm channels
            assert kinds[f"stage_0.attn_0.to_{t}_bn.running_var"] == sharding.COLUMN
        assert local["stage_0.attn_0.to_q_bn.running_mean"] == (8,)
        assert local["stage_0.attn_0.to_v_bn.weight"] == (16,)
        assert local["stage_0.attn_0.pos_bias.weight"] == (16, 1)
        assert local["shrink_0.attn_0.pos_bias.weight"] == (16, 2)  # 4 heads
        assert local["stage_0.attn_0.to_out_bn.running_var"] == (32,)
        assert local["stage_0.mlp_0.fc1.weight"] == (32, 32, 1, 1)
        assert rank["levit audit"]["whole"] == ["stage_1.attn_0"]  # 3 heads
        assert not any(k.startswith("stage_1.attn_0.") for k in kinds)

        assert rank["cvt"]["whole"] == ["s1_transformer.layers.0.attn"]  # 1 head
        kinds = rank["cvt"]["kinds"]
        assert kinds["s2_transformer.layers.0.attn.to_kv.pointwise.weight"] == sharding.KV
        assert kinds["s1_transformer.layers.0.mlp_fc1.bias"] == sharding.COLUMN
        assert not any(".depthwise." in k or ".bn." in k for k in kinds)
        assert rank["cvt13 whole"] == ["s1_transformer.layers.0.attn",
                                       "s2_transformer.layers.0.attn"]

        kinds = rank["mobilevit"]["kinds"]
        assert kinds["trunk_attn_1.attn_3.to_qkv.weight"] == sharding.QKV
        assert kinds["trunk_attn_2.mlp_fc2_2.weight"] == sharding.ROW
        assert rank["mobilevit"]["whole"] == []


def test_kernel_route_runs_the_split_blocks(runs):
    """Twins-SVT's kernel route opened on the CPU: every residual through
    the split Functions (a model group given), 6 local blocks, 8 global ones
    and 14 fused MLPs a forward."""
    for rank in runs["ranks"]:
        calls = rank["twins kernels"]["calls"]
        assert all(split for _, split in calls)
        assert {k: sum(name == k for name, _ in calls) for k in ("local", "global", "mlp")} == \
            {"local": 6 * worker.STEPS, "global": 8 * worker.STEPS, "mlp": 14 * worker.STEPS}


@pytest.mark.parametrize("tag", worker.CHECKPOINTED)
def test_checkpoint_of_a_split_model_is_whole(runs, tag):
    """Written whole by rank 0 (the ranks' gathered state, running statistics
    included), it restores into an unsplit model bit for bit."""
    path = runs["workdir"] / f"ckpt {tag}" / f"checkpoint_{worker.STEPS}.pt"
    saved = torch.load(path, weights_only=True)
    gathered = runs["ranks"][0][tag]["state"]
    assert saved["step"] == worker.STEPS and set(saved["model"]) == set(gathered)
    assert all(torch.equal(saved["model"][k], v) for k, v in gathered.items())
    model = worker.build(tag)
    restore_checkpoint(str(path), TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)))
    assert all(torch.equal(v, saved["model"][k]) for k, v in model.state_dict().items())


def test_state_placements_follow_the_plan(runs):
    for rank in runs["ranks"]:
        placed = rank["levit audit"]["placements"]
        assert placed["stage_0.attn_0.to_q.weight"] == ["R", "S(0)"]  # (data, model)
        assert placed["stage_0.attn_0.to_q_bn.weight"] == ["R", "S(0)"]
        assert placed["stage_0.attn_0.to_q_bn.running_mean"] == ["R", "S(0)"]
        assert placed["stage_0.attn_0.pos_bias.weight"] == ["R", "S(1)"]
        assert placed["stage_0.attn_0.to_out.0.weight"] == ["R", "S(1)"]
        assert placed["stage_0.attn_0.to_out_bn.running_var"] == ["R", "R"]
        assert placed["stage_1.attn_0.to_q.weight"] == ["R", "R"]  # whole
        assert placed["stage_1.mlp_0.fc1.weight"] == ["R", "S(0)"]


# Why each model of worker.REFUSED is refused: its modules have no split form
# (the rule table shards them), the hybrid tier's kernels none, T2T-ViT's
# single-head token transformers no output projection.
REFUSAL_REASONS = {"hybrid tier": "fused_attention='hybrid'",
                   "T2T-ViT": "t2t_transformer_0.layers.0.attn has no output projection"}


@pytest.mark.parametrize("name", list(worker.REFUSED))
def test_shard_params_still_refuses_the_other_models(runs, name):
    reason = REFUSAL_REASONS.get(name, "is split over the 'model' axis by the rule table")
    for rank in runs["ranks"]:
        refusal = rank["refusals"][name]
        assert refusal.startswith("NotImplementedError: shard_params: ") and \
            reason in refusal, refusal
