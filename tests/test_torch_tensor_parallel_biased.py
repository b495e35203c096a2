"""Tensor parallelism for the biased and windowed models (the small-dataset
ViT, CrossFormer, RegionViT, NesT), on the CPU.

- Row 5's split form (the biased attention block over a rank's heads) with
  t in {2, 4} ranks emulated in one process: the weights cut into the
  ranks' heads, a per-head bias cut with them and a shared one whole, the
  ranks' f32 partials summed, the forward ended by the pass and the
  backward's dxn summed before the LayerNorm backward, dbias concatenated
  (per head) or summed (shared), held within 1e-5 of the unsplit plain op in
  f32 and within 1e-4 of ``vit_tpu``'s ``fused_attention_block_bias`` in the
  Pallas interpreter: a shared bias with dbias at 49 tokens (CrossFormer's
  windows), a per-head one at 50 (RegionViT's joint rows), LSA's mask at 65
  (no dbias) and a per-head bias at 577 tokens (the mha route).
- One spawn of four gloo ranks (``torch_tensor_parallel_biased_worker.run``,
  which also takes the port's one-process steps, a share a rank): each
  model at its own test's configuration, two SGD steps on a batch of 8 over
  a (2, 2) ``data`` x ``model`` mesh and over a (1, 4) one, from the same
  Flax weights, held within 1e-5 of the port's one-process step and within
  1e-4 of ``vit_tpu``'s ``make_train_step`` on a (2, 2) mesh of the virtual
  CPU devices, losses and gathered parameters; LSA's temperature gradients
  and CrossFormer's position-bias gradients whole and equal on every rank;
  the small-dataset ViT, CrossFormer and RegionViT also on their split
  Functions' kernel route; the attentions that run whole; a checkpoint of
  the split RegionViT written whole and restored into an unsplit model.

The group has a 60 s timeout and the ranks a join deadline, as the other
tensor-parallel tests', so a failed rank fails the test instead of hanging
it.
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

import torch_tensor_parallel_biased_worker as worker  # noqa: E402
from vit_tpu.ops.fused_attention_block import fused_attention_block_bias  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.interop.checkpoint import restore_checkpoint  # noqa: E402
from vit_tpu_torch.models.vit_for_small_dataset import lsa_bias  # noqa: E402
from vit_tpu_torch.ops import fused_attention_block as fab  # noqa: E402
from vit_tpu_torch.ops._shared import weight_grad  # noqa: E402
from vit_tpu_torch.ops.tensor_parallel import (  # noqa: E402
    bias_residual_reference, ln_backward_residual_reference,
)
from vit_tpu_torch.parallel import sharding  # noqa: E402
from vit_tpu_torch.parallel.train import TrainState  # noqa: E402

WORLD = 4
JOIN_TIMEOUT_S = 240
TOL, JAX_TOL = 1e-5, 1e-4


def _diff(got, want) -> float:
    """max|got - want| over max(1, max|want|)."""
    got, want = (np.asarray(t.detach() if isinstance(t, torch.Tensor) else t, np.float64)
                 for t in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(1.0, np.max(np.abs(want))))


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


# --- row 5's split form, emulated in one process ----------------------------

# (kind, b, n, d, heads, dim_head): 4 heads of 32 over d 64.
BIASED = [("shared", 2, 49, 64, 4, 32), ("per-head", 2, 50, 64, 4, 32),
          ("lsa", 2, 65, 64, 4, 32), ("per-head", 1, 577, 64, 4, 32)]


def _biased_inputs(kind, b, n, d, heads, dh):
    """x, gamma, beta, wqkv, wo, bo in vit_tpu's layout, the f32 bias and a
    cotangent, numpy arrays."""
    rng = np.random.default_rng(n)

    def rn(*shape, scale=1.0, shift=0.0):
        return (rng.standard_normal(shape) * scale + shift).astype(np.float32)

    inner = heads * dh
    args = (rn(b, n, d), rn(d, scale=0.1, shift=1.0), rn(d, scale=0.1),
            rn(d, 3 * inner, scale=0.05), rn(inner, d, scale=0.05), rn(d, scale=0.05))
    bias = lsa_bias(n, "cpu").numpy() if kind == "lsa" else \
        rn(heads if kind == "per-head" else 1, n, n)
    return args, bias, rn(b, n, d)


@functools.lru_cache(maxsize=None)
def _jax_biased(case):
    """``vit_tpu``'s biased block and its VJP in the Pallas interpreter."""
    kind, b, n, d, heads, dh = case
    args, bias, g = _biased_inputs(*case)
    y, vjp = jax.vjp(lambda *a: fused_attention_block_bias(*a, heads, dh, None, 1e-3, True),
                     *map(jnp.asarray, (*args, bias)))
    return np.asarray(y), [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("case", BIASED, ids=lambda c: f"{c[0]}-{c[2]}")
def test_split_biased_block_matches_unsplit_and_vit_tpu(t, case):
    kind, b, n, d, heads, dh = case
    hl, need_dbias = heads // t, kind != "lsa"
    args, bias_np, g = _biased_inputs(*case)
    x, gamma, beta, bo = (torch.from_numpy(args[i]) for i in (0, 1, 2, 5))
    wqkv, wo = torch.from_numpy(args[3].T.copy()), torch.from_numpy(args[4].T.copy())
    bias, dy = torch.from_numpy(bias_np), torch.from_numpy(g)

    parts = []
    for r in range(t):
        w_r = (sharding.shard_tensor(wqkv, sharding.QKV, r, t),
               sharding.shard_tensor(wo, sharding.ROW, r, t))
        bias_r = bias[r * hl:(r + 1) * hl] if kind == "per-head" else bias
        out = fab.fused_attention_block_partial_forward_reference(x, gamma, beta, *w_r, hl, dh,
                                                                  bias=bias_r)
        back = fab.fused_attention_block_partial_backward_reference(
            dy, *out[2:], *w_r, hl, dh, bias=bias_r, need_dbias=need_dbias)
        assert back[0].dtype == torch.float32 and len(back) == 4  # the partial dxn, dbias
        parts.append((w_r, out, back))
    y = bias_residual_reference(sum(p[1][0] for p in parts), bo, x)
    xn = parts[0][1][1]
    dxn = sum(p[2][0] for p in parts)
    dx, dgamma, dbeta, dbo = ln_backward_residual_reference(x, dxn, gamma, dy)
    got = dict(y=y, dx=dx, dxn=dxn, dgamma=dgamma, dbeta=dbeta, dbo=dbo,
               dwqkv=_join([weight_grad(p[2][1], xn) for p in parts], sharding.QKV),
               dwo=_join([weight_grad(dy, p[1][3]) for p in parts], sharding.ROW))
    if need_dbias:
        dbias = [p[2][3] for p in parts]
        got["dbias"] = torch.cat(dbias) if kind == "per-head" else sum(dbias)
    else:
        assert all(p[2][3] is None for p in parts)

    y_ref, xn_ref, qkv, oattn = fab.fused_attention_block_forward_reference(
        x, gamma, beta, wqkv, wo, bo, heads, dh, bias=bias)
    dx_ref, dqkv, dgamma_ref, dbeta_ref, dbo_ref, dbias_ref = \
        fab.fused_attention_block_backward_reference(dy, x, qkv, gamma, wqkv, wo, heads, dh,
                                                     bias=bias, need_dbias=need_dbias)
    want = dict(y=y_ref, dx=dx_ref, dxn=dqkv.reshape(-1, 3 * heads * dh) @ wqkv,
                dgamma=dgamma_ref, dbeta=dbeta_ref, dbo=dbo_ref,
                dwqkv=weight_grad(dqkv, xn_ref), dwo=weight_grad(dy, oattn))
    if need_dbias:
        want["dbias"] = dbias_ref
    for key in want:
        assert _diff(got[key], want[key]) <= TOL, (key, _diff(got[key], want[key]))

    y_jax, grads = _jax_biased(case)
    assert _diff(y, y_jax) <= JAX_TOL
    names = ("dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo", "dbias")
    for key, g_jax in zip(names, grads):
        if key in got:
            g_jax = g_jax.T if key in ("dwqkv", "dwo") else g_jax
            assert _diff(got[key], g_jax) <= JAX_TOL, (key, _diff(got[key], g_jax))


@pytest.mark.parametrize("kind", ["shared", "per-head"])
def test_split_biased_function_sums_over_its_group(monkeypatch, kind):
    """``fused_attention_block_bias(..., group=)`` under autograd on the CPU:
    the split form's partial through the group's sum (a recorder here, one
    rank), the pass, the f32 dxn's sum, the LayerNorm backward, and dbias
    this rank's; no launch counted (the plain versions)."""
    from vit_tpu_torch.ops import tensor_parallel

    case = next(c for c in BIASED if c[0] == kind)
    _, b, n, d, heads, dh = case
    args, bias_np, g = _biased_inputs(*case)
    x, gamma, beta, bo, bias = (torch.from_numpy(a).requires_grad_()
                                for a in (args[0], args[1], args[2], args[5], bias_np))
    wqkv = torch.from_numpy(args[3].T.copy()).requires_grad_()
    wo = torch.from_numpy(args[4].T.copy()).requires_grad_()
    sums = []
    monkeypatch.setattr(fab, "all_reduce_sum", lambda s, group: sums.append(group) or s)
    counters = (fab.fused_attention_block_bias_partial_forward,
                fab.fused_attention_block_bias_partial_backward, tensor_parallel.bias_residual,
                tensor_parallel.ln_backward)
    before = [c.launches for c in counters]
    y = fab.fused_attention_block_bias(x, gamma, beta, wqkv, wo, bo, bias, heads, dh,
                                       group="model")
    grads = torch.autograd.grad(y, (x, gamma, beta, wqkv, wo, bo, bias), torch.from_numpy(g))
    assert sums == ["model", "model"]  # the forward's s, the backward's dxn
    assert [c.launches for c in counters] == before
    y_jax, grads_jax = _jax_biased(case)
    assert _diff(y, y_jax) <= JAX_TOL
    for got, want, key in zip(grads, grads_jax,
                              ("dx", "dgamma", "dbeta", "dwqkv", "dwo", "dbo", "dbias")):
        want = want.T if key in ("dwqkv", "dwo") else want
        assert _diff(got, want) <= JAX_TOL, key


# --- shard_params without a group -------------------------------------------

@pytest.mark.parametrize("name", list(worker.MODELS))
def test_units_cover_the_rule_table(name):
    """Every parameter the rule table shards belongs to a module
    ``shard_params`` splits, but CrossFormer's position-bias MLPs, which stay
    whole (``plan.replicated``); each unit's cuts name its own tensors."""
    from torch.distributed.tensor import Shard

    model = worker.build(name)
    units, transformers = sharding._units(model)
    sharding._refuse(model, units, transformers)
    covered = {f"{u.path}.{k}" for u in units for k in u.cuts}
    sharded = {k for k, spec in sharding.param_specs(model).items() if isinstance(spec, Shard)}
    left = sorted(sharded - covered)
    if name == "crossformer":
        assert left and all(".dpb.fc1." in k or ".dpb.fc2.weight" in k for k in left), left
    else:
        assert not left, left
    for u in units:
        assert set(u.cuts) <= {k for k, _ in [*u.module.named_parameters(),
                                              *u.module.named_buffers()]}, u.path


# --- four gloo ranks --------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _flax_class(name):
    import vit_tpu

    module, _, cls = worker.MODELS[name][0].rpartition(".")
    owner = getattr(vit_tpu.models, module) if module else vit_tpu
    return getattr(owner, cls)


def _variables(model, img, rng):
    """Flax variables drawn from ``rng`` on the shapes the init gives: the
    norms' scales around 1 and biases around 0, the position tables at 0.5,
    the kernels scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: model.init(jax.random.PRNGKey(0), a), jnp.asarray(img))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name == "scale":
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name == "bias":
            return (0.1 * draw).astype(np.float32)
        if name in ("embedding", "temperature"):
            return (0.5 * draw).astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return {k: dict(v) for k, v in jax.tree_util.tree_map_with_path(leaf, shapes).items()}


def _jax_steps(name, variables, images, labels):
    """``vit_tpu``'s step on a (2, 2) mesh of the virtual CPU devices, the
    parameters placed by its rule table."""
    from vit_tpu.parallel import mesh as mesh_lib
    from vit_tpu.parallel import train as jax_train

    _, cfg, _, lr = worker.MODELS[name]
    model, tx = _flax_class(name)(**cfg), optax.sgd(lr)
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
            "state": state_dict_from_flax(jax.tree.map(np.asarray, {"params": state.params}))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    inputs, flax = {}, {}
    for name, (_, cfg, side, _) in worker.MODELS.items():
        images = rng.standard_normal((worker.BATCH, side, side, 3)).astype(np.float32)
        labels = (np.arange(worker.BATCH) % cfg["num_classes"]).astype(np.int32)
        variables = _variables(_flax_class(name)(**cfg), images, rng)
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
    for name, run in jax_runs.items():  # LSA's temperature: Flax's (1,), the port's ()
        shapes = {k: v.shape for k, v in inputs[name]["state"].items()}
        run["state"] = {k: v.reshape(shapes[k]) for k, v in run["state"].items()}
    ranks = [torch.load(workdir / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    whole = {k: v for rank in ranks for k, v in rank.get("one process", {}).items()}
    return {"ranks": ranks, "workdir": workdir, "whole": whole, "jax": jax_runs,
            "inputs": inputs}


def _run_diff(got, want) -> float:
    """The largest :func:`_diff` of the losses and of the state."""
    return max([_diff(a, b) for a, b in zip(got["losses"], want["losses"])]
               + [_diff(got["state"][k], v) for k, v in want["state"].items()])


def _model(tag) -> str:
    return tag.removesuffix(" kernels").removesuffix(" tp 4")


TAGS = [*worker.MODELS, *(f"{k} kernels" for k in worker.KERNEL_ROUTE),
        *(f"{k} tp 4" for k in worker.MODELS)]


def test_ranks_finished(runs):
    for rank in runs["ranks"]:
        assert "error" not in rank, rank.get("error")


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_matches_one_process(runs, tag):
    want = runs["whole"][_model(tag)]
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(want["state"])
        assert _run_diff(rank[tag], want) <= TOL, _run_diff(rank[tag], want)


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_matches_vit_tpu(runs, tag):
    want = runs["jax"][_model(tag)]
    for rank in runs["ranks"]:
        assert _run_diff(rank[tag], want) <= JAX_TOL, _run_diff(rank[tag], want)


@pytest.mark.parametrize("tag", TAGS)
def test_ranks_hold_equal_gathered_states(runs, tag):
    """Every rank's gathered state bit for bit; the losses of each model
    group (one data slice) too."""
    first = runs["ranks"][0][tag]
    for rank in runs["ranks"][1:]:
        assert all(torch.equal(first["state"][k], v) for k, v in rank[tag]["state"].items())
    group = runs["ranks"] if tag.endswith("tp 4") else runs["ranks"][:2]
    assert all(rank[tag]["losses"] == first["losses"] for rank in group)


@pytest.mark.parametrize("tag", ["small-dataset ViT", "small-dataset ViT kernels", "crossformer",
                                 "crossformer kernels", "crossformer tp 4"])
def test_replicated_gradients_are_whole_and_equal(runs, tag):
    """LSA's temperatures and CrossFormer's position-bias MLPs, which every
    rank holds whole: their step-1 gradients, summed over the model group by
    ``copy_to_model_parallel``, equal on every rank bit for bit and the
    one-process step's within 1e-5 (a one-token window's DPB takes a zero
    gradient: its softmax is 1)."""
    want = runs["whole"][_model(tag)]["grads"]
    assert want and any(float(v.abs().max()) > 0 for v in want.values())
    first = runs["ranks"][0][tag]["grads"]
    assert set(first) == set(want)
    for rank in runs["ranks"]:
        got = rank[tag]["grads"]
        assert all(torch.equal(got[k], first[k]) for k in want)
        assert max(_diff(got[k], v) for k, v in want.items()) <= TOL


def test_split_modules_keep_their_heads_and_units(runs):
    for rank in runs["ranks"]:
        local, kinds = rank["small-dataset ViT"]["local"], rank["small-dataset ViT"]["kinds"]
        # 2 heads of 32 at dim 64: one a rank; 64 of 128 hidden units
        assert local["layers.0.attn.to_qkv.weight"] == (96, 64)
        assert local["layers.0.attn.to_out.0.weight"] == (64, 32)
        assert local["layers.0.attn.temperature"] == ()
        assert local["layers.1.mlp.fc1.weight"] == (64, 64)
        assert kinds["layers.0.attn.to_qkv.weight"] == sharding.QKV
        assert kinds["layers.1.mlp.fc2.weight"] == sharding.ROW
        assert "layers.0.attn.temperature" not in kinds
        assert rank["small-dataset ViT"]["whole"] == []

        run = rank["crossformer"]
        # c / 32 heads: 1 / 2 / 3 / 4 by stage, so stages 1 and 3 run whole at tp 2
        assert run["whole"] == ["short_attn_0_0", "long_attn_0_0", "short_attn_2_0",
                                "long_attn_2_0"]
        assert run["local"]["short_attn_1_0.to_qkv.weight"] == (96, 64, 1, 1)
        assert run["local"]["short_ff_0_0.fc1.weight"] == (64, 32, 1, 1)  # 4·32 / 2
        assert run["local"]["short_attn_1_0.dpb.fc1.weight"] == (16, 16)  # whole
        assert sorted(run["replicated"]) == sorted(
            f"{kind}_attn_{s}_0.dpb.{leaf}" for kind in ("short", "long") for s in (1, 3)
            for leaf in ("fc1.weight", "fc1.bias", "fc2.weight"))
        assert not any(".dpb." in k for k in run["kinds"])

        run = rank["regionvit"]
        assert run["local"]["transformer_0.local_rel_pos_bias.weight"] == (49, 2)
        assert run["kinds"]["transformer_3.local_rel_pos_bias.weight"] == sharding.ROW
        assert run["local"]["transformer_1.attn_0.to_qkv.weight"] == (192, 48)
        assert run["local"]["transformer_1.ff_0.fc2.weight"] == (48, 96)
        assert run["whole"] == [] and run["replicated"] == []

        run = rank["nest"]
        assert run["local"]["transformer_0.attn_0.to_qkv.weight"] == (96, 64, 1, 1)
        assert run["kinds"]["transformer_2.mlp_fc1_1.bias"] == sharding.COLUMN
        assert run["local"]["transformer_2.mlp_fc2_1.weight"] == (256, 512, 1, 1)
        assert run["whole"] == []

        # NesT@224's three-head hierarchy 1 runs whole at tp 2; its MLP splits.
        three = rank["nest three heads"]
        assert three["whole"] == ["transformer_0.attn_0"]
        assert three["kinds"]["transformer_0.mlp_fc1_0.weight"] == sharding.COLUMN
        assert "transformer_1.attn_0.to_qkv.weight" in three["kinds"]

        # Over four ranks: the heads that do not divide by 4 run whole.
        assert rank["small-dataset ViT tp 4"]["whole"] == ["layers.0.attn", "layers.1.attn"]
        assert rank["crossformer tp 4"]["whole"] == [
            f"{kind}_attn_{s}_0" for s in range(3) for kind in ("short", "long")]
        assert rank["regionvit tp 4"]["whole"] == []
        assert rank["regionvit tp 4"]["local"]["transformer_0.local_rel_pos_bias.weight"] == \
            (49, 1)
        assert rank["nest tp 4"]["whole"] == ["transformer_0.attn_0"]


def test_kernel_route_runs_the_split_blocks(runs):
    """The kernel route opened on the CPU: the small-dataset ViT's 2 LSA
    blocks and 2 fused MLPs a forward, all split; CrossFormer's 5 biased
    blocks (stages 2 and 4's short windows split; stages 1 and 3's, whole,
    without a group) and 8 fused MLPs, all split; RegionViT's 4 region
    self-attentions and 4 joint rows, all split."""
    for rank in runs["ranks"]:
        calls = rank["small-dataset ViT kernels"]["calls"]
        count = {c: calls.count(c) for c in set(calls)}
        assert count == {("fused_attention_block_bias", True): 2 * worker.STEPS,
                         ("fused_mlp", True): 2 * worker.STEPS}, count
        calls = rank["crossformer kernels"]["calls"]
        count = {c: calls.count(c) for c in set(calls)}
        assert count == {("fused_attention_block_bias", True): 2 * worker.STEPS,
                         ("fused_attention_block_bias", False): 3 * worker.STEPS,
                         ("fused_mlp", True): 8 * worker.STEPS}, count
        calls = rank["regionvit kernels"]["calls"]
        count = {c: calls.count(c) for c in set(calls)}
        assert count == {("fused_attention_block", True): 4 * worker.STEPS,
                         ("fused_attention_block_bias", True): 4 * worker.STEPS}, count


def test_checkpoint_of_a_split_model_is_whole(runs):
    """Written whole by rank 0 (the gathered state, RegionViT's position
    tables included), it restores into an unsplit model bit for bit."""
    tag = worker.CHECKPOINTED
    path = runs["workdir"] / f"ckpt {tag}" / f"checkpoint_{worker.STEPS}.pt"
    saved = torch.load(path, weights_only=True)
    gathered = runs["ranks"][0][tag]["state"]
    assert saved["step"] == worker.STEPS and set(saved["model"]) == set(gathered)
    assert all(torch.equal(saved["model"][k], v) for k, v in gathered.items())
    assert saved["model"]["transformer_0.local_rel_pos_bias.weight"].shape == (49, 4)
    model = worker.build(tag)
    restore_checkpoint(str(path), TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)))
    assert all(torch.equal(v, saved["model"][k]) for k, v in model.state_dict().items())
