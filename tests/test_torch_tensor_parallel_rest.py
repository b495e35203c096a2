"""Tensor parallelism for ATS-ViT, CCT, ScalableViT and T2T-ViT, on the CPU.

- The split attentions of these models with t in {2, 4} ranks emulated by
  threads in one process (``torch_tp_emulation``): CCT's attention (its
  attention-matrix dropout on the generator: the full mask drawn, this
  rank's heads taken), ATS-ViT's attention with its token sampling (the
  value-weighted cls row summed over the model group before the draw, the
  Gumbel table injected into both packages as ``test_torch_ats_vit.py``
  injects it), ScalableViT's IWSA (``to_v`` whole before ``f``, ``f`` on v,
  the local module cut by output channels) and SSA on the plain route.  In
  training at dropout 0.1 on one generator, the forward, the input
  gradients and every parameter's gradient, gathered, within 1e-5 of the
  unsplit module; in eval, within 1e-4 of ``vit_tpu``'s module from the same
  Flax weights.  ATS-ViT's sampled ids equal on every rank and to the
  unsplit module's.  Without ``f`` on IWSA's v the gradients miss.
- ``shard_params``' units cover every parameter the rule table shards, for
  the four models and ``DistillableT2TViT``; what cannot split (T2T-ViT's
  one-head token transformers and their 147- and 1323-wide MLPs, an
  attention whose heads the axis does not divide) runs whole.
- One spawn of four gloo ranks (``torch_tensor_parallel_rest_worker.run``,
  which also takes the port's one-process steps, a share a rank): each
  model at its own test file's configuration, two SGD steps on a batch of 8
  over a (2, 2) ``data`` x ``model`` mesh and over a (1, 4) one, from the
  same Flax weights, within 1e-5 of the port's one-process step and within
  1e-4 of ``vit_tpu``'s ``make_train_step`` on a (2, 2) mesh of the virtual
  CPU devices, losses and gathered parameters, the ranks' states bit for
  bit; ATS-ViT, ScalableViT and T2T-ViT also on their kernel route (the
  split Functions on the CPU); every dropout at 0.1 with a generator a data
  rank against the one-process steps on those draws, and without a
  generator a ``ValueError``; the plan's cuts cover at least 80 % of each
  model's hot matmul weights.

The group has a 60 s timeout and the ranks a join deadline, as the other
tensor-parallel tests', so a failed rank fails the test instead of hanging
it.
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

import torch_tensor_parallel_rest_worker as worker  # noqa: E402
from torch_tp_emulation import diff, split_grads  # noqa: E402
from vit_tpu.models import ats_vit as jax_ats  # noqa: E402
from vit_tpu.models import cct as jax_cct  # noqa: E402
from vit_tpu.models import scalable_vit as jax_svit  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.models import ats_vit, cct, scalable_vit  # noqa: E402
from vit_tpu_torch.ops import tensor_parallel  # noqa: E402
from vit_tpu_torch.parallel import sharding  # noqa: E402

WORLD = 4
JOIN_TIMEOUT_S = 240
TOL, JAX_TOL = 1e-5, 1e-4
RATE, SEED = 0.1, 11


def random_variables(module, x, rng, **kw):
    """Flax variables of ``module`` on the shapes its init gives, every leaf
    drawn from ``rng``: the norms' scales around 1, their shifts and the
    biases around 0, the tokens and positions at unit scale, the kernels
    scaled by their fan-in."""
    shapes = jax.eval_shape(lambda a: module.init(jax.random.PRNGKey(0), a, **kw),
                            jnp.asarray(x))

    def leaf(path, s):
        draw = rng.standard_normal(s.shape)
        name = path[-1].key
        if name in ("g", "scale"):
            return (1.0 + 0.1 * draw).astype(np.float32)
        if name in ("b", "bias"):
            return (0.1 * draw).astype(np.float32)
        if name in ("cls_token", "pos_embedding", "positional_emb"):
            return draw.astype(np.float32)
        return (draw / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


# --- the split attentions, emulated in one process --------------------------

# name: (port module, vit_tpu module, input shape); 4 heads, so that t 2 and
# t 4 both split them, dropout 0.1 where the module has one.
MODULES = {
    "cct": (lambda: cct.CCTAttention(16, 4, RATE, RATE, device="cpu"),
            lambda: jax_cct.CCTAttention(16, 4), (2, 9, 16)),
    "ats": (lambda: ats_vit.ATSAttention(16, 4, 8, RATE, output_num_tokens=4, device="cpu"),
            lambda: jax_ats.ATSAttention(16, 4, 8, output_num_tokens=4), (2, 9, 16)),
    "iwsa": (lambda: scalable_vit.InteractiveWindowedSelfAttention(
        16, 4, 4, 8, 8, RATE, device="cpu"),
        lambda: jax_svit.InteractiveWindowedSelfAttention(16, 4, 4, 8, 8), (2, 8, 8, 16)),
    "ssa": (lambda: scalable_vit.ScalableSelfAttention(16, 4, 10, 8, RATE, 2, device="cpu"),
            lambda: jax_svit.ScalableSelfAttention(16, 4, 10, 8, reduction_factor=2),
            (2, 8, 8, 16)),
}


@pytest.fixture(scope="module")
def cases():
    """Each module's port and ``vit_tpu`` forms on one set of Flax weights,
    its input and a cotangent, from one seed."""
    out = {}
    for i, (name, (port, flax, shape)) in enumerate(MODULES.items()):
        rng = np.random.default_rng(20 + i)
        x = rng.standard_normal(shape).astype(np.float32)
        jax_module = flax()
        kw = {"mask": jnp.ones(shape[:2], bool)} if name == "ats" else {}
        variables = random_variables(jax_module, x, rng, **kw)
        module = port()
        state = {k.removeprefix("attn."): v for k, v in
                 state_dict_from_flax({"params": {"attn": variables["params"]}}).items()}
        module.load_state_dict(state, strict=True)
        out_shape = (shape[0], 4 + 1, shape[2]) if name == "ats" else shape  # 4 tokens + cls
        dy = rng.standard_normal(out_shape).astype(np.float32)
        out[name] = (module, jax_module, variables, torch.from_numpy(x), torch.from_numpy(dy))
    return out


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(tensor_parallel, "all_reduce_sum", lambda t, group: group.all_reduce(t))
    monkeypatch.setattr(ats_vit, "sample_gumbel", lambda generator, shape, eps=1e-6:
                        torch.from_numpy(worker.gumbel_table(shape)))


def _grads(module, x, dy, training):
    """The output (and ATS-ViT's sampled ids), the input gradient and every
    parameter's, the dropout drawn from a generator on :data:`SEED`."""
    module.train(training)
    xs = x.clone().requires_grad_()
    mask = (torch.ones(x.shape[:2], dtype=torch.bool),) if isinstance(
        module, ats_vit.ATSAttention) else ()
    y = module(xs, *mask, generator=torch.Generator().manual_seed(SEED))
    ids = None
    if isinstance(y, tuple):
        y, _, ids = y
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(y, [xs, *params], dy)
    return (y.detach(), ids), grads[0], dict(zip(names, grads[1:]))


def _jax_grads(jax_module, variables, x, dy):
    """``vit_tpu``'s module in eval: its output (and sampled ids) and VJP,
    the parameters' as the port's names."""
    mask = (jnp.ones(x.shape[:2], bool),) if isinstance(jax_module, jax_ats.ATSAttention) \
        else ()

    def apply(params, x):
        y = jax_module.apply({"params": params}, x, *mask)
        return y[0] if isinstance(y, tuple) else y

    y, vjp = jax.vjp(apply, variables["params"], jnp.asarray(x.numpy()))
    grads = vjp(jnp.asarray(dy.numpy()))
    params = {k.removeprefix("attn."): v for k, v in state_dict_from_flax(
        {"params": {"attn": jax.tree.map(np.asarray, grads[0])}}).items()}
    full = jax_module.apply(variables, jnp.asarray(x.numpy()), *mask)
    ids = np.asarray(full[2]) if isinstance(full, tuple) else None
    return np.asarray(y), np.asarray(grads[1]), params, ids


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", MODULES)
def test_split_attention_matches_unsplit_and_vit_tpu(emulated, cases, monkeypatch, name, t):
    module, jax_module, variables, x, dy = cases[name]
    for training in (True, False):
        (y_ref, ids_ref), dx_ref, params_ref = _grads(module, x, dy, training)
        outs, dxs, params, differ, _ = split_grads(
            module, t, lambda m: _grads(m, x, dy, training))
        assert differ == []
        for (y, ids), dx in zip(outs, dxs):
            assert torch.equal(y, outs[0][0]) and torch.equal(dx, dxs[0])
            assert ids is None or torch.equal(ids, ids_ref)  # every rank draws one token set
        assert diff(outs[0][0], y_ref) <= TOL and diff(dxs[0], dx_ref) <= TOL
        assert set(params) == set(params_ref)
        for k, want in params_ref.items():
            assert diff(params[k], want) <= TOL, (k, diff(params[k], want))

    with monkeypatch.context() as mp_:
        mp_.setattr(jax_ats, "sample_gumbel",
                    lambda key, shape, eps=1e-6: jnp.asarray(worker.gumbel_table(shape)))
        y_jax, dx_jax, params_jax, ids_jax = _jax_grads(jax_module, variables, x, dy)
    (y, ids), dx = outs[0], dxs[0]
    assert ids_jax is None or np.array_equal(ids.numpy(), ids_jax)
    assert diff(y, y_jax) <= JAX_TOL and diff(dx, dx_jax) <= JAX_TOL
    for k, want in params_jax.items():
        assert diff(params[k], want) <= JAX_TOL, (k, diff(params[k], want))


def test_iwsa_needs_f_on_v(emulated, cases, monkeypatch):
    """Without ``f`` on v each rank's v gradient covers only its heads'
    attention share and its local-module channels: the forward holds,
    ``to_v``'s gradient and the input gradient miss."""
    module, _, _, x, dy = cases["iwsa"]
    (y_ref, _), dx_ref, params_ref = _grads(module, x, dy, False)
    monkeypatch.setattr(tensor_parallel, "copy_to_model_parallel", lambda t, group: t)
    outs, dxs, params, _, _ = split_grads(module, 2, lambda m: _grads(m, x, dy, False))
    assert diff(outs[0][0], y_ref) <= TOL
    assert diff(dxs[0], dx_ref) > 100 * TOL
    assert diff(params["to_v.weight"], params_ref["to_v.weight"]) > 100 * TOL


def test_cct_attention_dropout_takes_the_ranks_heads(cases):
    """``dropout_shard`` over the head axis: each rank's slice of the full
    ``(b, heads, n, n)`` mask, drawn once from the generator."""
    from vit_tpu_torch.layers.common import ModelShard, dropout, dropout_shard

    attn = torch.rand(2, 4, 9, 9)
    full = dropout(attn, RATE, True, torch.Generator().manual_seed(SEED))
    for r in range(2):
        part = dropout_shard(attn[:, 2 * r:2 * r + 2], RATE, True,
                             torch.Generator().manual_seed(SEED), ModelShard(None, r, 2), dim=1)
        assert torch.equal(part, full[:, 2 * r:2 * r + 2])


# --- shard_params without a group -------------------------------------------

@pytest.mark.parametrize("name", [*worker.MODELS, "distill t2t"])
def test_units_cover_the_rule_table(name):
    """Every parameter the rule table shards belongs to a module
    ``shard_params`` splits or runs whole; each split unit's cuts name its
    own tensors, and those beyond the rule table are the heads' own (CCT's
    ``proj``, ScalableViT's ``to_k`` and IWSA's local module); IWSA's
    ``to_v`` is the one sharded parameter kept whole.  What runs whole at
    tp 2: T2T-ViT's token transformers."""
    from torch.distributed.tensor import Shard

    model = worker.build(name)
    units, transformers = sharding._units(model)
    sharding._refuse(model, units, transformers)
    split = [u for u in units if not sharding._runs_whole(u, 2)]
    whole = sorted(u.path for u in units if sharding._runs_whole(u, 2))
    covered = {f"{u.path}.{k}" for u in split for k in u.cuts}
    sharded = {k for k, spec in sharding.param_specs(model).items() if isinstance(spec, Shard)}
    assert all(k.startswith(tuple(f"{p}." for p in whole)) or k.endswith("iwsa.to_v.weight")
               for k in sharded - covered), sorted(sharded - covered)
    assert {k.rsplit(".", 2)[-2] for k in covered - sharded} <= {
        "proj", "to_k", "local_interactive_module"}
    for u in split:
        assert set(u.cuts) <= {k for k, _ in u.module.named_parameters()}, u.path
    if "t2t" in name:
        assert whole == [f"t2t_transformer_{i}.layers.0.{m}" for i in (0, 1)
                         for m in ("attn", "mlp")]
    else:
        assert whole == []


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


def _placements(mesh, state):
    """``vit_tpu``'s ``state_shardings``, each leaf its rule table would cut
    along a width the axis does not divide replicated: T2T-ViT's token
    transformers (``to_qkv`` 441 and 3969 wide, MLPs 147 and 1323), which
    its ``compile_step`` refuses to place.  GSPMD keeps the unsharded
    numbers either way."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vit_tpu.parallel import train as jax_train

    def fit(sharding, leaf):
        spec = tuple(sharding.spec) + (None,) * (leaf.ndim - len(sharding.spec))
        if all(ax is None or leaf.shape[i] % mesh.shape[ax] == 0 for i, ax in enumerate(spec)):
            return sharding
        return NamedSharding(mesh, P())

    return jax.tree.map(fit, jax_train.state_shardings(mesh, state), state)


def _jax_steps(name, variables, images, labels):
    """``vit_tpu``'s step on a (2, 2) mesh of the virtual CPU devices, the
    parameters placed by its rule table (:func:`_placements`), jitted as its
    ``compile_step`` jits it (ATS-ViT's Gumbel table injected, one row an
    image of the batch, as the ranks slice it)."""
    from vit_tpu.parallel import mesh as mesh_lib
    from vit_tpu.parallel import train as jax_train

    _, cfg, _, lr = worker.MODELS[name]
    model, tx = _flax_class(name)(**cfg), optax.sgd(lr)
    mesh = mesh_lib.make_mesh(worker.MESH, devices=jax.devices()[:WORLD])
    step, _ = jax_train.make_train_step(
        lambda p, x, rng: model.apply({"params": p}, x), tx, mesh, donate=False)
    state = jax_train.create_train_state(variables["params"], tx)
    placed, data = _placements(mesh, state), mesh_lib.batch_sharding(mesh)
    rep = mesh_lib.replicated(mesh)
    step = jax.jit(step, in_shardings=(placed, data, data, rep), out_shardings=(placed, rep))
    state = jax.device_put(state, placed)
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
        variables = random_variables(_flax_class(name)(**cfg), images, rng)
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
        with pytest.MonkeyPatch.context() as mp_:
            mp_.setattr(jax_ats, "sample_gumbel", lambda key, shape, eps=1e-6: jnp.asarray(
                worker.gumbel_table(shape)))
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
    return {"ranks": ranks, "whole": whole, "jax": jax_runs}


def _run_diff(got, want) -> float:
    """The largest :func:`diff` of the losses and of the state."""
    return max([diff(a, b) for a, b in zip(got["losses"], want["losses"])]
               + [diff(got["state"][k], v) for k, v in want["state"].items()])


def _model(tag) -> str:
    for suffix in (" kernels", " tp 4", " dropout"):
        tag = tag.removesuffix(suffix)
    return tag


STEP_TAGS = [*worker.MODELS, *(f"{k} kernels" for k in worker.KERNEL_ROUTE),
             *(f"{k} tp 4" for k in worker.MODELS)]
TAGS = STEP_TAGS + [f"{k} dropout" for k in worker.MODELS]


def test_ranks_finished(runs):
    for rank in runs["ranks"]:
        assert "error" not in rank, rank.get("error")


@pytest.mark.parametrize("tag", TAGS)
def test_split_step_matches_one_process(runs, tag):
    want = runs["whole"][tag if tag.endswith("dropout") else _model(tag)]
    for rank in runs["ranks"]:
        assert set(rank[tag]["state"]) == set(want["state"])
        assert _run_diff(rank[tag], want) <= TOL, _run_diff(rank[tag], want)


@pytest.mark.parametrize("tag", STEP_TAGS)
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


def test_ats_ranks_sample_one_token_set(runs):
    """Every rank's sampled ids after the last layer, split (2, 2) and (1,
    4), equal the one-process model's on those images under the injected
    noise."""
    want = runs["whole"]["ats"]["ids"]
    for rank in runs["ranks"]:
        for tag in ("ats", "ats tp 4"):
            row, ids = rank[tag]["ids"]
            assert torch.equal(ids, want[row:row + ids.shape[0]]), tag


@pytest.mark.parametrize("name", list(worker.MODELS))
def test_dropout_without_a_generator_raises(runs, name):
    for rank in runs["ranks"]:
        refusal = rank[f"{name} without a generator"]
        assert refusal.startswith("ValueError: dropout in training draws from an explicit "
                                  "generator"), refusal


HOT = ("to_q", "to_k", "to_v", "to_qkv", "to_kv", "to_out", "proj", "fc1", "fc2")


@pytest.mark.parametrize("name", list(worker.MODELS))
def test_plan_covers_the_hot_matmuls(runs, name):
    """``vit_tpu``'s zoo audit on the port's plan at tp 2: at least 80 % of
    the attention projections' and MLP halves' weights split (ScalableViT's
    11 of 12 a layer, IWSA's ``to_v`` whole).  T2T-ViT's two token
    transformers cannot split (one head without an output projection, MLPs
    147 and 1323 wide) and run whole: their 6 of its 14 are left out of the
    count, and every other one splits."""
    run = runs["ranks"][0][name]
    state, kinds = run["state"], run["kinds"]
    hot = [k for k, v in state.items()
           if k.endswith("weight") and v.dim() in (2, 4)
           and any(f".{t}." in f".{k}" for t in HOT)]
    if name == "t2t":
        whole = [k for k in hot if k.startswith(tuple(f"{p}." for p in run["whole"]))]
        assert len(whole) == 6 and not set(whole) & set(kinds)
        hot = [k for k in hot if k not in whole]
        assert all(k in kinds for k in hot)
    split = [k for k in hot if k in kinds]
    assert hot and len(split) / len(hot) >= 0.8, sorted(set(hot) - set(split))
    if name == "scalable":
        assert sorted(set(hot) - set(split)) == [
            f"stage_{i}.layers.0.iwsa.to_v.weight" for i in range(2)]


def test_split_modules_keep_their_heads_and_units(runs):
    for rank in runs["ranks"]:
        run = rank["scalable"]
        # stage 1: 2 heads, q and k 40 wide, v 32 wide: one head a rank
        assert run["local"]["stage_0.layers.0.ssa.to_k.weight"] == (40, 32, 4, 4)
        assert run["local"]["stage_0.layers.0.iwsa.to_v.weight"] == (64, 32, 1, 1)  # whole
        assert run["local"]["stage_0.layers.0.iwsa.local_interactive_module.weight"] == \
            (32, 64, 3, 3)
        assert run["replicated"] == [f"stage_{i}.layers.0.iwsa.to_v.weight" for i in range(2)]
        assert run["heads"]["stage_1.layers.0.iwsa"] == 1 and run["whole"] == []
        run = rank["cct"]
        assert run["local"]["block_0.self_attn.proj.weight"] == (32, 16)
        assert run["local"]["block_0.linear1.weight"] == (64, 32)  # whole
        assert run["heads"]["block_1.self_attn"] == 1
        run = rank["t2t"]
        assert run["local"]["t2t_transformer_1.layers.0.mlp.fc1.weight"] == (1323, 1323)
        assert run["local"]["transformer.layers.0.attn.to_qkv.weight"] == (96, 64)
        assert len(run["whole"]) == 4
        # Over four ranks: the two-head attentions run whole, the MLPs split.
        assert rank["ats tp 4"]["whole"] == [f"transformer.layers.{i}.attn" for i in range(3)]
        assert rank["cct tp 4"]["whole"] == ["block_0.self_attn", "block_1.self_attn"]
        assert len(rank["scalable tp 4"]["whole"]) == 4
        assert rank["scalable tp 4"]["local"]["stage_0.layers.0.ff1.fc1.weight"] == (32, 32, 1, 1)
        assert len(rank["t2t tp 4"]["whole"]) == 4 + 2


def test_kernel_route_runs_the_split_forms(runs):
    """The split Functions' route opened on the CPU: ATS-ViT's 3 fused MLPs
    a forward, ScalableViT's 2 SSAs on row 6's split form and 4 conv-MLPs,
    T2T-ViT's 2 attention blocks and 2 MLPs split and its 2 token MLPs
    whole, a forward."""
    steps = worker.STEPS
    for rank in runs["ranks"]:
        assert rank["ats kernels"]["calls"] == [("mlp", True)] * 3 * steps
        calls = rank["scalable kernels"]["calls"]
        assert sorted(calls) == sorted([("ssa", True)] * 2 * steps + [("mlp", True)] * 4 * steps)
        calls = rank["t2t kernels"]["calls"]
        assert sorted(calls) == sorted([("mlp", False)] * 2 * steps
                                       + [("attention", True), ("mlp", True)] * 2 * steps)
        assert all(rank[name]["calls"] == [] for name in worker.MODELS)
