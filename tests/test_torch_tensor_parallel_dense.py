"""Tensor parallelism for the dense five (CaiT, DeepViT, Parallel ViT, the
patch merger's ViT, CrossViT), on the CPU.

- The head-mixing split (CaiT's talking heads, with and without a context,
  and DeepViT's re-attention, split by heads) with t in {2, 4} ranks
  emulated by threads in one process (an all-reduce behind a barrier, the
  ranks' terms summed in rank order): the forward, the input gradients and
  every parameter's gradient, the cut mixing matrices' gathered, within
  1e-5 of the unsplit plain module in f32 and within 1e-4 of ``vit_tpu``'s
  module from the same Flax weights.  Without the ``f`` after the
  replicated middle (``mix_across_heads``' ``copy_to_model_parallel``) the
  gradients miss that bound.
- A module that runs whole inside a split model (``layers.common.WHOLE``:
  ``Attention``, ``MLP`` and the three attentions of these models) runs no
  collective, draws its dropout from the generator and equals the unsplit
  module on it, and raises without one.
- ``shard_params``' units cover every parameter the rule table shards.
- One spawn of four gloo ranks (``torch_tensor_parallel_dense_worker.run``,
  which also takes the port's one-process steps, a share a rank): each model
  at its own test's configuration, two SGD steps on a batch of 8 over a
  (2, 2) ``data`` x ``model`` mesh and over a (1, 4) one, from the same Flax
  weights, held within 1e-5 of the port's one-process step and within 1e-4
  of ``vit_tpu``'s ``make_train_step`` on a (2, 2) mesh of the virtual CPU
  devices, losses and gathered parameters, the ranks' states bit for bit;
  DeepViT, the merger's ViT and CrossViT also on their split Functions'
  route; every dropout at 0.1 with a generator a data rank against the
  one-process steps on those draws; a split model in training with an active
  dropout and no generator raises; the plan's cuts cover at least 80 % of
  each model's hot matmul weights (``vit_tpu``'s zoo audit, on the port's
  plan) and all of CaiT's; a checkpoint of the split CaiT is written whole,
  its mixing matrices included, and restores into an unsplit model.

The group has a 60 s timeout and the ranks a join deadline, as the other
tensor-parallel tests', so a failed rank fails the test instead of hanging
it.
"""

import copy
import socket
import threading
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import torch_tensor_parallel_dense_worker as worker  # noqa: E402
from torch_parity import random_variables  # noqa: E402
from vit_tpu.models import cait as jax_cait  # noqa: E402
from vit_tpu.models import deepvit as jax_deepvit  # noqa: E402
from vit_tpu_torch import state_dict_from_flax  # noqa: E402
from vit_tpu_torch.interop.checkpoint import restore_checkpoint  # noqa: E402
from vit_tpu_torch.layers import common  # noqa: E402
from vit_tpu_torch.models.cait import TalkingHeadsAttention  # noqa: E402
from vit_tpu_torch.models.cross_vit import CrossAttention  # noqa: E402
from vit_tpu_torch.models.deepvit import ReAttention  # noqa: E402
from vit_tpu_torch.ops import tensor_parallel  # noqa: E402
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


# --- the head-mixing split, emulated in one process -------------------------

class _Ranks:
    """t ranks as threads: an all-reduce (a sum in rank order, the same bits
    on every rank) behind a barrier, and a count of the calls."""

    def __init__(self, t):
        self.barrier = threading.Barrier(t, timeout=60)
        self.slots, self.calls = [None] * t, 0

    def all_reduce(self, rank, x):
        self.slots[rank] = x.clone()
        self.barrier.wait()
        total = self.slots[0].clone()
        for s in self.slots[1:]:
            total += s
        self.barrier.wait()
        if rank == 0:
            self.calls += 1
        return x.copy_(total)


class _Group:
    """One rank's model group: what ``ModelShard.group`` holds."""

    def __init__(self, ranks, rank):
        self.ranks, self.rank = ranks, rank

    def all_reduce(self, x):
        return self.ranks.all_reduce(self.rank, x)


# (module, dim, heads, dim_head, tokens, context tokens or None)
MIXING = {"talking heads": ("cait", 16, 4, 8, 9, None),
          "talking heads, context": ("cait", 16, 4, 8, 1, 9),
          "re-attention": ("deepvit", 16, 4, 8, 9, None)}


def _mixing_case(case):
    """The port's module, ``vit_tpu``'s, their Flax variables, the inputs
    and a cotangent, from one seed."""
    kind, dim, heads, dh, n, m = MIXING[case]
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, n, dim)).astype(np.float32)
    ctx = None if m is None else rng.standard_normal((2, m, dim)).astype(np.float32)
    if kind == "cait":
        jax_module = jax_cait.TalkingHeadsAttention(dim, heads, dh)
        module = TalkingHeadsAttention(dim, heads, dh, device="cpu")
    else:
        jax_module = jax_deepvit.ReAttention(dim, heads, dh)
        module = ReAttention(dim, heads, dh, device="cpu")
    kw = {} if ctx is None else {"context": jnp.asarray(ctx)}
    variables = random_variables(jax_module, x, rng, **kw)
    state = {k.removeprefix("attn."): v for k, v in
             state_dict_from_flax({"params": {"attn": variables["params"]}}).items()}
    module.load_state_dict(state, strict=True)
    dy = rng.standard_normal((2, n, dim)).astype(np.float32)
    inputs = [torch.from_numpy(x)] + ([] if ctx is None else [torch.from_numpy(ctx)])
    return module, jax_module, variables, inputs, torch.from_numpy(dy)


def _grads(module, inputs, dy):
    """The output, the inputs' gradients and every parameter's."""
    xs = [t.clone().requires_grad_() for t in inputs]
    y = module(*xs)
    names, params = zip(*module.named_parameters())
    grads = torch.autograd.grad(y, [*xs, *params], dy)
    return y.detach(), list(grads[:len(xs)]), dict(zip(names, grads[len(xs):]))


def _split_grads(module, t, inputs, dy):
    """:func:`_grads` of ``module`` split over t emulated ranks: the output
    and input gradients of every rank, each parameter's gradient gathered
    (a cut one joined, a whole one rank 0's), the whole ones on which the
    ranks differ, and the all-reduces run."""
    ranks, kinds, modules = _Ranks(t), {}, []
    for r in range(t):
        m = copy.deepcopy(module)
        units, _ = sharding._units(m)
        for u in units:
            sharding._split(u, common.ModelShard(_Group(ranks, r), r, t))
            kinds.update({sharding._join(u.path, k): kind for k, kind in u.cuts.items()})
        modules.append(m)
    out, errors = [None] * t, []

    def work(r):
        try:
            out[r] = _grads(modules[r], inputs, dy)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            ranks.barrier.abort()

    threads = [threading.Thread(target=work, args=(r,)) for r in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    params, differ = {}, []
    for name in out[0][2]:
        pieces = [o[2][name] for o in out]
        if name in kinds:
            params[name] = _join(pieces, kinds[name])
        else:
            params[name] = pieces[0]
            if not all(torch.equal(p, pieces[0]) for p in pieces):
                differ.append(name)
    return [o[0] for o in out], [o[1] for o in out], params, differ, ranks.calls


@pytest.fixture
def emulated(monkeypatch):
    monkeypatch.setattr(tensor_parallel, "all_reduce_sum", lambda t, group: group.all_reduce(t))


def _jax_grads(jax_module, variables, inputs, dy):
    """``vit_tpu``'s module: its output and VJP, the parameters' as the
    port's names."""
    def apply(params, *xs):
        kw = {} if len(xs) == 1 else {"context": xs[1]}
        return jax_module.apply({"params": params}, xs[0], **kw)

    y, vjp = jax.vjp(apply, variables["params"], *(jnp.asarray(t.numpy()) for t in inputs))
    grads = vjp(jnp.asarray(dy.numpy()))
    params = {k.removeprefix("attn."): v for k, v in state_dict_from_flax(
        {"params": {"attn": jax.tree.map(np.asarray, grads[0])}}).items()}
    return np.asarray(y), [np.asarray(g) for g in grads[1:]], params


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("case", MIXING)
def test_split_head_mix_matches_unsplit_and_vit_tpu(emulated, case, t):
    module, jax_module, variables, inputs, dy = _mixing_case(case)
    y_ref, dx_ref, params_ref = _grads(module, inputs, dy)
    ys, dxs, params, differ, calls = _split_grads(module, t, inputs, dy)
    assert differ == []  # reattn_norm's γ and β, to_out's bias: whole on every rank
    # g after the mix and after the out-projection forward; backward f after
    # the middle and at each input
    assert calls == 2 + 1 + len(inputs)
    for y, dx in zip(ys, dxs):
        assert torch.equal(y, ys[0]) and all(torch.equal(a, b) for a, b in zip(dx, dxs[0]))
    assert _diff(ys[0], y_ref) <= TOL
    for got, want in zip(dxs[0], dx_ref):
        assert _diff(got, want) <= TOL
    assert set(params) == set(params_ref)
    for k, want in params_ref.items():
        assert float(want.abs().max()) > 0, k
        assert _diff(params[k], want) <= TOL, (k, _diff(params[k], want))

    y_jax, dx_jax, params_jax = _jax_grads(jax_module, variables, inputs, dy)
    assert _diff(ys[0], y_jax) <= JAX_TOL
    for got, want in zip(dxs[0], dx_jax):
        assert _diff(got, want) <= JAX_TOL
    for k, want in params_jax.items():
        assert _diff(params[k], want) <= JAX_TOL, (k, _diff(params[k], want))


@pytest.mark.parametrize("case", MIXING)
def test_split_head_mix_needs_f_after_the_middle(emulated, monkeypatch, case):
    """Without ``mix_across_heads``' ``f`` each rank's gradient at the
    softmax's (the norm's) output covers only the heads it reads next: the
    forward holds, the input gradients and the mixing matrix's miss."""
    module, _, _, inputs, dy = _mixing_case(case)
    y_ref, dx_ref, params_ref = _grads(module, inputs, dy)
    monkeypatch.setattr(tensor_parallel, "copy_to_model_parallel", lambda x, group: x)
    ys, dxs, params, _, _ = _split_grads(module, 2, inputs, dy)
    assert _diff(ys[0], y_ref) <= TOL
    assert max(_diff(got, want) for got, want in zip(dxs[0], dx_ref)) > 100 * TOL
    mix = "mix_heads_pre_attn" if "mix_heads_pre_attn" in params else "reattn_weights"
    assert _diff(params[mix], params_ref[mix]) > 100 * TOL


# --- a module that runs whole inside a split model --------------------------

WHOLE_MODULES = {
    "Attention": lambda: common.Attention(16, 3, 8, 0.1, device="cpu"),
    "MLP": lambda: common.MLP(16, 32, 0.1, device="cpu"),
    "TalkingHeadsAttention": lambda: TalkingHeadsAttention(16, 3, 8, 0.1, device="cpu"),
    "ReAttention": lambda: ReAttention(16, 3, 8, 0.1, device="cpu"),
    "CrossAttention": lambda: CrossAttention(16, 3, 8, 0.1, device="cpu"),
}


@pytest.mark.parametrize("name", WHOLE_MODULES)
def test_whole_module_runs_no_collective(monkeypatch, name):
    """``shard = WHOLE`` (its heads do not divide over the axis): forward
    and backward in training run no all-reduce (one over ``group=None``
    would sum over the whole world), the dropout draws from the generator
    and equals the unsplit module's on the same seed, and raises without
    one."""
    reduced = []

    def record(t, group):
        reduced.append(group)
        return t

    monkeypatch.setattr(tensor_parallel, "all_reduce_sum", record)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda *a, **k: reduced.append(a))
    torch.manual_seed(3)
    module = WHOLE_MODULES[name]().train()
    whole = copy.deepcopy(module)
    whole.shard = common.WHOLE
    x = torch.randn(2, 5, 16)

    def run(m):
        xs = x.clone().requires_grad_()
        y = m(xs, generator=torch.Generator().manual_seed(4))
        dx, *dp = torch.autograd.grad(y, [xs, *m.parameters()], torch.ones_like(y))
        return y, dx, dp

    got, want = run(whole), run(module)
    assert reduced == []
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert all(torch.equal(a, b) for a, b in zip(got[2], want[2]))
    with pytest.raises(ValueError, match="explicit generator"):
        whole(x)


# --- shard_params without a group -------------------------------------------

@pytest.mark.parametrize("name", list(worker.MODELS))
def test_units_cover_the_rule_table(name):
    """Every parameter the rule table shards belongs to a module
    ``shard_params`` splits; each unit's cuts name its own tensors; the
    mixing matrices are cut with their heads beyond the rule table."""
    from torch.distributed.tensor import Shard

    model = worker.build(name)
    units, transformers = sharding._units(model)
    assert transformers == {}
    sharding._refuse(model, 2, units, transformers)
    covered = {f"{u.path}.{k}" for u in units for k in u.cuts}
    sharded = {k for k, spec in sharding.param_specs(model).items() if isinstance(spec, Shard)}
    assert sharded <= covered, sorted(sharded - covered)
    assert {k.rsplit(".", 1)[-1] for k in covered - sharded} <= {
        "mix_heads_pre_attn", "mix_heads_post_attn", "reattn_weights"}
    for u in units:
        assert set(u.cuts) <= {k for k, _ in u.module.named_parameters()}, u.path


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
    return {"ranks": ranks, "workdir": workdir, "whole": whole, "jax": jax_runs}


def _run_diff(got, want) -> float:
    """The largest :func:`_diff` of the losses and of the state."""
    return max([_diff(a, b) for a, b in zip(got["losses"], want["losses"])]
               + [_diff(got["state"][k], v) for k, v in want["state"].items()])


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


@pytest.mark.parametrize("name", list(worker.MODELS))
def test_dropout_without_a_generator_raises(runs, name):
    for rank in runs["ranks"]:
        refusal = rank[f"{name} without a generator"]
        assert refusal.startswith("ValueError: dropout in training draws from an explicit "
                                  "generator"), refusal


HOT = ("to_q", "to_k", "to_v", "to_qkv", "to_kv", "to_out", "fc1", "fc2")


@pytest.mark.parametrize("name", list(worker.MODELS))
def test_plan_covers_the_hot_matmuls(runs, name):
    """``vit_tpu``'s zoo audit on the port's plan at tp 2: at least 80 % of
    the attention projections' and MLP halves' weights split, and all of
    CaiT's ``to_q``, ``to_kv``, ``to_out``, ``fc1`` and ``fc2``."""
    state, kinds = runs["ranks"][0][name]["state"], runs["ranks"][0][name]["kinds"]
    hot = [k for k, v in state.items()
           if k.endswith("weight") and v.dim() == 2 and any(f".{t}." in f".{k}" for t in HOT)]
    split = [k for k in hot if k in kinds]
    assert hot and len(split) / len(hot) >= 0.8, sorted(set(hot) - set(split))
    if name == "cait":
        assert split == hot and len(hot) == 5 * 5  # 5 layers, 5 hot weights each


def test_split_modules_keep_their_heads_and_units(runs):
    for rank in runs["ranks"]:
        run = rank["cait"]
        # 4 heads of 8 at dim 32: two a rank; 32 of 64 hidden units
        assert run["local"]["patch_transformer.layers.0.attn.to_q.weight"] == (16, 32)
        assert run["local"]["cls_transformer.layers.1.attn.to_kv.weight"] == (32, 32)
        assert run["local"]["cls_transformer.layers.1.attn.to_out.0.weight"] == (32, 16)
        assert run["local"]["patch_transformer.layers.2.attn.mix_heads_pre_attn"] == (2, 4)
        assert run["local"]["patch_transformer.layers.2.attn.mix_heads_post_attn"] == (4, 2)
        assert run["local"]["patch_transformer.layerscale_attn_0"] == (1, 1, 32)
        assert run["kinds"]["cls_transformer.layers.0.attn.mix_heads_post_attn"] == sharding.ROW
        assert run["heads"]["patch_transformer.layers.0.attn"] == 2 and run["whole"] == []

        run = rank["deepvit"]
        assert run["local"]["layers.0.attn.to_qkv.weight"] == (48, 32)
        assert run["local"]["layers.0.attn.reattn_weights"] == (2, 4)
        assert run["local"]["layers.0.attn.reattn_norm.weight"] == (4,)
        assert run["local"]["layers.1.mlp.fc1.weight"] == (32, 32)

        run = rank["parallel vit"]
        assert run["local"]["attn_1_1.to_qkv.weight"] == (48, 32)
        assert run["kinds"]["mlp_0_1.fc2.weight"] == sharding.ROW

        run = rank["patch merger"]
        assert run["local"]["layers.3.attn.to_qkv.weight"] == (48, 32)  # 1 of 2 heads of 16
        assert run["local"]["patch_merger.queries"] == (3, 32)

        run = rank["crossvit"]
        assert run["local"]["sm_enc_0.attn_0.to_kv.weight"] == (16, 16)
        assert run["local"]["cross_attend_1.lg_attend_sm_0.to_q.weight"] == (8, 16)
        assert run["local"]["cross_attend_1.sm_project_in_0.weight"] == (24, 16)  # whole
        assert run["local"]["lg_enc_1.mlp_1.fc1.weight"] == (16, 24)
        assert run["whole"] == []

        # Over four ranks: the two-head attentions run whole, their MLPs split.
        assert rank["patch merger tp 4"]["whole"] == [f"layers.{i}.attn" for i in range(4)]
        assert "layers.0.mlp.fc1.weight" in rank["patch merger tp 4"]["kinds"]
        assert len(rank["crossvit tp 4"]["whole"]) == 2 * (1 + 2 + 2)
        assert rank["crossvit tp 4"]["local"]["sm_enc_0.mlp_0.fc1.weight"] == (8, 16)
        for name in ("cait", "deepvit", "parallel vit"):
            assert rank[f"{name} tp 4"]["whole"] == []
        assert rank["cait tp 4"]["local"]["cls_transformer.layers.0.attn.mix_heads_pre_attn"] \
            == (1, 4)


def test_kernel_route_runs_the_split_mlps(runs):
    """The fused MLP's route opened on the CPU: DeepViT's 2, the merger's 4
    and CrossViT's 2 · (1 + 2) fused MLPs a forward, all split."""
    for rank in runs["ranks"]:
        for name, count in (("deepvit", 2), ("patch merger", 4), ("crossvit", 6)):
            assert rank[f"{name} kernels"]["calls"] == [("fused_mlp", True)] * (
                count * worker.STEPS), name
        assert all(rank[name]["calls"] == [] for name in worker.MODELS)


def test_checkpoint_of_a_split_model_is_whole(runs):
    """Written whole by rank 0 (the gathered state, CaiT's cut mixing
    matrices included), it restores into an unsplit model bit for bit."""
    tag = worker.CHECKPOINTED
    path = runs["workdir"] / f"ckpt {tag}" / f"checkpoint_{worker.STEPS}.pt"
    saved = torch.load(path, weights_only=True)
    gathered = runs["ranks"][0][tag]["state"]
    assert saved["step"] == worker.STEPS and set(saved["model"]) == set(gathered)
    assert all(torch.equal(saved["model"][k], v) for k, v in gathered.items())
    assert saved["model"]["patch_transformer.layers.1.attn.mix_heads_pre_attn"].shape == (4, 4)
    assert saved["model"]["cls_transformer.layers.0.attn.mix_heads_post_attn"].shape == (4, 4)
    model = worker.build(tag)
    restore_checkpoint(str(path), TrainState(model, torch.optim.SGD(model.parameters(), lr=0.1)))
    assert all(torch.equal(v, saved["model"][k]) for k, v in model.state_dict().items())
