"""The training objectives against ``vit_tpu``'s, on the CPU in f32: MAE,
SimMIM, MPP and ``DistillWrapper`` (soft and hard, integer and one-hot
labels), the loss and every gradient within 1e-4, the bar ``vit_tpu`` held
against TF.

Both packages get the same weights (``vit_tpu``'s through
``state_dict_from_flax``) and the same random draws: each objective's
module-level draw functions are replaced in both packages by ones that return
one seeded numpy draw, as ``tests/parity/test_objectives_parity.py`` does for
TF; MPP's inline ``jax.random.randint`` is replaced for the test's scope by
pytest's ``monkeypatch``.  Eval mode, the encoders at
``tests/unit/test_objectives.py``'s size (image 64, patch 16, dim 64, depth
2, heads 2 of 32) and with an inner width that is not the model's (4 heads
of 32 in 64).  The objectives' encoder trees have no ``head`` / ``head_norm``
(Flax creates only what a model calls): the test names the port's keys that
the converted tree lacks, exactly.
"""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vit_tpu import ViT as JaxViT  # noqa: E402
from vit_tpu.objectives import distill as jax_distill  # noqa: E402
from vit_tpu.objectives import mae as jax_mae  # noqa: E402
from vit_tpu.objectives import mpp as jax_mpp  # noqa: E402
from vit_tpu.objectives import simmim as jax_simmim  # noqa: E402
from vit_tpu_torch import ViT, state_dict_from_flax  # noqa: E402
from vit_tpu_torch.objectives import distill, mae, mpp, simmim  # noqa: E402
from vit_tpu_torch.parallel.train import make_loss_train_step  # noqa: E402

TOL = 1e-4
ENC = dict(image_size=64, patch_size=16, num_classes=10, dim=64, depth=2, heads=2,
           mlp_dim=128, dim_head=32)
ENC_INNER = dict(ENC, heads=4)  # inner 128 in a 64-wide model
NUM_PATCHES = 16


def _head_keys(prefix):
    return {f"{prefix}.{m}.{p}" for m in ("head", "head_norm") for p in ("weight", "bias")}


def _image(seed=0, b=2, uniform=False):
    rng = np.random.default_rng(seed)
    shape = (b, 64, 64, 3)
    return (rng.random(shape) if uniform else rng.standard_normal(shape)).astype(np.float32)


def _load(port, variables, absent=frozenset()):
    """Load the converted tree by the keys it has; exactly ``absent`` of the
    port's keys may be missing."""
    state = state_dict_from_flax(jax.tree.map(np.asarray, variables))
    missing, unexpected = port.load_state_dict(state, strict=False)
    assert set(missing) == set(absent) and not unexpected, (missing, unexpected)
    return port.eval()


def _jax_loss_and_grads(module, variables, *args):
    def loss_of(p):
        return module.apply({"params": p}, *args)

    loss, grads = jax.value_and_grad(loss_of)(variables["params"])
    return float(loss), state_dict_from_flax(jax.tree.map(np.asarray, grads))


def _check_loss_and_grads(port, loss, want_loss, want_grads):
    """The loss, and every gradient of the JAX tree; a port parameter JAX
    has no gradient for, or a zero one, may have none."""
    loss.backward()
    assert abs(loss.item() - want_loss) <= TOL, (loss.item(), want_loss)
    got = dict(port.named_parameters())
    for k, want in want_grads.items():
        g = got[k].grad
        g = torch.zeros_like(got[k]) if g is None else g
        assert float((g - want).abs().max()) <= TOL, k
    assert all(p.grad is None for k, p in got.items() if k not in want_grads)


def _encoder_fence(port, prefix, unused):
    """SURVEY §8.5's fence: every encoder parameter that the objective uses
    gets a nonzero gradient; the ones it does not use get none."""
    for k, p in port.named_parameters():
        if not k.startswith(prefix + "."):
            continue
        if k in unused:
            assert p.grad is None, k
        else:
            assert p.grad is not None and float(p.grad.abs().max()) > 0, k


def _permutations(seed=1, b=2):
    return np.stack([np.random.default_rng(seed + i).permutation(NUM_PATCHES)
                     for i in range(b)]).astype(np.int32)


@pytest.mark.parametrize("enc", [ENC, ENC_INNER], ids=["inner=dim", "inner!=dim"])
@pytest.mark.parametrize("decoder", [dict(decoder_dim=32, decoder_depth=2, decoder_heads=2,
                                          decoder_dim_head=16),
                                     dict(decoder_dim=64, decoder_depth=1)],
                         ids=["enc_to_dec", "same-width"])
def test_mae_loss_and_gradients_match_jax(monkeypatch, enc, decoder):
    img = _image()
    perm = _permutations()
    monkeypatch.setattr(jax_mae, "random_masking_indices", lambda key, b, n: jnp.asarray(perm))
    monkeypatch.setattr(mae, "random_masking_indices",
                        lambda g, b, n: torch.from_numpy(perm).long())
    jm = jax_mae.MAE(encoder=JaxViT(**enc), image_size=64, masking_ratio=0.75, **decoder)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want_loss, want_grads = _jax_loss_and_grads(jm, variables, jnp.asarray(img))

    port = _load(mae.MAE(ViT(**enc, device="cpu"), image_size=64, masking_ratio=0.75,
                         device="cpu", **decoder), variables, _head_keys("encoder"))
    assert (port.enc_to_dec is None) == (decoder["decoder_dim"] == enc["dim"])
    _check_loss_and_grads(port, port(torch.from_numpy(img)), want_loss, want_grads)
    _encoder_fence(port, "encoder", _head_keys("encoder") | {"encoder.cls_token"})


@pytest.mark.parametrize("enc", [ENC, ENC_INNER], ids=["inner=dim", "inner!=dim"])
def test_simmim_loss_and_gradients_match_jax(monkeypatch, enc):
    img = _image(2)
    idx = _permutations(5)[:, :8]
    monkeypatch.setattr(jax_simmim, "masked_topk_indices",
                        lambda key, b, n, k: jnp.asarray(idx))
    monkeypatch.setattr(simmim, "masked_topk_indices",
                        lambda g, b, n, k: torch.from_numpy(idx).long())
    jm = jax_simmim.SimMIM(encoder=JaxViT(**enc), image_size=64, masking_ratio=0.5)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want_loss, want_grads = _jax_loss_and_grads(jm, variables, jnp.asarray(img))

    port = _load(simmim.SimMIM(ViT(**enc, device="cpu"), image_size=64, masking_ratio=0.5,
                               device="cpu"), variables, _head_keys("encoder"))
    _check_loss_and_grads(port, port(torch.from_numpy(img)), want_loss, want_grads)
    _encoder_fence(port, "encoder", _head_keys("encoder") | {"encoder.cls_token"})


def _mpp_draws(seed=3, b=2, n=NUM_PATCHES, masked=8):
    rng = np.random.default_rng(seed)
    subset = np.zeros((b, n), bool)
    for row in subset:
        row[rng.choice(n, masked, replace=False)] = True
    return (subset, rng.random((b, n)) < 0.5, rng.random((b, n)) < 0.5,
            rng.integers(0, n, (b, n)).astype(np.int32))


@pytest.mark.parametrize("enc", [ENC, ENC_INNER], ids=["inner=dim", "inner!=dim"])
@pytest.mark.parametrize("probs", [dict(), dict(random_patch_prob=0.0, replace_prob=1.0)],
                         ids=["random-patches-and-mask-token", "mask-token-only"])
def test_mpp_loss_and_gradients_match_jax(monkeypatch, enc, probs):
    """All four draws injected: the subset, the random-patch and mask-token
    choices (keyed by their probability), the random patches."""
    img = _image(4, uniform=True)
    subset, rand_choice, replace_choice, patches = _mpp_draws()
    random_prob = probs.get("random_patch_prob", 0.5) / (1 - probs.get("replace_prob", 0.5)) \
        if probs.get("random_patch_prob", 0.5) > 0 else None
    choice = {random_prob: rand_choice, probs.get("replace_prob", 0.5): replace_choice}
    monkeypatch.setattr(jax_mpp, "get_mask_subset_with_prob",
                        lambda b, n, p, key: jnp.asarray(subset))
    monkeypatch.setattr(jax_mpp, "prob_mask_like", lambda shape, p, key: jnp.asarray(choice[p]))
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi: jnp.asarray(patches))
    monkeypatch.setattr(mpp, "get_mask_subset_with_prob",
                        lambda b, n, p, g: torch.from_numpy(subset))
    monkeypatch.setattr(mpp, "prob_mask_like", lambda shape, p, g: torch.from_numpy(choice[p]))
    monkeypatch.setattr(mpp, "randint", lambda g, shape, lo, hi: torch.from_numpy(patches).long())
    jm = jax_mpp.MPP(transformer=JaxViT(**enc), patch_size=16, image_size=64, mask_prob=0.5,
                     **probs)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(img))
    want_loss, want_grads = _jax_loss_and_grads(jm, variables, jnp.asarray(img))

    port = _load(mpp.MPP(ViT(**enc, device="cpu"), patch_size=16, image_size=64, mask_prob=0.5,
                         device="cpu", **probs), variables, _head_keys("transformer"))
    loss = port(torch.from_numpy(img))
    assert 2.0 < loss.item() < 12.0  # CE over 2^9 buckets starts near log(512)
    _check_loss_and_grads(port, loss, want_loss, want_grads)
    _encoder_fence(port, "transformer", _head_keys("transformer"))


def test_mpp_buckets_labels():
    """One patch of constant colour 0.9, one bit a channel: bucket 1 per
    channel, label 1 + 2 + 4 = 7 (``tests/unit/test_objectives.py``)."""
    loss = mpp.MPPLoss(patch_size=2, channels=3, output_channel_bits=1, max_pixel_val=1.0)
    logits = torch.zeros(1, 1, 8)
    logits[0, 0, 7] = 100.0
    assert loss(logits, torch.full((1, 2, 2, 3), 0.9), torch.ones(1, 1, dtype=torch.bool)) < 1e-3


def _distill_pair(enc, module=jax_distill):
    student_kw = dict(enc, depth=1)
    return JaxViT(**enc), module.DistillableViT(**student_kw), student_kw


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("one_hot", [False, True], ids=["int-labels", "one-hot"])
@pytest.mark.parametrize("enc", [ENC, ENC_INNER], ids=["inner=dim", "inner!=dim"])
def test_distill_wrapper_loss_and_gradients_match_jax(hard, one_hot, enc):
    img = _image(6)
    labels = np.array([1, 7], np.int32)
    lab = np.eye(10, dtype=np.float32)[labels] if one_hot else labels
    teacher, student, student_kw = _distill_pair(enc)
    jw = jax_distill.DistillWrapper(teacher=teacher, student=student, temperature=3.0,
                                    alpha=0.5, hard=hard)
    batch = (jnp.asarray(img), jnp.asarray(lab))
    variables = jw.init(jax.random.PRNGKey(0), batch)
    want_loss, want_grads = _jax_loss_and_grads(jw, variables, batch)

    port = _load(distill.DistillWrapper(ViT(**enc, device="cpu"),
                                        distill.DistillableViT(**student_kw, device="cpu"),
                                        temperature=3.0, alpha=0.5, hard=hard, device="cpu"),
                 variables)
    lab_t = torch.from_numpy(lab) if one_hot else torch.from_numpy(labels).long()
    _check_loss_and_grads(port, port((torch.from_numpy(img), lab_t)), want_loss, want_grads)
    # the teacher runs under no_grad: no gradient at all; the student's all flow
    assert all(p.grad is None for p in port.teacher.parameters())
    assert all(p.grad is not None and float(p.grad.abs().max()) > 0
               for p in port.student.parameters())


def test_distill_wrapper_refuses_a_student_without_a_distillation_token():
    with pytest.raises(TypeError, match="vision transformer"):
        distill.DistillWrapper(ViT(**ENC, device="cpu"), ViT(**ENC, device="cpu"),
                               device="cpu")


def test_converted_objective_trees_lack_exactly_the_encoders_head():
    """Each objective's tree converted: the port's keys it lacks are exactly
    the encoder's ``head`` and ``head_norm`` (MAE, SimMIM, MPP) or none
    (``DistillWrapper``), and it has no key the port lacks."""
    img = jnp.asarray(_image(uniform=True))
    cases = [
        (jax_mae.MAE(encoder=JaxViT(**ENC), decoder_dim=32), (img,),
         mae.MAE(ViT(**ENC, device="cpu"), decoder_dim=32, device="cpu"),
         _head_keys("encoder")),
        (jax_simmim.SimMIM(encoder=JaxViT(**ENC)), (img,),
         simmim.SimMIM(ViT(**ENC, device="cpu"), device="cpu"), _head_keys("encoder")),
        (jax_mpp.MPP(transformer=JaxViT(**ENC), patch_size=16), (img,),
         mpp.MPP(ViT(**ENC, device="cpu"), patch_size=16, device="cpu"),
         _head_keys("transformer")),
        (jax_distill.DistillWrapper(teacher=JaxViT(**ENC),
                                    student=jax_distill.DistillableViT(**ENC)),
         ((img, jnp.array([1, 2])),),
         distill.DistillWrapper(ViT(**ENC, device="cpu"),
                                distill.DistillableViT(**ENC, device="cpu"), device="cpu"),
         set()),
    ]
    for jax_module, args, port, absent in cases:
        variables = jax_module.init(jax.random.PRNGKey(0), *args)
        state = state_dict_from_flax(jax.tree.map(np.asarray, variables))
        assert set(port.state_dict()) - set(state) == absent
        assert not set(state) - set(port.state_dict())
        for k, v in state.items():
            assert tuple(v.shape) == tuple(port.state_dict()[k].shape), k


def test_draws_come_from_the_generator_and_default_to_a_fixed_seed():
    """Each draw is a function of its generator; without one the objective
    draws from seed 0, so evaluation repeats."""
    g = [torch.Generator().manual_seed(7) for _ in range(2)]
    assert torch.equal(mae.random_masking_indices(g[0], 3, 16),
                       mae.random_masking_indices(g[1], 3, 16))
    assert sorted(mae.random_masking_indices(g[0], 1, 16)[0].tolist()) == list(range(16))
    idx = simmim.masked_topk_indices(torch.Generator().manual_seed(1), 2, 16, 8)
    assert idx.shape == (2, 8) and all(len(set(r.tolist())) == 8 for r in idx)
    subset = mpp.get_mask_subset_with_prob(2, 16, 0.15, torch.Generator().manual_seed(1))
    assert subset.dtype == torch.bool and subset.sum(-1).tolist() == [3, 3]
    model = mae.MAE(ViT(**ENC, device="cpu"), decoder_dim=32, device="cpu").eval()
    img = torch.from_numpy(_image())
    with torch.no_grad():
        assert torch.equal(model(img), model(img))
        seeded = model(img, generator=torch.Generator().manual_seed(0))
        assert torch.equal(seeded, model(img))


def test_loss_train_step_accumulates_as_one_batch():
    """``make_loss_train_step`` with ``accum_steps=2`` takes the step of
    ``accum_steps=1``: the same loss and the same updated parameters."""
    torch.manual_seed(0)
    teacher = ViT(**ENC, device="cpu", generator=torch.Generator().manual_seed(1))
    student = distill.DistillableViT(**dict(ENC, depth=1), device="cpu",
                                     generator=torch.Generator().manual_seed(2))
    models = [distill.DistillWrapper(teacher, student, temperature=2.0, device="cpu",
                                     generator=torch.Generator().manual_seed(3))]
    models.append(distill.DistillWrapper(ViT(**ENC, device="cpu"),
                                         distill.DistillableViT(**dict(ENC, depth=1),
                                                                device="cpu"),
                                         temperature=2.0, device="cpu"))
    models[1].load_state_dict(models[0].state_dict())
    img = torch.from_numpy(_image(8, b=4))
    labels = torch.tensor([1, 2, 3, 4])
    out = []
    for model, accum in zip(models, (1, 2)):
        step = make_loss_train_step(model, torch.optim.SGD(model.parameters(), lr=0.1),
                                    accum_steps=accum)
        out.append(step((img, labels))["loss"])
        assert step.state.step == 1
    assert abs(out[0].item() - out[1].item()) <= 1e-6
    params = [{k: p.detach() for k, p in m.named_parameters()} for m in models]
    for k, p in params[0].items():
        assert float((p - params[1][k]).abs().max()) <= 1e-6, k


def test_loss_train_step_draws_from_its_generator():
    """A fixed generator seed each step: the same mask every step, so the
    loss falls on one batch; the step's loss stays a device tensor."""
    model = mae.MAE(ViT(**ENC, device="cpu", generator=torch.Generator().manual_seed(0)),
                    decoder_dim=32, device="cpu", generator=torch.Generator().manual_seed(1))
    step = make_loss_train_step(model, torch.optim.AdamW(model.parameters(), lr=1e-3))
    img = torch.from_numpy(_image(9))
    losses = [step(img, generator=torch.Generator().manual_seed(5))["loss"] for _ in range(4)]
    assert all(isinstance(v, torch.Tensor) and v.dim() == 0 for v in losses)
    assert losses[-1] < losses[0]
