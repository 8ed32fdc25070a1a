"""The port's model trainers (``train/__init__.py``) against the
reference's on the CPU: the InfoNCE and Bradley-Terry losses, their
gradients against ``jax.grad`` for every named parameter, five-step loss
trajectories against ``optax.adamw``, the full-state resume, the
checkpoint files and the Orbax refusal, and the plain attention the
trainers take.

Both packages start from the same weights: the reference's parameter
pytree is carried into the port with ``models.convert``, and the
reference's gradient pytree goes through the same converter, so each
port parameter's gradient is held against its own counterpart.

Tolerances (measured on this CPU in f32, stated with each test):
losses 1e-5 relative; gradients 1e-4 of the largest gradient magnitude
of the model plus 1e-3 relative (a gradient that is 0 in exact
arithmetic, such as the key biases', is rounding noise in both); loss
trajectories 1e-4 absolute over 5 AdamW steps (torch folds Adam's bias
corrections into the step size, optax divides the moments: equal in
exact arithmetic, not in f32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llm_weighted_consensus_tpu import train as jtrain
from llm_weighted_consensus_tpu.models import bert as jbert
from llm_weighted_consensus_tpu.models import configs as jconfigs
from llm_weighted_consensus_tpu.models import deberta as jdeberta
from llm_weighted_consensus_tpu_torch import train
from llm_weighted_consensus_tpu_torch.models import bert, configs, convert
from llm_weighted_consensus_tpu_torch.models import deberta
from llm_weighted_consensus_tpu_torch.ops import attention, kernels

LOSS_RTOL = 1e-5
GRAD_SCALE_TOL = 1e-4
GRAD_RTOL = 1e-3
TRAJ_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bert_pair(seed=3):
    params = jbert.init_params(jax.random.PRNGKey(seed), jconfigs.TEST_TINY)
    state = convert.from_jax_params(_np_tree(params), configs.TEST_TINY)
    return params, state


def _deberta_pair(seed=5):
    params = jdeberta.init_params(jax.random.PRNGKey(seed),
                                  jconfigs.DEBERTA_TEST_TINY)
    state = convert.from_jax_deberta_params(_np_tree(params),
                                            configs.DEBERTA_TEST_TINY)
    return params, state


def _bert_model(state):
    return bert.trainable(bert.BertEncoder, state, configs.TEST_TINY,
                          device="cpu")


def _deberta_model(state):
    return bert.trainable(deberta.DebertaModel, state,
                          configs.DEBERTA_TEST_TINY, device="cpu")


def _pairs(vocab, b, s, seed, ragged=True):
    rng = np.random.default_rng(seed)
    a = rng.integers(3, vocab, (b, s)).astype(np.int32)
    c = rng.integers(3, vocab, (b, s)).astype(np.int32)
    mask_a = np.ones((b, s), np.int32)
    mask_c = np.ones((b, s), np.int32)
    if ragged:
        for r in range(b):
            mask_a[r, s - 1 - (r * 3) % (s // 2):] = 0
            mask_c[r, s - 1 - (r * 5) % (s // 2):] = 0
    return a, mask_a, c, mask_c


def _check_grads(model, jgrads, to_state):
    want = to_state(_np_tree(jgrads))
    scale = max(float(np.abs(g).max()) for g in want.values())
    checked = 0
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), want[name], rtol=GRAD_RTOL,
            atol=GRAD_SCALE_TOL * scale, err_msg=name,
        )
        checked += 1
    assert checked == len(want)


def test_contrastive_loss_and_grads_match_the_reference():
    params, state = _bert_pair()
    batch = _pairs(jconfigs.TEST_TINY.vocab_size, 4, 16, seed=7)
    jloss, jgrads = jax.value_and_grad(jtrain.contrastive_loss)(
        params, *map(jnp.asarray, batch), jconfigs.TEST_TINY)
    model = _bert_model(state)
    loss = train.contrastive_loss(model, *batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    _check_grads(model, jgrads, lambda t: convert.from_jax_params(
        t, configs.TEST_TINY))
    # the attention projections got a gradient through the plain path
    for layer in model.encoder.layer:
        for proj in ("query", "key", "value"):
            grad = getattr(layer.attention.self, proj).weight.grad
            assert float(grad.abs().max()) > 0, proj


def test_reward_loss_and_grads_match_the_reference():
    params, state = _deberta_pair()
    batch = _pairs(jconfigs.DEBERTA_TEST_TINY.vocab_size, 4, 24, seed=8)
    jloss, jgrads = jax.value_and_grad(jtrain.reward_pairwise_loss)(
        params, *map(jnp.asarray, batch), jconfigs.DEBERTA_TEST_TINY)
    model = _deberta_model(state)
    loss = train.reward_pairwise_loss(model, *batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    _check_grads(model, jgrads, lambda t: convert.from_jax_deberta_params(
        t, configs.DEBERTA_TEST_TINY))
    for layer in model.layers:
        for proj in ("attn_q", "attn_k", "attn_v"):
            assert float(getattr(layer, proj).weight.grad.abs().max()) > 0


def _jax_run(step, params, config, batches, lr):
    optimizer = jtrain.make_optimizer(lr=lr)
    opt_state = optimizer.init(params)
    losses = []
    for batch in batches:
        params, opt_state, loss = step(
            params, opt_state, *map(jnp.asarray, batch), config, optimizer)
        losses.append(float(loss))
    return losses


def _port_run(step, model, optimizer, batches):
    return [float(step(model, optimizer, *batch)) for batch in batches]


@pytest.mark.parametrize("which", ["contrastive", "reward"])
def test_five_adamw_steps_follow_the_references_losses(which):
    if which == "contrastive":
        params, state = _bert_pair()
        jconfig, vocab, s = jconfigs.TEST_TINY, configs.TEST_TINY.vocab_size, 16
        jstep, step, model = (jtrain.contrastive_train_step,
                              train.contrastive_train_step,
                              _bert_model(state))
    else:
        params, state = _deberta_pair()
        jconfig, vocab, s = (jconfigs.DEBERTA_TEST_TINY,
                             configs.DEBERTA_TEST_TINY.vocab_size, 24)
        jstep, step, model = (jtrain.reward_train_step,
                              train.reward_train_step, _deberta_model(state))
    # one batch five times: the loss must fall as the model fits it
    batches = [_pairs(vocab, 4, s, seed=20)] * 5
    want = _jax_run(jstep, params, jconfig, batches, lr=1e-3)
    got = _port_run(step, model, train.make_optimizer(model, lr=1e-3),
                    batches)
    np.testing.assert_allclose(got, want, atol=TRAJ_ATOL)
    assert got[-1] < got[0]


def test_make_optimizer_is_optax_adamw_on_one_parameter():
    """One parameter, a few steps of a fixed gradient: the torch AdamW
    update against optax's, decay included."""
    import optax

    theta0 = np.array([0.5, -1.25, 3.0], np.float32)
    grads = [np.array([0.1, -0.2, 0.3], np.float32) * (k + 1)
             for k in range(4)]
    opt = optax.adamw(1e-2, weight_decay=0.01)
    jt = jnp.asarray(theta0)
    state = opt.init(jt)
    for g in grads:
        updates, state = opt.update(jnp.asarray(g), state, jt)
        jt = optax.apply_updates(jt, updates)
    p = torch.nn.Parameter(torch.tensor(theta0))
    topt = train.make_optimizer([p], lr=1e-2)
    for g in grads:
        p.grad = torch.tensor(g)
        topt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jt),
                               rtol=1e-6, atol=1e-7)


def test_train_resume_equivalence(tmp_path):
    """An interrupted contrastive run resumed from the full train state
    (params, AdamW moments, step) continues with the same losses as the
    uninterrupted run; a fresh optimizer would not."""
    _, state = _bert_pair()
    vocab = configs.TEST_TINY.vocab_size
    batches = [_pairs(vocab, 4, 16, seed=40 + k, ragged=False)
               for k in range(5)]

    def run(model, optimizer, batch_list):
        return _port_run(train.contrastive_train_step, model, optimizer,
                         batch_list)

    model = _bert_model(state)
    straight = run(model, train.make_optimizer(model, lr=1e-3), batches)

    model = _bert_model(state)
    optimizer = train.make_optimizer(model, lr=1e-3)
    first3 = run(model, optimizer, batches[:3])
    path = str(tmp_path / "train_state.pt")
    train.save_train_state(path, model, optimizer, step=3)

    _, other = _bert_pair(seed=9)  # another seed: the file must win
    like = _bert_model(other)
    like_opt = train.make_optimizer(like, lr=1e-3)
    model_b, opt_b, step = train.load_train_state(path, like, like_opt)
    assert step == 3 and model_b is like
    last2 = run(model_b, opt_b, batches[3:])
    np.testing.assert_allclose(first3 + last2, straight, rtol=1e-6)
    # a params-only resume resets the moments and leaves the trajectory
    fresh = _bert_model(state)
    train.load_checkpoint(_checkpoint(tmp_path, model_b), like=fresh)
    assert not np.allclose(
        run(fresh, train.make_optimizer(fresh, lr=1e-3), batches[3:]),
        last2, rtol=1e-6)


def _checkpoint(tmp_path, model):
    path = str(tmp_path / "params.pt")
    train.save_checkpoint(path, model)
    return path


def test_checkpoints_round_trip_and_orbax_is_refused(tmp_path):
    _, state = _bert_pair()
    model = _bert_model(state)
    path = _checkpoint(tmp_path, model)
    params = train.load_checkpoint(path)
    assert set(params) == set(model.state_dict())
    for name, value in model.state_dict().items():
        assert torch.equal(params[name], value)
    # an Orbax checkpoint is a directory: refused by name, both ways
    orbax_dir = tmp_path / "orbax_ckpt"
    orbax_dir.mkdir()
    (orbax_dir / "_CHECKPOINT_METADATA").write_text("{}")
    for call in (lambda: train.load_checkpoint(str(orbax_dir)),
                 lambda: train.load_train_state(str(orbax_dir), model, None),
                 lambda: train.save_checkpoint(str(orbax_dir), model)):
        with pytest.raises(ValueError, match="Orbax"):
            call()
    # a train-state file is not a checkpoint, and the reverse
    state_path = str(tmp_path / "state.pt")
    train.save_train_state(state_path, model,
                           train.make_optimizer(model), step=1)
    with pytest.raises(ValueError, match="checkpoint"):
        train.load_checkpoint(state_path)
    with pytest.raises(ValueError, match="train_state"):
        train.load_train_state(path, model, train.make_optimizer(model))


def test_the_trainers_take_the_plain_path_and_refuse_a_serving_model(
        monkeypatch):
    _, state = _bert_pair()
    model = _bert_model(state)
    assert model.training
    assert all(p.requires_grad and p.dtype == torch.float32
               for p in model.parameters())
    serving = bert.build_from_state(bert.BertEncoder, state,
                                    configs.TEST_TINY, None, "cpu")
    batch = _pairs(configs.TEST_TINY.vocab_size, 2, 8, seed=1)
    opt = train.make_optimizer(model)
    with pytest.raises(ValueError, match="trainable"):
        train.contrastive_train_step(serving, opt, *batch)
    with pytest.raises(ValueError, match="quantized"):
        bert.trainable(bert.BertEncoder, {"x.weight_q": 0},
                       configs.TEST_TINY, device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        bert.encode(model, torch.ones((1, 4), dtype=torch.int64),
                    torch.ones((1, 4)), attention_impl="ring")
    # the step's forward never reaches the kernel wrapper: its attention
    # is the plain version
    def no_kernel(*args, **kwargs):
        raise AssertionError("the trainer reached the attention wrapper")

    monkeypatch.setattr(bert, "attention", no_kernel)
    # training launches no kernel (none exists on the CPU either, and
    # the counters stay where they were)
    before = (attention.attention.launches, kernels.cosine_vote.launches)
    train.contrastive_train_step(model, opt, *batch)
    assert (attention.attention.launches,
            kernels.cosine_vote.launches) == before


@pytest.mark.parametrize("packed", [False, True])
def test_the_plain_path_is_the_cpu_serving_path_and_trains_q_k_v(packed):
    """``attention_impl="plain"`` computes, bit for bit, what the serving
    path computes on the CPU (the same plain version), in the padded and
    the packed layout, and passes a gradient to every q/k/v
    projection."""
    _, state = _bert_pair()
    model = _bert_model(state)
    rng = np.random.default_rng(4)
    ids = torch.tensor(rng.integers(1, configs.TEST_TINY.vocab_size,
                                    (2, 12)))
    if packed:
        mask = None
        seg = torch.tensor([[1] * 5 + [2] * 4 + [0] * 3, [1] * 12],
                           dtype=torch.int32)
        pos = torch.tensor([list(range(5)) + list(range(4)) + [0] * 3,
                            list(range(12))], dtype=torch.int32)
        layout = {"segment_ids": seg, "positions": pos}
    else:
        mask = torch.ones((2, 12), dtype=torch.int32)
        mask[1, 9:] = 0
        layout = {}
    with torch.no_grad():
        want = bert.encode(model, ids, mask, **layout)
    got = bert.encode(model, ids, mask, attention_impl="plain", **layout)
    assert torch.equal(got.detach(), want)
    weight = torch.tensor(rng.standard_normal(tuple(got.shape)),
                          dtype=torch.float32)
    (got * weight).sum().backward()
    for layer in model.encoder.layer:
        for proj in ("query", "key", "value"):
            grad = getattr(layer.attention.self, proj).weight.grad
            assert float(grad.abs().max()) > 0, proj


def test_a_refused_grad_names_the_kernel():
    from llm_weighted_consensus_tpu_torch.ops import launches

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="attention.*no backward"):
        launches.refuse_grad("attention", None, x)
    launches.refuse_grad("attention", torch.ones(3))  # no grad: fine
    with torch.no_grad():
        launches.refuse_grad("attention", x)  # grad mode off: fine
