"""The port's session-recommender trainer
(``predictionio_torch/ops/sessionrec.py``) against the JAX package's, on
the CPU.

- Trainer, dropout 0, started from the JAX trainer's weights: the first
  step's gradients within atol 1e-5 (rtol 1e-4), the first three step
  losses within rtol 1e-5, the updates they make within atol 1e-6 (3 lr
  on entries whose first gradient is at rounding level: Adam steps such
  an entry by +-lr on rounding alone), and two whole epochs (the JAX
  epoch orders, the wrapped tail batch) with epoch losses within rtol
  1e-4.
- Checkpoint/resume: a run stopped after epoch 1 and resumed gives the
  uninterrupted run's losses and parameters bit for bit (dropout on).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from predictionio_tpu.ops import sessionrec as jax_sr
from predictionio_torch.ops import sessionrec as sr
from tests.test_torch_sessionrec import (JAX_CFG, _cyclic_events, _np_tree,
                                         _port_cfg, jitted_flax_init)

torch.set_num_threads(2)


def _jax_loss(encoder, seq, tgt):
    def loss_fn(params):
        h = encoder.apply(params, seq, deterministic=True)
        emb = params["params"]["item_embed"]["embedding"]
        logits = jnp.einsum("bld,vd->blv", h, emb)
        mask = (tgt > 0).astype(jnp.float32)
        ll = optax.softmax_cross_entropy_with_integer_labels(logits, tgt)
        return jnp.sum(ll * mask) / jnp.maximum(mask.sum(), 1e-8)
    return loss_fn


def _grads_as_flax(trainer):
    g = sr.SessionEncoder(trainer.n_items, trainer.cfg)
    g.load_state_dict({name: p.grad for name, p
                       in trainer.encoder.named_parameters()})
    return sr.params_to_flax(g)


def test_first_steps_match_the_jax_trainer():
    users, items, times = _cyclic_events(n_users=48, n_items=12, hist=12)
    cfg = dataclasses.replace(JAX_CFG, epochs=1)
    with jitted_flax_init():
        jt = jax_sr.SessionRecTrainer((users, items, times), 48, 12, cfg)
    p0 = _np_tree(jt._params)
    tt = sr.SessionRecTrainer((users, items, times), 48, 12, _port_cfg(cfg),
                              device="cpu", params=p0)
    assert np.array_equal(tt._train_rows, jt._train_rows)
    order = np.random.default_rng(cfg.seed).permutation(jt._train_rows)
    batches = tt.epoch_batches(order)

    # the first step's gradients
    seq, tgt = jt.inputs[batches[0]], jt.targets[batches[0]]
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(
        jt.encoder, jnp.asarray(seq), jnp.asarray(tgt))))(jt._params)
    loss = sr.tied_loss(tt.encoder, torch.from_numpy(seq),
                        torch.from_numpy(tgt), None)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
        _grads_as_flax(tt), _np_tree(jg))
    tt._opt.zero_grad(set_to_none=True)

    # three steps of each, the same batches
    key = jax.random.PRNGKey(0)
    for sel in batches[:3]:
        jt._params, jt._opt_state, jl = jt._step(
            jt._params, jt._opt_state, jnp.asarray(jt.inputs[sel]),
            jnp.asarray(jt.targets[sel]), key)
        sel_t = torch.from_numpy(sel)
        tl = tt.step(tt._inputs_dev[sel_t], tt._targets_dev[sel_t])
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    # the three steps' updates: Adam moves every entry by about lr a step,
    # so an update held at 1e-6 (lr / 1000) catches a missing or
    # wrong-signed step. Entries whose first gradient is at rounding level
    # (the key projection's bias: the softmax ignores a shift of its keys)
    # step +-lr on that rounding in either package, so they are held
    # only to 3 lr.
    def same_update(port, jax_p, start, grad):
        noise = np.abs(grad) <= 1e-6 * np.abs(grad).max()
        up, uj = port - start, jax_p - start
        np.testing.assert_allclose(up[~noise], uj[~noise], rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(up[noise], uj[noise], rtol=0, atol=3e-3)

    jax.tree_util.tree_map(same_update, sr.params_to_flax(tt.encoder),
                           _np_tree(jt._params), p0, _np_tree(jg))


def test_two_epochs_match_the_jax_trainer_on_its_orders():
    users, items, times = _cyclic_events(n_users=50, n_items=12, hist=12,
                                         seed=1)
    cfg = dataclasses.replace(JAX_CFG, epochs=2)
    with jitted_flax_init():
        jt = jax_sr.SessionRecTrainer((users, items, times), 50, 12, cfg)
    tt = sr.SessionRecTrainer((users, items, times), 50, 12, _port_cfg(cfg),
                              device="cpu", params=_np_tree(jt._params))
    want = jt.run()
    got = tt.run()
    assert tt.steps_per_epoch == 3       # 50 rows, the tail wrapped
    np.testing.assert_allclose(got, want, rtol=1e-4)
    js, ts = jt.state(want), tt.state(got)
    assert np.array_equal(ts.sequences, js.sequences)


def test_the_port_trainer_learns_the_cycle():
    users, items, times = _cyclic_events()
    cfg = sr.SessionRecConfig(dim=32, heads=2, layers=1, max_len=16,
                              dropout=0.0, epochs=30, batch_size=64,
                              learning_rate=3e-3)
    tr = sr.SessionRecTrainer((users, items, times), 64, 12, cfg,
                              device="cpu")
    losses = tr.run()
    assert losses[-1] < losses[0] * 0.5, losses
    state = tr.state(losses)
    _, idx = sr.SessionScorer(state, device="cpu").top_k(
        state.sequences[:8], 1)
    rows = state.sequences[:8]
    last = rows[np.arange(8), (rows > 0).sum(axis=1) - 1] - 1
    assert np.mean(idx[:, 0] == (last + 1) % 12) >= 0.75


def test_checkpoint_resume_walks_the_uninterrupted_orders(tmp_path):
    users, items, times = _cyclic_events(n_users=40, n_items=9, hist=10,
                                         seed=2)
    cfg = sr.SessionRecConfig(dim=16, heads=2, layers=1, max_len=8,
                              dropout=0.1, epochs=3, batch_size=16)

    def trainer(ckpt=None):
        c = dataclasses.replace(cfg, checkpoint_dir=ckpt)
        return sr.SessionRecTrainer((users, items, times), 40, 9, c,
                                    device="cpu")

    whole = trainer()
    want = whole.run()
    first = trainer(str(tmp_path))
    first.run(epochs=1)
    assert (tmp_path / "ckpt_1.pkl").exists()
    resumed = trainer(str(tmp_path))
    assert resumed._epochs_done == 1 and resumed.restore_seconds > 0
    got = resumed.run()
    assert got == want
    a, b = sr.params_to_flax(resumed.encoder), sr.params_to_flax(whole.encoder)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, a, b))
