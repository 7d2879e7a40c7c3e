"""The session recommender's trainer across gloo processes, on the CPU,
against the JAX package.

``SessionRecTrainer(..., mesh=)`` splits the batch over ``data`` and,
with ``seq_axis``, the sequence over that axis, each rank encoding its
block with ring attention; the loss is the whole batch's masked mean
(numerators and denominators summed over the ranks) and the gradients
are summed over both axes. Each world is spawned once for the module
(``tests/torch_world.py``): two ranks, on ``{"seq": 2}`` and on
``{"data": 2}``, and four on ``{"data": 2, "seq": 2}``.

Every rank starts from the JAX trainer's weights with dropout 0 and
walks the same orders; its results are held against JAX's
``SessionRecTrainer`` on a mesh of the same axis sizes over
``jax.devices()[:n]`` at ``test_torch_sessionrec_train.py``'s
tolerances: the first step's gradients (rtol 1e-4, atol 1e-5) and loss,
the first three step losses (rtol 1e-5) and two whole epochs' losses
(rtol 1e-4, also against the unsharded JAX trainer); every rank's
gradients, losses and weights are equal. With dropout on, the world of
four is held against the one-process trainer instead: each rank keeps
its block of the whole batch's masks, so both apply the same masks.
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import sessionrec as jax_sr
from predictionio_tpu.parallel.mesh import create_mesh as jax_mesh
from predictionio_torch.ops import sessionrec as sr

from tests.test_torch_sessionrec import (JAX_CFG, _cyclic_events, _np_tree,
                                         jitted_flax_init)
from tests.test_torch_sessionrec_train import _jax_loss
from tests.torch_world import run_world

_WORKER = """
import dataclasses, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.ops import sessionrec as sr
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import create_mesh

out = sys.argv[1]
assert mh.initialize_from_env(device="cpu")
with open(out + "/cases.pkl", "rb") as f:
    cases = pickle.load(f)
res = {}
for name, case in cases.items():
    cfg = sr.SessionRecConfig(**case["cfg"])
    mesh = create_mesh(case["axes"])

    def trainer():
        return sr.SessionRecTrainer(case["events"], case["n_users"],
                                    case["n_items"], cfg, device="cpu",
                                    params=case["params"], mesh=mesh)

    t = trainer()
    order = np.random.default_rng(cfg.seed).permutation(t._train_rows)
    batches = torch.from_numpy(t.epoch_batches(order))
    losses = []
    for j, sel in enumerate(batches[:3]):
        losses.append(float(t.step(t._inputs_dev[sel], t._targets_dev[sel])))
        if j == 0:
            g = sr.SessionEncoder(t.n_items, t.cfg)
            g.load_state_dict({n: p.grad for n, p
                               in t.encoder.named_parameters()})
            grads = sr.params_to_flax(g)
    t = trainer()
    epochs = t.run()
    res[name] = {"grads": grads, "step_losses": losses,
                 "epoch_losses": epochs, "batch": t.batch,
                 "params": sr.params_to_flax(t.encoder)}
with open(out + f"/rank{mh.process_index()}.pkl", "wb") as f:
    pickle.dump(res, f)
"""

N_USERS, N_ITEMS = 48, 12
DROPOUT = 0.1


def _events():
    return _cyclic_events(n_users=N_USERS, n_items=N_ITEMS, hist=12, seed=2)


def _cfg(axes):
    return dataclasses.replace(JAX_CFG, epochs=2,
                               seq_axis="seq" if "seq" in axes else None)


def _params():
    with jitted_flax_init():
        jt = jax_sr.SessionRecTrainer(_events(), N_USERS, N_ITEMS,
                                      dataclasses.replace(JAX_CFG, epochs=2))
    return _np_tree(jt._params)


def _spawn(tmp_path_factory, name, axes_list, dropout_axes=()):
    out = tmp_path_factory.mktemp(name)
    p0 = _params()

    def case(axes, cfg):
        return {"axes": axes, "cfg": dataclasses.asdict(cfg),
                "events": _events(), "n_users": N_USERS,
                "n_items": N_ITEMS, "params": p0}
    cases = {str(axes): case(axes, _cfg(axes)) for axes in axes_list}
    for axes in dropout_axes:
        cases[f"dropout {axes}"] = case(
            axes, dataclasses.replace(_cfg(axes), dropout=DROPOUT))
    with open(out / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    n = int(np.prod(list(axes_list[0].values())))
    run_world(_WORKER, n, args=[out])
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return p0, results


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return _spawn(tmp_path_factory, "world2", [{"seq": 2}, {"data": 2}])


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _spawn(tmp_path_factory, "world4", [{"data": 2, "seq": 2}],
                  dropout_axes=[{"data": 2, "seq": 2}])


def _same_on_every_rank(results, key):
    first = results[0][key]
    for other in results[1:]:
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               other[key]["grads"], first["grads"])
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               other[key]["params"], first["params"])
        assert other[key]["step_losses"] == first["step_losses"]
        assert other[key]["epoch_losses"] == first["epoch_losses"]
    return first


def _jax_trainer(p0, cfg, axes=None):
    mesh = None
    if axes is not None:
        n = int(np.prod(list(axes.values())))
        mesh = jax_mesh(axes, jax.devices()[:n])
    with jitted_flax_init():
        jt = jax_sr.SessionRecTrainer(_events(), N_USERS, N_ITEMS, cfg,
                                      mesh=mesh)
    jt._params = jax.tree_util.tree_map(jnp.asarray, p0)
    jt._opt_state = jt._tx.init(jt._params)
    return jt


def _hold(p0, got, axes):
    cfg = _cfg(axes)
    jt = _jax_trainer(p0, cfg, axes)
    assert got["batch"] == jt.batch
    order = np.random.default_rng(cfg.seed).permutation(jt._train_rows)
    # the first three batches, the last wrapped to full size as both
    # trainers wrap it
    wrapped = np.concatenate([order, order])
    sels = [wrapped[s:s + jt.batch] for s in range(0, 3 * jt.batch, jt.batch)]
    assert len(order) < 3 * jt.batch
    seq, tgt = jt.inputs[sels[0]], jt.targets[sels[0]]
    jl, jg = jax.jit(jax.value_and_grad(_jax_loss(
        jt.encoder, jnp.asarray(seq), jnp.asarray(tgt))))(jt._params)
    np.testing.assert_allclose(got["step_losses"][0], float(jl), rtol=1e-5)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5),
        got["grads"], _np_tree(jg))
    key = jax.random.PRNGKey(0)
    for sel, want in zip(sels, got["step_losses"]):
        jt._params, jt._opt_state, jl = jt._step(
            jt._params, jt._opt_state, jnp.asarray(jt.inputs[sel]),
            jnp.asarray(jt.targets[sel]), key)
        np.testing.assert_allclose(want, float(jl), rtol=1e-5)
    for ref_axes in (axes, None):
        want = _jax_trainer(p0, cfg, ref_axes).run()
        np.testing.assert_allclose(got["epoch_losses"], want, rtol=1e-4)


@pytest.mark.parametrize("axes", [{"seq": 2}, {"data": 2}],
                         ids=["seq_axis", "batch_split"])
def test_two_ranks_match_the_jax_trainer_on_a_mesh(world2, axes):
    p0, results = world2
    _hold(p0, _same_on_every_rank(results, str(axes)), axes)


def test_data_and_seq_axes_on_a_world_of_four(world4):
    p0, results = world4
    axes = {"data": 2, "seq": 2}
    _hold(p0, _same_on_every_rank(results, str(axes)), axes)


def test_dropout_masks_on_a_mesh_match_one_process(world4):
    p0, results = world4
    axes = {"data": 2, "seq": 2}
    got = _same_on_every_rank(results, f"dropout {axes}")
    cfg = dataclasses.replace(_cfg(axes), dropout=DROPOUT, seq_axis=None)

    def trainer():
        return sr.SessionRecTrainer(_events(), N_USERS, N_ITEMS, cfg,
                                    device="cpu", params=p0)
    t = trainer()
    assert got["batch"] == t.batch
    order = np.random.default_rng(cfg.seed).permutation(t._train_rows)
    batches = torch.from_numpy(t.epoch_batches(order))
    for j, (sel, want) in enumerate(zip(batches[:3], got["step_losses"])):
        np.testing.assert_allclose(
            want, float(t.step(t._inputs_dev[sel], t._targets_dev[sel])),
            rtol=1e-5)
        if j == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in t.encoder.named_parameters()}
            g = sr.SessionEncoder(t.n_items, t.cfg)
            g.load_state_dict({n: torch.from_numpy(a)
                               for n, a in grads.items()})
            jax.tree_util.tree_map(
                lambda a, b: np.testing.assert_allclose(a, b, rtol=1e-4,
                                                        atol=1e-5),
                got["grads"], sr.params_to_flax(g))
    np.testing.assert_allclose(got["epoch_losses"], trainer().run(),
                               rtol=1e-4)
