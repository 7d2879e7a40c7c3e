"""Ring attention of the port on worlds of gloo processes, on the CPU,
against the JAX package.

``predictionio_torch.ops.attention.ring_attention`` splits the sequence
over a mesh axis of the world (each rank ``[B, L/S, H, D]``), folds the
key/value block it holds into the online softmax and passes the block
round the ring; its backward walks the ring again. Two worlds, each
spawned once for the module (``tests/torch_world.py``): two ranks on
``{"seq": 2}``, and four on ``{"data": 2, "seq": 2}`` for
``batch_axis``. Every rank's whole output (``ring_attention_sharded``)
is held against JAX ``ring_attention_sharded`` on a mesh of the same
axis sizes over ``jax.devices()[:n]`` of the 8-device CPU mesh and
against JAX ``mha_reference``, causal and not, at atol 1e-5 (JAX
``tests/test_attention.py``'s). The gradients of the ranks' shards,
concatenated, are held against the blockwise form's on one process
(atol 1e-4, ``tests/test_torch_attention.py``'s gradient tolerance),
and ``ring_attention_sharded``'s per-rank gradients sum to it.
"""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import attention as jax_attn
from predictionio_tpu.parallel.mesh import create_mesh as jax_mesh
from predictionio_torch.ops import attention

from tests.torch_world import run_world

torch.set_num_threads(2)

B, L, H, D = 4, 32, 2, 8

_WORKER = """
import pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from predictionio_torch.ops.attention import (ring_attention,
                                              ring_attention_sharded)
from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import axis_rank, create_mesh

out = sys.argv[1]
assert mh.initialize_from_env(device="cpu")
with open(out + "/case.pkl", "rb") as f:
    case = pickle.load(f)
mesh = create_mesh(case["axes"])
batch_axis = "data" if "data" in case["axes"] else None
q, k, v, g = (torch.from_numpy(a) for a in case["qkvg"])
res = {}
for causal in (True, False):
    res[("out", causal)] = ring_attention_sharded(
        q, k, v, mesh, axis="seq", causal=causal,
        batch_axis=batch_axis).numpy()
    # the shards' own gradients through the ring
    S = case["axes"]["seq"]
    si = axis_rank(mesh, "seq")
    Bn = case["axes"].get("data", 1)
    bi = axis_rank(mesh, "data") if Bn > 1 else 0
    bs, ls = q.shape[0] // Bn, q.shape[1] // S
    rows = slice(bi * bs, (bi + 1) * bs)
    cols = slice(si * ls, (si + 1) * ls)
    qs, ks, vs = (t[rows, cols].clone().requires_grad_(True)
                  for t in (q, k, v))
    o = ring_attention(qs, ks, vs, axis="seq", causal=causal, mesh=mesh)
    (o * g[rows, cols]).sum().backward()
    res[("shard_grads", causal)] = [t.grad.numpy() for t in (qs, ks, vs)]
    res[("shard_out", causal)] = o.detach().numpy()
    # the whole-tensor wrapper: each rank's gradient is its share
    qw, kw, vw = (t.clone().requires_grad_(True) for t in (q, k, v))
    ow = ring_attention_sharded(qw, kw, vw, mesh, axis="seq", causal=causal,
                                batch_axis=batch_axis)
    (ow * g).sum().backward()
    res[("whole_grads", causal)] = [t.grad.numpy() for t in (qw, kw, vw)]
res["where"] = (bi, si)
with open(out + f"/rank{mh.process_index()}.pkl", "wb") as f:
    pickle.dump(res, f)
"""


def _qkvg(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, L, H, D)).astype(np.float32)
            for _ in range(4)]


def _spawn(tmp_path_factory, name, axes):
    out = tmp_path_factory.mktemp(name)
    case = {"axes": axes, "qkvg": _qkvg()}
    with open(out / "case.pkl", "wb") as f:
        pickle.dump(case, f)
    n = int(np.prod(list(axes.values())))
    run_world(_WORKER, n, args=[out])
    results = []
    for r in range(n):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return case, results


@pytest.fixture(scope="module")
def seq2(tmp_path_factory):
    return _spawn(tmp_path_factory, "seq2", {"seq": 2})


@pytest.fixture(scope="module")
def data2_seq2(tmp_path_factory):
    return _spawn(tmp_path_factory, "data2_seq2", {"data": 2, "seq": 2})


def _jax(case, causal):
    q, k, v, _ = (jnp.asarray(a) for a in case["qkvg"])
    axes = case["axes"]
    n = int(np.prod(list(axes.values())))
    import jax

    mesh = jax_mesh(axes, jax.devices()[:n])
    ring = jax_attn.ring_attention_sharded(
        q, k, v, mesh, axis="seq", causal=causal,
        batch_axis="data" if "data" in axes else None)
    return np.asarray(ring), np.asarray(jax_attn.mha_reference(
        q, k, v, causal=causal))


def _blockwise_grads(case, causal):
    q, k, v, g = (torch.from_numpy(a).requires_grad_(i < 3)
                  for i, a in enumerate(case["qkvg"]))
    out = attention.blockwise_attention(q, k, v, block_size=8, causal=causal)
    (out * g).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (q, k, v)]


def _world(request, name):
    return request.getfixturevalue(name)


@pytest.mark.parametrize("world", ["seq2", "data2_seq2"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax_ring_and_reference(request, world, causal):
    case, results = _world(request, world)
    ring, ref = _jax(case, causal)
    np.testing.assert_allclose(ring, ref, atol=1e-5)
    for res in results:
        np.testing.assert_allclose(res[("out", causal)], ring, atol=1e-5)
        np.testing.assert_allclose(res[("out", causal)], ref, atol=1e-5)


@pytest.mark.parametrize("world", ["seq2", "data2_seq2"])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_gradients_match_the_blockwise_form(request, world, causal):
    case, results = _world(request, world)
    want_out, want = _blockwise_grads(case, causal)
    S = case["axes"]["seq"]
    Bn = case["axes"].get("data", 1)
    bs, ls = B // Bn, L // S
    got = [np.zeros_like(w) for w in want]
    out = np.zeros_like(want_out)
    summed = [np.zeros_like(w) for w in want]
    for res in results:
        bi, si = res["where"]
        rows, cols = slice(bi * bs, (bi + 1) * bs), slice(si * ls,
                                                          (si + 1) * ls)
        out[rows, cols] = res[("shard_out", causal)]
        for j, shard in enumerate(res[("shard_grads", causal)]):
            got[j][rows, cols] = shard
        for j, whole in enumerate(res[("whole_grads", causal)]):
            summed[j] += whole
    np.testing.assert_allclose(out, want_out, atol=1e-5)
    for g, s, w in zip(got, summed, want):
        np.testing.assert_allclose(g, w, atol=1e-4)
        np.testing.assert_allclose(s, w, atol=1e-4)


def test_one_rank_ring_is_attention_over_the_shard():
    q, k, v, _ = (torch.from_numpy(a) for a in _qkvg(3))
    for causal in (True, False):
        np.testing.assert_allclose(
            attention.ring_attention(q, k, v, axis="seq",
                                     causal=causal).numpy(),
            attention.mha_reference(q, k, v, causal=causal).numpy(),
            atol=1e-5)
