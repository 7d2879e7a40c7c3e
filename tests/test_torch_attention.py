"""The port's attention (``predictionio_torch/ops/attention.py``) against
the JAX package's, on the CPU.

Seeded numpy ``[B, L, H, D]`` inputs go through both packages:
``mha_reference`` causal and not, the decode suffix (``Lq < Lk``), and
``blockwise_attention`` against both the JAX blockwise function and the
materialized oracle, at atol 1e-5. A fully masked block stays finite,
a ragged block size raises ``ValueError`` as in JAX, and ring attention
on one rank equals JAX's on a one-device mesh (worlds of several
processes: ``tests/test_torch_ring_attention.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import attention as jax_attn
from predictionio_torch.ops import attention

torch.set_num_threads(2)

ATOL = 1e-5


def _qkv(B=2, L=64, H=2, D=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(B, L, H, D)).astype(np.float32)
                 for _ in range(3))


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    arrays = _qkv(seed=1)
    got = attention.mha_reference(*_t(arrays), causal=causal).numpy()
    want = np.asarray(jax_attn.mha_reference(*_j(arrays), causal=causal))
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block", [8, 16, 64])
def test_blockwise_matches_jax_and_the_materialized_form(causal, block):
    arrays = _qkv(seed=2)
    got = attention.blockwise_attention(*_t(arrays), block_size=block,
                                        causal=causal).numpy()
    want = np.asarray(jax_attn.blockwise_attention(
        *_j(arrays), block_size=block, causal=causal))
    ref = attention.mha_reference(*_t(arrays), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_decode_suffix_query_matches_jax():
    q, k, v = _qkv(L=32, seed=3)
    got = attention.mha_reference(*_t((q[:, -4:], k, v)), causal=True)
    want = jax_attn.mha_reference(*_j((q[:, -4:], k, v)), causal=True)
    full = attention.mha_reference(*_t((q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), full[:, -4:].numpy(), atol=ATOL)


def test_a_fully_masked_block_stays_finite():
    # with causal masking, query 0 sees no key of the second block
    arrays = _qkv(L=16, seed=4)
    out = attention.blockwise_attention(*_t(arrays), block_size=8)
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(
        out.numpy(), attention.mha_reference(*_t(arrays)).numpy(), atol=ATOL)


def test_blockwise_rejects_ragged_blocks_like_jax():
    arrays = _qkv(L=60)
    with pytest.raises(ValueError, match="not divisible"):
        attention.blockwise_attention(*_t(arrays), block_size=16)
    with pytest.raises(ValueError, match="not divisible"):
        jax_attn.blockwise_attention(*_j(arrays), block_size=16)


def test_blockwise_gradients_match_the_materialized_form():
    q, k, v = (t.requires_grad_(True) for t in _t(_qkv(L=32, seed=5)))
    attention.blockwise_attention(q, k, v, block_size=8).square().sum() \
        .backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    attention.mha_reference(q, k, v).square().sum().backward()
    for g, t in zip(grads, (q, k, v)):
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), atol=1e-4)


@pytest.mark.parametrize("fn", ["ring_attention", "ring_attention_sharded"])
def test_ring_attention_raises_naming_its_roadmap_item(fn):
    """Ring attention on one rank (no world; a mesh whose ``seq`` axis
    has one rank) against JAX ``ring_attention_sharded`` on a one-device
    ``seq`` mesh and the materialized form, causal and not; worlds of
    several processes are in ``tests/test_torch_ring_attention.py``."""
    import jax

    from predictionio_tpu.parallel.mesh import create_mesh as jax_mesh
    from predictionio_torch.parallel.mesh import create_mesh

    arrays = _qkv(L=16, seed=6)
    mesh = jax_mesh({"seq": 1}, jax.devices()[:1])
    for causal in (True, False):
        if fn == "ring_attention":
            got = attention.ring_attention(*_t(arrays), axis="seq",
                                           causal=causal)
        else:
            got = attention.ring_attention_sharded(
                *_t(arrays), create_mesh({"seq": 1}), axis="seq",
                causal=causal)
        want = jax_attn.ring_attention_sharded(*_j(arrays), mesh,
                                               axis="seq", causal=causal)
        ref = attention.mha_reference(*_t(arrays), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL)
