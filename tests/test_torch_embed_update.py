"""The port's rowwise-Adagrad table update against the JAX package's.

Table, accumulator, indices (with duplicates, within and across the
Pallas kernel's 8-row tiles) and gradients are made with numpy and go
through the JAX package's ``pallas_rowwise_adagrad`` (interpret mode)
and ``_rowwise_adagrad`` (XLA), and through the port's
``embed_update.rowwise_adagrad`` on CPU tensors (the kernel's plain
version, which the trainer calls on every device). The bare scatter,
``embed_update``, is held against the Pallas ``_scatter_apply`` it
replaces. Tolerances are the JAX kernel test's: table 1e-5 / 1e-6
(duplicates sum in another order), accumulator 1e-6 / 1e-7. The kernel
runs on the card only (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas.embed_update import (_scatter_apply,
                                                      pallas_rowwise_adagrad)
from predictionio_tpu.ops.twotower import _rowwise_adagrad
from predictionio_torch.ops.kernels import embed_update as eu

torch.set_num_threads(2)

CASES = [
    (64, 24, 37, 64),    # ragged tile + non-128 row width
    (128, 16, 32, 128),  # aligned
    (50, 8, 24, 6),      # duplicate-heavy: every tile collides
]


def _inputs(N, E, B, vocab):
    rng = np.random.default_rng(3)
    return (rng.normal(size=(N, E)).astype(np.float32),
            np.abs(rng.normal(size=N)).astype(np.float32),
            rng.integers(0, vocab, B).astype(np.int32),
            rng.normal(size=(B, E)).astype(np.float32))


@pytest.mark.parametrize("N,E,B,vocab", CASES)
@pytest.mark.parametrize("port_fn", [eu.rowwise_adagrad],
                         ids=["kernel_plain_version"])
def test_rowwise_adagrad_matches_jax(N, E, B, vocab, port_fn):
    table, acc, idx, grad = _inputs(N, E, B, vocab)
    refs = [
        _rowwise_adagrad(jnp.asarray(table), jnp.asarray(acc),
                         jnp.asarray(idx), jnp.asarray(grad), 0.03),
        pallas_rowwise_adagrad(jnp.asarray(table), jnp.asarray(acc),
                               jnp.asarray(idx), jnp.asarray(grad), 0.03,
                               interpret=True),
    ]
    t = torch.tensor(table)
    a = torch.tensor(acc)
    t_out, a_out = port_fn(t, a, torch.tensor(idx, dtype=torch.int64),
                           torch.tensor(grad), 0.03)
    assert t_out is t and a_out is a      # updated in place
    for t_ref, a_ref in refs:
        np.testing.assert_allclose(t.numpy(), np.asarray(t_ref),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a.numpy(), np.asarray(a_ref),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("N,E,B,vocab", CASES)
def test_embed_update_matches_pallas_scatter(N, E, B, vocab):
    """The bare scatter ``table[idx[b]] += -scale[b] * grad[b]`` against
    the Pallas kernel it replaces, at its 8-row tile."""
    table, _, idx, grad = _inputs(N, E, B, vocab)
    scale = np.random.default_rng(5).random(B).astype(np.float32)
    ref = _scatter_apply(jnp.asarray(table), jnp.asarray(idx),
                         jnp.asarray(grad), jnp.asarray(scale), tile=8,
                         interpret=True)
    t = torch.tensor(table)
    out = eu.embed_update(t, torch.tensor(idx, dtype=torch.int64),
                          torch.tensor(grad), torch.tensor(scale))
    assert out is t                       # updated in place
    np.testing.assert_allclose(t.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_embed_update_checks_its_inputs():
    table = torch.zeros((8, 4))
    idx = torch.tensor([1, 1, 7])
    with pytest.raises(TypeError, match="int64"):
        eu.embed_update(table, idx.int(), torch.ones((3, 4)), torch.ones(3))
    with pytest.raises(ValueError, match="disagree"):
        eu.embed_update(table, idx, torch.ones((3, 5)), torch.ones(3))
    eu.embed_update(table, idx, torch.ones((3, 4)), torch.full((3,), 0.5))
    assert table[1].tolist() == [-1.0] * 4 and table[7].tolist() == [-0.5] * 4
