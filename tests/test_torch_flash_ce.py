"""The port's flash-CE loss against the JAX package's.

The same seeded inputs (made with numpy) go through the JAX package's
Pallas ``make_flash_ce`` (interpret mode on the CPU, as
tests/test_pallas_kernels.py runs it), its XLA ``_dense_softmax_ce`` and
``_make_blockwise_ce_vjp``, and through the port's ``flash_ce`` on CPU
tensors (the kernels' plain version) and its torch blockwise and dense
forms. Losses and both gradients must agree with the JAX package's own
kernel tolerances: f32 loss 1e-5, grads 1e-4 / 1e-6; bf16 loss 5e-3,
grads 1e-1 / 2e-3 (bf16 logits round at other points when summed in
another order). At B = 256, D = 16 the gradients average about
1e-2 in size, so the absolute tolerances bite. The kernels themselves run on the card only
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.pallas.flash_ce import make_flash_ce
from predictionio_tpu.ops.twotower import (_dense_softmax_ce,
                                           _make_blockwise_ce_vjp)
from predictionio_torch.ops import twotower as tt
from predictionio_torch.ops.kernels.flash_ce import (flash_ce,
                                                     grad_reference,
                                                     tile_logits, tile_masks,
                                                     tile_stats)

torch.set_num_threads(2)

TEMP = 0.07
CDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOLS = {"float32": (1e-5, 1e-4, 1e-6), "bfloat16": (5e-3, 1e-1, 2e-3)}


def _batch(B, D, seed=9, n_users=60, n_items=40, n_pad=17, uniform_w=True):
    """Unit-norm towers + index vectors with many in-batch duplicates
    and a zero-weight padded tail; ``uniform_w=False`` draws real-valued
    weights (the ``weight_by_rating`` path)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, D)).astype(np.float32)
    v = rng.normal(size=(B, D)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    w = (np.ones(B, np.float32) if uniform_w
         else (0.5 + 4.0 * rng.random(B)).astype(np.float32))
    if n_pad:
        w[-n_pad:] = 0.0
    return (u, v, rng.integers(0, n_users, B).astype(np.int32),
            rng.integers(0, n_items, B).astype(np.int32), w)


def _jax(fn, u, v):
    loss, (du, dv) = jax.value_and_grad(fn, argnums=(0, 1))(
        jnp.asarray(u), jnp.asarray(v))
    return float(loss), np.asarray(du), np.asarray(dv)


def _torch(fn, u, v, u_idx, i_idx, w, *args):
    tu = torch.tensor(u, requires_grad=True)
    tv = torch.tensor(v, requires_grad=True)
    loss = fn(tu, tv, torch.tensor(u_idx, dtype=torch.int64),
              torch.tensor(i_idx, dtype=torch.int64), torch.tensor(w), *args)
    loss.backward()
    return float(loss.detach()), tu.grad.numpy(), tv.grad.numpy()


def _close(got, ref, l_rtol, g_rtol, g_atol):
    np.testing.assert_allclose(got[0], ref[0], rtol=l_rtol)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g, r, rtol=g_rtol, atol=g_atol)


@pytest.mark.parametrize("cdt_name,uniform_w", [
    ("float32", True), ("float32", False), ("bfloat16", True)])
def test_flash_ce_matches_jax_kernel_and_xla_forms(cdt_name, uniform_w):
    """The three cases of the JAX package's own kernel test."""
    B, D, block = 256, 16, 64
    u, v, u_idx, i_idx, w = _batch(B, D, uniform_w=uniform_w)
    cdt = jnp.dtype(cdt_name)
    ju, ji, jw = jnp.asarray(u_idx), jnp.asarray(i_idx), jnp.asarray(w)
    refs = [
        _jax(make_flash_ce(ju, ji, jw, TEMP, cdt, B, interpret=True,
                           block=block), u, v),
        _jax(lambda a, b: _dense_softmax_ce(a, b, ju, ji, jw, TEMP, cdt),
             u, v),
        _jax(_make_blockwise_ce_vjp(ju, ji, jw, TEMP, block, cdt, B), u, v),
    ]
    got = _torch(flash_ce, u, v, u_idx, i_idx, w, TEMP, CDT[cdt_name])
    for ref in refs:
        _close(got, ref, *TOLS[cdt_name])


@pytest.mark.parametrize("B", [200, 130])
def test_flash_ce_ragged_batch(B):
    """A batch that is not a multiple of the kernel tile."""
    u, v, u_idx, i_idx, w = _batch(B, 16, seed=4, n_pad=9)
    ju, ji, jw = jnp.asarray(u_idx), jnp.asarray(i_idx), jnp.asarray(w)
    got = _torch(flash_ce, u, v, u_idx, i_idx, w, TEMP, torch.float32)
    for ref in (
            _jax(make_flash_ce(ju, ji, jw, TEMP, jnp.float32, B,
                               interpret=True, block=64), u, v),
            _jax(lambda a, b: _dense_softmax_ce(a, b, ju, ji, jw, TEMP,
                                                jnp.float32), u, v)):
        _close(got, ref, *TOLS["float32"])
    assert got[1].shape == (B, 16) and got[2].shape == (B, 16)


@pytest.mark.parametrize("cdt_name,uniform_w,B", [
    ("float32", True, 256), ("float32", False, 256), ("bfloat16", True, 256),
    ("bfloat16", False, 256), ("float32", False, 130), ("bfloat16", True, 130),
])
def test_backward_kernel_plain_version_and_role_swap(cdt_name, uniform_w, B):
    """The backward kernel's plain version gives du, and with the roles
    swapped (v for u, i_idx for u_idx, lse_iu for lse_ui) dv, as the
    card launches it: both match the Pallas kernel's gradients
    (interpret mode) and the plain loss's autograd gradients. Batches
    with duplicate users and items and a zero-weight tail; 130 is
    ragged (3 tiles of 64)."""
    D = 16
    u, v, u_idx, i_idx, w = _batch(B, D, seed=B + len(cdt_name),
                                   uniform_w=uniform_w)
    cdt = CDT[cdt_name]
    tu, tv, tw = torch.tensor(u), torch.tensor(v), torch.tensor(w)
    tui, tii = (torch.tensor(a, dtype=torch.int64) for a in (u_idx, i_idx))
    rows = torch.arange(B)
    masks = tile_masks(rows, tui, tii, (tw <= 0.0)[:, None], tii, tw, rows,
                       tui)
    lse_ui, _, lse_iu, _ = tile_stats(tile_logits(tu, tv, TEMP, cdt), *masks,
                                      True)
    scale = 1.0 / (2.0 * torch.clamp(tw.sum(), min=1e-8) * TEMP)
    du = grad_reference(tu, tv, tui, tii, tw, lse_ui, lse_iu, scale, TEMP,
                        cdt).numpy()
    dv = grad_reference(tv, tu, tii, tui, tw, lse_iu, lse_ui, scale, TEMP,
                        cdt).numpy()
    ju, ji, jw = jnp.asarray(u_idx), jnp.asarray(i_idx), jnp.asarray(w)
    pallas = _jax(make_flash_ce(ju, ji, jw, TEMP, jnp.dtype(cdt_name), B,
                                interpret=True, block=64), u, v)
    plain = _torch(flash_ce, u, v, u_idx, i_idx, w, TEMP, cdt)
    _, g_rtol, g_atol = TOLS[cdt_name]
    for ref in (pallas, plain):
        np.testing.assert_allclose(du, ref[1], rtol=g_rtol, atol=g_atol)
        np.testing.assert_allclose(dv, ref[2], rtol=g_rtol, atol=g_atol)


def test_weight_that_requires_grad_raises():
    """The weights are closed over, not differentiated: asking for their
    gradient raises instead of returning a silent zero."""
    u, v, u_idx, i_idx, w = (torch.tensor(a) for a in _batch(128, 8))
    w.requires_grad_(True)
    with pytest.raises(ValueError, match="not differentiable"):
        flash_ce(u, v, u_idx.long(), i_idx.long(), w, TEMP, torch.float32)


def test_temperature_outside_the_direct_exp_regime_raises():
    """The kernels sum exp(logits) directly, which holds for 1/temp up
    to 70; a colder temperature is refused, not overflowed."""
    u, v, u_idx, i_idx, w = (torch.tensor(a) for a in _batch(128, 8))
    with pytest.raises(ValueError, match="1/temp"):
        flash_ce(u, v, u_idx.long(), i_idx.long(), w, 0.01, torch.float32)


@pytest.mark.parametrize("cdt_name", ["float32", "bfloat16"])
def test_torch_blockwise_and_dense_forms_match_jax(cdt_name):
    """The port's blockwise (hand-written backward) and dense forms
    against the JAX package's, loss and both gradients."""
    B, D, chunk = 256, 16, 64
    u, v, u_idx, i_idx, w = _batch(B, D, seed=2, uniform_w=False)
    cdt = jnp.dtype(cdt_name)
    ju, ji, jw = jnp.asarray(u_idx), jnp.asarray(i_idx), jnp.asarray(w)
    pairs = [
        (_torch(tt.blockwise_softmax_ce, u, v, u_idx, i_idx, w, TEMP,
                chunk, CDT[cdt_name]),
         _jax(_make_blockwise_ce_vjp(ju, ji, jw, TEMP, chunk, cdt, B), u, v)),
        (_torch(tt.dense_softmax_ce, u, v, u_idx, i_idx, w, TEMP,
                CDT[cdt_name]),
         _jax(lambda a, b: _dense_softmax_ce(a, b, ju, ji, jw, TEMP, cdt),
              u, v)),
    ]
    for got, ref in pairs:
        _close(got, ref, *TOLS[cdt_name])


def test_float32_case_does_not_depend_on_the_thread_count():
    """The ``[float32-True]`` case above once failed under ``-n 6``: its
    port side gives the same bits with 1, 2 and 4 torch threads, and
    against each JAX form its worst element (loss, du, dv) uses under
    half of its tolerance, so neither a thread count nor a last-bit
    rounding can flip it."""
    B, D, block = 256, 16, 64
    u, v, u_idx, i_idx, w = _batch(B, D, uniform_w=True)
    ju, ji, jw = jnp.asarray(u_idx), jnp.asarray(i_idx), jnp.asarray(w)
    refs = [
        _jax(make_flash_ce(ju, ji, jw, TEMP, jnp.float32, B, interpret=True,
                           block=block), u, v),
        _jax(lambda a, b: _dense_softmax_ce(a, b, ju, ji, jw, TEMP,
                                            jnp.float32), u, v),
        _jax(_make_blockwise_ce_vjp(ju, ji, jw, TEMP, block, jnp.float32, B),
             u, v),
    ]
    threads = torch.get_num_threads()
    try:
        runs = []
        for n in (1, 2, 4):
            torch.set_num_threads(n)
            runs.append(_torch(flash_ce, u, v, u_idx, i_idx, w, TEMP,
                               torch.float32))
    finally:
        torch.set_num_threads(threads)
    for run in runs[1:]:
        assert run[0] == runs[0][0]
        for a, b in zip(run[1:], runs[0][1:]):
            np.testing.assert_array_equal(a, b)
    l_rtol, g_rtol, g_atol = TOLS["float32"]
    got = runs[0]
    for ref in refs:
        assert abs(got[0] - ref[0]) <= 0.5 * l_rtol * abs(ref[0])
        for g, r in zip(got[1:], ref[1:]):
            assert np.all(np.abs(g - r) <= 0.5 * (g_atol + g_rtol * np.abs(r)))
