"""Attention for the session recommender: materialized and blockwise.

Counterpart of ``predictionio_tpu/ops/attention.py``. All shapes are
``[batch, seq, heads, head_dim]``, computed in float32 and returned in
the input's dtype. Masking uses a large finite negative, not ``-inf``,
so a fully masked block stays NaN-free (its running max is finite and
its weights are rescaled away once a real key arrives).

  - ``mha_reference``: the materialized softmax, the oracle for the
    blockwise path and the default encoder attention. A query sequence
    shorter than the key sequence is its suffix (decode style): query
    ``i`` sits at key position ``i + Lk - Lq``.
  - ``blockwise_attention``: the online-softmax recurrence over key/value
    blocks (``_accum_block`` folds one block into the running max,
    denominator and numerator; ``_finish`` divides), so the ``[L, L]``
    score matrix never exists whole. ``L`` must be a multiple of the
    block.

Both are plain tensor functions (autograd differentiates them). The JAX
package ships these two as XLA, not as a Pallas kernel (its module
docstring records the flash-attention kernel it measured and did not
ship), so neither is a kernel here; and neither calls
``F.scaled_dot_product_attention``: the tests hold these formulations
against the JAX ones.

``ring_attention`` / ``ring_attention_sharded`` (the sequence axis
sharded over a mesh, key/value blocks rotating between devices) wait for
the multi-device slice and raise (ROADMAP.md, queue 1 item 12).
"""

from __future__ import annotations

from typing import Tuple

import torch

_NEG = -0.7 * float(torch.finfo(torch.float32).max)


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """Materialized-softmax attention over ``[B, L, H, D]``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        L_q, L_k = q.shape[1], k.shape[1]
        q_pos = torch.arange(L_q, device=q.device) + (L_k - L_q)
        mask = q_pos[:, None] >= torch.arange(L_k, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _accum_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
                 q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fold one key/value block into the accumulators: ``m`` [B, H, Lq]
    running max, ``l`` [B, H, Lq] running denominator, ``o`` [B, Lq, H,
    D] running numerator (all float32)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    o_new = (o * alpha.permute(0, 2, 1)[..., None]
             + torch.einsum("bhqk,bkhd->bqhd", p, v))
    return m_new, l_new, o_new


def _finish(m: torch.Tensor, l: torch.Tensor, o: torch.Tensor,
            dtype: torch.dtype) -> torch.Tensor:
    return (o / l.clamp_min(1e-30).permute(0, 2, 1)[..., None]).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, block_size: int = 512, causal: bool = True,
                        ) -> torch.Tensor:
    """Attention as an online-softmax loop over key/value blocks of
    ``block_size``; peak memory ``O(L * block)``. ``L`` must be a
    multiple of ``block_size`` (pad upstream)."""
    B, L, H, D = q.shape
    if L % block_size:
        raise ValueError(f"seq len {L} not divisible by block_size "
                         f"{block_size}")
    dtype, dev = q.dtype, q.device
    qf, kf, vf = q.float(), k.float(), v.float()
    q_pos = torch.arange(L, device=dev)
    m = torch.full((B, H, L), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, L), dtype=torch.float32, device=dev)
    o = torch.zeros((B, L, H, D), dtype=torch.float32, device=dev)
    for start in range(0, L, block_size):
        stop = start + block_size
        k_pos = torch.arange(start, stop, device=dev)
        m, l, o = _accum_block(qf, kf[:, start:stop], vf[:, start:stop],
                               m, l, o, q_pos, k_pos, causal)
    return _finish(m, l, o, dtype)


def _ring_not_ported() -> NotImplementedError:
    return NotImplementedError(
        "ring attention (the sequence axis sharded over devices) is not "
        "ported to predictionio_torch yet (ROADMAP.md, queue 1 item 12); "
        "use blockwise_attention on one device")


def ring_attention(q, k, v, *, axis: str, causal: bool = True):
    """Per-shard ring attention: waits for the multi-device slice."""
    raise _ring_not_ported()


def ring_attention_sharded(q, k, v, mesh, *, axis: str = "seq",
                           causal: bool = True, batch_axis=None):
    """Sequence-sharded ring attention: waits for the multi-device slice."""
    raise _ring_not_ported()
