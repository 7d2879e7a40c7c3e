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

Ring attention (sequence parallelism across processes): the sequence
axis is split over a mesh axis of a ``torch.distributed`` world, each
rank holding ``[B, L/S, H, D]``. ``ring_attention`` runs ``S`` steps of
``_accum_block`` over the key/value block it holds, with global
positions for the causal mask, passing the block to the next rank of
the ring between steps (``multihost.ring_shift``); the last step does
not pass it on. Its backward (a ``torch.autograd.Function``: autograd
does not cross a send) walks the ring again from the saved
log-sum-exp, carrying each block's key/value gradient with it, and one
last pass hands every gradient block to the rank that holds its
keys. ``ring_attention_sharded`` takes whole ``[B, L, H, D]`` tensors,
runs the ring on this rank's sequence shard (and batch shard with
``batch_axis``) and gathers the whole output on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from predictionio_torch.parallel import multihost as mh
from predictionio_torch.parallel.mesh import axis_group, axis_rank, axis_size

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


def _block_grads(q, k, v, o, do, lse, q_pos, k_pos, causal):
    """One key/value block's share of the attention gradient from the
    saved row log-sum-exp ``lse`` [B, H, Lq] (all float32): ``dq``'s
    part, and the block's ``dk``, ``dv``."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
        s = torch.where(mask[None, None], s, _NEG)
    p = torch.exp(s - lse[..., None])                         # [B, H, q, k]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    delta = torch.einsum("bqhd,bqhd->bhq", do, o)
    ds = p * (dp - delta[..., None]) * scale
    return (torch.einsum("bhqk,bkhd->bqhd", ds, k),
            torch.einsum("bhqk,bqhd->bkhd", ds, q), dv)


class _Ring(torch.autograd.Function):
    """Ring attention over a process group, forward and backward."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        n = torch.distributed.get_world_size(group)
        me = torch.distributed.get_rank(group)
        B, Lq, H, D = q.shape
        dev = q.device
        qf = q.float()
        q_pos = me * Lq + torch.arange(Lq, device=dev)
        m = torch.full((B, H, Lq), _NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, Lq), dtype=torch.float32, device=dev)
        o = torch.zeros((B, Lq, H, D), dtype=torch.float32, device=dev)
        kv = torch.stack([k.float(), v.float()])
        Lk = k.shape[1]
        for step in range(n):
            src = (me - step) % n                 # the block's origin rank
            k_pos = src * Lk + torch.arange(Lk, device=dev)
            m, l, o = _accum_block(qf, kv[0], kv[1], m, l, o, q_pos, k_pos,
                                   causal)
            if step < n - 1:                      # the last block stays
                kv = mh.ring_shift(kv, group)
        out = _finish(m, l, o, torch.float32)
        ctx.save_for_backward(q, k, v, out, m + torch.log(l.clamp_min(1e-30)))
        ctx.group, ctx.causal, ctx.n, ctx.me = group, causal, n, me
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        n, me, group = ctx.n, ctx.me, ctx.group
        dev = q.device
        qf, do = q.float(), grad_out.float()
        Lq, Lk = q.shape[1], k.shape[1]
        q_pos = me * Lq + torch.arange(Lq, device=dev)
        kv = torch.stack([k.float(), v.float()])
        dq = torch.zeros_like(qf)
        dkv = torch.zeros_like(kv)
        for step in range(n):
            src = (me - step) % n
            k_pos = src * Lk + torch.arange(Lk, device=dev)
            dq_part, dk, dv = _block_grads(qf, kv[0], kv[1], out, do, lse,
                                           q_pos, k_pos, ctx.causal)
            dq = dq + dq_part
            dkv = dkv + torch.stack([dk, dv])
            if step < n - 1:
                kv = mh.ring_shift(kv, group)
            # the gradient travels with its block, and a last pass
            # hands it to the block's own rank
            dkv = mh.ring_shift(dkv, group)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis: str, causal: bool = True, mesh=None
                   ) -> torch.Tensor:
    """Ring attention of this rank's ``[B, L/S, H, D]`` shards, the
    sequence split in rank order over ``mesh``'s ``axis`` (every rank of
    the axis calls this with its shard; ``mesh`` None: the axis is the
    whole world). On an axis of one rank it is attention over the shard
    as a single block. Differentiable: the backward runs the ring
    again, and each rank receives its own blocks' key/value gradient."""
    if mesh is None:
        n, group = mh.process_count(), None
    else:
        n, group = axis_size(mesh, axis), axis_group(mesh, axis)
    if n == 1:
        return blockwise_attention(q, k, v, block_size=q.shape[1],
                                   causal=causal)
    return _Ring.apply(q, k, v, group, causal)


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, mesh, *, axis: str = "seq",
                           causal: bool = True,
                           batch_axis: Optional[str] = None
                           ) -> torch.Tensor:
    """Whole ``[B, L, H, D]`` tensors (the same on every rank) -> the
    whole attention output on every rank: the sequence is split over
    ``mesh``'s ``axis`` (and the batch over ``batch_axis``), each rank
    runs :func:`ring_attention` on its shard, and the shards' outputs
    are gathered. ``L`` (and ``B``) must divide by the axis sizes. Each
    rank's gradient reaches its own shard of ``q`` and, through the
    ring, its shard of ``k`` and ``v``: the sum over the ranks is the
    whole gradient."""
    S = axis_size(mesh, axis)
    Bn = axis_size(mesh, batch_axis) if batch_axis is not None else 1
    B, L = q.shape[:2]
    if L % S or B % Bn:
        raise ValueError(f"[B={B}, L={L}] does not split over {Bn} x {S} "
                         "ranks")
    ls, bs = L // S, B // Bn
    si = axis_rank(mesh, axis)
    bi = axis_rank(mesh, batch_axis) if batch_axis is not None else 0

    def shard(t):
        return t[bi * bs:(bi + 1) * bs, si * ls:(si + 1) * ls]

    out = ring_attention(shard(q), shard(k), shard(v), axis=axis,
                         causal=causal, mesh=mesh)
    for n, name, dim in ((S, axis, 1), (Bn, batch_axis, 0)):
        if n > 1:
            out = mh.gather_shards(out, axis_group(mesh, name), dim)
    return out

