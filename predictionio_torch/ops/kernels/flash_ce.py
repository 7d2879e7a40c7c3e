"""Fused flash-CE: the two-tower symmetric in-batch softmax loss as
Hopper kernels, forward and hand-written backward under one
``torch.autograd.Function``.

Replaces ``predictionio_tpu/ops/pallas/flash_ce.py`` (``make_flash_ce``:
the forward ``pallas_call`` with body ``_fwd_kernel`` and the backward
``pallas_call``s with bodies ``_bwd_du_kernel`` / ``_bwd_dv_kernel``).
The kernels are CUDA C++ in ``csrc/flash_ce.cu``; its header says how
they are laid out and what bounds them.

Semantics are those of the JAX package's kernel:

  forward   per-tile logits rounded as ``cdt(cdt(u . v) / temp)`` (the
            matmul output in ``cdt``, then the divide by the
            ``cdt``-rounded temperature in ``cdt``); in-batch
            false-negative bans (the same item for user->item, the same
            user for item->user, zero-weight rows as columns — never
            the diagonal); one-pass direct-exp row and column exp-sums
            (unit-sphere logits are bounded by ``1/temp``, and callers
            keep ``1/temp <= 70``) and the diagonal. The log, the sum of
            the per-row-tile column partials and the loss combine stay
            torch ops, as they stay XLA outside the Pallas kernel.
  backward  softmax reconstruction from the two saved LSE vectors with
            the forward's rounding, ``coef = [w_b (p_ui - d) + w_j (p_iu
            - d)] * ct / (2 sum(w) temp)`` cast to ``cdt``, then ``du =
            coef . v`` with f32 sums. The loss is symmetric, so one
            backward kernel serves both gradients: ``dv = coef^T . u``
            is the same kernel with u <-> v, u_idx <-> i_idx and
            lse_ui <-> lse_iu swapped (:func:`grad_reference` is its
            plain version). Three launches per loss.

For bf16 the wrapper casts u and v to bf16 once per loss (zero-padded
to the kernels' width ``Dp``) and keeps the copies for the backward;
ids go to the kernels as int32, as the Pallas kernel takes them. Each
kernel writes ``split_for(B)`` partials that torch sums in a fixed
order: the loss and its gradients are the same bit for bit from run to
run.

``u_idx``, ``i_idx`` and ``weight`` are not differentiable: a ``weight``
that requires grad raises (the JAX kernel raises too; neither ever
returns a silent zero gradient).

Contract of :func:`flash_ce`: CUDA tensors launch the kernels or raise;
CPU tensors take :func:`flash_ce_reference`, the plain version: the
module's plain-torch blockwise form (the JAX package's
``_blockwise_softmax_ce`` with its hand-written VJP) with one column
tile of the whole batch. The logits rounding (:func:`tile_logits`) and
the bans (:func:`tile_masks`) are stated once here, for the kernels,
the plain version and the trainer's blockwise form alike.
"""

from __future__ import annotations

import ctypes

import torch

from predictionio_torch.ops.kernels import LaunchCounter, load_library

#: below this batch the dense loss is already cheap (the JAX package's
#: selection threshold)
MIN_BATCH = 128
#: rows and columns of one kernel tile (csrc/flash_ce.cu kTile)
TILE = 64
#: widest tower output the kernels take (D is padded to 32/64/128/256)
MAX_DIM = 256
#: direct exp-sum-log is safe while |logit| <= 1/temp stays under this
#: (f32 overflows at exp(~88.7); 70 + ln(2^24) keeps a sum of up to 2^24
#: terms finite). Tower outputs are L2-normalized, so the bound is
#: structural.
DIRECT_EXP_MAX_INV_TEMP = 70.0

#: chunks of each block's loop over the other side (grid n_tiles x
#: SPLIT, fewer when the batch has fewer tiles): at B = 8192 an H100
#: holds all 128 x 3 = 384 blocks at once (3 on each of its 132 SMs).
#: Measured with ``python -m predictionio_torch.tools.flash_ce_timing``
#: over 1, 2, 3, 4, 6 and 8: 3 and 6 fastest, 3 has half the partials
SPLIT = 3

#: kernel launches: one forward and two of the backward kernel (du,
#: then dv with the roles swapped) per loss
launches = LaunchCounter("flash_ce")

_MODE_FWD, _MODE_GRAD = 0, 1


def _check(u, v, u_idx, i_idx, weight, temp, cdt) -> None:
    if u.dim() != 2 or u.shape != v.shape:
        raise ValueError(f"flash_ce wants u, v [B, D] of one shape, got "
                         f"{tuple(u.shape)} and {tuple(v.shape)}")
    B, D = u.shape
    if not (u_idx.shape == i_idx.shape == weight.shape == (B,)):
        raise ValueError("flash_ce wants u_idx, i_idx, weight [B]")
    if u.dtype != torch.float32 or v.dtype != torch.float32 or (
            weight.dtype != torch.float32):
        raise TypeError("flash_ce wants float32 u, v and weight")
    if u_idx.dtype != torch.int64 or i_idx.dtype != torch.int64:
        raise TypeError("flash_ce wants int64 u_idx and i_idx")
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_ce compute dtype {cdt} is not float32 or "
                        "bfloat16")
    if len({t.device for t in (u, v, u_idx, i_idx, weight)}) != 1:
        raise ValueError("flash_ce inputs on different devices")
    if weight.requires_grad:
        raise ValueError(
            "flash_ce: weight is not differentiable (the loss closes over "
            "it, as the JAX kernel does); pass weight.detach(), or use a "
            "formulation with an explicit d(loss)/d(weight)")
    if not 1 <= D <= MAX_DIM:
        raise ValueError(f"flash_ce tower width {D} outside [1, {MAX_DIM}]")
    if not 0.0 < 1.0 / temp <= DIRECT_EXP_MAX_INV_TEMP:
        raise ValueError(f"flash_ce sums exp(logits) directly: 1/temp "
                         f"{1.0 / temp} must lie in (0, "
                         f"{DIRECT_EXP_MAX_INV_TEMP}]")


def tile_logits(u: torch.Tensor, v: torch.Tensor, temp: float,
                cdt: torch.dtype) -> torch.Tensor:
    """``[B, C]`` logits with the kernels' rounding: ``u . v^T`` of the
    ``cdt`` inputs summed in f32 and rounded to ``cdt``, then divided by
    the ``cdt``-rounded temperature in ``cdt``, then f32."""
    L = u.to(cdt).float() @ v.to(cdt).float().T
    if cdt == torch.float32:
        return L / temp
    return (L.to(cdt) / torch.tensor(temp, dtype=cdt)).float()


def tile_masks(rows, u_idx, i_idx, pad_row, ic, wc, colc, uc):
    """``(not_diag, ban_ui, ban_iu)`` of the logits tile of all batch
    rows (``rows``: their ids, with ``u_idx``, ``i_idx`` and ``pad_row``
    = weight <= 0 as a column) against one column tile (``colc``: its
    batch ids, with ``ic``, ``wc`` and ``uc``): ban the same item
    elsewhere in the batch (user->item), the same user (item->user) and
    zero-weight padding rows/columns — never the diagonal. The one
    statement of the banning semantics; the kernels restate it on
    global tile coordinates."""
    not_diag = colc[None, :] != rows[:, None]
    ban_ui = ((ic[None, :] == i_idx[:, None])
              | (wc <= 0.0)[None, :]) & not_diag
    ban_iu = ((u_idx[:, None] == uc[None, :]) | pad_row) & not_diag
    return not_diag, ban_ui, ban_iu


def tile_stats(Lc, not_diag, ban_ui, ban_iu, direct_exp):
    """Per-tile LSE and diagonal reductions. ``direct_exp``: unit-sphere
    logits are bounded by ``1/temp``, so the LSEs are ``log(sum(exp))``
    in one pass (a fully banned tile part gives -inf, which the
    cross-tile combine absorbs); otherwise a -1e9 sentinel and
    ``logsumexp``."""
    Lc = Lc.float()
    if direct_exp:
        e = torch.exp(Lc)
        lse_ui_c = torch.log(torch.where(ban_ui, 0.0, e).sum(dim=1))
        lse_iu_c = torch.log(torch.where(ban_iu, 0.0, e).sum(dim=0))
    else:
        lse_ui_c = torch.logsumexp(torch.where(ban_ui, -1e9, Lc), dim=1)
        lse_iu_c = torch.logsumexp(torch.where(ban_iu, -1e9, Lc), dim=0)
    on_diag = torch.where(~not_diag, Lc, 0.0)
    return lse_ui_c, on_diag.sum(dim=1), lse_iu_c, on_diag.sum(dim=0)


class _BlockwiseCE(torch.autograd.Function):
    """Blockwise CE with a hand-written backward (the JAX package's
    ``_make_blockwise_ce_vjp``, an XLA scan there, plain torch here):
    logits in ``[B, chunk]`` column tiles, one pass yielding both
    directions; the backward reconstructs the softmax from the two saved
    LSE vectors, ``dLoss/dL[b,j] = [w_b (p_ui - d) + w_j (p_iu - d)] /
    (2 sum(w))``."""

    @staticmethod
    def forward(ctx, u, v, u_idx, i_idx, weight, temp, chunk, cdt):
        B = u.shape[0]
        rows = torch.arange(B, device=u.device)
        pad_row = (weight <= 0.0)[:, None]
        wsum = torch.clamp(weight.sum(), min=1e-8)
        direct = (1.0 / temp) <= DIRECT_EXP_MAX_INV_TEMP
        iu_total = torch.zeros((), device=u.device)
        lse_parts, diag_sum, lse_iu = [], torch.zeros(B, device=u.device), []
        for s in range(0, B, chunk):
            sl = slice(s, s + chunk)
            Lc = tile_logits(u, v[sl], temp, cdt)
            masks = tile_masks(rows, u_idx, i_idx, pad_row, i_idx[sl],
                               weight[sl], rows[sl], u_idx[sl])
            lse_c, diag_c, lse_iu_c, pos_c = tile_stats(Lc, *masks, direct)
            iu_total = iu_total + torch.sum(weight[sl] * (lse_iu_c - pos_c))
            lse_parts.append(lse_c)
            diag_sum = diag_sum + diag_c
            lse_iu.append(lse_iu_c)
        lse_ui = torch.logsumexp(torch.stack(lse_parts), dim=0)
        loss = 0.5 * (torch.sum((lse_ui - diag_sum) * weight)
                      + iu_total) / wsum
        ctx.save_for_backward(u, v, u_idx, i_idx, weight, lse_ui,
                              torch.cat(lse_iu), wsum)
        ctx.temp, ctx.chunk, ctx.cdt = temp, chunk, cdt
        return loss

    @staticmethod
    def backward(ctx, ct):
        u, v, u_idx, i_idx, weight, lse_ui, lse_iu, wsum = ctx.saved_tensors
        temp, chunk, cdt = ctx.temp, ctx.chunk, ctx.cdt
        B = u.shape[0]
        rows = torch.arange(B, device=u.device)
        pad_row = (weight <= 0.0)[:, None]
        scale = ct / (2.0 * wsum * temp)
        du = torch.zeros_like(u)
        dv = []
        for s in range(0, B, chunk):
            sl = slice(s, s + chunk)
            # recompute the tile logits exactly as the forward did: a
            # different rounding would reconstruct probabilities that
            # disagree with the saved LSEs
            Lc = tile_logits(u, v[sl], temp, cdt)
            not_diag, ban_ui, ban_iu = tile_masks(
                rows, u_idx, i_idx, pad_row, i_idx[sl], weight[sl],
                rows[sl], u_idx[sl])
            p_ui = torch.where(ban_ui, 0.0, torch.exp(Lc - lse_ui[:, None]))
            p_iu = torch.where(ban_iu, 0.0,
                               torch.exp(Lc - lse_iu[sl][None, :]))
            isdiag = (~not_diag).float()
            coef = (weight[:, None] * (p_ui - isdiag)
                    + weight[sl][None, :] * (p_iu - isdiag)) * scale
            cc = coef.to(cdt).float()
            du = du + cc @ v[sl].to(cdt).float()
            dv.append(cc.T @ u.to(cdt).float())
        return du, torch.cat(dv), None, None, None, None, None, None


def blockwise_softmax_ce(u, v, u_idx, i_idx, weight, temp, chunk, cdt):
    """Blockwise symmetric in-batch softmax CE (``B % chunk == 0``), in
    plain torch; equal to the dense form up to the logits' rounding."""
    if u.shape[0] % chunk:
        raise ValueError(f"batch {u.shape[0]} is not a multiple of the "
                         f"loss chunk {chunk}")
    return _BlockwiseCE.apply(u, v, u_idx, i_idx, weight, float(temp),
                              int(chunk), cdt)


def grad_reference(own, other, own_ids, other_ids, weight, lse_own,
                   lse_other, scale, temp, cdt) -> torch.Tensor:
    """The plain version of the backward kernel: the gradient of the
    loss with respect to one tower's rows ``own`` ``[B, D]``, given the
    other tower's rows, each side's ids (``own_ids`` are compared for
    the other side's bans, ``other_ids`` for this side's), the weights,
    the two saved LSE vectors (this side's first), the scalar ``scale``
    = ``ct / (2 sum(w) temp)``, ``temp`` and ``cdt``. ``du`` is
    ``grad_reference(u, v, u_idx, i_idx, w, lse_ui, lse_iu, ...)``;
    the loss is symmetric, so ``dv`` is the same call with the roles
    swapped: ``grad_reference(v, u, i_idx, u_idx, w, lse_iu, lse_ui,
    ...)``, as the kernel is launched."""
    rows = torch.arange(own.shape[0], device=own.device)
    L = tile_logits(own, other, temp, cdt)
    not_diag, ban_ui, ban_iu = tile_masks(
        rows, own_ids, other_ids, (weight <= 0.0)[:, None], other_ids,
        weight, rows, own_ids)
    p_ui = torch.where(ban_ui, 0.0, torch.exp(L - lse_own[:, None]))
    p_iu = torch.where(ban_iu, 0.0, torch.exp(L - lse_other[None, :]))
    isdiag = (~not_diag).float()
    coef = (weight[:, None] * (p_ui - isdiag)
            + weight[None, :] * (p_iu - isdiag)) * scale
    return coef.to(cdt).float() @ other.to(cdt).float()


def split_for(B: int) -> int:
    """Chunks S of the loop over the other side (grid n_tiles x S): at
    most the number of tiles, so every block has work."""
    return min(SPLIT, -(-B // TILE))


def _launcher():
    lib = load_library("flash_ce")
    fn = lib.flash_ce_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [i, i, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, f,
                       p]
        fn.restype = ctypes.c_int
        lib.flash_ce_error_string.argtypes = [ctypes.c_int]
        lib.flash_ce_error_string.restype = ctypes.c_char_p
    return lib, fn


def _launch(mode, u, v, u_idx, i_idx, weight, temp, cdt, split, *,
            lse_ui=None, lse_iu=None, scale=None, sum_ui=None, diag=None,
            iu_parts=None, out=None) -> None:
    """One kernel launch. ``u``, ``v``: the row and column sides, bf16
    ``[B, Dp]`` (cdt bfloat16) or f32 ``[B, D]``; ids int32; ``D`` is
    the output width (``out`` ``[split, B, D]``)."""
    B = u.shape[0]
    D = out.shape[2] if out is not None else u.shape[1]
    temp_c = float(torch.tensor(temp, dtype=cdt))   # the cdt-rounded divisor
    lib, fn = _launcher()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = fn(mode, int(cdt == torch.bfloat16), ptr(u), ptr(v),
                 ptr(u_idx), ptr(i_idx), ptr(weight), ptr(lse_ui),
                 ptr(lse_iu), ptr(scale), ptr(sum_ui), ptr(diag),
                 ptr(iu_parts), ptr(out), B, D, split, temp_c, stream)
    if err != 0:
        raise RuntimeError(
            f"flash_ce launch failed (mode={mode}, B={B}, D={D}, "
            f"split={split}, cdt={cdt}): CUDA error {err}: "
            f"{lib.flash_ce_error_string(err).decode(errors='replace')}")
    launches.add()


def _kernel_inputs(u, v, cdt):
    """What the kernels read: bf16 copies zero-padded to ``Dp`` columns
    (cast once per loss, kept for the backward), or f32 as given."""
    if cdt == torch.float32:
        return u.contiguous(), v.contiguous()
    D = u.shape[1]
    pad = next(p for p in (32, 64, 128, 256) if D <= p) - D
    return tuple(torch.nn.functional.pad(t.to(torch.bfloat16), (0, pad))
                 .contiguous() for t in (u, v))


def forward_kernel(ub, vb, u_idx, i_idx, weight, temp, cdt, split=None):
    """The forward kernel on kernel inputs (:func:`_kernel_inputs`, ids
    int32): ``(lse_ui, lse_iu, diag)``, each ``[B]`` f32, with the
    partials summed by torch in a fixed order."""
    B = ub.shape[0]
    split = split_for(B) if split is None else split
    dev = ub.device
    sum_ui = torch.empty((split, B), dtype=torch.float32, device=dev)
    diag = torch.empty(B, dtype=torch.float32, device=dev)
    iu_parts = torch.empty((-(-B // TILE), B), dtype=torch.float32,
                           device=dev)
    _launch(_MODE_FWD, ub, vb, u_idx, i_idx, weight, temp, cdt, split,
            sum_ui=sum_ui, diag=diag, iu_parts=iu_parts)
    return (torch.log(sum_ui.sum(dim=0)), torch.log(iu_parts.sum(dim=0)),
            diag)


def grad_kernel(own, other, own_ids, other_ids, weight, lse_own, lse_other,
                scale, temp, cdt, D, split=None) -> torch.Tensor:
    """The backward kernel, with :func:`grad_reference`'s arguments on
    kernel inputs (``scale`` a one-element f32 tensor): the ``[B, D]``
    gradient of ``own``, its ``split`` partials summed by torch in a
    fixed order."""
    B = own.shape[0]
    split = split_for(B) if split is None else split
    out = torch.empty((split, B, D), dtype=torch.float32, device=own.device)
    _launch(_MODE_GRAD, own, other, own_ids, other_ids, weight, temp, cdt,
            split, lse_ui=lse_own, lse_iu=lse_other, scale=scale, out=out)
    return out[0] if split == 1 else out.sum(dim=0)


class _FlashCE(torch.autograd.Function):
    """``loss = _FlashCE.apply(u, v, u_idx, i_idx, weight, temp, cdt)``
    on CUDA tensors: the forward kernel, then under autograd the
    backward kernel twice, for du and (roles swapped) for dv; gradients
    flow to ``u`` and ``v`` only."""

    @staticmethod
    def forward(ctx, u, v, u_idx, i_idx, weight, temp, cdt):
        ub, vb = _kernel_inputs(u, v, cdt)
        ui, ii = (t.to(torch.int32).contiguous() for t in (u_idx, i_idx))
        weight = weight.contiguous()
        wsum = torch.clamp(weight.sum(), min=1e-8)
        lse_ui, lse_iu, diag = forward_kernel(ub, vb, ui, ii, weight, temp,
                                              cdt)
        loss = 0.5 * (torch.sum((lse_ui - diag) * weight)
                      + torch.sum((lse_iu - diag) * weight)) / wsum
        ctx.save_for_backward(ub, vb, ui, ii, weight, lse_ui, lse_iu, wsum)
        ctx.temp, ctx.cdt, ctx.D = temp, cdt, u.shape[1]
        return loss

    @staticmethod
    def backward(ctx, ct):
        ub, vb, ui, ii, weight, lse_ui, lse_iu, wsum = ctx.saved_tensors
        scale = (ct / (2.0 * wsum * ctx.temp)).reshape(1).contiguous()
        du = grad_kernel(ub, vb, ui, ii, weight, lse_ui, lse_iu, scale,
                         ctx.temp, ctx.cdt, ctx.D)
        dv = grad_kernel(vb, ub, ii, ui, weight, lse_iu, lse_ui, scale,
                         ctx.temp, ctx.cdt, ctx.D)
        return du, dv, None, None, None, None, None


def flash_ce(u: torch.Tensor, v: torch.Tensor, u_idx: torch.Tensor,
             i_idx: torch.Tensor, weight: torch.Tensor, temp: float,
             cdt: torch.dtype) -> torch.Tensor:
    """The symmetric in-batch softmax CE of unit-norm towers ``u``,
    ``v`` ``[B, D]`` (f32) with in-batch false-negative masking; a
    scalar, differentiable in ``u`` and ``v``. CUDA tensors run the
    kernels (the forward now, the backward under autograd), CPU tensors
    their plain version :func:`flash_ce_reference`."""
    _check(u, v, u_idx, i_idx, weight, temp, cdt)
    if u.device.type == "cpu":
        return flash_ce_reference(u, v, u_idx, i_idx, weight, temp, cdt)
    if u.device.type != "cuda":
        raise ValueError(f"flash_ce has no kernel for device {u.device}")
    return _FlashCE.apply(u, v, u_idx, i_idx, weight, float(temp), cdt)


def flash_ce_reference(u, v, u_idx, i_idx, weight, temp, cdt
                       ) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_ce`, on any device: the
    blockwise form with one column tile of the whole batch, so both
    passes run over the whole ``[B, B]`` logits with the kernels'
    rounding (how ``chip_smoke.py`` holds the kernels against it on the
    card)."""
    _check(u, v, u_idx, i_idx, weight, temp, cdt)
    return blockwise_softmax_ce(u, v, u_idx, i_idx, weight, temp,
                                u.shape[0], cdt)
