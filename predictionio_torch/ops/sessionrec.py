"""Sequential (next-item) recommendation: a causal transformer over event
histories.

Counterpart of ``predictionio_tpu/ops/sessionrec.py``: a SASRec-style
pre-LN encoder over each user's chronological item history, trained to
predict the next item with a softmax over the whole catalog tied to the
input embedding. Histories are truncated or padded to ``max_len`` (item
id 0 is the pad; real items are 1-shifted).

The encoder follows the flax module layer for layer: the embedding
scaled by ``dim ** 0.5`` plus a learned position table, dropout, then
per block LayerNorm (``eps=1e-6``, flax's) -> fused QKV projection ->
causal attention (``ops/attention.py``: blockwise when ``attn_block >
0``, else materialized) -> output projection -> dropout -> residual,
LayerNorm -> Dense -> tanh GELU (flax's default) -> Dense -> dropout ->
residual; a final LayerNorm, and pad positions zeroed.

Weights carry across the two packages: ``params_from_flax`` turns the
JAX package's flax variables (numpy leaves under flax names) into this
module's ``state_dict`` and ``params_to_flax`` goes back.
``SessionRecModelState.params`` stores the flax layout, so a model blob
written by either package loads in the other.

Training (``SessionRecTrainer``): the JAX trainer's epoch orders (numpy
``default_rng(seed)`` permutations of the trainable rows, the last batch
wrapped to full size), AdamW over every parameter in one group (as
``optax.adamw`` decays every leaf), dropout masks drawn from a
``torch.Generator`` seeded with ``seed + 1`` on the trainer's device
(another stream than ``jax.random``'s: parity tests run with dropout 0),
and the masked mean CE over ``target > 0`` of the ``[B, L, V]`` tied
logits, in float32. Checkpoints (``checkpoint_dir``) go through
``core/checkpoint.py`` and carry the parameters, the AdamW state, the
shuffle generator's state and the dropout generator's state.

Serving (``SessionScorer``): the last real position's hidden state is
scored against ``item_embed[1:]`` (the pad row is never a candidate)
through the retrieval index (``index/exact.py``: the ``topk_dot`` kernel
on a card, one launch a lone query), the seen items (0-based) passed as
exclusions. The index excludes up to ``max_len`` items, so no seen item
is ever dropped: a session with more than ``topk_dot.MAX_EXCLUDE``
distinct seen items goes to the index's masked full product. Excluded items come back at ``NEG_INF``
(finite), where the JAX scorer gives ``-inf``; callers drop both.

Observability: each epoch's wall time (it ends when the step losses
reach the host) goes to ``torchmon.observe_train_step`` (the JAX
trainer observes each step, which it syncs; here the steps run
asynchronously, so the epoch is the timed unit), and the
``sessionrec`` MFU gauge counts the epoch's steps of
``perfacct.sessionrec_step_flops``. The batches move no bytes from the
host (the sequences live on the device), so no transfer is recorded.

Not in this port yet: ring attention over a mesh (``seq_axis``;
ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from predictionio_torch.core.checkpoint import (TrainCheckpointer,
                                                train_fingerprint)
from predictionio_torch.index import make_index
from predictionio_torch.obs import perfacct, torchmon
from predictionio_torch.ops.attention import (blockwise_attention,
                                              mha_reference)
from predictionio_torch.ops.kernels.topk_dot import MAX_EXCLUDE
from predictionio_torch.parallel.context import DeviceLike, resolve_device

log = logging.getLogger(__name__)

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class SessionRecConfig:
    dim: int = 64
    heads: int = 2
    layers: int = 2
    ffn_mult: int = 4
    max_len: int = 64              # fixed sequence length (pad id = 0)
    dropout: float = 0.1
    learning_rate: float = 1e-3
    weight_decay: float = 1e-6
    epochs: int = 5
    batch_size: int = 256
    seed: int = 13
    attn_block: int = 0            # >0: blockwise attention block size
    seq_axis: Optional[str] = None  # mesh axis for ring attention (SP)
    checkpoint_dir: Optional[str] = None  # mid-training checkpoint/resume
    checkpoint_every: int = 1             # epochs between checkpoints


def _dropout(x: torch.Tensor, rate: float,
             gen: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale
    the kept by ``1 / (1 - rate)``; ``gen is None`` is inference."""
    if gen is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=gen, device=x.device) < keep_prob
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


class _Block(nn.Module):
    """Pre-LN transformer block (flax ``_Block``)."""

    def __init__(self, cfg: SessionRecConfig):
        super().__init__()
        self.cfg = cfg
        d, inner = cfg.dim, cfg.heads * (cfg.dim // cfg.heads)
        self.norm0 = nn.LayerNorm(d, eps=LN_EPS)
        self.qkv = nn.Linear(d, 3 * inner)
        self.proj = nn.Linear(inner, d)
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.ffn_in = nn.Linear(d, d * cfg.ffn_mult)
        self.ffn_out = nn.Linear(d * cfg.ffn_mult, d)

    def forward(self, x: torch.Tensor,
                gen: Optional[torch.Generator]) -> torch.Tensor:
        cfg = self.cfg
        head_dim = cfg.dim // cfg.heads
        h = self.norm0(x)
        B, L, _ = h.shape
        q, k, v = self.qkv(h).view(B, L, 3, cfg.heads, head_dim).unbind(2)
        if cfg.attn_block:
            attn = blockwise_attention(q, k, v, block_size=cfg.attn_block)
        else:
            attn = mha_reference(q, k, v, causal=True)
        attn = self.proj(attn.reshape(B, L, cfg.heads * head_dim))
        x = x + _dropout(attn, cfg.dropout, gen)
        h = F.gelu(self.ffn_in(self.norm1(x)), approximate="tanh")
        return x + _dropout(self.ffn_out(h), cfg.dropout, gen)


class SessionEncoder(nn.Module):
    """Item + position embedding -> causal blocks -> hidden states
    ``[B, L, dim]``. The vocabulary is ``n_items + 1``: row 0 is the
    padding token."""

    def __init__(self, n_items: int, cfg: SessionRecConfig):
        super().__init__()
        self.n_items, self.cfg = n_items, cfg
        self.item_embed = nn.Embedding(n_items + 1, cfg.dim)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_len, cfg.dim))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.final_norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)

    def forward(self, seq: torch.Tensor,
                gen: Optional[torch.Generator] = None) -> torch.Tensor:
        """``gen`` draws the dropout masks; None is inference."""
        cfg = self.cfg
        x = self.item_embed(seq) * (cfg.dim ** 0.5)
        x = x + self.pos_embed[None, : seq.shape[1]]
        x = _dropout(x, cfg.dropout, gen)
        for block in self.blocks:
            x = block(x, gen)
        x = self.final_norm(x)
        return x * (seq > 0)[..., None].to(x.dtype)


def init_encoder(encoder: SessionEncoder, gen: torch.Generator) -> None:
    """flax's initializers in kind (the streams differ): lecun-normal
    (truncated) kernels, zero biases, unit LayerNorm scales, embeddings
    ~ N(0, 1/dim), positions ~ N(0, 0.02)."""
    with torch.no_grad():
        for module in encoder.modules():
            if isinstance(module, nn.Linear):
                # variance_scaling(1, fan_in, truncated_normal): the std of
                # the untruncated normal corrected for the +-2 sigma cut
                std = math.sqrt(1.0 / module.in_features) / .87962566103423978
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std,
                                      2 * std, generator=gen)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        nn.init.normal_(encoder.item_embed.weight, 0.0,
                        math.sqrt(1.0 / encoder.cfg.dim), generator=gen)
        nn.init.normal_(encoder.pos_embed, 0.0, 0.02, generator=gen)


# -- the flax layout ------------------------------------------------------------

def params_from_flax(tree: Dict) -> Dict[str, torch.Tensor]:
    """The JAX package's flax variables (``{"params": {...}}``, numpy or
    array leaves) -> a ``SessionEncoder`` state dict (float32 tensors on
    the host)."""
    p = tree["params"]

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    emb = np.asarray(p["item_embed"]["embedding"])
    dim = emb.shape[1]
    out = {"item_embed.weight": t(emb), "pos_embed": t(p["pos_embed"]),
           "final_norm.weight": t(p["final_norm"]["scale"]),
           "final_norm.bias": t(p["final_norm"]["bias"])}
    i = 0
    while f"block_{i}" in p:
        b, pre = p[f"block_{i}"], f"blocks.{i}."
        qkv, o = b["DenseGeneral_0"], b["DenseGeneral_1"]
        out.update({
            pre + "norm0.weight": t(b["LayerNorm_0"]["scale"]),
            pre + "norm0.bias": t(b["LayerNorm_0"]["bias"]),
            # [dim, 3, H, Dh] -> Linear weight [3*H*Dh, dim]
            pre + "qkv.weight": t(np.asarray(qkv["kernel"]).reshape(dim, -1).T),
            pre + "qkv.bias": t(np.asarray(qkv["bias"]).reshape(-1)),
            # [H, Dh, dim] -> Linear weight [dim, H*Dh]
            pre + "proj.weight": t(np.asarray(o["kernel"]).reshape(-1, dim).T),
            pre + "proj.bias": t(o["bias"]),
            pre + "norm1.weight": t(b["LayerNorm_1"]["scale"]),
            pre + "norm1.bias": t(b["LayerNorm_1"]["bias"]),
            pre + "ffn_in.weight": t(np.asarray(b["Dense_0"]["kernel"]).T),
            pre + "ffn_in.bias": t(b["Dense_0"]["bias"]),
            pre + "ffn_out.weight": t(np.asarray(b["Dense_1"]["kernel"]).T),
            pre + "ffn_out.bias": t(b["Dense_1"]["bias"]),
        })
        i += 1
    return out


def params_to_flax(encoder: SessionEncoder) -> Dict:
    """A ``SessionEncoder``'s parameters -> the flax variables tree with
    numpy float32 leaves (the stored format)."""
    cfg = encoder.cfg
    H, Dh, dim = cfg.heads, cfg.dim // cfg.heads, cfg.dim
    sd = {k: v.detach().cpu().numpy().astype(np.float32, copy=True)
          for k, v in encoder.state_dict().items()}

    def ln(pre):
        return {"scale": sd[pre + ".weight"], "bias": sd[pre + ".bias"]}

    params = {"item_embed": {"embedding": sd["item_embed.weight"]},
              "pos_embed": sd["pos_embed"],
              "final_norm": ln("final_norm")}
    for i in range(cfg.layers):
        pre = f"blocks.{i}."
        params[f"block_{i}"] = {
            "LayerNorm_0": ln(pre + "norm0"),
            "DenseGeneral_0": {
                "kernel": np.ascontiguousarray(
                    sd[pre + "qkv.weight"].T.reshape(dim, 3, H, Dh)),
                "bias": sd[pre + "qkv.bias"].reshape(3, H, Dh)},
            "DenseGeneral_1": {
                "kernel": np.ascontiguousarray(
                    sd[pre + "proj.weight"].T.reshape(H, Dh, dim)),
                "bias": sd[pre + "proj.bias"]},
            "LayerNorm_1": ln(pre + "norm1"),
            "Dense_0": {"kernel": np.ascontiguousarray(
                sd[pre + "ffn_in.weight"].T), "bias": sd[pre + "ffn_in.bias"]},
            "Dense_1": {"kernel": np.ascontiguousarray(
                sd[pre + "ffn_out.weight"].T),
                "bias": sd[pre + "ffn_out.bias"]},
        }
    return {"params": params}


def build_sequences(user_idx: np.ndarray, item_idx: np.ndarray,
                    times: np.ndarray, n_users: int,
                    max_len: int) -> np.ndarray:
    """Per-user chronological histories -> ``[n_users, max_len + 1]``
    int32 of 1-shifted item ids, LEFT-aligned (trailing 0-pad); the
    extra column keeps each history's final target. Only the last
    ``max_len + 1`` events of a user are kept. (A copy of the JAX
    function: the same sort and scatter, bit for bit.)"""
    order = np.lexsort((times, user_idx))
    u, it = user_idx[order], item_idx[order] + 1
    out = np.zeros((n_users, max_len + 1), np.int32)
    if len(u) == 0:
        return out
    starts = np.searchsorted(u, np.arange(n_users))
    ends = np.searchsorted(u, np.arange(n_users), side="right")
    lengths = ends - starts
    pos = np.arange(len(u)) - starts[u]
    drop = np.maximum(lengths - (max_len + 1), 0)[u]
    kept = pos >= drop
    out[u[kept], pos[kept] - drop[kept]] = it[kept]
    return out


@dataclasses.dataclass
class SessionRecModelState:
    """Serializable training product: the flax params tree (numpy
    leaves) and the per-user padded histories for serve-time encoding."""

    params: Dict
    sequences: np.ndarray          # [n_users, max_len] inputs (1-shifted)
    n_items: int
    cfg: SessionRecConfig
    losses: List[float]


def tied_loss(encoder: SessionEncoder, seq: torch.Tensor, tgt: torch.Tensor,
              gen: Optional[torch.Generator]) -> torch.Tensor:
    """Masked mean next-item CE over the ``[B, L, V]`` logits of the
    hidden states against the tied item table (targets ``> 0`` count)."""
    h = encoder(seq, gen)
    logits = h @ encoder.item_embed.weight.T
    ll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tgt.reshape(-1).long(), reduction="none")
    mask = (tgt > 0).reshape(-1).to(ll.dtype)
    return (ll * mask).sum() / mask.sum().clamp_min(1e-8)


class SessionRecTrainer:
    """Sequence build, parameter init and the optimizer up front; ``run``
    walks the epochs. ``params`` (a flax variables tree) starts from
    given weights instead of this trainer's own initialization."""

    def __init__(self, events: Tuple[np.ndarray, np.ndarray, np.ndarray],
                 n_users: int, n_items: int, cfg: SessionRecConfig,
                 device: DeviceLike = None, params: Optional[Dict] = None):
        if cfg.seq_axis is not None:
            raise NotImplementedError(
                f"seq_axis={cfg.seq_axis!r}: ring attention over a device "
                "mesh is not ported to predictionio_torch yet (ROADMAP.md, "
                "queue 1 item 12); train with attn_block on one device")
        self.cfg, self.n_items = cfg, n_items
        self.device = dev = resolve_device(device)
        u_idx, i_idx, times = events
        t0 = time.perf_counter()
        seqs = build_sequences(np.asarray(u_idx, np.int64),
                               np.asarray(i_idx, np.int64),
                               np.asarray(times), n_users, cfg.max_len)
        self.inputs = seqs[:, :-1]                      # [U, max_len]
        self.targets = seqs[:, 1:]                      # next-item labels
        self._train_rows = np.flatnonzero((self.targets > 0).any(axis=1))
        #: host seconds of ``build_sequences``
        self.sequence_seconds = time.perf_counter() - t0

        self.encoder = SessionEncoder(n_items, cfg).to(dev)
        if params is None:
            init_encoder(self.encoder,
                         torch.Generator(device=dev).manual_seed(cfg.seed))
        else:
            self.encoder.load_state_dict(params_from_flax(params))
        self._opt = self._make_opt()
        self.batch = cfg.batch_size
        self._inputs_dev = torch.from_numpy(
            np.ascontiguousarray(self.inputs)).to(dev)
        self._targets_dev = torch.from_numpy(
            np.ascontiguousarray(self.targets)).to(dev)
        self._shuffle = np.random.default_rng(cfg.seed)
        self._dropout_gen = torch.Generator(device=dev).manual_seed(
            cfg.seed + 1)
        self._epochs_done = 0
        self._losses: List[float] = []
        #: MFU accounting (obs/perfacct.py) over the analytic step count
        self._acct = perfacct.StepAccountant(
            "sessionrec", perfacct.sessionrec_step_flops(
                self.batch, cfg.max_len, n_items + 1, cfg.dim, cfg.layers,
                cfg.heads, cfg.ffn_mult), device=dev)
        #: host wall time of each epoch, ending when its losses reached
        #: the host; steps per epoch
        self.epoch_seconds: List[float] = []
        self.steps_per_epoch = 0
        self.restore_seconds = 0.0
        self._ckpt = None
        if cfg.checkpoint_dir:
            t0 = time.perf_counter()
            fp = train_fingerprint(cfg, n_users, n_items, self.inputs.shape,
                                   self.inputs[:512], self.inputs[-512:],
                                   "predictionio_torch")
            self._ckpt = TrainCheckpointer(cfg.checkpoint_dir,
                                           every=cfg.checkpoint_every,
                                           fingerprint=fp)
            restored = self._ckpt.restore()
            if restored is not None:
                self._restore(*restored)
                self.restore_seconds = time.perf_counter() - t0

    def _make_opt(self) -> torch.optim.Optimizer:
        return torch.optim.AdamW(self.encoder.parameters(),
                                 lr=self.cfg.learning_rate, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=self.cfg.weight_decay)

    def _checkpoint_state(self) -> dict:
        return {"params": params_to_flax(self.encoder),
                "opt": self._opt.state_dict(),
                "shuffle_state": self._shuffle.bit_generator.state,
                "dropout_gen": self._dropout_gen.get_state(),
                "dropout_gen_device": self.device.type,
                "losses": list(self._losses)}

    def _restore(self, epoch: int, state: dict) -> None:
        if state["dropout_gen_device"] != self.device.type:
            raise ValueError(
                f"checkpoint in {self.cfg.checkpoint_dir!r} was written by "
                f"a trainer on {state['dropout_gen_device']}: its dropout "
                f"generator state does not restore on {self.device.type} "
                "(resume on the same device type, or use another "
                "checkpoint_dir)")
        self.encoder.load_state_dict(params_from_flax(state["params"]))
        self._opt = self._make_opt()
        opt = state["opt"]
        self._opt.load_state_dict({
            "state": {k: {name: torch.from_numpy(np.asarray(v))
                          for name, v in st.items()}
                      for k, st in opt["state"].items()},
            "param_groups": opt["param_groups"]})
        self._shuffle.bit_generator.state = state["shuffle_state"]
        self._dropout_gen.set_state(
            torch.from_numpy(np.asarray(state["dropout_gen"])))
        self._epochs_done = int(epoch)
        self._losses = list(state["losses"])

    def epoch_batches(self, order: np.ndarray) -> np.ndarray:
        """``[n_batches, batch]`` rows of one epoch's order, the last
        batch wrapped to full size as the JAX trainer does."""
        rows = []
        for s in range(0, len(order), self.batch):
            sel = order[s:s + self.batch]
            if len(sel) < self.batch:
                sel = (np.concatenate([sel, order[: self.batch - len(sel)]])
                       if len(order) >= self.batch
                       else np.resize(sel, self.batch))
            rows.append(sel)
        return np.stack(rows) if rows else np.zeros((0, self.batch), np.int64)

    def step(self, seq: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        """One AdamW step on a batch; the loss stays on the device."""
        loss = tied_loss(self.encoder, seq, tgt, self._dropout_gen)
        self._opt.zero_grad(set_to_none=True)
        loss.backward()
        self._opt.step()
        return loss.detach()

    def run(self, epochs: Optional[int] = None) -> List[float]:
        """Train up to ``epochs`` TOTAL epochs (resume-aware: epochs a
        restored checkpoint completed are not repeated). The epoch's
        loss is the host float64 sum of its step losses in step order
        over the step count, as in the JAX trainer."""
        target = epochs if epochs is not None else self.cfg.epochs
        self.encoder.train()
        while self._epochs_done < target:
            t0 = time.perf_counter()
            order = self._shuffle.permutation(self._train_rows)
            batches = torch.from_numpy(self.epoch_batches(order)).to(
                self.device)
            self.steps_per_epoch = len(batches)
            step_losses = [self.step(self._inputs_dev[sel],
                                     self._targets_dev[sel])
                           for sel in batches]
            total = 0.0
            for x in (torch.stack(step_losses).tolist()
                      if step_losses else []):
                total += x
            self._losses.append(total / max(len(step_losses), 1))
            self._epochs_done += 1
            self.epoch_seconds.append(time.perf_counter() - t0)
            torchmon.observe_train_step(self.epoch_seconds[-1])
            self._acct.observe(self.epoch_seconds[-1],
                               steps=len(step_losses))
            log.info("sessionrec epoch %d: loss %.6f, %.3f s, %d steps "
                     "(%.3f ms a step)", self._epochs_done, self._losses[-1],
                     self.epoch_seconds[-1], len(step_losses),
                     1e3 * self.epoch_seconds[-1] / max(len(step_losses), 1))
            if self._ckpt is not None:
                self._ckpt.maybe_save(self._epochs_done,
                                      self._checkpoint_state())
        return list(self._losses)

    def state(self, losses: Optional[List[float]] = None
              ) -> SessionRecModelState:
        """The serving product: each user's last ``max_len`` real items
        (the held-out target column appended, then re-truncated)."""
        full = np.concatenate([self.inputs, self.targets[:, -1:]], axis=1)
        L = self.cfg.max_len
        counts = (full > 0).sum(axis=1)
        drop = np.maximum(counts - L, 0)
        gather = np.minimum(drop[:, None] + np.arange(L)[None, :],
                            full.shape[1] - 1)
        serve = np.take_along_axis(full, gather, axis=1)
        serve[np.arange(L)[None, :] >= counts[:, None] - drop[:, None]] = 0
        return SessionRecModelState(
            params=params_to_flax(self.encoder), sequences=serve,
            n_items=self.n_items, cfg=self.cfg, losses=losses or [])


class SessionScorer:
    """Serve path: encode histories, score the catalog from the last
    real position's hidden state, top-k with optional seen-item
    exclusion, on ``device`` (None: the card)."""

    def __init__(self, state: SessionRecModelState, device: DeviceLike = None):
        self.state = state
        self.device = resolve_device(device)
        attn_block = state.cfg.attn_block
        if state.cfg.seq_axis is not None and not attn_block:
            # trained with ring attention because max_len's O(L^2) score
            # matrix is too big for one device: serve blockwise with the
            # largest power-of-two block <= 512 that divides max_len
            attn_block = 512
            while state.cfg.max_len % attn_block:
                attn_block //= 2
        self._cfg = dataclasses.replace(state.cfg, dropout=0.0,
                                        seq_axis=None, attn_block=attn_block)
        self.encoder = SessionEncoder(state.n_items, self._cfg)
        self.encoder.load_state_dict(params_from_flax(state.params))
        self.encoder.to(self.device).eval()
        # a copy: a stored tree's arrays may be read-only
        items = np.array(state.params["params"]["item_embed"]["embedding"][1:],
                         np.float32)
        self.index = make_index(items, device=self.device,
                                max_exclude=max(MAX_EXCLUDE,
                                                state.cfg.max_len))

    def hidden(self, seq_rows: np.ndarray) -> torch.Tensor:
        """``[B, dim]`` hidden state at each row's last real position."""
        seq = torch.from_numpy(
            np.ascontiguousarray(seq_rows, dtype=np.int32)).to(self.device)
        with torch.no_grad():
            h = self.encoder(seq)
            last = ((seq > 0).sum(dim=1) - 1).clamp_min(0)
            return h[torch.arange(len(seq), device=self.device), last]

    def top_k(self, seq_rows: np.ndarray, k: int, *,
              exclude_seen: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [B, k'], 0-based item ids [B, k']), k' = min(k,
        catalog size), under (score descending, id ascending); excluded
        items score ``NEG_INF``."""
        seq_rows = np.atleast_2d(np.asarray(seq_rows, np.int32))
        k = min(int(k), self.state.n_items)
        last = self.hidden(seq_rows)
        if not exclude_seen:
            return self.index.search(last, k)
        seen = [np.unique(r[r > 0]) - 1 for r in seq_rows]
        width = max(1, max(len(s) for s in seen))
        excl = np.full((len(seen), width), -1, np.int32)
        for b, s in enumerate(seen):
            excl[b, :len(s)] = s
        return self.index.search(last, k, excl)
