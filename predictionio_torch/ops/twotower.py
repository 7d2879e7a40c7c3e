"""Two-tower neural retrieval trained with in-batch softmax.

Counterpart of ``predictionio_tpu/ops/twotower.py``: a user tower and an
item tower (id embedding -> optional MLP -> L2-normalized vector)
trained on positive (user, item) events with a symmetric in-batch
sampled-softmax loss. The loop has the JAX package's shape:

  - ROW-SPARSE table updates: tables are raw tensors, the gathered rows
    enter the loss directly, and the update is rowwise Adagrad (one
    accumulator per row, duplicate-safe), in place; dense MLP params
    (when ``hidden``/``embed_dim`` add any) keep AdamW.
  - the positives live on the device; each epoch walks a permutation
    in full batches, the tail padded with a zero-weight row.
  - matmuls in ``compute_dtype`` with f32 sums; the L2 norm, the
    softmax CE and all optimizer state stay f32.

Kernels (``ops/kernels``): on a CUDA device the loss runs through the
``flash_ce`` kernels wherever they are eligible (``1/temp <= 70``,
batch >= 128) and the table update through ``embed_update``, whatever
the flags say. The flags (``flash_ce_kernel`` / ``embed_update_kernel``,
env ``PIO_TT_FLASH_CE`` / ``PIO_TT_EMBED_UPDATE``) are still read, so
JAX engine.json files and blobs load, and choose on the CPU only: for
the loss, ``on`` runs the kernels' plain version, ``auto``/``off`` the
blockwise or dense form, as the JAX package does on a non-TPU backend.
The table update is one function everywhere (``embed_update``'s plain
version on a CPU tensor is the torch form), so its flag only shows in
``kernel_plan``. An ineligible loss takes the blockwise or dense form on
any device. There is no probe and no fallback: a kernel that cannot run
raises.

The streaming lane's ``online_delta_step`` takes a few SGD steps of the
dense in-batch CE on a delta of pairs, for the touched rows of the
serving tables only.

Mid-training checkpoints (``checkpoint_dir``, ``checkpoint_every``;
``core/checkpoint.py``): the trainer restores the newest checkpoint of
its run at construction and saves after each due epoch — the tables,
the Adagrad accumulators, the dense weights, the AdamW state dict, the
losses and the state of the generator that draws each epoch's order,
so a resumed run trains its remaining epochs on the same orders as an
uninterrupted one. That state belongs to a generator on the trainer's
device type: a checkpoint written on a card restores on a card, and a
trainer on the other device type raises rather than resume on other
orders.

The trainer carries the JAX trainer's observability hooks (step
timing and the watchdog beat, the MFU accounting, the kernel plan and
the memory ledger). Not in this port yet: meshes and sharded tables
(ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_torch.core.checkpoint import (TrainCheckpointer,
                                                train_fingerprint)
from predictionio_torch.obs import memacct, perfacct, torchmon
from predictionio_torch.ops.kernels import resolve_flag
from predictionio_torch.ops.kernels import embed_update as _embed
from predictionio_torch.ops.kernels import flash_ce as _flash
from predictionio_torch.ops.kernels.flash_ce import (DIRECT_EXP_MAX_INV_TEMP,
                                                     blockwise_softmax_ce)
from predictionio_torch.parallel.context import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    """The JAX package's config, field for field."""

    dim: int = 64                      # final embedding dimension
    hidden: Tuple[int, ...] = ()       # MLP widths on top of the id embedding
    embed_dim: Optional[int] = None    # id-embedding width (default: dim)
    temperature: float = 0.07
    learning_rate: float = 3e-3        # dense (AdamW) learning rate
    weight_decay: float = 1e-6         # dense AdamW weight decay
    table_learning_rate: Optional[float] = None  # rowwise-Adagrad lr of the
                                                 # tables (default: 10x
                                                 # learning_rate)
    epochs: int = 5
    batch_size: int = 1024
    seed: int = 11
    compute_dtype: str = "bfloat16"    # tower matmul input dtype (f32 sums)
    loss_chunk: Optional[int] = 2048   # blockwise CE column tile; engages
                                       # when batch >= 2*chunk (None: dense)
    shard_embeddings: bool = False     # not ported (ROADMAP queue 1 item 12)
    checkpoint_dir: Optional[str] = None  # mid-training checkpoint/resume
    checkpoint_every: int = 1             # epochs between checkpoints
    flash_ce_kernel: str = "auto"      # CPU only: "on" = the kernel's plain
                                       # version; env PIO_TT_FLASH_CE
    embed_update_kernel: str = "off"   # CPU only, as above; env
                                       # PIO_TT_EMBED_UPDATE


@dataclasses.dataclass
class TwoTowerEmbeddings:
    user_vecs: np.ndarray    # [n_users, dim] float32, L2-normalized
    item_vecs: np.ndarray    # [n_items, dim] float32, L2-normalized
    losses: List[float]      # per-epoch mean loss


@dataclasses.dataclass
class TwoTowerState:
    """A trainer's whole state: the id tables and their Adagrad
    accumulators per side, the tail MLPs (``[{"w", "b"}, ...]`` per
    side) and their AdamW moments and step count."""

    tables: Dict[str, torch.Tensor]
    acc: Dict[str, torch.Tensor]
    dense: Dict[str, List[Dict[str, torch.Tensor]]]
    adam_mu: Optional[Dict[str, List[Dict[str, torch.Tensor]]]] = None
    adam_nu: Optional[Dict[str, List[Dict[str, torch.Tensor]]]] = None
    adam_count: int = 0     # AdamW steps taken; 0: fresh moments


SIDES = ("user", "item")

def compute_dtype(cfg: TwoTowerConfig) -> torch.dtype:
    names = {"bfloat16": torch.bfloat16, "float32": torch.float32}
    if cfg.compute_dtype not in names:
        raise ValueError(f"compute_dtype {cfg.compute_dtype!r}: one of "
                         f"{sorted(names)}")
    return names[cfg.compute_dtype]


def tail_widths(cfg: TwoTowerConfig) -> List[int]:
    width = cfg.embed_dim or cfg.dim
    widths = [width, *cfg.hidden]
    if cfg.hidden or width != cfg.dim:
        widths.append(cfg.dim)
    return widths


def _init_dense(gen: torch.Generator, widths: Sequence[int],
                device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """He-init MLP params for one tower's tail (``[]`` when the tail is
    pure normalization)."""
    return [{"w": torch.randn((w_in, w_out), generator=gen, device=device)
                  * math.sqrt(2.0 / w_in),
             "b": torch.zeros(w_out, device=device)}
            for w_in, w_out in zip(widths[:-1], widths[1:])]


def apply_tail(dense: List[Dict[str, torch.Tensor]], x: torch.Tensor,
               cdt: torch.dtype) -> torch.Tensor:
    """Gathered embedding rows -> L2-normalized tower output: matmuls of
    ``cdt`` inputs with f32 sums, the norm in f32."""
    h = x
    for li, layer in enumerate(dense):
        h = h.to(cdt).float() @ layer["w"].to(cdt).float() + layer["b"]
        if li < len(dense) - 1:
            h = torch.relu(h)
    h = h.float()
    return h / torch.clamp(torch.linalg.norm(h, dim=-1, keepdim=True),
                           min=1e-8)


def dense_softmax_ce(u, v, u_idx, i_idx, weight, temp, cdt) -> torch.Tensor:
    """Reference dense form: the whole ``[B, B]`` logits (f32 sums of
    ``cdt`` products, then the f32 divide) with in-batch false negatives
    (the same item user->item, the same user item->user, and
    zero-weight padding columns) masked to -1e9."""
    logits = (u.to(cdt).float() @ v.to(cdt).float().T) / temp
    B = logits.shape[0]
    eye = torch.eye(B, dtype=torch.bool, device=logits.device)
    pad_col = (weight <= 0.0)[None, :]
    dup_i = ((i_idx[None, :] == i_idx[:, None]) | pad_col) & ~eye
    dup_u = ((u_idx[None, :] == u_idx[:, None]) | pad_col) & ~eye
    labels = torch.arange(B, device=logits.device)
    neg = torch.tensor(-1e9, device=logits.device)
    l_ui = torch.nn.functional.cross_entropy(
        torch.where(dup_i, neg, logits), labels, reduction="none")
    l_iu = torch.nn.functional.cross_entropy(
        torch.where(dup_u, neg, logits.T), labels, reduction="none")
    wsum = torch.clamp(weight.sum(), min=1e-8)
    return torch.sum(0.5 * (l_ui + l_iu) * weight) / wsum


def twotower_state_from_jax(tables, acc, dense, adam_mu, adam_nu,
                            adam_count, device: DeviceLike = None
                            ) -> TwoTowerState:
    """The JAX trainer's state (``TwoTowerTrainer._state`` there: the
    tables, accumulators and tail MLPs, and optax ``adamw``'s first and
    second moments and step count), as numpy arrays in the same nesting,
    -> a :class:`TwoTowerState` on ``device``. Handing it to
    :class:`TwoTowerTrainer` starts the port from the JAX trainer's
    point.

    Dense AdamW becomes ``torch.optim.AdamW(lr, weight_decay)``: optax's
    ``adamw`` (b1 0.9, b2 0.999, eps 1e-8 outside the root, decoupled
    decay ``-lr * wd * p``, bias-corrected moments) and torch's default
    AdamW compute the same update."""
    device = resolve_device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def layers(tree):
        return {side: [{"w": t(layer["w"]), "b": t(layer["b"])}
                       for layer in tree[side]] for side in SIDES}

    return TwoTowerState(
        tables={side: t(tables[side]) for side in SIDES},
        acc={side: t(acc[side]) for side in SIDES},
        dense=layers(dense), adam_mu=layers(adam_mu),
        adam_nu=layers(adam_nu), adam_count=int(np.asarray(adam_count)))


def plan_kernels(cfg: TwoTowerConfig, batch: int,
                 device: torch.device) -> dict:
    """Which form computes a trainer's loss and table update, with the
    reasons (the JAX package's ``_plan_kernels`` without its probe). On
    a CUDA device each kernel serves wherever it is eligible and the
    flags are not consulted; on the CPU ``on`` selects a kernel's plain
    version (the JAX package's interpret mode), ``auto``/``off`` the
    torch forms. The table update's plain version is its torch form, so
    on the CPU its entry reports the flag and changes no arithmetic."""
    on_card = device.type == "cuda"
    direct = (1.0 / cfg.temperature) <= DIRECT_EXP_MAX_INV_TEMP
    eligible = direct and batch >= _flash.MIN_BATCH
    why_not = ("1/temp outside the direct-exp regime" if not direct
               else f"batch {batch} < {_flash.MIN_BATCH}")

    def decide(flag: str, env: str, ok: bool, why: str):
        if not ok:
            return False, why
        if on_card:
            return True, "cuda device: the kernel always serves"
        value = resolve_flag(flag, env)
        if value == "on":
            return True, "forced on (the kernel's plain version on the CPU)"
        if value == "off":
            return False, "disabled by flag"
        return False, ("auto runs the torch form on the CPU (set the flag "
                       "to 'on' for the kernel's plain version)")

    plan = {"device": str(device)}
    plan["flash_ce"], plan["flash_ce_reason"] = decide(
        cfg.flash_ce_kernel, "PIO_TT_FLASH_CE", eligible, why_not)
    plan["embed_update"], plan["embed_update_reason"] = decide(
        cfg.embed_update_kernel, "PIO_TT_EMBED_UPDATE", True, "")
    return plan


def _tensor_bytes(tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors))


class TwoTowerTrainer:
    """Prepared training run over positive (user, item, weight) triples:
    state and kernel plan in the constructor, :meth:`run` drives the
    epochs, :meth:`embeddings` materializes the serving tables."""

    def __init__(self, positives: Tuple[np.ndarray, np.ndarray,
                                        Optional[np.ndarray]],
                 n_users: int, n_items: int, cfg: TwoTowerConfig,
                 device: DeviceLike = None,
                 state: Optional[TwoTowerState] = None):
        if cfg.shard_embeddings:
            raise NotImplementedError(
                "shard_embeddings: sharded tables and meshes are not "
                "ported to predictionio_torch yet (ROADMAP.md, queue 1 "
                "item 12)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cdt = compute_dtype(cfg)
        self.n_users, self.n_items = int(n_users), int(n_items)
        u_idx, i_idx, w = positives
        u = np.asarray(u_idx, np.int64)
        i = np.asarray(i_idx, np.int64)
        w = (np.ones(len(u), np.float32) if w is None
             else np.asarray(w, np.float32))
        self.n_pos = len(u)
        self.batch = cfg.batch_size
        self.steps_per_epoch = max(1, -(-self.n_pos // self.batch))
        # the positives live on the device; index n_pos is the padding
        # row (weight 0) that fills the last batch of an epoch
        dev = self.device
        self._u = torch.tensor(np.append(u, 0), device=dev)
        self._i = torch.tensor(np.append(i, 0), device=dev)
        self._w = torch.tensor(np.append(w, np.float32(0)), device=dev)
        self.table_lr = (cfg.table_learning_rate
                         if cfg.table_learning_rate is not None
                         else 10.0 * cfg.learning_rate)
        self.kernel_plan = plan_kernels(cfg, self.batch, self.device)
        torchmon.record_kernel_plan(self.kernel_plan)
        self._perm_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self._set_state(state if state is not None else self._init_state())
        self._epochs_done = 0
        self._losses: List[float] = []
        # device-memory ledger (obs/memacct.py): the run's residents —
        # tables and tails as params, adagrad accumulators and AdamW
        # state as opt_state, the positives as train_data — priced once,
        # swept when the trainer is dropped
        self._param_bytes = _tensor_bytes(
            list(self.tables.values()) + self._dense_params())
        self._opt_bytes = _tensor_bytes(
            list(self.acc.values()) + [
                t for st in (self._opt.state.values() if self._opt else ())
                for t in st.values() if isinstance(t, torch.Tensor)])
        self._data_bytes = _tensor_bytes([self._u, self._i, self._w])
        memacct.LEDGER.register(self, "twotower", "params",
                                self._param_bytes)
        memacct.LEDGER.register(self, "twotower", "opt_state",
                                self._opt_bytes)
        memacct.LEDGER.register(self, "twotower", "train_data",
                                self._data_bytes)
        #: MFU accounting (obs/perfacct.py): one epoch is the timed unit
        self._acct = perfacct.StepAccountant(
            "twotower", self.matmul_flops_per_step(), device=self.device)
        #: host wall time of each epoch run, ending when its mean loss
        #: reached the host (the JAX package's train-step observation)
        self.epoch_seconds: List[float] = []
        #: seconds spent writing checkpoints, and restoring one here
        self.checkpoint_seconds: List[float] = []
        self.restore_seconds = 0.0
        self._ckpt = None
        if cfg.checkpoint_dir:
            t0 = time.perf_counter()
            # the JAX trainer's parts, plus the package: a directory the
            # JAX trainer wrote is another run here
            fp = train_fingerprint(cfg, n_users, n_items, self.n_pos,
                                   u[:4096], u[-4096:], i[:4096], w[:4096],
                                   "predictionio_torch")
            self._ckpt = TrainCheckpointer(cfg.checkpoint_dir,
                                           every=cfg.checkpoint_every,
                                           fingerprint=fp)
            restored = self._ckpt.restore()
            if restored is not None:
                self._restore(*restored)
                self.restore_seconds = time.perf_counter() - t0

    # -- state ---------------------------------------------------------------

    def _init_state(self) -> TwoTowerState:
        """Tables ~ N(0, 1/width), He-init tails, zero optimizer state,
        from a generator seeded with ``cfg.seed`` (another stream than
        ``jax.random``'s: to start from the JAX trainer's point, pass
        :func:`twotower_state_from_jax`'s state)."""
        cfg, dev = self.cfg, self.device
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
        width = cfg.embed_dim or cfg.dim
        scale = 1.0 / math.sqrt(width)
        tables = {"user": torch.randn((self.n_users, width), generator=gen,
                                      device=dev) * scale,
                  "item": torch.randn((self.n_items, width), generator=gen,
                                      device=dev) * scale}
        return TwoTowerState(
            tables=tables,
            acc={side: torch.zeros(len(tables[side]), device=dev)
                 for side in SIDES},
            dense={side: _init_dense(gen, tail_widths(cfg), dev)
                   for side in SIDES})

    def _set_state(self, state: TwoTowerState) -> None:
        self.tables = {side: state.tables[side].to(self.device).contiguous()
                       for side in SIDES}
        self.acc = {side: state.acc[side].to(self.device).contiguous()
                    for side in SIDES}
        self.dense = {side: [{k: a.to(self.device).clone().requires_grad_(True)
                              for k, a in layer.items()}
                             for layer in state.dense[side]]
                      for side in SIDES}
        params = self._dense_params()
        self._opt = (torch.optim.AdamW(params, lr=self.cfg.learning_rate,
                                       weight_decay=self.cfg.weight_decay)
                     if params else None)
        if self._opt is not None and state.adam_count:
            for side in SIDES:
                for layer, mu, nu in zip(self.dense[side],
                                         state.adam_mu[side],
                                         state.adam_nu[side]):
                    for k, p in layer.items():
                        self._opt.state[p] = {
                            "step": torch.tensor(float(state.adam_count)),
                            "exp_avg": mu[k].to(self.device).clone(),
                            "exp_avg_sq": nu[k].to(self.device).clone()}

    def _checkpoint_state(self) -> dict:
        """What a checkpoint holds (``core/checkpoint.py`` copies the
        tensors to the host)."""
        return {"tables": self.tables, "acc": self.acc,
                "dense": self.dense,
                "opt": (self._opt.state_dict() if self._opt is not None
                        else None),
                "perm_gen": self._perm_gen.get_state(),
                "perm_gen_device": self.device.type,
                "losses": list(self._losses)}

    def _restore(self, epoch: int, state: dict) -> None:
        if state["perm_gen_device"] != self.device.type:
            raise ValueError(
                f"checkpoint in {self.cfg.checkpoint_dir!r} was written by "
                f"a trainer on {state['perm_gen_device']}: its epoch-order "
                f"generator state does not restore on {self.device.type} "
                "(resume on the same device type, or use another "
                "checkpoint_dir)")

        def t(a):
            return torch.from_numpy(np.asarray(a)).to(self.device)

        self.tables = {side: t(state["tables"][side]).contiguous()
                       for side in SIDES}
        self.acc = {side: t(state["acc"][side]).contiguous()
                    for side in SIDES}
        self.dense = {side: [{k: t(a).requires_grad_(True)
                              for k, a in layer.items()}
                             for layer in state["dense"][side]]
                      for side in SIDES}
        params = self._dense_params()
        self._opt = (torch.optim.AdamW(params, lr=self.cfg.learning_rate,
                                       weight_decay=self.cfg.weight_decay)
                     if params else None)
        if self._opt is not None:
            opt = state["opt"]
            self._opt.load_state_dict({
                "state": {k: {name: torch.from_numpy(np.asarray(v))
                              for name, v in st.items()}
                          for k, st in opt["state"].items()},
                "param_groups": opt["param_groups"]})
        self._perm_gen.set_state(
            torch.from_numpy(np.asarray(state["perm_gen"])))
        self._epochs_done = int(epoch)
        self._losses = list(state["losses"])

    def _dense_params(self) -> List[torch.Tensor]:
        return [p for side in SIDES for layer in self.dense[side]
                for p in layer.values()]

    # -- the step ------------------------------------------------------------

    def _loss_from_rows(self, ue, ve, u_idx, i_idx, weight) -> torch.Tensor:
        cfg = self.cfg
        u = apply_tail(self.dense["user"], ue, self.cdt)   # [B, D] f32 unit
        v = apply_tail(self.dense["item"], ve, self.cdt)
        if self.kernel_plan["flash_ce"]:
            return _flash.flash_ce(u, v, u_idx, i_idx, weight,
                                   cfg.temperature, self.cdt)
        chunk = cfg.loss_chunk
        B = u.shape[0]
        if chunk and B >= 2 * chunk and B % chunk == 0:
            return blockwise_softmax_ce(u, v, u_idx, i_idx, weight,
                                        cfg.temperature, chunk, self.cdt)
        return dense_softmax_ce(u, v, u_idx, i_idx, weight, cfg.temperature,
                                self.cdt)

    def _step(self, rows: torch.Tensor) -> torch.Tensor:
        u_idx, i_idx, w = self._u[rows], self._i[rows], self._w[rows]
        ue = self.tables["user"][u_idx].requires_grad_(True)   # [B, E]
        ve = self.tables["item"][i_idx].requires_grad_(True)
        loss = self._loss_from_rows(ue, ve, u_idx, i_idx, w)
        loss.backward()
        with torch.no_grad():
            for side, idx, grad in (("user", u_idx, ue.grad),
                                    ("item", i_idx, ve.grad)):
                _embed.rowwise_adagrad(self.tables[side], self.acc[side],
                                       idx, grad, self.table_lr)
        if self._opt is not None:
            self._opt.step()
            self._opt.zero_grad(set_to_none=True)
        return loss.detach()

    def epoch_order(self, perm=None) -> torch.Tensor:
        """``[steps, batch]`` rows of one epoch: ``perm`` (a permutation
        of ``n_pos``; by default ``torch.randperm`` on the trainer's
        generator, seeded ``cfg.seed + 1``) padded with the zero-weight
        row ``n_pos`` to whole batches."""
        n, S, B = self.n_pos, self.steps_per_epoch, self.batch
        if perm is None:
            perm = torch.randperm(n, generator=self._perm_gen,
                                  device=self.device)
        if not isinstance(perm, torch.Tensor):
            perm = torch.from_numpy(np.array(perm, np.int64))
        perm = perm.to(self.device, torch.long)
        if perm.shape != (n,):
            raise ValueError(f"epoch order must permute {n} positives, "
                             f"got shape {tuple(perm.shape)}")
        pad = torch.full((S * B - n,), n, dtype=torch.long,
                         device=self.device)
        return torch.cat([perm, pad]).reshape(S, B)

    def run(self, epochs: Optional[int] = None,
            perms: Optional[Sequence] = None) -> List[float]:
        """Train up to ``epochs`` total epochs (default ``cfg.epochs``);
        returns the per-epoch mean losses so far. ``perms[e]``, when
        given, is epoch ``e``'s order (a permutation of ``n_pos``; the
        JAX trainer's orders can be passed in, since torch cannot
        reproduce ``jax.random``)."""
        target = epochs if epochs is not None else self.cfg.epochs
        while self._epochs_done < target:
            e = self._epochs_done
            t0 = time.perf_counter()
            order = self.epoch_order(None if perms is None else perms[e])
            losses = torch.stack([self._step(rows) for rows in order])
            self._losses.append(float(losses.mean()))   # waits for the epoch
            self.epoch_seconds.append(time.perf_counter() - t0)
            # per-epoch wall time onto pio_train_step_seconds (beats the
            # train-step watchdog) and the MFU gauge over the epoch's
            # steps; the peak is the JAX trainer's analytic floor
            torchmon.observe_train_step(self.epoch_seconds[-1])
            self._acct.observe(self.epoch_seconds[-1],
                               steps=self.steps_per_epoch)
            memacct.note_train_peak(
                "twotower", 2 * self._param_bytes + self._opt_bytes
                + self._data_bytes, source="analytic")
            self._epochs_done += 1
            if self._ckpt is not None:
                t0 = time.perf_counter()
                if self._ckpt.maybe_save(self._epochs_done,
                                         self._checkpoint_state()):
                    self.checkpoint_seconds.append(time.perf_counter() - t0)
        return list(self._losses)

    # -- serving tables ------------------------------------------------------

    @torch.no_grad()
    def _all_vecs(self, side: str) -> np.ndarray:
        table = self.tables[side]
        out = np.empty((len(table), self.cfg.dim), np.float32)
        chunk = 8192
        for s in range(0, len(table), chunk):
            out[s:s + chunk] = apply_tail(self.dense[side],
                                          table[s:s + chunk],
                                          self.cdt).cpu().numpy()
        return out

    def embeddings(self, losses: Optional[List[float]] = None
                   ) -> TwoTowerEmbeddings:
        return TwoTowerEmbeddings(user_vecs=self._all_vecs("user"),
                                  item_vecs=self._all_vecs("item"),
                                  losses=losses or [])

    def matmul_flops_per_step(self) -> float:
        """Matmul FLOPs of one training step (forward and backward): the
        ``[B, B]`` logits and their two rank-D gradient products, plus
        the tail MLPs (``obs.perfacct.twotower_matmul_flops``, the one
        copy of the formula)."""
        return perfacct.twotower_matmul_flops(self.batch, self.cfg.dim,
                                              tail_widths(self.cfg))


def twotower_train(positives, n_users: int, n_items: int,
                   cfg: TwoTowerConfig, device: DeviceLike = None
                   ) -> TwoTowerEmbeddings:
    """One-call train from positive (user_idx, item_idx, weight?) triples."""
    trainer = TwoTowerTrainer(positives, n_users, n_items, cfg, device=device)
    return trainer.embeddings(trainer.run())


def online_delta_step(
    user_vecs: np.ndarray,
    item_vecs: np.ndarray,
    u_rows: np.ndarray,
    i_rows: np.ndarray,
    weight: Optional[np.ndarray] = None,
    lr: float = 0.05,
    steps: int = 4,
    temp: float = 0.05,
    device: DeviceLike = None,
):
    """``steps`` SGD steps of the in-batch softmax CE over the delta
    pairs ``(u_rows[p], i_rows[p])`` on ``device`` (the card unless the
    caller asks for the CPU), updating ONLY the touched rows of the
    serving embedding tables.

    A served two-tower model carries only its final L2-normalized
    vectors, so the touched rows are free embeddings: each step
    descends the dense CE (``dense_softmax_ce`` in f32, as the JAX
    package's ``_dense_softmax_ce``; its ``[P, P]`` logits bound the
    delta's size) and renormalizes the rows onto the serving sphere.
    Each step's loss is taken before its update.

    Returns ``(touched_u_rows, new_u_vecs, touched_i_rows, new_i_vecs,
    losses)``: the unique touched row indices and their updated vectors,
    directly a model patch. The JAX package pads the delta to pow2
    buckets for its compile cache; zero-weight padding adds nothing to
    the loss, so the port runs the delta as it is."""
    u_rows = np.asarray(u_rows, np.int32)
    i_rows = np.asarray(i_rows, np.int32)
    d = user_vecs.shape[1]
    if len(u_rows) == 0:
        return (np.zeros(0, np.int32), np.zeros((0, d), np.float32),
                np.zeros(0, np.int32), np.zeros((0, d), np.float32), [])
    device = resolve_device(device)
    uu, pos_u = np.unique(u_rows, return_inverse=True)
    ii, pos_i = np.unique(i_rows, return_inverse=True)

    def put(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    U = put(np.asarray(user_vecs, np.float32)[uu], torch.float32)
    V = put(np.asarray(item_vecs, np.float32)[ii], torch.float32)
    pu, pi = put(pos_u, torch.int64), put(pos_i, torch.int64)
    w = put(np.ones(len(u_rows), np.float32) if weight is None
            else np.asarray(weight, np.float32), torch.float32)

    def renorm(t):
        return t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True),
                               min=1e-8)

    losses = []
    for _ in range(int(steps)):
        U = U.detach().requires_grad_(True)
        V = V.detach().requires_grad_(True)
        loss = dense_softmax_ce(U[pu], V[pi], pu, pi, w, temp, torch.float32)
        gU, gV = torch.autograd.grad(loss, (U, V))
        losses.append(loss.detach())
        with torch.no_grad():
            U, V = renorm(U - lr * gU), renorm(V - lr * gV)
    return (uu.astype(np.int32), U.detach().cpu().numpy(),
            ii.astype(np.int32), V.detach().cpu().numpy(),
            [float(x) for x in torch.stack(losses).cpu()] if losses else [])
