"""Two-tower neural retrieval as a DASE Algorithm.

Counterpart of ``predictionio_tpu/models/twotower.py``: the deep-model
sibling of ``models/als.py`` with the same prepared data
(``PreparedRatings``), the same model container and the same query
surface (top-``num`` itemScores, ``{"item": ...}`` for similar items),
so the recommendation engine can swap ``"als"`` for ``"twotower"`` — or
run both and let Serving combine them. Compute: ``ops/twotower.py`` on
the context's device (the ``flash_ce`` and ``embed_update`` kernels on
a card).

Scores are cosine similarities (the towers L2-normalize), so averaging
with ALS dot products needs score-scale awareness — the caveat the
reference leaves to user Serving code. A JAX-trained two-tower blob
unpickles into :class:`TwoTowerModel` through the deploy loader's
module remap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from predictionio_torch.core import Algorithm
from predictionio_torch.core.params import Params
from predictionio_torch.models.als import (ALSAlgorithm, ALSModel,
                                           PreparedRatings)
from predictionio_torch.ops.twotower import TwoTowerConfig, TwoTowerTrainer
from predictionio_torch.parallel.context import DeviceContext


@dataclass
class TwoTowerParams(Params):
    """The JAX package's params, field for field (an engine instance
    stores all of them and deploy rebuilds them by name)."""

    dim: int = 64
    embed_dim: Optional[int] = None   # id-embedding width (default: dim)
    hidden: Tuple[int, ...] = ()
    temperature: float = 0.07
    learning_rate: float = 3e-3
    weight_decay: float = 1e-6
    epochs: int = 5
    batch_size: int = 1024
    seed: int = 11
    min_rating: float = 0.0       # keep events with rating >= this as positives
    weight_by_rating: bool = False
    shard_embeddings: bool = False
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1
    # kernel flags, read on the CPU only (on a card the kernels serve):
    # "on" = the kernel's plain version; env PIO_TT_FLASH_CE /
    # PIO_TT_EMBED_UPDATE override
    flash_ce_kernel: str = "auto"
    embed_update_kernel: str = "off"
    index_backend: str = "auto"   # retrieval index (PIO_INDEX_BACKEND)
    index_kernel: str = "auto"    # topk_dot flag (PIO_INDEX_KERNEL)


class TwoTowerModel(ALSModel):
    """The ALS container: (user_vecs, item_vecs, id maps) with the same
    scorer and retrieval index; the vectors are L2-normalized, so
    scores are cosine similarities."""

    #: device-memory ledger attribution (obs/memacct.py)
    memacct_model = "twotower"


class TwoTowerAlgorithm(Algorithm):
    """DASE wrapper over ``ops.twotower``."""

    def __init__(self, params: TwoTowerParams):
        super().__init__(params)

    def train(self, ctx: DeviceContext, pd: PreparedRatings) -> TwoTowerModel:
        p: TwoTowerParams = self.params
        if pd.binned_request is not None:
            # the binned lane's deferred read is shaped for ALS's layout;
            # this trainer takes host COO, read through the columnar path
            # (the same rows, codes and values)
            pd = pd.binned_request.read_prepared(pd.fingerprint)
        keep = pd.ratings >= p.min_rating
        u, i, r = pd.user_idx[keep], pd.item_idx[keep], pd.ratings[keep]
        if len(u) == 0:
            raise ValueError(f"no events with rating >= {p.min_rating} — "
                             "nothing to train on")
        cfg = TwoTowerConfig(
            dim=p.dim, embed_dim=p.embed_dim, hidden=tuple(p.hidden),
            temperature=p.temperature, learning_rate=p.learning_rate,
            weight_decay=p.weight_decay, epochs=p.epochs,
            batch_size=p.batch_size, seed=p.seed,
            shard_embeddings=p.shard_embeddings,
            checkpoint_dir=p.checkpoint_dir,
            checkpoint_every=p.checkpoint_every,
            flash_ce_kernel=p.flash_ce_kernel,
            embed_update_kernel=p.embed_update_kernel)
        trainer = TwoTowerTrainer(
            (u, i, r if p.weight_by_rating else None), pd.n_users,
            pd.n_items, cfg, device=ctx.device)
        losses = trainer.run()
        emb = trainer.embeddings(losses)
        model = TwoTowerModel(emb.user_vecs, emb.item_vecs, pd.user_ids,
                              pd.item_ids, index_backend=p.index_backend,
                              index_kernel=p.index_kernel)
        model.train_losses = emb.losses
        model.train_epoch_seconds = list(trainer.epoch_seconds)
        model.kernel_plan = dict(trainer.kernel_plan)
        return model

    # the same model and query surface: share ALS's serve and batched
    # paths, its deploy-time placement and warm-up, and the patch lane
    predict = ALSAlgorithm.predict
    batch_predict = ALSAlgorithm.batch_predict
    load_persistent_model = ALSAlgorithm.load_persistent_model
    warmup = ALSAlgorithm.warmup
    apply_patch = ALSAlgorithm.apply_patch
