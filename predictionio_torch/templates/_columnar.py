"""Shared columnar-read glue for interaction-based templates.

Copy of ``predictionio_tpu/templates/_columnar.py`` for one host: a
dict-encoded bulk scan of (entity -> target) events, rows without a
target dropped, codes kept consistent with the vocabularies."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from predictionio_torch.data import store


@dataclass
class InteractionColumns:
    """Kept (entity, target) interaction rows as dense codes + vocabs."""

    entity_vocab: List[str]
    target_vocab: List[str]
    entity_idx: np.ndarray    # int32 into entity_vocab, [n]
    target_idx: np.ndarray    # int32 into target_vocab, [n]
    values: np.ndarray        # float64, NaN = no value property, [n]
    times: np.ndarray         # float64 epoch seconds, [n]
    name_codes: np.ndarray    # int32 into names, [n]
    names: List[str]


def read_interactions(app_name: str, channel_name: Optional[str],
                      entity_type: str, event_names: Sequence[str],
                      target_entity_type: str,
                      value_property: Optional[str] = None,
                      time_ordered: bool = False) -> InteractionColumns:
    """Bulk dict-encoded read of interaction events; rows without a
    target id are dropped."""
    cols = store.find_columnar(
        app_name, channel_name=channel_name, value_property=value_property,
        time_ordered=time_ordered, entity_type=entity_type,
        event_names=list(event_names), target_entity_type=target_entity_type)
    keep = cols.target_codes >= 0
    return InteractionColumns(
        entity_vocab=cols.entity_vocab,
        target_vocab=cols.target_vocab,
        entity_idx=cols.entity_codes[keep],
        target_idx=cols.target_codes[keep],
        values=cols.values[keep],
        times=cols.times_us[keep].astype(np.float64) / 1e6,
        name_codes=cols.name_codes[keep],
        names=cols.names,
    )
