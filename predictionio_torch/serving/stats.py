"""Per-app operational counters with hourly cutoff.

Copy of ``predictionio_tpu/serving/stats.py``: the port imports nothing
of the JAX package.

Behavior contract from the reference (data/.../api/Stats.scala:48 +
StatsActor.scala:33): the event server keeps in-memory counts of
(status-code, event name, entity type) per appId, bucketed by hour;
``/stats.json`` reports the previous + current hour. The reference
routes bookkeeping through an Akka actor; here a lock suffices.
"""

from __future__ import annotations

import datetime as _dt
import threading
from collections import defaultdict
from typing import Dict, Optional, Tuple

UTC = _dt.timezone.utc


def _hour_bucket(t: Optional[_dt.datetime] = None) -> _dt.datetime:
    t = t or _dt.datetime.now(tz=UTC)
    return t.replace(minute=0, second=0, microsecond=0)


class Stats:
    """ref: Stats.scala:48."""

    def __init__(self):
        self._lock = threading.Lock()
        # hour -> app_id -> (status, event, entity_type) -> count
        self._buckets: Dict[_dt.datetime, Dict[int, Dict[Tuple, int]]] = defaultdict(
            lambda: defaultdict(lambda: defaultdict(int))
        )
        self.start_time = _dt.datetime.now(tz=UTC)

    def _prune_locked(self) -> _dt.datetime:
        """Drop buckets older than the previous hour (hourly cutoff,
        ref: StatsActor bookkeeping); returns the cutoff. Caller holds
        the lock."""
        cutoff = _hour_bucket() - _dt.timedelta(hours=1)
        for old in [b for b in self._buckets if b < cutoff]:
            del self._buckets[old]
        return cutoff

    def update(self, app_id: int, status: int, event: str, entity_type: str) -> None:
        with self._lock:
            self._buckets[_hour_bucket()][int(app_id)][
                (status, event, entity_type)] += 1
            self._prune_locked()

    def report(self, app_id: int) -> dict:
        """Previous + current hour counts for one app (ref: /stats.json)."""
        with self._lock:
            # prune here too: update() only runs when events arrive, so
            # on a quiet app stale hours would otherwise sit in memory
            # (and one filter bug away from being reported) indefinitely
            cutoff = self._prune_locked()
            out = []
            for bucket in sorted(b for b in self._buckets if b >= cutoff):
                counts = self._buckets[bucket].get(int(app_id), {})
                if not counts:
                    continue
                out.append(
                    {
                        "hour": bucket.isoformat(),
                        "counts": [
                            {
                                "status": status,
                                "event": event,
                                "entityType": entity_type,
                                "count": count,
                            }
                            for (status, event, entity_type), count in sorted(counts.items())
                        ],
                    }
                )
            return {"appId": int(app_id), "startTime": self.start_time.isoformat(), "buckets": out}
