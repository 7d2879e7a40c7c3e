"""Shared helpers of the storage-tier parity tests: both packages'
modules by name, in-memory sources and storage servers of either
package, and ``rest`` client environments (one endpoint, or a sharded
and replicated set).

The two packages speak one wire, so a test can put a server of one
package behind a client of the other; ``PAIRS`` names the three pairs a
parity test runs against the JAX package's own server and client.
"""

from __future__ import annotations

import contextlib
import datetime as dt
import importlib
import types
from typing import Dict, List, Optional

import numpy as np

JAX, PORT = "predictionio_tpu", "predictionio_torch"
UTC = dt.timezone.utc

#: (server package, client package) of the runs held against JAX's own
PAIRS = ((PORT, PORT), (JAX, PORT), (PORT, JAX))
PAIR_IDS = ("port-port", "jax-server-port-client", "port-server-jax-client")


def pkg(name: str) -> types.SimpleNamespace:
    """The storage-tier modules of one package."""
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    ns = types.SimpleNamespace(
        name=name, storage=mod("data.storage"), event=mod("data.event"),
        metadata=mod("data.metadata"), rest=mod("data.backends.rest"),
        server=mod("serving.storage_server"), view=mod("data.view"),
        bimap=mod("data.bimap"), store=mod("data.store"),
        commands=mod("tools.commands"), cli=mod("tools.cli"))
    ns.Event = ns.event.Event
    ns.Storage = ns.storage.Storage
    return ns


def memory_storage(P):
    return P.Storage.from_env({"PIO_STORAGE_SOURCES_MEM_TYPE": "memory"})


def rest_env(ports, replicas: Optional[int] = None,
             auth_key: Optional[str] = None, retries: int = 0,
             timeout: float = 30.0) -> Dict[str, str]:
    """A ``rest`` source ``SH`` serving all three repositories."""
    env = {
        "PIO_STORAGE_SOURCES_SH_TYPE": "rest",
        "PIO_STORAGE_SOURCES_SH_HOSTS": "127.0.0.1",
        "PIO_STORAGE_SOURCES_SH_PORTS": ",".join(str(p) for p in ports),
        "PIO_STORAGE_SOURCES_SH_RETRIES": str(retries),
        "PIO_STORAGE_SOURCES_SH_TIMEOUT": str(timeout),
    }
    for repo in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_NAME"] = repo.lower()
        env[f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE"] = "SH"
    if replicas is not None:
        env["PIO_STORAGE_SOURCES_SH_REPLICAS"] = str(replicas)
    if auth_key is not None:
        env["PIO_STORAGE_SOURCES_SH_AUTH_KEY"] = auth_key
    return env


@contextlib.contextmanager
def servers(P, n: int = 1, backends=None, **kwargs):
    """``n`` storage servers of package ``P`` on 127.0.0.1, each over
    its own in-memory storage unless ``backends`` are given; yields
    (backends, servers). Every server is stopped on the way out."""
    backends = backends or [memory_storage(P) for _ in range(n)]
    started = []
    try:
        for b in backends:
            started.append(P.server.StorageServer(
                storage=b, host="127.0.0.1", port=0, **kwargs).start())
        yield backends, started
    finally:
        for s in started:
            with contextlib.suppress(Exception):
                s.stop()


def client(P, srvs, replicas: Optional[int] = None, **kwargs):
    return P.Storage.from_env(rest_env([s.port for s in srvs], replicas,
                                       **kwargs))


def rate_events(P, n: int = 60, users: int = 13, items: int = 7,
                seed: int = 0) -> List:
    """``n`` seeded ``rate`` events, one a minute: a random user of
    ``users`` gives a random item of ``items`` a rating of 1-5."""
    rng = np.random.default_rng(seed)
    t0 = dt.datetime(2026, 2, 1, tzinfo=UTC)
    return [P.Event(event="rate", entity_type="user",
                    entity_id=f"u{int(rng.integers(users))}",
                    target_entity_type="item",
                    target_entity_id=f"i{int(rng.integers(items))}",
                    properties={"rating": float(rng.integers(1, 6))},
                    event_time=t0 + dt.timedelta(minutes=j))
            for j in range(n)]


def event_key(e) -> tuple:
    """An event without its id and creation time."""
    return (e.event, e.entity_type, e.entity_id, e.target_entity_type,
            e.target_entity_id, tuple(sorted(e.properties.to_dict().items())),
            e.event_time.isoformat())


def column_rows(cols) -> List[tuple]:
    """Decoded rows of an ``EventColumns``, in its order."""
    return [(cols.entity_vocab[int(e)],
             cols.target_vocab[int(t)] if t >= 0 else None,
             cols.names[int(n)],
             None if np.isnan(v) else float(v), int(us))
            for e, t, n, v, us in zip(cols.entity_codes, cols.target_codes,
                                      cols.name_codes, cols.values,
                                      cols.times_us)]


def column_multiset(cols) -> List[tuple]:
    return sorted(column_rows(cols), key=repr)
