"""Shared command client for the CLI and the admin API.

Counterpart of ``predictionio_tpu/tools/commands.py``. Behavior
contracts from the reference console + admin
(tools/.../console/App.scala, AccessKey.scala,
admin/CommandClient.scala):

  - ``app new`` (App.scala:34-66): fail if the name exists, insert the
    App row, initialize its event store, create a default access key
    with an empty (= allow-all) event whitelist.
  - ``app delete`` (App.scala:129-180): delete the app's access keys,
    channel event stores + channels, the default event store, the app.
  - ``app data-delete`` (App.scala:215-380): wipe + re-init the event
    store of the default channel or one named channel.
  - ``channel new/delete`` (App.scala:383-498): channel row + its own
    event store.
  - ``accesskey new/list/delete`` (AccessKey.scala): key with per-key
    event whitelist.
  - ``storagerepair``: owner-authoritative replica repair of an app's
    events and of the metadata and model tier on a replicated ``rest``
    source.

Each function raises ``CommandError`` with the reference's message
shape on failure; callers (CLI / admin) map that to exit codes / HTTP.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from predictionio_torch.data.metadata import AccessKey, App, Channel
from predictionio_torch.data.storage import Storage, StorageError, get_storage
from predictionio_torch.data.store import resolve_app


class CommandError(RuntimeError):
    pass


def _storage(storage: Optional[Storage]) -> Storage:
    return storage or get_storage()


# -- apps --------------------------------------------------------------------

@dataclass
class AppInfo:
    app: App
    access_keys: List[AccessKey] = field(default_factory=list)
    channels: List[Channel] = field(default_factory=list)


def app_new(
    name: str,
    description: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> AppInfo:
    st = _storage(storage)
    if st.apps().get_by_name(name) is not None:
        raise CommandError(f"App {name} already exists. Aborting.")
    app = st.apps().insert(name, description)
    st.events().init(app.id)
    key = AccessKey.generate(app.id)
    st.access_keys().insert(key)
    return AppInfo(app=app, access_keys=[key])


def app_list(storage: Optional[Storage] = None) -> List[AppInfo]:
    st = _storage(storage)
    return [
        AppInfo(
            app=app,
            access_keys=st.access_keys().get_by_app_id(app.id),
            channels=st.channels().get_by_app_id(app.id),
        )
        for app in sorted(st.apps().get_all(), key=lambda a: a.name)
    ]


def app_show(name: str, storage: Optional[Storage] = None) -> AppInfo:
    st = _storage(storage)
    app = st.apps().get_by_name(name)
    if app is None:
        raise CommandError(f"App {name} does not exist. Aborting.")
    return AppInfo(
        app=app,
        access_keys=st.access_keys().get_by_app_id(app.id),
        channels=st.channels().get_by_app_id(app.id),
    )


def app_delete(name: str, storage: Optional[Storage] = None) -> None:
    st = _storage(storage)
    info = app_show(name, st)
    for ch in info.channels:
        st.events().remove(info.app.id, ch.id)
        st.channels().delete(ch.id)
    for key in info.access_keys:
        st.access_keys().delete(key.key)
    st.events().remove(info.app.id)
    st.apps().delete(info.app.id)


def app_data_delete(
    name: str,
    channel: Optional[str] = None,
    storage: Optional[Storage] = None,
) -> None:
    st = _storage(storage)
    info = app_show(name, st)
    if channel is None:
        st.events().remove(info.app.id)
        st.events().init(info.app.id)
        return
    ch = next((c for c in info.channels if c.name == channel), None)
    if ch is None:
        raise CommandError(f"Channel {channel} does not exist. Aborting.")
    st.events().remove(info.app.id, ch.id)
    st.events().init(info.app.id, ch.id)


def app_compact(
    name: str,
    channel: Optional[str] = None,
    storage: Optional[Storage] = None,
):
    """Physically reclaim deleted/superseded event space (eventlog
    backend; no-op None elsewhere). The pio-side entry for the HBase
    major-compaction role."""
    st = _storage(storage)
    info = app_show(name, st)
    channel_id = None
    if channel is not None:
        ch = next((c for c in info.channels if c.name == channel), None)
        if ch is None:
            raise CommandError(f"Channel {channel} does not exist. Aborting.")
        channel_id = ch.id
    return st.events().compact(info.app.id, channel_id)


# -- channels ----------------------------------------------------------------

def channel_new(
    app_name: str, channel_name: str, storage: Optional[Storage] = None
) -> Channel:
    st = _storage(storage)
    info = app_show(app_name, st)
    if any(c.name == channel_name for c in info.channels):
        raise CommandError(f"Channel {channel_name} already exists. Aborting.")
    ch = st.channels().insert(channel_name, info.app.id)
    st.events().init(info.app.id, ch.id)
    return ch


def channel_delete(
    app_name: str, channel_name: str, storage: Optional[Storage] = None
) -> None:
    st = _storage(storage)
    info = app_show(app_name, st)
    ch = next((c for c in info.channels if c.name == channel_name), None)
    if ch is None:
        raise CommandError(f"Channel {channel_name} does not exist. Aborting.")
    st.events().remove(info.app.id, ch.id)
    st.channels().delete(ch.id)


# -- access keys -------------------------------------------------------------

def accesskey_new(
    app_name: str,
    events: Optional[List[str]] = None,
    storage: Optional[Storage] = None,
) -> AccessKey:
    st = _storage(storage)
    info = app_show(app_name, st)
    key = AccessKey.generate(info.app.id, events)
    st.access_keys().insert(key)
    return key


def accesskey_list(
    app_name: Optional[str] = None, storage: Optional[Storage] = None
) -> List[AccessKey]:
    st = _storage(storage)
    if app_name is None:
        return st.access_keys().get_all()
    info = app_show(app_name, st)
    return st.access_keys().get_by_app_id(info.app.id)


def accesskey_delete(key: str, storage: Optional[Storage] = None) -> None:
    st = _storage(storage)
    if st.access_keys().get(key) is None:
        raise CommandError(f"Access key {key} does not exist. Aborting.")
    st.access_keys().delete(key)


# -- status ------------------------------------------------------------------

def status(storage: Optional[Storage] = None) -> Dict[str, bool]:
    """ref: `pio status` -> Storage.verifyAllDataObjects
    (Storage.scala:237)."""
    return _storage(storage).verify_all_data_objects()


def repair_events(app_name: str, channel_name: Optional[str] = None,
                  storage: Optional[Storage] = None) -> Dict[str, int]:
    """Owner-authoritative replica reconciliation of an app's events on
    a replicated sharded EVENTDATA source (`pio storagerepair`) — the
    anti-entropy role HBase inherits from HDFS. A backend with no
    replicas to check fails loudly (a silent zeros result would be
    indistinguishable from "checked and consistent"): CommandError when
    the source is not sharded rest at all, StorageError from repair()
    itself when it is sharded but unreplicated. Run only while writes
    to the app are quiesced (see ShardedRestEventStore.repair)."""
    st = _storage(storage)
    app_id, channel_id = resolve_app(app_name, channel_name, st)
    events = st.events()
    repair = getattr(events, "repair", None)
    if repair is None:
        raise CommandError(
            "EVENTDATA is not a sharded rest source — nothing to repair "
            "(configure comma-separated HOSTS/PORTS with REPLICAS>1)"
        )
    # an unreplicated sharded store raises StorageError from repair()
    # itself (the loud-failure guard lives with the operation)
    return repair(app_id, channel_id)


def repair_metadata(storage: Optional[Storage] = None) -> Dict[str, int]:
    """Owner-authoritative reconciliation of replicated METADATA and
    MODELDATA (`pio storagerepair`) — the tier-availability counterpart
    of repair_events (ES replica re-sync / HDFS block-repair roles).
    Each distinct replicated client repairs once even when both
    repositories share a source. Fails loudly when no repository is on
    a replicated rest source — zeros must mean "checked and
    consistent", never "nothing to check"."""
    st = _storage(storage)
    clients: list = []
    for repo in ("METADATA", "MODELDATA"):
        try:
            c = st.client_for(repo)
        except StorageError:
            continue
        if not any(c is seen for seen in clients):
            clients.append(c)
    totals = {"copied": 0, "deleted": 0}
    found = False
    for c in clients:
        fn = getattr(c, "repair_meta", None)
        # an unreplicated rest source (REPLICAS=1) is "nothing to
        # check" — the same CommandError as no rest source at all —
        # while an exception from a replicated repair stays LOUD (it
        # means divergence was left behind, not that there was nothing
        # to do)
        if fn is None or not getattr(c, "meta_replicated", False):
            continue
        found = True
        stats = fn()
        totals["copied"] += stats["copied"]
        totals["deleted"] += stats["deleted"]
    if not found:
        raise CommandError(
            "METADATA/MODELDATA is not a replicated rest source — nothing "
            "to repair (configure REPLICAS>1 on its source)"
        )
    return totals
