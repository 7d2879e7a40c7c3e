"""Shared command client for the CLI and the admin API.

Counterpart of ``predictionio_tpu/tools/commands.py`` without
``repair_events`` / ``repair_metadata``, which exist for the sharded
``rest`` source the port does not have. Behavior contracts from the
reference console + admin (tools/.../console/App.scala, AccessKey.scala,
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

Each function raises ``CommandError`` with the reference's message
shape on failure; callers (CLI / admin) map that to exit codes / HTTP.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from predictionio_torch.data.metadata import AccessKey, App, Channel
from predictionio_torch.data.storage import Storage, get_storage


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
