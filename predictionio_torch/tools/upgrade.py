"""Opt-in version check.

Counterpart of ``predictionio_tpu/tools/upgrade.py``. Behavior contract
from the reference: ``WorkflowUtils.checkUpgrade``
(workflow/WorkflowUtils.scala:220) and the engine server's daily
``UpgradeActor`` (workflow/CreateServer.scala:163-170,246) phone
``update.prediction.io`` to compare versions. Here the check is **off by
default** (no egress unless the operator sets ``PIO_UPDATE_URL``), never
raises, and never blocks callers for more than a couple of seconds.

The daemon waits on a ``threading.Event`` between checks rather than
sleeping, so its owner can end it: :func:`start_upgrade_daemon` returns
an :class:`UpgradeDaemon` whose ``stop()`` sets the event and joins the
``pio-upgrade-check`` thread (the engine server's ``stop`` does), and
no thread outlives the server that started it.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import urllib.request
from typing import Optional

from predictionio_torch import __version__

log = logging.getLogger(__name__)

THREAD_NAME = "pio-upgrade-check"


def check_upgrade(component: str = "pio", timeout: float = 2.0) -> None:
    """Compare ``__version__`` against the JSON at ``PIO_UPDATE_URL``.

    Expected payload: ``{"version": "X.Y.Z"}``. Logs (never raises); a
    no-op when PIO_UPDATE_URL is unset.
    """
    url = os.environ.get("PIO_UPDATE_URL", "")
    if not url:
        return
    try:
        with urllib.request.urlopen(f"{url}?component={component}",
                                    timeout=timeout) as r:
            latest = json.loads(r.read().decode("utf-8")).get("version", "")
        if latest and latest != __version__:
            log.info(
                "a newer version is available: %s (running %s)", latest,
                __version__)
    except Exception as exc:  # network failure must never affect the caller
        log.debug("version check skipped: %s", exc)


class UpgradeDaemon:
    """The periodic check's thread; ``stop()`` ends and joins it."""

    def __init__(self, component: str, interval_sec: float):
        self._stop = threading.Event()
        self._component = component
        self._interval = interval_sec
        self.thread = threading.Thread(target=self._loop, name=THREAD_NAME,
                                       daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                check_upgrade(self._component)
            except Exception:  # noqa: BLE001 — the daemon must outlive any surprise
                log.exception("upgrade check iteration failed")
            self._stop.wait(self._interval)

    def stop(self, timeout: float = 5.0) -> bool:
        """Set the stop event and join the thread (a check in flight ends
        within its 2-s timeout); True once the thread has ended."""
        self._stop.set()
        if self.thread.is_alive() and (
                self.thread is not threading.current_thread()):
            self.thread.join(timeout)
        return not self.thread.is_alive()


def start_upgrade_daemon(component: str = "pio",
                         interval_sec: float = 86400.0
                         ) -> Optional[UpgradeDaemon]:
    """Daily background check (ref: UpgradeActor, CreateServer.scala:246).

    A daemon thread, checking at once and then every ``interval_sec``;
    None (no thread) unless PIO_UPDATE_URL is set. The caller stops the
    returned daemon when it shuts down.
    """
    if not os.environ.get("PIO_UPDATE_URL"):
        return None
    daemon = UpgradeDaemon(component, interval_sec)
    daemon.thread.start()
    return daemon
