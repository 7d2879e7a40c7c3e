"""Chaos harness: deterministic fault injection at the framework's seams.

Copy of ``predictionio_tpu/resilience/chaos.py``; the port's seams are
in ``data/storage.py`` (``Storage.client_for``),
``serving/engine_server.py`` (``MicroBatcher``) and
``workflow/train.py``. ``_rng`` is a ``random.Random`` a test may seed.
What follows is the JAX module's account.

Resilience code that has never seen a failure is decorative. This
module injects latency, errors and hangs at three seams —

  storage   every repository access (``Storage.client_for``): a slow
            or erroring backend, without touching the backend
  batcher   the engine server's micro-batch dispatch (inside the
            dispatch watchdog's watch window): a slow or hung model
  train     the training workflow, just before ``engine.train``

— so tier-1 tests (and operators, against a staging server) can PROVE
the breaker opens, admission control sheds, the watchdog still fires
on true hangs, and recovery closes the loop.

Spec grammar (``PIO_CHAOS`` env var, or ``POST /admin/chaos``):

    site[@tag]:kind[:amount][,site[@tag]:kind[:amount]...]

The optional ``@tag`` scopes a rule to ONE instance of a seam that
exists many times per fleet: every engine-server replica runs the same
``batcher`` seam, and ``batcher@r1:hang:5s`` hangs only the replica
whose chaos tag is ``r1`` (the fleet supervisor tags replicas by name;
a standalone server tags itself via ``PIO_CHAOS_TAG``). An untagged
rule matches every instance, tagged or not.

  kinds:
    latency:50ms   sleep that long at the seam (ms/s suffix; bare
                   numbers are seconds)
    error:0.1      raise ChaosError with that probability (default 1)
    hang:30s       sleep that long (default 300s) — long enough that
                   deadlines/watchdogs, not patience, must save the
                   caller. A hang is just a big latency; the separate
                   kind keeps specs honest about intent.

    PIO_CHAOS=storage:latency:50ms,storage:error:0.1,batcher:hang:30s

``ChaosError`` subclasses ``ConnectionError`` deliberately: an injected
storage error classifies exactly like a real connection failure — it
trips breakers, spends retry budgets, and maps to
``StorageUnavailableError`` — so the failure path exercised is the one
production takes. Every injection lands in
``pio_chaos_injections_total{site,kind}``; an injected fault must
never be mistaken for an organic one in a postmortem.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from predictionio_torch.obs import journal, metrics

log = logging.getLogger(__name__)

DEFAULT_HANG_SEC = 300.0

_INJECTIONS = metrics.counter(
    "pio_chaos_injections_total",
    "Chaos faults injected, by seam and fault kind",
    ("site", "kind"),
)

#: seams with an ``inject()`` call in tree — unknown sites are accepted
#: (a test may add its own seam) but the admin surface lists these
KNOWN_SITES = ("storage", "batcher", "train")


class ChaosError(ConnectionError):
    """An injected failure. A ConnectionError on purpose: the retry/
    breaker/degraded machinery must not be able to tell it from a real
    one."""


@dataclasses.dataclass(frozen=True)
class ChaosRule:
    site: str
    kind: str        # "latency" | "error" | "hang"
    amount: float    # seconds (latency/hang) or probability (error)

    def as_dict(self) -> Dict[str, Any]:
        return {"site": self.site, "kind": self.kind, "amount": self.amount}

    def spec(self) -> str:
        if self.kind == "error":
            return f"{self.site}:error:{self.amount:g}"
        return f"{self.site}:{self.kind}:{self.amount:g}s"


def _parse_duration(text: str, what: str) -> float:
    text = text.strip().lower()
    try:
        if text.endswith("ms"):
            return float(text[:-2]) / 1e3
        if text.endswith("s"):
            return float(text[:-1])
        return float(text)
    except ValueError:
        raise ValueError(f"chaos {what} needs a duration like 50ms or "
                         f"1.5s, got {text!r}") from None


def parse_rule(item: str) -> ChaosRule:
    parts = [p.strip() for p in item.strip().split(":")]
    if len(parts) < 2 or not parts[0]:
        raise ValueError(
            f"chaos rule {item!r} is not site:kind[:amount]")
    site, kind = parts[0], parts[1]
    arg = parts[2] if len(parts) > 2 else None
    if kind == "latency":
        if arg is None:
            raise ValueError(f"chaos rule {item!r}: latency needs an amount")
        return ChaosRule(site, kind, _parse_duration(arg, "latency"))
    if kind == "hang":
        return ChaosRule(site, kind,
                         _parse_duration(arg, "hang")
                         if arg is not None else DEFAULT_HANG_SEC)
    if kind == "error":
        try:
            prob = float(arg) if arg is not None else 1.0
        except ValueError:
            raise ValueError(
                f"chaos rule {item!r}: error probability must be a "
                "number") from None
        if not 0.0 <= prob <= 1.0:
            raise ValueError(
                f"chaos rule {item!r}: error probability must be in [0, 1]")
        return ChaosRule(site, kind, prob)
    raise ValueError(
        f"chaos rule {item!r}: unknown kind {kind!r} "
        "(latency | error | hang)")


def parse_spec(spec: str) -> List[ChaosRule]:
    return [parse_rule(item)
            for item in spec.split(",") if item.strip()]


# -- active rule set -----------------------------------------------------------
#
# The rule tuple is immutable and swapped atomically: inject() reads it
# without a lock (one attribute load), writers serialize on _lock.
# ``_explicit`` records that an operator set/cleared rules through the
# API or admin surface — from then on the PIO_CHAOS env var is inert
# (a later server start in the same process must not silently revert
# an admin decision).

_rules: Tuple[ChaosRule, ...] = ()
_lock = threading.Lock()
_env_loaded = False
_explicit = False
_rng = random.Random()


def _install(rules: Tuple[ChaosRule, ...], explicit: bool) -> None:
    global _rules, _env_loaded, _explicit
    with _lock:
        _rules = rules
        _env_loaded = True
        if explicit:
            _explicit = True
    journal.emit("chaos", spec=",".join(r.spec() for r in rules) or None,
                 rules=len(rules), explicit=explicit or None)
    if rules:
        log.warning("CHAOS ACTIVE: %s", ",".join(r.spec() for r in rules))
    else:
        log.info("chaos cleared")


def configure(spec: str) -> List[ChaosRule]:
    """Replace the active rule set from a spec string (empty = off)."""
    rules = tuple(parse_spec(spec))
    _install(rules, explicit=True)
    return list(rules)


def add(spec: str) -> List[ChaosRule]:
    """Append rules from a spec to the active set."""
    new = tuple(parse_spec(spec))
    with _lock:
        merged = _rules + new
    _install(merged, explicit=True)
    return list(merged)


def clear(site: Optional[str] = None) -> None:
    """Drop every rule, or only ``site``'s — INCLUDING its tagged
    variants (``clear("batcher")`` drops ``batcher@r1`` too: an
    operator clearing a seam means the whole seam, not just the
    untagged spelling). An exact ``site@tag`` clears one instance."""
    with _lock:
        kept = (() if site is None
                else tuple(r for r in _rules
                           if r.site != site
                           and not r.site.startswith(site + "@")))
    _install(kept, explicit=True)


def reset() -> None:
    """Full reset INCLUDING the explicit-configuration latch (tests:
    each test must see env-driven behavior again)."""
    global _rules, _env_loaded, _explicit
    with _lock:
        _rules = ()
        _env_loaded = False
        _explicit = False


def configure_from_env() -> List[ChaosRule]:
    """(Re)load ``PIO_CHAOS`` — unless rules were explicitly
    set/cleared via the API or admin surface, which outranks the env
    for the life of the process (a second in-process server start must
    not re-enable injection an operator turned off)."""
    global _env_loaded
    spec = os.environ.get("PIO_CHAOS")
    with _lock:
        explicit = _explicit
    if spec is not None and not explicit:
        _install(tuple(parse_spec(spec)), explicit=False)
    else:
        with _lock:
            _env_loaded = True
    return list(_rules)


def active() -> List[ChaosRule]:
    return list(_rules)


def describe() -> Dict[str, Any]:
    """The admin-surface view (GET /admin/chaos)."""
    rules = _rules
    return {
        "enabled": bool(rules),
        "spec": ",".join(r.spec() for r in rules),
        "rules": [r.as_dict() for r in rules],
        "sites": list(KNOWN_SITES),
    }


def apply_admin(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Mutate the rule set from a POST /admin/chaos body:
    ``{"spec": "..."}`` replaces, ``{"add": "..."}`` appends,
    ``{"clear": true}`` / ``{"clear": "site"}`` drops. Raises
    ValueError on a malformed body or spec (the route answers 400)."""
    if not isinstance(payload, dict):
        raise ValueError("chaos admin body must be a JSON object")
    did = False
    if payload.get("clear"):
        clear(None if payload["clear"] is True else str(payload["clear"]))
        did = True
    if "spec" in payload:
        configure(str(payload["spec"]))
        did = True
    if "add" in payload:
        add(str(payload["add"]))
        did = True
    if not did:
        raise ValueError(
            'chaos admin body needs "spec", "add" or "clear"')
    return describe()


def inject(site: str, tag: Optional[str] = None) -> None:
    """The seam hook. Applies every active rule for ``site``, in rule
    order: latency/hang sleep, error raises :class:`ChaosError` with
    its probability. No active rules = one tuple load and out — the
    hot path cost of an idle harness is nil.

    ``tag`` names THIS instance of the seam (a fleet replica's name):
    untagged rules (``site``) match every instance; tagged rules
    (``site@tag``) match only the instance carrying that tag."""
    rules = _rules
    if not rules:
        _ensure_env_loaded()
        rules = _rules
        if not rules:
            return
    qualified = f"{site}@{tag}" if tag else None
    for rule in rules:
        if rule.site != site and rule.site != qualified:
            continue
        if rule.kind in ("latency", "hang"):
            _INJECTIONS.labels(rule.site, rule.kind).inc()
            time.sleep(rule.amount)
        elif rule.kind == "error":
            if _rng.random() < rule.amount:
                _INJECTIONS.labels(rule.site, rule.kind).inc()
                raise ChaosError(
                    f"chaos: injected {rule.spec()} fault at the "
                    f"{site} seam")


def _ensure_env_loaded() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        _env_loaded = True
    spec = os.environ.get("PIO_CHAOS")
    if spec:
        configure(spec)
