"""The port's console: ``pio`` for apps, keys, events, templates, build,
train, deploy, stream and eval, the operator commands slo, chaos,
replay, canary and fleet, and the observability commands metrics,
flight, trace, profile, prof, journal, anomalies, data, mem and top.

    python -m predictionio_torch.tools.cli app new NAME [--description D]
    python -m predictionio_torch.tools.cli app list|show|delete|data-delete|
        compact|channel-new|channel-delete ...
    python -m predictionio_torch.tools.cli accesskey new APP [EVENT ...]
    python -m predictionio_torch.tools.cli accesskey list [--app APP]
    python -m predictionio_torch.tools.cli accesskey delete KEY
    python -m predictionio_torch.tools.cli eventserver [--ip IP] [--port 7070]
    python -m predictionio_torch.tools.cli adminserver [--ip IP] [--port 7071]
    python -m predictionio_torch.tools.cli storageserver [--ip IP] \
        [--port 7077] [--auth-key KEY]
    python -m predictionio_torch.tools.cli storagerepair --appname APP \
        [--channel CH]
    python -m predictionio_torch.tools.cli import --appname APP --input F
    python -m predictionio_torch.tools.cli export --appname APP --output F
    python -m predictionio_torch.tools.cli status
    python -m predictionio_torch.tools.cli template list
    python -m predictionio_torch.tools.cli template get NAME DIRECTORY
    python -m predictionio_torch.tools.cli build \\
        --engine-json engine.json [--engine-id ID] [--engine-version V]
    python -m predictionio_torch.tools.cli train \\
        --engine-json engine.json [--engine-id ID] [--device cpu]
    python -m predictionio_torch.tools.cli deploy \\
        --engine-json engine.json [--engine-id ID] [--port 8000] \\
        [--ip 0.0.0.0] [--device cpu] [--replicas N] \\
        [--replica-mode subprocess|thread] [--canary] \\
        [--feedback-url URL --accesskey KEY] [--log-url URL]
    python -m predictionio_torch.tools.cli undeploy [--ip IP] [--port 8000]
    python -m predictionio_torch.tools.cli stream \\
        --engine-json engine.json [--url http://HOST:8000[,...]] \\
        [--reload-url URL[,...]] [--once | --interval SEC] [--device cpu]
    python -m predictionio_torch.tools.cli eval pkg.mod.MyEvaluation \\
        [pkg.mod.MyParamsGenerator] [--batch B] [--device cpu]
    python -m predictionio_torch.tools.cli slo [--url URL] [--json]
    python -m predictionio_torch.tools.cli chaos --url URL \\
        [--set SPEC | --add SPEC | --clear [SITE]] [--json]
    python -m predictionio_torch.tools.cli replay --url CANDIDATE \\
        [--baseline URL] [--flight-url URL] [-n N] [--k K] \\
        [--no-push] [--fail-under X] [--json]
    python -m predictionio_torch.tools.cli canary [--url ROUTER] \\
        [--start | --promote | --rollback] [--json]
    python -m predictionio_torch.tools.cli fleet [--url ROUTER] \\
        [--reload [--force] | --drain R | --readmit R] [--json]
    python -m predictionio_torch.tools.cli metrics [--url URL] [--json]
    python -m predictionio_torch.tools.cli flight --url URL [-n N] [--slow]
    python -m predictionio_torch.tools.cli trace TRACE_ID [--url URL] [--json]
    python -m predictionio_torch.tools.cli profile --url URL [--seconds S]
    python -m predictionio_torch.tools.cli prof [--url URL] [--fleet] \\
        [--collapsed] [--slow] [--endpoint ROUTE] [--top N] [--json]
    python -m predictionio_torch.tools.cli journal [--url URL] [--fleet] \\
        [-n N] [--kind K] [--since TS] [--follow] [--json]
    python -m predictionio_torch.tools.cli anomalies [--url URL] [--fleet] \\
        [--json]
    python -m predictionio_torch.tools.cli data [--url URL] [--fleet] \\
        [--top N] [--json]
    python -m predictionio_torch.tools.cli mem [--url URL] [--json]
    python -m predictionio_torch.tools.cli top [--url URL] [--fleet] \\
        [--once [--json] | --interval SEC]

The app, access-key, server, import/export and status commands take the
JAX console's arguments and print its lines (ref:
tools/.../console/Console.scala:128-735); they touch no device and
import no torch; ``storageserver`` serves this host's configured
storage to ``rest`` sources (``serving/storage_server.py``),
``storagerepair`` reconciles the replicas of a replicated ``rest``
source, owner-authoritatively, and ``status`` exits 2 when every tier
still serves through replicas with some endpoint down, 1 when a tier
cannot serve. ``template list`` names every template the JAX console
offers and the port's module of each; ``template get`` scaffolds a project
directory from the port's template source (an editable
``<name>_engine.py``, an ``engine.json`` whose factory resolves from the
directory, a README; ref: console/Template.scala:198-415, egress-free).
``build`` loads the engine.json's engine and registers its
EngineManifest (ref: RegisterEngine.scala:50; engines are Python, so
there is no compile step). The engine commands read an engine.json as
an ``EngineVariant`` (``workflow/variant.py``): a factory module beside
it loads from the project directory, one scaffolded by either package.
``train`` reads the engine's events, trains its algorithms and stores a
COMPLETED engine instance with its models. ``deploy`` serves the latest
COMPLETED instance of the engine — trained by either package; an
``engineFactory`` under ``predictionio_tpu.`` resolves under
``predictionio_torch.`` — on ``POST /queries.json`` until SIGTERM
drains it or ``undeploy`` (``POST /stop``) stops it (ref:
Console.scala:830), with the variant's ``"slo"`` block's objectives and
shed thresholds; ``--replicas N`` serves from N replicas (subprocesses
running this CLI's ``deploy --replicas 1`` on the parent's device, or
threads) behind the query router (``serving/{fleet,router}.py``).
``stream`` tails the engine's event log and folds new events into the
deployed model, patching the servers named by ``--url``
(``workflow/stream.py``; ``--once`` runs one cycle and prints its
stats; ``--reload-url`` names the reload lane a drift-band breach of
its quality probe fires). ``eval`` runs an ``Evaluation`` over the
candidates of an ``EngineParamsGenerator``, stores an EvaluationInstance and prints the
best score's one-liner (ref: Console.scala eval,
CreateWorkflow.scala:263-276); dotted paths under ``predictionio_tpu.``
resolve under ``predictionio_torch.``. These four run on the card;
``--device cpu`` is the only way onto the CPU. ``slo``, ``chaos``,
``replay``, ``canary`` and ``fleet`` talk to a running server's admin
routes (sending the ``PIO_ADMIN_TOKEN`` bearer when set) with the JAX
console's arguments and exit codes, as do the observability commands;
``metrics``, ``trace``, ``journal``, ``anomalies``, ``data``, ``mem``
and ``top`` read this process's own state without ``--url``
(``anomalies`` exits 1 while an anomaly is active, ``trace`` when no
span of the id was found, ``profile`` where the server has no card).
Storage comes from the
``PIO_STORAGE_*`` environment, as for ``pio``. The other commands stay
with ``predictionio_tpu.tools.cli`` until their slices are ported
(ROADMAP.md queue 1).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from predictionio_torch.data.storage import get_storage
from predictionio_torch.tools import commands, eventdata


def _events_text(events) -> str:
    return ",".join(sorted(events)) if events else "(all)"


# -- app / accesskey -----------------------------------------------------------

def cmd_app(args) -> int:
    st = get_storage()
    if args.app_command == "new":
        info = commands.app_new(args.name, args.description, st)
        print("Created new app:")
        print(f"      Name: {info.app.name}")
        print(f"        ID: {info.app.id}")
        print(f"Access Key: {info.access_keys[0].key}")
    elif args.app_command == "list":
        infos = commands.app_list(st)
        print(f"{'Name':>20} | {'ID':>4} | {'Access Key':>64} | "
              "Allowed Event(s)")
        for info in infos:
            for k in info.access_keys:
                print(f"{info.app.name:>20} | {info.app.id:>4} | "
                      f"{k.key:>64} | {_events_text(k.events)}")
        print(f"Finished listing {len(infos)} app(s).")
    elif args.app_command == "show":
        info = commands.app_show(args.name, st)
        print(f"    App Name: {info.app.name}")
        print(f"      App ID: {info.app.id}")
        print(f" Description: {info.app.description or ''}")
        for k in info.access_keys:
            print(f"  Access Key: {k.key} | {_events_text(k.events)}")
        for c in info.channels:
            print(f"     Channel: {c.name} (id {c.id})")
    elif args.app_command == "delete":
        commands.app_delete(args.name, st)
        print(f"App deleted: {args.name}")
    elif args.app_command == "data-delete":
        commands.app_data_delete(args.name, args.channel, st)
        print(f"App data deleted: {args.name}")
    elif args.app_command == "compact":
        stats = commands.app_compact(args.name, args.channel, st)
        # a sharded rest source returns one stats dict (or None) per shard
        shard_stats = stats if isinstance(stats, list) else [stats]
        if all(s is None for s in shard_stats):
            print("Backend stores events in place; nothing to compact.")
        else:
            for i, s in enumerate(shard_stats):
                prefix = f"shard {i}: " if len(shard_stats) > 1 else ""
                if s is None:
                    print(f"{prefix}stores events in place; nothing to "
                          "compact.")
                else:
                    print(f"{prefix}Compacted: dropped {s['dropped']} "
                          f"records, {s['before_bytes']} -> "
                          f"{s['after_bytes']} bytes")
    elif args.app_command == "channel-new":
        ch = commands.channel_new(args.name, args.channel, st)
        print(f"Channel created: {ch.name} (id {ch.id})")
    elif args.app_command == "channel-delete":
        commands.channel_delete(args.name, args.channel, st)
        print(f"Channel deleted: {args.channel}")
    return 0


def cmd_accesskey(args) -> int:
    st = get_storage()
    if args.ak_command == "new":
        key = commands.accesskey_new(args.app, args.event, st)
        print(f"Created new access key: {key.key}")
    elif args.ak_command == "list":
        for k in commands.accesskey_list(args.app, st):
            print(f"{k.key} | app {k.appid} | {_events_text(k.events)}")
    elif args.ak_command == "delete":
        commands.accesskey_delete(args.key, st)
        print(f"Deleted access key: {args.key}")
    return 0


# -- servers -------------------------------------------------------------------

def cmd_eventserver(args) -> int:
    from predictionio_torch.serving.event_server import EventServer
    from predictionio_torch.serving.http import (drain_timeout,
                                                 install_drain_handler)

    server = EventServer(host=args.ip, port=args.port)
    install_drain_handler(server)
    print(f"Event server running on {args.ip}:{server.port}", flush=True)
    server.serve_forever()
    # SIGTERM returns serve_forever at once; the drain answers what is
    # in flight, then stops the server. Then close the event store: an
    # event log closed cleanly writes its index snapshot, and the next
    # process to open it (pio train) scans without first rebuilding the
    # id index of every record.
    if server.wait_stopped(drain_timeout() + 5.0) \
            and server.inflight_count() == 0:
        close = getattr(server.core.storage.events(), "close", None)
        if close is not None:
            close()
    return 0


def cmd_adminserver(args) -> int:
    from predictionio_torch.tools.admin import AdminServer

    server = AdminServer(host=args.ip, port=args.port)
    print(f"Admin server running on {args.ip}:{server.port}", flush=True)
    server.serve_forever()
    return 0


# -- data ----------------------------------------------------------------------

def cmd_import(args) -> int:
    n = eventdata.import_events(args.appname, args.input, args.channel,
                                format=args.format)
    print(f"Imported {n} event(s).")
    return 0


def cmd_export(args) -> int:
    n = eventdata.export_events(args.appname, args.output, args.channel,
                                format=args.format)
    print(f"Exported {n} event(s).")
    return 0


#: `pio status` exit code when every tier still serves through its
#: replicas but some endpoint is down: distinct from 1 (a tier cannot
#: serve) so operators page on the right thing (ref:
#: Storage.verifyAllDataObjects role, Storage.scala:237)
STATUS_DEGRADED = 2


def cmd_status(args) -> int:
    """ref: Storage.verifyAllDataObjects (Storage.scala:237), resolved
    per tier: OK, DEGRADED (serving through replicas) or FAILED, with
    each endpoint of a sharded source named."""
    details = get_storage().serving_status()
    all_up = all(d["serving"] and not d["degraded"] for d in details.values())
    serving = all(d["serving"] for d in details.values())
    for repo, d in sorted(details.items()):
        state = ("OK" if d["serving"] and not d["degraded"]
                 else "DEGRADED" if d["serving"] else "FAILED")
        print(f"{repo}: {state}")
        if len(d["endpoints"]) > 1 or not d["serving"] or d["degraded"]:
            for shard, alive in sorted(d["endpoints"].items()):
                if shard:
                    print(f"  shard {shard}: {'OK' if alive else 'DOWN'}")
    if all_up:
        print("(sleeping)")
        return 0
    if serving:
        print("Storage degraded: every tier still serving through replicas, "
              "but some endpoint is down.")
        return STATUS_DEGRADED
    print("Unable to connect to all storage backends.")
    return 1


def cmd_storageserver(args) -> int:
    """Serve this host's configured storage to ``rest``-backend peers
    (the scale-out tier: the HBase/ES/HDFS roles behind one HTTP
    service); SIGTERM drains it."""
    from predictionio_torch.serving.http import install_drain_handler
    from predictionio_torch.serving.storage_server import StorageServer

    server = StorageServer(host=args.ip, port=args.port,
                           auth_key=args.auth_key)
    install_drain_handler(server)
    print(f"Storage server running on {args.ip}:{server.port}", flush=True)
    server.serve_forever()
    return 0


def cmd_storagerepair(args) -> int:
    """Repair every replicated tier: the app's events, then the metadata
    and model replica set. A tier that is not replicated is reported as
    skipped; when neither tier can be repaired the command fails with
    the events tier's error (nothing was checked)."""
    from predictionio_torch.data.storage import StorageError

    repaired = 0
    try:
        stats = commands.repair_events(args.appname, args.channel)
        print(f"Event replica repair for app {args.appname}: "
              f"{stats['copied']} rows copied, {stats['deleted']} rows "
              "deleted")
        repaired += 1
    except (commands.CommandError, StorageError) as e:
        print(f"Events: skipped ({e})")
        events_error = e
    try:
        stats = commands.repair_metadata()
        print(f"Metadata/model replica repair: {stats['copied']} records "
              f"copied, {stats['deleted']} records deleted")
        repaired += 1
    except commands.CommandError as e:
        print(f"Metadata/models: skipped ({e})")
    if not repaired:
        raise events_error
    return 0


# -- templates -----------------------------------------------------------------

#: every template the JAX console offers -> (the port's module, its
#: factory)
TEMPLATES = {
    "recommendation": ("predictionio_torch.templates.recommendation",
                       "recommendation_engine"),
    "similarproduct": ("predictionio_torch.templates.similarproduct",
                       "similar_product_engine"),
    "ecommercerecommendation": ("predictionio_torch.templates.ecommerce",
                                "ecommerce_engine"),
    "twotower": ("predictionio_torch.templates.twotower",
                 "twotower_engine"),
    "twotower-hybrid": ("predictionio_torch.templates.twotower",
                        "twotower_hybrid_engine"),
    "classification": ("predictionio_torch.templates.classification",
                       "classification_engine"),
    "regression": ("predictionio_torch.templates.regression",
                   "regression_engine"),
    "vanilla": ("predictionio_torch.templates.vanilla", "vanilla_engine"),
    "sessionrec": ("predictionio_torch.templates.sessionrec",
                   "sessionrec_engine"),
}


def cmd_template(args) -> int:
    if args.template_command == "list":
        for name, (module_name, _factory) in sorted(TEMPLATES.items()):
            print(f"{name:28} {module_name}")
        return 0
    # template get NAME DIR: a working engine project — the port's
    # template source copied in as editable code, plus an engine.json
    # whose factory resolves from the project directory
    import importlib.util
    import os
    import shutil

    name = args.name
    entry = TEMPLATES.get(name)
    if entry is None:
        raise commands.CommandError(
            f"Unknown template {name!r} (available: {sorted(TEMPLATES)})")
    module_name, factory = entry
    # the source file's path, found without importing the module (and
    # torch with it)
    src = importlib.util.find_spec(module_name).origin
    os.makedirs(args.directory, exist_ok=True)
    mod_name = f"{name.replace('-', '_')}_engine"
    shutil.copyfile(src, os.path.join(args.directory, f"{mod_name}.py"))
    path = os.path.join(args.directory, "engine.json")
    with open(path, "w") as f:
        json.dump({"id": "default",
                   "description": f"{name} template (scaffolded from "
                                  f"{module_name})",
                   "engineFactory": f"{mod_name}.{factory}"}, f, indent=2)
        f.write("\n")
    with open(os.path.join(args.directory, "README.md"), "w") as f:
        f.write(
            f"# {name} engine\n\n"
            f"Scaffolded from `{module_name}`.\n\n"
            f"- `{mod_name}.py` — your engine source (DataSource/"
            "Preparator/Algorithm/Serving + factory). Edit freely; it\n"
            "  is resolved from this directory, not the installed "
            "package.\n"
            "- `engine.json` — the variant: fill the per-component "
            "`{\"name\": ..., \"params\": {...}}` blocks (e.g. the "
            "datasource's `app_name`).\n\n"
            "Run `python -m predictionio_torch.tools.cli build|train|deploy "
            "--engine-json engine.json`.\n")
    print(f"Created {args.directory}: {mod_name}.py (editable engine "
          "source), engine.json, README.md")
    print(f"Edit params, then `pio train --engine-json {path}`.")
    return 0


# -- build / train / deploy -----------------------------------------------------

def load_variant(path: str):
    from predictionio_torch.workflow.variant import EngineVariant

    return EngineVariant.load(path)


def engine_from_json(path: str):
    """(engine, variant dict) of an engine.json."""
    variant = load_variant(path)
    return variant.create_engine(), variant.raw


def _engine_id(args, variant) -> str:
    return (args.engine_id or variant.raw.get("engineId")
            or variant.engine_factory)


def cmd_build(args) -> int:
    """Load the engine (an engine.json whose engine does not load fails
    here, not at train) and register its manifest."""
    from predictionio_torch.data.metadata import EngineManifest

    variant = load_variant(args.engine_json)
    variant.create_engine()
    engine_id = _engine_id(args, variant)
    manifests = get_storage().engine_manifests()
    manifest = EngineManifest(
        id=engine_id, version=args.engine_version, name=variant.id,
        description=variant.description, files=[args.engine_json],
        engine_factory=variant.engine_factory)
    if manifests.get(engine_id, args.engine_version) is None:
        manifests.insert(manifest)
    else:
        manifests.update(manifest)
    print(f"Registered engine {engine_id} {args.engine_version} "
          f"({variant.engine_factory})")
    return 0


def cmd_train(args) -> int:
    from predictionio_torch.parallel import multihost
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.workflow.config import WorkflowParams
    from predictionio_torch.workflow.train import run_train

    # under PIO_COORDINATOR_ADDRESS / PIO_NUM_PROCESSES / PIO_PROCESS_ID
    # the world comes up first, so the default device is the rank's card
    multihost.initialize_from_env(device=args.device)
    variant = load_variant(args.engine_json)
    engine = variant.create_engine()
    wp = WorkflowParams(batch=args.batch,
                        skip_sanity_check=args.skip_sanity_check,
                        stop_after_read=args.stop_after_read,
                        stop_after_prepare=args.stop_after_prepare)
    instance = run_train(engine, variant.engine_params(engine),
                         engine_id=_engine_id(args, variant),
                         engine_version=args.engine_version,
                         engine_variant=variant.id,
                         engine_factory=variant.engine_factory,
                         batch=args.batch,
                         ctx=DeviceContext(args.device,
                                           config=variant.runtime_conf()),
                         workflow_params=wp)
    print(f"Training completed: engine instance {instance.id} "
          f"({instance.status})", flush=True)
    return 0 if instance.status == "COMPLETED" else 1


def cmd_deploy(args) -> int:
    from predictionio_torch.obs import metrics
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.serving.http import install_drain_handler

    replicas = (args.replicas if args.replicas is not None
                else metrics.env_int("PIO_REPLICAS", 1))
    if args.canary and replicas <= 1:
        raise commands.CommandError(
            "--canary needs a fleet (--replicas >= 2): a canary is one "
            "replica serving the candidate while the rest serve the "
            "baseline")
    if replicas > 1:
        return _deploy_fleet(args, replicas)
    variant = load_variant(args.engine_json)
    engine = variant.create_engine()
    engine_id = _engine_id(args, variant)
    server = EngineServer(engine, engine_id=engine_id,
                          engine_version=args.engine_version,
                          engine_variant=variant.id,
                          host=args.ip, port=args.port, device=args.device,
                          feedback_url=args.feedback_url,
                          feedback_access_key=args.accesskey,
                          log_url=args.log_url,
                          # the variant's objectives and shed thresholds
                          slo_conf=variant.slo_conf())
    # SIGTERM drains the queries in flight, then stops the server (on
    # the drain's own thread, which the interpreter waits for)
    install_drain_handler(server)
    print(f"Engine {engine_id} deployed on {args.ip}:{server.port} "
          f"({server.ctx.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.stop()
    return 0


def _deploy_fleet(args, replicas: int) -> int:
    """``deploy --replicas N``: N single-server children on ephemeral
    ports behind the query router on the public port (``--replica-mode
    thread``: in-process servers, the same wiring in one process)."""
    import time

    from predictionio_torch.serving.fleet import (FleetSupervisor,
                                                  deploy_fleet_argv,
                                                  subprocess_fleet,
                                                  threaded_fleet)
    from predictionio_torch.serving.http import (drain_timeout,
                                                 install_drain_handler)
    from predictionio_torch.serving.router import QueryRouter
    from predictionio_torch.workflow.deploy import (
        latest_completed_instance_id)

    variant = load_variant(args.engine_json)
    engine_id = _engine_id(args, variant)
    if args.replica_mode == "thread":
        from predictionio_torch.serving.engine_server import EngineServer

        engine = variant.create_engine()

        def factory(name):
            return EngineServer(
                engine, engine_id=engine_id,
                engine_version=args.engine_version,
                engine_variant=variant.id, host="127.0.0.1", port=0,
                device=args.device, feedback_url=args.feedback_url,
                feedback_access_key=args.accesskey, log_url=args.log_url,
                slo_conf=variant.slo_conf(), chaos_tag=name)

        members = threaded_fleet(replicas, factory)
    else:
        argv = deploy_fleet_argv(args.engine_json, device=args.device)
        if args.engine_id:
            argv += ["--engine-id", args.engine_id]
        if args.engine_version != "0":
            argv += ["--engine-version", args.engine_version]
        # the per-server wiring survives the subprocess hop
        if args.feedback_url:
            argv += ["--feedback-url", args.feedback_url]
        if args.accesskey:
            argv += ["--accesskey", args.accesskey]
        if args.log_url:
            argv += ["--log-url", args.log_url]
        members = subprocess_fleet(replicas, argv)
    storage = get_storage()
    fleet = FleetSupervisor(
        members,
        version_source=lambda: latest_completed_instance_id(
            storage, engine_id, args.engine_version, variant.id),
        canary_mode=True if args.canary else None).start()
    router = QueryRouter(fleet, host=args.ip, port=args.port)
    install_drain_handler(router)
    lane = (" (CANARY mode: new COMPLETED instances land on one replica "
            "and are promoted or rolled back by verdict)"
            if args.canary else "")
    print(f"Engine {engine_id} deployed: {replicas} {args.replica_mode} "
          f"replica(s) behind router on {args.ip}:{router.port} (fleet "
          f"status: /admin/fleet; rolling hot-swap: GET /reload){lane}",
          flush=True)
    try:
        router.serve_forever()
    finally:
        # serve_forever returns when the SIGTERM drain stops the router
        # ACCEPTING; its admitted requests still drain on the pio-drain
        # thread and need live replicas, so the fleet outlives them
        # (bounded by the drain window)
        deadline = time.monotonic() + drain_timeout() + 5.0
        while (router.inflight_count() > 0
               and time.monotonic() < deadline):
            time.sleep(0.05)
        fleet.stop()
    return 0


def cmd_undeploy(args) -> int:
    import urllib.request

    req = urllib.request.Request(
        f"http://{args.ip}:{args.port}/stop", method="POST", data=b"")
    with urllib.request.urlopen(req, timeout=10) as resp:
        print(resp.read().decode(), flush=True)
    return 0


def cmd_stream(args) -> int:
    """`pio stream`: tail the event log since the last fold, fold deltas
    into the deployed model (ALS fold-in / two-tower online steps) and
    patch live engine servers; ``--once`` runs one cycle. A drift-band
    breach of the quality probe fires ``GET /reload`` at each
    ``--reload-url``."""
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.workflow.stream import (StreamUnsupported,
                                                    StreamUpdater)

    variant = load_variant(args.engine_json)
    engine = variant.create_engine()
    engine_id = _engine_id(args, variant)
    urls = [u.strip() for u in (args.url or "").split(",") if u.strip()]
    reload_urls = [u.strip() for u in (args.reload_url or "").split(",")
                   if u.strip()]
    try:
        updater = StreamUpdater(
            engine, engine_id, engine_version=args.engine_version,
            engine_variant=variant.id,
            ctx=DeviceContext(args.device), patch_urls=urls,
            reload_urls=reload_urls)
    except StreamUnsupported as e:
        raise commands.CommandError(str(e)) from e
    if args.once:
        print(json.dumps(updater.poll_once()), flush=True)
        return 0
    print(f"streaming fold-in for engine {engine_id} "
          f"(instance {updater.instance_id}, cursor {updater.cursor}) -> "
          f"{', '.join(urls) if urls else 'local model only'}; Ctrl-C "
          "stops", flush=True)
    try:
        updater.run_forever(interval=args.interval)
    except KeyboardInterrupt:
        print("stream stopped", flush=True)
    return 0


def cmd_eval(args) -> int:
    import importlib

    from predictionio_torch.core.engine import port_module
    from predictionio_torch.core.evaluation import (EngineParamsGenerator,
                                                    Evaluation)
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.workflow.evaluate import run_evaluation

    def resolve(dotted: str):
        module_name, _, attr = dotted.rpartition(".")
        if not module_name:
            raise commands.CommandError(
                f"{dotted!r} must be a dotted module.Attr path")
        try:
            obj = getattr(importlib.import_module(port_module(module_name)),
                          attr)
        except (ImportError, AttributeError) as e:
            raise commands.CommandError(
                f"cannot resolve {dotted!r}: {e}") from e
        return obj() if isinstance(obj, type) else obj

    evaluation = resolve(args.evaluation_class)
    if not isinstance(evaluation, Evaluation):
        raise commands.CommandError(
            f"{args.evaluation_class} is not an Evaluation")
    generator = None
    if args.engine_params_generator_class:
        generator = resolve(args.engine_params_generator_class)
        if not isinstance(generator, EngineParamsGenerator):
            raise commands.CommandError(
                f"{args.engine_params_generator_class} is not an "
                "EngineParamsGenerator")
    result = run_evaluation(
        evaluation, generator=generator,
        evaluation_class=args.evaluation_class,
        generator_class=args.engine_params_generator_class or "",
        batch=args.batch, ctx=DeviceContext(args.device))
    print(result.to_one_liner(), flush=True)
    return 0


# -- parser --------------------------------------------------------------------

def _add_admin_auth(req) -> None:
    """Attach the PIO_ADMIN_TOKEN bearer header to an /admin/* request
    when the operator has one configured — the servers 401 those
    routes without it (serving/http.py)."""
    import os

    token = os.environ.get("PIO_ADMIN_TOKEN")
    if token:
        req.add_header("Authorization", f"Bearer {token}")


def _fetch_admin_json(url: str, timeout: float = 30.0):
    """GET an /admin/* JSON payload with the bearer header; raises
    CommandError with the server's message on failure."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url)
    _add_admin_auth(req)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.load(resp)
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        try:
            message = json.loads(body).get("message", body)
        except json.JSONDecodeError:
            message = body[:200]
        raise commands.CommandError(f"request failed ({e.code}): {message}")
    except urllib.error.URLError as e:
        raise commands.CommandError(f"cannot reach {url}: {e.reason}")


def _dump_json(payload) -> None:
    json.dump(payload, sys.stdout, indent=1, sort_keys=True)
    sys.stdout.write("\n")


def cmd_slo(args) -> int:
    """SLO burn-rate evaluation (obs/slo.py): from a running server's
    ``GET /admin/slo`` when --url is given (sending the
    ``PIO_ADMIN_TOKEN`` bearer header when set), otherwise evaluated
    in-process against this process's registry. ``--json`` dumps the
    raw report; default output is one line per SLO with its state and
    the worst-window burn."""
    if args.url:
        report = _fetch_admin_json(args.url.rstrip("/") + "/admin/slo",
                                   timeout=10)
    else:
        from predictionio_torch.obs import slo as _slo

        report = _slo.MONITOR.report()
    if args.json:
        _dump_json(report)
        return 0
    firing = 0
    for entry in report["slos"]:
        burns = {w: b for w, b in entry["burn_rates"].items()
                 if b is not None}
        worst = max(burns.values()) if burns else None
        target = f"{entry['objective']:.3%}"
        if entry.get("threshold_ms") is not None:
            target += f" <= {entry['threshold_ms']:g}ms"
        print(f"{entry['name']:>20} [{entry['kind']}] objective {target}  "
           f"state={entry['state']}  "
           + (f"worst-window burn {worst:.2f}" if worst is not None
              else "no data"))
        for alert, info in entry["alerts"].items():
            if info["firing"]:
                print(f"{'':>20} {alert} page FIRING "
                   f"(burn >= {info['threshold']} over "
                   f"{' and '.join(info['windows'])})")
        firing += entry["state"] == "firing"
    return 1 if firing else 0


def cmd_chaos(args) -> int:
    """Inspect or toggle a live server's fault injection
    (``/admin/chaos``, resilience/chaos.py): with no mutation flags,
    print the active rule set; ``--set``/``--add``/``--clear`` change
    it. The server applies changes process-wide — every seam (storage,
    batcher, train) sees them immediately."""
    import urllib.error
    import urllib.request

    body = {}
    if args.clear is not None:
        body["clear"] = args.clear
    if args.set_spec is not None:
        body["spec"] = args.set_spec
    if args.add is not None:
        body["add"] = args.add
    url = args.url.rstrip("/") + "/admin/chaos"
    if body:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
    else:
        req = urllib.request.Request(url)
    _add_admin_auth(req)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            state = json.load(resp)
    except urllib.error.HTTPError as e:
        raise commands.CommandError(
            f"chaos request failed ({e.code}): "
            f"{e.read().decode(errors='replace')[:200]}")
    except urllib.error.URLError as e:
        raise commands.CommandError(f"cannot reach {args.url}: {e.reason}")
    if args.json:
        _dump_json(state)
        return 0
    if not state["enabled"]:
        print("chaos: no active rules")
        return 0
    print(f"chaos ACTIVE ({len(state['rules'])} rule(s)): {state['spec']}")
    for rule in state["rules"]:
        unit = "" if rule["kind"] == "error" else "s"
        print(f"  {rule['site']:>10} {rule['kind']:<8} {rule['amount']:g}{unit}")
    return 0


def cmd_replay(args) -> int:
    """`pio replay`: re-play logged query payloads (the flight
    recorder's PIO_FLIGHT_PAYLOADS capture) against a candidate
    instance, diffing every answer against the baseline (top-k overlap,
    score deltas, latency — workflow/replay.py); prints the
    machine-readable report and registers it on the baseline's
    ``/admin/quality`` surface unless --no-push. Exit 1 when
    --fail-under is given and the mean overlap lands below it."""
    import urllib.error

    from predictionio_torch.workflow import replay as replay_mod

    baseline = args.baseline or args.flight_url
    flight_url = args.flight_url or baseline
    if not baseline:
        raise commands.CommandError("--baseline (or --flight-url) is required: "
                           "the diff needs a reference lane")
    try:
        report = replay_mod.replay_urls(
            args.url, baseline, flight_url=flight_url, n=args.n,
            k=args.k)
    except urllib.error.URLError as e:
        raise commands.CommandError(f"replay failed: {e.reason}") from e
    except RuntimeError as e:
        raise commands.CommandError(str(e)) from e
    if not args.no_push:
        try:
            replay_mod.push_report(report, baseline)
        except Exception as e:  # noqa: BLE001 — the report is already
            # in hand; a failed push must not eat it
            print(f"(report push to {baseline} failed: {e})")
    if args.json:
        _dump_json(report)
    else:
        print(f"replayed {report['n']} logged quer(ies): "
           f"{report['diffed']} diffed, errors {report['errors']}")
        print(f"  mean top-{report['k']} overlap {report['mean_overlap']}, "
           f"worst {report['worst_overlap']}, mean |score delta| "
           f"{report['mean_score_delta']}")
        for lane in ("baseline", "candidate"):
            lat = report["latency_ms"].get(lane) or {}
            if lat:
                print(f"  {lane:>9}: p50 {lat['p50_ms']} ms, "
                   f"p99 {lat['p99_ms']} ms")
    if (args.fail_under is not None
            and (report["mean_overlap"] is None
                 or report["mean_overlap"] < args.fail_under)):
        print(f"FAIL: mean overlap below --fail-under {args.fail_under:g}")
        return 1
    return 0


def cmd_canary(args) -> int:
    """`pio canary`: drive/inspect the fleet's canary lane through the
    router. Default output renders the quality surface's verdict
    (``GET /admin/quality`` — drift gauges, replay report and canary
    analysis all read obs/quality.py's one state); --start/--promote/
    --rollback POST the action to ``/admin/fleet``. Exit 1 while an
    active canary's verdict says rollback."""
    import urllib.error
    import urllib.request

    base = args.url.rstrip("/")
    action = ("start" if args.start else "promote" if args.promote
              else "rollback" if args.rollback else None)
    if action:
        req = urllib.request.Request(
            base + "/admin/fleet",
            data=json.dumps({"canary": action}).encode(), method="POST",
            headers={"Content-Type": "application/json"})
        _add_admin_auth(req)
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                body = json.load(resp)
        except urllib.error.HTTPError as e:
            raise commands.CommandError(
                f"canary {action} failed ({e.code}): "
                f"{e.read().decode(errors='replace')[:200]}")
        except urllib.error.URLError as e:
            raise commands.CommandError(f"cannot reach {args.url}: {e.reason}")
        print(body.get("message") or json.dumps(body))
        return 0
    req = urllib.request.Request(base + "/admin/quality")
    _add_admin_auth(req)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            report = json.load(resp)
    except urllib.error.HTTPError as e:
        raise commands.CommandError(
            f"quality request failed ({e.code}): "
            f"{e.read().decode(errors='replace')[:200]}")
    except urllib.error.URLError as e:
        raise commands.CommandError(f"cannot reach {args.url}: {e.reason}")
    if args.json:
        _dump_json(report)
        canary = report.get("canary") or {}
        verdict = (canary.get("verdict") or {}).get("verdict")
        return 1 if (canary.get("active") and verdict == "rollback") else 0
    drift = report.get("drift")
    if drift:
        breached = drift.get("breached") or []
        print(f"drift (band {report['band']:g}, shadow "
           f"{str(drift.get('shadow_instance'))[:16]}): "
           f"recall_vs_retrain={drift.get('recall_vs_retrain')} "
           f"rmse_drift={drift.get('rmse_drift')} "
           f"factor_drift={drift.get('factor_drift')}"
           + (f"  BREACHED: {', '.join(breached)}" if breached else ""))
    else:
        print("drift: no probe yet (run `pio stream` against a trained "
           "instance)")
    rep = report.get("replay")
    if rep:
        print(f"replay: {rep.get('n')} queries, mean overlap "
           f"{rep.get('mean_overlap')}, worst {rep.get('worst_overlap')}")
    canary = report.get("canary") or {}
    if not canary:
        print("canary: none")
        return 0
    state = "ACTIVE" if canary.get("active") else (
        canary.get("outcome") or "inactive")
    print(f"canary [{state}]: replica {canary.get('replica')} candidate "
       f"{str(canary.get('candidate_version'))[:16]} vs baseline "
       f"{str(canary.get('baseline_version'))[:16]}")
    paired = canary.get("paired") or {}
    if paired:
        print(f"  paired samples: {paired.get('n')} "
           f"(errors {paired.get('errors')}), mean overlap "
           f"{paired.get('mean_overlap')}, worst "
           f"{paired.get('worst_overlap')}")
    verdict = canary.get("verdict") or {}
    if verdict:
        print(f"  verdict: {verdict.get('verdict', '?').upper()}")
        for lane, info in (verdict.get("latency") or {}).items():
            print(f"    {lane:>9}: {info.get('answers')} answers, "
               f"over-threshold rate {info.get('over_threshold_rate')} "
               f"(burn {info.get('burn')})")
        for reason in verdict.get("reasons") or []:
            print(f"    - {reason}")
    return 1 if (canary.get("active")
                 and verdict.get("verdict") == "rollback") else 0


def cmd_fleet(args) -> int:
    """Inspect or control a serving fleet through its router's
    ``/admin/fleet`` (serving/fleet.py): default output is one line per
    replica (state, version, restarts, outstanding); ``--reload``
    starts the rolling zero-downtime hot-swap, ``--drain``/``--readmit``
    move one replica out of / into rotation."""
    import urllib.error
    import urllib.request

    body = {}
    if args.reload:
        body["reload"] = True
        if getattr(args, "force", False):
            # acknowledge a 507 preflight refusal: the operator owns
            # the OOM risk now (obs/memacct.py)
            body["force"] = True
    if args.drain is not None:
        body["drain"] = args.drain
    if args.readmit is not None:
        body["readmit"] = args.readmit
    url = args.url.rstrip("/") + "/admin/fleet"
    if body:
        req = urllib.request.Request(
            url, data=json.dumps(body).encode(), method="POST",
            headers={"Content-Type": "application/json"})
    else:
        req = urllib.request.Request(url)
    _add_admin_auth(req)
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            state = json.load(resp)
    except urllib.error.HTTPError as e:
        raise commands.CommandError(
            f"fleet request failed ({e.code}): "
            f"{e.read().decode(errors='replace')[:200]}")
    except urllib.error.URLError as e:
        raise commands.CommandError(f"cannot reach {args.url}: {e.reason}")
    if args.json:
        _dump_json(state)
        return 0
    if body:
        print(state.get("message") or json.dumps(state))
        return 0
    print(f"fleet: {state['ready']}/{state['size']} ready, serving "
       f"version {state['version'] or '(mixed/none)'}")
    for r in state["replicas"]:
        print(f"  {r['name']:>6} {r['state']:<9} port={r['port'] or '-':<6} "
           f"version={r['version'] or '-':<34} restarts={r['restarts']} "
           f"outstanding={r['outstanding']}")
    from predictionio_torch.serving.fleet import format_swap

    swap = state.get("swap") or {}
    if swap.get("active") or swap.get("last"):
        print(format_swap(swap))
    return 0


# -- observability commands ----------------------------------------------------

def cmd_metrics(args) -> int:
    """Dump telemetry: a running server's ``GET /metrics`` with --url,
    else this process's registry. Prometheus text by default; ``--json``
    emits the flat ``{"name{labels}": value}`` object."""
    from predictionio_torch.obs import metrics as obs_metrics

    if args.url:
        import urllib.request

        url = args.url.rstrip("/")
        if not url.endswith("/metrics"):
            url += "/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            text = resp.read().decode()
    else:
        text = obs_metrics.REGISTRY.render()
    if args.json:
        _dump_json(obs_metrics.samples_dict(text))
    else:
        sys.stdout.write(text)
    return 0


def cmd_flight(args) -> int:
    """A server's flight-recorder dump (``GET /admin/flight``): the last
    completed request records with stage timings, span trees and trace
    ids, pretty-printed."""
    import urllib.parse

    query = {}
    if args.n is not None:
        query["n"] = str(args.n)
    if args.slow:
        query["slow"] = "1"
    url = args.url.rstrip("/") + "/admin/flight"
    if query:
        url += "?" + urllib.parse.urlencode(query)
    _dump_json(_fetch_admin_json(url, timeout=10))
    return 0


def cmd_trace(args) -> int:
    """One trace id stitched across processes (obs/collect.py) and
    rendered as an annotated tree: by the server at --url (``GET
    /admin/trace?id=``), else in this process from its own ring, its
    active fleets and ``PIO_OBS_MEMBERS``. Exit 1 when no span of the
    id was found."""
    from predictionio_torch.obs import collect

    if args.url:
        doc = _fetch_admin_json(
            args.url.rstrip("/") + "/admin/trace?id=" + args.trace_id)
    else:
        doc = collect.stitch_trace(args.trace_id, collect.default_members())
    if args.json:
        _dump_json(doc)
    else:
        print(collect.format_trace_tree(doc))
    return 0 if doc.get("span_count") else 1


def cmd_profile(args) -> int:
    """A torch.profiler window on a live server (``POST
    /admin/profile?seconds=N``, obs/profiler.py): prints the trace's
    path and its device-time summary. Exit 1 when the server has no
    card to profile (501)."""
    import urllib.error
    import urllib.request

    url = (args.url.rstrip("/")
           + f"/admin/profile?seconds={float(args.seconds)}")
    req = urllib.request.Request(url, method="POST", data=b"")
    _add_admin_auth(req)
    try:
        # the server sleeps through the capture window before answering
        with urllib.request.urlopen(
                req, timeout=float(args.seconds) + 30) as resp:
            payload = json.load(resp)
    except urllib.error.HTTPError as e:
        body = e.read().decode(errors="replace")
        try:
            message = json.loads(body).get("message", body)
        except json.JSONDecodeError:
            message = body
        if e.code == 501:
            print(f"profiler unavailable on the server: {message}")
            return 1
        raise commands.CommandError(
            f"profile request failed ({e.code}): {message}")
    except urllib.error.URLError as e:
        raise commands.CommandError(f"cannot reach {args.url}: {e.reason}")
    print(f"profile captured ({payload['seconds']}s, "
          f"backend {payload.get('backend', '?')})")
    print(f"artifact: {payload['artifact']}")
    summary = payload.get("summary") or {}
    if summary:
        print(json.dumps(summary, sort_keys=True))
    return 0


def cmd_prof(args) -> int:
    """The continuous host profiler (obs/contprof.py): a server's flame
    (``GET /admin/prof``; ``--fleet`` asks a router for the
    member-merged ``GET /admin/fleet/prof``) as a flame tree and its
    hot frames; ``--collapsed`` emits folded ``stack count`` lines."""
    import urllib.parse

    from predictionio_torch.obs import contprof

    path = "/admin/fleet/prof" if args.fleet else "/admin/prof"
    query = {}
    if args.slow:
        query["slow"] = "1"
    if args.endpoint:
        query["endpoint"] = args.endpoint
    url = args.url.rstrip("/") + path
    if query:
        url += "?" + urllib.parse.urlencode(query)
    payload = _fetch_admin_json(url)
    if args.json:
        _dump_json(payload)
        return 0
    flame = payload.get("merged", payload) if args.fleet else payload
    if args.collapsed:
        sys.stdout.write(contprof.collapsed_text(flame))
        return 0
    if args.fleet:
        for member in payload.get("members") or []:
            state = ("ok" if member.get("ok")
                     else f"ERROR: {member.get('error')}")
            detail = ""
            if member.get("ok"):
                detail = " ({} sample(s), {:.3g} Hz, overhead {})".format(
                    member.get("samples", 0),
                    member.get("effective_hz") or 0.0,
                    member.get("overhead_ratio"))
            print(f"member {member.get('name', '?'):<12} {state}{detail}")
        print("")
    sys.stdout.write(contprof.format_flame(flame, top=args.top))
    if args.slow and payload.get("slow_trace_ids"):
        print("slow-cohort trace ids (join with `pio flight --slow`):")
        for tid in payload["slow_trace_ids"][-20:]:
            print(f"  {tid}")
    return 0


def format_journal_event(event) -> str:
    """One journal event as one line: local wall clock, kind, member
    when federated, then the event's own fields."""
    import datetime

    ts = event.get("ts")
    when = (datetime.datetime.fromtimestamp(ts).strftime("%H:%M:%S")
            if isinstance(ts, (int, float)) else "--:--:--")
    parts = [f"{when}  {event.get('kind', '?'):<18}"]
    member = event.get("fleet_member")
    if member:
        parts.append(f"[{member}]")
    for key, value in event.items():
        if key in ("ts", "mono", "kind", "fleet_member"):
            continue
        if key == "trace":
            value = str(value)[:8]
        parts.append(f"{key}={value}")
    return " ".join(parts)


def cmd_journal(args) -> int:
    """The ops journal (obs/journal.py): reloads, patches, canary
    verdicts, breaker flips, SLO alerts, shed episodes, stalls and
    anomalies, from ``GET /admin/journal`` (``--fleet``: the router's
    member-merged ``/admin/fleet/journal``) with --url, else this
    process's ring. ``--follow`` polls for new events until
    interrupted."""
    import time as _time
    import urllib.parse

    def fetch(since):
        if args.url:
            path = ("/admin/fleet/journal" if args.fleet
                    else "/admin/journal")
            query = {"n": str(args.n)}
            if args.kind:
                query["kind"] = args.kind
            if since is not None:
                query["since"] = repr(since)
            return _fetch_admin_json(args.url.rstrip("/") + path + "?"
                                     + urllib.parse.urlencode(query))
        if args.fleet:
            raise commands.CommandError("--fleet needs --url (the router "
                                        "assembles the member merge)")
        from predictionio_torch.obs import journal as _journal

        return _journal.JOURNAL.page(n=args.n, kind=args.kind,
                                     since=since)

    payload = fetch(args.since)
    if args.json and not args.follow:
        _dump_json(payload)
        return 0
    events = payload.get("events") or []
    for event in events:
        print(json.dumps(event, sort_keys=True) if args.json
              else format_journal_event(event))
    if not events and not args.follow:
        print("(journal is empty)")
    if not args.follow:
        return 0
    # poll just past the newest event printed: ts is the join key across
    # members, so a merged fleet stream tails as one process's does
    last_ts = max((e.get("ts") or 0.0 for e in events), default=0.0)
    try:
        while True:
            _time.sleep(args.interval)
            payload = fetch(last_ts + 1e-3 if last_ts else None)
            for event in payload.get("events") or []:
                last_ts = max(last_ts, event.get("ts") or 0.0)
                print(json.dumps(event, sort_keys=True) if args.json
                      else format_journal_event(event), flush=True)
    except KeyboardInterrupt:
        return 0


def cmd_anomalies(args) -> int:
    """The regression sentinel (obs/anomaly.py): active change-points of
    the metric timelines, each attributed to a journal event, and the
    recently resolved ones, from ``GET /admin/anomaly`` (``--fleet``:
    ``/admin/fleet/anomaly``) with --url, else this process's sentinel.
    Exit 1 while any anomaly is active."""
    if args.url:
        path = "/admin/fleet/anomaly" if args.fleet else "/admin/anomaly"
        report = _fetch_admin_json(args.url.rstrip("/") + path)
    elif args.fleet:
        raise commands.CommandError("--fleet needs --url (the router "
                                    "assembles the member merge)")
    else:
        from predictionio_torch.obs import anomaly as _anomaly

        report = _anomaly.SENTINEL.report()
    active = report.get("active") or []
    if isinstance(active, dict):
        # one process keys its verdicts by series; the fleet merge
        # already flattens them into member-stamped rows
        active = [dict(entry, series=series)
                  for series, entry in sorted(active.items())]
    if args.json:
        _dump_json(report)
        return 1 if active else 0

    def describe(entry) -> str:
        line = (f"{entry.get('series', '?'):<28} "
                f"{entry.get('mode', '?')}/{entry.get('direction', '?')} "
                f"z={entry.get('z', 0):.1f} "
                f"baseline={entry.get('baseline')} "
                f"now={entry.get('recent')}")
        member = entry.get("fleet_member")
        if member:
            line = f"[{member}] " + line
        cause = entry.get("cause")
        if cause:
            line += (f"\n{'':<30}<- {cause.get('kind', '?')} "
                     f"{cause.get('gap_sec', 0):+.1f}s "
                     + " ".join(f"{k}={v}" for k, v in cause.items()
                                if k not in ("kind", "gap_sec", "ts",
                                             "trace")))
        return line

    if args.fleet:
        for member in report.get("members") or []:
            state = ("ok" if member.get("ok")
                     else f"ERROR: {member.get('error')}")
            print(f"member {member.get('name', '?'):<12} {state}  "
                  f"active={member.get('active', '?')}")
        print("")
    if not active:
        print("no active anomalies")
    else:
        print(f"{len(active)} ACTIVE anomal"
              + ("y" if len(active) == 1 else "ies")
              + f" (window {report.get('window_sec', '?')}s):")
        for entry in active:
            print("  " + describe(entry))
    resolved = (report.get("recent_resolved") or []
                if not args.fleet else [])
    if resolved:
        print("recently resolved:")
        for entry in resolved[-5:]:
            print(f"  {entry.get('series', '?'):<28} "
                  f"lasted {entry.get('duration_sec', 0):.0f}s "
                  f"(cause: {(entry.get('cause') or {}).get('kind', '-')})")
    return 1 if active else 0


def cmd_data(args) -> int:
    """The data plane (obs/dataobs.py): ingest rates per (app, event),
    entity heavy hitters and Zipf skew, cardinalities, quantiles,
    schema drift and the unknown-entity coverage ratio, from ``GET
    /admin/data`` (``--fleet``: ``/admin/fleet/data``) with --url, else
    this process's plane."""
    if args.url:
        path = "/admin/fleet/data" if args.fleet else "/admin/data"
        report = _fetch_admin_json(args.url.rstrip("/") + path)
    elif args.fleet:
        raise commands.CommandError("--fleet needs --url (the router "
                                    "assembles the member merge)")
    else:
        from predictionio_torch.obs import dataobs

        report = dataobs.DATAOBS.report(top_n=args.top)
    if args.json:
        _dump_json(report)
        return 0

    def render_one(rep: dict, indent: str = "") -> None:
        print(f"{indent}events {int(rep.get('events_total') or 0)} "
              f"({rep.get('eps', 0.0):g}/s)  "
              f"tail {int(rep.get('tail_events_total') or 0)}  "
              f"bytes {int(rep.get('bytes_total') or 0)}")
        entities = rep.get("entities") or {}
        card = entities.get("cardinality") or {}
        print(f"{indent}entity skew {entities.get('skew', 0.0):g}  "
              "cardinality " +
              " ".join(f"{k}={v}" for k, v in sorted(card.items())))
        print(f"{indent}unknown-entity ratio "
              f"{rep.get('unknown_ratio', 0.0):g} "
              f"(over {int(rep.get('queries_seen') or 0)} query refs)")
        breaches = rep.get("breach_active") or {}
        if breaches:
            print(f"{indent}ACTIVE BREACH: "
                  + ", ".join(sorted(k for k, v in breaches.items() if v)))
        rates = rep.get("rates") or []
        if rates:
            print(f"{indent}rates:")
            for row in rates[:10]:
                print(f"{indent}  app {row.get('app'):>6} "
                      f"{row.get('event', '?'):<20} {row.get('count')}")
        top = entities.get("top") or []
        if top:
            print(f"{indent}hot entities:")
            for row in top[:10]:
                print(f"{indent}  {row.get('id', '?'):<24} "
                      f"{row.get('count')} (±{row.get('err', 0)})")
        quant = rep.get("quantiles") or {}
        for name, summ in sorted(quant.items()):
            if summ and summ.get("n"):
                print(f"{indent}{name}: p50 {summ.get('p50')} "
                      f"p90 {summ.get('p90')} p99 {summ.get('p99')} "
                      f"(n={summ.get('n')})")
        schema = rep.get("schema") or {}
        changes = schema.get("changes") or []
        if changes:
            print(f"{indent}schema changes "
                  f"({schema.get('changes_total', len(changes))} total, "
                  "frozen at instance "
                  f"{schema.get('frozen_instance') or '-'}):")
            for ch in changes[-10:]:
                member = ch.get("fleet_member")
                print(f"{indent}  "
                      + (f"[{member}] " if member else "")
                      + f"{ch.get('event', '?')}.{ch.get('field', '?')} "
                      f"{ch.get('change', '?')} "
                      + " ".join(f"{k}={ch[k]}" for k in
                                 ("old_type", "new_type") if ch.get(k)))

    if args.fleet:
        for member in report.get("members") or []:
            state = ("ok" if member.get("ok")
                     else f"ERROR: {member.get('error')}")
            print(f"member {member.get('name', '?'):<12} {state}")
        print("")
        totals = report.get("totals") or {}
        changes = report.get("schema_changes") or []
        render_one({
            "events_total": totals.get("events_total"),
            "eps": totals.get("eps"),
            "tail_events_total": totals.get("tail_events_total"),
            "bytes_total": totals.get("bytes_total"),
            "entities": {"skew": report.get("skew", 0.0)},
            "unknown_ratio": report.get("unknown_ratio", 0.0),
            "breach_active": report.get("breach_active") or {},
            "schema": {"changes": changes, "changes_total": len(changes)},
        })
    else:
        render_one(report)
    return 0


def _fmt_bytes(n) -> str:
    """Binary-unit bytes for the mem report; None renders as '-'."""
    if n is None:
        return "-"
    n = float(n)
    sign = "-" if n < 0 else ""
    n = abs(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if n < 1024 or unit == "TiB":
            return (f"{sign}{n:.0f} {unit}" if unit == "B"
                    else f"{sign}{n:.2f} {unit}")
        n /= 1024.0
    return f"{sign}{n:.2f} TiB"


def cmd_mem(args) -> int:
    """Device-memory accounting (obs/memacct.py): headroom and its
    basis, the per-model ledger, train peaks and the last preflight,
    from ``GET /admin/memory`` with --url, else this process's
    ledger."""
    if args.url:
        report = _fetch_admin_json(args.url.rstrip("/") + "/admin/memory",
                                   timeout=10)
    else:
        from predictionio_torch.obs import memacct

        report = memacct.report()
    if args.json:
        _dump_json(report)
        return 0
    print(f"device memory ({report['basis']} basis): "
          f"{_fmt_bytes(report['in_use_bytes'])} in use of "
          f"{_fmt_bytes(report['capacity_bytes'])} — headroom "
          f"{_fmt_bytes(report['headroom_bytes'])}")
    models = report.get("models") or {}
    if not models:
        print("  (no ledgered model residency in this process)")
    for model in sorted(models):
        block = models[model]
        components = " ".join(
            f"{name}={_fmt_bytes(nbytes)}"
            for name, nbytes in sorted(block["components"].items()))
        print(f"  {model:>12} {_fmt_bytes(block['total_bytes']):>12}  "
              f"{components}")
    peaks = report.get("train_peaks") or {}
    for model in sorted(peaks):
        peak = peaks[model]
        print(f"  train peak {model}: {_fmt_bytes(peak['bytes'])} "
              f"({peak['source']})")
    pre = report.get("preflight") or {}
    state = "on" if pre.get("enabled") else "OFF (PIO_MEM_PREFLIGHT=0)"
    line = (f"preflight {state}, estimate scale "
            f"x{pre.get('estimate_scale')}")
    last = pre.get("last")
    if last:
        line += (f"; last: {last.get('result')} instance "
                 f"{last.get('instance')} "
                 f"(est {_fmt_bytes(last.get('estimated_bytes'))} vs "
                 f"headroom {_fmt_bytes(last.get('headroom_bytes'))})")
    print(line)
    return 0


def _fetch_timeline(url: Optional[str]) -> dict:
    """One timeline payload: a server's ``GET /admin/timeline``, else
    this process's rings (sampled now)."""
    if url:
        return _fetch_admin_json(url.rstrip("/") + "/admin/timeline",
                                 timeout=10)
    from predictionio_torch.obs import perfacct, timeline

    timeline.TIMELINE.sample(force=True)
    payload = timeline.TIMELINE.series()
    payload["datapath"] = perfacct.LEDGER.snapshot()
    return payload


def _render_top_frame(payload: dict) -> str:
    """One `pio top` frame: a sparkline and the latest value per series,
    then the data-path ledger's summary."""
    from predictionio_torch.obs.timeline import sparkline

    lines = []
    series = payload.get("series") or {}
    if not series:
        lines.append("(no samples yet — traffic or a train run feeds "
                     "the timeline)")
    width = max((len(n) for n in series), default=0)
    for name in sorted(series):
        points = series[name]
        if not points:
            continue
        values = [p[1] for p in points]
        lines.append(f"{name:>{width}}  {sparkline(values, 40):<40} "
                     f"{values[-1]:>12.4g}  "
                     f"(min {min(values):.4g} max {max(values):.4g}, "
                     f"n={len(values)})")

    def latest(name):
        points = series.get(name) or []
        return points[-1][1] if points else None

    eps = latest("data.eps")
    unknown = latest("data.unknown_ratio")
    skew = latest("data.skew")
    if any(v is not None for v in (eps, unknown, skew)):
        lines.append("")
        lines.append(
            "ingest: {} ev/s  unknown-entity {}  skew {}".format(
                "–" if eps is None else f"{eps:.4g}",
                "–" if unknown is None else f"{unknown:.2%}",
                "–" if skew is None else f"{skew:.3g}"))
    datapath = payload.get("datapath") or {}
    if datapath:
        lines.append("")
        lines.append(f"model staleness: "
                     f"{datapath.get('staleness_seconds', 0.0):.1f}s")
        runs = datapath.get("runs") or []
        if runs:
            last = runs[-1]
            stages = " ".join(f"{k}={v:.2f}s"
                              for k, v in sorted(last["stages"].items()))
            lines.append(f"last run {last['run']}: {stages or '(no stages)'}")
    return "\n".join(lines)


def _render_fleet_frame(report: dict, history: Optional[dict] = None) -> str:
    """One `pio top --fleet` frame: fleet percentiles off the merged
    serving histogram, the fleet SLO burn and a per-member table;
    ``history`` (the live loop's rings) adds sparklines."""
    from predictionio_torch.obs import collect
    from predictionio_torch.obs.timeline import sparkline

    lines = []
    samples = report.get("samples") or {}
    slo = report.get("slo") or {}
    p50 = collect.quantile_from_flat(
        samples, "pio_serving_request_seconds", 0.5)
    p99 = collect.quantile_from_flat(
        samples, "pio_serving_request_seconds", 0.99)
    requests = sum(v for k, v in samples.items()
                   if k.startswith("pio_http_requests_total"))
    if history is not None:
        for name, value in (("fleet.srv_p50_ms",
                             None if p50 is None else p50 * 1e3),
                            ("fleet.srv_p99_ms",
                             None if p99 is None else p99 * 1e3),
                            ("fleet.http_requests", requests)):
            if value is not None:
                history.setdefault(name, []).append(value)
                del history[name][:-120]
    burn = slo.get("burn")
    lines.append(
        "fleet serving: p50 {} p99 {} — SLO burn {} "
        "(<= {:g}ms objective {:.1%}, {} of {} good)".format(
            "–" if p50 is None else f"{p50 * 1e3:.2f}ms",
            "–" if p99 is None else f"{p99 * 1e3:.2f}ms",
            "–" if burn is None else f"{burn:g}",
            slo.get("threshold_ms", 0.0), slo.get("objective", 0.0),
            int(slo.get("good") or 0), int(slo.get("total") or 0)))
    # counters sum across the merge; skew and unknown take the fleet
    # max (a hot key or a stale model on one replica is the fleet's)
    ingest_events = sum(v for k, v in samples.items()
                        if k.startswith("pio_data_events_total"))
    fleet_skew = max((v for k, v in samples.items()
                      if k.startswith("pio_data_entity_skew")),
                     default=None)
    fleet_unknown = max(
        (v for k, v in samples.items()
         if k.startswith("pio_query_unknown_entity_ratio")),
        default=None)
    if ingest_events or fleet_skew is not None \
            or fleet_unknown is not None:
        if history is not None:
            history.setdefault("fleet.ingest_events", []).append(
                ingest_events)
            del history["fleet.ingest_events"][:-120]
        lines.append(
            "fleet ingest: events {:.0f}  unknown-entity {}  "
            "skew {}".format(
                ingest_events,
                "–" if fleet_unknown is None else f"{fleet_unknown:.2%}",
                "–" if fleet_skew is None else f"{fleet_skew:.3g}"))
    if history:
        width = max(len(n) for n in history)
        for name in sorted(history):
            values = history[name]
            lines.append(f"{name:>{width}}  "
                         f"{sparkline(values, 40):<40} "
                         f"{values[-1]:>12.4g}")
    lines.append("")
    lines.append(f"{'member':>12} {'role':>10} {'status':>8} "
                 f"{'http_reqs':>10} {'served':>8}")
    for member in report.get("members") or []:
        status = "ok" if member.get("ok") else "ERROR"
        lines.append(
            f"{member.get('name', '?'):>12} "
            f"{member.get('role', ''):>10} {status:>8} "
            f"{int(member.get('http_requests') or 0):>10} "
            f"{int(member.get('serving_requests') or 0):>8}"
            + (f"  ({member.get('error')})" if not member.get("ok")
               else ""))
    return "\n".join(lines)


def cmd_top(args) -> int:
    """Live view of the metric timelines (obs/timeline.py,
    obs/perfacct.py) as sparklines, every ``--interval`` seconds;
    ``--once`` prints one frame, ``--json`` (with --once) its raw
    payload. ``--fleet`` drives the view from a router's ``GET
    /admin/fleet/metrics``: merged percentiles, SLO burn and a
    per-member table."""
    if args.json and not args.once:
        raise commands.CommandError(
            "--json requires --once (one machine-readable frame; stream "
            "consumers should poll /admin/timeline)")
    if args.fleet and not args.url:
        raise commands.CommandError("--fleet needs --url (the fleet's "
                                    "router)")

    def fetch_and_render(history=None):
        if args.fleet:
            report = _fetch_admin_json(
                args.url.rstrip("/") + "/admin/fleet/metrics", timeout=10)
            return report, _render_fleet_frame(report, history)
        payload = _fetch_timeline(args.url)
        return payload, _render_top_frame(payload)

    if args.once:
        payload, frame = fetch_and_render()
        if args.json:
            _dump_json(payload)
        else:
            print(frame)
        return 0
    import time as _time

    history: dict = {}
    try:
        while True:
            # a failed fetch (a server restarting) shows in the frame and
            # the watch goes on; only --once fails hard
            try:
                _payload, frame = fetch_and_render(history)
            except commands.CommandError as e:
                frame = f"(fetch failed, retrying: {e})"
            sys.stdout.write("\x1b[2J\x1b[H")
            print(f"pio top — {args.url or 'in-process'}"
                  f"{' [fleet]' if args.fleet else ''} "
                  f"(interval {args.interval:g}s, ctrl-c to quit)\n")
            print(frame, flush=True)
            _time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m predictionio_torch.tools.cli",
        description="PredictionIO on PyTorch/CUDA")
    parser.add_argument("--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    p_app = sub.add_parser("app", help="manage apps")
    app_sub = p_app.add_subparsers(dest="app_command", required=True)
    p = app_sub.add_parser("new")
    p.add_argument("name")
    p.add_argument("--description", default=None)
    app_sub.add_parser("list")
    for name in ("show", "delete"):
        app_sub.add_parser(name).add_argument("name")
    for name in ("data-delete", "compact"):
        p = app_sub.add_parser(name)
        p.add_argument("name")
        p.add_argument("--channel", default=None)
    for name in ("channel-new", "channel-delete"):
        p = app_sub.add_parser(name)
        p.add_argument("name")
        p.add_argument("channel")
    p_app.set_defaults(func=cmd_app)

    p_ak = sub.add_parser("accesskey", help="manage access keys")
    ak_sub = p_ak.add_subparsers(dest="ak_command", required=True)
    p = ak_sub.add_parser("new")
    p.add_argument("app")
    p.add_argument("event", nargs="*", help="allowed events (empty = all)")
    ak_sub.add_parser("list").add_argument("--app", default=None)
    ak_sub.add_parser("delete").add_argument("key")
    p_ak.set_defaults(func=cmd_accesskey)

    for name, port, func in (("eventserver", 7070, cmd_eventserver),
                             ("adminserver", 7071, cmd_adminserver)):
        p = sub.add_parser(name)
        p.add_argument("--ip", default="0.0.0.0")
        p.add_argument("--port", type=int, default=port)
        p.set_defaults(func=func)

    for name, path_arg, func in (("import", "--input", cmd_import),
                                 ("export", "--output", cmd_export)):
        p = sub.add_parser(name, help=f"{name} events from/to a "
                                      "JSONL/parquet file")
        p.add_argument("--appname", required=True)
        p.add_argument(path_arg, required=True)
        p.add_argument("--channel", default=None)
        p.add_argument("--format", default=None, choices=["json", "parquet"])
        p.set_defaults(func=func)

    p = sub.add_parser("status", help="verify storage configuration")
    p.set_defaults(func=cmd_status)

    p = sub.add_parser("storageserver",
                       help="serve this host's storage to rest-backend peers")
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=7077)
    p.add_argument("--auth-key", default=None,
                   help="require X-PIO-Storage-Key on every request")
    p.set_defaults(func=cmd_storageserver)

    p = sub.add_parser(
        "storagerepair",
        help="reconcile event replicas on a replicated sharded source "
             "(owner-authoritative anti-entropy; run in a maintenance "
             "window — writes to the app must be quiesced)")
    p.add_argument("--appname", required=True)
    p.add_argument("--channel", default=None)
    p.set_defaults(func=cmd_storagerepair)

    p_tpl = sub.add_parser("template", help="engine templates")
    tpl_sub = p_tpl.add_subparsers(dest="template_command", required=True)
    tpl_sub.add_parser("list")
    p = tpl_sub.add_parser("get")
    p.add_argument("name")
    p.add_argument("directory")
    p_tpl.set_defaults(func=cmd_template)

    def engine_command(name, help, func, device=True):
        p = sub.add_parser(name, help=help)
        p.add_argument("--engine-json", default="engine.json")
        p.add_argument("--engine-id", default=None)
        p.add_argument("--engine-version", default="0")
        if device:
            p.add_argument("--device", default=None,
                           help="device (default: the CUDA card; 'cpu' "
                                "runs the kernels' plain versions on the "
                                "CPU)")
        p.set_defaults(func=func)
        return p

    engine_command("build", "register the engine manifest", cmd_build,
                   device=False)
    p = engine_command("train", "train the engine and store an instance",
                       cmd_train)
    p.add_argument("--batch", default="")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p = engine_command("deploy", "deploy the latest trained instance",
                       cmd_deploy)
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--feedback-url", default=None,
                   help="event server base URL for the feedback loop's "
                        "predict events (with --accesskey)")
    p.add_argument("--accesskey", default=None)
    p.add_argument("--log-url", default=None,
                   help="POST serve errors to this URL "
                        "(ref: CreateServer.scala:413-424)")
    p.add_argument("--replicas", type=int, default=None,
                   help="serve from N engine-server replicas behind a "
                        "health-routed query router on --port "
                        "(default: PIO_REPLICAS or 1 = a single server)")
    p.add_argument("--replica-mode", choices=["subprocess", "thread"],
                   default="subprocess",
                   help="replica isolation: subprocesses on ephemeral "
                        "ports, or in-process threaded servers")
    p.add_argument("--canary", action="store_true",
                   help="canary mode (needs --replicas >= 2): a new "
                        "COMPLETED instance lands on ONE replica and the "
                        "verdict promotes or rolls it back "
                        "(PIO_CANARY_* knobs; watch cadence "
                        "PIO_FLEET_WATCH_SEC)")

    p = sub.add_parser("undeploy", help="stop a deployed engine server")
    p.add_argument("--ip", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.set_defaults(func=cmd_undeploy)

    p = engine_command(
        "stream", "streaming events->model: tail the event log, fold "
        "deltas into the deployed model, POST /model/patch to engine "
        "servers (interval: PIO_STREAM_INTERVAL_SEC)", cmd_stream)
    p.add_argument("--url", default=None,
                   help="comma-separated engine-server base URLs to patch "
                        "(e.g. http://127.0.0.1:8000); omit to fold the "
                        "local model copy only")
    p.add_argument("--interval", type=float, default=None,
                   help="poll seconds (default PIO_STREAM_INTERVAL_SEC "
                        "or 1.0)")
    p.add_argument("--once", action="store_true",
                   help="one tail->fold->publish cycle, print stats JSON")
    p.add_argument("--reload-url", default=None,
                   help="comma-separated base URLs whose GET /reload "
                        "the drift-band breach auto-triggers (normally "
                        "the fleet router; PIO_QUALITY_DRIFT_BAND sets "
                        "the band)")

    p = sub.add_parser("eval", help="run an evaluation")
    p.add_argument("evaluation_class")
    p.add_argument("engine_params_generator_class", nargs="?", default=None)
    p.add_argument("--batch", default="")
    p.add_argument("--device", default=None,
                   help="device (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    p.set_defaults(func=cmd_eval)

    p = sub.add_parser(
        "slo",
        help="SLO burn-rate evaluation (from a server's /admin/slo with "
             "--url, else the in-process registry); exit 1 when firing",
    )
    p.add_argument("--url", default=None,
                   help="base URL of any PIO server, e.g. "
                        "http://127.0.0.1:8000 (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set)")
    p.add_argument("--json", action="store_true",
                   help="dump the raw evaluation report")
    p.set_defaults(func=cmd_slo)

    p = sub.add_parser(
        "chaos",
        help="inspect or toggle fault injection on a live server "
             "(GET/POST /admin/chaos; resilience/chaos.py spec grammar "
             "like storage:latency:50ms,storage:error:0.1)",
    )
    p.add_argument("--url", required=True,
                   help="base URL of any PIO server (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set)")
    p.add_argument("--set", dest="set_spec", default=None, metavar="SPEC",
                   help="replace the active rule set with SPEC "
                        "('' clears everything)")
    p.add_argument("--add", default=None, metavar="SPEC",
                   help="append SPEC's rules to the active set")
    p.add_argument("--clear", nargs="?", const=True, default=None,
                   metavar="SITE",
                   help="drop every rule, or only SITE's")
    p.add_argument("--json", action="store_true",
                   help="dump the raw rule-set JSON")
    p.set_defaults(func=cmd_chaos)

    p = sub.add_parser(
        "fleet",
        help="inspect or control a serving fleet through its router "
             "(GET/POST /admin/fleet; serving/fleet.py): replica "
             "states, rolling hot-swap, drain/readmit",
    )
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="base URL of the fleet's router (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set)")
    p.add_argument("--reload", action="store_true",
                   help="start a rolling zero-downtime hot-swap onto "
                        "the newest COMPLETED instance")
    p.add_argument("--drain", default=None, metavar="REPLICA",
                   help="take REPLICA out of rotation")
    p.add_argument("--readmit", default=None, metavar="REPLICA",
                   help="put REPLICA back into rotation (readiness "
                        "probes permitting)")
    p.add_argument("--force", action="store_true",
                   help="with --reload: override the replicas' "
                        "device-memory preflight (a 507-refused swap)")
    p.add_argument("--json", action="store_true",
                   help="dump the raw fleet snapshot JSON")
    p.set_defaults(func=cmd_fleet)

    p = sub.add_parser(
        "replay",
        help="re-play captured query payloads (PIO_FLIGHT_PAYLOADS) "
             "against a candidate instance and diff the answers vs the "
             "baseline (workflow/replay.py); report lands on "
             "/admin/quality",
    )
    p.add_argument("--url", required=True,
                   help="base URL of the CANDIDATE server")
    p.add_argument("--baseline", default=None,
                   help="base URL of the baseline server (default: "
                        "--flight-url)")
    p.add_argument("--flight-url", default=None,
                   help="server whose /admin/flight holds the captured "
                        "payloads (default: --baseline; requires "
                        "PIO_ADMIN_TOKEN — payloads only travel under "
                        "the bearer gate)")
    p.add_argument("-n", type=int, default=None,
                   help="replay only the newest N captured payloads")
    p.add_argument("--k", type=int, default=None,
                   help="top-k depth for the overlap diff (default "
                        "PIO_QUALITY_K)")
    p.add_argument("--no-push", action="store_true",
                   help="do not register the report on the baseline's "
                        "/admin/quality")
    p.add_argument("--fail-under", type=float, default=None,
                   help="exit 1 when mean overlap is below this floor")
    p.add_argument("--json", action="store_true",
                   help="dump the raw comparison report")
    p.set_defaults(func=cmd_replay)

    p = sub.add_parser(
        "canary",
        help="inspect or drive the fleet's canary lane through the "
             "router (GET /admin/quality, POST /admin/fleet): paired "
             "answer diffs, per-lane latency burn, promote/rollback",
    )
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="base URL of the fleet's router (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set)")
    p.add_argument("--start", action="store_true",
                   help="deploy the newest COMPLETED instance onto one "
                        "replica as the canary")
    p.add_argument("--promote", action="store_true",
                   help="roll the whole fleet onto the candidate")
    p.add_argument("--rollback", action="store_true",
                   help="restore the canary replica to the baseline "
                        "instance")
    p.add_argument("--json", action="store_true",
                   help="dump the raw /admin/quality report")
    p.set_defaults(func=cmd_canary)

    p = sub.add_parser(
        "metrics",
        help="dump Prometheus metrics (from a server's /metrics with "
             "--url, else the in-process registry)",
    )
    p.add_argument("--url", default=None,
                   help="base URL of any PIO server, e.g. "
                        "http://127.0.0.1:8000")
    p.add_argument("--json", action="store_true",
                   help="machine-readable flat {name{labels}: value} dump")
    p.set_defaults(func=cmd_metrics)

    p = sub.add_parser(
        "flight",
        help="dump a server's flight recorder (GET /admin/flight): the "
             "last completed requests with stage timings + trace ids",
    )
    p.add_argument("--url", required=True,
                   help="base URL of any PIO server, e.g. "
                        "http://127.0.0.1:8000")
    p.add_argument("-n", type=int, default=None,
                   help="only the last N records")
    p.add_argument("--slow", action="store_true",
                   help="only slow/errored records")
    p.set_defaults(func=cmd_flight)

    p = sub.add_parser(
        "trace",
        help="stitch one trace id across the fleet (GET /admin/trace "
             "via --url, else assembled in-process from this process's "
             "ring + ACTIVE fleets + PIO_OBS_MEMBERS) and render the "
             "annotated cross-process tree",
    )
    p.add_argument("trace_id",
                   help="the trace id (X-PIO-Trace-Id of any response)")
    p.add_argument("--url", default=None,
                   help="base URL of the assembling server — normally "
                        "the fleet's router (sends the PIO_ADMIN_TOKEN "
                        "bearer header when set)")
    p.add_argument("--json", action="store_true",
                   help="dump the raw stitched-trace document")
    p.set_defaults(func=cmd_trace)

    p = sub.add_parser(
        "profile",
        help="capture a torch.profiler window on a live server (POST "
             "/admin/profile); prints the trace's path and device-time "
             "summary, exits 1 with a message where there is no card",
    )
    p.add_argument("--url", required=True,
                   help="base URL of the server doing the device work")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="capture window length (default 3)")
    p.set_defaults(func=cmd_profile)

    p = sub.add_parser(
        "prof",
        help="continuous host profiler (GET /admin/prof): the always-on "
             "wall-clock flame of a live server — flame tree + hot "
             "frames; --fleet for the member-merged view",
    )
    p.add_argument("--url", default="http://127.0.0.1:8000",
                   help="base URL of any PIO server (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set)")
    p.add_argument("--fleet", action="store_true",
                   help="member-merged profile through the federation "
                        "plane (GET /admin/fleet/prof on the router)")
    p.add_argument("--collapsed", action="store_true",
                   help="emit folded 'stack count' lines for external "
                        "flamegraph tooling")
    p.add_argument("--slow", action="store_true",
                   help="only the above-PIO_SLOW_MS tail cohort's "
                        "samples (also lists their trace ids)")
    p.add_argument("--endpoint", default=None,
                   help="one route's slice, e.g. /queries.json")
    p.add_argument("--top", type=int, default=10,
                   help="hot frames listed under the flame (default 10)")
    p.add_argument("--json", action="store_true",
                   help="dump the raw profile payload")
    p.set_defaults(func=cmd_prof)

    p = sub.add_parser(
        "mem",
        help="device-memory accounting (obs/memacct.py): per-model "
             "ledger, headroom, train peaks and the OOM-preflight "
             "state (GET /admin/memory)",
    )
    p.add_argument("--url", default=None,
                   help="base URL of any PIO server (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set); "
                        "default: this process's own ledger")
    p.add_argument("--json", action="store_true",
                   help="dump the raw /admin/memory payload")
    p.set_defaults(func=cmd_mem)

    p = sub.add_parser(
        "top",
        help="live terminal view of the metric timelines (MFU, "
             "staleness, serving quantiles, request rate) from a "
             "server's /admin/timeline or the in-process rings",
    )
    p.add_argument("--url", default=None,
                   help="base URL of any PIO server (sends the "
                        "PIO_ADMIN_TOKEN bearer header when set); "
                        "default: this process's own timeline")
    p.add_argument("--interval", type=float, default=2.0,
                   help="refresh cadence in seconds (default 2)")
    p.add_argument("--once", action="store_true",
                   help="print one frame and exit")
    p.add_argument("--json", action="store_true",
                   help="with --once: dump the raw timeline payload")
    p.add_argument("--fleet", action="store_true",
                   help="drive the view from the router's federated "
                        "GET /admin/fleet/metrics (requires --url): "
                        "fleet-wide merged percentiles, SLO burn and "
                        "a per-member table")
    p.set_defaults(func=cmd_top)

    p = sub.add_parser(
        "journal",
        help="the ops journal: what the system DID and when (reloads, "
             "canary verdicts, breaker flips, shed episodes, anomaly "
             "onsets) — one line per event, newest last",
    )
    p.add_argument("--url", default=None,
                   help="server base URL (default: this process's ring)")
    p.add_argument("--fleet", action="store_true",
                   help="member-merged stream via the router's "
                        "GET /admin/fleet/journal (requires --url)")
    p.add_argument("-n", type=int, default=200,
                   help="events to show (default 200)")
    p.add_argument("--kind", default=None,
                   help="only this event kind (reload, breaker, "
                        "canary_verdict, shed_episode, anomaly, ...)")
    p.add_argument("--since", type=float, default=None,
                   help="unix-seconds floor")
    p.add_argument("--follow", "-f", action="store_true",
                   help="keep polling for new events until interrupted")
    p.add_argument("--interval", type=float, default=2.0,
                   help="--follow poll interval in seconds (default 2)")
    p.add_argument("--json", action="store_true",
                   help="raw JSON (one object per line with --follow)")
    p.set_defaults(func=cmd_journal)

    p = sub.add_parser(
        "anomalies",
        help="the regression sentinel: active metric change-points "
             "attributed to journal events; exit 1 while any is active",
    )
    p.add_argument("--url", default=None,
                   help="server base URL (default: this process's "
                        "sentinel)")
    p.add_argument("--fleet", action="store_true",
                   help="per-member reports + the active union via the "
                        "router's GET /admin/fleet/anomaly (requires "
                        "--url)")
    p.add_argument("--json", action="store_true",
                   help="raw sentinel report")
    p.set_defaults(func=cmd_anomalies)

    p = sub.add_parser(
        "data",
        help="the data & ingest observability plane: ingest rates, "
             "entity heavy hitters + Zipf skew, cardinality, schema "
             "drift, unknown-entity coverage",
    )
    p.add_argument("--url", default=None,
                   help="server base URL (default: this process's "
                        "data plane)")
    p.add_argument("--fleet", action="store_true",
                   help="member-merged report via the router's "
                        "GET /admin/fleet/data (requires --url)")
    p.add_argument("--top", type=int, default=20,
                   help="heavy-hitter rows to show (default 20)")
    p.add_argument("--json", action="store_true",
                   help="raw data-plane report")
    p.set_defaults(func=cmd_data)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    # structured logging with trace-id correlation (obs/logging.py): the
    # console stays human-readable unless PIO_LOG_JSON opts in; server
    # subcommands inherit the same handler
    from predictionio_torch.obs import logging as obs_logging

    obs_logging.setup(level=logging.DEBUG if args.verbose else logging.INFO,
                      default_json=False)
    try:
        return args.func(args)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        # operator errors (CommandError and StorageError are
        # RuntimeErrors: a bad app name, unconfigured storage, no trained
        # instance, a malformed import line or engine.json) exit cleanly
        if args.verbose:
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
