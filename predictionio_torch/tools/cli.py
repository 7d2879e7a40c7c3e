"""The port's console: ``pio`` for apps, keys, events, train, deploy and
eval.

    python -m predictionio_torch.tools.cli app new NAME [--description D]
    python -m predictionio_torch.tools.cli app list|show|delete|data-delete|
        compact|channel-new|channel-delete ...
    python -m predictionio_torch.tools.cli accesskey new APP [EVENT ...]
    python -m predictionio_torch.tools.cli accesskey list [--app APP]
    python -m predictionio_torch.tools.cli accesskey delete KEY
    python -m predictionio_torch.tools.cli eventserver [--ip IP] [--port 7070]
    python -m predictionio_torch.tools.cli adminserver [--ip IP] [--port 7071]
    python -m predictionio_torch.tools.cli import --appname APP --input F
    python -m predictionio_torch.tools.cli export --appname APP --output F
    python -m predictionio_torch.tools.cli status
    python -m predictionio_torch.tools.cli train \\
        --engine-json engine.json [--engine-id ID] [--device cpu]
    python -m predictionio_torch.tools.cli deploy \\
        --engine-json engine.json [--engine-id ID] [--port 8000] \\
        [--ip 0.0.0.0] [--device cpu]
    python -m predictionio_torch.tools.cli eval pkg.mod.MyEvaluation \\
        [pkg.mod.MyParamsGenerator] [--batch B] [--device cpu]

The app, access-key, server, import/export and status commands take the
JAX console's arguments and print its lines (ref:
tools/.../console/Console.scala:128-735); they touch no device and
import no torch. ``train`` reads the engine's events, trains its
algorithms and stores a COMPLETED engine instance with its models.
``deploy`` serves the latest COMPLETED instance of the engine — trained
by either package; an ``engineFactory`` under ``predictionio_tpu.``
resolves under ``predictionio_torch.`` — on ``POST /queries.json`` until
SIGTERM drains it (ref: Console.scala:830). ``eval`` runs an
``Evaluation`` over the candidates of an ``EngineParamsGenerator``,
stores an EvaluationInstance and prints the best score's one-liner (ref:
Console.scala eval, CreateWorkflow.scala:263-276); dotted paths under
``predictionio_tpu.`` resolve under ``predictionio_torch.``. The three
run on the card; ``--device cpu`` is the only way onto the CPU. Storage comes from the
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
        s = commands.app_compact(args.name, args.channel, st)
        if s is None:
            print("Backend stores events in place; nothing to compact.")
        else:
            print(f"Compacted: dropped {s['dropped']} records, "
                  f"{s['before_bytes']} -> {s['after_bytes']} bytes")
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


def cmd_status(args) -> int:
    """ref: Storage.verifyAllDataObjects (Storage.scala:237). Each port
    source has one endpoint, so a tier either serves or FAILED."""
    details = get_storage().serving_status()
    for repo, d in sorted(details.items()):
        print(f"{repo}: {'OK' if d['serving'] else 'FAILED'}")
    if all(d["serving"] for d in details.values()):
        print("(sleeping)")
        return 0
    print("Unable to connect to all storage backends.")
    return 1


# -- train / deploy ------------------------------------------------------------

def engine_from_json(path: str):
    """(engine, variant dict) of an engine.json."""
    from predictionio_torch.core.engine import resolve_engine_factory

    with open(path) as f:
        variant = json.load(f)
    if "engineFactory" not in variant:
        raise ValueError(f"{path}: engine variant requires 'engineFactory'")
    engine = resolve_engine_factory(variant["engineFactory"])()
    return engine, variant


def _engine_id(args, variant: dict) -> str:
    return (args.engine_id or variant.get("engineId")
            or variant["engineFactory"])


def cmd_train(args) -> int:
    from predictionio_torch.parallel.context import DeviceContext
    from predictionio_torch.workflow.config import WorkflowParams
    from predictionio_torch.workflow.train import run_train

    engine, variant = engine_from_json(args.engine_json)
    wp = WorkflowParams(batch=args.batch,
                        skip_sanity_check=args.skip_sanity_check,
                        stop_after_read=args.stop_after_read,
                        stop_after_prepare=args.stop_after_prepare)
    instance = run_train(engine, engine.engine_params_from_variant(variant),
                         engine_id=_engine_id(args, variant),
                         engine_version=args.engine_version,
                         engine_variant=variant.get("id", "default"),
                         engine_factory=variant["engineFactory"],
                         batch=args.batch, ctx=DeviceContext(args.device),
                         workflow_params=wp)
    print(f"Training completed: engine instance {instance.id} "
          f"({instance.status})", flush=True)
    return 0 if instance.status == "COMPLETED" else 1


def cmd_deploy(args) -> int:
    from predictionio_torch.serving.engine_server import EngineServer
    from predictionio_torch.serving.http import install_drain_handler

    engine, variant = engine_from_json(args.engine_json)
    engine_id = _engine_id(args, variant)
    server = EngineServer(engine, engine_id=engine_id,
                          engine_version=args.engine_version,
                          engine_variant=variant.get("id", "default"),
                          host=args.ip, port=args.port, device=args.device)
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

    def engine_command(name, help, func):
        p = sub.add_parser(name, help=help)
        p.add_argument("--engine-json", default="engine.json")
        p.add_argument("--engine-id", default=None)
        p.add_argument("--engine-version", default="0")
        p.add_argument("--device", default=None,
                       help="device (default: the CUDA card; 'cpu' runs "
                            "the kernels' plain versions on the CPU)")
        p.set_defaults(func=func)
        return p

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

    p = sub.add_parser("eval", help="run an evaluation")
    p.add_argument("evaluation_class")
    p.add_argument("engine_params_generator_class", nargs="?", default=None)
    p.add_argument("--batch", default="")
    p.add_argument("--device", default=None,
                   help="device (default: the CUDA card; 'cpu' to run on "
                        "the CPU)")
    p.set_defaults(func=cmd_eval)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
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
