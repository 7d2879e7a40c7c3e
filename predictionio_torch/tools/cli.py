"""The port's console: ``pio train`` and ``pio deploy`` on the card.

    python -m predictionio_torch.tools.cli train \\
        --engine-json engine.json [--engine-id ID] [--device cpu]
    python -m predictionio_torch.tools.cli deploy \\
        --engine-json engine.json [--engine-id ID] [--port 8000] \\
        [--ip 0.0.0.0] [--device cpu]

``train`` reads the engine's events, trains its algorithms and stores a
COMPLETED engine instance with its models (ref:
tools/.../console/Console.scala train). ``deploy`` serves the latest
COMPLETED instance of the engine — trained by either package; an
``engineFactory`` under ``predictionio_tpu.`` resolves under
``predictionio_torch.`` — on ``POST /queries.json`` until interrupted
(ref: Console.scala:830). Both run on the card; ``--device cpu`` is the
only way onto the CPU. Storage comes from the ``PIO_STORAGE_*``
environment, as for ``pio``. The other commands stay with
``predictionio_tpu.tools.cli`` until their slices are ported.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

from predictionio_torch.core.engine import resolve_engine_factory


def engine_from_json(path: str):
    """(engine, variant dict) of an engine.json."""
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

    engine, variant = engine_from_json(args.engine_json)
    engine_id = _engine_id(args, variant)
    server = EngineServer(engine, engine_id=engine_id,
                          engine_version=args.engine_version,
                          engine_variant=variant.get("id", "default"),
                          host=args.ip, port=args.port, device=args.device)
    print(f"Engine {engine_id} deployed on {args.ip}:{server.port} "
          f"({server.ctx.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.stop()
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m predictionio_torch.tools.cli",
        description="PredictionIO on PyTorch/CUDA")
    parser.add_argument("--verbose", action="store_true")
    sub = parser.add_subparsers(dest="command", required=True)

    def command(name, help, func):
        p = sub.add_parser(name, help=help)
        p.add_argument("--engine-json", default="engine.json")
        p.add_argument("--engine-id", default=None)
        p.add_argument("--engine-version", default="0")
        p.add_argument("--device", default=None,
                       help="device (default: the CUDA card; 'cpu' runs "
                            "the kernels' plain versions on the CPU)")
        p.set_defaults(func=func)
        return p

    p = command("train", "train the engine and store an instance",
                cmd_train)
    p.add_argument("--batch", default="")
    p.add_argument("--skip-sanity-check", action="store_true")
    p.add_argument("--stop-after-read", action="store_true")
    p.add_argument("--stop-after-prepare", action="store_true")
    p = command("deploy", "deploy the latest trained instance", cmd_deploy)
    p.add_argument("--ip", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO)
    try:
        return args.func(args)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        if args.verbose:
            raise
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
