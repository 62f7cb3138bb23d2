"""The ``serve`` and ``export-serving`` commands.

Counterpart of ``viscoin_tpu/cli/serve.py``, with its options and defaults:

    python -m viscoin_tpu_torch serve --viscoin-pickle-path checkpoints/cub/viscoin-cub
    python -m viscoin_tpu_torch export-serving --viscoin-pickle-path ... -o artifact
    python -m viscoin_tpu_torch serve --from-artifact artifact

``serve`` loads a bundle (``utils/checkpoints.py::load_viscoin_bundle``) on
the card, runs every batched endpoint once (``InferenceEngine.warmup``),
then serves it over HTTP (``serve/server.py::run_server``), printing the
bound address (``--port 0`` takes a free port). SIGINT stops it: the
micro-batchers close and the command returns normally.

``--data-parallel`` serves one replica on every visible card and splits
each device batch over them (``serve/engine.py``; the batch size must divide
by the card count), as the JAX command does over its devices; with one card
it serves on it.

``export-serving`` seals a bundle into an artifact (``serve/export.py``):
classify, reconstruct and explain as ``torch.export`` programs beside the
weights, for ``--platforms`` (default: the ``--device``'s type).
``serve --from-artifact`` serves one without model code: its batch size,
compute dtype and devices were fixed at export, so an explicitly passed
``--batch-size``, ``--compute-dtype`` or ``--data-parallel`` is refused, as
the JAX command does; it has no amplify (400).
"""

from __future__ import annotations

import argparse

from viscoin_tpu_torch.cli.utils import add_device_option, add_viscoin_pickle_option

SEALED = ("batch_size", "compute_dtype", "data_parallel")  # fixed by an artifact's export
DEFAULTS = {"batch_size": 8, "compute_dtype": "bfloat16", "data_parallel": False}


def add_parser(subparsers) -> None:
    p = subparsers.add_parser("serve", help="Serve a trained VisCoIN ensemble over HTTP.")
    add_viscoin_pickle_option(p)
    add_device_option(p)
    p.add_argument("--host", default="127.0.0.1", help="(default 127.0.0.1)")
    p.add_argument("--port", type=int, default=8751, help="(default 8751; 0 takes a free port)")
    p.add_argument("--batch-size", type=int, default=None,
                   help="Device batch; requests coalesce up to it (default 8)")
    p.add_argument("--max-delay-ms", type=float, default=5.0,
                   help="Micro-batching window: how long the first request of a batch waits "
                        "for company (default 5)")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default=None,
                   help="Serving compute dtype, weights cast once at startup (default bfloat16)")
    p.add_argument("--from-artifact", default=None,
                   help="Serve a sealed export-serving artifact directory instead of a "
                        "checkpoint (no amplify: it needs model code)")
    p.add_argument("--data-parallel", action=argparse.BooleanOptionalAction, default=None,
                   help="Shard each device batch over all visible cards, one replica each")
    p.set_defaults(func=serve)

    e = subparsers.add_parser("export-serving",
                              help="Seal a trained bundle into a serving artifact.")
    add_viscoin_pickle_option(e)
    add_device_option(e)
    e.add_argument("--output", "-o", required=True, help="Artifact directory to write")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="bfloat16")
    e.add_argument("--platforms", default=None,
                   help='Comma-separated devices the artifact serves, e.g. "cuda,cpu" '
                        "(default: the --device's type); traced on the first")
    e.set_defaults(func=export_serving)


def serve(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.serve.server import run_server

    if args.from_artifact is not None:
        # An artifact is sealed: refuse knobs its manifest fixed, rather than
        # serve with other values than the operator asked for.
        sealed = [name for name in SEALED if getattr(args, name) is not None]
        if sealed:
            flags = ", ".join("--" + n.replace("_", "-") for n in sealed)
            raise ValueError(f"{flags} cannot be combined with --from-artifact: the artifact's "
                             "manifest fixes them at export time (re-export with the desired "
                             "values)")
        from viscoin_tpu_torch.serve.export import load_exported

        engine = load_exported(args.from_artifact, device=card_or_cpu("serve", args.device))
    else:
        engine = _bundle_engine(args, card_or_cpu("serve", args.device))
    print("warming up (one batch through each endpoint)...", flush=True)
    engine.warmup()
    try:
        run_server(engine, host=args.host, port=args.port, max_delay_ms=args.max_delay_ms)
    except KeyboardInterrupt:  # SIGINT: run_server has closed the batchers and the socket
        pass


def _bundle_engine(args: argparse.Namespace, device):
    import torch

    from viscoin_tpu_torch.serve.engine import InferenceEngine
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle

    for name, value in DEFAULTS.items():
        if getattr(args, name) is None:
            setattr(args, name, value)
    devices = None
    if args.data_parallel and device.type == "cuda":
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if args.batch_size % len(devices):
            raise ValueError(f"serve --data-parallel: --batch-size {args.batch_size} does not "
                             f"divide over the {len(devices)} visible cards")
        print(f"--data-parallel: a replica on each of {len(devices)} visible card(s)", flush=True)
    models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
    return InferenceEngine(models, batch_size=args.batch_size, compute_dtype=args.compute_dtype,
                           device=device, devices=devices)


def export_serving(args: argparse.Namespace) -> None:
    from viscoin_tpu_torch.cli.utils import card_or_cpu
    from viscoin_tpu_torch.serve.export import export_serving as export
    from viscoin_tpu_torch.utils.checkpoints import load_viscoin_bundle

    device = card_or_cpu("export-serving", args.device)
    platforms = tuple(args.platforms.split(",")) if args.platforms else (device.type,)
    models = load_viscoin_bundle(args.viscoin_pickle_path, device=device)
    manifest = export(models, args.output, batch_size=args.batch_size,
                      compute_dtype=args.compute_dtype, platforms=platforms)
    print(f"exported {manifest['endpoints']} (batch {args.batch_size}, "
          f"{manifest['resolution']}px, {args.compute_dtype}, for {manifest['platforms']}) "
          f"-> {args.output}", flush=True)
