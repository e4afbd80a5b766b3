"""``python -m repro_torch.service`` — run a StudyServer over TCP.

    python -m repro_torch.service serve --addr 127.0.0.1:7481 \\
        --build repro_torch.app.pipeline:pathology_service_build --workers 4

``--build`` names a ``module:callable`` returning the fleet-build mapping
(``workflow`` / ``space`` / ``inputs`` / ``objective`` / ``input_keys``);
the server binds, prints the bound address, and serves until interrupted.
"""

from __future__ import annotations

import argparse
import importlib
import sys
from typing import Any, Callable, Dict


def _resolve_build(ref: str) -> Callable[..., Dict[str, Any]]:
    mod_name, sep, attr = ref.partition(":")
    if not sep or not attr:
        raise SystemExit(f"--build must be 'module:callable', got {ref!r}")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, attr, None)
    if not callable(fn):
        raise SystemExit(f"{ref!r} does not name a callable")
    return fn


def main(argv: Any = None) -> int:
    parser = argparse.ArgumentParser(prog="repro_torch.service")
    sub = parser.add_subparsers(dest="cmd", required=True)
    serve = sub.add_parser("serve", help="run a study server")
    serve.add_argument("--addr", default="127.0.0.1:0")
    serve.add_argument(
        "--build",
        default="repro_torch.app.pipeline:pathology_service_build",
        help="module:callable returning the fleet-build mapping",
    )
    serve.add_argument("--workers", type=int, default=2)
    serve.add_argument(
        "--backend",
        default=None,
        help="worker backend (default: in-process threads)",
    )
    args = parser.parse_args(argv)

    from repro_torch.service.server import StudyServer

    server = StudyServer.from_build(
        _resolve_build(args.build),
        n_workers=args.workers,
        backend=args.backend,
    )
    bound = server.serve_background(args.addr)
    print(f"repro_torch.service listening on {bound}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
