"""Tracing-server entry point (cmd/tracing-server/main.go equivalent).

    python -m distpow_tpu_torch.cli.tracing_server [--config PATH]

The port's own copy of the reference's ``cli/tracing_server.py``
(``distpow_tpu/cli/tracing_server.py``):
it imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import logging

from ..runtime.config import TracingServerConfig, read_json_config
from ..runtime.trace_server import TracingServer


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="distpow tracing server")
    ap.add_argument("--config", default="config/tracing_server_config.json")
    args = ap.parse_args(argv)

    server = TracingServer(read_json_config(args.config, TracingServerConfig))
    addr = server.open()
    logging.info("tracing server listening on %s", addr)
    server.accept_forever()


if __name__ == "__main__":
    main()
