"""Coordinator entry point (cmd/coordinator/main.go equivalent).

    python -m distpow_tpu_torch.cli.coordinator [--config PATH] [--faults PLAN]

``--faults`` (or ``FaultPlanFile`` in the config, or ``$DISTPOW_FAULTS``)
installs a deterministic fault-injection plan — see docs/FAULTS.md.

The port's own copy of the reference's ``cli/coordinator.py``
(``distpow_tpu/cli/coordinator.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import logging

from ..nodes.coordinator import Coordinator
from ..runtime import faults
from ..runtime.config import CoordinatorConfig, read_json_config


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="distpow coordinator")
    ap.add_argument("--config", default="config/coordinator_config.json")
    ap.add_argument("--faults", default=None,
                    help="fault-injection plan: JSON file path or inline "
                         "JSON (chaos testing; docs/FAULTS.md)")
    args = ap.parse_args(argv)

    config = read_json_config(args.config, CoordinatorConfig)
    plan_spec = args.faults or config.FaultPlanFile
    if plan_spec:
        faults.install_from_spec(plan_spec)
    logging.info("coordinator config: %s", config)
    Coordinator(config).run_forever()


if __name__ == "__main__":
    main()
