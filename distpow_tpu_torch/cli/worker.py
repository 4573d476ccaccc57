"""Worker entry point of the port (cmd/worker/main.go equivalent).

    python -m distpow_tpu_torch.cli.worker [--config PATH] [--id ID]
        [--listen ADDR] [--backend NAME] [--faults PLAN]
        [--device {cuda,cuda:<i>,cpu}]
        [--jax-coordinator HOST:PORT --jax-num-processes N --jax-process-id I]

The flags and the config file are the reference's
(``distpow_tpu/cli/worker.py``): ``--id`` and ``--listen`` override the
config the way the reference's flags do (cmd/worker/main.go:15-16) and
``--backend`` picks the compute path (``auto``, ``pallas`` and ``jax`` are
the CUDA kernel; ``pallas-mesh`` its mesh form).  ``--device`` is the
port's: the worker runs on the card (``cuda``, the default) unless it is
asked for the CPU (``cpu``); without a GPU it exits with an error.  The
``--jax-*`` flags set ``JaxCoordinator`` and its fields, which the port
refuses until its multi-host mesh is ported.

SIGTERM and SIGINT stop the worker gracefully: the fleet lease drains
first, then the serving plane stops, and the process exits 0.
"""

from __future__ import annotations

import argparse
import logging
import signal
import threading

from ..nodes.worker import Worker
from ..runtime import faults
from ..runtime.config import WorkerConfig, read_json_config


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="distpow worker (PyTorch/CUDA)")
    ap.add_argument("--config", default="config/worker_config.json")
    ap.add_argument("--id", help="Worker ID, e.g. worker1")
    ap.add_argument("--listen", help="Listen address, e.g. 127.0.0.1:5000")
    ap.add_argument("--backend", help="Compute backend override")
    ap.add_argument("--faults", default=None,
                    help="fault-injection plan: JSON file path or inline "
                         "JSON (chaos testing; docs/FAULTS.md)")
    ap.add_argument("--device", default="cuda",
                    help="where the worker computes: cuda (default), "
                         "cuda:<index>, or cpu")
    ap.add_argument("--jax-coordinator", default=None,
                    help="multi-host coordinator HOST:PORT (not ported: "
                         "a set value raises)")
    ap.add_argument("--jax-num-processes", type=int, default=None)
    ap.add_argument("--jax-process-id", type=int, default=None)
    args = ap.parse_args(argv)

    config = read_json_config(args.config, WorkerConfig)
    if args.id:
        config.WorkerID = args.id
    if args.listen:
        config.ListenAddr = args.listen
    if args.backend:
        config.Backend = args.backend
    if args.jax_coordinator is not None:
        config.JaxCoordinator = args.jax_coordinator
    if args.jax_num_processes is not None:
        config.JaxNumProcesses = args.jax_num_processes
    if args.jax_process_id is not None:
        config.JaxProcessId = args.jax_process_id
    plan_spec = args.faults or config.FaultPlanFile
    if plan_spec:
        faults.install_from_spec(plan_spec)
    logging.info("worker config: %s (device %s)", config, args.device)
    worker = Worker(config, device=args.device)
    # graceful teardown on SIGTERM/SIGINT instead of dying mid-shard:
    # run_forever(stop) drains the fleet lease first, then stops the
    # serving plane.  A second signal during a slow drain falls through to
    # the default handler.
    stop = threading.Event()

    def _term(signum, frame):
        signal.signal(signum, signal.SIG_DFL)
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    worker.run_forever(stop)


if __name__ == "__main__":
    main()
