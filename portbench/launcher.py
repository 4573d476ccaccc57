"""Run one node of the port through its CLI, with a control channel.

    python -m portbench.launcher worker [--fault NAME] -- <cli.worker arguments>
    python -m portbench.launcher coordinator -- <cli.coordinator arguments>

The node is ``distpow_tpu_torch.cli.<node>``'s ``main``, in this process's
main thread; it stops on SIGTERM.  The benchmark talks to this launcher in
JSON lines: commands on standard input, one reply a command on the
original standard output.  Everything else that the process writes to its
standard output goes to its standard error.

* ``{"cmd": "trace_start"}``: start ``torch.profiler`` (host and device;
  workers only).
* ``{"cmd": "trace_stop", "path": P, "window_s": W}``: stop it and write
  the window's summary (``profile.summarize``) to ``P`` as JSON.
* ``{"cmd": "arm"}``: arm the planted fault, if any (``faults.py``).
* ``{"cmd": "report"}``: the JAX modules this process has loaded
  (``forbidden``, top-level names compared whole), the wall-clock marks of
  its boot, and for a worker the card's name and this process's peak of
  allocated device memory.
"""

from __future__ import annotations

import faulthandler
import json
import logging
import os
import signal
import sys
import threading
import time
import traceback

# wall-clock marks of this node's boot, which the report carries: the
# launcher's start, the node's modules imported, a worker serving its
# RPCs and its warm-up done (the last two read from its log)
MARKS = {"start": time.time()}
NODES = ("worker", "coordinator")
FORBIDDEN = ("jax", "jaxlib", "flax", "distpow_tpu")


def loaded_forbidden() -> list:
    """The JAX modules in this process's ``sys.modules``, by top-level
    name compared whole (``distpow_tpu_torch`` is not ``distpow_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class _BootMarks(logging.Handler):
    def emit(self, record):
        text = record.getMessage()
        for mark, words in (("serving", "serving"), ("warm", "warmup")):
            if words in text:
                MARKS.setdefault(mark, record.created)


def _report(node: str) -> dict:
    reply = {"ok": True, "forbidden": loaded_forbidden(), "boot": dict(MARKS)}
    if node == "worker":
        import torch

        cuda = torch.cuda.is_available()
        reply["kind"] = torch.cuda.get_device_name(0) if cuda else "cpu"
        reply["memory_peak_bytes"] = torch.cuda.max_memory_allocated(0) if cuda else 0
    return reply


def _control(out, node: str) -> None:
    from . import faults

    prof = None
    for line in sys.stdin:
        msg = json.loads(line)
        cmd = msg["cmd"]
        try:
            if cmd == "report":
                reply = _report(node)
            elif cmd == "trace_start":
                import torch
                from torch.profiler import ProfilerActivity, profile

                acts = [ProfilerActivity.CPU]
                if torch.cuda.is_available():
                    acts.append(ProfilerActivity.CUDA)
                prof = profile(activities=acts)
                prof.start()
                reply = {"ok": True}
            elif cmd == "trace_stop":
                from .profile import split_events, summarize

                prof.stop()
                device, host = split_events(prof.profiler.kineto_results.events())
                with open(msg["path"], "w") as fh:
                    json.dump(summarize(device, host, float(msg["window_s"])), fh)
                prof = None
                reply = {"ok": True}
            elif cmd == "arm":
                faults.ARMED.set()
                reply = {"ok": True}
            else:
                reply = {"ok": False, "error": f"unknown command {cmd!r}"}
        except Exception:
            reply = {"ok": False, "error": traceback.format_exc()}
        out.write(json.dumps(reply) + "\n")
        out.flush()


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    cut = argv.index("--") if "--" in argv else len(argv)
    own, node_argv = argv[:cut], argv[cut + 1:]
    node, own = own[0], own[1:]
    if node not in NODES:
        raise SystemExit(f"unknown node {node!r}; known: {NODES}")
    faulthandler.register(signal.SIGUSR1, all_threads=True)  # a stalled node's stacks
    # the control channel keeps the real standard output to itself
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    if own[:1] == ["--fault"]:
        from . import faults

        faults.install(own[1])
    threading.Thread(target=_control, args=(out, node), daemon=True).start()
    if node == "worker":
        logging.getLogger("distpow.worker").addHandler(_BootMarks())
        from distpow_tpu_torch.cli import worker as cli
    else:
        from distpow_tpu_torch.cli import coordinator as cli

    MARKS["imported"] = time.time()
    cli.main(node_argv)


if __name__ == "__main__":
    main()
