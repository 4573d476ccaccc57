"""Boot and stop the deployment a cell runs: the port's coordinator and
its workers, each a process of its own, on localhost ports that the
kernel hands out.

Each node is ``python -m portbench.launcher``, which runs the node's CLI
(``distpow_tpu_torch.cli.coordinator`` or ``.cli.worker``) with a control
channel.  Each worker sees its card through ``CUDA_VISIBLE_DEVICES``
(worker ``i`` takes card ``i`` modulo the cell's chips, of those the run's
own ``CUDA_VISIBLE_DEVICES`` lists, where set; ``cards`` lists them).
Their configuration files, logs and profiles go to the run's temporary
directory; the kernels are built in ``build_dir``, a fixed directory
inside the checkout, so only a checkout's first run builds.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import List, Optional


def visible_cards() -> Optional[List[int]]:
    """The card indices ``CUDA_VISIBLE_DEVICES`` lists, or None where it is
    not set."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return None
    return [int(x) for x in env.split(",") if x.strip().isdigit()]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _accepting(port: int) -> bool:
    try:
        with socket.create_connection(("127.0.0.1", port), timeout=1.0):
            return True
    except OSError:
        return False


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, 2)
            fh.seek(max(0, fh.tell() - n))
            return fh.read().decode(errors="replace")
    except OSError:
        return ""


class Launcher:
    """One node's process and its control channel."""

    def __init__(self, argv: List[str], env: dict, cwd: str, log_path: str):
        self.log_path = log_path
        self._log = open(log_path, "wb")
        self.proc = subprocess.Popen(argv, cwd=cwd, env=env, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, stderr=self._log, text=True)
        self.replies: "queue.Queue[Optional[str]]" = queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self.proc.stdout:
            self.replies.put(line)
        self.replies.put(None)


class Stack:
    def __init__(self, root: str, tmp: str, build_dir: str, config: dict, chips: int,
                 device: str = "cuda", fault: Optional[str] = None):
        self.root, self.tmp, self.build_dir = root, tmp, build_dir
        self.config, self.chips, self.device, self.fault = config, chips, device, fault
        self.coordinator: Optional[Launcher] = None
        self.workers: List[Launcher] = []
        self.cards: List[int] = []  # each worker's card, as CUDA numbers it
        self.client_addr = self.worker_api_addr = ""
        self.worker_addrs: List[str] = []

    @property
    def nodes(self) -> List[Launcher]:
        return ([self.coordinator] if self.coordinator is not None else []) + self.workers

    def env(self, card: Optional[int]) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [self.root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        env["PYTHONUNBUFFERED"] = "1"
        env["USE_FLAX"] = "0"
        env["DISTPOW_TORCH_BUILD_DIR"] = self.build_dir
        cache = os.path.dirname(self.build_dir)
        env["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
        env["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
        env["CUDA_VISIBLE_DEVICES"] = "" if card is None else str(card)
        return env

    def _write(self, name: str, data: dict) -> str:
        path = os.path.join(self.tmp, name)
        with open(path, "w") as fh:
            json.dump(data, fh)
        return path

    def _launch(self, node: str, name: str, cli_argv: List[str], card: Optional[int]) -> Launcher:
        argv = [sys.executable, "-m", "portbench.launcher", node]
        if self.fault and node == "worker":
            argv += ["--fault", self.fault]
        return Launcher(argv + ["--"] + cli_argv, self.env(card), self.root,
                        os.path.join(self.tmp, f"{name}.log"))

    def boot(self, timeout: float = 120.0) -> None:
        """Start the coordinator, wait until it accepts, then start the
        workers (each dials the coordinator as it boots).  The coordinator
        dials the workers at the first Mine and waits for them there."""
        n = int(self.config["Workers"])
        client_port, worker_api_port = free_port(), free_port()
        self.client_addr = f"127.0.0.1:{client_port}"
        self.worker_api_addr = f"127.0.0.1:{worker_api_port}"
        self.worker_addrs = [f"127.0.0.1:{free_port()}" for _ in range(n)]
        coord_cfg = self._write("coordinator.json", {
            **self.config.get("coordinator", {}),
            "ClientAPIListenAddr": self.client_addr,
            "WorkerAPIListenAddr": self.worker_api_addr,
            "Workers": self.worker_addrs, "TracerServerAddr": ""})
        self.coordinator = self._launch("coordinator", "coordinator",
                                        ["--config", coord_cfg], None)
        deadline = time.monotonic() + timeout
        while not (_accepting(client_port) and _accepting(worker_api_port)):
            if self.coordinator.proc.poll() is not None or time.monotonic() > deadline:
                raise RuntimeError("the coordinator did not start: "
                                   + _tail(self.coordinator.log_path))
            time.sleep(0.05)
        if self.device == "cuda":
            vis = visible_cards()
            usable = list(range(self.chips)) if vis is None else vis[:self.chips]
            self.cards = [usable[i % len(usable)] for i in range(n)] if usable else []
        for i, addr in enumerate(self.worker_addrs):
            cfg = self._write(f"worker{i + 1}.json", {
                **self.config.get("worker", {}),
                "WorkerID": f"worker{i + 1}", "CoordAddr": self.worker_api_addr,
                "TracerServerAddr": "", "CompilationCacheDir": self.build_dir})
            self.workers.append(self._launch(
                "worker", f"worker{i + 1}",
                ["--config", cfg, "--listen", addr,
                 "--device", "cuda" if self.device == "cuda" else "cpu"],
                self.cards[i] if self.cards else None))

    def check_alive(self) -> None:
        """Raise with its log if a process of the deployment has exited."""
        for node in self.nodes:
            if node.proc.poll() is not None:
                raise RuntimeError(f"{os.path.basename(node.log_path)[:-4]} exited "
                                   f"({node.proc.returncode}): " + _tail(node.log_path))

    def send(self, cmd: str, nodes: List[Launcher], each: Optional[List[dict]] = None,
             **kw) -> List[dict]:
        """One command to each of ``nodes`` (with ``each[i]``'s arguments
        added for node ``i``), the replies in the same order."""
        for i, node in enumerate(nodes):
            msg = {"cmd": cmd, **kw, **(each[i] if each else {})}
            node.proc.stdin.write(json.dumps(msg) + "\n")
            node.proc.stdin.flush()
        out = []
        for node in nodes:
            line = node.replies.get(timeout=300)
            if line is None:
                raise RuntimeError(f"a node exited: {_tail(node.log_path)}")
            reply = json.loads(line)
            if not reply.get("ok"):
                raise RuntimeError(f"{cmd}: {reply.get('error')}")
            out.append(reply)
        return out

    def stop(self) -> None:
        """SIGTERM every process, wait for each, SIGKILL what lingers."""
        procs = [node.proc for node in self.nodes]
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + 30
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        for node in self.nodes:
            for f in (node.proc.stdin, node.proc.stdout):
                try:
                    f.close()
                except OSError:
                    pass
            node._log.close()

    def logs_tail(self) -> str:
        return "\n".join(f"--- {os.path.basename(node.log_path)[:-4]} ---\n"
                         f"{_tail(node.log_path, 1500)}" for node in self.nodes)
