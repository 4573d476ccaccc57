"""The reference demo as processes, with the port's worker CLI.

The reference's ``tracing_server`` and ``coordinator`` CLIs (configs from
``config_gen``), two workers that are ``python -m
distpow_tpu_torch.cli.worker --device cpu`` (the CUDA backend's plain
version on the CPU), and the reference's demo client at ``--difficulty 3``
(7 for its repeated nonce... the client adds 2).  The client prints its
four ``MineResult`` lines, each secret solves its puzzle, the reference's
``trace_check`` finds 0 violations in the two logs, and SIGTERM stops each
worker with exit code 0.
"""

import hashlib
import re
import signal
import subprocess
import sys
import time

from tests.proc_harness import REPO, ProcStack

CPU_WORKER = {"Backend": "cuda", "BatchSize": 1 << 12, "MaxLaunchCandidates": 1 << 14,
              "WarmupNonceLens": [2], "WarmupWidths": [0, 1, 2]}


def test_demo_with_port_worker_processes(tmp_path):
    stack = ProcStack(tmp_path, workers=2, seed=321, worker_overrides=CPU_WORKER)
    workers = []
    try:
        stack.boot_core()
        for i, addr in enumerate(stack.coord_cfg["Workers"]):
            p = stack.spawn("-m", "distpow_tpu_torch.cli.worker",
                            "--config", stack.config("worker_config.json"),
                            "--id", f"worker{i + 1}", "--listen", addr, "--device", "cpu")
            stack.wait_for_line(p, f"serving worker{i + 1} RPCs", timeout=40.0)
            workers.append(p)
        client = stack.spawn("-m", "distpow_tpu.cli.client",
                             "--config", stack.config("client_config.json"),
                             "--config2", stack.config("client2_config.json"),
                             "--difficulty", "3")
        out, _ = client.communicate(timeout=60)
        assert client.returncode == 0, out
        results = re.findall(r"MineResult nonce=([0-9a-f]*) difficulty=(\d+) secret=([0-9a-f]*)",
                             out)
        assert len(results) == 4, out
        for nonce, ntz, secret in results:
            digest = hashlib.md5(bytes.fromhex(nonce) + bytes.fromhex(secret)).hexdigest()
            assert digest.endswith("0" * int(ntz)), (nonce, ntz, secret)
        assert sorted(int(r[1]) for r in results) == [3, 3, 5, 5]

        # SIGTERM: each worker drains and exits 0
        for p in workers:
            p.send_signal(signal.SIGTERM)
        for p in workers:
            assert p.wait(timeout=20) == 0
        time.sleep(0.5)  # the tracing server writes what the workers sent
        check = subprocess.run(
            [sys.executable, "-m", "distpow_tpu.cli.trace_check",
             str(tmp_path / "trace_output.log"), str(tmp_path / "shiviz_output.log")],
            cwd=REPO, env=stack.env, capture_output=True, text=True, timeout=60)
        assert check.returncode == 0, check.stdout + check.stderr
        assert "0 violation(s)" in check.stdout
        trace_log = (tmp_path / "trace_output.log").read_text()
        for marker in ("[worker1]", "[worker2]", "WorkerMine", "WorkerResult", "WorkerCancel"):
            assert marker in trace_log, marker
    finally:
        stack.close()
