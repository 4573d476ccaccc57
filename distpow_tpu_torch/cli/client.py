"""Demo client entry point (cmd/client/main.go equivalent).

Runs the reference's built-in smoke scenario (cmd/client/main.go:40-60):
two clients, four mining requests — two concurrent distinct nonces plus a
repeated nonce at increasing difficulty to exercise the dominance cache's
miss-then-supersede path — then drains both notify queues.

    python -m distpow_tpu_torch.cli.client [--config PATH] [--config2 PATH]
        [--id ID] [--id2 ID] [--difficulty N | --difficulty-bits N]

Difficulty units (SURVEY.md section 0): the protocol's
``numTrailingZeros`` counts trailing ``'0'`` HEX DIGITS of the digest —
nibbles, 4 bits each (worker.go:246-256).  ``--difficulty`` speaks that
native unit; ``--difficulty-bits`` accepts bits (the unit BASELINE.json's
configs use) and divides by 4, so ``--difficulty-bits 32`` ≡
``--difficulty 8``.  Bits must be a multiple of 4 — the digest check has
no sub-nibble resolution.

The port's own copy of the reference's ``cli/client.py``
(``distpow_tpu/cli/client.py``): it
imports nothing of the JAX package.
"""

from __future__ import annotations

import argparse
import logging
import os
import queue

from ..nodes.client import Client
from ..runtime import faults
from ..runtime.config import ClientConfig, read_json_config


def difficulty_nibbles(difficulty, difficulty_bits, default: int = 5) -> int:
    """Resolve the two difficulty flags to the protocol's nibble unit.

    ``difficulty`` is already in nibbles; ``difficulty_bits`` is divided
    by 4 (raising on non-multiples — the trailing-hex-digit check has no
    sub-nibble resolution).  Exactly one may be set; neither means
    ``default``.
    """
    if difficulty_bits is not None:
        if difficulty_bits % 4:
            raise ValueError(
                "--difficulty-bits must be a multiple of 4 (the difficulty "
                "check counts trailing hex digits)"
            )
        return difficulty_bits // 4
    return default if difficulty is None else difficulty


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(description="distpow demo client")
    ap.add_argument("--config", default="config/client_config.json")
    ap.add_argument(
        "--config2",
        help="second client's config (default: client2_config.json next to "
        "--config, falling back to --config with ClientID 'client2')",
    )
    ap.add_argument("--id", help="Client ID override")
    ap.add_argument("--id2", help="Second client ID override")
    diff_group = ap.add_mutually_exclusive_group()
    diff_group.add_argument(
        "--difficulty", type=int, default=None,
        help="base difficulty in trailing hex digits (nibbles), the "
        "protocol's native numTrailingZeros unit; default 5 "
        "(the repeat-nonce request adds 2)",
    )
    diff_group.add_argument(
        "--difficulty-bits", type=int, default=None,
        help="base difficulty in bits (must be a multiple of 4); "
        "translated to nibbles: --difficulty-bits 32 == --difficulty 8",
    )
    ap.add_argument("--faults", default=None,
                    help="fault-injection plan: JSON file path or inline "
                         "JSON (chaos testing; docs/FAULTS.md)")
    args = ap.parse_args(argv)

    try:
        args.difficulty = difficulty_nibbles(
            args.difficulty, args.difficulty_bits
        )
    except ValueError as exc:
        ap.error(str(exc))

    cfg1 = read_json_config(args.config, ClientConfig)
    plan_spec = args.faults or cfg1.FaultPlanFile
    if plan_spec:
        faults.install_from_spec(plan_spec)
    config2, reused_cfg1 = args.config2, False
    if config2 is None:
        sibling = os.path.join(
            os.path.dirname(args.config), "client2_config.json"
        )
        if os.path.exists(sibling):
            config2 = sibling
        else:
            config2, reused_cfg1 = args.config, True
    cfg2 = read_json_config(config2, ClientConfig)
    if reused_cfg1 and not args.id2:
        cfg2.ClientID = "client2"
    if args.id:
        cfg1.ClientID = args.id
    if args.id2:
        cfg2.ClientID = args.id2

    client1, client2 = Client(cfg1), Client(cfg2)
    client1.initialize()
    client2.initialize()
    try:
        d = args.difficulty
        client1.mine(bytes([1, 2, 3, 4]), d + 2)
        client1.mine(bytes([5, 6, 7, 8]), d)
        client2.mine(bytes([2, 2, 2, 2]), d)
        client2.mine(bytes([2, 2, 2, 2]), d + 2)

        remaining = 4
        while remaining:
            for c in (client1, client2):
                try:
                    r = c.notify_queue.get(timeout=0.2)
                except queue.Empty:
                    continue
                if r.error is not None:
                    logging.error(
                        "MineError nonce=%s difficulty=%d error=%s",
                        r.nonce.hex(), r.num_trailing_zeros, r.error,
                    )
                else:
                    logging.info(
                        "MineResult nonce=%s difficulty=%d secret=%s",
                        r.nonce.hex(), r.num_trailing_zeros, r.secret.hex(),
                    )
                remaining -= 1
    finally:
        client1.close()
        client2.close()


if __name__ == "__main__":
    main()
