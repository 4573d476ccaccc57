"""Command-line entry points of the port, each ``python -m
distpow_tpu_torch.cli.<name>``: ``worker`` (the one that touches the
card), ``coordinator``, ``client``, ``tracing_server``, ``config_gen``,
``trace_check``, ``stats``, ``slo``, ``forensics``, ``soak`` and ``lint``
(which import no ``torch``; ``soak`` loads it only to boot its own
cluster)."""
