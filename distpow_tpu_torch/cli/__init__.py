"""Command-line entry points of the port: ``python -m
distpow_tpu_torch.cli.worker``."""
