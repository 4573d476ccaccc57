"""Runtime support of the port (the metrics registry the driver writes)."""
